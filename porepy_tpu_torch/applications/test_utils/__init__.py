"""Utilities shared by functional/benchmark tests (reference
``applications/test_utils``)."""
