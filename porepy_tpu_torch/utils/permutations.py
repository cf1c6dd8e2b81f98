"""Number-system permutations (reference ``utils/permutations.py``;
deprecated upstream but kept for API parity)."""

from __future__ import annotations

import warnings

__all__ = ["multinary_permutations"]


def multinary_permutations(base: int, length: int):
    """Generate every ``length``-digit number in a ``base``-ary system as a
    list of digits (least significant first). Yields ``base ** length``
    combinations."""
    warnings.warn(
        "This functionality is deprecated and will be removed in a future "
        "version",
        DeprecationWarning,
    )
    for number in range(base**length):
        digits = []
        v = number
        for _ in range(length):
            digits.append(v % base)
            v //= base
        yield digits
