"""Benchmark case definitions shared by ``bench.py`` (the driver-run
artifact producer) and the diagnostics/probing tools.

Each case is a model class + params on one of the BASELINE.md configs;
the reference counterparts are measured by ``tools/measure_ref_configs.py``
(scipy assembly + spsolve per Newton iteration, e.g. reference
``src/porepy/models/solution_strategy.py:820-826``).
"""

from .cases import CASE_BUILDERS, build_case

__all__ = ["CASE_BUILDERS", "build_case"]
