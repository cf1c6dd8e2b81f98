"""Initial-condition mixin (reference ``models/initial_condition.py:10``)."""

from __future__ import annotations

__all__ = ["InitialConditionMixin"]


class InitialConditionMixin:
    def initial_condition(self) -> None:
        """Set initial values at the current iterate. Cooperative: physics
        mixins extend ``set_initial_values_primary_variables``."""
        self.set_initial_values_primary_variables()

    def set_initial_values_primary_variables(self) -> None:
        pass
