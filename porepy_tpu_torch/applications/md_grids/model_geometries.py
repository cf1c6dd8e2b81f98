"""Model geometry mixins for canned domains (reference
``applications/md_grids/model_geometries.py``)."""

from __future__ import annotations

import numpy as np

from porepy_tpu_torch.applications.md_grids import domains, fracture_sets

__all__ = [
    "SquareDomainOrthogonalFractures",
    "CubeDomainOrthogonalFractures",
]


class SquareDomainOrthogonalFractures:
    """Square of side ``params['domain_size']`` with up to two orthogonal
    fractures selected by ``params['fracture_indices']``."""

    @property
    def domain_size(self):
        return self.units.convert_units(self.params.get("domain_size", 1.0), "m")

    def set_fractures(self) -> None:
        indices = self.params.get("fracture_indices", [0])
        endpoints = self.params.get(
            "fracture_endpoints",
            [np.array([0, self.domain_size])] * 2,
        )
        all_fracs = fracture_sets.orthogonal_fractures_2d(
            self.domain_size, endpoints
        )
        self._fractures = [all_fracs[i] for i in indices]

    def set_domain(self) -> None:
        self._domain = domains.nd_cube_domain(2, self.domain_size)


class CubeDomainOrthogonalFractures:
    """Cube of side ``params['domain_size']`` with up to three orthogonal
    plane fractures selected by ``params['fracture_indices']``."""

    @property
    def domain_size(self):
        return self.units.convert_units(self.params.get("domain_size", 1.0), "m")

    def set_fractures(self) -> None:
        indices = self.params.get("fracture_indices", [0])
        all_fracs = fracture_sets.orthogonal_fractures_3d(self.domain_size)
        self._fractures = [all_fracs[i] for i in indices]

    def set_domain(self) -> None:
        self._domain = domains.nd_cube_domain(3, self.domain_size)
