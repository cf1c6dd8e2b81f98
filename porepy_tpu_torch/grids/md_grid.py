"""Mixed-dimensional grid container.

Parity counterpart of reference ``grids/md_grid.py:18``: a DAG of subdomain
grids (matrix, fractures, intersections, points) connected by interface
:class:`~porepy_tpu.grids.mortar_grid.MortarGrid` objects, with one
:class:`~porepy_tpu.grids.boundary_grid.BoundaryGrid` per positive-
dimensional subdomain and a data dictionary attached to every grid.

Iteration order contract (load-bearing: global dof ordering depends on it):
descending dimension, ascending grid id within a dimension — matching the
reference's ``argsort_grids`` (``grids/md_grid.py:607``).
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator, Optional, Union

import numpy as np

from porepy_tpu_torch.grids.boundary_grid import BoundaryGrid
from porepy_tpu_torch.grids.grid import Grid

__all__ = ["MixedDimensionalGrid"]


class MixedDimensionalGrid:
    def __init__(self) -> None:
        self.name = "Mixed-dimensional grid"
        self._subdomain_data: dict[Grid, dict] = {}
        self._interface_data: dict[Any, dict] = {}
        self._boundary_grid_data: dict[BoundaryGrid, dict] = {}
        # interface -> (higher-dim sd, lower-dim sd)
        self._interface_to_subdomains: dict[Any, tuple[Grid, Grid]] = {}

    def __contains__(self, key: Any) -> bool:
        return (
            key in self._subdomain_data
            or key in self._interface_data
            or key in self._boundary_grid_data
        )

    # -- iteration ----------------------------------------------------------

    def _sorted(self, grids: Iterable) -> list:
        return sorted(grids, key=lambda g: (-g.dim, g.id))

    def subdomains(
        self, return_data: bool = False, dim: Optional[int] = None
    ) -> list:
        out = [
            sd
            for sd in self._sorted(self._subdomain_data)
            if dim is None or sd.dim == dim
        ]
        if return_data:
            return [(sd, self._subdomain_data[sd]) for sd in out]
        return out

    def interfaces(
        self, return_data: bool = False, dim: Optional[int] = None, codim: Optional[int] = None
    ) -> list:
        out = []
        for intf in self._sorted(self._interface_data):
            if dim is not None and intf.dim != dim:
                continue
            if codim is not None and getattr(intf, "codim", 1) != codim:
                continue
            out.append(intf)
        if return_data:
            return [(intf, self._interface_data[intf]) for intf in out]
        return out

    def boundaries(
        self, return_data: bool = False, dim: Optional[int] = None
    ) -> list:
        out = [
            bg
            for bg in self._sorted(self._boundary_grid_data)
            if dim is None or bg.dim == dim
        ]
        if return_data:
            return [(bg, self._boundary_grid_data[bg]) for bg in out]
        return out

    # -- relations ----------------------------------------------------------

    def interface_to_subdomain_pair(self, intf) -> tuple[Grid, Grid]:
        """(higher-dimensional, lower-dimensional) subdomain pair of an
        interface."""
        return self._interface_to_subdomains[intf]

    def subdomain_pair_to_interface(self, sd_pair: tuple[Grid, Grid]):
        sd_pair = self.sort_subdomain_tuple(sd_pair)
        for intf, pair in self._interface_to_subdomains.items():
            if pair == sd_pair:
                return intf
        raise KeyError("Unknown subdomain pair")

    def subdomain_to_interfaces(self, sd: Grid) -> list:
        return self._sorted(
            intf
            for intf, pair in self._interface_to_subdomains.items()
            if sd in pair
        )

    def subdomain_to_boundary_grid(self, sd: Grid) -> Optional[BoundaryGrid]:
        for bg in self._boundary_grid_data:
            if bg.parent is sd:
                return bg
        return None

    def neighboring_subdomains(
        self, sd: Grid, only_higher: bool = False, only_lower: bool = False
    ) -> list[Grid]:
        if only_higher and only_lower:
            raise ValueError("only_higher and only_lower are mutually exclusive")
        neigh = []
        for pair in self._interface_to_subdomains.values():
            if sd is pair[0] and not only_higher:
                neigh.append(pair[1])
            elif sd is pair[1] and not only_lower:
                neigh.append(pair[0])
        return self._sorted(set(neigh))

    # -- data ---------------------------------------------------------------

    def subdomain_data(self, sd: Grid) -> dict:
        return self._subdomain_data[sd]

    def interface_data(self, intf) -> dict:
        return self._interface_data[intf]

    def boundary_grid_data(self, bg: BoundaryGrid) -> dict:
        return self._boundary_grid_data[bg]

    # -- mutation -----------------------------------------------------------

    def add_subdomains(self, new_subdomains: Union[Grid, Iterable[Grid]]) -> None:
        if isinstance(new_subdomains, Grid):
            new_subdomains = [new_subdomains]
        for sd in new_subdomains:
            if sd in self._subdomain_data:
                raise ValueError("Grid already in mixed-dimensional grid")
            self._subdomain_data[sd] = {}
            if sd.dim > 0:
                bg = BoundaryGrid(sd)
                self._boundary_grid_data[bg] = {}

    def add_interface(
        self, intf, sd_pair: tuple[Grid, Grid], primary_secondary_map=None
    ) -> None:
        """Register an interface (MortarGrid) between a subdomain pair.

        The pair is stored as (higher-dim, lower-dim); equal dimensions are
        allowed for codim-0 couplings (ordered by id).
        """
        if intf in self._interface_data:
            raise ValueError("Interface already in mixed-dimensional grid")
        if any(sd not in self._subdomain_data for sd in sd_pair):
            raise ValueError("Interface subdomains must be added first")
        if sd_pair[0].dim < sd_pair[1].dim:
            sd_pair = (sd_pair[1], sd_pair[0])
        self._interface_data[intf] = (
            {} if primary_secondary_map is None
            else {"face_cells": primary_secondary_map}
        )
        self._interface_to_subdomains[intf] = sd_pair

    def replace_subdomains_and_interfaces(
        self,
        sd_map: Optional[dict] = None,
        interface_map: Optional[dict] = None,
        tol: float = 1e-6,
    ) -> None:
        """Swap subdomain grids and/or mortar (side) grids for new — possibly
        refined and non-matching — grids, updating every mortar projection
        and boundary grid touched (reference ``grids/md_grid.py:700``).

        Parameters:
            sd_map: ``{old subdomain: new subdomain}``.
            interface_map: ``{old MortarGrid: new MortarGrid}`` or
                ``{old MortarGrid: {MortarSides: side grid}}``.
            tol: Geometric tolerance for the grid matching.
        """
        from porepy_tpu_torch.grids.mortar_grid import MortarGrid

        for intf, replacement in (interface_map or {}).items():
            side_grids = (
                replacement.side_grids
                if isinstance(replacement, MortarGrid)
                else replacement
            )
            intf.update_mortar(side_grids, tol)

        for sd_old, sd_new in (sd_map or {}).items():
            self._subdomain_data[sd_new] = self._subdomain_data.pop(sd_old)
            for intf in self.subdomain_to_interfaces(sd_old):
                primary, secondary = self._interface_to_subdomains[intf]
                if primary is sd_old:
                    self._interface_to_subdomains[intf] = (sd_new, secondary)
                    intf.update_primary(sd_new, sd_old, tol)
                else:
                    self._interface_to_subdomains[intf] = (primary, sd_new)
                    intf.update_secondary(sd_new, tol)
            bg_old = self.subdomain_to_boundary_grid(sd_old)
            if bg_old is not None:
                data = self._boundary_grid_data.pop(bg_old)
                bg_new = BoundaryGrid(sd_new)
                bg_new.compute_geometry()
                bg_new.set_projections()
                self._boundary_grid_data[bg_new] = data

    def remove_subdomain(self, sd: Grid) -> None:
        del self._subdomain_data[sd]
        for intf in list(self.subdomain_to_interfaces(sd)):
            del self._interface_data[intf]
            del self._interface_to_subdomains[intf]
        bg = self.subdomain_to_boundary_grid(sd)
        if bg is not None:
            del self._boundary_grid_data[bg]

    # -- sorting ------------------------------------------------------------

    def sort_subdomains(self, subdomains: list[Grid]) -> list[Grid]:
        return self._sorted(subdomains)

    def sort_subdomain_tuple(self, sd_pair: tuple[Grid, Grid]) -> tuple[Grid, Grid]:
        a, b = sd_pair
        return (a, b) if (-a.dim, a.id) <= (-b.dim, b.id) else (b, a)

    def sort_interfaces(self, interfaces: list) -> list:
        return self._sorted(interfaces)

    def argsort_grids(self, grids: Iterable) -> np.ndarray:
        grids = list(grids)
        keys = [(-g.dim, g.id) for g in grids]
        return np.array(sorted(range(len(grids)), key=keys.__getitem__), dtype=int)

    # -- geometry -----------------------------------------------------------

    def compute_geometry(self) -> None:
        for sd in self.subdomains():
            sd.compute_geometry()
        for intf in self.interfaces():
            intf.compute_geometry()
        for bg in self.boundaries():
            bg.compute_geometry()
        self.set_boundary_grid_projections()

    def set_boundary_grid_projections(self) -> None:
        for bg in self.boundaries():
            bg.set_projections()

    def copy(self) -> "MixedDimensionalGrid":
        """Shallow copy: same grid objects, fresh data dicts references."""
        out = MixedDimensionalGrid()
        out._subdomain_data = dict(self._subdomain_data)
        out._interface_data = dict(self._interface_data)
        out._boundary_grid_data = dict(self._boundary_grid_data)
        out._interface_to_subdomains = dict(self._interface_to_subdomains)
        return out

    # -- summary stats ------------------------------------------------------

    def diameter(self, cond=None) -> float:
        if cond is None:
            cond = lambda g: True  # noqa: E731
        diam = 0.0
        for sd in self.subdomains():
            if cond(sd) and sd.dim > 0:
                diam = max(diam, float(np.max(sd.cell_diameters())))
        return diam

    def dim_min(self) -> int:
        return min(sd.dim for sd in self._subdomain_data)

    def dim_max(self) -> int:
        return max(sd.dim for sd in self._subdomain_data)

    def num_subdomain_cells(self, cond=None) -> int:
        sds = self.subdomains()
        return int(sum(sd.num_cells for sd in sds if cond is None or cond(sd)))

    def num_interface_cells(self, cond=None) -> int:
        intfs = self.interfaces()
        return int(
            sum(intf.num_cells for intf in intfs if cond is None or cond(intf))
        )

    def num_subdomains(self) -> int:
        return len(self._subdomain_data)

    def num_interfaces(self) -> int:
        return len(self._interface_data)

    def __repr__(self) -> str:
        s = (
            f"MixedDimensionalGrid(subdomains={self.num_subdomains()}, "
            f"interfaces={self.num_interfaces()}"
        )
        if self._subdomain_data:
            s += f", dims=[{self.dim_min()}, {self.dim_max()}]"
            s += f", cells={self.num_subdomain_cells()}"
        return s + ")"

    __str__ = __repr__
