"""Case 3 of the 3d flow benchmark of Berre et al. (2021), "Verification
benchmarks for single-phase flow in three-dimensional fractured porous
media", Adv. Water Resources 147.

Counterpart of reference ``examples/flow_benchmark_3d_case_3.py``: eight
fractures (inclined and T-intersecting planes) in the box
(0,0,0)-(1,2.25,1); inflow through the middle band of the south boundary,
Dirichlet pressure on the top/bottom bands of the north boundary.

``params["refinement_level"]`` (0-3) controls the mesh: the native
conforming cut-tet mesher produces roughly 30k/140k/350k/500k
three-dimensional cells, mirroring the reference's gmsh refinement-level
sizes (reference ``examples/flow_benchmark_3d_case_3.py:1-17``).
"""

from __future__ import annotations

import numpy as np

import porepy_tpu_torch as pt
from porepy_tpu_torch.applications.md_grids.mdg_library import benchmark_3d_case_3
from porepy_tpu_torch.examples.flow_benchmark_2d_case_1 import (
    FluxDiscretization,
    FractureSolidConstants,
    Permeability,
)

__all__ = [
    "solid_constants",
    "Geometry",
    "BoundaryConditions",
    "FlowBenchmark3dCase3Model",
]

solid_constants = FractureSolidConstants(
    residual_aperture=1e-2,
    normal_permeability=1e4,
    fracture_permeability=1e4,
)


class Geometry:
    """Benchmark geometry (Section 5.3 of Berre et al. 2021)."""

    def set_geometry(self) -> None:
        self.mdg, self.fracture_network = benchmark_3d_case_3(
            refinement_level=self.params.get("refinement_level", 0)
        )
        self.nd: int = self.mdg.dim_max()
        self._domain = self.fracture_network.domain
        self._fractures = self.fracture_network.fractures
        pt.set_local_coordinate_projections(self.mdg)

        self.set_well_network()
        if self.well_network is not None and len(self.well_network.wells) > 0:
            pt.compute_well_fracture_intersections(
                self.well_network, self.fracture_network
            )
            self.well_network.mesh(self.mdg)


class BoundaryConditions:
    """Inlet/outlet bands as specified by the benchmark: Dirichlet on the
    north boundary where z > 2/3 or z < 1/3; unit influx through the south
    boundary band 1/3 < z < 2/3; no-flow elsewhere."""

    def bc_type_darcy_flux(self, sd) -> pt.BoundaryCondition:
        sides = self.domain_boundary_sides(sd)
        dir_faces = np.zeros(sd.num_faces, dtype=bool)
        z = sd.face_centers[2][sides.north]
        dir_faces[sides.north] = (z > 2.0 / 3.0) | (z < 1.0 / 3.0)
        return pt.BoundaryCondition(sd, dir_faces, "dir")

    def bc_values_darcy_flux(self, bg) -> np.ndarray:
        sides = self.domain_boundary_sides(bg)
        cc = bg.cell_centers
        inlet = np.zeros(bg.num_cells, dtype=bool)
        inlet[sides.south] = (cc[2][sides.south] < 2.0 / 3.0) & (
            cc[2][sides.south] > 1.0 / 3.0
        )
        # Unit inflow (negative: fluid enters the domain).
        val = self.units.convert_units(-1, "m * s^-1")
        values = np.zeros(bg.num_cells)
        values[inlet] = val * bg.cell_volumes[inlet]
        return values


class FlowBenchmark3dCase3Model(
    FluxDiscretization,
    Geometry,
    Permeability,
    BoundaryConditions,
    pt.SinglePhaseFlow,
):
    """Complete model for case 3 of the 3d flow benchmark."""
