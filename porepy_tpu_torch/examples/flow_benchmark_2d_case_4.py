"""Case 4 of the 2d flow benchmark of Flemisch et al. (2018): 63 fractures
in 13 connected networks on a 700 m x 600 m domain.

Counterpart of reference ``examples/flow_benchmark_2d_case_4.py``
(performance-profiling geometry). Fracture coordinates are the published
benchmark data, checked in under
``applications/md_grids/file_library/benchmark_2d_case_4``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

import porepy_tpu_torch as pt
from porepy_tpu_torch.examples.flow_benchmark_2d_case_1 import (
    FluxDiscretization,
    FractureSolidConstants,
    Permeability,
)
from porepy_tpu_torch.fracs import fracture_importer

__all__ = ["solid_constants", "Geometry", "BoundaryConditions", "FlowBenchmark2dCase4Model"]

solid_constants = FractureSolidConstants(
    residual_aperture=1e-2,
    permeability=1e-14,
    normal_permeability=1e-8,
    fracture_permeability=1e-8,
)

_CSV = (
    Path(__file__).parents[1]
    / "applications"
    / "md_grids"
    / "file_library"
    / "benchmark_2d_case_4"
    / "fracture_network_benchmark_2d_case_4.csv"
)


def benchmark_2d_case_4_fractures() -> list:
    """The 63 published fracture traces."""
    network = fracture_importer.network_2d_from_csv(str(_CSV))
    return list(network.fractures)


class Geometry:
    def set_fractures(self) -> None:
        self._fractures = benchmark_2d_case_4_fractures()

    def set_domain(self) -> None:
        self._domain = pt.Domain(
            {
                "xmin": 0,
                "xmax": self.units.convert_units(700, "m"),
                "ymin": 0,
                "ymax": self.units.convert_units(600, "m"),
            }
        )

    def grid_type(self) -> str:
        return "simplex"

    def meshing_arguments(self) -> dict:
        return {"cell_size": self.units.convert_units(
            self.params.get("cell_size", 20.0), "m"
        )}


class BoundaryConditions:
    """Pressure drop from west (4e6 Pa) to east (1e6 Pa)."""

    def bc_type_darcy_flux(self, sd) -> pt.BoundaryCondition:
        sides = self.domain_boundary_sides(sd)
        return pt.BoundaryCondition(sd, sides.west | sides.east, "dir")

    def bc_values_pressure(self, bg) -> np.ndarray:
        sides = self.domain_boundary_sides(bg)
        values = np.zeros(bg.num_cells)
        values[sides.west] = self.units.convert_units(4e6, "Pa")
        values[sides.east] = self.units.convert_units(1e6, "Pa")
        return values


class FlowBenchmark2dCase4Model(
    FluxDiscretization,
    Geometry,
    Permeability,
    BoundaryConditions,
    pt.SinglePhaseFlow,
):
    """Complete model for case 4 of the 2d flow benchmark."""
