"""Canned mixed-dimensional grids (reference
``applications/md_grids/mdg_library.py``). Simplex variants require gmsh;
cartesian/tensor variants are gmsh-free."""

from __future__ import annotations

from typing import Optional

import numpy as np

from porepy_tpu_torch.applications.md_grids import domains, fracture_sets
from porepy_tpu_torch.fracs.fracture_network import create_fracture_network
from porepy_tpu_torch.grids.mdg_generation import create_mdg

__all__ = [
    "square_with_orthogonal_fractures",
    "cube_with_orthogonal_fractures",
    "seven_fractures_one_L_intersection",
    "benchmark_regular_2d",
]


def square_with_orthogonal_fractures(
    grid_type: str,
    meshing_args: dict,
    fracture_indices: list[int],
    fracture_endpoints: Optional[list] = None,
    size=1,
    **meshing_kwargs,
):
    """Unit(ish) square with one or two axis-aligned fractures through the
    middle. Returns (mdg, fracture network)."""
    if fracture_endpoints is None:
        fracture_endpoints = []
    if len(fracture_endpoints) != 2:
        all_endpoints = [np.array([0, size]), np.array([0, size])]
        for ind, endpoint in zip(fracture_indices, fracture_endpoints):
            all_endpoints[ind] = endpoint
        fracture_endpoints = all_endpoints
    all_fractures = fracture_sets.orthogonal_fractures_2d(
        size, fracture_endpoints
    )
    fractures = [all_fractures[i] for i in fracture_indices]
    domain = domains.nd_cube_domain(2, size)
    network = create_fracture_network(fractures, domain)
    mdg = create_mdg(grid_type, meshing_args, network, **meshing_kwargs)
    mdg.compute_geometry()
    return mdg, network


def cube_with_orthogonal_fractures(
    grid_type: str,
    meshing_args: dict,
    fracture_indices: list[int],
    size=1,
    **meshing_kwargs,
):
    """Cube with up to three axis-aligned plane fractures through the
    middle. Returns (mdg, fracture network)."""
    all_fractures = fracture_sets.orthogonal_fractures_3d(size)
    fractures = [all_fractures[i] for i in fracture_indices]
    domain = domains.nd_cube_domain(3, size)
    network = create_fracture_network(fractures, domain)
    mdg = create_mdg(grid_type, meshing_args, network, **meshing_kwargs)
    mdg.compute_geometry()
    return mdg, network


def seven_fractures_one_L_intersection(meshing_args: dict, **meshing_kwargs):
    """Berge et al. 2019 example geometry (simplex meshing; needs gmsh)."""
    from porepy_tpu_torch.geometry.domain import Domain

    fractures = fracture_sets.seven_fractures_one_L_intersection()
    domain = Domain({"xmin": 0, "xmax": 2, "ymin": 0, "ymax": 1})
    network = create_fracture_network(fractures, domain)
    mdg = create_mdg("simplex", meshing_args, network, **meshing_kwargs)
    mdg.compute_geometry()
    return mdg, network


def benchmark_regular_2d(meshing_args: dict, is_coarse: bool = False, **kwargs):
    """Flemisch et al. 2018 case-1 geometry (simplex meshing; needs gmsh)."""
    fractures = fracture_sets.benchmark_2d_case_1()
    domain = domains.unit_cube_domain(2)
    network = create_fracture_network(fractures, domain)
    mdg = create_mdg("simplex", meshing_args, network, **kwargs)
    mdg.compute_geometry()
    return mdg, network


def benchmark_3d_case_2(
    refinement_level: int = 0, msh_file: Optional[str] = None
):
    """Geometry of case 2 of the 3d flow benchmark (Berre et al. 2021;
    reference ``applications/md_grids/mdg_library.py:287``).

    All nine fractures of this case are axis-aligned rectangles, so the
    default path meshes it NATIVELY (no gmsh) with a fracture-conforming
    structured tetrahedral grid
    (:func:`porepy_tpu.fracs.structured_simplex.tet_cart_grid`):
    refinement levels 0/1/2 use 16/24/32 lattice cubes per axis
    (~25k/83k/197k tets; the reference's gmsh meshes are ~500/4k/32k).
    Pass an externally meshed MSH 4.1 file as ``msh_file`` to reproduce
    the reference's exact unstructured meshes instead. Returns
    ``(mdg, network)``.
    """
    if msh_file is not None:
        return _benchmark_3d("benchmark_3d_case_2", refinement_level, msh_file)
    from pathlib import Path

    import numpy as np

    from porepy_tpu_torch.fracs import fracture_importer
    from porepy_tpu_torch.fracs.structured_simplex import tet_cart_grid

    lib = Path(__file__).parent / "file_library" / "benchmark_3d_case_2"
    network = fracture_importer.network_3d_from_csv(
        str(lib / "fracture_network.csv")
    )
    n = {0: 16, 1: 24, 2: 32}[int(refinement_level)]
    fracs = [f.pts for f in network.fractures]
    mdg = tet_cart_grid(fracs, np.array([n, n, n]), physdims=[1.0, 1.0, 1.0])
    mdg.compute_geometry()
    return mdg, network


def benchmark_3d_case_3(
    refinement_level: int = 0, msh_file: Optional[str] = None
):
    """Geometry of case 3 of the 3d flow benchmark (Berre et al. 2021):
    8 fractures including inclined and T-intersecting planes in the box
    (0,0,0)-(1,2.25,1) (reference meshes it exclusively through gmsh,
    reference ``examples/flow_benchmark_3d_case_3.py:5-9``).

    The default path meshes it NATIVELY (no gmsh) with the conforming
    cut-tet mesher (:func:`porepy_tpu.fracs.cut_tet.cut_tet_grid`):
    refinement levels 0-3 use lattices giving roughly 30k/140k/350k/500k
    tets, mirroring the reference's level sizes. Pass an externally meshed
    MSH 4.1 file as ``msh_file`` to reproduce the reference's exact
    unstructured meshes instead. Returns ``(mdg, network)``.
    """
    if msh_file is not None:
        return _benchmark_3d("benchmark_3d_case_3", refinement_level, msh_file)
    from pathlib import Path

    import numpy as np

    from porepy_tpu_torch.fracs import fracture_importer
    from porepy_tpu_torch.fracs.cut_tet import cut_tet_grid

    lib = Path(__file__).parent / "file_library" / "benchmark_3d_case_3"
    network = fracture_importer.network_3d_from_csv(
        str(lib / "fracture_network.csv")
    )
    nx = {
        0: (9, 20, 9),
        1: (15, 34, 15),
        2: (21, 47, 21),
        3: (24, 54, 24),
    }[int(refinement_level)]
    fracs = [f.pts for f in network.fractures]
    mdg = cut_tet_grid(
        fracs,
        np.array(nx),
        physdims=[1.0, 2.25, 1.0],
        exact_boundary=False,
    )
    mdg.compute_geometry()
    return mdg, network


def _benchmark_3d(case: str, refinement_level: int, msh_file):
    from pathlib import Path

    from porepy_tpu_torch.fracs import fracture_importer, meshing
    from porepy_tpu_torch.fracs.msh_2_grid import create_grids_from_msh

    lib = Path(__file__).parent / "file_library" / case
    network = fracture_importer.network_3d_from_csv(
        str(lib / "fracture_network.csv")
    )
    if msh_file is None:
        geos = sorted(g.name for g in lib.glob("mesh*.geo"))
        raise RuntimeError(
            f"Meshing {case} requires gmsh (not installable in this image). "
            f"Mesh one of the checked-in geometries offline, e.g. "
            f"'gmsh -3 {lib}/{geos[min(refinement_level, len(geos) - 1)]} "
            f"-o case.msh -format msh41', and pass msh_file='case.msh'."
        )
    grids = create_grids_from_msh(msh_file)
    mdg = meshing.subdomains_to_mdg(grids)
    mdg.compute_geometry()
    return mdg, network
