"""User-facing mixed-dimensional grid factory (reference
``grids/mdg_generation.py:664``).

Dispatches on grid type: ``cartesian`` and ``tensor_grid`` use the
gmsh-free structured meshing in ``fracs/meshing.py``; ``simplex``
delegates to the fracture network's gmsh-backed ``mesh()``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from porepy_tpu_torch.fracs.fracture_network_2d import FractureNetwork2d
from porepy_tpu_torch.fracs.fracture_network_3d import FractureNetwork3d

__all__ = ["create_mdg"]

_VALID_GRID_TYPES = ("simplex", "cartesian", "tensor_grid")


def _network_dim(network) -> int:
    if isinstance(network, FractureNetwork2d):
        return 2
    if isinstance(network, FractureNetwork3d):
        return 3
    raise TypeError(f"Unknown fracture network type {type(network)}")


def _cells_per_direction(domain, meshing_args: dict) -> tuple[list, list]:
    box = domain.bounding_box
    dims = ["x", "y"] + (["z"] if "zmax" in box else [])
    cell_size = meshing_args.get("cell_size")
    nx, phys = [], []
    for d in dims:
        size = meshing_args.get(f"cell_size_{d}", cell_size)
        if size is None:
            raise ValueError(
                f"Either cell_size or cell_size_{d} must be provided"
            )
        length = box[f"{d}max"] - box[f"{d}min"]
        n = max(1, int(round(length / size)))
        nx.append(n)
        phys.append(box[f"{d}max"])
    return nx, phys


def create_mdg(grid_type: str, meshing_args: dict, fracture_network, **kwargs):
    """Create a mixed-dimensional grid of the requested type from a
    fracture network."""
    if not isinstance(grid_type, str) or grid_type not in _VALID_GRID_TYPES:
        raise ValueError(
            f"grid_type must be one of {_VALID_GRID_TYPES}, got {grid_type!r}"
        )
    if not isinstance(meshing_args, dict):
        raise TypeError("meshing_args must be a dict")
    dim = _network_dim(fracture_network)

    if grid_type == "simplex":
        cell_size = meshing_args.get("cell_size")
        if cell_size is None and not any(
            meshing_args.get(k) is not None
            for k in ("cell_size_min", "cell_size_boundary", "cell_size_fracture")
        ):
            raise ValueError(
                "simplex meshing requires cell_size (or one of "
                "cell_size_min/cell_size_boundary/cell_size_fracture)"
            )
        mesh_args = {
            "mesh_size_min": meshing_args.get("cell_size_min", cell_size),
            "mesh_size_bound": meshing_args.get("cell_size_boundary", cell_size),
            "mesh_size_frac": meshing_args.get("cell_size_fracture", cell_size),
        }
        return fracture_network.mesh(mesh_args, **kwargs)

    domain = fracture_network.domain
    if domain is None:
        raise ValueError(
            f"Domain is required for grid_type {grid_type!r}"
        )
    boundary_tags = fracture_network.tags.get("boundary")
    fractures = [
        f.pts
        for fi, f in enumerate(fracture_network.fractures)
        if boundary_tags is None or not boundary_tags[fi]
    ]

    from porepy_tpu_torch.fracs import meshing

    if grid_type == "cartesian":
        nx, phys = _cells_per_direction(domain, meshing_args)
        return meshing.cart_grid(
            fracs=fractures, nx=np.asarray(nx), physdims=np.asarray(phys), **kwargs
        )

    # tensor_grid
    box = domain.bounding_box
    cell_size = meshing_args.get("cell_size")

    def axis_points(d):
        user = meshing_args.get(f"{d}_pts")
        if user is not None:
            user = np.asarray(user, dtype=float)
            if user.min() != box[f"{d}min"] or user.max() != box[f"{d}max"]:
                raise ValueError(
                    f"{d}_pts must span the domain in the {d}-direction"
                )
            return user
        if cell_size is None:
            raise ValueError(f"Either cell_size or {d}_pts must be provided")
        length = box[f"{d}max"] - box[f"{d}min"]
        n = max(1, int(round(length / cell_size)))
        return np.linspace(box[f"{d}min"], box[f"{d}max"], n + 1)

    x = axis_points("x")
    y = axis_points("y") if "ymax" in box else None
    z = axis_points("z") if "zmax" in box else None
    return meshing.tensor_grid(fracs=fractures, x=x, y=y, z=z, **kwargs)
