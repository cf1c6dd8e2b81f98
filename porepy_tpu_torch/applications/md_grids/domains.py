"""Canned domains (reference ``applications/md_grids/domains.py``)."""

from __future__ import annotations

from porepy_tpu_torch.geometry.domain import Domain

__all__ = ["nd_cube_domain", "unit_cube_domain"]


def nd_cube_domain(dimension: int, size) -> Domain:
    box = {"xmin": 0.0, "xmax": size, "ymin": 0.0, "ymax": size}
    if dimension == 3:
        box.update({"zmin": 0.0, "zmax": size})
    elif dimension != 2:
        raise ValueError("Only 2d and 3d cube domains supported")
    return Domain(box)


def unit_cube_domain(dimension: int) -> Domain:
    return nd_cube_domain(dimension, 1.0)
