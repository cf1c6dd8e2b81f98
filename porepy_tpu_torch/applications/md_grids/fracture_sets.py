"""Canned fracture sets (reference
``applications/md_grids/fracture_sets.py``)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from porepy_tpu_torch.fracs.fracture import LineFracture, PlaneFracture
from porepy_tpu_torch.fracs.utils import pts_edges_to_linefractures

__all__ = [
    "orthogonal_fractures_2d",
    "orthogonal_fractures_3d",
    "benchmark_2d_case_1",
    "benchmark_2d_case_3",
    "seven_fractures_one_L_intersection",
]


def orthogonal_fractures_2d(
    size, fracture_endpoints: Optional[list] = None
) -> list[LineFracture]:
    """Two orthogonal line fractures; fracture i has constant coordinate i
    equal to size / 2."""
    if fracture_endpoints is None:
        fracture_endpoints = [np.array([0, size]), np.array([0, size])]
    fracture_endpoints = [pts.reshape((1, 2)) for pts in fracture_endpoints]
    constant = np.array([0.5, 0.5]).reshape((1, 2)) * size
    pts = [
        np.vstack((constant, fracture_endpoints[0])),
        np.vstack((fracture_endpoints[1], constant)),
    ]
    return [LineFracture(p) for p in pts]


def orthogonal_fractures_3d(size) -> list[PlaneFracture]:
    """Three orthogonal plane fractures; fracture i has constant coordinate
    i equal to size / 2."""
    a = [0.5, 0.5, 0.5, 0.5]
    b = [0, 0, 1, 1]
    c = [0, 1, 1, 0]
    pts = [
        np.array([a, b, c]) * size,
        np.array([b, a, c]) * size,
        np.array([b, c, a]) * size,
    ]
    return [PlaneFracture(p) for p in pts]


def benchmark_2d_case_1(size=1) -> list[LineFracture]:
    """Six fractures (Flemisch et al. 2018, case 1)."""
    points = (
        np.array(
            [
                [0.0, 0.5], [1.0, 0.5], [0.5, 0.0], [0.5, 1.0],
                [0.5, 0.75], [1.0, 0.75], [0.75, 0.5], [0.75, 1.0],
                [0.5, 0.625], [0.75, 0.625], [0.625, 0.5], [0.625, 0.75],
            ]
        ).T
        * size
    )
    fracs = np.array([[0, 1], [2, 3], [4, 5], [6, 7], [8, 9], [10, 11]]).T
    return pts_edges_to_linefractures(points, fracs)


def benchmark_2d_case_3(size=1) -> list[LineFracture]:
    """Ten fractures (Flemisch et al. 2018, case 3)."""
    points = [
        np.array([[0.0500, 0.2200], [0.4160, 0.0624]]),
        np.array([[0.0500, 0.2500], [0.2750, 0.1350]]),
        np.array([[0.1500, 0.4500], [0.6300, 0.0900]]),
        np.array([[0.1500, 0.4000], [0.9167, 0.5000]]),
        np.array([[0.6500, 0.849723], [0.8333, 0.167625]]),
        np.array([[0.7000, 0.849723], [0.2350, 0.167625]]),
        np.array([[0.6000, 0.8500], [0.3800, 0.2675]]),
        np.array([[0.3500, 0.8000], [0.9714, 0.7143]]),
        np.array([[0.7500, 0.9500], [0.9574, 0.8155]]),
        np.array([[0.1500, 0.4000], [0.8363, 0.9727]]),
    ]
    return [LineFracture(p * size) for p in points]


def seven_fractures_one_L_intersection(size=1) -> list[LineFracture]:
    """Berge et al. 2019 example-one geometry (domain 2*size x size)."""
    points = np.array(
        [
            [0.2, 0.7], [0.5, 0.7], [0.8, 0.65], [1, 0.3], [1.8, 0.4],
            [0.2, 0.3], [0.6, 0.25], [1.0, 0.4], [1.7, 0.85], [1.5, 0.65],
            [2.0, 0.55], [1.5, 0.05], [1.4, 0.25],
        ]
    ).T
    fracs = np.array([[0, 1], [1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12]]).T
    return pts_edges_to_linefractures(points * size, fracs)
