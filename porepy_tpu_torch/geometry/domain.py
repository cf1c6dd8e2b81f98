"""Domain abstraction (reference ``geometry/domain.py:13,323``).

Box-shaped computational domains described by a bounding-box dict, plus the
``DomainSides`` named tuple of boundary-face index masks used by model
geometry mixins.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

__all__ = ["Domain", "DomainSides", "mdg_minmax_coordinates"]


class Domain:
    """Box domain defined by a bounding box ``{xmin, xmax, ymin, ymax,
    [zmin, zmax]}`` (polytope support to be added with the fracture-network
    layer)."""

    def __init__(
        self,
        bounding_box: Optional[dict[str, float]] = None,
        polytope: Optional[list] = None,
    ) -> None:
        if (bounding_box is None) == (polytope is None):
            raise ValueError("Provide exactly one of bounding_box/polytope")
        if polytope is not None:
            raise NotImplementedError(
                "Polytope domains arrive with the fracture-network layer"
            )
        assert bounding_box is not None
        self.bounding_box = dict(bounding_box)
        if "zmin" in self.bounding_box or "zmax" in self.bounding_box:
            self.dim = 3
        else:
            self.dim = 2
        self.is_boxed = True

    def polytope_from_bounding_box(self) -> list[np.ndarray]:
        """The domain boundary as a list of line segments (2d) or plane
        polygons (3d), matching reference ``geometry/domain.py:251``."""
        bb = self.bounding_box
        x0, x1 = bb["xmin"], bb["xmax"]
        y0, y1 = bb["ymin"], bb["ymax"]
        if self.dim == 2:
            return [
                np.array([[x0, x0], [y0, y1]]),  # west
                np.array([[x1, x1], [y1, y0]]),  # east
                np.array([[x1, x0], [y0, y0]]),  # south
                np.array([[x0, x1], [y1, y1]]),  # north
            ]
        z0, z1 = bb["zmin"], bb["zmax"]
        return [
            np.array([[x0, x0, x0, x0], [y0, y1, y1, y0], [z0, z0, z1, z1]]),
            np.array([[x1, x1, x1, x1], [y0, y1, y1, y0], [z0, z0, z1, z1]]),
            np.array([[x0, x1, x1, x0], [y0, y0, y0, y0], [z0, z0, z1, z1]]),
            np.array([[x0, x1, x1, x0], [y1, y1, y1, y1], [z0, z0, z1, z1]]),
            np.array([[x0, x1, x1, x0], [y0, y0, y1, y1], [z0, z0, z0, z0]]),
            np.array([[x0, x1, x1, x0], [y0, y0, y1, y1], [z1, z1, z1, z1]]),
        ]

    @property
    def xmin(self) -> float:
        return self.bounding_box["xmin"]

    @property
    def xmax(self) -> float:
        return self.bounding_box["xmax"]

    @property
    def ymin(self) -> float:
        return self.bounding_box["ymin"]

    @property
    def ymax(self) -> float:
        return self.bounding_box["ymax"]

    @property
    def zmin(self) -> float:
        return self.bounding_box.get("zmin", 0.0)

    @property
    def zmax(self) -> float:
        return self.bounding_box.get("zmax", 0.0)

    def side_lengths(self) -> np.ndarray:
        out = [self.xmax - self.xmin, self.ymax - self.ymin]
        if self.dim == 3:
            out.append(self.zmax - self.zmin)
        return np.array(out)

    def __contains__(self, point) -> bool:
        p = np.asarray(point, dtype=float)
        ok = self.xmin <= p[0] <= self.xmax and self.ymin <= p[1] <= self.ymax
        if self.dim == 3 and p.size > 2:
            ok = ok and self.zmin <= p[2] <= self.zmax
        return bool(ok)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Domain) and self.bounding_box == other.bounding_box
        )

    def __repr__(self) -> str:
        return f"Domain({self.bounding_box})"


class DomainSides(NamedTuple):
    """Boundary-face masks per box side (reference ``geometry/domain.py:323``)."""

    all_bf: np.ndarray
    east: np.ndarray
    west: np.ndarray
    north: np.ndarray
    south: np.ndarray
    top: np.ndarray
    bottom: np.ndarray


def mdg_minmax_coordinates(mdg) -> tuple[np.ndarray, np.ndarray]:
    mins, maxs = [], []
    for sd in mdg.subdomains():
        if sd.dim > 0:
            lo, hi = sd.bounding_box()
            mins.append(lo)
            maxs.append(hi)
    return np.min(mins, axis=0), np.max(maxs, axis=0)
