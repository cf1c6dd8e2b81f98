"""Half-space predicates and constructions (reference
``geometry/half_space.py``): membership in an intersection of half spaces,
a robust interior point via linear programming, and the vertices of a
convex domain via the dual (qhull half-space intersection)."""

from __future__ import annotations

import numpy as np

__all__ = [
    "point_inside_half_space_intersection",
    "half_space_interior_point",
    "vertexes_of_convex_domain",
]


def point_inside_half_space_intersection(
    n: np.ndarray, x0: np.ndarray, pts: np.ndarray
) -> np.ndarray:
    """True for points inside ALL half spaces ``(x - x0_i) . n_i <= 0``
    (normals point out of the half spaces)."""
    n = np.atleast_2d(n)
    x0 = np.atleast_2d(x0)
    pts = np.atleast_2d(pts)
    if n.shape[0] != 3 or x0.shape[0] != 3 or pts.shape[0] != 3:
        raise ValueError("n, x0 and pts must be 3 x k arrays")
    if n.shape[1] != x0.shape[1]:
        raise ValueError("One base point per normal vector required")
    # (num_planes, num_pts) signed distances in one product.
    d = n.T @ pts - np.sum(n * x0, axis=0)[:, None]
    return np.all(d <= 0, axis=0)


def half_space_interior_point(
    n: np.ndarray, x0: np.ndarray, pts: np.ndarray, recompute: bool = True
) -> np.ndarray:
    """A point strictly inside the intersection of the half spaces
    ``(x - x0_i) . n_i <= 0``, found by maximizing the margin with a small
    linear program (the Chebyshev-center construction of qhull's ``qhalf``
    notes; reference ``half_space.py:63``). ``pts`` bounds the search box.

    With ``recompute``, a failed solve is retried with flipped normals
    (tolerating the opposite orientation convention). Raises ``ValueError``
    when the intersection is empty.
    """
    import scipy.optimize as opt

    n = np.atleast_2d(np.asarray(n, dtype=float))
    x0 = np.atleast_2d(np.asarray(x0, dtype=float))
    pts = np.atleast_2d(np.asarray(pts, dtype=float))
    # max t  s.t.  n_i . x + t <= n_i . x0_i  within the bounding box of pts
    num = n.shape[1]
    c = np.zeros(4)
    c[3] = -1.0
    A_ub = np.column_stack([n.T, np.ones(num)])
    b_ub = np.sum(n * x0, axis=0)
    lo, hi = pts.min(axis=1), pts.max(axis=1)
    bounds = [(lo[0], hi[0]), (lo[1], hi[1]), (lo[2], hi[2]), (0.0, None)]
    res = opt.linprog(c, A_ub, b_ub, bounds=bounds)
    if (not res.success or np.isclose(res.x[3], 0.0)) and recompute:
        return half_space_interior_point(-n, x0, pts, recompute=False)
    if res.success and not np.isclose(res.x[3], 0.0):
        return np.asarray(res.x[:3])
    raise ValueError("Half space intersection empty")


def vertexes_of_convex_domain(A: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Vertices of the convex domain ``{x : A x + b <= 0}`` (2d or 3d) via
    scipy's qhull half-space intersection (reference
    ``half_space.py:143``). Raises ``QhullError`` for unbounded/ill-posed
    input, ``ValueError`` for an empty domain."""
    import scipy.optimize as opt
    from scipy.spatial import HalfspaceIntersection

    A = np.asarray(A, dtype=float)
    b = np.asarray(b, dtype=float).reshape(-1)
    # Chebyshev center: max t s.t. A x + t ||A_i|| <= -b.
    norms = np.linalg.norm(A, axis=1)
    res = opt.linprog(
        np.append(np.zeros(A.shape[1]), -1.0),
        np.column_stack([A, norms]),
        -b,
        bounds=[(None, None)] * A.shape[1] + [(0.0, None)],
    )
    if not res.success or np.isclose(res.x[-1], 0.0):
        raise ValueError("Half space intersection empty or degenerate")
    interior = res.x[:-1]
    hs = HalfspaceIntersection(
        np.column_stack([A, b]), interior
    )
    return hs.intersections.T
