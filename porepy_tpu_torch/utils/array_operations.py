"""Array set-operations (reference ``utils/array_operations.py``).

Host-side numpy kernels used by meshing/bookkeeping code.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "ismember_columns",
    "expand_index_pointers",
    "expand_indices_nd",
    "uniquify_point_set",
]


def uniquify_point_set(
    points: np.ndarray, tol: float
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Merge points closer than ``tol``; each unique point is the first
    encountered (reference ``array_operations.py:569``). Returns the reduced
    point set, the indices of the kept columns, and the inverse map."""
    points = np.asarray(points, dtype=float)
    n = points.shape[1]
    if n == 0:
        return (
            np.empty_like(points),
            np.zeros(0, dtype=int),
            np.zeros(0, dtype=int),
        )
    from scipy.spatial import cKDTree

    tree = cKDTree(points.T)
    # Union-find over all close pairs; the representative of each cluster is
    # its lowest (first-encountered) index.
    parent = np.arange(n)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i, j in tree.query_pairs(r=tol):
        ri, rj = find(i), find(j)
        if ri != rj:
            lo, hi = (ri, rj) if ri < rj else (rj, ri)
            parent[hi] = lo
    reps = np.array([find(i) for i in range(n)])
    ia, ib = np.unique(reps, return_inverse=True)
    return points[:, ia], ia, ib


def ismember_columns(
    a: np.ndarray, b: np.ndarray, sort: bool = True
) -> tuple[np.ndarray, np.ndarray]:
    """Column-wise membership of ``a`` in ``b``.

    Treats each column as a tuple (1d arrays are treated element-wise).

    Parameters:
        a: ``(m, na)`` or ``(na,)`` query columns.
        b: ``(m, nb)`` or ``(nb,)`` reference columns.
        sort: Sort entries within columns before comparison (set False if
            already sorted / order significant).

    Returns:
        ``(is_mem, index)`` where ``is_mem[i]`` is True if column i of ``a``
        occurs in ``b``, and ``index`` holds, for each member column of
        ``a``, the index of the (first) matching column in ``b``.
    """
    a = np.atleast_2d(a)
    b = np.atleast_2d(b)
    if sort and a.shape[0] > 1:
        a = np.sort(a, axis=0)
        b = np.sort(b, axis=0)

    def encode(x):
        return np.ascontiguousarray(x.T).view(
            np.dtype((np.void, x.dtype.itemsize * x.shape[0]))
        ).ravel()

    if a.dtype != b.dtype:
        common = np.promote_types(a.dtype, b.dtype)
        a = a.astype(common)
        b = b.astype(common)
    ea = encode(a)
    eb = encode(b)
    b_sorter = np.argsort(eb, kind="stable")
    pos = np.searchsorted(eb, ea, sorter=b_sorter)
    pos_clipped = np.clip(pos, 0, eb.size - 1)
    found = eb[b_sorter[pos_clipped]] == ea
    index = b_sorter[pos_clipped][found]
    return found, index


def expand_index_pointers(start: np.ndarray, end: np.ndarray) -> np.ndarray:
    """Concatenate ``[arange(s, e) for s, e in zip(start, end)]`` without a
    Python loop (reference ``array_operations.expand_index_pointers``)."""
    start = np.asarray(start, dtype=int)
    end = np.asarray(end, dtype=int)
    counts = end - start
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=int)
    seg = np.repeat(np.arange(counts.size), counts)
    seg_begin = np.concatenate([[0], np.cumsum(counts)[:-1]])
    offsets = np.arange(total) - seg_begin[seg]
    return start[seg] + offsets


def expand_indices_nd(ind: np.ndarray, nd: int, direction: str = "F") -> np.ndarray:
    """Expand entity indices to ``nd`` dofs per entity:
    ``[i*nd, ..., i*nd + nd - 1]`` per index (F-ordering per entity)."""
    ind = np.asarray(ind, dtype=int)
    if direction == "F":
        return (ind[:, None] * nd + np.arange(nd)).ravel()
    return (ind[None, :] * nd + np.arange(nd)[:, None]).ravel()
