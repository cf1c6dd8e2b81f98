"""Tensor-product and Cartesian grids in 1/2/3d.

Index conventions are identical to the reference implementation
(``/root/reference/src/porepy/grids/structured.py:22,344``) so that grids,
discretizations and golden arrays are directly comparable:

- Faces are numbered x-faces first, then y-faces, then z-faces.
- 2d: node ``(ix, iy) -> iy*(nx+1) + ix``; x-face ``(ix, iy) ->
  iy*(nx+1)+ix``; y-face ``(ix, iy) -> nfx + iy*nx + ix``. Face node order
  encodes orientation: x-faces run low->high y (normal +x), y-faces run
  high->low x (normal +y).
- 3d: F-order numbering, ``node(ix,iy,iz) = ix + iy*(nx+1) +
  iz*(nx+1)*(ny+1)``; face-node loops are oriented so normals point in +x,
  +y, +z.
- ``cell_faces`` signs: the lower-index face of each cell carries -1, the
  upper +1 (normal out of the cell with entry +1).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sps

from porepy_tpu_torch.grids.grid import Grid

__all__ = ["TensorGrid", "CartGrid"]


def _csc_from_fixed_stride(
    indices: np.ndarray, stride: int, n_cols: int, n_rows: int, data: np.ndarray
) -> sps.csc_matrix:
    indptr = np.arange(0, stride * n_cols + 1, stride)
    return sps.csc_matrix((data, indices, indptr), shape=(n_rows, n_cols))


class TensorGrid(Grid):
    """Grid from a tensor product of 1-3 coordinate lines."""

    def __init__(
        self,
        x: np.ndarray,
        y: Optional[np.ndarray] = None,
        z: Optional[np.ndarray] = None,
        name: Optional[str] = None,
    ) -> None:
        name = name or "TensorGrid"
        x = np.asarray(x, dtype=float)
        if y is None:
            nodes, fn, cf = _tensor_1d(x)
            self.cart_dims = np.array([x.size - 1])
            super().__init__(1, nodes, fn, cf, name)
        elif z is None:
            y = np.asarray(y, dtype=float)
            nodes, fn, cf = _tensor_2d(x, y)
            self.cart_dims = np.array([x.size - 1, y.size - 1])
            super().__init__(2, nodes, fn, cf, name)
        else:
            y = np.asarray(y, dtype=float)
            z = np.asarray(z, dtype=float)
            nodes, fn, cf = _tensor_3d(x, y, z)
            self.cart_dims = np.array([x.size - 1, y.size - 1, z.size - 1])
            super().__init__(3, nodes, fn, cf, name)


class CartGrid(TensorGrid):
    """Uniform Cartesian grid.

    Parameters:
        nx: Number of cells per dimension (length 1, 2 or 3).
        physdims: Physical extent per dimension; defaults to ``nx`` (unit
            cells).
    """

    def __init__(self, nx, physdims=None, name: Optional[str] = None) -> None:
        nx = np.asarray(nx, dtype=int)
        if physdims is None:
            physdims = nx.astype(float)
        elif isinstance(physdims, dict):
            # Domain-style dict {"xmax": ..., "ymax": ...}.
            keys = ["xmax", "ymax", "zmax"][: nx.size]
            physdims = np.array([physdims[k] for k in keys], dtype=float)
        else:
            physdims = np.asarray(physdims, dtype=float)
        name = name or "CartGrid"

        lines = [np.linspace(0.0, physdims[i], nx[i] + 1) for i in range(nx.size)]
        super().__init__(*lines, name=name)


def _tensor_1d(x: np.ndarray):
    n = x.size
    nc, nf, nn = n - 1, n, n
    nodes = np.vstack([x, np.zeros(n), np.zeros(n)])

    fn = _csc_from_fixed_stride(
        np.arange(nf), 1, nf, nn, np.ones(nf, dtype=bool)
    )

    cf_ind = np.empty(2 * nc, dtype=int)
    cf_ind[0::2] = np.arange(nc)
    cf_ind[1::2] = np.arange(1, nc + 1)
    cf_data = np.empty(2 * nc, dtype=int)
    cf_data[0::2] = -1
    cf_data[1::2] = 1
    cf = _csc_from_fixed_stride(cf_ind, 2, nc, nf, cf_data)
    return nodes, fn, cf


def _tensor_2d(x: np.ndarray, y: np.ndarray):
    nx, ny = x.size - 1, y.size - 1
    nn = (nx + 1) * (ny + 1)
    nfx = (nx + 1) * ny
    nfy = nx * (ny + 1)
    nf = nfx + nfy
    nc = nx * ny

    xs = np.tile(x, ny + 1)
    ys = np.repeat(y, nx + 1)
    nodes = np.vstack([xs, ys, np.zeros(nn)])

    def node(ix, iy):
        return iy * (nx + 1) + ix

    # x-faces (normal +x): oriented from (ix, iy) to (ix, iy+1).
    iy, ix = np.divmod(np.arange(nfx), nx + 1)
    fx_start = node(ix, iy)
    fx_end = node(ix, iy + 1)
    # y-faces (normal +y): oriented from (ix+1, iy) to (ix, iy).
    iy, ix = np.divmod(np.arange(nfy), nx)
    fy_start = node(ix + 1, iy)
    fy_end = node(ix, iy)

    fn_ind = np.empty(2 * nf, dtype=int)
    fn_ind[0 : 2 * nfx : 2] = fx_start
    fn_ind[1 : 2 * nfx : 2] = fx_end
    fn_ind[2 * nfx :: 2] = fy_start
    fn_ind[2 * nfx + 1 :: 2] = fy_end
    fn = _csc_from_fixed_stride(fn_ind, 2, nf, nn, np.ones(2 * nf, dtype=bool))

    # Cells in C-order: cell (ix, iy) -> iy*nx + ix.
    iy, ix = np.divmod(np.arange(nc), nx)
    west = iy * (nx + 1) + ix
    east = iy * (nx + 1) + ix + 1
    south = nfx + iy * nx + ix
    north = nfx + (iy + 1) * nx + ix
    cf_ind = np.vstack([west, east, south, north]).ravel(order="F")
    cf_data = np.tile(np.array([-1, 1, -1, 1]), nc)
    cf = _csc_from_fixed_stride(cf_ind, 4, nc, nf, cf_data)
    return nodes, fn, cf


def _tensor_3d(x: np.ndarray, y: np.ndarray, z: np.ndarray):
    nx, ny, nz = x.size - 1, y.size - 1, z.size - 1
    nn = (nx + 1) * (ny + 1) * (nz + 1)
    nfx = (nx + 1) * ny * nz
    nfy = nx * (ny + 1) * nz
    nfz = nx * ny * (nz + 1)
    nf = nfx + nfy + nfz
    nc = nx * ny * nz

    xs = np.tile(x, (ny + 1) * (nz + 1))
    ys = np.tile(np.repeat(y, nx + 1), nz + 1)
    zs = np.repeat(z, (nx + 1) * (ny + 1))
    nodes = np.vstack([xs, ys, zs])

    def node(ix, iy, iz):
        return ix + iy * (nx + 1) + iz * (nx + 1) * (ny + 1)

    def unravel_f(ids, d0, d1):
        """F-order unravel of ids over dims (d0, d1, d2)."""
        i0 = ids % d0
        rest = ids // d0
        i1 = rest % d1
        i2 = rest // d1
        return i0, i1, i2

    # x-faces: loop (iy,iz)->(iy+1,iz)->(iy+1,iz+1)->(iy,iz+1), normal +x.
    ix, iy, iz = unravel_f(np.arange(nfx), nx + 1, ny)
    fx = np.vstack(
        [
            node(ix, iy, iz),
            node(ix, iy + 1, iz),
            node(ix, iy + 1, iz + 1),
            node(ix, iy, iz + 1),
        ]
    )
    # y-faces: loop (ix,iz)->(ix,iz+1)->(ix+1,iz+1)->(ix+1,iz), normal +y.
    ix, iy, iz = unravel_f(np.arange(nfy), nx, ny + 1)
    fy = np.vstack(
        [
            node(ix, iy, iz),
            node(ix, iy, iz + 1),
            node(ix + 1, iy, iz + 1),
            node(ix + 1, iy, iz),
        ]
    )
    # z-faces: loop (ix,iy)->(ix+1,iy)->(ix+1,iy+1)->(ix,iy+1), normal +z.
    ix, iy, iz = unravel_f(np.arange(nfz), nx, ny)
    fz = np.vstack(
        [
            node(ix, iy, iz),
            node(ix + 1, iy, iz),
            node(ix + 1, iy + 1, iz),
            node(ix, iy + 1, iz),
        ]
    )

    fn_ind = np.hstack(
        [fx.ravel(order="F"), fy.ravel(order="F"), fz.ravel(order="F")]
    )
    fn = _csc_from_fixed_stride(fn_ind, 4, nf, nn, np.ones(4 * nf, dtype=bool))

    # Cells in F-order: cell (ix, iy, iz) -> ix + iy*nx + iz*nx*ny.
    ix, iy, iz = unravel_f(np.arange(nc), nx, ny)
    west = ix + iy * (nx + 1) + iz * (nx + 1) * ny
    east = west + 1
    south = nfx + ix + iy * nx + iz * nx * (ny + 1)
    north = south + nx
    zlow = nfx + nfy + ix + iy * nx + iz * nx * ny
    zhigh = zlow + nx * ny
    cf_ind = np.vstack([west, east, south, north, zlow, zhigh]).ravel(order="F")
    cf_data = np.tile(np.array([-1, 1, -1, 1, -1, 1]), nc)
    cf = _csc_from_fixed_stride(cf_ind, 6, nc, nf, cf_data)
    return nodes, fn, cf
