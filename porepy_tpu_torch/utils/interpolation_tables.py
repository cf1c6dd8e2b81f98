"""Regular-grid multilinear interpolation tables with gradients.

Parity counterpart of reference ``utils/interpolation_tables.py:34,317``:
a dense table evaluating the function at construction, and an adaptive
variant filling values lazily (from a function or externally assigned
data) — the backend of table-lookup AD operators.
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional

import numpy as np

__all__ = ["InterpolationTable", "AdaptiveInterpolationTable"]


class InterpolationTable:
    """Piecewise multilinear interpolation (and piecewise-constant
    gradients) on a Cartesian point lattice over an Nd box."""

    def __init__(
        self,
        low: np.ndarray,
        high: np.ndarray,
        npt: np.ndarray,
        function: Callable,
        dim: int = 1,
    ) -> None:
        self.dim = dim
        self._param_dim = np.asarray(low).size
        self._set_sizes(np.asarray(low), np.asarray(high), np.asarray(npt))
        self._table_values = np.zeros((self.dim, self._coord[0].size))
        for i, c in enumerate(zip(*self._coord)):
            self._table_values[:, i] = function(*c)

    def _set_sizes(self, low, high, npt) -> None:
        self._low = low
        self._high = high
        self._npt = npt
        self._pt_on_axes = [
            np.linspace(low[i], high[i], npt[i]) for i in range(self._param_dim)
        ]
        self._h = (high - low) / (npt - 1)
        self._strides = np.cumprod(np.hstack((1, npt)))[
            : self._param_dim
        ].reshape((-1, 1))
        mesh = np.meshgrid(*self._pt_on_axes, indexing="ij")
        self._coord = [c.ravel("F") for c in mesh]

    @property
    def _values(self) -> np.ndarray:
        return self._table_values

    def interpolate(self, x: np.ndarray) -> np.ndarray:
        x = np.atleast_2d(x.reshape((self._param_dim, -1)))
        values = np.zeros((self.dim, x.shape[1]))
        base_ind = self._find_base_vertex(x)
        right, left = self._right_left_weights(x, base_ind)
        for incr, eval_ind in self._generate_indices(base_ind):
            weight = np.prod(right * incr + left * (1 - incr), axis=0)
            inside = eval_ind < self._values.shape[1]
            values[:, inside] += weight[inside] * self._values[:, eval_ind[inside]]
        return values

    def gradient(self, x: np.ndarray, axis: int) -> np.ndarray:
        x = np.atleast_2d(x.reshape((self._param_dim, -1)))
        values = np.zeros((self.dim, x.shape[1]))
        base_ind = self._find_base_vertex(x)
        right, left = self._right_left_weights(x, base_ind)
        for incr, eval_ind in self._generate_indices(base_ind):
            weight_nd = right * incr + left * (1 - incr)
            weight_nd[axis] = 2 * incr[axis] - 1
            values += np.prod(weight_nd, axis=0) * self._values[:, eval_ind]
        return values / self._h[axis]

    def _find_base_vertex(self, coord: np.ndarray) -> np.ndarray:
        ind = []
        for x_i, h_i, low_i, high_i in zip(
            coord, self._h, self._low, self._high
        ):
            if np.any(x_i < low_i) or np.any(high_i < x_i):
                raise ValueError(
                    f"Point(s) outside coordinate range [{self._low}, {self._high}]"
                )
            ind.append(((x_i - low_i) // h_i).astype(int))
        return np.array(ind)

    def _generate_indices(self, base_ind: np.ndarray):
        for increment in itertools.product(range(2), repeat=self._param_dim):
            incr = np.asarray(increment).reshape((-1, 1))
            yield incr, self._index_from_base_and_increment(base_ind, incr)

    def _index_from_base_and_increment(self, base_ind, incr) -> np.ndarray:
        return np.sum((base_ind + incr) * self._strides, axis=0)

    def _right_left_weights(self, x, base_ind):
        left_coord = np.array(
            [
                self._pt_on_axes[i][base_ind[i]]
                for i in range(self._param_dim)
            ]
        )
        right = (x - left_coord) / self._h.reshape((-1, 1))
        return right, 1 - right

    def __repr__(self) -> str:
        return (
            f"InterpolationTable in {self._param_dim} dimensions, "
            f"{self._values.shape[1]} points"
        )


class AdaptiveInterpolationTable(InterpolationTable):
    """Interpolation table filled lazily: values are computed (or assigned)
    only at the lattice vertices actually touched by queries."""

    def __init__(
        self,
        dx: np.ndarray,
        base_point: Optional[np.ndarray] = None,
        function: Optional[Callable] = None,
        dim: int = 1,
    ) -> None:
        self.dim = dim
        dx = np.asarray(dx, dtype=float)
        self._param_dim = dx.size
        self._h = dx
        if base_point is None:
            base_point = np.zeros(self._param_dim)
        self._base_point = np.asarray(base_point, dtype=float)
        self._function = function
        # Sparse storage: lattice multi-index (tuple) -> value column.
        self._data: dict[tuple, np.ndarray] = {}

    # -- the lattice is unbounded; identify vertices by multi-index ----------

    def _find_base_vertex(self, coord: np.ndarray) -> np.ndarray:
        return np.array(
            [
                ((coord[i] - self._base_point[i]) // self._h[i]).astype(int)
                for i in range(self._param_dim)
            ]
        )

    def _vertex_coordinates(self, multi_ind: np.ndarray) -> np.ndarray:
        return self._base_point.reshape((-1, 1)) + multi_ind * self._h.reshape(
            (-1, 1)
        )

    def quadrature_points_from_coordinates(
        self, x: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """The lattice vertices needed to interpolate at ``x`` (coordinates
        and multi-indices), for external evaluation via assign_values."""
        x = np.atleast_2d(x.reshape((self._param_dim, -1)))
        base_ind = self._find_base_vertex(x)
        all_inds = []
        for incr in itertools.product(range(2), repeat=self._param_dim):
            all_inds.append(base_ind + np.asarray(incr).reshape((-1, 1)))
        inds = np.unique(np.hstack(all_inds), axis=1)
        return self._vertex_coordinates(inds), inds

    def assign_values(
        self, values: np.ndarray, indices: np.ndarray
    ) -> None:
        values = np.atleast_2d(values).reshape((self.dim, -1))
        for k in range(indices.shape[1]):
            self._data[tuple(indices[:, k])] = values[:, k]

    def _fill(self, multi_inds: np.ndarray) -> None:
        missing = [
            tuple(multi_inds[:, k])
            for k in range(multi_inds.shape[1])
            if tuple(multi_inds[:, k]) not in self._data
        ]
        if not missing:
            return
        if self._function is None:
            raise ValueError(
                "Missing table values and no function to fill them; use "
                "assign_values first"
            )
        coords = self._vertex_coordinates(np.array(missing).T)
        for k, key in enumerate(missing):
            self._data[key] = np.atleast_1d(self._function(*coords[:, k]))

    def interpolate(self, x: np.ndarray) -> np.ndarray:
        x = np.atleast_2d(x.reshape((self._param_dim, -1)))
        values = np.zeros((self.dim, x.shape[1]))
        base_ind = self._find_base_vertex(x)
        left_coord = self._vertex_coordinates(base_ind)
        right = (x - left_coord) / self._h.reshape((-1, 1))
        left = 1 - right
        for incr in itertools.product(range(2), repeat=self._param_dim):
            incr_arr = np.asarray(incr).reshape((-1, 1))
            vert = base_ind + incr_arr
            self._fill(vert)
            weight = np.prod(right * incr_arr + left * (1 - incr_arr), axis=0)
            vals = np.column_stack(
                [self._data[tuple(vert[:, k])] for k in range(vert.shape[1])]
            )
            values += weight * vals
        return values

    def gradient(self, x: np.ndarray, axis: int) -> np.ndarray:
        x = np.atleast_2d(x.reshape((self._param_dim, -1)))
        values = np.zeros((self.dim, x.shape[1]))
        base_ind = self._find_base_vertex(x)
        left_coord = self._vertex_coordinates(base_ind)
        right = (x - left_coord) / self._h.reshape((-1, 1))
        left = 1 - right
        for incr in itertools.product(range(2), repeat=self._param_dim):
            incr_arr = np.asarray(incr).reshape((-1, 1))
            vert = base_ind + incr_arr
            self._fill(vert)
            weight_nd = right * incr_arr + left * (1 - incr_arr)
            weight_nd[axis] = 2 * incr_arr[axis] - 1
            vals = np.column_stack(
                [self._data[tuple(vert[:, k])] for k in range(vert.shape[1])]
            )
            values += np.prod(weight_nd, axis=0) * vals
        return values / self._h[axis]

    def __repr__(self) -> str:
        return (
            f"AdaptiveInterpolationTable in {self._param_dim} dimensions, "
            f"{len(self._data)} stored points"
        )
