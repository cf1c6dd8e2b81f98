"""Cell-wise tangential/normal coordinate frames on fracture grids.

Capability counterpart of reference ``utils/tangential_normal_projection.py``
(same tangent-direction conventions so contact-state fields agree), built
batched: all frames are assembled in one shot as an ``(n, dim, dim)`` row
stack — rows are the ``dim - 1`` unit tangents followed by the unit normal —
and every projection matrix is a direct COO construction from that stack.
Because each frame is orthonormal, the inverse the reference computes with a
per-cell LU loop is simply the transpose here; there is no per-cell Python
loop anywhere.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sps

__all__ = ["TangentialNormalProjection", "set_local_coordinate_projections"]


def _frames_2d(n: np.ndarray) -> np.ndarray:
    """(num, 2, 2) row stacks (tangent; normal) for unit normals ``n``
    (2 x num). Tangent convention: the tangent's first component is kept
    non-negative (flipped with the sign of ``n_y``); a horizontal tangent
    for vertical-free normals."""
    num = n.shape[1]
    s = np.sign(n[1])
    t = np.stack([s * n[1], -s * n[0]], axis=0)
    t[:, s == 0] = np.array([[0.0], [1.0]])
    frames = np.empty((num, 2, 2))
    frames[:, 0, :] = t.T
    frames[:, 1, :] = n.T
    return frames


def _frames_3d(n: np.ndarray) -> np.ndarray:
    """(num, 3, 3) row stacks (t1; t2; normal). The first tangent zeroes the
    dominant normal component: with ``i = argmax |n|`` and ``j < k`` the
    remaining axes, ``t1[j] = -n[k], t1[k] = n[j]`` (degenerate axis-aligned
    normals fall back to ``t1[j] = 1``); ``t2 = n x t1``."""
    num = n.shape[1]
    i = np.argmax(np.abs(n), axis=0)
    others = np.array([[1, 2], [0, 2], [0, 1]])[i]  # (num, 2), ascending
    j, k = others[:, 0], others[:, 1]
    cols = np.arange(num)
    t1 = np.zeros_like(n)
    t1[j, cols] = -n[k, cols]
    t1[k, cols] = n[j, cols]
    degenerate = np.hypot(n[j, cols], n[k, cols]) < 1e-8
    t1[j[degenerate], cols[degenerate]] = 1.0
    t1 /= np.linalg.norm(t1, axis=0)
    t2 = np.cross(n, t1, axis=0)
    t2 /= np.linalg.norm(t2, axis=0)
    frames = np.empty((num, 3, 3))
    frames[:, 0, :] = t1.T
    frames[:, 1, :] = t2.T
    frames[:, 2, :] = n.T
    return frames


def _block_diag(blocks: np.ndarray) -> sps.csc_matrix:
    """Block-diagonal sparse matrix from a dense ``(num, r, c)`` stack."""
    num, r, c = blocks.shape
    rows = r * np.arange(num)[:, None, None] + np.arange(r)[None, :, None]
    cols = c * np.arange(num)[:, None, None] + np.arange(c)[None, None, :]
    return sps.csc_matrix(
        (
            blocks.ravel(),
            (np.broadcast_to(rows, blocks.shape).ravel(),
             np.broadcast_to(cols, blocks.shape).ravel()),
        ),
        shape=(num * r, num * c),
    )


class TangentialNormalProjection:
    """Projections between global and local (tangential/normal) coordinates
    for a batch of normal vectors (``dim x num`` array, one frame per
    column). Reference: ``utils/tangential_normal_projection.py:20``."""

    def __init__(self, normals: np.ndarray) -> None:
        unit = normals / np.linalg.norm(normals, axis=0)
        self.dim, self.num_vecs = unit.shape
        self.normals = unit
        self._frames = _frames_2d(unit) if self.dim == 2 else _frames_3d(unit)

    def local_frames(self) -> np.ndarray:
        """Dense ``(num, dim, dim)`` stack; rows are tangents then normal."""
        return self._frames

    def _blocks(self, num: Optional[int], rows: slice) -> np.ndarray:
        frames = self._frames[:, rows, :]
        if num is not None:
            frames = np.broadcast_to(frames[:1], (num,) + frames.shape[1:])
        return frames

    def project_tangential_normal(
        self, num: Optional[int] = None
    ) -> sps.spmatrix:
        """Block-diagonal projection to local coordinates: within each
        ``dim x dim`` block the first ``dim - 1`` rows map to the tangent
        components, the last to the normal component."""
        return _block_diag(self._blocks(num, slice(None)))

    def project_tangential(self, num: Optional[int] = None) -> sps.spmatrix:
        """Rectangular block-diagonal projection onto the tangent space
        (``(dim-1) * n`` rows)."""
        return _block_diag(self._blocks(num, slice(0, self.dim - 1)))

    def project_normal(self, num: Optional[int] = None) -> sps.spmatrix:
        """Rectangular block-diagonal projection onto the normal direction
        (``n`` rows)."""
        return _block_diag(self._blocks(num, slice(self.dim - 1, self.dim)))


def set_local_coordinate_projections(mdg, interfaces=None) -> None:
    """Store a TangentialNormalProjection in the data dict of every
    codimension-1 subdomain (reference
    ``tangential_normal_projection.py:289``). The normal of each fracture
    cell is the outward normal of the primary ("first") side's host faces,
    averaged onto the fracture through the mortar projections."""
    if interfaces is None:
        interfaces = mdg.interfaces(dim=mdg.dim_max() - 1)
    for intf in interfaces:
        if intf.dim != mdg.dim_max() - 1:
            continue
        sd_primary, sd_secondary = mdg.interface_to_subdomain_pair(intf)
        surface_faces = intf.primary_to_mortar_int().tocsr().indices
        sgn, _ = sd_primary.signs_and_cells_of_boundary_faces(surface_faces)
        outward = sd_primary.face_normals[: sd_primary.dim] / sd_primary.face_areas
        outward[:, surface_faces] *= sgn
        # The duplicated ("other") side's faces are zeroed so only the first
        # side defines the positive normal direction.
        outward[:, intf._ind_face_on_other_side] = 0
        on_mortar = intf.primary_to_mortar_int() @ outward.T
        on_secondary = (intf.mortar_to_secondary_int() @ on_mortar).T
        mdg.subdomain_data(sd_secondary)["tangential_normal_projection"] = (
            TangentialNormalProjection(on_secondary)
        )


def sides_of_fracture(intf, sd_primary, direction):
    """Split a planar interface's mortar cells into the positive and
    negative side relative to ``direction`` (outward matrix normals with
    positive/negative inner product), and report whether the positive side
    is the mortar grid's FIRST side — which fixes the sign convention of
    jumps across the interface (reference
    ``utils/tangential_normal_projection.py:370``).

    Returns ``(positive_cells, negative_cells, positive_side_first)``.
    """
    from porepy_tpu_torch.utils.grid_utils import switch_sign_if_inwards_normal

    faces = np.where(sd_primary.tags["fracture_faces"])[0]
    switch = switch_sign_if_inwards_normal(sd_primary, 3, faces)
    normal_primary = switch @ sd_primary.face_normals.ravel(order="F")
    normal_intf = (
        intf.primary_to_mortar_avg(3) @ normal_primary
    ).reshape((3, -1), order="F")
    direction = np.broadcast_to(
        np.reshape(np.asarray(direction, dtype=float), (3, -1)),
        normal_intf.shape,
    )
    inner = np.sum(normal_intf * direction, axis=0)
    if np.allclose(inner, 0):
        raise ValueError("The direction vector is orthogonal to the normals")
    negative = np.where(inner < 0)[0]
    positive = np.where(inner >= 0)[0]
    # Mortar cells are numbered all of side 1, then all of side 2.
    n_first = next(iter(intf.side_grids.values())).num_cells
    if np.array_equal(positive, np.arange(n_first)):
        positive_side_first = True
    elif np.array_equal(negative, np.arange(n_first)):
        positive_side_first = False
    else:
        raise ValueError(
            "Could not identify the positive side with a mortar side"
        )
    return positive, negative, positive_side_first
