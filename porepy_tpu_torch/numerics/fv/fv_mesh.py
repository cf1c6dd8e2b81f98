"""Finite-volume mesh data as tensors.

All topology is flattened to static-shape integer index tensors at setup,
geometry to dense float64 tensors. Transmissibilities, fluxes and
divergences are gathers and segment sums over these tensors; nothing
touches scipy.

Conceptual counterpart of what the reference framework recomputes from its
scipy CSC ``cell_faces`` matrix at each discretization call
(``/root/reference/src/porepy/numerics/fv/tpfa.py:113`` uses
``sparse_array_to_row_col_data(sd.cell_faces)``); here it is extracted once.

Half-face convention: entry ``k`` couples face ``fi[k]`` with adjacent cell
``ci[k]``; ``sgn[k]`` is +1 when the stored face normal points out of that
cell. Interior faces own two half-faces, boundary faces one. The ordering is
the CSC order of the originating grid.

The segment sums over the half-faces of a face or of a cell go through
``face_ptr``/``face_hf`` and ``cell_ptr``, two CSR views of the half-face
list built once on the host: each sum runs in the CSC order of its items,
on a CUDA tensor in the K14 ``segment_sum_sorted`` kernel
(``kernels/csrc/tpfa_ad.cu``, no atomics), on a CPU tensor in its plain
version, so the result has the same bits on every run.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import scipy.sparse as sps
import torch

from porepy_tpu_torch.kernels import functions as kfn

__all__ = ["FvMesh", "BoundaryMasks"]


def _bool(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=bool), device=device)


@dataclasses.dataclass(frozen=True)
class BoundaryMasks:
    """Face-wise boundary-condition masks.

    ``is_dir``/``is_neu`` are the *effective* masks after internal
    (fracture) boundary faces have been forced to Neumann, matching the
    primal-FV convention (reference ``numerics/fv/tpfa.py:204-206``).
    ``is_dir_raw``/``is_neu_raw`` keep the user-assigned flags, which the
    pressure-trace reconstruction uses.
    """

    is_dir: torch.Tensor
    is_neu: torch.Tensor
    is_dir_raw: torch.Tensor
    is_neu_raw: torch.Tensor
    is_rob: torch.Tensor
    is_internal: torch.Tensor

    @staticmethod
    def from_bc(bc, device: Union[str, torch.device] = "cpu") -> "BoundaryMasks":
        is_internal = np.asarray(bc.is_internal, dtype=bool)
        is_dir_raw = np.asarray(bc.is_dir, dtype=bool)
        is_neu_raw = np.asarray(bc.is_neu, dtype=bool)
        return BoundaryMasks(
            is_dir=_bool(is_dir_raw & ~is_internal, device),
            is_neu=_bool(is_neu_raw | is_internal, device),
            is_dir_raw=_bool(is_dir_raw, device),
            is_neu_raw=_bool(is_neu_raw, device),
            is_rob=_bool(bc.is_rob, device),
            is_internal=_bool(is_internal, device),
        )


@dataclasses.dataclass(frozen=True)
class FvMesh:
    """Static-shape finite-volume view of a
    :class:`~porepy_tpu_torch.grids.grid.Grid`.

    Data fields are tensors; ``dim``/``num_cells``/``num_faces``/
    ``num_half_faces`` are plain ints.
    """

    # Half-face topology (num_half_faces,)
    fi: torch.Tensor  # face index of each half-face (int64)
    ci: torch.Tensor  # cell index of each half-face (int64)
    sgn: torch.Tensor  # +-1.0: normal out of cell ci -> +1

    # CSR views of the half-face list (int32): the half-faces of face f are
    # face_hf[face_ptr[f]:face_ptr[f + 1]], ascending; those of cell c are
    # cell_ptr[c]:cell_ptr[c + 1] themselves (the list is in CSC order).
    face_ptr: torch.Tensor  # (num_faces + 1,)
    face_hf: torch.Tensor  # (num_half_faces,)
    cell_ptr: torch.Tensor  # (num_cells + 1,)

    # Geometry
    face_normals: torch.Tensor  # (3, num_faces), area weighted
    face_centers: torch.Tensor  # (3, num_faces)
    face_areas: torch.Tensor  # (num_faces,)
    cell_centers: torch.Tensor  # (3, num_cells)
    cell_volumes: torch.Tensor  # (num_cells,)

    dim: int
    num_cells: int
    num_faces: int
    num_half_faces: int

    @staticmethod
    def from_grid(sd, device: Union[str, torch.device] = "cpu") -> "FvMesh":
        """Extract half-face arrays from a host grid (CSC order, i.e. sorted
        by cell then face within cell — identical traversal order to the
        reference's ``sparse_array_to_row_col_data``)."""
        cf: sps.csc_matrix = sd.cell_faces.tocsc()
        ci = np.repeat(np.arange(sd.num_cells), np.diff(cf.indptr))
        fi = cf.indices

        def f64(a):
            return torch.tensor(np.asarray(a, dtype=float), dtype=torch.float64, device=device)

        def i32(a):
            return torch.tensor(np.asarray(a), dtype=torch.int32, device=device)

        face_ptr = np.concatenate([[0], np.cumsum(np.bincount(fi, minlength=sd.num_faces))])
        return FvMesh(
            fi=torch.tensor(fi, dtype=torch.int64, device=device),
            ci=torch.tensor(ci, dtype=torch.int64, device=device),
            sgn=f64(cf.data),
            face_ptr=i32(face_ptr),
            face_hf=i32(np.argsort(fi, kind="stable")),
            cell_ptr=i32(cf.indptr),
            face_normals=f64(sd.face_normals),
            face_centers=f64(sd.face_centers),
            face_areas=f64(sd.face_areas),
            cell_centers=f64(sd.cell_centers),
            cell_volumes=f64(sd.cell_volumes),
            dim=int(sd.dim),
            num_cells=int(sd.num_cells),
            num_faces=int(sd.num_faces),
            num_half_faces=int(fi.size),
        )

    # -- derived quantities -------------------------------------------------

    def fc_cc(self) -> torch.Tensor:
        """(3, num_half_faces) distance vectors face-center minus
        cell-center per half-face."""
        return self.face_centers[:, self.fi] - self.cell_centers[:, self.ci]

    def divergence_apply(self, face_field: torch.Tensor) -> torch.Tensor:
        """Apply the divergence operator to a face field: per cell the
        signed sum over its faces. Input ``(num_faces,)`` or
        ``(..., num_faces)``; reduces the last axis to ``num_cells``."""
        return self.cell_sum(self.sgn * face_field[..., self.fi])

    def face_sum(self, x_hf: torch.Tensor) -> torch.Tensor:
        """Sum of a half-face field ``(..., num_half_faces)`` over the
        half-faces of each face, in CSC order: ``(..., num_faces)``."""
        return kfn.segment_sum_sorted(x_hf, self.face_ptr, self.face_hf, self.num_faces)

    def cell_sum(self, x_hf: torch.Tensor) -> torch.Tensor:
        """Sum of a half-face field ``(..., num_half_faces)`` over the
        half-faces of each cell: ``(..., num_cells)``."""
        return kfn.segment_sum_sorted(x_hf, self.cell_ptr, None, self.num_cells)

    def boundary_faces(self) -> np.ndarray:
        """Host-side indices of faces with exactly one adjacent cell."""
        counts = np.bincount(self.fi.cpu().numpy(), minlength=self.num_faces)
        return np.where(counts == 1)[0]
