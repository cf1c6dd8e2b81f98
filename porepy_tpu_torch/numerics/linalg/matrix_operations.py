"""Sparse-matrix toolbox for FV discretizations.

Parity counterpart of (a subset of) reference
``numerics/linalg/matrix_operations.py``. The centerpiece is
:func:`invert_diagonal_blocks`: where the reference JIT-compiles a numba
loop over variable-size local systems (``matrix_operations.py:1283-1376``),
this implementation groups the blocks by size and inverts each group as one
batched dense ``np.linalg.inv`` on the host (K11: a device kernel is later
work) — the "sort-and-batch" form of the interaction-region solves at the
heart of MPFA/MPSA.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sps

__all__ = [
    "rlencode",
    "rldecode",
    "diagonal_scaling_matrix",
    "invert_diagonal_blocks",
    "sparse_array_to_row_col_data",
    "zero_rows",
    "zero_columns",
    "slice_indices",
    "slice_sparse_matrix",
    "merge_matrices",
    "stack_mat",
    "stack_diag",
    "optimized_compressed_storage",
    "sparse_kronecker_product",
    "csr_matrix_from_dense_blocks",
]


def rlencode(A: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Run-length encode columns of a 2d array."""
    comp = A[:, 0:-1] != A[:, 1:]
    i = np.any(comp, axis=0)
    i = np.hstack((np.argwhere(i).ravel(), (A.shape[1] - 1)))
    num = np.diff(np.hstack((np.array([-1]), i)))
    return A[:, i], num


def rldecode(A: np.ndarray, n: np.ndarray) -> np.ndarray:
    """Expand each element ``A[i]`` ``n[i]`` times."""
    r = n > 0
    i = np.cumsum(np.hstack((np.zeros(1, dtype=int), n[r])), dtype=int)
    j = np.zeros(i[-1], dtype=int)
    j[i[1:-1:]] = 1
    return A[np.cumsum(j)]


def sparse_array_to_row_col_data(
    mat: sps.spmatrix,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(rows, cols, data) triplet in the matrix's natural iteration order."""
    coo = mat.tocoo()
    return coo.row, coo.col, coo.data


def diagonal_scaling_matrix(mat: sps.spmatrix) -> sps.dia_matrix:
    """Left preconditioner: 1 / (row-wise sum of absolute values)."""
    tmp = mat.copy()
    tmp.data = np.abs(tmp.data)
    scalings = np.asarray(tmp.sum(axis=1)).ravel()
    return sps.dia_matrix((1.0 / scalings, 0), shape=mat.shape)


def invert_diagonal_blocks(
    mat: sps.spmatrix, s: np.ndarray, method: Optional[str] = None
) -> sps.csr_matrix:
    """Invert a block-diagonal matrix with blocks of sizes ``s``.

    ``method``: ``"jax"`` (default, the name kept for API parity;
    size-grouped batched dense inverses) or ``"python"`` (numpy loop,
    reference fallback).
    """
    s = np.asarray(s, dtype=int)
    n = int(s.sum())
    if mat.shape[0] != n:
        raise ValueError("Block sizes do not match matrix dimension")
    if method in (None, "jax", "numba"):
        return _invert_blocks_batched(mat.tocsr(), s)
    if method == "python":
        return _invert_blocks_python(mat.tocsr(), s)
    raise ValueError(f"Unknown inverter {method!r}")


def _block_entry_layout(s: np.ndarray):
    """COO layout of the dense inverse: every block contributes a full
    ``n x n`` set of entries."""
    offsets = np.concatenate([[0], np.cumsum(s)])
    rows = []
    cols = []
    for b, n in enumerate(s):
        base = offsets[b]
        r, c = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        rows.append(base + r.ravel())
        cols.append(base + c.ravel())
    return np.concatenate(rows), np.concatenate(cols), offsets


def _invert_blocks_batched(mat: sps.csr_matrix, s: np.ndarray) -> sps.csr_matrix:
    """Group blocks by size; one batched f64 dense inverse per group, on the
    host (assembly-time work)."""
    coo = mat.tocoo()
    offsets = np.concatenate([[0], np.cumsum(s)])
    # Block id per entry, local indices.
    blk = np.searchsorted(offsets, coo.row, side="right") - 1
    lr = coo.row - offsets[blk]
    lc = coo.col - offsets[blk]
    if np.any(coo.col < offsets[blk]) or np.any(coo.col >= offsets[blk] + s[blk]):
        raise ValueError("Matrix has entries outside the diagonal blocks")

    inv_data_per_block: list[np.ndarray] = [None] * s.size  # type: ignore
    for size in np.unique(s):
        members = np.where(s == size)[0]
        # Dense batch (B, size, size).
        sel = np.isin(blk, members)
        # Position of each member block within the batch.
        batch_index_of_block = np.full(s.size, -1)
        batch_index_of_block[members] = np.arange(members.size)
        dense = np.zeros((members.size, size, size))
        dense[batch_index_of_block[blk[sel]], lr[sel], lc[sel]] = coo.data[sel]
        inv = np.linalg.inv(dense)
        for k, b in enumerate(members):
            inv_data_per_block[b] = inv[k].ravel()

    rows, cols, _ = _block_entry_layout(s)
    data = np.concatenate(inv_data_per_block)
    return sps.csr_matrix((data, (rows, cols)), shape=mat.shape)


def _invert_blocks_python(mat: sps.csr_matrix, s: np.ndarray) -> sps.csr_matrix:
    offsets = np.concatenate([[0], np.cumsum(s)])
    dense = mat.toarray()
    blocks = []
    for b, n in enumerate(s):
        sl = slice(offsets[b], offsets[b + 1])
        blocks.append(np.linalg.inv(dense[sl, sl]))
    rows, cols, _ = _block_entry_layout(s)
    data = np.concatenate([blk.ravel() for blk in blocks])
    return sps.csr_matrix((data, (rows, cols)), shape=mat.shape)


def zero_rows(A: sps.csr_matrix, rows: np.ndarray) -> None:
    """Zero the values of the given rows in place (sparsity unchanged)."""
    from porepy_tpu_torch.utils.array_operations import expand_index_pointers

    if A.getformat() != "csr":
        raise ValueError("Need a csr matrix")
    indptr = A.indptr
    row_indptr = expand_index_pointers(indptr[rows], indptr[rows + 1])
    A.data[row_indptr] = 0


def zero_columns(A: sps.csc_matrix, cols) -> None:
    """In-place zeroing of columns of a CSC matrix (reference
    ``matrix_operations.py:24``)."""
    if not sps.issparse(A) or A.getformat() != "csc":
        raise ValueError("Need a csc matrix to zero columns in place")
    cols = np.atleast_1d(np.asarray(cols, dtype=int))
    for c in cols:
        A.data[A.indptr[c] : A.indptr[c + 1]] = 0.0


def slice_indices(A, slice_ind, return_array_ind: bool = False):
    """Row/column indices of the nonzeros in the given columns (csc) or
    rows (csr) — without forming a sub-matrix (reference
    ``matrix_operations.py:253``)."""
    fmt = A.getformat()
    if fmt not in ("csc", "csr"):
        raise ValueError("slice_indices needs a csc or csr matrix")
    slice_ind = np.atleast_1d(np.asarray(slice_ind, dtype=int))
    from porepy_tpu_torch.utils.array_operations import expand_index_pointers

    sel = expand_index_pointers(A.indptr[slice_ind], A.indptr[slice_ind + 1])
    indices = A.indices[sel]
    if return_array_ind:
        return indices, sel
    return indices


def slice_sparse_matrix(A, ind):
    """Columns (csc) or rows (csr) of a sparse matrix as a new matrix."""
    fmt = A.getformat()
    if fmt == "csc":
        return A[:, np.atleast_1d(ind)]
    if fmt == "csr":
        return A[np.atleast_1d(ind)]
    raise ValueError("slice_sparse_matrix needs a csc or csr matrix")


def merge_matrices(A, B, lines, matrix_format: str) -> None:
    """Replace columns (csc) or rows (csr) of ``A`` by those of ``B``
    in place (reference ``matrix_operations.py:71``)."""
    lines = np.atleast_1d(np.asarray(lines, dtype=int))
    if matrix_format == "csc":
        A_lil = A.tolil()
        B_csc = B.tocsc()
        for k, c in enumerate(lines):
            col = B_csc[:, k].toarray().ravel()
            A_lil[:, c] = col.reshape(-1, 1)
        out = A_lil.tocsc()
    elif matrix_format == "csr":
        A_lil = A.tolil()
        B_csr = B.tocsr()
        for k, r in enumerate(lines):
            A_lil[r] = B_csr[k].toarray().ravel()
        out = A_lil.tocsr()
    else:
        raise ValueError("merge_matrices supports csc or csr")
    A.data = out.data
    A.indices = out.indices
    A.indptr = out.indptr


def stack_mat(A, B) -> None:
    """Append the columns (csc) or rows (csr) of ``B`` to ``A`` in place."""
    fmt = A.getformat()
    if fmt == "csc":
        out = sps.hstack([A, B.tocsc()]).tocsc()
    elif fmt == "csr":
        out = sps.vstack([A, B.tocsr()]).tocsr()
    else:
        raise ValueError("stack_mat supports csc or csr")
    A.data = out.data
    A.indices = out.indices
    A.indptr = out.indptr
    A._shape = out.shape


def stack_diag(A, B):
    """Block-diagonal stacking preserving the format of ``A``."""
    return sps.block_diag([A, B], format=A.getformat())


def optimized_compressed_storage(A):
    """Store in the compressed format matching the matrix's aspect ratio
    (csr for wide, csc for tall; reference ``matrix_operations.py:824``)."""
    return A.tocsr() if A.shape[0] <= A.shape[1] else A.tocsc()


def sparse_kronecker_product(matrix, nd: int):
    """Expand a scalar-dof mapping to ``nd`` vector dofs:
    ``kron(matrix, I_nd)`` (reference ``matrix_operations.py:1653``)."""
    if nd == 1:
        return matrix.tocsr()
    return sps.kron(matrix, sps.identity(nd), format="csr")


def csr_matrix_from_dense_blocks(data, block_size: int, num_blocks=None):
    """Block-diagonal CSR from stacked equal-size dense blocks: ``data`` is
    either a flat array of ``num_blocks * block_size**2`` entries (row-major
    per block) or a ``(num_blocks, block_size, block_size)`` array."""
    data = np.asarray(data, dtype=float)
    if data.ndim == 3:
        blocks = data
    else:
        blocks = data.reshape(-1, block_size, block_size)
    return sps.block_diag(list(blocks), format="csr")
