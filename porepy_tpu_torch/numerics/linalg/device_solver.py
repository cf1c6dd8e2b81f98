"""Device-resident preconditioned Krylov solve of the assembled md system.

The replacement for the reference's host direct solvers (PyPardiso/UMFPACK,
reference ``models/solution_strategy.py:830-877``): the Jacobian never
leaves the device during a solve. Assembly
(``EquationSystem.assemble_device``) yields the nonzero data of a
statically indexed global sparse operator; this module solves with
right-preconditioned FGMRES where

- the matvec gathers the nonzero data into a padded-row (ELL) value tensor
  once per solve, and every Krylov matvec is the hand-written K1 kernel,
  launched by an :class:`~porepy_tpu_torch.kernels.EllOperator` made for
  the solve (no dispatcher),
- the preconditioner is a frozen block operator built on the host from a
  recent Jacobian: smoothed-aggregation AMG V-cycles per elliptic field
  block (:mod:`porepy_tpu_torch.numerics.linalg.amg`, one ``amg_vcycle``
  launch an apply), exact Schur elimination of (block-)diagonal blocks
  (mortar fluxes), and damped l1-Jacobi sweeps (K2, one ``jacobi_sweeps``
  launch a block) for anything else. Freezing the preconditioner across
  Newton iterations trades a slightly stale
  approximate inverse (still a valid right preconditioner) for zero
  per-iteration host work; it is refreshed automatically when a solve
  stalls,
- precision is mixed as in ``porepy_tpu`` (FGMRES-IR): the Krylov cycles
  run in float32 on the Ruiz-equilibrated operator, wrapped in float64
  iterative refinement (one f64 true-residual matvec per restart cycle),
  so that Krylov counts match the reference package. The H100 has native
  f64; whether plain f64 FGMRES is faster here is an open measurement,
- each Arnoldi step, less the preconditioner (the matvec, CGS2, the
  norm, the Givens update and the convergence flag), is one cooperative
  launch of the K4 kernel through the cycle's
  :class:`~porepy_tpu_torch.kernels.FgmresArnoldi`; the host reads the flag
  once a step to end the cycle early,
- with a dof mesh set (:meth:`DeviceLinearSolver.set_dof_sharding`, K19)
  the solves of :meth:`DeviceLinearSolver.solve_device` run row-sharded
  over a ``torch.distributed`` group: halo-exchange matvecs and
  all-reduced norms and dot products
  (:class:`porepy_tpu_torch.parallel.halo.DofShard`).

Falls back (counted + logged) to host spsolve if the device iteration misses
tolerance. With ``dense=True`` each field block of at most
``PPT_DENSE_PRECOND_MAX`` rows takes a dense frozen inverse instead (K6,
below), applied as one GEMV per Krylov step.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np
import scipy.sparse as sps
import torch

from porepy_tpu_torch import kernels
from porepy_tpu_torch.numerics.linalg import amg
from porepy_tpu_torch.numerics.linalg.krylov import FALLBACK_COUNTER

__all__ = ["DeviceLinearSolver"]

logger = logging.getLogger(__name__)

# -- dense frozen block inverses (K6) --------------------------------------------
#
# A field block of at most PPT_DENSE_PRECOND_MAX rows may be replaced by its
# dense inverse, built once per preconditioner refresh: per-block Ruiz
# equilibration, a host condition-number gate, the coalesced COO block
# scattered into a padded f32 matrix (identity pad) by the
# ``dense_block_scatter`` kernel, a blocked Gauss-Jordan inverse of it, and
# the Ruiz diagonals folded back so the stored matrix is the raw-space
# inverse. Every Krylov apply is then one ``dense_block_apply`` GEMV, and
# FGMRES converges in a few iterations because the block solve is exact to
# f32 rounding. As in ``porepy_tpu``, the elimination is unpivoted at the
# block level (the caller hands in an equilibrated block, gated by its
# condition estimate); inside each 128-row pivot block the
# ``gj_pivot_inverse`` kernel pivots by rows, as ``jax.numpy.linalg.inv``
# does. A singular or non-finite pivot sets a device flag that the build
# reads once and turns into FloatingPointError, so the block demotes to its
# sparse method like a block the condition gate rejects.

#: Rows of a pivot block: a power of two, at most 128, so that one pivot
#: (66 KB in f32) fits the shared memory of one SM. porepy_tpu uses 1024,
#: which suits XLA's LU on the TPU.
_DENSE_GJ_BLOCK = 128


def _dense_block_inv(
    A: torch.Tensor, pivot_inverse=None, flag: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Inverse of the square matrix ``A`` by blocked Gauss-Jordan
    elimination without pivoting between blocks, in place (``A`` is
    overwritten and returned, so no second n x n buffer is made).

    Per block step: the ``b x b`` pivot is inverted by ``pivot_inverse``
    (default :func:`~porepy_tpu_torch.kernels.gj_pivot_inverse`, which sets
    ``flag`` on a singular pivot), then the row strip ``Pi R``, the rank-b
    update ``M -= C (Pi R)`` and the column strip ``-C Pi`` are dense
    products in full f32 (``porepy_tpu`` asks XLA for
    ``Precision.HIGHEST``). ``A.shape[0]`` must be a multiple of
    :data:`_DENSE_GJ_BLOCK`."""
    if pivot_inverse is None:
        pivot_inverse = kernels.gj_pivot_inverse
    if A.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "dense block inverse needs full f32 products: "
            "torch.backends.cuda.matmul.allow_tf32 must be False"
        )
    n = A.shape[0]
    b = _DENSE_GJ_BLOCK
    if n % b:
        raise ValueError(f"matrix size {n} is not a multiple of the pivot block {b}")
    if flag is None:
        flag = torch.zeros(1, dtype=torch.int32, device=A.device)
    M = A
    for i0 in range(0, n, b):
        s = slice(i0, i0 + b)
        Pi = pivot_inverse(M[s, s].contiguous()[None], flag)[0]
        C = M[:, s].clone()
        C[s] = 0.0
        R = Pi @ M[s, :]
        R[:, s] = 0.0
        M.addmm_(C, R, alpha=-1.0)
        M[:, s] = -(C @ Pi)
        R[:, s] = Pi
        M[s, :] = R
    return M


def _dense_precond_limit() -> int:
    """Per-block size threshold below which a dense frozen block inverse is
    built when ``dense=True`` (env ``PPT_DENSE_PRECOND_MAX``, default 36864,
    as in ``porepy_tpu``). 36864^2 f32 is 5.4 GB; a failed build demotes
    the block to its sparse method."""
    import os

    return int(os.environ.get("PPT_DENSE_PRECOND_MAX", "36864"))


def _dense_inv_fn(
    ni: int,
    n_pad: int,
    vals: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
) -> torch.Tensor:
    """Scatter of an ``ni``-sized coalesced COO block into a zero
    ``(n_pad, n_pad)`` matrix with an identity pad diagonal, then its
    blocked Gauss-Jordan inverse. Reads the pivot flag once and raises
    ``FloatingPointError`` if a pivot was singular or the inverse is not
    finite."""
    D = kernels.dense_block_scatter(vals, rows, cols, ni, n_pad)
    flag = torch.zeros(1, dtype=torch.int32, device=D.device)
    D = _dense_block_inv(D, flag=flag)
    bad = (flag[0] != 0) | ~torch.isfinite(D).all()
    if bool(bad):
        raise FloatingPointError(
            f"dense block inverse failed: singular or non-finite pivot "
            f"(n = {ni}, pivot block {_DENSE_GJ_BLOCK})"
        )
    return D


class _Local:
    """The reductions of a solve whose vectors lie whole on one device
    (a :class:`~porepy_tpu_torch.parallel.halo.DofShard` has the same
    methods over a process group)."""

    norm = staticmethod(torch.linalg.vector_norm)
    dot = staticmethod(torch.matmul)

    @staticmethod
    def all_sum(t: torch.Tensor) -> torch.Tensor:
        return t

    @staticmethod
    def all_finite(d: torch.Tensor) -> torch.Tensor:
        return torch.all(torch.isfinite(d))


def _fgmres(matvec, M, b, x0, atol, restart, max_cycles, red=_Local):
    """Right-preconditioned restarted FGMRES: each Arnoldi step is ``z =
    M(V[j])`` and one K4 launch (:class:`~porepy_tpu_torch.kernels.
    FgmresArnoldi`: the matvec, CGS2, the norm, the Givens least squares
    and the flag), early exit on ``|g[j]| <= atol``, read once a step.
    ``matvec`` an :class:`~porepy_tpu_torch.kernels.EllOperator` and ``red``
    :class:`_Local` run the matvec inside the launch; any other ``matvec``
    (a dof shard's halo matvec) is called for ``w = A z`` and the step runs
    as its phases around ``red.all_sum``. Right preconditioning keeps the
    recurrence in TRUE residual norms (``|g[j]|``), so the tolerance check
    needs no extra matvec and a frozen/approximate ``M`` cannot distort
    convergence reporting. ``atol`` is a scalar (tensor or float).
    Returns ``(x, residual_norm, total_iterations)``; the norm is a 0-d
    device tensor, the count a host int. ``red`` supplies the norms and
    dot products (:class:`_Local`, or a dof shard's all-reduced ones: then
    ``b``, ``x0`` and the Krylov bases hold the rank's rows only).

    Guard constants stay at 1e-30, as in ``porepy_tpu``, so that both
    packages take the same branches."""
    n = b.shape[0]
    dtype, dev = b.dtype, b.device
    atol = torch.as_tensor(atol, dtype=dtype, device=dev).reshape(())
    fused = red is _Local and isinstance(matvec, kernels.EllOperator)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def cycle(x):
        r = b - matvec(x)
        beta = red.norm(r)
        V = zeros(restart + 1, n)
        V[0] = r / torch.clamp(beta, min=1e-30)
        Z = zeros(restart, n)
        # Ht[j] is column j of the Hessenberg matrix (row-major rows are
        # the contiguous columns the Givens kernel rotates in place).
        Ht = zeros(restart, restart + 1)
        cs = zeros(restart)
        sn = zeros(restart)
        g = zeros(restart + 1)
        g[0] = beta
        j_dev = torch.zeros((), dtype=torch.int32, device=dev)
        flag = ((beta > atol) & (restart > 0)).to(torch.int32)
        step = kernels.FgmresArnoldi(V, Z, Ht, cs, sn, g, j_dev, atol, flag, matvec if fused else None)
        j = 0
        while j < restart and bool(flag):
            z = M(V[j])
            if fused:
                step(z)
            else:
                step.split(z, matvec(z), red.all_sum)
            j += 1
        if j:
            R = Ht[:j, :j].T
            # Happy breakdowns leave a zero pivot; neutralizing it with a
            # matching zero rhs keeps the triangular solve finite.
            bad = torch.abs(torch.diagonal(R)) < 1e-30
            R = R + torch.diag(bad.to(dtype))
            gr = torch.where(bad, torch.zeros_like(g[:j]), g[:j])
            y = torch.linalg.solve_triangular(R, gr[:, None], upper=True)[:, 0]
            x = x + Z[:j].T @ y
        return x, torch.abs(g[j]), j

    x = x0
    res = red.norm(b - matvec(x0))
    iters = 0
    k = 0
    while k < max_cycles and bool(res > atol):
        x, res, it = cycle(x)
        iters += it
        k += 1
    return x, res, iters


def _jacobi_sweeps(op, r, sweeps):
    """y ~= A^{-1} r by damped l1-Jacobi iteration: ``y = sinv r``, then
    ``sweeps - 1`` sweeps, all in one K2 launch of the block's
    :class:`~porepy_tpu_torch.kernels.JacobiSweeps` ``op`` (one sweep is
    ``sinv r`` alone, with no launch). Unlike a
    Chebyshev polynomial (which assumes a real positive
    spectrum and amplifies on nonsymmetric upwind-transport blocks), the
    damped l1-sweep is bounded for arbitrary matrices and contracts on the
    diagonally dominant M-matrix blocks (transport, contact
    complementarity) it is used for. Stationary => a valid Krylov
    preconditioner."""
    if sweeps <= 1:
        return op.sinv * r
    return op(r, sweeps - 1)


def _blockdiag_inverse(
    A: sps.csr_matrix, tol: float, max_block: int = 2048
) -> Optional[sps.csr_matrix]:
    """Exact inverse of a block-diagonal matrix, one dense inverse per
    connected component of its significant-coupling graph; None if any
    component exceeds ``max_block`` (then the caller must not eliminate).
    Entries below ``tol`` are treated as absent when finding components
    but kept in the inverted blocks."""
    import scipy.sparse.csgraph as csg

    n = A.shape[0]
    coo = A.tocoo()
    keep = np.abs(coo.data) > tol
    G = sps.coo_matrix(
        (np.ones(int(keep.sum())), (coo.row[keep], coo.col[keep])),
        shape=A.shape,
    )
    ncomp, lab = csg.connected_components(
        (G + G.T) > 0, directed=False
    )
    sizes = np.bincount(lab, minlength=ncomp)
    if sizes.size and sizes.max() > max_block:
        return None
    order = np.argsort(lab, kind="stable")
    rows_l, cols_l, vals_l = [], [], []
    ptr = 0
    csr = A.tocsr()
    for comp in range(ncomp):
        size = sizes[comp]
        idx = order[ptr : ptr + size]
        ptr += size
        if size == 1:
            d = csr[idx[0], idx[0]]
            rows_l.append(idx)
            cols_l.append(idx)
            vals_l.append(np.array([1.0 / d]))
            continue
        sub = csr[idx][:, idx].toarray()
        inv = np.linalg.inv(sub)
        ii, jj = np.meshgrid(idx, idx, indexing="ij")
        rows_l.append(ii.ravel())
        cols_l.append(jj.ravel())
        vals_l.append(inv.ravel())
    return sps.csr_matrix(
        (
            np.concatenate(vals_l),
            (np.concatenate(rows_l), np.concatenate(cols_l)),
        ),
        shape=(n, n),
    )


def _ruiz_scaling(A: sps.spmatrix, iters: int = 6):
    """Symmetric Ruiz equilibration: diagonal ``d_r, d_c`` with
    ``diag(d_r) A diag(d_c)`` having unit row/col max-norms. The md/contact
    systems mix rows spanning ~10 orders of magnitude; equilibrating before
    preconditioning and Krylov is worth several digits of achievable
    accuracy."""
    B = A.tocsr().copy()
    n, m = B.shape
    d_r = np.ones(n)
    d_c = np.ones(m)
    for _ in range(iters):
        rmax = np.asarray(abs(B).max(axis=1).todense()).ravel()
        sr = 1.0 / np.sqrt(np.where(rmax > 0.0, rmax, 1.0))
        B = sps.diags(sr) @ B
        d_r *= sr
        cmax = np.asarray(abs(B).max(axis=0).todense()).ravel()
        sc = 1.0 / np.sqrt(np.where(cmax > 0.0, cmax, 1.0))
        B = B @ sps.diags(sc)
        d_c *= sc
    return d_r, d_c



class _BlockPrecondBuilder:
    """Host-side construction of the frozen block preconditioner.

    Blocks are an ordered partition of the dofs (and matching equation
    rows); each gets a method:

    - ``"amg"``: SA-AMG V-cycle on the block's (Schur-folded, optionally
      stabilized) diagonal matrix, with optional near-nullspace modes.
    - ``"eliminate"``: the block's diagonal matrix must be diagonal (mortar
      flux equations are); it is eliminated exactly — folded into every amg
      block's operator — and back-substituted after the sweep. Demoted to
      ``"jacobi"`` (with a log message) if the diagonality check fails.
    - ``"jacobi"`` (or any other name): fixed damped l1-Jacobi sweeps in
      the block (robust for the nonsymmetric transport/contact blocks,
      where polynomial methods assuming a real spectrum amplify).

    Application order is lower block Gauss-Seidel over the amg/jacobi
    blocks in the declared order, bracketed by the exact eliminations.
    Every tensor of the frozen state lives on ``device``.
    """

    def __init__(self, blocks, methods, stabilization, near_nullspace, device):
        self.device = torch.device(device)
        self.blocks = [
            (np.asarray(r, np.int64), np.asarray(c, np.int64)) for r, c in blocks
        ]
        self.methods = list(methods)
        self.stab = stabilization or {}
        self.nns = near_nullspace or {}
        n = sum(c.size for _r, c in self.blocks)
        cols_concat = np.concatenate([c for _r, c in self.blocks])
        if np.unique(cols_concat).size != n:
            raise ValueError("Field blocks must cover every dof exactly once")
        rows_concat = np.concatenate([r for r, _c in self.blocks])
        self._rows_concat = self._tensor(rows_concat)
        inv = np.empty(n, np.int64)
        inv[cols_concat] = np.arange(n)
        self._scatter_inv = self._tensor(inv)
        self._sizes = [int(r.size) for r, _c in self.blocks]
        # Per-block Jacobi sweep counts, frozen at the FIRST build so value
        # refreshes keep the apply structure.
        self._jac_sweeps: dict[int, int] = {}
        # Per-block dense upgrade: sweep blocks of at most this size get a
        # dense frozen inverse instead of their AMG/Jacobi method. 0
        # disables. Decisions are sticky per block (a failed build demotes
        # the block for good).
        self.dense_limit: int = 0
        self._block_dense: dict[int, bool] = {}

    @staticmethod
    def _cond_estimate(S_eq: sps.csr_matrix, iters: int = 8) -> float:
        """Host-side 2-norm condition estimate of the equilibrated block:
        power iteration for sigma_max, splu-backed inverse power iteration
        for sigma_min (both on ``S^T S``; deterministic seed). Returns
        ``inf`` for (numerically) singular blocks."""
        n = S_eq.shape[0]
        rng = np.random.default_rng(0xC0ED)
        v = rng.standard_normal(n)
        v /= np.linalg.norm(v)
        nw = 0.0
        for _ in range(iters):
            w = S_eq.T @ (S_eq @ v)
            nw = float(np.linalg.norm(w))
            if not np.isfinite(nw) or nw == 0.0:
                return np.inf
            v = w / nw
        smax = np.sqrt(nw)
        try:
            import warnings

            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                lu = sps.linalg.splu(S_eq.tocsc())
            u = rng.standard_normal(n)
            u /= np.linalg.norm(u)
            for _ in range(iters):
                w = lu.solve(lu.solve(u), trans="T")
                nw = float(np.linalg.norm(w))
                if not np.isfinite(nw) or nw == 0.0:
                    return np.inf
                u = w / nw
        except Exception:
            return np.inf
        smin = 1.0 / np.sqrt(nw)
        return float(smax / smin)

    def _build_dense_block(self, Sii: sps.csr_matrix) -> torch.Tensor:
        """Dense frozen inverse of one sweep block: per-block Ruiz
        equilibration, a host condition gate, the blocked Gauss-Jordan
        inverse of the equilibrated block on the device, and the diagonals
        folded back so the stored ``(n_pad, n_pad)`` f32 matrix is the
        RAW-space inverse (one GEMV per apply, consistent with the
        raw-space block sweep). Raises to let the caller demote the block.

        The gate: an f32 Gauss-Jordan inverse of an equilibrated block with
        condition number kappa carries a relative error of about
        kappa * eps_f32, so kappa <= 1e5 (``PPT_DENSE_COND_MAX``) keeps it
        within 5%. A mis-predicted block is caught downstream by FGMRES's
        true residual and the counted host fallback, never silently. The
        pivot flag of the inverse catches a pivot block that the gate
        passes but Gauss-Jordan cannot invert."""
        import os

        ni = Sii.shape[0]
        b = _DENSE_GJ_BLOCK
        n_pad = -(-ni // b) * b
        dr, dc = _ruiz_scaling(Sii)
        coo = Sii.tocoo()
        # Coalesced entries make the device scatter a plain store.
        coo.sum_duplicates()
        eq_vals = dr[coo.row] * coo.data * dc[coo.col]
        S_eq = sps.csr_matrix((eq_vals, (coo.row, coo.col)), shape=Sii.shape)
        cond = self._cond_estimate(S_eq)
        cond_max = float(os.environ.get("PPT_DENSE_COND_MAX", "1e5"))
        if not np.isfinite(cond) or cond > cond_max:
            raise FloatingPointError(
                f"dense block inverse gated off: equilibrated cond estimate "
                f"{cond:.2e} > {cond_max:.0e} (n = {ni}; f32 Gauss-Jordan "
                f"error ~ cond * eps_f32 would breach the 5% contract)"
            )
        inv = _dense_inv_fn(
            ni,
            n_pad,
            self._tensor(eq_vals.astype(np.float32)),
            self._tensor(coo.row.astype(np.int32)),
            self._tensor(coo.col.astype(np.int32)),
        )
        # Raw-space inverse Minv = Dc inv_eq Dr (pad scales are 1), in place.
        dcp = self._tensor(np.pad(dc, (0, n_pad - ni), constant_values=1.0).astype(np.float32))
        drp = self._tensor(np.pad(dr, (0, n_pad - ni), constant_values=1.0).astype(np.float32))
        return inv.mul_(dcp[:, None]).mul_(drp[None, :])

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(np.asarray(a), device=self.device)

    def _ell(self, mat: sps.spmatrix) -> tuple[torch.Tensor, torch.Tensor]:
        val, col = amg._ell_arrays(mat, np.float32)
        return self._tensor(val), self._tensor(col)

    def build(
        self,
        A: sps.csr_matrix,
        prev_hierarchies: Optional[dict] = None,
        row_scale: Optional[np.ndarray] = None,
        col_scale: Optional[np.ndarray] = None,
    ):
        """Build (or value-refresh) the frozen preconditioner.

        ``A`` is the RAW (unequilibrated) operator; ``row_scale`` /
        ``col_scale`` are the outer Krylov's Ruiz diagonals. The block
        solves run in RAW space — the apply maps the equilibrated residual
        in and the equilibrated correction out via the diagonals
        (``M_eq(r) = Dc^{-1} M_raw(Dr^{-1} r)``): global two-sided Ruiz
        scaling makes the fracture pressure rows of the elliptic blocks
        strongly nonsymmetric, which SA-AMG does not survive.

        Returns ``(state, apply, hierarchies)``: ``state`` is the dict of
        device tensors consumed by the solve, ``apply(state, r)`` the
        application, ``hierarchies`` the host-side AMG objects (pass back
        as ``prev_hierarchies`` to reuse aggregation structure on a value
        refresh)."""
        nb = len(self.blocks)
        sub = {}
        for i, (ri, ci) in enumerate(self.blocks):
            Ar = A[ri]
            for j, (_rj, cj) in enumerate(self.blocks):
                sub[(i, j)] = Ar[:, cj].tocsr()

        elim = [i for i, m in enumerate(self.methods) if m == "eliminate"]
        dinv_mat: dict[int, sps.csr_matrix] = {}
        for j in list(elim):
            Ajj = sub[(j, j)]
            dg = Ajj.diagonal()
            off = (Ajj - sps.diags(dg)).tocoo()
            # Diagonality is judged RELATIVE to the diagonal scale:
            # AD-assembled mortar blocks carry O(1e-28) numerical-noise
            # couplings (products of tiny constants) that are structureless;
            # demoting the exact elimination over them collapses the whole
            # preconditioner at scale.
            dscale = np.abs(dg).max() if dg.size else 1.0
            significant = (
                int(np.count_nonzero(np.abs(off.data) > 1e-12 * dscale))
                if off.nnz
                else 0
            )
            if np.any(dg == 0.0):
                logger.info(
                    "Block %d has zero diagonal entries; demoting "
                    "eliminate -> jacobi",
                    j,
                )
                self.methods[j] = "jacobi"
                elim.remove(j)
                continue
            if significant:
                # Genuinely coupled (e.g. MPFA pressure traces couple the
                # mortar fluxes within each interface on non-K-orthogonal
                # meshes): eliminate exactly BLOCKWISE — one dense inverse
                # per connected coupling component.
                inv = _blockdiag_inverse(Ajj, tol=1e-12 * dscale)
                if inv is None:
                    logger.info(
                        "Block %d coupled beyond the blockwise-elimination "
                        "limit; demoting eliminate -> jacobi",
                        j,
                    )
                    self.methods[j] = "jacobi"
                    elim.remove(j)
                    continue
                logger.info(
                    "Block %d eliminated blockwise (%d significant "
                    "off-diagonal entries)",
                    j,
                    significant,
                )
                dinv_mat[j] = inv
        sweep = [i for i, m in enumerate(self.methods) if m != "eliminate"]

        n = A.shape[0]
        mdr = 1.0 / row_scale if row_scale is not None else np.ones(n)
        mdc = 1.0 / col_scale if col_scale is not None else np.ones(n)
        # The preconditioner is an approximate inverse applied inside the
        # float32 inner Krylov cycles (FGMRES-IR): every value tensor is f32.
        state = {
            "dinv": {},
            "cpl": {},
            "amg": {},
            "jac": {},
            "dense": {},
            "perm_rows": self._rows_concat,
            "perm_inv": self._scatter_inv,
            "mdr": self._tensor(mdr.astype(np.float32)),
            "mdc": self._tensor(mdc.astype(np.float32)),
        }
        hierarchies = {}

        def _dinv_of(j) -> sps.csr_matrix:
            m = dinv_mat.get(j)
            if m is None:
                m = sps.diags(1.0 / sub[(j, j)].diagonal()).tocsr()
            return m

        for j in elim:
            # Uniform ELL form (K=1 for strictly diagonal blocks): the
            # elimination/back-substitution applies are one K1 launch
            # either way.
            state["dinv"][j] = self._ell(_dinv_of(j))
        for i in sweep:
            Sii = sub[(i, i)]
            for j in elim:
                Aij = sub[(i, j)]
                if Aij.nnz:
                    Sii = Sii - (Aij @ _dinv_of(j) @ sub[(j, i)])
            Sii = Sii.tocsr()
            if i in self.stab:
                # Raw space: user stabilization diagonals apply unscaled.
                Sii = Sii + sps.diags(
                    np.asarray(self.stab[i], dtype=np.float64)
                )
            want_dense = self._block_dense.get(
                i, 0 < Sii.shape[0] <= self.dense_limit
            )
            if want_dense:
                try:
                    state["dense"][i] = self._build_dense_block(Sii)
                    self._block_dense[i] = True
                    continue
                except Exception:
                    logger.exception(
                        "Dense inverse of block %d failed; demoting to %s",
                        i,
                        self.methods[i],
                    )
                    self._block_dense[i] = False
            if self.methods[i] == "amg":
                nns = self.nns.get(i)
                B, bs = (nns if nns is not None else (None, 1))
                prev = (prev_hierarchies or {}).get(i)
                if prev is not None:
                    prev.update_values(Sii)
                    hierarchies[i] = prev
                else:
                    hierarchies[i] = amg.build_hierarchy(
                        Sii, B=B, block_size=bs, device=self.device
                    )
                state["amg"][i] = hierarchies[i].state
            else:  # jacobi
                val, col = self._ell(Sii)
                # Upwind transport / complementarity blocks are acyclic in
                # their significant couplings: true-diagonal UNDAMPED Jacobi
                # is then nilpotent and solves the block exactly in depth+1
                # sweeps (damped l1 stalls on advection chains). Frozen at
                # first build; value refreshes recompute sinv only.
                if i not in self._jac_sweeps:
                    cfg = amg.flow_ordered_jacobi(Sii)
                    self._jac_sweeps[i] = cfg[1] if cfg is not None else 0
                sweeps = self._jac_sweeps[i]
                if sweeps:
                    dg = Sii.diagonal()
                    sinv = np.where(dg != 0.0, 1.0 / np.where(dg == 0, 1, dg), 0.0)
                else:
                    sinv = amg._l1_smoother(Sii)
                state["jac"][i] = {
                    "val": val,
                    "col": col,
                    "sinv": self._tensor(sinv.astype(np.float32)),
                }
        # Couplings used during application (frozen values, ELL form):
        # sweep blocks consume earlier sweep blocks and all elim blocks;
        # elim back-substitution consumes every sweep block.
        needed = []
        for pos, i in enumerate(sweep):
            for j in elim:
                needed.append((i, j))
            for k in sweep[:pos]:
                needed.append((i, k))
        for j in elim:
            for i in sweep:
                needed.append((j, i))
        for key in needed:
            mat = sub[key]
            if mat.nnz:
                state["cpl"][key] = self._ell(mat)

        # K1 launchers of the eliminations and couplings and the K2
        # launchers of the Jacobi blocks, made once here; apply(state, r)
        # finds them by tensor (a state handed in from elsewhere gets its
        # own on first use).
        ops = kernels.EllOperators()
        for dv, dc in state["dinv"].values():
            ops(dv, dc)
        for cv, cc in state["cpl"].values():
            ops(cv, cc)
        jac_ops = kernels.EllOperators(kernels.JacobiSweeps)
        for jb in state["jac"].values():
            jac_ops(jb["val"], jb["col"], jb["sinv"])
        sizes = self._sizes
        methods = list(self.methods)
        jac_sweeps = dict(self._jac_sweeps)
        dense_set = frozenset(i for i in sweep if self._block_dense.get(i))

        def apply(state, r):
            # Equilibrated residual in -> raw space; block GS runs raw.
            r = r * state["mdr"]
            parts = torch.split(r[state["perm_rows"]], sizes)
            y = [None] * nb
            # Forward elimination of the (block-)diagonal blocks.
            r_red = {}
            for j in elim:
                y[j] = ops(*state["dinv"][j])(parts[j])
            # r_i - C y_j in K1's epilogue: one launch each.
            for i in sweep:
                ri = parts[i]
                for j in elim:
                    cpl = state["cpl"].get((i, j))
                    if cpl is not None:
                        ri = ops(*cpl)(y[j], c=ri, sign=-1)
                r_red[i] = ri
            # Lower block Gauss-Seidel over the sweep blocks.
            for pos, i in enumerate(sweep):
                ri = r_red[i]
                for k in sweep[:pos]:
                    cpl = state["cpl"].get((i, k))
                    if cpl is not None:
                        ri = ops(*cpl)(y[k], c=ri, sign=-1)
                if i in dense_set:
                    y[i] = kernels.dense_block_apply(state["dense"][i], ri.contiguous())
                elif methods[i] == "amg":
                    y[i] = hierarchies[i].apply(state["amg"][i], ri)
                else:
                    jb = state["jac"][i]
                    y[i] = _jacobi_sweeps(
                        jac_ops(jb["val"], jb["col"], jb["sinv"]), ri.contiguous(),
                        jac_sweeps.get(i) or 8,
                    )
            # Back-substitute the eliminated blocks.
            for j in elim:
                rj = parts[j]
                for i in sweep:
                    cpl = state["cpl"].get((j, i))
                    if cpl is not None:
                        rj = ops(*cpl)(y[i], c=rj, sign=-1)
                y[j] = ops(*state["dinv"][j])(rj)
            # Scatter-free reassembly: one gather by the precomputed inverse
            # permutation of the concatenated block order; raw correction
            # out -> equilibrated space.
            return torch.cat(y)[state["perm_inv"]] * state["mdc"]

        return state, apply, hierarchies


class DeviceLinearSolver:
    """Solve of ``A x = b`` on the device for a fixed assembly structure.

    Parameters
    ----------
    system:
        ``_CompiledSystem`` from ``EquationSystem.compiled_system()`` (must be
        square: equation rows align with dofs). The solve runs on its
        ``device``.
    blocks:
        Optional field split: list of ``(row_indices, col_indices)`` global
        index arrays. ``None`` -> one AMG block over the whole system.
    methods:
        Per-block method (``"amg" | "eliminate" | "jacobi"``); default
        ``"amg"`` for every block.
    stabilization:
        Optional dict ``{block_position: diagonal array}`` added to that
        block's diagonal inside the preconditioner only (fixed-stress style).
    near_nullspace:
        Optional dict ``{block_position: (B, node_block_size)}`` of
        near-nullspace modes for the block's AMG (rigid body modes for
        displacement blocks).
    dense:
        Dense frozen block inverses (K6): ``True`` gives every sweep block
        of at most ``PPT_DENSE_PRECOND_MAX`` rows a dense inverse (demoted
        to its sparse method if the build fails); ``None`` and ``False``
        mean off.
    """

    def __init__(
        self,
        system,
        method: str = "gmres",
        blocks: Optional[Sequence[tuple[np.ndarray, np.ndarray]]] = None,
        methods: Optional[Sequence[str]] = None,
        stabilization: Optional[dict] = None,
        near_nullspace: Optional[dict] = None,
        tol: float = 1e-11,
        maxiter: Optional[int] = None,
        restart: int = 70,
        dense: Optional[bool] = False,
    ) -> None:
        if system.num_rows != system.shape[1]:
            raise ValueError("Device solve needs a square assembled system")
        self.system = system
        self.device = system.device
        self.method = method
        self.tol = tol
        n = system.shape[1]
        self.n = n
        self.maxiter = maxiter if maxiter is not None else max(4 * restart, 280)
        self._restart = restart
        rows = system.indices_np[:, 0]
        cols = system.indices_np[:, 1]
        self._rows_np = rows
        self._cols_np = cols

        # Padded-row (ELL) layout: ``ell_sel`` selects nnz slots into a
        # dense (n, K) value tensor ONCE per solve; each matvec is then one
        # K1 launch.
        order = np.lexsort((cols, rows))
        r_sorted = rows[order]
        counts = np.bincount(r_sorted, minlength=n)
        K = max(int(counts.max()) if counts.size else 1, 1)
        pos_in_row = np.arange(rows.size) - np.repeat(
            np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
        )
        ell_sel = np.full((n, K), rows.size, dtype=np.int64)
        ell_col = np.full((n, K), n, dtype=np.int32)
        ell_sel[r_sorted, pos_in_row] = order
        ell_col[r_sorted, pos_in_row] = cols[order]
        self._ell_sel = torch.tensor(ell_sel, device=self.device)
        self._ell_col = torch.tensor(ell_col, device=self.device)

        if blocks is None:
            blocks = [(np.arange(n), np.arange(n))]
        if methods is None:
            methods = ["amg"] * len(blocks)
        self._builder = _BlockPrecondBuilder(
            blocks, methods, stabilization, near_nullspace, self.device
        )
        self._m_state: Optional[dict] = None
        self._m_apply = None
        self._hierarchies: Optional[dict] = None
        self.last_stats: Optional[dict] = None
        self._shard = None
        # Unlike porepy_tpu, which turns dense inverses on by itself on the
        # TPU below the size threshold, the port builds them only when asked.
        if dense:
            self._builder.dense_limit = _dense_precond_limit()

    # -- preconditioner lifecycle ---------------------------------------------

    @property
    def _dense(self) -> bool:
        """True when dense frozen block inverses are active (before the
        first build: configured to be attempted)."""
        if self._builder._block_dense:
            return any(self._builder._block_dense.values())
        return self._builder.dense_limit > 0

    def _host_matrix(self, data) -> sps.csr_matrix:
        if torch.is_tensor(data):
            data = data.detach().cpu().numpy()
        return sps.csr_matrix(
            (np.asarray(data), (self._rows_np, self._cols_np)),
            shape=self.system.shape,
        )

    def refresh_preconditioner(self, data) -> None:
        """(Re)build the frozen preconditioner from the given Jacobian
        nonzeros (a device tensor is copied to the host once):
        Ruiz-equilibrate, then build the block preconditioner. Reuses
        aggregation structure when it exists."""
        A = self._host_matrix(data)
        d_r, d_c = _ruiz_scaling(A)
        # The Krylov iterates on the equilibrated operator; the block
        # preconditioner is built on the RAW matrix (see build()) and maps
        # between the spaces with the Ruiz diagonals itself.
        self._m_state, self._m_apply, self._hierarchies = self._builder.build(
            A,
            prev_hierarchies=self._hierarchies,
            row_scale=d_r,
            col_scale=d_c,
        )
        dev = self.device
        self._m_state["dr"] = torch.tensor(d_r, dtype=torch.float64, device=dev)
        self._m_state["dc"] = torch.tensor(d_c, dtype=torch.float64, device=dev)
        self._m_state["dc1"] = torch.tensor(
            np.append(d_c, 1.0), dtype=torch.float64, device=dev
        )

    def invalidate_preconditioner(self) -> None:
        """Force a rebuild at the next solve (call after rediscretization)."""
        self._m_state = None

    def set_dof_sharding(self, mesh) -> None:
        """Shard the rows of :meth:`solve_device`'s solves over ``mesh``
        (a :class:`~porepy_tpu_torch.parallel.sharded.DofMesh` whose device
        is the solver's); ``None`` removes the sharding. Builds this rank's
        halo plan once, on the host, exchanging it with the other ranks
        (every rank must call this together). :meth:`solve` and the fused
        Newton loop stay single-device either way."""
        if mesh is None:
            self._shard = None
            return
        from porepy_tpu_torch.parallel import halo

        if not halo.same_device(mesh.device, self.device):
            raise ValueError(f"the solver runs on {self.device}, the mesh's rank on {mesh.device}")
        plan = halo.exchange_plan(self._ell_col.cpu().numpy(), self.n, mesh)
        self._shard = halo.DofShard(mesh, plan, self.n, self._ell_sel, self._ell_col)

    @property
    def dof_shard(self):
        """The :class:`~porepy_tpu_torch.parallel.halo.DofShard` of this
        rank, or ``None`` without a dof mesh."""
        return self._shard

    @property
    def solve_args(self) -> tuple:
        """Static index operands of the solve: ``(ell_sel, ell_col)``."""
        return (self._ell_sel, self._ell_col)

    # -- the solve ---------------------------------------------------------------

    def _solve(self, data, b, x0, m_state, tol, shard=None):
        """FGMRES-IR (K5): float32 inner FGMRES cycles on the Ruiz-scaled
        operator, float64 true residual and refinement between cycles, and
        a NaN guard. Returns ``(x, residual_norm, krylov_iterations)``; the
        norm is measured in the EQUILIBRATED space and rescaled to ``|b|``
        (the diagonal scaling spans ~10 orders on contact systems, so the
        raw-residual norm is dominated by a few wild rows).

        With a dof ``shard``, ``b``, ``x0`` and the result are this rank's
        rows: the matvecs exchange halos, every norm and dot product (and
        the NaN guard) is all-reduced, and the preconditioner runs on the
        gathered residual, of which the rank keeps its rows."""
        restart = self._restart
        max_cycles = max(-(-self.maxiter // restart), 1)
        data_p = torch.cat([data, data.new_zeros(1)])
        dr, dc, dc1 = m_state["dr"], m_state["dc"], m_state["dc1"]
        if shard is None:
            red, ell_sel, ell_col = _Local, self._ell_sel, self._ell_col
        else:
            red, ell_sel, ell_col = shard, shard.ell_sel, shard.ell_col
            dr, dc = shard.own(dr), shard.own(dc)
        val = data_p[ell_sel]
        # Solve the Ruiz-equilibrated system (Dr A Dc) y = Dr b, x = Dc y;
        # the preconditioner was built in this space.
        val_eq = dr[:, None] * val * dc1[ell_col]
        val32 = val_eq.to(torch.float32)

        if shard is None:
            # This solve's two matrices, each with its K1 launcher.
            mv_eq = kernels.EllOperator(val_eq, ell_col)
            mv32 = kernels.EllOperator(val32, ell_col)

            def M(r):
                return self._m_apply(m_state, r)

        else:
            # The same two matrices' row shards, each with its K19 launcher.
            op_eq, op32 = shard.operator(val_eq), shard.operator(val32)

            def mv_eq(y):
                return shard.matvec(op_eq, y)

            def mv32(y):
                return shard.matvec(op32, y)

            def M(r):
                return shard.own(self._m_apply(m_state, shard.gather(r)))

        b_eq = dr * b
        b_eq_norm = torch.clamp(red.norm(b_eq), min=1e-30)
        atol = tol * b_eq_norm
        n = b.shape[0]

        y = x0 / dc
        r = b_eq - mv_eq(y)
        rn = red.norm(r)
        iters = 0
        k = 0
        while k < max_cycles and bool((rn > atol) & torch.isfinite(rn)):
            rs = torch.clamp(rn, min=1e-30)
            # Inner relative target: whatever the outer contract still
            # needs, floored at f32 resolution.
            inner_atol = torch.clamp(atol / rs, min=1e-7).to(torch.float32)
            d32, _ri, it = _fgmres(
                mv32,
                M,
                (r / rs).to(torch.float32),
                torch.zeros(n, dtype=torch.float32, device=b.device),
                inner_atol,
                restart,
                1,
                red,
            )
            d = rs * d32.to(y.dtype)
            # Guard: a NaN/Inf inner result must not poison y — keep the
            # old iterate and let the outer loop exit on rn.
            ok = red.all_finite(d)
            y = torch.where(ok, y + d, y)
            r = b_eq - mv_eq(y)
            rn = torch.where(ok, red.norm(r), torch.full_like(rn, float("nan")))
            iters += it
            k += 1
        x = dc * y
        res = rn / b_eq_norm * red.norm(b)
        return x, res, iters

    # -- driver ----------------------------------------------------------------

    def _solve_device(self, data, b, tol=None, shard=None):
        """Device solve returning ``(x, residual_norm)`` at the caller's
        scale; builds the preconditioner on first use and refreshes it
        once when a solve stalls. With a dof ``shard``, ``b`` and ``x`` are
        the rank's rows and every decision is taken from all-reduced
        values, the same on every rank (the refresh too: the whole
        Jacobian ``data`` is on every rank)."""
        target = float(tol) if tol is not None else self.tol
        data = torch.as_tensor(data, dtype=torch.float64, device=self.device)
        if self._m_state is None:
            self.refresh_preconditioner(data)
        b_norm = float((_Local if shard is None else shard).norm(b))
        if b_norm == 0.0 or not np.isfinite(b_norm):
            return torch.zeros(b.shape[0], dtype=b.dtype, device=b.device), b_norm
        # Solve at unit rhs scale: near-converged Newton steps hand in
        # |b| ~ 1e-7..1e-13; normalizing makes the solve scale-invariant.
        b_unit = b / b_norm
        x = torch.zeros(b.shape[0], dtype=b.dtype, device=b.device)
        x, res_dev, iters = self._solve(data, b_unit, x, self._m_state, target, shard)
        res = float(res_dev)
        refreshed = False
        if np.isfinite(res) and res > target:
            # Stalled: refresh the frozen preconditioner from the CURRENT
            # Jacobian values and retry once, warm-started.
            self.refresh_preconditioner(data)
            refreshed = True
            x, res_dev, it2 = self._solve(data, b_unit, x, self._m_state, target, shard)
            res = float(res_dev)
            iters = iters + it2
        self.last_stats = {
            "krylov_iters": int(iters),
            "refreshed": refreshed,
            "nnz": int(self.system.indices_np.shape[0]),
            "n": self.n,
            "dense": self._dense,
        }
        return x * b_norm, res * b_norm

    # -- public API ------------------------------------------------------------

    def solve(self, data, b, tol=None) -> np.ndarray:
        """Solve on the device; host-spsolve fallback (logged + counted) if
        the Krylov iteration misses tolerance. ``tol`` overrides the
        construction-time relative tolerance for this call (inexact-Newton
        forcing). Returns a host array."""
        b = torch.as_tensor(b, dtype=torch.float64, device=self.device)
        x, res = self._solve_device(data, b, tol=tol)
        res = float(res)
        b_norm = float(torch.linalg.vector_norm(b))
        eff_tol = float(tol) if tol is not None else self.tol
        if not np.isfinite(res) or res > max(
            eff_tol * max(b_norm, 1.0) * 1e3, 1e-8
        ):
            FALLBACK_COUNTER["count"] += 1
            logger.warning(
                "Device %s missed tolerance (|r|=%.2e, |b|=%.2e); falling back "
                "to host spsolve (fallback #%d).",
                self.method,
                res,
                b_norm,
                FALLBACK_COUNTER["count"],
            )
            A = self._host_matrix(data)
            return sps.linalg.spsolve(A, b.cpu().numpy())
        return x.cpu().numpy()

    def solve_device(self, data, b):
        """Device-only solve: returns (x, residual_norm) without host checks
        (for device-resident loops). With a dof mesh set, ``b`` is this
        rank's rows of the right-hand side (``data`` the whole Jacobian's
        nonzeros) and ``x`` its rows of the solution; the residual norm is
        global."""
        return self._solve_device(data, b, shard=self._shard)
