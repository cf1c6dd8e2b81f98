"""Smoothed-aggregation algebraic multigrid for the device Krylov solvers.

The reference eliminates every linear system with a host direct solver
(reference ``models/solution_strategy.py:830-877``). The replacement is
iterative, and the number of Krylov iterations is the whole game: an
unpreconditioned (or weakly preconditioned) solve of an elliptic FV system
costs hundreds of matvecs, a V-cycle-preconditioned one costs a few tens.
This module supplies the V-cycle:

* :func:`build_hierarchy` runs ONCE (or rarely) on host: strength graph,
  greedy aggregation, near-nullspace-aware tentative prolongation (rigid
  body modes for elasticity blocks), Jacobi smoothing of the prolongator and
  Galerkin coarse operators via scipy spgemm.
* :class:`Hierarchy` holds the device form: every level's operator and
  transfer in padded-row (ELL) layout — a dense ``(n, K)`` value tensor and
  an ``(n, K)`` int32 column tensor — and the coarse inverse.
* :meth:`Hierarchy.apply` is a function of ``(state, r)`` where ``state``
  is the dict of level tensors: the whole V-cycle (K3) is one launch of the
  hand-written ``amg_vcycle`` kernel through the state's
  :class:`~porepy_tpu_torch.kernels.VCycleOperator`, made when the state is
  built; value updates (:meth:`Hierarchy.update_values`) keep every shape.

Smoothers are damped sign-aware l1-Jacobi (scale-robust — the md systems
mix O(1e-6) accumulation rows with O(1) flux rows), the coarsest level is a
precomputed dense inverse applied as a dense GEMV.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import scipy.sparse as sps
import torch

from porepy_tpu_torch import kernels
from porepy_tpu_torch.utils import device_policy

__all__ = ["build_hierarchy", "Hierarchy"]


def _ell_arrays(mat: sps.spmatrix, dtype) -> tuple[np.ndarray, np.ndarray]:
    """Padded-row (ELL) layout ``(val, col)`` of shape ``(n_rows, K)``.
    Padding columns point at index ``n_cols`` (a zero appended to the
    operand vector by the matvec)."""
    csr = sps.csr_matrix(mat)
    csr.sort_indices()
    n_rows, n_cols = csr.shape
    counts = np.diff(csr.indptr)
    K = max(int(counts.max()) if counts.size else 1, 1)
    pos = np.arange(csr.indices.size) - np.repeat(csr.indptr[:-1], counts)
    row_of = np.repeat(np.arange(n_rows), counts)
    val = np.zeros((n_rows, K), dtype=dtype)
    col = np.full((n_rows, K), n_cols, dtype=np.int32)
    val[row_of, pos] = csr.data
    col[row_of, pos] = csr.indices
    return val, col


def _aggregate(S: sps.csr_matrix) -> tuple[np.ndarray, int]:
    """Greedy aggregation of the strength graph: distance-1 root aggregates,
    then attach leftovers to a neighboring aggregate, then singletons."""
    n = S.shape[0]
    agg = np.full(n, -1, dtype=np.int64)
    n_agg = 0
    indptr, indices = S.indptr, S.indices
    for i in range(n):
        if agg[i] >= 0:
            continue
        nb = indices[indptr[i] : indptr[i + 1]]
        if nb.size and (agg[nb] >= 0).any():
            continue
        agg[i] = n_agg
        agg[nb] = n_agg
        n_agg += 1
    for i in range(n):
        if agg[i] >= 0:
            continue
        nb = indices[indptr[i] : indptr[i + 1]]
        taken = nb[agg[nb] >= 0]
        if taken.size:
            agg[i] = agg[taken[0]]
    for i in range(n):
        if agg[i] < 0:
            agg[i] = n_agg
            n_agg += 1
    return agg, n_agg


def _node_strength(
    A: sps.csr_matrix, bs: int, theta: float
) -> sps.csr_matrix:
    """Symmetrized node-level strength graph. For ``bs > 1`` the dof matrix
    is collapsed to nodes by block Frobenius norms; strength is
    ``|a_ij| >= theta * sqrt(|a_ii a_jj|)``."""
    n = A.shape[0]
    nn = n // bs
    coo = A.tocoo()
    nr = coo.row // bs
    nc = coo.col // bs
    key = nr.astype(np.int64) * nn + nc
    uniq, inv = np.unique(key, return_inverse=True)
    ss = np.zeros(uniq.size)
    np.add.at(ss, inv, coo.data.astype(np.float64) ** 2)
    unr = (uniq // nn).astype(np.int64)
    unc = (uniq % nn).astype(np.int64)
    norm = np.sqrt(ss)
    dnorm = np.ones(nn)
    on_diag = unr == unc
    dnorm[unr[on_diag]] = np.maximum(norm[on_diag], 1e-300)
    strong = (~on_diag) & (norm >= theta * np.sqrt(dnorm[unr] * dnorm[unc]))
    S = sps.csr_matrix(
        (np.ones(int(strong.sum())), (unr[strong], unc[strong])), shape=(nn, nn)
    )
    return ((S + S.T) > 0).tocsr()


def _tentative_prolongation(
    agg: np.ndarray, n_agg: int, B: np.ndarray, bs: int
) -> tuple[sps.csr_matrix, np.ndarray]:
    """Near-nullspace-preserving tentative prolongator: per aggregate, the
    thin-QR of the nullspace rows becomes the P0 block (orthonormal
    columns); the R factors stack into the coarse nullspace."""
    k = B.shape[1]
    n = agg.size * bs
    order = np.argsort(agg, kind="stable")
    bounds = np.searchsorted(agg[order], np.arange(n_agg + 1))
    rows, cols, vals = [], [], []
    B_c = np.zeros((n_agg * k, k))
    for a in range(n_agg):
        nodes = order[bounds[a] : bounds[a + 1]]
        dofs = (nodes[:, None] * bs + np.arange(bs)[None, :]).ravel()
        Ba = B[dofs]
        if dofs.size >= k:
            q, r = np.linalg.qr(Ba)
        else:
            # Tiny aggregate: keep the raw modes; rank handled by the
            # pseudo-inverse-style normalization below.
            q, r = Ba, np.eye(k)
        # Guard exactly-zero columns (e.g. rotation mode on a single node).
        col_norm = np.linalg.norm(q, axis=0)
        dead = col_norm < 1e-12
        if dead.any():
            q = q.copy()
            q[:, dead] = 0.0
        rows.append(np.repeat(dofs, k))
        cols.append(np.tile(a * k + np.arange(k), dofs.size))
        vals.append(q.ravel())
        B_c[a * k : (a + 1) * k] = r
    P0 = sps.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n_agg * k),
    )
    return P0, B_c


def _power_lam(M: sps.spmatrix, iters: int = 12) -> float:
    n = M.shape[0]
    v = np.full(n, 1.0 / np.sqrt(n))
    lam = 1.0
    for _ in range(iters):
        w = M @ v
        nw = np.linalg.norm(w)
        if nw == 0.0 or not np.isfinite(nw):
            return 1.0
        v = w / nw
    lam = float(abs(v @ (M @ v)))
    return max(lam * 1.05, 1e-30)


def flow_ordered_jacobi(
    A: sps.csr_matrix,
    rel_tol: float = 1e-10,
    max_sweeps: int = 192,
) -> tuple[np.ndarray, int] | None:
    """Detect an (essentially) triangular block and return the exact
    undamped-Jacobi configuration for it, or ``None``.

    Upwind transport and complementarity blocks are acyclic in their
    significant couplings: in flow-topological order the matrix is lower
    triangular, so the iteration matrix of TRUE-diagonal undamped Jacobi,
    ``-D^{-1} L``, is nilpotent with index ``depth + 1`` — the sweeps solve
    the block EXACTLY in ``depth + 1`` iterations, with no reordering and
    no sequential triangular solve (each sweep is one ELL matvec; the
    device-friendly substitute for the host world's spsolve on such blocks).
    Damped l1-Jacobi, by contrast, loses the nilpotency and stalls on
    advection chains (measured: 128 sweeps leave a 0.11 relative residual
    where depth+1 undamped sweeps are exact).

    Returns ``(1/diag, sweeps)`` when the significant-coupling digraph
    (``|a_ij| > rel_tol * |a_ii|``) is acyclic with everywhere nonzero
    diagonal and depth small enough; ``None`` otherwise.
    """
    import scipy.sparse.csgraph as csgraph

    n = A.shape[0]
    if n == 0:
        return None
    dg = A.diagonal()
    if np.any(dg == 0.0) or not np.all(np.isfinite(dg)):
        return None
    coo = (A - sps.diags(dg)).tocoo()
    keep = np.abs(coo.data) > rel_tol * np.abs(dg[coo.row])
    if not np.any(keep):
        return 1.0 / dg, 1
    G = sps.csr_matrix(
        (np.ones(int(keep.sum())), (coo.row[keep], coo.col[keep])),
        shape=(n, n),
    )
    ncomp, _ = csgraph.connected_components(
        G, directed=True, connection="strong"
    )
    if ncomp != n:
        return None  # cycles: not triangular, undamped Jacobi may diverge
    # Longest path (levels) by Kahn traversal: sweeps needed for exactness.
    indeg = np.asarray((G != 0).sum(axis=0)).ravel()
    level = np.zeros(n, np.int64)
    stack = list(np.where(indeg == 0)[0])
    indptr, indices = G.indptr, G.indices
    while stack:
        u = stack.pop()
        lu = level[u] + 1
        for v in indices[indptr[u] : indptr[u + 1]]:
            if lu > level[v]:
                level[v] = lu
            indeg[v] -= 1
            if indeg[v] == 0:
                stack.append(v)
    depth = int(level.max())
    if depth + 1 > max_sweeps:
        return None
    # Headroom for mild flow reordering between value refreshes (the sweep
    # count is frozen into the compiled program at first build).
    sweeps = min(depth + depth // 4 + 2, max_sweeps)
    return 1.0 / dg, sweeps


def _l1_smoother(A: sps.csr_matrix) -> np.ndarray:
    """Sign-aware damped l1-Jacobi: ``0.5 * sign(diag) / row_l1``. Bounded
    for arbitrarily scaled rows (plain inverse-diagonal Jacobi diverges on
    md coupling rows whose diagonal sits far below the row scale)."""
    l1 = np.abs(A).sum(axis=1)
    l1 = np.asarray(l1).ravel()
    l1[l1 == 0.0] = 1.0
    sgn = np.sign(A.diagonal())
    sgn[sgn == 0.0] = 1.0
    return 0.5 * sgn / l1


class Hierarchy:
    """Device SA-AMG hierarchy.

    ``structure`` (aggregates, transfer sparsity, level sizes) is frozen at
    build time; ``state`` (the dict of value tensors consumed by
    :meth:`apply`) can be refreshed from a new fine matrix via
    :meth:`update_values` with every shape unchanged. Its tensors live on
    ``device`` (default: the CUDA card).
    """

    def __init__(
        self,
        levels_host: list[dict],
        coarse_inv: np.ndarray,
        dtype: torch.dtype,
        nu: int = 2,
        device: Union[str, torch.device, None] = None,
    ) -> None:
        self._levels_host = levels_host
        self.dtype = dtype
        self.device = device_policy.resolve(device)
        self.nu = nu
        self.level_sizes = [lv["A"].shape[0] for lv in levels_host] + [
            coarse_inv.shape[0]
        ]
        self.state = self._device_state(levels_host, coarse_inv)

    # -- state construction ----------------------------------------------------

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(np.asarray(a), device=self.device)

    def _device_state(self, levels_host, coarse_inv) -> dict:
        """The level tensors, and their V-cycle launcher in
        ``self._vcycles`` (made anew, so that launchers of an earlier state
        do not hold its tensors)."""
        np_dtype = torch.empty(0, dtype=self.dtype).numpy().dtype
        state = {
            "levels": [],
            "coarse_inv": self._tensor(coarse_inv.astype(np_dtype)),
        }
        for lv in levels_host:
            A_val, A_col = _ell_arrays(lv["A"], np_dtype)
            P_val, P_col = _ell_arrays(lv["P"], np_dtype)
            R_val, R_col = _ell_arrays(lv["P"].T.tocsr(), np_dtype)
            state["levels"].append(
                {
                    "A_val": self._tensor(A_val),
                    "A_col": self._tensor(A_col),
                    "P_val": self._tensor(P_val),
                    "P_col": self._tensor(P_col),
                    "R_val": self._tensor(R_val),
                    "R_col": self._tensor(R_col),
                    "sinv": self._tensor(_l1_smoother(lv["A"]).astype(np_dtype)),
                }
            )
        self._vcycles = {}
        self._vcycle(state)
        return state

    def _vcycle(self, state: dict) -> kernels.VCycleOperator:
        """The launcher of ``state``: made the first time a state is seen
        (a state handed in from elsewhere gets its own), the same after."""
        levels, coarse_inv = state["levels"], state["coarse_inv"]
        op = self._vcycles.get(id(coarse_inv))
        if op is None or not op.holds(levels, coarse_inv):
            op = self._vcycles[id(coarse_inv)] = kernels.VCycleOperator(levels, coarse_inv, self.nu)
        return op

    def update_values(self, A_new: sps.csr_matrix) -> None:
        """Refresh all level values from a new fine-level matrix, keeping the
        aggregation/transfer structure. Host spgemm per level; the new state
        has identical shapes."""
        A = A_new.tocsr()
        new_levels = []
        for lv in self._levels_host:
            lv = dict(lv)
            lv["A"] = A
            new_levels.append(lv)
            A = (lv["P"].T @ A @ lv["P"]).tocsr()
        coarse = A.toarray()
        coarse_inv = _safe_inv(coarse)
        self._levels_host = new_levels
        self.state = self._device_state(new_levels, coarse_inv)

    # -- application -----------------------------------------------------------

    def apply(self, state: dict, r: torch.Tensor) -> torch.Tensor:
        """V(nu, nu) cycle: a function of the state dict and the residual
        (K3: one ``amg_vcycle`` launch on the card, its plain version on the
        CPU)."""
        return self._vcycle(state)(r.to(self.dtype).contiguous()).to(r.dtype)


def _safe_inv(M: np.ndarray) -> np.ndarray:
    try:
        return np.linalg.inv(M)
    except np.linalg.LinAlgError:
        return np.linalg.pinv(M)


def build_hierarchy(
    A: sps.spmatrix,
    B: Optional[np.ndarray] = None,
    block_size: int = 1,
    theta: float = 0.08,
    max_levels: int = 6,
    coarse_max: int = 300,
    omega: float = 4.0 / 3.0,
    dtype: torch.dtype = torch.float32,
    nu: int = 2,
    device: Union[str, torch.device, None] = None,
) -> Hierarchy:
    """Build a smoothed-aggregation hierarchy on host.

    Parameters
    ----------
    A:
        Square sparse operator (need not be symmetric; the strength graph is
        symmetrized and the hierarchy is used as a preconditioner for
        FGMRES/BiCGStab).
    B:
        Near-nullspace modes ``(n, k)``. Defaults to the constant vector.
        For elasticity pass rigid body modes (translations + rotations).
    block_size:
        Dofs per node (e.g. ``nd`` for interleaved displacement dofs); the
        strength graph and aggregation act on nodes.
    theta:
        Strength-of-connection drop tolerance.
    dtype:
        Device dtype of the hierarchy (f32 default: the V-cycle is an
        approximate inverse — half the gather bytes, no loss of final
        accuracy since the outer Krylov runs in the system dtype).
    device:
        Device of the hierarchy's tensors (default: the CUDA card; pass
        ``"cpu"`` for the host).
    """
    device = device_policy.resolve(device)
    A = A.tocsr()
    n = A.shape[0]
    if B is None:
        B = np.ones((n, 1))
    bs = block_size
    levels_host: list[dict] = []
    while A.shape[0] > coarse_max and len(levels_host) < max_levels - 1:
        S = _node_strength(A, bs, theta)
        agg, n_agg = _aggregate(S)
        if n_agg * B.shape[1] >= A.shape[0]:
            break  # aggregation stalled; stop coarsening
        P0, B_c = _tentative_prolongation(agg, n_agg, B, bs)
        d = np.abs(A.diagonal())
        d[d == 0.0] = 1.0
        DinvA = sps.diags(1.0 / d) @ A
        lam = _power_lam(DinvA)
        P = (sps.eye(n := A.shape[0], format="csr") - (omega / lam) * DinvA) @ P0
        levels_host.append({"A": A, "P": P.tocsr()})
        A = (P.T @ A @ P).tocsr()
        B = B_c
        bs = B.shape[1]
    coarse_inv = _safe_inv(A.toarray())
    return Hierarchy(levels_host, coarse_inv, dtype=dtype, nu=nu, device=device)
