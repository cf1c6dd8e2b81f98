"""Operator-graph compiler: DAG -> torch function + sparse Jacobian.

This module replaces the reference's interpretation machinery (the
post-order evaluator ``numerics/ad/_ad_parser.py:20`` carrying scipy
forward-mode Jacobians through every node) with a compile-once strategy:

1. :func:`build_function` traces the operator DAG into a function
   ``f(x, *env) -> torch.Tensor`` of the global dof vector ``x``. Historic
   states (previous time steps / iterates) and time-dependent arrays enter
   through ``env``, so one traced function serves every time step.
2. :func:`sparsity_pattern` propagates *structural* sparsity through the
   DAG as boolean scipy matrices — cheap, done once per equation system.
3. :func:`sparse_jacobian` computes the Jacobian by coloring-compressed
   forward-mode JVPs: columns of the pattern are greedily colored so no two
   same-colored columns share a row; one forward pass with one seed per
   color recovers all nonzeros. For FV stencils this is O(stencil size)
   tangent rows instead of O(num dofs).

What differentiates the residual (K8): :func:`dual_jvps`, the hand-written
forward-mode pass of :mod:`porepy_tpu_torch.numerics.ad.forward`, which
evaluates the same DAG on (value, tangent rows) pairs in the ``dual_ew``,
``dual_gather`` and K1/K14/K15/K16 kernels; the traced function carries its
executor as ``fn.dual``. :func:`colored_jvps` (``torch.func.vmap`` over
``torch.func.jvp`` of the traced function) is the plain version of that
pass: the tests and ``chip_smoke.py`` hold the two together, and a function
without a dual rule is differentiated that way on its node alone.

Constant sparse matrices are applied in padded-row (ELL) form by the K1
kernel (:func:`~porepy_tpu_torch.kernels.ell_spmv`), directly in the dual
pass and through :class:`_EllMatvec` in the traced function, an autograd
Function whose JVP and batching rules call the same kernel. Determinism:
every reduction is a row sum inside the ELL kernel or a gather over static
indices — no scatter-add — so assembly is reproducible run to run on every
device.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import numpy as np
import scipy.sparse as sps
import torch

from porepy_tpu_torch import kernels
from porepy_tpu_torch.numerics.ad.operators import (
    AdArray,
    DenseArray,
    MixedDimensionalVariable,
    Operations,
    Operator,
    Scalar,
    SparseArray,
    TimeDependentDenseArray,
    Variable,
)

__all__ = [
    "build_function",
    "evaluate",
    "evaluate_with_jacobian",
    "sparsity_pattern",
    "greedy_color",
    "colored_jvps",
    "dual_jvps",
    "sparse_jacobian",
]


# -- environment (historic/time-dependent constants) --------------------------


class _EnvSpec:
    """Ordered list of fetchers producing the non-differentiated inputs of a
    compiled function. Re-fetched every evaluation (cheap host gathers)."""

    def __init__(self) -> None:
        self.fetchers: list[Callable[[Any], np.ndarray]] = []
        self._keys: dict = {}
        self._scalar_slots: set[int] = set()
        # Slots holding immutable constants (discretization matrices,
        # projections): uploaded once, never re-fetched or re-compared.
        self.static_slots: set[int] = set()
        # Keeps const-slot host payloads alive: slot keys embed ``id()`` of
        # the payload, so a collected payload would let a later one reuse
        # the id and ALIAS the wrong slot.
        self._pinned: list = []
        # Refreshable constant matrices: (producer, record) pairs allowing a
        # VALUE-ONLY swap after rediscretization (see refresh_constants).
        self._const_mats: list[dict] = []
        # True if any slot reads the *iterate* ring (previous_iteration
        # states): such envs change within a Newton loop, which rules out
        # the fused Newton loop for this equation.
        self.has_prev_iterate: bool = False
        # Device cache: env tensors keyed on the global stored-state version
        # so unchanged historic states are not re-uploaded every assembly.
        self._cache_version: int = -1
        self._cache: Optional[list[torch.Tensor]] = None
        self._cache_host: Optional[list] = None
        self._cache_device: Optional[torch.device] = None
        # Slot indices whose host value CHANGED at the most recent
        # version-bumped fetch (None until one full refresh has been
        # observed). The fused multi-step time loop uses this to prove that
        # everything varying between time steps is state it carries itself
        # (previous-time-step variable slots); see
        # SolutionStrategy.fused_time_block.
        self.last_refreshed: Optional[set[int]] = None

    def slot(self, key, fetcher) -> int:
        if key in self._keys:
            return self._keys[key]
        idx = len(self.fetchers)
        self.fetchers.append(fetcher)
        self._keys[key] = idx
        if isinstance(key, tuple) and key and key[0] == "scalar":
            self._scalar_slots.add(idx)
        return idx

    def const_slot(self, key, host_array: np.ndarray) -> int:
        """A slot delivering an immutable array. The fetcher returns the
        HOST array; :meth:`fetch_device` uploads it to the device once,
        deduplicated globally — a projection shared by several equations
        lives on the device once."""
        idx = self.slot(key, lambda _es, _h=host_array: _h)
        self.static_slots.add(idx)
        return idx

    def refresh_constants(self) -> bool:
        """Swap refreshable constant-matrix VALUES in place after a
        rediscretization, keeping the compiled function (same shapes, same
        sparsity). Returns False — caller must rebuild — if any matrix's
        sparsity layout changed (different ELL/CSR index arrays), since
        the compiled Jacobian gather is baked to the old pattern."""
        for rec in self._const_mats:
            mat = rec["producer"]()
            kind, a, b, shape = _host_const_arrays(mat)
            if (
                kind != rec["kind"]
                or shape != rec["shape"]
                or a.shape != rec["a"].shape
                or not np.array_equal(b, rec["b"])
            ):
                return False
            if np.array_equal(a, rec["a"]):
                continue
            idx = rec["slot_a"]
            self.fetchers[idx] = lambda _es, _h=a: _h
            if self._cache is not None:
                self._cache[idx] = _to_tensor(a, self._cache_device)
                self._cache_host[idx] = a
            rec["a"] = a
        return True

    def fetch(self, eq_sys, device=None) -> list[torch.Tensor]:
        """Fresh tensors of every slot on ``device`` (default: the equation
        system's device), bypassing the cache."""
        dev = eq_sys.device if device is None else torch.device(device)
        return [_to_tensor(f(eq_sys), dev) for f in self.fetchers]

    def fetch_device(self, eq_sys) -> list[torch.Tensor]:
        """Like :meth:`fetch` but array slots are cached on the device. The
        global state version is bumped by every iterate write (each Newton
        iteration), while env slots hold *historic* states that change once
        per time step — so on a version change each slot's freshly fetched
        host array is compared against the cached one and re-uploaded only
        if it actually changed. Scalar slots (e.g. the mutable time-step
        ``ad.Scalar``) are always re-read."""
        from porepy_tpu_torch.utils.solution_storage import state_version

        dev = eq_sys.device
        version = state_version()
        if self._cache is None or self._cache_device != dev:
            host = [f(eq_sys) for f in self.fetchers]
            self._cache = [
                _device_const(h, dev) if i in self.static_slots else _to_tensor(h, dev)
                for i, h in enumerate(host)
            ]
            self._cache_host = host
            self._cache_version = version
            self._cache_device = dev
            return list(self._cache)
        if self._cache_version != version:
            refreshed: set[int] = set()
            for i, f in enumerate(self.fetchers):
                if i in self._scalar_slots or i in self.static_slots:
                    continue
                h = f(eq_sys)
                old = self._cache_host[i]
                if not (
                    isinstance(old, np.ndarray)
                    and old.shape == np.shape(h)
                    and np.array_equal(old, h)
                ):
                    self._cache[i] = _to_tensor(h, dev)
                    self._cache_host[i] = h
                    refreshed.add(i)
            self._cache_version = version
            self.last_refreshed = refreshed
        # Scalar slots (mutable ad.Scalar, e.g. the time step) can change
        # without a state-version bump: re-read the host value every call
        # and re-upload only when it changed.
        for i in self._scalar_slots:
            h = self.fetchers[i](eq_sys)
            if h != self._cache_host[i]:
                self._cache[i] = _to_tensor(h, dev)
                self._cache_host[i] = h
                if self.last_refreshed is not None:
                    self.last_refreshed.add(i)
        return list(self._cache)


def _to_tensor(h, device: torch.device) -> torch.Tensor:
    """A float64 (or int32 index) tensor copy of a host value on ``device``."""
    arr = np.asarray(h)
    dtype = torch.int32 if arr.dtype.kind in "iu" else torch.float64
    return torch.tensor(arr, dtype=dtype, device=device)


# Global device-constant dedup: (id(host array), device) -> (host ref,
# tensor). The host reference pins the id; entries live for the process
# lifetime.
_DEVICE_CONSTS: dict[tuple, tuple] = {}


def _device_const(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    key = (id(arr), device)
    hit = _DEVICE_CONSTS.get(key)
    if hit is None:
        hit = (arr, _to_tensor(arr, device))
        _DEVICE_CONSTS[key] = hit
    return hit[1]


def _var_key(v: Variable):
    return (v.name, id(v.domain), v.time_step_index, v.iterate_index)


def _fetch_variable(v: Variable):
    def fetch(eq_sys):
        return eq_sys._stored_values(v)

    return fetch


def _fetch_tda(op: TimeDependentDenseArray):
    def fetch(eq_sys):
        return eq_sys._stored_time_dependent(op)

    return fetch


# -- tracing ------------------------------------------------------------------


def build_function(
    op: Operator, eq_sys
) -> tuple[Callable, _EnvSpec]:
    """Compile an operator into ``f(x, *env) -> torch.Tensor``.

    ``x`` is the full global dof vector of ``eq_sys`` (current iterate);
    ``env`` are constant tensors described by the returned spec. Constants
    met while tracing (dense arrays, gather indices) are converted once per
    device and kept with the function. ``fn.dual`` is the
    :class:`~porepy_tpu_torch.numerics.ad.forward.DualExecutor` of the same
    DAG over the same env slots (see :func:`dual_jvps`).
    """
    from porepy_tpu_torch.numerics.ad.forward import DualExecutor

    env_spec = _EnvSpec()
    const_mats: dict[int, Any] = {}
    consts: dict[tuple, torch.Tensor] = {}

    def fn(x, *env):
        cache: dict[int, Any] = {}

        def rec(node: Operator):
            key = id(node)
            if key in cache:
                return cache[key]
            val = _trace_node(node, rec, x, env, env_spec, eq_sys, const_mats, consts)
            cache[key] = val
            return val

        return rec(op)

    _collect_env(op, env_spec, eq_sys, set(), const_mats)
    fn.dual = DualExecutor(op, eq_sys, env_spec, const_mats)
    return fn, env_spec


def constant_sparse_matrix(op: Operator):
    """The scipy matrix of a variable-free matrix subtree (constant folding
    for chains like ``projection @ trace``), or None if not constant."""
    if isinstance(op, SparseArray):
        return op.mat
    if type(op).__name__ == "MergedOperator" and hasattr(op, "fetch"):
        return op.fetch()
    if op.operation is Operations.matmul and len(op.children) == 2:
        a = constant_sparse_matrix(op.children[0])
        if a is None:
            return None
        b = constant_sparse_matrix(op.children[1])
        if b is None:
            return None
        return (a @ b).tocsr()
    # Sums/differences of constant matrices (e.g. sum_projection_list of
    # basis prolongations) are themselves constant matrices.
    if op.operation in (Operations.add, Operations.sub) and len(op.children) == 2:
        a = constant_sparse_matrix(op.children[0])
        if a is None:
            return None
        b = constant_sparse_matrix(op.children[1])
        if b is None or a.shape != b.shape:
            return None
        return (a + b if op.operation is Operations.add else a - b).tocsr()
    if op.operation is Operations.neg and len(op.children) == 1:
        a = constant_sparse_matrix(op.children[0])
        return None if a is None else (-a).tocsr()
    return None


def _collect_env(
    op: Operator, env_spec: _EnvSpec, eq_sys, seen: set, const_mats: dict
) -> None:
    if id(op) in seen:
        return
    seen.add(id(op))
    # Fold constant matrix chains (products, sums, negations of constant
    # sparse matrices) into a single device matrix.
    if op.operation in (
        Operations.matmul,
        Operations.add,
        Operations.sub,
        Operations.neg,
    ):
        mat = constant_sparse_matrix(op)
        if mat is not None:
            const_mats[id(op)] = _register_const_matrix(
                env_spec, mat,
                producer=lambda _op=op: constant_sparse_matrix(_op),
            )
            return
    if isinstance(op, MixedDimensionalVariable):
        for v in op.sub_vars:
            _collect_env(v, env_spec, eq_sys, seen, const_mats)
        return
    if isinstance(op, Variable):
        if not op.is_current_iterate:
            env_spec.slot(_var_key(op), _fetch_variable(op))
            if op.time_step_index is None and op.iterate_index != 0:
                env_spec.has_prev_iterate = True
        return
    if isinstance(op, TimeDependentDenseArray):
        env_spec.slot(
            ("tda", op.name, op.domains, op.prev_time, getattr(op, "iterate_index", 0)),
            _fetch_tda(op),
        )
        if getattr(op, "iterate_index", 0):
            env_spec.has_prev_iterate = True
        return
    if isinstance(op, Scalar):
        env_spec.slot(("scalar", id(op)), lambda _es, _op=op: np.float64(_op.value))
        return
    if isinstance(op, SparseArray):
        const_mats[id(op)] = _register_const_matrix(env_spec, op.mat)
        return
    if type(op).__name__ == "MergedOperator" and hasattr(op, "fetch"):
        const_mats[id(op)] = _register_const_matrix(
            env_spec, op.fetch(), producer=op.fetch
        )
        return
    for c in op.children:
        _collect_env(c, env_spec, eq_sys, seen, const_mats)


class _EllMatvec(torch.autograd.Function):
    """``A @ x`` for a constant ELL matrix through the K1 kernel. The
    tangent goes through the same matvec (``val``/``col`` are constants),
    and a batch of tangents — the colored JVP seeds of the assembly — runs
    as one batched launch."""

    generate_vmap_rule = False

    @staticmethod
    def forward(val, col, x):
        return kernels.ell_spmv(val, col, x.contiguous())

    @staticmethod
    def setup_context(ctx, inputs, output):
        val, col, _x = inputs
        ctx.save_for_forward(val, col)

    @staticmethod
    def jvp(ctx, _dval, _dcol, dx):
        val, col = ctx.saved_tensors
        return _EllMatvec.apply(val, col, dx)

    @staticmethod
    def vmap(info, in_dims, val, col, x):
        if in_dims[0] is not None or in_dims[1] is not None:
            raise NotImplementedError("batched ELL matrices are not supported")
        if in_dims[2] is None:
            return _EllMatvec.apply(val, col, x), None
        xb = x.movedim(in_dims[2], 0)
        if xb.dim() != 2:
            raise NotImplementedError("ELL matvec batches one vector axis")
        return _EllMatvec.apply(val, col, xb), 0


class _CsrMatvec(torch.autograd.Function):
    """``A @ x`` for a constant :class:`_CsrMat` (the layout for matrices
    with pathological row lengths); linear in ``x`` like
    :class:`_EllMatvec`. The matrix enters as the :class:`_CsrMat` holder,
    not as a tensor: functorch cannot wrap sparse CSR tensors."""

    generate_vmap_rule = False

    @staticmethod
    def forward(holder, x):
        if x.dim() == 1:
            return torch.mv(holder.mat, x)
        return torch.matmul(holder.mat, x.T).T

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.holder = inputs[0]

    @staticmethod
    def jvp(ctx, _dholder, dx):
        return _CsrMatvec.apply(ctx.holder, dx)

    @staticmethod
    def vmap(info, in_dims, holder, x):
        if in_dims[1] is None:
            return _CsrMatvec.apply(holder, x), None
        return _CsrMatvec.apply(holder, x.movedim(in_dims[1], 0)), 0


class _EllMat:
    """Sparse matrix in padded-row (ELL) layout: ``val`` ``(n, K)`` float64,
    ``col`` ``(n, K)`` int32 with padding column ``n_cols``. The matvec is
    the K1 kernel. ``val``/``col`` are device constants or env tensors."""

    __slots__ = ("val", "col", "shape", "ndim", "_op")

    def __init__(self, val, col, shape) -> None:
        self.val = val
        self.col = col
        self.shape = shape
        self.ndim = 2
        self._op = None

    @property
    def op(self) -> "kernels.EllOperator":
        """The K1 launcher of this matrix (made at first use), for callers
        outside ``torch.func``: the dual-number pass."""
        if self._op is None:
            self._op = kernels.EllOperator(self.val, self.col)
        return self._op

    @classmethod
    def from_scipy(cls, mat: sps.spmatrix, device) -> "_EllMat":
        val, col, shape = _ell_host_arrays(mat)
        return cls(_to_tensor(val, device), _to_tensor(col, device), shape)

    def matvec(self, x):
        return _EllMatvec.apply(self.val, self.col, x)


class _CsrMat:
    """Constant ``torch.sparse_csr`` matrix with a forward-differentiable,
    batchable matvec."""

    __slots__ = ("mat", "shape", "ndim")

    def __init__(self, mat: torch.Tensor) -> None:
        self.mat = mat
        self.shape = tuple(mat.shape)
        self.ndim = 2

    def matvec(self, x):
        return _CsrMatvec.apply(self, x)


def _ell_host_arrays(mat: sps.spmatrix):
    csr = sps.csr_matrix(mat)
    csr.sort_indices()
    n_rows, n_cols = csr.shape
    counts = np.diff(csr.indptr)
    K = max(int(counts.max()) if counts.size else 1, 1)
    pos = np.arange(csr.indices.size) - np.repeat(csr.indptr[:-1], counts)
    row_of = np.repeat(np.arange(n_rows), counts)
    val = np.zeros((n_rows, K))
    col = np.full((n_rows, K), n_cols, dtype=np.int32)
    val[row_of, pos] = csr.data
    col[row_of, pos] = csr.indices
    return val, col, csr.shape


def _csr_tensor(data, indptr_indices, shape) -> _CsrMat:
    """A :class:`_CsrMat` from value tensor ``data`` and the packed int32
    ``[indptr, indices]`` tensor built by :func:`_host_const_arrays`."""
    n_rows = shape[0]
    crow = indptr_indices[: n_rows + 1].to(torch.int64)
    cols = indptr_indices[n_rows + 1 :].to(torch.int64)
    return _CsrMat(
        torch.sparse_csr_tensor(crow, cols, data, size=shape, dtype=data.dtype)
    )


class _ConstMatRef:
    """Placeholder for a constant sparse matrix delivered through env
    slots; :meth:`resolve` turns the env tensors into the operand used by
    the trace (:class:`_EllMat` or :class:`_CsrMat`)."""

    __slots__ = ("kind", "slot_a", "slot_b", "shape")

    def __init__(self, kind: str, slot_a: int, slot_b: int, shape) -> None:
        self.kind = kind
        self.slot_a = slot_a
        self.slot_b = slot_b
        self.shape = shape

    def resolve(self, env):
        a, b = env[self.slot_a], env[self.slot_b]
        if self.kind == "ell":
            return _EllMat(a, b, self.shape)
        return _csr_tensor(a, b, self.shape)


def _host_const_arrays(mat: sps.spmatrix) -> tuple:
    """Host ELL/CSR arrays of a constant matrix: ``(kind, values, indices,
    shape)``; ELL when padding is reasonable, CSR (values, packed int32
    ``[indptr, indices]``) for pathological rows."""
    csr = sps.csr_matrix(mat)
    counts = np.diff(csr.indptr)
    K = int(counts.max()) if counts.size else 0
    nnz = max(csr.nnz, 1)
    if K <= 64 or K * csr.shape[0] <= 8 * nnz:
        val, col, shape = _ell_host_arrays(csr)
        return ("ell", val, col, shape)
    csr = csr.copy()
    csr.sort_indices()
    data = np.array(csr.data, dtype=np.float64, copy=True)
    idx = np.concatenate([csr.indptr, csr.indices]).astype(np.int32)
    return ("csr", data, idx, csr.shape)


def _register_const_matrix(
    env_spec: "_EnvSpec", mat: sps.spmatrix, producer=None
) -> _ConstMatRef:
    """Cache the host ELL/CSR arrays on the scipy object and register env
    slots so the matrix reaches the compiled function as an argument.

    ``producer``: optional zero-arg callable re-reading the CURRENT matrix
    (e.g. from the data dictionary after a rediscretization); registering
    it makes the slot value-refreshable via ``refresh_constants``."""
    host = getattr(mat, "_ppt_host", None)
    if host is None:
        host = _host_const_arrays(mat)
        try:
            mat._ppt_host = host
        except AttributeError:
            pass
    env_spec._pinned.append(host)
    kind, a, b, shape = host
    sa = env_spec.const_slot(("constmat", id(host), 0), a)
    sb = env_spec.const_slot(("constmat", id(host), 1), b)
    if producer is not None:
        env_spec._const_mats.append(
            {
                "producer": producer,
                "kind": kind,
                "a": a,
                "b": b,
                "shape": shape,
                "slot_a": sa,
                "slot_b": sb,
            }
        )
    return _ConstMatRef(kind, sa, sb, shape)


def _device_const_matrix(mat: sps.spmatrix, device):
    """ELL layout when the padding is reasonable, CSR for pathological
    rows (a near-dense row would blow the padded storage)."""
    kind, a, b, shape = _host_const_arrays(mat)
    if kind == "ell":
        return _EllMat(_to_tensor(a, device), _to_tensor(b, device), shape)
    return _csr_tensor(_to_tensor(a, device), _to_tensor(b, device), shape)


def _resolve_const(v, env):
    return v.resolve(env) if isinstance(v, _ConstMatRef) else v


def _trace_node(node, rec, x, env, env_spec, eq_sys, const_mats, consts):
    dev = x.device
    if isinstance(node, Scalar):
        slot = env_spec.slot(
            ("scalar", id(node)), lambda _es, _op=node: np.float64(_op.value)
        )
        return env[slot]
    if isinstance(node, DenseArray):
        key = (id(node), dev)
        if key not in consts:
            consts[key] = _to_tensor(node.values, dev)
        return consts[key]
    if isinstance(node, SparseArray) or (
        type(node).__name__ == "MergedOperator" and hasattr(node, "fetch")
    ):
        if id(node) in const_mats:
            return _resolve_const(const_mats[id(node)], env)
        key = (id(node), dev)
        if key not in consts:
            mat = node.mat if isinstance(node, SparseArray) else node.fetch()
            consts[key] = _device_const_matrix(mat, dev)
        return consts[key]
    if isinstance(node, MixedDimensionalVariable):
        if not node.sub_vars:
            return torch.zeros(0, dtype=x.dtype, device=dev)
        return torch.cat([rec(v) for v in node.sub_vars])
    if isinstance(node, Variable):
        if node.is_current_iterate:
            key = (id(node), dev)
            if key not in consts:
                idx = np.asarray(eq_sys.dofs_of([node]), dtype=np.int64)
                consts[key] = torch.tensor(idx, dtype=torch.int64, device=dev)
            return x[consts[key]]
        slot = env_spec.slot(_var_key(node), _fetch_variable(node))
        return env[slot]
    if isinstance(node, TimeDependentDenseArray):
        slot = env_spec.slot(
            (
                "tda",
                node.name,
                node.domains,
                node.prev_time,
                getattr(node, "iterate_index", 0),
            ),
            _fetch_tda(node),
        )
        return env[slot]

    if id(node) in const_mats:
        return _resolve_const(const_mats[id(node)], env)

    c = [rec(ch) for ch in node.children]
    op = node.operation
    if op is Operations.add:
        return c[0] + c[1]
    if op is Operations.sub:
        return c[0] - c[1]
    if op is Operations.mul:
        return c[0] * c[1]
    if op is Operations.div:
        return c[0] / c[1]
    if op is Operations.pow:
        return c[0] ** c[1]
    if op is Operations.neg:
        return -c[0]
    if op is Operations.matmul:
        left, right = c
        # Matrix @ scalar: broadcast the scalar over the domain (reference
        # allows e.g. ``scalar_to_tangential @ c_num`` for both cell-wise
        # arrays and single scalars, contact_mechanics.py:215).
        if right.dim() == 0 or (
            tuple(right.shape) == (1,) and left.shape[1] != 1
        ):
            right = right.reshape(()).expand(left.shape[1])
        if isinstance(left, (_EllMat, _CsrMat)):
            return left.matvec(right)
        return torch.matmul(left, right)
    if op is Operations.concat:
        if not c:
            return torch.zeros(0, dtype=x.dtype, device=dev)
        return torch.cat([torch.atleast_1d(v) for v in c])
    if op is Operations.evaluate:
        assert node.func is not None, "evaluate node without function"
        return node.func(*c)
    raise NotImplementedError(f"Operation {op} not supported by compiler")


# -- user-facing evaluation ---------------------------------------------------


def evaluate(op: Operator, eq_sys, state=None) -> np.ndarray:
    """Evaluate an operator at the current iterate, or at an explicitly
    supplied global state vector (used by line searches)."""
    fn, env_spec = build_function(op, eq_sys)
    x = _to_tensor(
        eq_sys._global_vector() if state is None else np.asarray(state),
        eq_sys.device,
    )
    out = fn(x, *env_spec.fetch(eq_sys))
    return out.cpu().numpy()


def evaluate_with_jacobian(op: Operator, eq_sys) -> AdArray:
    fn, env_spec = build_function(op, eq_sys)
    x = _to_tensor(eq_sys._global_vector(), eq_sys.device)
    env = env_spec.fetch(eq_sys)
    pattern = sparsity_pattern(op, eq_sys)
    val, jac = sparse_jacobian(fn, x, env, pattern)
    return AdArray(val, jac)


# -- structural sparsity ------------------------------------------------------


def sparsity_pattern(op: Operator, eq_sys) -> sps.csr_matrix:
    """Boolean ``(num_rows(op), num_dofs)`` structural Jacobian pattern.

    Guaranteed to be a superset of the true pattern; exact for FV stencils.
    """
    ndof = eq_sys.num_dofs()
    cache: dict[int, sps.csr_matrix] = {}

    def rec(node: Operator) -> sps.csr_matrix:
        key = id(node)
        if key in cache:
            return cache[key]
        pat = _pattern_node(node, rec, ndof, eq_sys)
        cache[key] = pat
        return pat

    return rec(op).tocsr()


def _zero_pattern(nrows: int, ndof: int) -> sps.csr_matrix:
    return sps.csr_matrix((nrows, ndof), dtype=bool)


def _union(a: sps.csr_matrix, b: sps.csr_matrix) -> sps.csr_matrix:
    # Broadcasting: a 1-row pattern (scalar operand) expands to the other
    # operand's rows. Scalar operands are constants, hence zero patterns.
    if a.shape[0] == b.shape[0]:
        return (a + b).astype(bool)
    if a.shape[0] == 1 and a.nnz == 0:
        return b
    if b.shape[0] == 1 and b.nnz == 0:
        return a
    if a.shape[0] == 1:
        a = sps.vstack([a] * b.shape[0])
        return (a + b).astype(bool)
    if b.shape[0] == 1:
        b = sps.vstack([b] * a.shape[0])
        return (a + b).astype(bool)
    raise ValueError(f"Incompatible pattern shapes {a.shape} vs {b.shape}")


def _pattern_node(node, rec, ndof, eq_sys) -> sps.csr_matrix:
    if isinstance(node, Scalar):
        return _zero_pattern(1, ndof)
    if isinstance(node, DenseArray):
        return _zero_pattern(node.values.shape[-1] if node.values.ndim else 1, ndof)
    if isinstance(node, SparseArray):
        return _zero_pattern(node.mat.shape[0], ndof)
    if type(node).__name__ == "MergedOperator" and hasattr(node, "fetch"):
        return _zero_pattern(node.fetch().shape[0], ndof)
    if isinstance(node, MixedDimensionalVariable):
        if not node.sub_vars:
            return _zero_pattern(0, ndof)
        return sps.vstack([rec(v) for v in node.sub_vars]).tocsr()
    if isinstance(node, Variable):
        n = node.size()
        if not node.is_current_iterate:
            return _zero_pattern(n, ndof)
        idx = eq_sys.dofs_of([node])
        return sps.csr_matrix(
            (np.ones(n, dtype=bool), (np.arange(n), idx)), shape=(n, ndof)
        )
    if isinstance(node, TimeDependentDenseArray):
        n = eq_sys._stored_time_dependent(node).shape[0]
        return _zero_pattern(n, ndof)

    c = [rec(ch) for ch in node.children]
    op = node.operation
    if op in (Operations.add, Operations.sub, Operations.mul, Operations.div, Operations.pow):
        return _union(c[0], c[1])
    if op is Operations.neg:
        return c[0]
    if op is Operations.matmul:
        left = node.children[0]
        left_mat = constant_sparse_matrix(left)
        if left_mat is not None:
            right_pat = c[1]
            if right_pat.shape[0] == 1 and left_mat.shape[1] != 1:
                # Scalar broadcast: every row with a nonzero inherits the
                # scalar's dependency pattern.
                rowmask = np.asarray(
                    abs(left_mat).astype(bool).sum(axis=1)
                ).ravel() > 0
                return (
                    sps.csr_matrix(rowmask.reshape(-1, 1)) @ right_pat
                ).astype(bool).tocsr()
            return (abs(left_mat).astype(bool) @ right_pat).astype(bool).tocsr()
        if isinstance(left, DenseArray) and left.values.ndim == 2:
            return (
                sps.csr_matrix(left.values.astype(bool)) @ c[1]
            ).astype(bool).tocsr()
        raise NotImplementedError(
            "matmul with non-constant left operand has no structural pattern: "
            f"{type(left).__name__} {getattr(left, 'name', '')!r} "
            f"op={getattr(left, 'operation', None)}"
        )
    if op is Operations.concat:
        if not c:
            return _zero_pattern(0, ndof)
        return sps.vstack(c).tocsr()
    if op is Operations.evaluate:
        pattern_fn = getattr(node, "func_pattern", None)
        if pattern_fn is not None:
            return pattern_fn(c, ndof)
        # Elementwise function: union of argument patterns.
        out = c[0]
        for other in c[1:]:
            out = _union(out, other)
        return out
    raise NotImplementedError(f"No pattern rule for {op}")


# -- coloring + compressed Jacobian -------------------------------------------


def greedy_color(pattern: sps.csr_matrix) -> tuple[np.ndarray, int]:
    """Distance-2 column coloring: no two columns sharing a row get the same
    color. Each color class is a *maximal* independent set of the column
    conflict graph, built Luby-style: every surviving candidate whose random
    priority is the minimum over all its rows joins the class; candidates
    sharing a row with a newly admitted column defer to a later color.
    Fully vectorized (numpy scatter/min-reduce over the nnz entries, no
    per-column Python work); expected O(nnz * log n) per color."""
    ndof = pattern.shape[1]
    if ndof == 0:
        return np.zeros(0, dtype=np.int64), 0
    csc = pattern.tocsc()
    nrows = pattern.shape[0]
    degree = np.diff(csc.indptr)
    colors = -np.ones(ndof, dtype=np.int64)
    colors[degree == 0] = 0
    e_cols = np.repeat(np.arange(ndof), degree)
    e_rows = csc.indices.astype(np.int64)
    # Deterministic random priorities (Luby): O(log n) MIS rounds w.h.p.
    rank = np.random.default_rng(0x5EED).permutation(ndof).astype(np.int64)

    color = 0
    remaining = colors < 0
    while remaining.any():
        cand = remaining.copy()
        while cand.any():
            sel = cand[e_cols]
            rows_s = e_rows[sel]
            cols_s = e_cols[sel]
            ranks_s = rank[cols_s]
            # Min priority claiming each row among current candidates.
            first = np.full(nrows, ndof, dtype=np.int64)
            np.minimum.at(first, rows_s, ranks_s)
            # A candidate wins iff it holds the min claim on every row.
            n_bad = np.zeros(ndof, dtype=np.int64)
            np.add.at(n_bad, cols_s[first[rows_s] < ranks_s], 1)
            winners = cand & (n_bad == 0)
            colors[winners] = color
            # Drop winners and anything sharing a row with a winner.
            row_blocked = np.zeros(nrows, dtype=bool)
            row_blocked[rows_s[winners[cols_s]]] = True
            n_blocked = np.zeros(ndof, dtype=np.int64)
            np.add.at(n_blocked, cols_s[row_blocked[rows_s]], 1)
            cand &= (n_blocked == 0) & ~winners
        remaining = colors < 0
        color += 1
    return colors, max(int(colors.max()) + 1, 1) if ndof else 0


def colored_jvps(fn: Callable, x: torch.Tensor, env: Sequence, seeds: torch.Tensor):
    """``(fn(x, *env), compressed)`` with ``compressed[c] = J @ seeds[c]``:
    ``torch.func.vmap`` over ``torch.func.jvp`` of one residual, the colored
    JVPs of the sparse Jacobian (K8)."""

    def f_of_x(xx):
        return fn(xx, *env)

    def one(seed):
        return torch.func.jvp(f_of_x, (x,), (seed,))

    val, compressed = torch.func.vmap(one)(seeds)
    return val[0], compressed


def dual_jvps(fn: Callable, x: torch.Tensor, env: Sequence, colors, n_colors: int):
    """``(fn(x, *env), compressed)`` as :func:`colored_jvps` gives them for
    the one-hot seeds of ``colors`` (int32 tensor over the unknowns), by the
    hand-written forward-mode pass ``fn.dual`` (K8); ``compressed`` is
    ``None`` where the residual does not depend on ``x``. With ``colors=None``
    the value alone is computed."""
    return fn.dual(x, env, colors, n_colors)


def sparse_jacobian(
    fn: Callable,
    x: torch.Tensor,
    env: Sequence[torch.Tensor],
    pattern: sps.csr_matrix,
    colors: Optional[np.ndarray] = None,
    n_colors: Optional[int] = None,
) -> tuple[np.ndarray, sps.csr_matrix]:
    """Value + sparse Jacobian of ``fn`` at ``x`` via coloring-compressed
    forward JVPs: :func:`dual_jvps` for a function built by
    :func:`build_function`, :func:`colored_jvps` for any other callable.
    Returns host ``(value, csr_jacobian)``."""
    if colors is None or n_colors is None:
        colors, n_colors = greedy_color(pattern)
    ndof = x.shape[0]
    if n_colors == 0:
        val = fn(x, *env).cpu().numpy()
        return val, sps.csr_matrix((val.shape[0], ndof))

    if hasattr(fn, "dual"):
        val, compressed = dual_jvps(
            fn, x, env, _to_tensor(colors.astype(np.int32), x.device), n_colors
        )
        if compressed is None:
            compressed = val.new_zeros((n_colors, val.shape[0]))
    else:
        seeds = np.zeros((n_colors, ndof))
        seeds[colors, np.arange(ndof)] = 1.0
        val, compressed = colored_jvps(fn, x, env, _to_tensor(seeds, x.device))

    rows, cols = pattern.nonzero()  # row-major (csr) order
    data = compressed.cpu().numpy()[colors[cols], rows]
    jac = sps.csr_matrix(
        (data, (rows, cols)), shape=(pattern.shape[0], ndof)
    )
    return val.cpu().numpy(), jac
