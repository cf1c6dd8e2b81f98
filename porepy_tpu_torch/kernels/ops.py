"""PyTorch operators over the hand-written CUDA kernels.

Each operator is a ``torch.library.custom_op``: on a CUDA tensor it
launches its kernel from ``csrc/`` (and raises if the build or the launch
fails); on a CPU tensor it runs the plain version from
:mod:`porepy_tpu_torch.kernels.reference`. ``LAUNCHES`` counts kernel
launches per operator, and only those.

Some operators are plain functions with the same rule (the kernel for a
CUDA tensor, the plain version for a CPU tensor), as they gain nothing from
the dispatcher: K1's launcher :class:`EllOperator`, which the solve and the
assembly call (the custom operator ``ell_spmv`` remains for ``torch.func``);
K2's :class:`JacobiSweeps`, one per Jacobi block, and K3's
:class:`VCycleOperator`, one per AMG hierarchy state;
K4's :class:`FgmresArnoldi`, one per FGMRES cycle;
K19's launcher :class:`HaloOperator`, one per shard matrix of the sharded
solve;
K14's :class:`TpfaAdLauncher`, one per subdomain geometry and kind (the
flux or the trace: value and all tangents in one launch);
K18a's :func:`bicgstab_cycle` and K18b's :func:`gmres_cycle`; the flow
steps' :class:`FlowCycle`, one per linearization buffer (K12, K13: a
BiCGStab solve in two cooperative launches) and their linearizations
:func:`structured_linearize` and :func:`tpfa_linearize`; K8's
launchers :class:`DualEwLauncher`, :class:`DualGatherVar` and
:class:`DualGatherCopy`, made once per step of the assembly's dual pass;
and the K14, K15 and K8 operators at the end,
called from the dual-number pass of the assembly
(:mod:`porepy_tpu_torch.numerics.ad.forward`) and from inside
``torch.autograd.Function``s, with optional seeds and row strides.
"""

from __future__ import annotations

import ctypes
import struct

import torch

from porepy_tpu_torch.kernels import reference
from porepy_tpu_torch.kernels.build import library

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "ell_spmv",
    "EllOperator",
    "EllOperators",
    "ell_jacobi_sweep",
    "JacobiSweeps",
    "VCycleOperator",
    "FgmresArnoldi",
    "dense_block_scatter",
    "gj_pivot_inverse",
    "dense_block_apply",
    "structured_residual",
    "structured_jvp",
    "structured_linearize",
    "tpfa_residual",
    "tpfa_jvp",
    "tpfa_linearize",
    "FlowCycle",
    "region_solve",
    "bicgstab_cycle",
    "bicgstab_cycle_grid",
    "gmres_cycle",
    "gmres_cycle_grid",
    "K18A",
    "K18B",
    "rachford_rice",
    "interp_lookup",
    "interp_tangent",
    "block_inverse",
    "HaloOperator",
    "upwind_flux",
    "upwind_flux_tangent",
    "upwind_select",
    "upwind_select_pair",
    "segment_sum_sorted",
    "TpfaAdGeometry",
    "TpfaAdLauncher",
    "tpfa_ad_dual",
    "tpfa_ad_flux",
    "tpfa_ad_flux_tangent",
    "tpfa_ad_trace",
    "tpfa_ad_trace_tangent",
    "DualProgram",
    "DualTape",
    "DualEwLauncher",
    "dual_ew",
    "DualGatherVar",
    "DualGatherCopy",
    "dual_gather_var",
    "dual_gather_copy",
    "jac_gather",
]

#: Kernel launches per operator since the last :func:`reset_launches`.
LAUNCHES = {
    "ell_spmv": 0,
    "amg_vcycle": 0,
    "jacobi_sweeps": 0,
    "fgmres_arnoldi": 0,
    "dense_block_scatter": 0,
    "gj_pivot_inverse": 0,
    "dense_block_apply": 0,
    "structured_residual": 0,
    "structured_jvp": 0,
    "structured_linearize": 0,
    "bicgstab_stencil": 0,
    "tpfa_residual": 0,
    "tpfa_jvp": 0,
    "tpfa_linearize": 0,
    "bicgstab_tpfa": 0,
    "region_solve": 0,
    "bicgstab_cycle": 0,
    "gmres_cycle": 0,
    "rachford_rice": 0,
    "interp_lookup": 0,
    "block_inverse": 0,
    "halo_interior": 0,
    "halo_boundary": 0,
    "upwind_flux": 0,
    "upwind_select": 0,
    "segment_sum_sorted": 0,
    "tpfa_ad_flux": 0,
    "tpfa_ad_trace": 0,
    "dual_ew": 0,
    "dual_gather": 0,
    "jac_gather": 0,
}

#: The operators of a BiCGStab solve (K18a) and of one GMRES(30) restart
#: (K18b), each one cooperative kernel in ``csrc/krylov.cu``.
K18A = ("bicgstab_cycle",)
K18B = ("gmres_cycle",)

_SUFFIX = {torch.float32: "_f32", torch.float64: "_f64"}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(name: str, tensors: dict, dtype: torch.dtype) -> None:
    for arg, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected cuda")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {dtype} not supported (float32/float64)")


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _current_stream(device: int = -1) -> int:
    """The current stream of ``device`` (default: the current device) as the
    integer the kernels take. ``torch.cuda.current_stream()`` builds a
    ``Stream`` object on every call (~25 us of host time under a profiler);
    the raw handle is one C call."""
    if _RAW_STREAM is None:
        return torch.cuda.current_stream().cuda_stream
    return _RAW_STREAM(device if device >= 0 else torch.cuda.current_device())


_FUNCTIONS: dict = {}


def _kernel(name: str, dtype: torch.dtype):
    """The ctypes function ``ppt_<name>`` for ``dtype``, resolved once (the
    first call builds the library)."""
    key = (name, dtype)
    fn = _FUNCTIONS.get(key)
    if fn is None:
        fn = _FUNCTIONS[key] = getattr(library(), "ppt_" + name + _SUFFIX[dtype])
    return fn


def _launch(name: str, dtype: torch.dtype, *args, count_as: str = "") -> None:
    """Launch ``ppt_<name>`` and count it under ``count_as`` (default ``name``)."""
    rc = _kernel(name, dtype)(*args, _current_stream())
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")
    LAUNCHES[count_as or name] += 1


# -- K1 ---------------------------------------------------------------------------


class EllOperator:
    """A fixed padded-row (ELL) matrix and its K1 launch: ``op(x, c, sign)``
    is ``c + sign * (A @ x)`` (``c`` optional, of the result's shape;
    ``sign`` 1 or -1; ``A @ x`` rounded before ``c`` is added, as the two
    operations). ``x`` is ``(n_cols,)`` or ``(B, n_cols)``; padding columns
    equal ``n_cols``.

    The matrix (``val`` float32/float64 ``(n, K)``, ``col`` int32) is checked
    once, here, and the kernel's ctypes function resolved once, so a call
    on the card checks ``x`` and ``c``, allocates the result and makes one
    ctypes call: no dispatcher. A matrix on the CPU runs the plain version.
    The result is always a new tensor, so ``c`` never aliases it."""

    __slots__ = (
        "val", "col", "n_rows", "K", "dtype", "_fn", "_dev", "_device", "_val_ptr", "_col_ptr",
    )

    def __init__(self, val: torch.Tensor, col: torch.Tensor) -> None:
        if col.dtype != torch.int32 or val.dtype not in _SUFFIX:
            raise TypeError("ell_spmv: needs float32/float64 val and int32 col")
        if val.dim() != 2 or col.shape != val.shape:
            raise ValueError("ell_spmv: needs (n, K) val and col")
        self.val, self.col = val, col
        self.n_rows, self.K = val.shape
        self.dtype = val.dtype
        self._fn = None
        if val.is_cuda or col.is_cuda:
            _check("ell_spmv", {"val": val, "col": col}, val.dtype)
            if col.device != val.device:
                raise ValueError("ell_spmv: val and col on different cards")
            self._dev, self._device = val.get_device(), val.device
            self._val_ptr, self._col_ptr = val.data_ptr(), col.data_ptr()
            self._fn = _kernel("ell_spmv", val.dtype)

    def __call__(self, x: torch.Tensor, c=None, sign: int = 1) -> torch.Tensor:
        if self._fn is None:
            if x.is_cuda:
                raise ValueError("ell_spmv: x is on the card, the matrix on the CPU")
            return reference.ell_spmv(self.val, self.col, x, c, sign)
        if not x.is_cuda or x.get_device() != self._dev:
            raise ValueError(f"ell_spmv: x is on {x.device}, expected the matrix's card")
        if x.dtype != self.dtype or x.dim() not in (1, 2) or not x.is_contiguous():
            raise ValueError("ell_spmv: needs a contiguous x of shape (m,) or (B, m) in val's dtype")
        y = torch.empty(x.shape[:-1] + (self.n_rows,), dtype=self.dtype, device=self._device)
        c_ptr = None
        if c is not None:
            if c.shape != y.shape or c.dtype != self.dtype or not c.is_contiguous() or (
                not c.is_cuda or c.get_device() != self._dev
            ):
                raise ValueError("ell_spmv: c must be a contiguous tensor like the result")
            c_ptr = c.data_ptr()
        if y.numel() == 0:
            return y
        rc = self._fn(
            self._val_ptr, self._col_ptr, x.data_ptr(), c_ptr, y.data_ptr(), self.n_rows,
            self.K, x.shape[-1], x.shape[0] if x.dim() == 2 else 1, -1 if sign < 0 else 1,
            _current_stream(self._dev),
        )
        if rc != 0:
            raise RuntimeError(f"ell_spmv kernel launch failed with CUDA error {rc}")
        LAUNCHES["ell_spmv"] += 1
        return y


class EllOperators:
    """Launchers by matrix: ``ops(val, col, *more)`` makes the launcher
    ``cls(val, col, *more)`` (default :class:`EllOperator`) of those tensors
    the first time they are seen and returns the same one after. For
    holders of fixed matrices that are also called with matrices built
    elsewhere (a preconditioner state handed in)."""

    __slots__ = ("_ops", "_cls")

    def __init__(self, cls=None) -> None:
        self._ops = {}
        self._cls = cls or EllOperator

    def __call__(self, *tensors: torch.Tensor):
        hit = self._ops.get(id(tensors[0]))
        if hit is None or any(a is not b for a, b in zip(hit[0], tensors)):
            hit = self._ops[id(tensors[0])] = (tensors, self._cls(*tensors))
        return hit[1]


@torch.library.custom_op("porepy_tpu_torch::ell_spmv", mutates_args=())
def ell_spmv(val: torch.Tensor, col: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` in padded-row form; ``x`` is ``(n_cols,)`` or
    ``(B, n_cols)``. Padding columns equal ``n_cols``. The operator that
    ``torch.func`` transforms see; every other caller uses
    :class:`EllOperator`."""
    return reference.ell_spmv(val, col, x)


@ell_spmv.register_kernel("cuda")
def _ell_spmv_cuda(val, col, x):
    if col.dtype != torch.int32 or val.dtype != x.dtype:
        raise TypeError("ell_spmv: needs val of x's dtype and int32 col")
    _check("ell_spmv", {"val": val, "col": col, "x": x}, x.dtype)
    return EllOperator(val, col)(x)


@ell_spmv.register_fake
def _(val, col, x):
    return x.new_empty(x.shape[:-1] + (val.shape[0],))


# -- K2 and K3 --------------------------------------------------------------------

#: Levels of a V-cycle that one ``amg_vcycle`` launch takes (``kMaxLevels`` in
#: ``csrc/amg_vcycle.cu``; ``amg.build_hierarchy``'s ``max_levels``).
VCYCLE_MAX_LEVELS = 6


def _on_card(name: str, tensors: dict) -> bool:
    """Whether the tensors lie on a card (then all on one, contiguous) or on
    the CPU (then all there)."""
    devices = {t.device for t in tensors.values()}
    if len(devices) > 1:
        raise ValueError(f"{name}: tensors on {sorted(map(str, devices))}, expected one device")
    on_card = next(iter(devices)).type != "cpu"
    if on_card:
        _check(name, tensors, next(iter(tensors.values())).dtype)
    return on_card


class JacobiSweeps:
    """A fixed square ELL matrix ``(val, col)`` with its smoother ``sinv``
    and the K2 launch: ``op(r, s, y=None)`` is ``s`` sweeps ``y <- y + sinv
    * (r - A y)`` from ``y``, or from ``y = sinv * r``, ``s >= 1``, in one
    cooperative launch with a grid sync between sweeps. Checked once, here; the operator owns the scratch vector of the
    sweeps, so a call checks ``r`` (and ``y``), allocates the result and
    makes one ctypes call. A matrix on the CPU runs the plain version."""

    __slots__ = ("val", "col", "sinv", "n", "K", "dtype", "_fn", "_dev", "_device", "_args",
                 "_scratch")

    def __init__(self, val: torch.Tensor, col: torch.Tensor, sinv: torch.Tensor) -> None:
        if col.dtype != torch.int32 or val.dtype not in _SUFFIX or sinv.dtype != val.dtype:
            raise TypeError("jacobi_sweeps: needs float32/float64 val and sinv of one dtype, int32 col")
        if val.dim() != 2 or col.shape != val.shape or sinv.shape != (val.shape[0],):
            raise ValueError("jacobi_sweeps: needs (n, K) val and col and (n,) sinv")
        self.val, self.col, self.sinv = val, col, sinv
        self.n, self.K = val.shape
        self.dtype = val.dtype
        self._fn = None
        if _on_card("jacobi_sweeps", {"val": val, "col": col, "sinv": sinv}):
            self._dev, self._device = val.get_device(), val.device
            self._scratch = torch.empty_like(sinv)
            self._args = (val.data_ptr(), col.data_ptr(), sinv.data_ptr())
            self._fn = _kernel("jacobi_sweeps", val.dtype)

    def _vector(self, name: str, v: torch.Tensor) -> None:
        if v.dtype != self.dtype or v.shape != (self.n,) or not v.is_contiguous():
            raise ValueError(f"jacobi_sweeps: {name} must be a contiguous ({self.n},) tensor in val's dtype")
        on_cpu = v.device.type == "cpu"
        if on_cpu != (self._fn is None) or (not on_cpu and v.get_device() != self._dev):
            raise ValueError(f"jacobi_sweeps: {name} is on {v.device}, the matrix on {self.val.device}")

    def __call__(self, r: torch.Tensor, s: int, y=None) -> torch.Tensor:
        if s < 1:
            raise ValueError(f"jacobi_sweeps: {s} sweeps, needs at least one")
        self._vector("r", r)
        if y is not None:
            self._vector("y", y)
        if self._fn is None:
            return reference.jacobi_sweeps(self.val, self.col, self.sinv, r, y, s)
        out = torch.empty_like(r)
        if self.n == 0:
            return out
        rc = self._fn(
            *self._args, r.data_ptr(), None if y is None else y.data_ptr(), out.data_ptr(),
            self._scratch.data_ptr(), self.n, self.K, s, _current_stream(self._dev),
        )
        if rc != 0:
            raise RuntimeError(f"jacobi_sweeps kernel launch failed with CUDA error {rc}")
        LAUNCHES["jacobi_sweeps"] += 1
        return out


def ell_jacobi_sweep(
    val: torch.Tensor, col: torch.Tensor, sinv: torch.Tensor, r: torch.Tensor, y: torch.Tensor
) -> torch.Tensor:
    """One smoother sweep ``y + sinv * (r - A y)``: :class:`JacobiSweeps`
    with ``s = 1`` from ``y`` (one ``jacobi_sweeps`` launch on the card)."""
    return JacobiSweeps(val, col, sinv)(r, 1, y)


_LEVEL = ("A_val", "A_col", "P_val", "P_col", "R_val", "R_col", "sinv")


class VCycleOperator:
    """The V(``nu``, ``nu``) cycle of one SA-AMG hierarchy state and its K3
    launch: ``op(r)`` is the cycle's ``y`` for the residual ``r`` (see
    :func:`porepy_tpu_torch.kernels.reference.amg_vcycle`), the whole cycle
    one cooperative ``amg_vcycle`` launch on the card.

    ``levels`` is the state's list of level dicts (``A_val``/``A_col``
    ``(n_l, K)``, ``P_*`` ``(n_l, K)`` with columns into level ``l + 1``,
    ``R_*`` ``(n_{l+1}, K)``, ``sinv`` ``(n_l,)``; float32/float64 values,
    int32 columns), at most :data:`VCYCLE_MAX_LEVELS` of them, and
    ``coarse_inv`` the ``(n_L, n_L)`` inverse of the coarse level. All are
    checked once, here; on the card the kernel's ctypes function is
    resolved, the level table (pointers and sizes) built, and the scratch
    vectors of every level allocated, owned and reused by every call (the
    stream orders one call after the last). A call checks ``r``, allocates
    the result and makes one ctypes call. A state on the CPU runs the plain
    version."""

    __slots__ = ("levels", "coarse_inv", "nu", "n", "dtype", "_fn", "_dev", "_device", "_args",
                 "_keep")

    def __init__(self, levels, coarse_inv: torch.Tensor, nu: int) -> None:
        if len(levels) > VCYCLE_MAX_LEVELS:
            raise ValueError(f"amg_vcycle: {len(levels)} levels, at most {VCYCLE_MAX_LEVELS}")
        if nu < 0:
            raise ValueError(f"amg_vcycle: nu = {nu}")
        dtype = coarse_inv.dtype
        if dtype not in _SUFFIX:
            raise TypeError(f"amg_vcycle: values must be float32/float64, not {dtype}")
        nc = coarse_inv.shape[0]
        if coarse_inv.dim() != 2 or coarse_inv.shape[1] != nc:
            raise ValueError("amg_vcycle: the coarse inverse must be square")
        tensors = {"coarse_inv": coarse_inv}
        sizes = [lv["A_val"].shape[0] for lv in levels] + [nc]
        for l, lv in enumerate(levels):
            n, n_next = sizes[l], sizes[l + 1]
            for m, rows in (("A", n), ("P", n), ("R", n_next)):
                val, col = lv[m + "_val"], lv[m + "_col"]
                if col.dtype != torch.int32:
                    raise TypeError(f"amg_vcycle: level {l} {m}_col must be int32, not {col.dtype}")
                if val.dtype != dtype:
                    raise TypeError(f"amg_vcycle: level {l} {m}_val is {val.dtype}, the coarse inverse {dtype}")
                if val.dim() != 2 or col.shape != val.shape or val.shape[0] != rows:
                    raise ValueError(f"amg_vcycle: level {l} {m} must be ({rows}, K) val and col")
            if lv["sinv"].dtype != dtype:
                raise TypeError(f"amg_vcycle: level {l} sinv is {lv['sinv'].dtype}, the coarse inverse {dtype}")
            if lv["sinv"].shape != (n,):
                raise ValueError(f"amg_vcycle: level {l} sinv must be ({n},)")
            tensors.update({f"level {l} {k}": lv[k] for k in _LEVEL})
        self.levels, self.coarse_inv, self.nu = levels, coarse_inv, int(nu)
        self.n, self.dtype = sizes[0], dtype
        self._fn = None
        if not _on_card("amg_vcycle", tensors):
            return
        self._dev, self._device = coarse_inv.get_device(), coarse_inv.device
        y_coarse = coarse_inv.new_empty(nc)
        keep, table = [y_coarse], []
        for l, lv in enumerate(levels):
            n, n_next = sizes[l], sizes[l + 1]
            # y_a, y_b (level 0: a scratch, the result taking the other), t, r_next.
            scratch = [coarse_inv.new_empty(n), coarse_inv.new_empty(n if l else 0),
                       coarse_inv.new_empty(n), coarse_inv.new_empty(n_next)]
            keep += scratch
            table += [lv[k].data_ptr() for k in _LEVEL] + [t.data_ptr() for t in scratch]
            table += [n, lv["A_col"].shape[1], lv["P_col"].shape[1], lv["R_col"].shape[1], n_next]
        self._keep = keep
        host_table = (ctypes.c_longlong * max(len(table), 1))(*table)
        self._args = (host_table, len(levels), coarse_inv.data_ptr(), y_coarse.data_ptr(), nc, self.nu)
        self._fn = _kernel("amg_vcycle", dtype)

    def holds(self, levels, coarse_inv) -> bool:
        """Whether this is the operator of the state ``(levels, coarse_inv)``."""
        return self.levels is levels and self.coarse_inv is coarse_inv

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        if r.dtype != self.dtype or r.shape != (self.n,) or not r.is_contiguous():
            raise ValueError(f"amg_vcycle: r must be a contiguous ({self.n},) tensor in the state's dtype")
        if self._fn is None:
            if r.device.type != "cpu":
                raise ValueError(f"amg_vcycle: r is on {r.device}, the state on the cpu")
            return reference.amg_vcycle(self.levels, self.coarse_inv, r, self.nu)
        if not r.is_cuda or r.get_device() != self._dev:
            raise ValueError(f"amg_vcycle: r is on {r.device}, expected the state's card")
        out = torch.empty(self.n, dtype=self.dtype, device=self._device)
        if self.n == 0:
            return out
        rc = self._fn(*self._args, r.data_ptr(), out.data_ptr(), _current_stream(self._dev))
        if rc != 0:
            raise RuntimeError(f"amg_vcycle kernel launch failed with CUDA error {rc}")
        LAUNCHES["amg_vcycle"] += 1
        return out


# -- K4 ---------------------------------------------------------------------------

#: Modes of a ``fgmres_arnoldi`` launch (``kFused`` .. ``kNormalize`` in
#: ``csrc/fgmres_arnoldi.cu``): the whole step, or one of its four phases
#: around the sharded solve's all-reduces.
ARNOLDI_FUSED, ARNOLDI_DOTS, ARNOLDI_UPDATE, ARNOLDI_NORM, ARNOLDI_NORMALIZE = range(5)


class FgmresArnoldi:
    """The Arnoldi steps of one FGMRES cycle and their K4 launch
    (``fgmres_arnoldi``, one cooperative kernel a step): ``step(z)``
    finishes column ``j`` (the device int32 scalar ``j``) from ``z =
    M(V[j])``, as :func:`~porepy_tpu_torch.kernels.reference.fgmres_arnoldi`
    computes it: ``w = A z`` by ``matrix`` (an
    :class:`EllOperator`, the solve's), CGS2 against ``V[:j+1]``, ``V[j +
    1]``, ``Z[j]``, column ``j`` of ``Ht``, the Givens step on ``cs``,
    ``sn``, ``g``, ``flag = (j + 1 < restart) & (|g[j + 1]| > atol)`` and
    ``j + 1``. ``step.split(z, w, all_sum)`` is the same step with ``w = A
    z`` given and each finished sum passed through ``all_sum`` (a dof
    shard's all-reduce), four launches on the card; it needs no ``matrix``.

    ``V`` ``(restart + 1, n)``, ``Z`` ``(restart, n)``, ``Ht`` ``(restart,
    restart + 1)``, ``cs``, ``sn`` ``(restart,)``, ``g`` ``(restart + 1,)``
    and ``atol`` (one value) are float32/float64 tensors of one dtype,
    ``j`` and ``flag`` one int32 value each: the cycle's state, updated in
    place. All are checked once, here; on the card the grid is sized (the
    co-resident maximum, at most one block per 128-row tile), the partial
    sums allocated and the launch table (pointers and sizes) built, so a
    step makes one ctypes call with ``z``'s pointer. State on the CPU runs
    the plain version. ``LAUNCHES["fgmres_arnoldi"]`` counts launches."""

    __slots__ = ("V", "Z", "Ht", "cs", "sn", "g", "j", "atol", "flag", "matrix", "n", "restart",
                 "dtype", "grid", "sums", "_fn", "_dev", "_table", "_partials", "_views")

    def __init__(self, V, Z, Ht, cs, sn, g, j, atol, flag, matrix=None) -> None:
        restart, n = Z.shape if Z.dim() == 2 else (-1, -1)
        dtype = V.dtype
        if dtype not in _SUFFIX or any(t.dtype != dtype for t in (Z, Ht, cs, sn, g, atol)):
            raise TypeError("fgmres_arnoldi: V, Z, Ht, cs, sn, g and atol need one float32/float64 dtype")
        if j.dtype != torch.int32 or flag.dtype != torch.int32:
            raise TypeError("fgmres_arnoldi: j and flag must be int32")
        if (restart < 0 or V.shape != (restart + 1, n) or Ht.shape != (restart, restart + 1)
                or cs.shape != (restart,) or sn.shape != (restart,) or g.shape != (restart + 1,)
                or j.numel() != 1 or atol.numel() != 1 or flag.numel() != 1):
            raise ValueError("fgmres_arnoldi: needs V (restart + 1, n), Z (restart, n), Ht (restart, "
                             "restart + 1), cs, sn (restart,), g (restart + 1,) and one-value j, atol, flag")
        if matrix is not None and (matrix.dtype != dtype or matrix.n_rows != n):
            raise ValueError(f"fgmres_arnoldi: the matrix must be {n} rows in V's dtype")
        self.V, self.Z, self.Ht, self.cs, self.sn, self.g = V, Z, Ht, cs, sn, g
        self.j, self.atol, self.flag, self.matrix = j, atol, flag, matrix
        self.n, self.restart, self.dtype = n, restart, dtype
        self.grid = self._fn = None
        self._dev = V.get_device()  # -1 on the CPU
        state = {"V": V, "Z": Z, "Ht": Ht, "cs": cs, "sn": sn, "g": g, "j": j, "atol": atol, "flag": flag}
        if matrix is not None:
            state.update(val=matrix.val, col=matrix.col)
        if not _on_card("fgmres_arnoldi", state) or n == 0 or restart == 0:
            return
        grid = _kernel("fgmres_arnoldi_grid", dtype)(n, restart, None)
        if grid < 0:
            raise RuntimeError(f"fgmres_arnoldi: no cooperative launch (CUDA error {-grid})")
        self.grid = grid
        r1 = restart + 1
        self._partials = V.new_empty(2 * r1 + 1, _nb(n))
        self.sums = V.new_zeros(2 * r1 + 1)
        # The slices the split route all-reduces: h, h2 (entries past j stay
        # zero) and |w|^2.
        self._views = (self.sums[:r1], self.sums[r1 : 2 * r1], self.sums[2 * r1 :])
        # The kernel's launch table, ``kVal`` .. ``kGrid``.
        table = [
            matrix.val.data_ptr() if matrix is not None else 0,
            matrix.col.data_ptr() if matrix is not None else 0,
            *(t.data_ptr() for t in (V, Z, Ht, cs, sn, g, j, atol, flag, self._partials, self.sums)),
            matrix.K if matrix is not None else 0, n, restart, grid,
        ]
        self._table = (ctypes.c_longlong * len(table))(*table)
        self._fn = _kernel("fgmres_arnoldi", dtype)

    def _vector(self, name: str, v: torch.Tensor) -> None:
        if v.dtype != self.dtype or v.shape != (self.n,) or not v.is_contiguous():
            raise ValueError(f"fgmres_arnoldi: {name} must be a contiguous ({self.n},) tensor in V's dtype")
        if v.get_device() != self._dev:
            raise ValueError(f"fgmres_arnoldi: {name} is on {v.device}, the state on {self.V.device}")

    def _launch(self, z, w, mode: int) -> None:
        rc = self._fn(self._table, z, w, mode, _current_stream(self._dev))
        if rc != 0:
            raise RuntimeError(f"fgmres_arnoldi kernel launch failed with CUDA error {rc}")
        LAUNCHES["fgmres_arnoldi"] += 1

    def __call__(self, z: torch.Tensor) -> None:
        if self.matrix is None:
            raise ValueError("fgmres_arnoldi: a step with the matvec inside needs the matrix")
        self._vector("z", z)
        if self._fn is None:
            if self.V.device.type == "cpu":
                reference.fgmres_arnoldi(self.matrix.val, self.matrix.col, z, self.V, self.Z, self.Ht,
                                         self.cs, self.sn, self.g, self.j, self.atol, self.flag)
            else:  # n == 0 or restart == 0: no column to finish
                self.flag.zero_()
            return
        self._launch(z.data_ptr(), None, ARNOLDI_FUSED)

    def split(self, z: torch.Tensor, w: torch.Tensor, all_sum) -> None:
        """The step with ``w = A z`` given; ``all_sum(t)`` sums ``t`` over
        the ranks in place (and returns it) between the phases."""
        self._vector("z", z)
        self._vector("w", w)
        if self._fn is None:
            if self.V.device.type == "cpu":
                reference.fgmres_arnoldi_split(z, w, self.V, self.Z, self.Ht, self.cs, self.sn, self.g,
                                               self.j, self.atol, self.flag, all_sum)
            else:
                self.flag.zero_()
            return
        zp, wp = z.data_ptr(), w.data_ptr()
        self._launch(zp, wp, ARNOLDI_DOTS)
        for view, mode in zip(self._views, (ARNOLDI_UPDATE, ARNOLDI_NORM, ARNOLDI_NORMALIZE)):
            all_sum(view)
            self._launch(zp, wp, mode)


# -- K6 ---------------------------------------------------------------------------


@torch.library.custom_op("porepy_tpu_torch::dense_block_scatter", mutates_args=())
def dense_block_scatter(
    vals: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, ni: int, n_pad: int
) -> torch.Tensor:
    """Coalesced COO entries into a zero ``(n_pad, n_pad)`` matrix, with
    ones on the diagonal of the pad rows ``ni <= i < n_pad``."""
    return reference.dense_block_scatter(vals, rows, cols, ni, n_pad)


@dense_block_scatter.register_kernel("cuda")
def _dense_block_scatter_cuda(vals, rows, cols, ni, n_pad):
    if rows.dtype != torch.int32 or cols.dtype != torch.int32:
        raise TypeError("dense_block_scatter: rows and cols must be int32")
    nnz = vals.shape[0]
    if vals.dim() != 1 or rows.shape != (nnz,) or cols.shape != (nnz,):
        raise ValueError("dense_block_scatter: needs (nnz,) vals, rows, cols")
    if not 0 <= ni <= n_pad:
        raise ValueError("dense_block_scatter: needs 0 <= ni <= n_pad")
    _check("dense_block_scatter", {"vals": vals, "rows": rows, "cols": cols}, vals.dtype)
    D = torch.zeros((n_pad, n_pad), dtype=vals.dtype, device=vals.device)
    _launch(
        "dense_block_scatter", vals.dtype,
        vals.data_ptr(), rows.data_ptr(), cols.data_ptr(), nnz, ni, n_pad,
        D.data_ptr(),
    )
    return D


@dense_block_scatter.register_fake
def _(vals, rows, cols, ni, n_pad):
    return vals.new_empty((n_pad, n_pad))


@torch.library.custom_op("porepy_tpu_torch::gj_pivot_inverse", mutates_args=("flag",))
def gj_pivot_inverse(a: torch.Tensor, flag: torch.Tensor) -> torch.Tensor:
    """Inverses of the ``(B, b, b)`` matrices ``a`` (partial pivoting
    inside each); sets ``flag[m] = 1`` where matrix ``m`` is singular or its
    inverse is not finite, and never clears it."""
    return reference.gj_pivot_inverse(a, flag)


@gj_pivot_inverse.register_kernel("cuda")
def _gj_pivot_inverse_cuda(a, flag):
    if flag.dtype != torch.int32:
        raise TypeError("gj_pivot_inverse: flag must be int32")
    if a.dim() != 3 or a.shape[1] != a.shape[2] or flag.shape != (a.shape[0],):
        raise ValueError("gj_pivot_inverse: needs (B, b, b) matrices and a (B,) flag")
    b = a.shape[1]
    if not 1 <= b <= 128:
        raise ValueError(f"gj_pivot_inverse: b = {b} outside 1..128")
    _check("gj_pivot_inverse", {"a": a, "flag": flag}, a.dtype)
    out = torch.empty_like(a)
    _launch(
        "gj_pivot_inverse", a.dtype,
        a.data_ptr(), out.data_ptr(), flag.data_ptr(), a.shape[0], b,
    )
    return out


@gj_pivot_inverse.register_fake
def _(a, flag):
    return torch.empty_like(a)


@torch.library.custom_op("porepy_tpu_torch::dense_block_apply", mutates_args=())
def dense_block_apply(D: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``D[:ni, :ni] @ r`` for float32 ``D`` of shape ``(n_pad, n_pad)``,
    accumulated in float32 and returned in ``r``'s dtype (``ni = r.numel()``)."""
    return reference.dense_block_apply(D, r)


@dense_block_apply.register_kernel("cuda")
def _dense_block_apply_cuda(D, r):
    if D.dtype != torch.float32:
        raise TypeError("dense_block_apply: D must be float32")
    if D.dim() != 2 or D.shape[0] != D.shape[1] or r.dim() != 1 or r.shape[0] > D.shape[0]:
        raise ValueError("dense_block_apply: needs a square D and r of length <= D's")
    _check("dense_block_apply", {"D": D, "r": r}, r.dtype)
    if D.data_ptr() % 16 or D.shape[1] % 4:
        raise ValueError("dense_block_apply: D needs 16-byte aligned rows")
    y = torch.empty_like(r)
    _launch(
        "dense_block_apply", r.dtype,
        D.data_ptr(), r.data_ptr(), y.data_ptr(), r.shape[0], D.shape[1],
    )
    return y


@dense_block_apply.register_fake
def _(D, r):
    return torch.empty_like(r)


# -- K12 --------------------------------------------------------------------------


def _structured_args(name, p, q, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef) -> dict:
    """The K12 kernels' tensors by name, checked: one dtype, the grid's
    shapes, contiguous on the card."""
    dtype = p.dtype
    tensors = {
        "p": p, "q": q, "tx": tx, "ty": ty, "tz": tz, "pbc_x": pbc_x,
        "pbc_y": pbc_y, "pbc_z": pbc_z, "pv": pv, "coef": coef,
    }
    if any(t.dtype != dtype for t in tensors.values()):
        raise TypeError(f"{name}: every tensor needs p's dtype")
    if p.dim() != 3:
        raise ValueError(f"{name}: p must be (nx, ny, nz)")
    nx, ny, nz = p.shape
    shapes = {
        "q": (nx, ny, nz), "tx": (nx + 1, ny, nz), "ty": (nx, ny + 1, nz),
        "tz": (nx, ny, nz + 1), "pbc_x": (2, ny, nz), "pbc_y": (2, nx, nz),
        "pbc_z": (2, nx, ny), "pv": (nx, ny, nz), "coef": (5,),
    }
    for arg, shape in shapes.items():
        if tuple(tensors[arg].shape) != shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(tensors[arg].shape)}, expected {shape}")
    _check(name, tensors, dtype)
    return tensors


def _structured_cuda(name, *args):
    tensors = _structured_args(name, *args)
    p = tensors["p"]
    out = torch.empty_like(p)
    _launch(name, p.dtype, *(t.data_ptr() for t in tensors.values()), out.data_ptr(), *p.shape)
    return out


@torch.library.custom_op("porepy_tpu_torch::structured_residual", mutates_args=())
def structured_residual(
    p: torch.Tensor,
    p_prev: torch.Tensor,
    tx: torch.Tensor,
    ty: torch.Tensor,
    tz: torch.Tensor,
    pbc_x: torch.Tensor,
    pbc_y: torch.Tensor,
    pbc_z: torch.Tensor,
    pv: torch.Tensor,
    coef: torch.Tensor,
) -> torch.Tensor:
    """Structured 7-point TPFA mass-balance residual (see
    :func:`porepy_tpu_torch.kernels.reference.structured_residual`)."""
    return reference.structured_residual(p, p_prev, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef)


@structured_residual.register_kernel("cuda")
def _structured_residual_cuda(p, p_prev, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef):
    return _structured_cuda(
        "structured_residual", p, p_prev, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef
    )


@structured_residual.register_fake
def _(p, p_prev, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef):
    return torch.empty_like(p)


@torch.library.custom_op("porepy_tpu_torch::structured_jvp", mutates_args=())
def structured_jvp(
    p: torch.Tensor,
    dp: torch.Tensor,
    tx: torch.Tensor,
    ty: torch.Tensor,
    tz: torch.Tensor,
    pbc_x: torch.Tensor,
    pbc_y: torch.Tensor,
    pbc_z: torch.Tensor,
    pv: torch.Tensor,
    coef: torch.Tensor,
) -> torch.Tensor:
    """``J(p) dp`` of :func:`structured_residual`, upwind side frozen."""
    return reference.structured_jvp(p, dp, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef)


@structured_jvp.register_kernel("cuda")
def _structured_jvp_cuda(p, dp, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef):
    return _structured_cuda(
        "structured_jvp", p, dp, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef
    )


@structured_jvp.register_fake
def _(p, dp, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef):
    return torch.empty_like(p)


# -- K13 --------------------------------------------------------------------------


def _tpfa_args(name, p, q, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef) -> dict:
    """The K13 kernels' tensors by name, checked: one dtype for the values,
    int32 topology, consistent cell and face shapes, contiguous on the
    card."""
    dtype = p.dtype
    if any(x.dtype != dtype for x in (q, t, bc_val, pv, coef)):
        raise TypeError(f"{name}: p, q, t, bc_val, pv, coef need one dtype")
    if any(x.dtype != torch.int32 for x in (lo, hi, cell_ptr, cell_faces)):
        raise TypeError(f"{name}: lo, hi, cell_ptr, cell_faces must be int32")
    if is_neu.dtype != torch.bool:
        raise TypeError(f"{name}: is_neu must be bool")
    nc, nf = p.shape[0], t.shape[0]
    if (
        p.dim() != 1 or q.shape != (nc,) or pv.shape != (nc,)
        or any(x.shape != (nf,) for x in (lo, hi, t, is_neu, bc_val))
        or cell_ptr.shape != (nc + 1,) or cell_faces.dim() != 1 or coef.shape != (5,)
    ):
        raise ValueError(f"{name}: inconsistent cell/face shapes")
    tensors = {
        "p": p, "q": q, "lo": lo, "hi": hi, "t": t, "is_neu": is_neu,
        "bc_val": bc_val, "pv": pv, "cell_ptr": cell_ptr,
        "cell_faces": cell_faces, "coef": coef,
    }
    _check(name, tensors, dtype)
    return tensors


def _tpfa_cuda(name, *args):
    tensors = _tpfa_args(name, *args)
    p, nf = tensors["p"], tensors["t"].shape[0]
    m = torch.empty(nf, dtype=p.dtype, device=p.device)
    out = torch.empty_like(p)
    _launch(name, p.dtype, *(x.data_ptr() for x in tensors.values()), m.data_ptr(), out.data_ptr(),
            p.shape[0], nf)
    return out


@torch.library.custom_op("porepy_tpu_torch::tpfa_residual", mutates_args=())
def tpfa_residual(
    p: torch.Tensor,
    p_prev: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    t: torch.Tensor,
    is_neu: torch.Tensor,
    bc_val: torch.Tensor,
    pv: torch.Tensor,
    cell_ptr: torch.Tensor,
    cell_faces: torch.Tensor,
    coef: torch.Tensor,
) -> torch.Tensor:
    """Unstructured TPFA mass-balance residual (see
    :func:`porepy_tpu_torch.kernels.reference.tpfa_residual`)."""
    return reference.tpfa_residual(
        p, p_prev, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef
    )


@tpfa_residual.register_kernel("cuda")
def _tpfa_residual_cuda(p, p_prev, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef):
    return _tpfa_cuda(
        "tpfa_residual", p, p_prev, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef
    )


@tpfa_residual.register_fake
def _(p, p_prev, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef):
    return torch.empty_like(p)


@torch.library.custom_op("porepy_tpu_torch::tpfa_jvp", mutates_args=())
def tpfa_jvp(
    p: torch.Tensor,
    dp: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    t: torch.Tensor,
    is_neu: torch.Tensor,
    bc_val: torch.Tensor,
    pv: torch.Tensor,
    cell_ptr: torch.Tensor,
    cell_faces: torch.Tensor,
    coef: torch.Tensor,
) -> torch.Tensor:
    """``J(p) dp`` of :func:`tpfa_residual`, upwind side frozen."""
    return reference.tpfa_jvp(p, dp, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef)


@tpfa_jvp.register_kernel("cuda")
def _tpfa_jvp_cuda(p, dp, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef):
    return _tpfa_cuda(
        "tpfa_jvp", p, dp, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef
    )


@tpfa_jvp.register_fake
def _(p, dp, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef):
    return torch.empty_like(p)


# -- K12 and K13: the Newton step's linearization and BiCGStab solve ----------------


def structured_linearize(p, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef, out) -> None:
    """``J(p)`` of :func:`structured_residual` as its 7-point stencil, into
    ``out`` ``(7, nx, ny, nz)`` (see
    :func:`porepy_tpu_torch.kernels.reference.structured_linearize`); one
    launch on the card."""
    if out.shape != (7,) + tuple(p.shape) or out.dtype != p.dtype:
        raise ValueError("structured_linearize: out must be (7, *p.shape) in p's dtype")
    if not p.is_cuda:
        out.copy_(reference.structured_linearize(p, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef))
        return
    tensors = _structured_args("structured_linearize", p, p, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef)
    _check("structured_linearize", {"out": out}, p.dtype)
    del tensors["q"]
    _launch("structured_linearize", p.dtype, *(t.data_ptr() for t in tensors.values()), out.data_ptr(),
            *p.shape)


def tpfa_linearize(p, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef, slot, diag_slot,
                   vals) -> None:
    """``J(p)`` of :func:`tpfa_residual` as the values ``vals`` of a
    cell-cell CSR matrix on a fixed pattern, in place (see
    :func:`porepy_tpu_torch.kernels.reference.tpfa_linearize`); one launch
    on the card."""
    if slot.shape != cell_faces.shape or diag_slot.shape != pv.shape:
        raise ValueError("tpfa_linearize: slot must be like cell_faces, diag_slot like pv")
    if vals.dtype != p.dtype or vals.dim() != 1:
        raise ValueError("tpfa_linearize: vals must be 1-d in p's dtype")
    if not p.is_cuda:
        vals.copy_(reference.tpfa_linearize(p, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces,
                                            coef, slot, diag_slot, vals.shape[0]))
        return
    if slot.dtype != torch.int32 or diag_slot.dtype != torch.int32:
        raise TypeError("tpfa_linearize: slot and diag_slot must be int32")
    tensors = _tpfa_args("tpfa_linearize", p, p, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef)
    _check("tpfa_linearize", {"slot": slot, "diag_slot": diag_slot, "vals": vals}, p.dtype)
    del tensors["q"]
    _launch("tpfa_linearize", p.dtype, *(x.data_ptr() for x in tensors.values()), slot.data_ptr(),
            diag_slot.data_ptr(), vals.data_ptr(), p.shape[0])


class FlowCycle:
    """A flow step's BiCGStab solve of ``J x = b`` with ``M v = v / diag``
    (jax's ``bicgstab`` from ``x = 0``), ``J`` held as the coefficients of
    one linearization: K12's stencil (``kind "stencil"``, ``op = (coef,)``,
    ``coef`` ``(7, nx, ny, nz)`` of :func:`structured_linearize`) or K13's
    cell-cell CSR matrix (``kind "tpfa"``, ``op = (row_ptr, cols, vals)``,
    the values from :func:`tpfa_linearize`). ``op`` and ``diag`` ``(n,)``
    are the caller's buffers, rewritten in place between solves.

    A solve is two launches of one cooperative kernel (``bicgstab_kernel``
    in ``csrc/krylov.cu``, counted as ``bicgstab_stencil`` or
    ``bicgstab_tpfa``): one starts it (``x = 0``, ``r = b``, the tolerance
    from ``<b, b>``), one runs its iterations, both matvecs inside, until it
    stops on the device or spends ``maxiter``; the host reads the flag and
    the count once, after the second. Everything is checked once, here: the
    state (the vectors, partial sums, scalars and flag) is allocated, owned
    and reused by every solve, the pointers and the kernel's ctypes function
    resolved, so a launch makes one ctypes call. On the card it refuses to
    run where there is no cooperative launch (``grid``: the blocks of a
    launch, the co-resident maximum, at most one per 128-row tile); buffers
    on the CPU run the plain version (``reference.bicgstab_stencil``/
    ``bicgstab_tpfa``)."""

    __slots__ = ("kind", "op", "diag", "n", "dtype", "state", "grid", "_fn", "_dev", "_head", "_tail",
                 "_dims")

    def __init__(self, kind: str, op: tuple, diag: torch.Tensor) -> None:
        if kind not in ("stencil", "tpfa"):
            raise ValueError(f"FlowCycle: kind {kind!r}, expected 'stencil' or 'tpfa'")
        name = "bicgstab_" + kind
        dtype, n = diag.dtype, diag.shape[0]
        if dtype not in _SUFFIX or diag.dim() != 1:
            raise TypeError(f"{name}: diag must be a float32/float64 vector")
        if kind == "stencil":
            (coef,) = op
            if coef.dim() != 4 or coef.shape[0] != 7 or coef[0].numel() != n or coef.dtype != dtype:
                raise ValueError(f"{name}: coef must be (7, nx, ny, nz) in diag's dtype, nx ny nz = {n}")
            tensors = {"coef": coef, "diag": diag}
            self._dims = tuple(coef.shape[1:])
        else:
            row_ptr, cols, vals = op
            if row_ptr.shape != (n + 1,) or cols.dim() != 1 or vals.shape != cols.shape:
                raise ValueError(f"{name}: needs a CSR matrix of {n} rows")
            if row_ptr.dtype != torch.int32 or cols.dtype != torch.int32 or vals.dtype != dtype:
                raise TypeError(f"{name}: needs int32 row_ptr and cols, vals in diag's dtype")
            tensors = {"row_ptr": row_ptr, "cols": cols, "vals": vals, "diag": diag}
            self._dims = (n,)
        self.kind, self.op, self.diag, self.n, self.dtype = kind, tuple(op), diag, n, dtype
        dev = diag.device
        self.state = (
            [torch.zeros(n, dtype=dtype, device=dev) for _ in range(9)]
            + [torch.zeros(reference.BICG_ROWS, _nb(n), dtype=dtype, device=dev),
               torch.zeros(reference.BICG_SLOTS, dtype=dtype, device=dev),
               torch.zeros(2, dtype=torch.int32, device=dev)]
        )
        self._fn = self.grid = None
        if not _on_card(name, {"diag": diag, **tensors}):
            return
        grid = _kernel(name + "_grid", dtype)(n, None)
        if grid < 0:
            raise RuntimeError(f"{name}: no cooperative launch (CUDA error {-grid})")
        self.grid = grid
        self._dev = diag.get_device()
        self._head = tuple(t.data_ptr() for t in tensors.values())
        self._tail = tuple(t.data_ptr() for t in self.state)
        self._fn = _kernel(name, dtype)

    def launch(self, b: torch.Tensor, iterations: int, tol: float, atol: float = 0.0) -> None:
        """One launch on the state: the start (``iterations = 0``) or up to
        ``iterations`` iterations. No host read: a CUDA graph may hold it."""
        if b.dtype != self.dtype or b.shape != (self.n,) or not b.is_contiguous():
            raise ValueError(f"bicgstab_{self.kind}: b must be a contiguous ({self.n},) tensor in diag's dtype")
        if iterations < 0:
            raise ValueError(f"bicgstab_{self.kind}: {iterations} iterations")
        tol2, abs2 = float(tol) ** 2, float(atol) ** 2
        if self._fn is None:
            if b.device.type != "cpu":
                raise ValueError(f"bicgstab_{self.kind}: b is on {b.device}, the operator on the cpu")
            plain = reference.bicgstab_stencil if self.kind == "stencil" else reference.bicgstab_tpfa
            plain(*self.op, self.diag, b, *self.state, iterations, tol2, abs2)
            return
        if not b.is_cuda or b.get_device() != self._dev:
            raise ValueError(f"bicgstab_{self.kind}: b is on {b.device}, expected the operator's card")
        if self.n == 0:
            return
        rc = self._fn(*self._head, b.data_ptr(), *self._tail, *self._dims, iterations, tol2, abs2,
                      _current_stream(self._dev))
        if rc != 0:
            raise RuntimeError(f"bicgstab_{self.kind} kernel launch failed with CUDA error {rc}")
        LAUNCHES["bicgstab_" + self.kind] += 1

    def solve(self, b: torch.Tensor, tol: float, atol: float = 0.0, maxiter: int = 200) -> tuple:
        """``(x, iterations)`` of jax's ``bicgstab(J, b, tol=tol,
        atol=atol, maxiter=maxiter, M=lambda v: v / diag)``: two launches,
        one host read. ``x`` is the state's vector, rewritten by the next
        solve."""
        self.launch(b, 0, tol, atol)
        if maxiter > 0:
            self.launch(b, maxiter, tol, atol)
        _flag, k = self.state[-1].tolist()
        return self.state[0], k


# -- K10 --------------------------------------------------------------------------

# Dynamic shared memory the region-solve and block-inverse kernels may take
# (``kSmemMax`` in ``csrc/region_solve.cu`` and ``csrc/block_inverse.cu``);
# larger systems work from a device workspace.
_SMEM_MAX = 231424


@torch.library.custom_op("porepy_tpu_torch::region_solve", mutates_args=())
def region_solve(a: torch.Tensor, rhs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``W @ solve(A / s, RHS / s)`` per region, ``s`` the row maxima of
    ``|A|`` (see :func:`porepy_tpu_torch.kernels.reference.region_solve_contract`);
    ``(B, n, n)``, ``(B, n, m)``, ``(B, q, n)`` float64 in, ``(B, q, m)`` out."""
    return reference.region_solve_contract(a, rhs, w)


@region_solve.register_kernel("cuda")
def _region_solve_cuda(a, rhs, w):
    if any(t.dtype != torch.float64 for t in (a, rhs, w)):
        raise TypeError("region_solve: a, rhs and w must be float64")
    if a.dim() != 3 or rhs.dim() != 3 or w.dim() != 3:
        raise ValueError("region_solve: needs (B, n, n) a, (B, n, m) rhs, (B, q, n) w")
    B, n = a.shape[0], a.shape[1]
    m, q = rhs.shape[2], w.shape[1]
    if a.shape != (B, n, n) or rhs.shape != (B, n, m) or w.shape != (B, q, n):
        raise ValueError("region_solve: needs (B, n, n) a, (B, n, m) rhs, (B, q, n) w")
    _check("region_solve", {"a": a, "rhs": rhs, "w": w}, a.dtype)
    out = torch.empty((B, q, m), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    work = None
    if 8 * n * (n + m + 1) > _SMEM_MAX:
        work = torch.empty((B, n, n + m), dtype=a.dtype, device=a.device)
    _launch(
        "region_solve", a.dtype,
        a.data_ptr(), rhs.data_ptr(), w.data_ptr(), out.data_ptr(),
        None if work is None else work.data_ptr(), B, n, m, q,
    )
    return out


@region_solve.register_fake
def _(a, rhs, w):
    return a.new_empty((a.shape[0], w.shape[1], rhs.shape[2]))


# -- K18 --------------------------------------------------------------------------


def _check_f64(name: str, tensors: dict, ints=()) -> None:
    """Contiguous CUDA tensors, float64 (int32 for the names in ``ints``)."""
    for arg, t in tensors.items():
        want = torch.int32 if arg in ints else torch.float64
        if t.dtype != want:
            raise TypeError(f"{name}: {arg} must be {want}")
    _check(name, tensors, torch.float64)


def _nb(n: int) -> int:
    return -(-n // reference.KRYLOV_BLOCK)


def _vectors(name: str, n: int, **vectors) -> None:
    for arg, t in vectors.items():
        if t.shape != (n,):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected ({n},)")


def _partials(name: str, partials: torch.Tensor, rows: int, n: int) -> None:
    if partials.dim() != 2 or partials.shape[0] < rows or partials.shape[1] != _nb(n):
        raise ValueError(f"{name}: partials must be (>= {rows}, {_nb(n)})")


def _cycle_grid(name: str, n: int) -> int:
    grid = _kernel(name + "_grid", torch.float64)(n, None)
    if grid < 0:
        raise RuntimeError(f"{name}: no cooperative launch (CUDA error {-grid})")
    return grid


def bicgstab_cycle_grid(n: int) -> int:
    """Blocks of one :func:`bicgstab_cycle` launch for ``n`` rows on the
    current card: the co-resident maximum, at most one per 128-row tile."""
    return _cycle_grid("bicgstab_cycle", n)


def bicgstab_cycle(
    row_ptr: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, dinv: torch.Tensor,
    b: torch.Tensor, x: torch.Tensor, r: torch.Tensor, rhat: torch.Tensor, p: torch.Tensor,
    q: torch.Tensor, phat: torch.Tensor, s: torch.Tensor, shat: torch.Tensor, t: torch.Tensor,
    partials: torch.Tensor, st: torch.Tensor, cont: torch.Tensor, iterations: int,
) -> None:
    """A BiCGStab solve of ``A x = b`` with ``M = dinv *`` on the CSR matrix
    ``(row_ptr, cols, vals)``, in place (see
    :func:`porepy_tpu_torch.kernels.reference.bicgstab_cycle`):
    ``iterations = 0`` starts it from ``x``, otherwise up to ``iterations``
    iterations run while ``cont[0]`` holds, ``cont[1]`` counting them. On
    the card one cooperative launch of the K18a kernel, the matvecs and
    the scalar recurrence inside it; it refuses to run where the card has
    no cooperative launch."""
    if not b.is_cuda:
        reference.bicgstab_cycle(row_ptr, cols, vals, dinv, b, x, r, rhat, p, q, phat, s, shat,
                                 t, partials, st, cont, iterations)
        return
    n = b.shape[0]
    if iterations < 0:
        raise ValueError(f"bicgstab_cycle: {iterations} iterations")
    if row_ptr.shape != (n + 1,) or cols.dim() != 1 or vals.shape != cols.shape:
        raise ValueError("bicgstab_cycle: needs a CSR matrix of n rows")
    vec = {"dinv": dinv, "x": x, "r": r, "rhat": rhat, "p": p, "q": q, "phat": phat, "s": s,
           "shat": shat, "t": t}
    _vectors("bicgstab_cycle", n, **vec)
    _partials("bicgstab_cycle", partials, reference.BICG_ROWS, n)
    if st.shape != (reference.BICG_SLOTS,) or cont.shape != (2,):
        raise ValueError("bicgstab_cycle: needs the state and a (2,) flag and count")
    _check_f64(
        "bicgstab_cycle",
        {"row_ptr": row_ptr, "cols": cols, "vals": vals, "b": b, **vec, "partials": partials,
         "st": st, "cont": cont},
        ints=("row_ptr", "cols", "cont"),
    )
    _launch(
        "bicgstab_cycle", torch.float64,
        row_ptr.data_ptr(), cols.data_ptr(), vals.data_ptr(), dinv.data_ptr(), b.data_ptr(),
        *(v.data_ptr() for k, v in vec.items() if k != "dinv"), partials.data_ptr(),
        st.data_ptr(), cont.data_ptr(), n, iterations,
    )


def gmres_cycle_grid(n: int) -> int:
    """Blocks of one :func:`gmres_cycle` launch for ``n`` rows on the
    current card: the co-resident maximum, at most one per 128-row tile."""
    return _cycle_grid("gmres_cycle", n)


def gmres_cycle(
    row_ptr: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, dinv: torch.Tensor,
    b: torch.Tensor, x: torch.Tensor, V: torch.Tensor, H: torch.Tensor, y: torch.Tensor,
    w: torch.Tensor, partials: torch.Tensor, flags: torch.Tensor, st: torch.Tensor,
    cont: torch.Tensor, arnoldi: int,
) -> None:
    """One GMRES(``restart = H.shape[0]``) restart of ``A x = b`` with ``M =
    dinv *`` on the CSR matrix ``(row_ptr, cols, vals)``, in place (see
    :func:`porepy_tpu_torch.kernels.reference.gmres_cycle`); ``arnoldi = 0``
    starts a solve. On the card one cooperative launch of the K18b kernel,
    which refuses to run where the card has no cooperative launch."""
    if not b.is_cuda:
        reference.gmres_cycle(row_ptr, cols, vals, dinv, b, x, V, H, y, w, partials, flags, st,
                              cont, arnoldi)
        return
    n = b.shape[0]
    restart = H.shape[0]
    if not 1 <= restart <= 30:
        raise ValueError(f"gmres_cycle: restart {restart} outside 1..30")
    if row_ptr.shape != (n + 1,) or cols.dim() != 1 or vals.shape != cols.shape:
        raise ValueError("gmres_cycle: needs a CSR matrix of n rows")
    if V.shape != (restart + 1, n) or H.shape != (restart, restart + 1) or y.shape != (restart,):
        raise ValueError("gmres_cycle: needs V (restart + 1, n), H (restart, restart + 1), y (restart,)")
    _vectors("gmres_cycle", n, dinv=dinv, x=x, w=w)
    _partials("gmres_cycle", partials, restart + 3, n)
    if flags.shape != (restart + 1,) or st.shape != (reference.GMRES_SLOTS,) or cont.shape != (1,):
        raise ValueError("gmres_cycle: needs flags (restart + 1,), the state, a (1,) flag")
    _check_f64(
        "gmres_cycle",
        {"row_ptr": row_ptr, "cols": cols, "vals": vals, "dinv": dinv, "b": b, "x": x, "V": V,
         "H": H, "y": y, "w": w, "partials": partials, "flags": flags, "st": st, "cont": cont},
        ints=("row_ptr", "cols", "flags", "cont"),
    )
    _launch(
        "gmres_cycle", torch.float64,
        row_ptr.data_ptr(), cols.data_ptr(), vals.data_ptr(), dinv.data_ptr(), b.data_ptr(),
        x.data_ptr(), V.data_ptr(), H.data_ptr(), y.data_ptr(), w.data_ptr(),
        partials.data_ptr(), flags.data_ptr(), st.data_ptr(), cont.data_ptr(), n, restart,
        int(bool(arnoldi)),
    )


# -- K17 --------------------------------------------------------------------------


@torch.library.custom_op("porepy_tpu_torch::rachford_rice", mutates_args=())
def rachford_rice(
    zs: torch.Tensor, K: torch.Tensor, max_iter: int, tol: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The constant-K flash at the points ``zs`` ``(nc, N)``: ``(V, x, y,
    converged, iters)`` (see :func:`porepy_tpu_torch.kernels.reference.rachford_rice`)."""
    return reference.rachford_rice(zs, K, max_iter, tol)


@rachford_rice.register_kernel("cuda")
def _rachford_rice_cuda(zs, K, max_iter, tol):
    # Two launches: each point capped at flash.cu's kTailCap iterations, then
    # the compact list of the points still running (its count, then the
    # indices), which starts them again from V_0.
    if zs.dtype != torch.float64 or K.dtype != torch.float64:
        raise TypeError("rachford_rice: zs and K must be float64")
    if zs.dim() != 2 or K.shape != (zs.shape[0],) or not 1 <= zs.shape[0] <= 8:
        raise ValueError("rachford_rice: needs zs (nc, N), K (nc,), 1 <= nc <= 8")
    if max_iter < 0:
        raise ValueError("rachford_rice: max_iter must be >= 0")
    _check("rachford_rice", {"zs": zs, "K": K}, zs.dtype)
    nc, n = zs.shape
    V = torch.empty(n, dtype=zs.dtype, device=zs.device)
    x, y = torch.empty_like(zs), torch.empty_like(zs)
    converged = torch.empty(n, dtype=torch.bool, device=zs.device)
    iters = torch.empty(n, dtype=torch.int32, device=zs.device)
    listed = torch.empty(n + 1, dtype=torch.int32, device=zs.device)
    _launch(
        "rachford_rice", zs.dtype,
        zs.data_ptr(), K.data_ptr(), V.data_ptr(), x.data_ptr(), y.data_ptr(),
        converged.data_ptr(), iters.data_ptr(), listed.data_ptr(), listed[1:].data_ptr(),
        nc, n, max_iter, float(tol),
    )
    if n:
        LAUNCHES["rachford_rice"] += 1
    return V, x, y, converged, iters


@rachford_rice.register_fake
def _(zs, K, max_iter, tol):
    n = zs.shape[1]
    return (
        zs.new_empty(n), torch.empty_like(zs), torch.empty_like(zs),
        zs.new_empty(n, dtype=torch.bool), zs.new_empty(n, dtype=torch.int32),
    )


# -- K16 --------------------------------------------------------------------------


def _interp_cuda(values, fgeom, igeom, x, dx):
    d, n = x.shape
    if not 1 <= d <= 3:
        raise ValueError(f"interp_lookup: {d} parameters, the kernel takes 1 to 3")
    if any(t.dtype != torch.float64 for t in (values, fgeom, x)) or igeom.dtype != torch.int32 or (
        dx is not None and dx.dtype != torch.float64
    ):
        raise TypeError("interp_lookup: needs float64 values, fgeom, x, dx and int32 igeom")
    if values.dim() != 1 or fgeom.shape != (2 * d,) or igeom.shape != (2 * d,):
        raise ValueError("interp_lookup: needs flat values, fgeom = [low, h], igeom = [npt, strides]")
    tensors = {"values": values, "fgeom": fgeom, "igeom": igeom, "x": x}
    if dx is not None:
        if dx.dim() != 3 or dx.shape[1:] != (d, n):
            raise ValueError("interp_lookup: dx must be (B, d, N)")
        tensors["dx"] = dx
    _check("interp_lookup", tensors, torch.float64)
    if dx is None:
        out = torch.empty(n, dtype=x.dtype, device=x.device)
        ptrs = (0, out.data_ptr(), 0, 0)
    else:
        out = torch.empty((dx.shape[0], n), dtype=x.dtype, device=x.device)
        ptrs = (dx.data_ptr(), 0, out.data_ptr(), dx.shape[0])
    dx_ptr, out_ptr, dout_ptr, batch = ptrs
    _launch(
        "interp_lookup", torch.float64,
        values.data_ptr(), fgeom.data_ptr(), igeom.data_ptr(), x.data_ptr(),
        dx_ptr or None, out_ptr or None, dout_ptr or None, d, n, batch,
    )
    return out


@torch.library.custom_op("porepy_tpu_torch::interp_lookup", mutates_args=())
def interp_lookup(
    values: torch.Tensor, fgeom: torch.Tensor, igeom: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """Multilinear table lookup at the points ``x`` ``(d, N)``, ``d <= 3``;
    ``fgeom = [low, h]`` float64, ``igeom = [npt, strides]`` int32."""
    return reference.interp_lookup(values, fgeom, igeom, x)


@interp_lookup.register_kernel("cuda")
def _interp_lookup_cuda(values, fgeom, igeom, x):
    return _interp_cuda(values, fgeom, igeom, x, None)


@interp_lookup.register_fake
def _(values, fgeom, igeom, x):
    return x.new_empty(x.shape[1])


@torch.library.custom_op("porepy_tpu_torch::interp_tangent", mutates_args=())
def interp_tangent(
    values: torch.Tensor, fgeom: torch.Tensor, igeom: torch.Tensor, x: torch.Tensor,
    dx: torch.Tensor,
) -> torch.Tensor:
    """Tangents ``(B, N)`` of :func:`interp_lookup` at ``x`` for the seeds
    ``dx`` ``(B, d, N)``; the same kernel as the lookup, so its launches
    count under ``interp_lookup``."""
    return reference.interp_tangent(values, fgeom, igeom, x, dx)


@interp_tangent.register_kernel("cuda")
def _interp_tangent_cuda(values, fgeom, igeom, x, dx):
    return _interp_cuda(values, fgeom, igeom, x, dx)


@interp_tangent.register_fake
def _(values, fgeom, igeom, x, dx):
    return x.new_empty((dx.shape[0], x.shape[1]))


# -- K11 --------------------------------------------------------------------------


@torch.library.custom_op("porepy_tpu_torch::block_inverse", mutates_args=())
def block_inverse(a: torch.Tensor) -> torch.Tensor:
    """Inverses of the ``(B, n, n)`` float64 matrices ``a`` by Gauss-Jordan
    elimination with partial pivoting (see
    :func:`porepy_tpu_torch.kernels.reference.block_inverse`)."""
    return reference.block_inverse(a)


@block_inverse.register_kernel("cuda")
def _block_inverse_cuda(a):
    if a.dtype != torch.float64:
        raise TypeError("block_inverse: a must be float64")
    if a.dim() != 3 or a.shape[1] != a.shape[2]:
        raise ValueError("block_inverse: needs (B, n, n) matrices")
    _check("block_inverse", {"a": a}, a.dtype)
    B, n = a.shape[0], a.shape[1]
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    work = None
    if n > 32 and 8 * n * (n | 1) + 28 * n > _SMEM_MAX:
        # The matrix does not fit in shared memory: a block's in a workspace.
        work = torch.empty((B, n, n | 1), dtype=a.dtype, device=a.device)
    _launch(
        "block_inverse", a.dtype,
        a.data_ptr(), out.data_ptr(), None if work is None else work.data_ptr(), B, n,
    )
    return out


@block_inverse.register_fake
def _(a):
    return torch.empty_like(a)


# -- K19 --------------------------------------------------------------------------


class HaloOperator:
    """The row-sharded matvec of one shard matrix (K19) and its two
    launches: :meth:`interior` (launch A: the send buffer ``send =
    x_own[send_idx]`` and the interior rows of ``y`` from ``x_own`` alone),
    then, once the caller has exchanged ``send`` into ``recv`` (the halo,
    ``n_halo`` entries), :meth:`boundary` (launch B: the boundary rows from
    ``x_own`` and ``recv``; no launch when the shard has none).

    ``val`` (float32/float64 ``(n_own, K)``, the shard's rows) and the plan's
    int32 tables: ``col`` (remapped: ``c < n_own`` reads ``x_own``, then the
    halo, ``n_own + n_halo`` is padding), ``send_idx``, and the ``interior``
    and ``boundary`` row lists (increasing, together every row once). All
    are checked once, here; on the card the rows are reordered once,
    interior first (not at all, and launch A given no row list, when every
    row is interior), the ctypes
    functions resolved, the pointers read, and ``send`` and ``recv``
    allocated, owned and reused by every call (the stream orders each
    call's launches after the last call's exchange). A call checks
    ``x_own``, allocates ``y`` (always a new tensor) and makes one ctypes
    call a launch. A plan on the CPU runs the plain versions; any tensor
    off the CPU puts the operator on the card, where every tensor must be."""

    __slots__ = (
        "val", "col", "send_idx", "interior_rows", "boundary_rows", "n_own", "K", "n_halo",
        "dtype", "send", "recv", "_dev", "_device", "_interior", "_boundary", "_tables",
        "_args_a", "_args_b", "_n_int", "_n_bnd",
    )

    def __init__(
        self, val: torch.Tensor, col: torch.Tensor, send_idx: torch.Tensor,
        interior: torch.Tensor, boundary: torch.Tensor, n_halo: int,
    ) -> None:
        tables = {"col": col, "send_idx": send_idx, "interior": interior, "boundary": boundary}
        for arg, t in tables.items():
            if t.dtype != torch.int32:
                raise TypeError(f"halo: {arg} must be int32, not {t.dtype}")
        if val.dtype not in _SUFFIX:
            raise TypeError(f"halo: val must be float32/float64, not {val.dtype}")
        if val.dim() != 2 or col.shape != val.shape:
            raise ValueError("halo: needs (n_own, K) val and col")
        if send_idx.dim() != 1 or interior.dim() != 1 or boundary.dim() != 1:
            raise ValueError("halo: send_idx and the row lists must be 1-d")
        if interior.shape[0] + boundary.shape[0] != val.shape[0]:
            raise ValueError("halo: the interior and boundary rows must hold every row once")
        self.val, self.col, self.send_idx = val, col, send_idx
        self.interior_rows, self.boundary_rows = interior, boundary
        self.n_own, self.K = val.shape
        self.n_halo = int(n_halo)
        self.dtype = val.dtype
        self._n_int, self._n_bnd = interior.shape[0], boundary.shape[0]
        self._interior = None
        on_card = any(t.device.type != "cpu" for t in (val, *tables.values()))
        if on_card:
            _check("halo", {**tables, "val": val}, val.dtype)
            if any(t.device != val.device for t in tables.values()):
                raise ValueError("halo: val and the plan on different cards")
        self.send = val.new_empty(send_idx.shape[0])
        self.recv = val.new_empty(self.n_halo)
        if not on_card:
            return
        if self._n_bnd:
            rows = torch.cat([interior, boundary])
            val, col = val.index_select(0, rows), col.index_select(0, rows)
        else:
            rows = interior
        # The reordered rows, held so that the pointers below stay valid.
        self._tables = (val, col, rows)
        self._dev, self._device = val.get_device(), val.device
        self._interior = _kernel("halo_interior", val.dtype)
        self._boundary = _kernel("halo_boundary", val.dtype)
        size = val.element_size()
        self._args_a = (
            val.data_ptr(), col.data_ptr(), rows.data_ptr() if self._n_bnd else None, send_idx.data_ptr(),
            self.send.data_ptr(),
        )
        off = self._n_int * self.K
        self._args_b = (
            val.data_ptr() + off * size, col.data_ptr() + off * 4, rows.data_ptr() + 4 * self._n_int,
            self.recv.data_ptr(),
        )

    def _x(self, x_own: torch.Tensor) -> None:
        if self._interior is None:
            if x_own.device.type != "cpu":
                raise ValueError(f"halo: x_own is on {x_own.device}, the plan on the cpu")
        elif not x_own.is_cuda or x_own.get_device() != self._dev:
            raise ValueError(f"halo: x_own is on {x_own.device}, expected the plan's card")
        if x_own.dtype != self.dtype:
            raise TypeError(f"halo: x_own is {x_own.dtype}, val {self.dtype}")
        if x_own.shape != (self.n_own,) or not x_own.is_contiguous():
            raise ValueError(f"halo: needs a contiguous x_own of shape ({self.n_own},)")

    def interior(self, x_own: torch.Tensor) -> torch.Tensor:
        """Launch A: writes :attr:`send` and returns ``y`` with the interior
        rows (the boundary rows are written by :meth:`boundary`)."""
        self._x(x_own)
        if self._interior is None:
            send, y = reference.halo_interior(self.val, self.col, x_own, self.send_idx, self.interior_rows)
            self.send.copy_(send)
            return y
        y = torch.empty(self.n_own, dtype=self.dtype, device=self._device)
        if self._n_int == 0 and self.send.shape[0] == 0:
            return y
        val, col, rows, send_idx, send = self._args_a
        rc = self._interior(
            val, col, rows, x_own.data_ptr(), send_idx, send, y.data_ptr(), self._n_int, self.K,
            self.n_own, self.send.shape[0], _current_stream(self._dev),
        )
        if rc != 0:
            raise RuntimeError(f"halo_interior kernel launch failed with CUDA error {rc}")
        LAUNCHES["halo_interior"] += 1
        return y

    def boundary(self, x_own: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Launch B: the boundary rows of ``y`` (in place) from ``x_own``
        and :attr:`recv`; returns ``y``."""
        if not self._n_bnd:
            return y
        self._x(x_own)
        if y.shape != (self.n_own,) or y.dtype != self.dtype or y.device != x_own.device:
            raise ValueError("halo: y must be the result of interior()")
        if self._interior is None:
            return reference.halo_boundary(self.val, self.col, x_own, self.recv, self.boundary_rows, y)
        val, col, rows, recv = self._args_b
        rc = self._boundary(
            val, col, rows, x_own.data_ptr(), recv, y.data_ptr(), self._n_bnd, self.K, self.n_own,
            self.n_halo, _current_stream(self._dev),
        )
        if rc != 0:
            raise RuntimeError(f"halo_boundary kernel launch failed with CUDA error {rc}")
        LAUNCHES["halo_boundary"] += 1
        return y


# -- K15 --------------------------------------------------------------------------


def _rows(name: str, n: int, **fields):
    """Pointers and row strides of float64 fields of length ``n``, each
    ``(n,)`` (row stride 0), ``(B, n)`` or ``None`` (a null pointer): ``(batch,
    [ptr, ...], [stride, ...])``. Rows must be unit-strided and on the card."""
    batch, ptrs, strides = 0, [], []
    for arg, t in fields.items():
        if t is None:
            ptrs.append(None)
            strides.append(0)
            continue
        if t.dtype != torch.float64 or not t.is_cuda:
            raise TypeError(f"{name}: {arg} must be a float64 CUDA tensor")
        if t.dim() not in (1, 2) or t.shape[-1] != n:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected (B?, {n})")
        if n > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name}: {arg} needs unit-stride rows")
        if t.dim() == 2:
            if batch and t.shape[0] != batch:
                raise ValueError(f"{name}: {arg} has {t.shape[0]} rows, others {batch}")
            batch = t.shape[0]
        ptrs.append(t.data_ptr())
        strides.append(t.stride(0) if t.dim() == 2 else 0)
    return batch, ptrs, strides


def _check_upwind_geometry(name, nf, lo, hi, is_dir, is_neu, sgn_div=None):
    tensors = {"lo": lo, "hi": hi, "is_dir": is_dir, "is_neu": is_neu}
    if lo.dtype != torch.int64 or hi.dtype != torch.int64:
        raise TypeError(f"{name}: lo and hi must be int64")
    if is_dir.dtype != torch.bool or is_neu.dtype != torch.bool:
        raise TypeError(f"{name}: is_dir and is_neu must be bool")
    if sgn_div is not None:
        if sgn_div.dtype != torch.float64:
            raise TypeError(f"{name}: sgn_div must be float64")
        tensors["sgn_div"] = sgn_div
    for arg, t in tensors.items():
        if t.shape != (nf,):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected ({nf},)")
    _check(name, tensors, torch.float64)


def _upwind_flux_cuda(q, w, bc, dq, dw, dbc, lo, hi, is_dir, is_neu, sgn_div, tangent):
    nf, nc = q.shape[-1], w.shape[-1]
    _check_upwind_geometry("upwind_flux", nf, lo, hi, is_dir, is_neu, sgn_div)
    b_face, p_face, s_face = _rows("upwind_flux", nf, q=q, bc=bc, dq=dq, dbc=dbc)
    b_cell, p_cell, s_cell = _rows("upwind_flux", nc, w=w, dw=dw)
    if b_face and b_cell and b_face != b_cell:
        raise ValueError("upwind_flux: face and cell fields differ in batch size")
    batch = b_face or b_cell
    shape = (batch, nf) if batch else (nf,)
    out = torch.empty(shape, dtype=torch.float64, device=q.device)
    if nf:
        _launch(
            "upwind_flux", torch.float64,
            p_face[0], p_cell[0], p_face[1], p_face[2], p_cell[1], p_face[3],
            s_face[0], s_cell[0], s_face[1], s_face[2], s_cell[1], s_face[3],
            lo.data_ptr(), hi.data_ptr(), is_dir.data_ptr(), is_neu.data_ptr(),
            sgn_div.data_ptr(), out.data_ptr(), nf, max(batch, 1), int(tangent),
        )
    return out


def upwind_flux(q, w, bc, lo, hi, is_dir, is_neu, sgn_div):
    """The upwinded advective face flux (see
    :func:`porepy_tpu_torch.kernels.reference.upwind_flux`): ``q``, ``bc``
    ``(nf,)`` or ``(B, nf)``, ``w`` ``(nc,)`` or ``(B, nc)``, float64; ``lo``,
    ``hi`` int64, ``is_dir``, ``is_neu`` bool, ``sgn_div`` float64 ``(nf,)``."""
    if not q.is_cuda:
        return reference.upwind_flux(q, w, bc, lo, hi, is_dir, is_neu, sgn_div)
    return _upwind_flux_cuda(q, w, bc, None, None, None, lo, hi, is_dir, is_neu, sgn_div, False)


def upwind_flux_tangent(q, w, bc, dq, dw, dbc, lo, hi, is_dir, is_neu, sgn_div):
    """Tangents of :func:`upwind_flux` for the seeds ``(dq, dw, dbc)``, each
    ``(n,)``, ``(B, n)`` or ``None`` (zero), in one launch; the same kernel
    as the flux, so its launches count under ``upwind_flux``."""
    if dq is None and dw is None and dbc is None:
        raise ValueError("upwind_flux_tangent: needs at least one seed")
    if not q.is_cuda:
        return reference.upwind_flux_tangent(
            q, w, bc, dq, dw, dbc, lo, hi, is_dir, is_neu, sgn_div
        )
    return _upwind_flux_cuda(q, w, bc, dq, dw, dbc, lo, hi, is_dir, is_neu, sgn_div, True)


def upwind_select(q, w, lo, hi, is_dir, is_neu):
    """The upstream value ``up(w)`` per face (see
    :func:`porepy_tpu_torch.kernels.reference.upwind_select`); ``q`` ``(nf,)``
    or ``(B, nf)``, ``w`` ``(nc,)`` or ``(B, nc)``."""
    if not q.is_cuda:
        return reference.upwind_select(q, w, lo, hi, is_dir, is_neu)
    nf, nc = q.shape[-1], w.shape[-1]
    _check_upwind_geometry("upwind_select", nf, lo, hi, is_dir, is_neu)
    bq, (pq,), (sq,) = _rows("upwind_select", nf, q=q)
    bw, (pw,), (sw,) = _rows("upwind_select", nc, w=w)
    if bq and bw and bq != bw:
        raise ValueError("upwind_select: q and w differ in batch size")
    batch = bq or bw
    out = torch.empty((batch, nf) if batch else (nf,), dtype=torch.float64, device=q.device)
    if nf:
        _launch(
            "upwind_select", torch.float64,
            pq, pw, sq, sw, lo.data_ptr(), hi.data_ptr(), is_dir.data_ptr(),
            is_neu.data_ptr(), out.data_ptr(), nf, max(batch, 1),
        )
    return out


def upwind_select_pair(s, a, b):
    """``a`` where ``s >= 0`` else ``b``; each ``(n,)`` or ``(B, n)``, a
    ``None`` candidate reads 0. Counts under ``upwind_select``."""
    if not s.is_cuda:
        return reference.upwind_select_pair(s, a, b)
    if a is None and b is None:
        raise ValueError("upwind_select_pair: needs at least one candidate")
    n = s.shape[-1]
    batch, ptrs, strides = _rows("upwind_select_pair", n, s=s, a=a, b=b)
    out = torch.empty((batch, n) if batch else (n,), dtype=torch.float64, device=s.device)
    if n:
        _launch(
            "upwind_select_pair", torch.float64,
            *ptrs, *strides, out.data_ptr(), n, max(batch, 1), count_as="upwind_select",
        )
    return out


# -- K14 --------------------------------------------------------------------------


def segment_sum_sorted(x, ptr, idx, num):
    """Segment sums of ``x`` (last axis) in fixed order (see
    :func:`porepy_tpu_torch.kernels.reference.segment_sum_sorted`): ``x``
    ``(n,)`` or ``(B, n)`` float64, ``ptr`` ``(num + 1,)`` and the optional
    item list ``idx`` ``(n,)`` int32."""
    if not x.is_cuda:
        return reference.segment_sum_sorted(x, ptr, idx, num)
    n = x.shape[-1]
    if ptr.dtype != torch.int32 or ptr.shape != (num + 1,):
        raise TypeError("segment_sum_sorted: ptr must be int32 of shape (num + 1,)")
    tensors = {"ptr": ptr}
    if idx is not None:
        if idx.dtype != torch.int32 or idx.shape != (n,):
            raise TypeError("segment_sum_sorted: idx must be int32 of shape (n,)")
        tensors["idx"] = idx
    _check("segment_sum_sorted", tensors, torch.float64)
    batch, (px,), (sx,) = _rows("segment_sum_sorted", n, x=x)
    out = torch.empty((batch, num) if batch else (num,), dtype=torch.float64, device=x.device)
    if num:
        _launch(
            "segment_sum_sorted", torch.float64,
            px, sx, ptr.data_ptr(), None if idx is None else idx.data_ptr(),
            out.data_ptr(), num, max(batch, 1),
        )
    return out


class TpfaAdGeometry:
    """The constant arrays of one subdomain that the K14 flux and trace
    kernels read, on one device: ``face_ptr`` ``(nf + 1,)``, ``face_hf``,
    ``ci`` ``(nhf,)`` int32, ``sgn`` ``(nhf,)``, ``nrm``, ``dvec`` ``(3, nhf)``
    float64 (outward area-weighted normal and face-minus-cell-center vector
    per half-face) and the bool face masks ``is_dir``, ``is_neu``
    (effective) and ``is_dir_raw``, ``is_neu_raw``. The constructor derives
    ``boundary_faces``, the int32 list of the faces where ``is_dir_raw |
    is_neu_raw`` (ascending), over which the trace kernel runs."""

    FIELDS = (
        "face_ptr", "face_hf", "ci", "sgn", "nrm", "dvec",
        "is_dir", "is_neu", "is_dir_raw", "is_neu_raw",
    )
    #: What :meth:`tensors` gives out and :meth:`trusted` takes back.
    TENSORS = FIELDS + ("boundary_faces",)
    _DTYPES = (torch.int32,) * 3 + (torch.float64,) * 3 + (torch.bool,) * 4

    def __init__(self, **arrays) -> None:
        self.arrays = {}
        for name, dtype in zip(self.FIELDS, self._DTYPES):
            t = arrays[name]
            if t.dtype != dtype:
                raise TypeError(f"TpfaAdGeometry: {name} must be {dtype}")
            self.arrays[name] = t.contiguous()
        self.num_faces = self.arrays["face_ptr"].shape[0] - 1
        self.num_half_faces = self.arrays["ci"].shape[0]
        nf, nhf = self.num_faces, self.num_half_faces
        shapes = ((nf + 1,), (nhf,), (nhf,), (nhf,), (3, nhf), (3, nhf)) + ((nf,),) * 4
        for name, shape in zip(self.FIELDS, shapes):
            if tuple(self.arrays[name].shape) != shape:
                raise ValueError(f"TpfaAdGeometry: {name} must have shape {shape}")
        listed = self.arrays["is_dir_raw"] | self.arrays["is_neu_raw"]
        self.arrays["boundary_faces"] = torch.nonzero(listed).reshape(-1).to(torch.int32)
        self._launchers = {}

    @classmethod
    def trusted(cls, tensors) -> "TpfaAdGeometry":
        """A geometry over ``tensors`` (in ``TENSORS`` order) that a checked
        instance gave out through :meth:`tensors`; nothing is checked again."""
        self = cls.__new__(cls)
        self.arrays = dict(zip(cls.TENSORS, tensors))
        self.num_faces = tensors[0].shape[0] - 1
        self.num_half_faces = tensors[2].shape[0]
        self._launchers = {}
        return self

    def tensors(self) -> tuple:
        """The arrays in ``TENSORS`` order."""
        return tuple(self.arrays[name] for name in self.TENSORS)

    def __getitem__(self, name):
        return self.arrays[name]

    @property
    def device(self):
        return self.arrays["sgn"].device

    def launcher(self, trace: bool) -> "TpfaAdLauncher":
        """This geometry's :class:`TpfaAdLauncher` of the flux or of the
        trace, made at the first call."""
        hit = self._launchers.get(trace)
        if hit is None:
            hit = self._launchers[trace] = TpfaAdLauncher(self, trace)
        return hit


# The launch table's words (csrc/tpfa_ad.cu, Word): sizes, geometry,
# fields, seeds, seed row strides, output.
_TPFA_HEAD = 13  # kNf .. kList
_TPFA_CALL = 16  # kK9 .. kOut
_TPFA_GEOMETRY = ("face_ptr", "face_hf", "ci", "sgn", "nrm", "dvec")
_TPFA_PRIMALS = ("k9", "vol", "p", "bco", "lam")
_TPFA_SEEDS = ("dk9", "dvol", "dp", "dbco", "dlam")


class TpfaAdLauncher:
    """K14's flux (``trace=False``) or trace of one subdomain, made once per
    :class:`TpfaAdGeometry` and kind (``geom.launcher(trace)``):
    ``launcher(primals, seeds=None)`` returns ``(value (nf,), tangents (B,
    nf) or None)`` of the function at the five ``primals`` ``(k9 (9 nc,), vol,
    p (nc,), bco, lam (nf,))`` for the five ``seeds``, each ``(B, n)`` with
    unit-strided rows or ``None`` (zero; all ``None``: the value alone), as
    :func:`porepy_tpu_torch.kernels.reference.tpfa_ad_dual` computes them.

    On the card it is one launch of ``tpfa_ad_dual`` (``csrc/tpfa_ad.cu``),
    value and tangents as rows 0 and ``1 ..`` of one ``(1 + B, nf)`` buffer.
    The geometry is checked and its pointers written into the launch table
    (int64 words the C entry reads) once, at the first call on the card; a
    call checks the fields and seeds, allocates the buffer, writes their
    pointers and makes one ctypes call. On the CPU the plain version runs;
    on a CUDA tensor the kernel launches or the call raises. Counts under
    ``tpfa_ad_flux`` or ``tpfa_ad_trace``."""

    __slots__ = ("geom", "trace", "name", "_fn", "_dev", "_table")

    def __init__(self, geom: TpfaAdGeometry, trace: bool) -> None:
        self.geom, self.trace = geom, bool(trace)
        self.name = "tpfa_ad_trace" if trace else "tpfa_ad_flux"
        self._fn = None
        self._dev = None

    def _bind(self) -> None:
        geom, name = self.geom, self.name
        masks = ("is_dir_raw", "is_neu_raw") if self.trace else ("is_dir", "is_neu")
        arrays = {k: geom[k] for k in (*_TPFA_GEOMETRY, *masks, "boundary_faces")}
        _check(name, arrays, torch.float64)
        if len({t.device for t in arrays.values()}) != 1:
            raise ValueError(f"{name}: the geometry's arrays lie on more than one card")
        words = _kernel("tpfa_ad_dual_words", torch.float64)()
        if words != _TPFA_HEAD + _TPFA_CALL:
            raise RuntimeError(f"{name}: the kernel's launch table has {words} words, expected "
                               f"{_TPFA_HEAD + _TPFA_CALL}")
        table = (ctypes.c_longlong * words)()
        nf = geom.num_faces
        table[:_TPFA_HEAD] = [
            nf, geom.num_half_faces, geom["boundary_faces"].shape[0], 0,
            *(t.data_ptr() for t in arrays.values()),
        ]
        self._table = table
        self._dev = geom["sgn"].get_device()
        self._fn = _kernel("tpfa_ad_dual", torch.float64)

    def __call__(self, primals, seeds=None):
        if not primals[1].is_cuda:
            return reference.tpfa_ad_dual(self.geom, primals, seeds, self.trace)
        return self._cuda(primals, seeds)

    def _cuda(self, primals, seeds):
        if self._fn is None:
            self._bind()
        name, dev, nf = self.name, self._dev, self.geom.num_faces
        f64 = torch.float64
        nc = primals[1].shape[0] if primals[1].dim() == 1 else -1
        sizes = (9 * nc, nc, nc, nf, nf)
        ptrs = []
        for arg, t, n in zip(_TPFA_PRIMALS, primals, sizes):
            if t.dtype is not f64 or t.shape != (n,):
                raise ValueError(f"{name}: {arg} must be float64 of shape ({n},)")
            if t.get_device() != dev:
                raise ValueError(f"{name}: {arg} is on {t.device}, the geometry on card {dev}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: {arg} must be contiguous")
            ptrs.append(t.data_ptr())
        batch = 0
        s_ptrs, s_strides = [0] * 5, [0] * 5
        if seeds is not None:
            for i, (arg, t, n) in enumerate(zip(_TPFA_SEEDS, seeds, sizes)):
                if t is None:
                    continue
                shape, stride = t.shape, t.stride()
                if t.dtype is not f64 or len(shape) != 2 or shape[1] != n:
                    raise ValueError(f"{name}: {arg} must be float64 of shape (B, {n})")
                if t.get_device() != dev:
                    raise ValueError(f"{name}: {arg} is on {t.device}, the geometry on card {dev}")
                if n > 1 and stride[1] != 1:
                    raise ValueError(f"{name}: {arg} needs unit-stride rows")
                if batch and shape[0] != batch:
                    raise ValueError(f"{name}: seeds differ in batch size")
                batch = shape[0]
                s_ptrs[i] = t.data_ptr()
                s_strides[i] = stride[0]
        buf = primals[1].new_empty((1 + batch, nf))
        if nf:
            table = self._table
            table[3] = batch
            struct.pack_into("16q", table, 8 * _TPFA_HEAD, *ptrs, *s_ptrs, *s_strides, buf.data_ptr())
            rc = self._fn(table, self.trace, _current_stream(dev))
            if rc != 0:
                raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")
            LAUNCHES[name] += 1
        return buf[0], (buf[1:] if batch else None)


def tpfa_ad_dual(geom: TpfaAdGeometry, primals, seeds=None, trace: bool = False):
    """``(value (nf,), tangents (B, nf) or None)`` of the flux (or, with
    ``trace``, the boundary pressure trace) of one subdomain at the five
    ``primals`` for the five ``seeds`` (each ``(B, n)`` or ``None``), in one
    launch of the geometry's :class:`TpfaAdLauncher` on the card (see
    :func:`porepy_tpu_torch.kernels.reference.tpfa_ad_dual`)."""
    return geom.launcher(trace)(primals, seeds)


def tpfa_ad_flux(geom: TpfaAdGeometry, k9, vol, p, bco, lam):
    """The differentiable TPFA face flux of one subdomain (see
    :func:`porepy_tpu_torch.kernels.reference.tpfa_ad_flux`): ``k9``
    ``(9 nc,)`` cell-major, ``vol``, ``p`` ``(nc,)``, ``bco``, ``lam``
    ``(nf,)``, float64; the value row of :func:`tpfa_ad_dual`."""
    return tpfa_ad_dual(geom, (k9, vol, p, bco, lam))[0]


def tpfa_ad_flux_tangent(geom: TpfaAdGeometry, primals, seeds):
    """Tangents ``(B, nf)`` of :func:`tpfa_ad_flux` at the five ``primals``
    for the five ``seeds``, each ``(B, n)`` or ``None`` (zero): the tangent
    rows of :func:`tpfa_ad_dual` (counted under ``tpfa_ad_flux``)."""
    if not primals[1].is_cuda:
        return reference.tpfa_ad_tangent(reference.tpfa_ad_flux, geom, primals, seeds)
    return _tangent_rows("tpfa_ad_flux", geom, primals, seeds, False)


def tpfa_ad_trace(geom: TpfaAdGeometry, k9, vol, p, bco, lam):
    """The boundary pressure trace of one subdomain (see
    :func:`porepy_tpu_torch.kernels.reference.tpfa_ad_trace`)."""
    return tpfa_ad_dual(geom, (k9, vol, p, bco, lam), trace=True)[0]


def tpfa_ad_trace_tangent(geom: TpfaAdGeometry, primals, seeds):
    """Tangents ``(B, nf)`` of :func:`tpfa_ad_trace`, as
    :func:`tpfa_ad_flux_tangent`."""
    if not primals[1].is_cuda:
        return reference.tpfa_ad_tangent(reference.tpfa_ad_trace, geom, primals, seeds)
    return _tangent_rows("tpfa_ad_trace", geom, primals, seeds, True)


def _tangent_rows(name, geom, primals, seeds, trace):
    if all(s is None for s in seeds):
        raise ValueError(f"{name}: needs at least one seed")
    return tpfa_ad_dual(geom, tuple(primals), tuple(seeds), trace)[1]


# -- K8 ---------------------------------------------------------------------------

_JOINT = 8  # equations per jac_gather launch
_COPY_PIECES = 32  # duals per dual_gather_copy launch
_DUAL_BINARY = ("add", "sub", "mul", "div", "pow", "gt", "ge", "leabs")
_DUAL_CONST = ("loadi", "sign", "gt", "ge", "leabs", "detach")
# Unary opcodes whose tangent divides by their derivative factor (as
# reference.dual_ew's table says); the others multiply by it.
_DUAL_DIVIDE = ("log", "arcsin", "arccos", "arctan", "arcsinh", "arccosh", "arctanh", "sqrt")
# The tape's entries, in the numbering of csrc/dual_ad.cu (TapeOp).
(_T_LOAD, _T_MUL1, _T_DIV1, _T_MUL2, _T_DIVB, _T_DIV2, _T_NEG, _T_ADD, _T_SUB,
 _T_SEL) = range(10)


class DualTape:
    """A :class:`DualProgram` lowered for one pattern of constant inputs,
    as the ``dual_ew`` kernel runs it.

    ``values``: one record ``(opcode, a, b, c, p0, p1)`` an instruction, with
    the registers renumbered (inputs ``0 .. n_inputs - 1``, instruction ``j``
    at ``n_inputs + j``; ``loadi`` keeps ``a``, the constant's index) and
    ``p0, p1`` the partials the instruction leaves (indices into the
    ``n_part`` partials of an element, -1 for none): ``mul`` leaves ``vb``
    and ``va``, ``div`` ``vb`` and its result, ``pow`` its two derivative
    factors, a unary opcode its factor, ``select`` the 0/1 choice and
    ``custom`` ``vb``, each only where the tangent needs it.

    ``tape``: the entries ``(kind, dst, x, y, p0, p1)`` of the tangent pass on
    slots, its ``n_load`` loads first: ``load`` (input ``x``'s tangent row
    into ``dst``), ``x * P0``,
    ``x / P0``, ``x * P0 + y * P1``, ``-(y * P1) / P0``, ``(x - y * P1) /
    P0``, ``-x``, ``x + y``, ``x - y`` and ``P0 != 0 ? x : y`` (a slot ``< 0``
    reads 0); a tangent that only copies another (``add``, ``sub`` with a
    constant operand) is that slot, and a tangent no output needs is not
    computed. Slots are given by liveness: ``n_slot`` is the most tangents
    alive at once, at most ``n_inputs + n_instr``; ``out_slot`` holds the
    output's. ``out_const``: the output has no tangent (no tape)."""

    __slots__ = ("values", "tape", "n_load", "n_part", "n_slot", "out_slot", "out_const")

    def __init__(self, program: "DualProgram", const_inputs: tuple) -> None:
        n_in, n_max = program.n_inputs, reference.DUAL_MAX_INPUTS
        const = list(const_inputs) + [True] * (n_max - n_in)
        ids: dict = {k: ("in", k) for k in range(n_in) if not const[k]}  # register -> tangent
        entries = []  # (kind, dst id, x id, y id, partial key, partial key)
        for j, (code, a, b, c) in enumerate(program.instrs):
            name = reference.DUAL_OPCODES[code]
            r, dst = n_max + j, ("r", j)
            p0, p1 = (j, 0), (j, 1)
            entry = None
            if name in _DUAL_CONST:
                pass
            elif name == "select":
                if not (const[b] and const[c]):
                    entry = (_T_SEL, dst, ids.get(b), ids.get(c), p0, None)
            elif name == "custom":
                if not const[c]:
                    entry = (_T_MUL1, dst, ids[c], None, p0, None)
            elif name in _DUAL_BINARY:
                ca, cb = const[a], const[b]
                if ca and cb:
                    pass
                elif name in ("add", "sub") and (ca or cb):
                    if cb:
                        ids[r] = ids[a]  # the tangent of a, unchanged
                    elif name == "add":
                        ids[r] = ids[b]
                    else:
                        entry = (_T_NEG, dst, ids[b], None, None, None)
                elif name in ("add", "sub"):
                    entry = (_T_ADD if name == "add" else _T_SUB, dst, ids[a], ids[b], None, None)
                elif name in ("mul", "pow"):
                    # mul leaves (vb, va), pow (its factor in a, its factor in b).
                    if cb:
                        entry = (_T_MUL1, dst, ids[a], None, p0, None)
                    elif ca:
                        entry = (_T_MUL1, dst, ids[b], None, p1, None)
                    else:
                        entry = (_T_MUL2, dst, ids[a], ids[b], p0, p1)
                else:  # div leaves (vb, result)
                    if cb:
                        entry = (_T_DIV1, dst, ids[a], None, p0, None)
                    elif ca:
                        entry = (_T_DIVB, dst, None, ids[b], p0, p1)
                    else:
                        entry = (_T_DIV2, dst, ids[a], ids[b], p0, p1)
            elif not const[a]:
                if name == "neg":
                    entry = (_T_NEG, dst, ids[a], None, None, None)
                else:
                    kind = _T_DIV1 if name in _DUAL_DIVIDE else _T_MUL1
                    entry = (kind, dst, ids[a], None, p0, None)
            if entry is not None:
                ids[r] = dst
                entries.append(entry)
            const.append(r not in ids)
        out = ids.get(n_max + len(program.instrs) - 1)
        self.out_const = out is None

        # Keep what the output needs, and load each input's row before its
        # first use.
        needed = {out} if out is not None else set()
        kept = []
        for entry in reversed(entries):
            if entry[1] in needed:
                needed.update(t for t in entry[2:4] if t is not None)
                kept.append(entry)
        kept.reverse()
        loads = []
        for entry in kept + [(None, None, out, None, None, None)]:
            for t in entry[2:4]:
                if t is not None and t[0] == "in" and t not in loads:
                    loads.append(t)
        # The loads first: the kernel issues them before the value pass, so
        # that their latency hides behind it.
        tape = [(_T_LOAD, t, t, None, None, None) for t in loads] + kept
        self.n_load = len(loads)

        # Slots by liveness: an operand's slot is free once its last reader
        # has read it (the reader's own result may take it).
        last = {out: len(tape)} if out is not None else {}
        for q, entry in enumerate(tape):
            if entry[0] != _T_LOAD:
                for t in entry[2:4]:
                    if t is not None:
                        last[t] = max(last.get(t, -1), q)
        slot_of: dict = {}
        free: list = []
        n_slot = 0
        for q, entry in enumerate(tape):
            if entry[0] != _T_LOAD:
                for t in {t for t in entry[2:4] if t is not None}:
                    if last[t] == q:
                        free.append(slot_of[t])
            if free:
                free.sort()
                slot_of[entry[1]] = free.pop(0)
            else:
                slot_of[entry[1]] = n_slot
                n_slot += 1
        self.n_slot = n_slot
        self.out_slot = slot_of.get(out, 0)

        partial: dict = {}
        for entry in tape:
            for key in entry[4:6]:
                if key is not None and key not in partial:
                    partial[key] = len(partial)
        self.n_part = len(partial)
        values = []
        for j, (code, a, b, c) in enumerate(program.instrs):
            if reference.DUAL_OPCODES[code] == "loadi":
                regs = (a, 0, 0)
            else:
                regs = tuple(r if r < n_max else n_in + r - n_max for r in (a, b, c))
            values.append((code,) + regs + (partial.get((j, 0), -1), partial.get((j, 1), -1)))
        self.values = tuple(values)
        self.tape = tuple(
            (
                kind,
                slot_of[dst],
                x[1] if kind == _T_LOAD else (-1 if x is None else slot_of[x]),
                -1 if y is None else slot_of[y],
                -1 if k0 is None else partial[k0],
                -1 if k1 is None else partial[k1],
            )
            for kind, dst, x, y, k0, k1 in tape
        )

    def code(self) -> list:
        """The int32 words the kernel reads: the value records, six ints
        each, then the tape's entries, two words each (``kind | dst << 4 |
        (x + 1) << 10 | (y + 1) << 17`` and ``(p0 + 1) | (p1 + 1) << 8``)."""
        words = [v for rec in self.values for v in rec]
        for kind, dst, x, y, p0, p1 in self.tape:
            words += [kind | dst << 4 | (x + 1) << 10 | (y + 1) << 17, (p0 + 1) | (p1 + 1) << 8]
        return words


class DualProgram:
    """A checked elementwise program for :func:`dual_ew`: ``instrs`` is a
    list of ``(opcode, a, b, c)`` (see
    :data:`porepy_tpu_torch.kernels.reference.DUAL_OPCODES`; opcode by name
    or number), ``imm`` the constants that ``loadi`` reads, ``n_inputs`` the
    number of input registers. Everything the kernel relies on is checked
    here, once; :meth:`tape` lowers it once a pattern of constant inputs."""

    def __init__(self, instrs, imm, n_inputs: int) -> None:
        n_max, i_max = reference.DUAL_MAX_INPUTS, reference.DUAL_MAX_INSTRS
        if not 1 <= n_inputs <= n_max:
            raise ValueError(f"DualProgram: {n_inputs} inputs outside 1..{n_max}")
        if not 1 <= len(instrs) <= i_max:
            raise ValueError(f"DualProgram: {len(instrs)} instructions outside 1..{i_max}")
        self.imm = tuple(float(v) for v in imm)
        checked = []
        for j, (op, a, b, c) in enumerate(instrs):
            code = reference.DUAL_OP[op] if isinstance(op, str) else int(op)
            name = reference.DUAL_OPCODES[code]
            if name == "loadi":
                if not 0 <= a < len(self.imm):
                    raise ValueError(f"DualProgram: instruction {j} reads imm[{a}]")
                checked.append((code, int(a), 0, 0))
                continue
            arity = 3 if name in ("select", "custom") else 2 if name in _DUAL_BINARY else 1
            regs = (a, b, c)[:arity]
            for r in regs:
                if not (0 <= r < n_inputs or n_max <= r < n_max + j):
                    raise ValueError(f"DualProgram: instruction {j} reads register {r}")
            checked.append((code,) + tuple(int(r) for r in regs) + (0,) * (3 - arity))
        self.instrs = tuple(checked)
        self.n_inputs = n_inputs
        self._tapes: dict = {}
        self._launcher = None

    def tape(self, const_inputs: tuple) -> DualTape:
        """The :class:`DualTape` for the inputs flagged constant in
        ``const_inputs``, lowered at the first call."""
        hit = self._tapes.get(const_inputs)
        if hit is None:
            hit = self._tapes[const_inputs] = DualTape(self, const_inputs)
        return hit

    def out_const(self, const_inputs: tuple) -> bool:
        """Whether the output is a constant when the inputs flagged in
        ``const_inputs`` are."""
        return self.tape(const_inputs).out_const

    def launcher(self) -> "DualEwLauncher":
        """This program's own :class:`DualEwLauncher`, made at the first call."""
        if self._launcher is None:
            self._launcher = DualEwLauncher(self)
        return self._launcher


class DualEwLauncher:
    """K8's ``dual_ew`` for one :class:`DualProgram`, made once per step of
    the dual pass (and once for each fixed program): ``launch(inputs,
    batch)`` returns ``(val, tan)`` of the program on the duals ``inputs``, a
    list of ``(val, tan)`` (see
    :func:`porepy_tpu_torch.kernels.reference.dual_ew`); on the card value
    and tangent rows are views of one ``(batch + 1, n)`` buffer, row 0 the
    value.

    The lowering (:meth:`DualProgram.tape`) and its code are made once a
    pattern of constant inputs, the launch table (one int64 array the
    kernel's C entry reads: the program's sizes, code and constants, the
    output, the operands' pointers and strides) once; a call
    checks the operands, allocates the output, writes the pointers (the
    strides and sizes only when they change) and makes one ctypes call of two
    arguments. On the CPU the plain version runs; on a CUDA tensor the kernel
    launches or the call raises. Counts under ``dual_ew``."""

    __slots__ = (
        "program", "_n_in", "_dev", "_fn", "_table", "_fmt", "_head", "_stride_key", "_states",
        "_all_const",
    )

    # The launch table: 10 header words (n_in, n_instr, n_tape, n_load, n_imm,
    # n_part, n_slot, out_slot, and the host addresses of the code and the
    # constants), 5 call words (out_v, out_t, out_rs, n, batch), n_in value
    # and n_in tangent pointers, n_in element and n_in row strides
    # (csrc/dual_ad.cu, ppt_dual_ew_f64).
    _HEAD, _CALL = 10, 5

    def __init__(self, program: DualProgram) -> None:
        self.program = program
        self._n_in = program.n_inputs
        self._dev = None
        self._all_const = (True,) * program.n_inputs

    def _bind(self, dev: int) -> None:
        n_in = self._n_in
        self._fn = _kernel("dual_ew", torch.float64)
        self._dev = dev
        self._table = (ctypes.c_longlong * (self._HEAD + self._CALL + 4 * n_in))()
        self._fmt = f"{self._CALL + 2 * n_in}q"
        self._head = None
        self._stride_key = None
        self._states = {}

    def _state(self, pattern: tuple) -> tuple:
        """``(tape, header words, code, constants)`` of ``pattern``: the code
        and constants are host arrays that the C entry copies into the
        kernel's parameters at every launch."""
        hit = self._states.get(pattern)
        if hit is None:
            program = self.program
            tape = program.tape(pattern)
            words = tape.code()
            code = (ctypes.c_int * len(words))(*words)
            imm = (ctypes.c_double * max(len(program.imm), 1))(*program.imm)
            head = (
                self._n_in, len(program.instrs), len(tape.tape), tape.n_load, len(program.imm),
                tape.n_part, tape.n_slot, tape.out_slot, ctypes.addressof(code),
                ctypes.addressof(imm),
            )
            hit = self._states[pattern] = (tape, head, code, imm)
        return hit

    def __call__(self, inputs, batch: int):
        ref = inputs[0][0]
        if not ref.is_cuda:
            program = self.program
            return reference.dual_ew(program.instrs, program.imm, inputs, batch)
        n_in = self._n_in
        if len(inputs) != n_in:
            raise ValueError(f"dual_ew: {len(inputs)} inputs for a program of {n_in}")
        dev = ref.get_device()
        if dev != self._dev:
            self._bind(dev)
        f64 = torch.float64
        n, one_d = -1, False
        vals, tans, strides, keep = [], [], [], []
        for val, tan in inputs:
            if val.dtype != f64 or val.get_device() != dev:
                raise TypeError("dual_ew: values must be float64 tensors on the launcher's card")
            dim = val.dim()
            length = val.numel()
            if dim == 1:
                one_d = True
                if length != 1:
                    if n not in (-1, length):
                        raise ValueError(f"dual_ew: operands of {n} and {length} elements")
                    n = length
            elif dim:
                raise ValueError(f"dual_ew: value of shape {tuple(val.shape)}")
            es = val.stride(0) if length > 1 else 0
            vals.append(val.data_ptr())
            if tan is None or not batch:
                tans.append(0)
                strides.append((es, 0))
                continue
            if (tan.dtype != f64 or tan.get_device() != dev
                    or tan.shape != (batch, length if dim else 1)):
                raise ValueError(
                    f"dual_ew: tangent of shape {tuple(tan.shape)}, expected "
                    f"({batch}, {length if dim else 1}) float64 on the launcher's card"
                )
            ts = tan.stride()
            if length > 1 and ts[1] != es:
                if es != 1:
                    raise ValueError("dual_ew: value and tangent rows differ in element stride")
                tan = tan.contiguous()
                keep.append(tan)
                ts = tan.stride()
            tans.append(tan.data_ptr())
            strides.append((es, ts[0]))
        shape = (n,) if n >= 0 else ((1,) if one_d else ())
        n = 1 if n < 0 else n
        pattern = tuple(p == 0 for p in tans) if batch else self._all_const
        tape, head, _code, _imm = self._state(pattern)
        if tape.out_const or not batch:
            out_v, out_t = ref.new_empty(n), None
            out_ptrs = (out_v.data_ptr(), 0, n, n, 0)
        else:
            buf = ref.new_empty((batch + 1, n))
            out_v, out_t = buf[0], buf[1:]
            ptr = buf.data_ptr()
            out_ptrs = (ptr, ptr + 8 * n, n, n, batch)
        if n:
            table = self._table
            if head is not self._head:
                table[: self._HEAD] = head
                self._head = head
            if strides != self._stride_key:
                base = self._HEAD + self._CALL + 2 * n_in
                table[base : base + 2 * n_in] = [e for e, _r in strides] + [r for _e, r in strides]
                self._stride_key = strides
            struct.pack_into(self._fmt, table, 8 * self._HEAD, *out_ptrs, *vals, *tans)
            rc = self._fn(table, _current_stream(dev))
            if rc != 0:
                raise RuntimeError(f"dual_ew kernel launch failed with CUDA error {rc}")
            LAUNCHES["dual_ew"] += 1
        return (out_v if shape == (n,) else out_v.reshape(shape)), out_t


def _host_table(ctype, values):
    return (ctype * len(values))(*values)


def _dual_rows(name, val, tan, batch, n):
    """``(val_ptr, tan_ptr, element stride, row stride, tan)`` of one dual
    operand of a K8 kernel over ``n`` elements; ``tan`` is returned because a
    copy made here must outlive the launch."""
    if val.dtype != torch.float64 or not val.is_cuda:
        raise TypeError(f"{name}: values must be float64 CUDA tensors")
    length = val.numel()
    if val.dim() > 1 or (length != n and length != 1):
        raise ValueError(f"{name}: value of shape {tuple(val.shape)} against {n} elements")
    es = val.stride(0) if (length > 1 and n > 1) else 0
    if tan is None or not batch:
        return val.data_ptr(), None, es, 0, None
    width = length if val.dim() else 1
    if tan.dtype != torch.float64 or not tan.is_cuda or tan.shape != (batch, width):
        raise ValueError(
            f"{name}: tangent of shape {tuple(tan.shape)}, expected ({batch}, {width})"
        )
    if length > 1 and n > 1 and tan.stride(1) != es:
        tan = tan.contiguous()
        if es != 1:
            raise ValueError(f"{name}: value and tangent rows differ in element stride")
    return val.data_ptr(), tan.data_ptr(), es, tan.stride(0), tan


def dual_ew(program: DualProgram, inputs, batch: int):
    """``(val, tan)`` of the elementwise ``program`` on the duals ``inputs``,
    a list of ``(val, tan)`` (see
    :func:`porepy_tpu_torch.kernels.reference.dual_ew`): the functional form
    of :class:`DualEwLauncher`, through the program's own launcher."""
    return program.launcher()(inputs, batch)


class DualGatherVar:
    """K8's gather of the unknowns ``x[idx]`` under one-hot seeds by color
    for one step of the dual pass (see
    :func:`porepy_tpu_torch.kernels.reference.dual_gather_var`):
    ``gather(x, colors, batch)`` returns ``(val, tan)``, views of a ``(batch +
    1, n)`` buffer that the launcher keeps per color set (the ``colors``
    tensor, its version and ``batch``; the last two sets seen). The tangent
    rows depend on ``idx`` and the colors alone: they are written when a set
    is first seen (the ``dual_seed_rows`` kernel; :attr:`seed_writes` counts
    it), and a call writes the value row alone (``dual_gather_value``). The
    next call with the same set overwrites that row, so a result kept past
    it is copied first (:meth:`holds` tells whether a tensor is a view of a
    buffer here). ``idx`` (1-d int64) is checked once, here; a call checks
    ``x``. On the CPU the plain versions fill the same buffers. Both kernels
    count under ``dual_gather``."""

    __slots__ = ("idx", "n", "seed_writes", "_sets", "_dev", "_idx_ptr", "_value", "_seed")
    _KEEP = 2

    def __init__(self, idx: torch.Tensor) -> None:
        if idx.dtype != torch.int64 or idx.dim() != 1:
            raise TypeError("dual_gather_var: needs a 1-d int64 idx")
        self.idx, self.n = idx, idx.shape[0]
        self.seed_writes = 0
        self._sets: dict = {}
        self._dev = None
        if idx.is_cuda:
            _check("dual_gather_var", {"idx": idx}, torch.float64)
            self._dev, self._idx_ptr = idx.get_device(), idx.data_ptr()
            self._value = _kernel("dual_gather_value", torch.float64)
            self._seed = _kernel("dual_seed_rows", torch.float64)

    def _color_set(self, colors, batch: int, x: torch.Tensor) -> tuple:
        key = (id(colors), batch)
        version = None if colors is None else colors._version
        hit = self._sets.get(key)
        if hit is not None and hit[0] is colors and hit[1] == version:
            return hit[2]
        if batch:
            if colors.dtype != torch.int32 or colors.shape != x.shape:
                raise TypeError("dual_gather_var: colors must be int32 of x's shape")
            if colors.is_cuda != x.is_cuda or (x.is_cuda and (
                colors.get_device() != self._dev or not colors.is_contiguous()
            )):
                raise ValueError("dual_gather_var: colors must be contiguous, on x's device")
        buf = torch.empty((batch + 1, self.n), dtype=torch.float64, device=self.idx.device)
        if batch:
            if self._dev is None:
                buf[1:] = reference.dual_seed_rows(self.idx, colors, batch)
            elif self.n:
                rc = self._seed(self._idx_ptr, colors.data_ptr(), buf[1].data_ptr(), self.n, batch,
                                _current_stream(self._dev))
                if rc != 0:
                    raise RuntimeError(f"dual_seed_rows kernel launch failed with CUDA error {rc}")
                LAUNCHES["dual_gather"] += 1
            self.seed_writes += 1
        out = (buf[0], buf[1:] if batch else None)
        self._sets.pop(key, None)
        if len(self._sets) >= self._KEEP:
            self._sets.pop(next(iter(self._sets)))
        self._sets[key] = (colors, version, out, buf)
        return out

    def __call__(self, x: torch.Tensor, colors=None, batch: int = 0) -> tuple:
        if colors is None:
            batch = 0
        if x.dtype != torch.float64 or x.dim() != 1:
            raise TypeError("dual_gather_var: needs a float64 x of shape (ndof,)")
        if x.is_cuda != (self._dev is not None) or (
            x.is_cuda and (x.get_device() != self._dev or not x.is_contiguous())
        ):
            raise ValueError(f"dual_gather_var: x is on {x.device}, idx on {self.idx.device}")
        val, tan = self._color_set(colors, batch, x)
        if self._dev is None:
            val.copy_(reference.dual_gather_var(x, self.idx, None, 0)[0])
        elif self.n:
            rc = self._value(x.data_ptr(), self._idx_ptr, val.data_ptr(), self.n,
                             _current_stream(self._dev))
            if rc != 0:
                raise RuntimeError(f"dual_gather_value kernel launch failed with CUDA error {rc}")
            LAUNCHES["dual_gather"] += 1
        return val, tan

    def holds(self, t: torch.Tensor) -> bool:
        """Whether ``t`` is a view of one of the buffers kept here."""
        ptr = t.untyped_storage().data_ptr()
        return any(entry[3].untyped_storage().data_ptr() == ptr for entry in self._sets.values())


def dual_gather_var(x, idx, colors, batch: int):
    """The dual of the unknowns ``x[idx]`` under one-hot seeds by color (see
    :func:`porepy_tpu_torch.kernels.reference.dual_gather_var`): ``idx``
    int64, ``colors`` int32 over all unknowns (not read, and may be ``None``,
    for ``batch == 0``). The functional form of :class:`DualGatherVar`: on
    the card a launcher made for the call (two launches), so ``(val, tan)``
    are views of a ``(batch + 1, n)`` buffer of their own."""
    if not x.is_cuda:
        return reference.dual_gather_var(x, idx, colors, batch)
    return DualGatherVar(idx)(x, colors if batch else None, batch)


class DualGatherCopy:
    """K8's concatenation of duals for one step of the dual pass (see
    :func:`porepy_tpu_torch.kernels.reference.dual_gather_copy`):
    ``copy(pieces, batch)`` returns ``(val, tan)``, views of a new ``(rows +
    1, n_out)`` buffer. The offsets, strides and ctypes tables are built
    when a layout of the pieces (their lengths and strides, which carry
    tangents, the rows) is first seen; a call checks the pieces, refreshes
    their pointers in the tables and launches, 32 pieces to a launch. On the
    CPU the plain version runs. Counts under ``dual_gather``."""

    __slots__ = ("_layout", "_chunks", "_n_out", "_dev", "_fn")

    def __init__(self) -> None:
        self._layout = None

    def _build(self, layout: tuple, dev: int) -> None:
        self._dev = dev
        self._fn = _kernel("dual_gather_copy", torch.float64)
        pieces = layout[1:]
        starts = [0]
        for n, _es, _rs in pieces:
            starts.append(starts[-1] + n)
        self._n_out = starts[-1]
        chunks = []
        for lo in range(0, len(pieces), _COPY_PIECES):
            chunk = pieces[lo : lo + _COPY_PIECES]
            count = len(chunk)
            if starts[lo + count] == starts[lo]:
                continue
            strides = _host_table(
                ctypes.c_longlong,
                [es for _n, es, _rs in chunk] + [rs for _n, _es, rs in chunk]
                + starts[lo : lo + count + 1],
            )
            chunks.append((lo, count, (ctypes.c_void_p * (2 * count))(), strides))
        self._chunks = chunks
        self._layout = layout

    def __call__(self, pieces, batch: int) -> tuple:
        ref = pieces[0][0]
        if not ref.is_cuda:
            return reference.dual_gather_copy(pieces, batch)
        dev = ref.get_device()
        rows = batch if any(t is not None for _v, t in pieces) else 0
        layout, ptrs, keep = [rows], [], []
        for val, tan in pieces:
            if val.dim() != 1 or val.get_device() != dev:
                raise ValueError("dual_gather_copy: values must be 1-d, on one card")
            n = val.shape[0]
            pv, pt, es, rs, kept = _dual_rows("dual_gather_copy", val, tan, rows, n)
            # A piece of one element is read at offset 0 whatever its stride.
            layout.append((n, es if n > 1 else 0, rs))
            ptrs.append((pv, pt))
            keep.append(kept)
        layout = tuple(layout)
        if layout != self._layout or dev != self._dev:
            self._build(layout, dev)
        buf = torch.empty((rows + 1, self._n_out), dtype=torch.float64, device=ref.device)
        for lo, count, table, strides in self._chunks:
            for k in range(count):
                table[k], table[count + k] = ptrs[lo + k]
            rc = self._fn(table, strides, count, buf.data_ptr(), self._n_out, rows,
                          _current_stream(dev))
            if rc != 0:
                raise RuntimeError(f"dual_gather_copy kernel launch failed with CUDA error {rc}")
            LAUNCHES["dual_gather"] += 1
        return buf[0], (buf[1:] if rows else None)


def dual_gather_copy(pieces, batch: int):
    """The concatenation of the duals ``pieces`` (see
    :func:`porepy_tpu_torch.kernels.reference.dual_gather_copy`); the
    functional form of :class:`DualGatherCopy`, a launcher made for the
    call. Counts under ``dual_gather``."""
    return DualGatherCopy()(pieces, batch)


def jac_gather(vals, tans, gather_color, gather_row, nnz_offsets, row_offsets):
    """``(data, rhs)``: the Jacobian nonzeros of all equations in the global
    nonzero order and the negated, concatenated residual (see
    :func:`porepy_tpu_torch.kernels.reference.jac_gather`), eight equations
    to a launch. ``gather_color``, ``gather_row`` int32 ``(nnz,)``; the
    offsets are host sequences."""
    ref = vals[0]
    if not ref.is_cuda:
        return reference.jac_gather(vals, tans, gather_color, gather_row, nnz_offsets, row_offsets)
    nnz, n_rows = nnz_offsets[-1], row_offsets[-1]
    if gather_color.dtype != torch.int32 or gather_row.dtype != torch.int32:
        raise TypeError("jac_gather: gather_color and gather_row must be int32")
    if gather_color.shape != (nnz,) or gather_row.shape != (nnz,):
        raise ValueError(f"jac_gather: gather_color and gather_row must have shape ({nnz},)")
    _check("jac_gather", {"gather_color": gather_color, "gather_row": gather_row}, torch.float64)
    data = torch.empty(nnz, dtype=torch.float64, device=ref.device)
    rhs = torch.empty(n_rows, dtype=torch.float64, device=ref.device)
    for lo in range(0, len(vals), _JOINT):
        hi = min(lo + _JOINT, len(vals))
        ptrs_v, ptrs_t, rs, keep = [], [], [], []
        for e in range(lo, hi):
            rows = row_offsets[e + 1] - row_offsets[e]
            val = vals[e]
            if val.shape != (rows,):
                raise ValueError(f"jac_gather: equation {e} has shape {tuple(val.shape)}, expected ({rows},)")
            val = val.contiguous()
            pv, pt, _es, r, kept = _dual_rows(
                "jac_gather", val, tans[e], 0 if tans[e] is None else tans[e].shape[0], rows
            )
            ptrs_v.append(pv)
            ptrs_t.append(pt)
            rs.append(r)
            keep.append((val, kept))
        _launch(
            "jac_gather", torch.float64,
            _host_table(ctypes.c_void_p, ptrs_v + ptrs_t),
            _host_table(
                ctypes.c_longlong,
                rs + list(nnz_offsets[lo : hi + 1]) + list(row_offsets[lo : hi + 1]),
            ),
            hi - lo, gather_color.data_ptr(), gather_row.data_ptr(),
            data.data_ptr(), rhs.data_ptr(),
        )
    return data, rhs
