"""K3 (``amg_vcycle``: one SA-AMG V-cycle a launch) and K2
(``jacobi_sweeps``: a Jacobi block's sweeps a launch) on the card, against
their plain versions and against the composition they replaced.

    python3 -m porepy_tpu_torch.applications.benchmarking.vcycle_check

The composition (:class:`Composition`) is the V-cycle as the port ran it
before: K1 launchers with ``r - A y`` and ``y + P z`` in their epilogue, one
one-sweep K2 launch a smoothing sweep and ``torch.matmul`` on the coarse
level, 19 launches an apply at md 1/128. It is the yardstick only; no path of
the package calls it.

The script prints what ``nvcc -Xptxas -v`` reports for ``amg_vcycle.cu``,
then, on every AMG hierarchy of md 1/128, md 1/256, 3d 32^3 and biot 1/64 at
their first Jacobians (:func:`check`) and on the Jacobi-block matrix of
tracer 1/64's (:func:`check_sweeps`; all with the AMG field split,
``dense_precond=False``), holds each launch against its plain version on the
card to the bit, in f32 and f64, the V-cycle against the composition (1e-5
of max |y| in f32, 1e-12 in f64), counts the launches of one apply, and
times kernel and composition in turns: device µs an apply by CUDA-graph
replay, host µs an apply, ms by CUDA events over back-to-back applies, the
plain version's ms and the bound (bytes). Needs a CUDA card and ``nvcc``;
exits non-zero when a launch and its plain version differ.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import tempfile

import torch

from porepy_tpu_torch import kernels
from porepy_tpu_torch.applications.benchmarking.timing import cuda_ms, graph_us, host_us
from porepy_tpu_torch.kernels import ops, reference

#: The card's memory rate and float32 peak outside the tensor cores
#: (NVIDIA's H100 SXM data sheet), for the bounds.
HBM_BYTES_PER_S = 3.35e12
PEAK_F32 = 67e12
#: Tolerance of the V-cycle against the composition, of max |y|: the
#: composition sums rows and the coarse product in other orders.
COMPOSITION_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
_LEVEL = ("A_val", "A_col", "P_val", "P_col", "R_val", "R_col", "sinv")


class Composition:
    """The V(``nu``, ``nu``) cycle of ``state`` composed from launches: K1
    (:class:`~porepy_tpu_torch.kernels.EllOperator`, the residual and the
    correction in its epilogue), one ``jacobi_sweeps`` launch a sweep (a
    :class:`~porepy_tpu_torch.kernels.JacobiSweeps` a level, ``s = 1``) and
    ``torch.matmul`` with the coarse inverse. Launchers are made once, here."""

    def __init__(self, state: dict, nu: int) -> None:
        self.state, self.nu = state, nu
        self.ops = kernels.EllOperators()
        self.sweeps = []
        for lv in state["levels"]:
            for m in "APR":
                self.ops(lv[m + "_val"], lv[m + "_col"])
            self.sweeps.append(kernels.JacobiSweeps(lv["A_val"], lv["A_col"], lv["sinv"]))

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return self._cycle(0, r)

    def _cycle(self, l: int, r: torch.Tensor) -> torch.Tensor:
        levels = self.state["levels"]
        if l == len(levels):
            return torch.matmul(self.state["coarse_inv"], r)
        lv, sweep, ops = levels[l], self.sweeps[l], self.ops
        y = lv["sinv"] * r
        for _ in range(self.nu - 1):
            y = sweep(r, 1, y)
        r_c = ops(lv["R_val"], lv["R_col"])(ops(lv["A_val"], lv["A_col"])(y, c=r, sign=-1))
        y = ops(lv["P_val"], lv["P_col"])(self._cycle(l + 1, r_c).contiguous(), c=y)
        for _ in range(self.nu):
            y = sweep(r, 1, y)
        return y


def state_as(state: dict, dtype: torch.dtype) -> dict:
    """A copy of the hierarchy state with its values in ``dtype``."""
    def cast(t):
        return t.to(dtype) if t.is_floating_point() else t

    return {
        "levels": [{k: cast(lv[k]) for k in _LEVEL} for lv in state["levels"]],
        "coarse_inv": cast(state["coarse_inv"]),
    }


def state_bytes(state: dict) -> int:
    """Bytes one V-cycle must move besides r and y: every level tensor and
    the coarse inverse, read once."""
    tensors = [lv[k] for lv in state["levels"] for k in _LEVEL] + [state["coarse_inv"]]
    return sum(t.numel() * t.element_size() for t in tensors)


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"vcycle_check failed: {what}")


def _launches_of(fn) -> dict:
    ops.reset_launches()
    fn()
    return {k: v for k, v in ops.LAUNCHES.items() if v}


def check(hier, label: str, seed: int = 33) -> dict:
    """K3 at the hierarchy ``hier`` (its own state): the kernel equal to its
    plain version in f32 and f64 (the state cast), within
    :data:`COMPOSITION_TOL` of the composition, one launch an apply; then,
    in f32 and in turns with the composition, device µs by graph replay,
    host µs an apply, events ms, the plain version's ms and the bound
    (bytes)."""
    state, nu = hier.state, hier.nu
    n0 = hier.level_sizes[0]
    gen = torch.Generator().manual_seed(seed)
    r64 = torch.randn(n0, generator=gen, dtype=torch.float64).to(hier.device)
    out = {"levels": hier.level_sizes, "K": [tuple(lv[m + "_col"].shape[1] for m in "APR")
                                             for lv in state["levels"]]}
    err = 0.0
    for dtype in (torch.float32, torch.float64):
        st = state if dtype == hier.dtype else state_as(state, dtype)
        op = kernels.VCycleOperator(st["levels"], st["coarse_inv"], nu)
        r = r64.to(dtype)
        y = op(r)
        torch.cuda.synchronize()
        y_plain = reference.amg_vcycle(st["levels"], st["coarse_inv"], r, nu)
        same = torch.equal(y, y_plain)
        y_comp = Composition(st, nu)(r)
        scale = float(y_plain.abs().max())
        diff = float((y_comp - y).abs().max())
        err = max(err, diff / scale)
        print(f"  K3 at {label}, {str(dtype)[6:]}: kernel and plain version equal: {same}; against the "
              f"composition max |diff| {diff:.3e} of max |y| {scale:.3e} (tolerance "
              f"{COMPOSITION_TOL[dtype]:g} of it)")
        _require(same, f"amg_vcycle at {label} ({dtype}) differs from its plain version")
        _require(bool(torch.isfinite(y).all()), f"amg_vcycle at {label}: non-finite y")
        _require(diff <= COMPOSITION_TOL[dtype] * scale, f"amg_vcycle at {label} ({dtype}): composition differs")
    out["err"] = err
    r = r64.to(hier.dtype)
    op = hier._vcycle(state)
    comp = Composition(state, nu)
    launches = _launches_of(lambda: op(r))
    comp_launches = _launches_of(lambda: comp(r))
    _require(launches == {"amg_vcycle": 1}, f"amg_vcycle at {label}: launches of one apply {launches}")
    size = torch.finfo(hier.dtype).bits // 8
    nbytes = state_bytes(state) + 2 * n0 * size
    bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    routes = {"kernel": functools.partial(op, r), "composition": functools.partial(comp, r)}
    turns = tuple(routes) + tuple(reversed(tuple(routes)))
    device_us = {k: [] for k in routes}
    host = {k: [] for k in routes}
    ms = {k: [] for k in routes}
    for route in turns:
        device_us[route].append(graph_us(routes[route], launches=20))
    for route in turns:
        host[route].append(host_us(routes[route], 50))
    for route in turns:
        ms[route].append(cuda_ms(routes[route], 50))
    plain_ms = cuda_ms(lambda: reference.amg_vcycle(state["levels"], state["coarse_inv"], r, nu), 5)
    dev_kernel = min(device_us["kernel"])
    out.update(
        device_us=device_us, host_us=host, ms_turns=ms, ms=min(ms["kernel"]), plain_ms=plain_ms,
        bound_ms=bound_ms, nbytes=nbytes, share=1e3 * bound_ms / dev_kernel, launches=launches,
        composition_launches=sum(comp_launches.values()),
    )
    print(f"  K3 at {label}: levels {hier.level_sizes}, K of A, P, R {out['K']}; one apply: launches "
          f"{launches} (composition {comp_launches}); device us (graph replay) "
          f"{device_us}; host us {host}; ms back to back {ms}; plain {plain_ms:.4f} ms; bound "
          f"{1e3 * bound_ms:.3f} us (bytes, {nbytes / 1e6:.2f} MB), device time at "
          f"{100 * out['share']:.1f}% of it")
    return out


def check_sweeps(val, col, sinv, label: str, counts=(1, 2, 8, 40), seed: int = 34) -> dict:
    """K2 on one Jacobi block: for each ``s`` in ``counts``, the launch from
    ``y = sinv r`` and (``s = 1``) from a given ``y`` equal to the plain
    version to the bit, in f32 and f64; one launch a call; then in f32,
    ms by CUDA events and device µs by graph replay of the launch and of
    ``s`` one-sweep launches, the plain version's ms and the bound."""
    n, K = val.shape
    gen = torch.Generator().manual_seed(seed)
    r64, y64 = (torch.randn(n, generator=gen, dtype=torch.float64).to(val.device) for _ in range(2))
    for dtype in (torch.float32, torch.float64):
        op = kernels.JacobiSweeps(val.to(dtype), col, sinv.to(dtype))
        r, y = r64.to(dtype), y64.to(dtype)
        for s in counts:
            for y0 in (None, y) if s == 1 else (None,):
                got = op(r, s, y0)
                want = reference.jacobi_sweeps(op.val, col, op.sinv, r, y0, s)
                same = torch.equal(got, want)
                _require(same, f"jacobi_sweeps at {label}, s {s}, {dtype}: differs from its plain version")
        print(f"  K2 at {label} (n {n}, K {K}), {str(dtype)[6:]}: s {counts} from sinv r and s = 1 from y "
              f"equal to the plain version")
    op = kernels.JacobiSweeps(val.to(torch.float32), col, sinv.to(torch.float32))
    r = r64.to(torch.float32)
    nnz = int((col < n).sum())
    out = {"n": n, "K": K, "nnz": nnz, "err": 0.0, "by_s": {}}
    for s in counts:
        launches = _launches_of(lambda: op(r, s))
        _require(launches == {"jacobi_sweeps": 1}, f"jacobi_sweeps: launches of one call {launches}")

        def one_sweeps():
            y = op.sinv * r
            for _ in range(s):
                y = op(r, 1, y)
            return y

        t = {
            "ms": cuda_ms(lambda: op(r, s), 50),
            "device_us": graph_us(lambda: op(r, s), launches=20),
            "one_sweep_ms": cuda_ms(one_sweeps, 20),
            "one_sweep_device_us": graph_us(one_sweeps, launches=5),
            "plain_ms": cuda_ms(lambda: reference.jacobi_sweeps(op.val, col, op.sinv, r, None, s), 5),
        }
        # Every sweep reads the matrix; the bound counts it once, with sinv
        # and r read and the result written (f32 values, int32 columns).
        nbytes = n * K * 8 + 3 * n * 4
        flops = s * (2 * nnz + 3 * n)
        t["bound_ms"] = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / PEAK_F32)
        t["bound_by"] = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / PEAK_F32 else "operations"
        out["by_s"][s] = t
        print(f"  K2 at {label}, f32, s = {s}: {t['ms']:.4f} ms ({t['device_us']:.2f} us device), "
              f"{s} one-sweep launches {t['one_sweep_ms']:.4f} ms ({t['one_sweep_device_us']:.2f} us device), "
              f"plain {t['plain_ms']:.4f} ms, bound {1e3 * t['bound_ms']:.3f} us")
    return out


def first_solver(case: str):
    """The device solver of a bench case (``md``, ``md256``, ``3d``,
    ``biot``, ``tracer``; AMG field split, ``dense_precond=False``) with its
    preconditioner built at the first Jacobian."""
    from porepy_tpu_torch.applications.benchmarking import cases

    builders = {"md": cases.build_md_flow, "md256": lambda: cases.build_md_flow(1.0 / 256),
                "3d": cases.build_3d_flow, "biot": cases.build_biot, "tracer": cases.build_tracer}
    Model, params = builders[case]()
    params["dense_precond"] = False
    model = Model(params)
    model.prepare_simulation()
    eq_sys = model.equation_system
    cs = eq_sys.compiled_system()
    solver = model._device_solver_for(cs)
    solver.refresh_preconditioner(cs.assemble(eq_sys)[0])
    return solver


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    if not torch.cuda.is_available():
        print("vcycle_check: no CUDA card", file=sys.stderr)
        return 1
    from porepy_tpu_torch.applications.benchmarking.krylov_cycle_check import ptxas_report
    from porepy_tpu_torch.kernels import build

    with tempfile.TemporaryDirectory() as tmp:
        ptxas_report([os.path.join(build.CSRC, "amg_vcycle.cu")], tmp)
        build.library()
        print(f"{torch.cuda.get_device_name(0)}; kernels built in {build.build_seconds():.1f} s")
        for case, label in (("md", "md 1/128"), ("md256", "md 1/256"), ("3d", "3d 32^3"), ("biot", "biot 1/64")):
            for i, hier in sorted(first_solver(case)._hierarchies.items()):
                check(hier, f"{label}'s first Jacobian, block {i}")
    solver = first_solver("tracer")
    ((i, jb),) = solver._m_state["jac"].items()
    sweeps = solver._builder._jac_sweeps[i]
    print(f"  tracer 1/64's Jacobi block: {sweeps} sweeps frozen (0: 8, s = sweeps - 1 a launch, none for 1)")
    check_sweeps(jb["val"], jb["col"], jb["sinv"], "tracer 1/64's Jacobi block")
    return 0


if __name__ == "__main__":
    sys.exit(main())
