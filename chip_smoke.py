"""Smoke test of porepy_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the script (non-zero exit) when it fails:

1. print the card (``nvidia-smi`` name and power limit, and torch's name);
2. build the hand-written kernels from ``porepy_tpu_torch/kernels/csrc``;
3. hold each kernel against its plain PyTorch version at the md 1/128
   shapes (n = 18,157 rows, K = 9, B = 11 seeds; the Givens step at
   j = 0, 35, 69 of restart 70), with CUDA-event times over 100 calls.
   Tolerance: |kernel - plain| <= 1e-13 (float64) or 1e-5 (float32) times
   the row's sum of |terms|;
4. run the md case at cell size 1/128 through ``run_time_dependent_model``
   for 26 time steps on the card, with every kernel's launch count reset
   just before and read just after; check 3 fused blocks committed, no host
   fallback solve, every kernel launched, a finite state, pressure within
   the boundary data's range [0, 1], and the last step re-checked on the
   host with the plain path: its residual, and one more Newton increment
   (a direct solve) within the Newton tolerance;
5. run md at 1/16 on the card and on the host (plain path) and compare
   the final states (1e-8 max abs).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA card, or
without the rest of the repository beside it, the script exits non-zero
before printing either.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_ROWS, K_ELL, N_SEEDS, RESTART = 18157, 9, 11, 70
REPEATS = 100
TOL = {torch.float64: 1e-13, torch.float32: 1e-5}


def _cuda_ms(fn, repeats=REPEATS) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _check(name, err, bound):
    ok = bool(torch.all(err <= bound))
    worst = float(err.max())
    print(f"  {name}: max |err| {worst:.3e}, within bound: {ok}")
    _require(ok, f"{name} disagrees with its plain version")
    return worst


def _ell_operator(gen, dtype, dev):
    val = torch.randn(N_ROWS, K_ELL, generator=gen, dtype=torch.float64).to(dtype)
    col = torch.randint(0, N_ROWS, (N_ROWS, K_ELL), generator=gen, dtype=torch.int32)
    # Padded rows, as the ELL layout of the md Jacobian has: padding slots
    # point at column n and carry zero values.
    pad = torch.rand(N_ROWS, K_ELL, generator=gen) < 0.1
    col[pad] = N_ROWS
    val[pad] = 0
    return val.to(dev), col.to(dev)


def check_kernels(dev) -> dict:
    from porepy_tpu_torch.kernels import ops, reference

    gen = torch.Generator().manual_seed(0)
    report = {}

    print("phase 3: kernels against their plain versions")
    k1 = {"err": 0.0}
    for dtype in (torch.float32, torch.float64):
        val, col = _ell_operator(gen, dtype, dev)
        for batch in (None, N_SEEDS):
            shape = (N_ROWS,) if batch is None else (batch, N_ROWS)
            x = torch.randn(shape, generator=gen, dtype=torch.float64).to(dtype).to(dev)
            y = ops.ell_spmv(val, col, x)
            y_ref = reference.ell_spmv(val, col, x)
            absx = torch.cat([x.abs(), x.new_zeros(x.shape[:-1] + (1,))], -1)
            rowsum = (val.abs() * absx[..., col]).sum(-1)
            tag = f"ell_spmv {str(dtype)[6:]} x{list(shape)}"
            k1["err"] = max(k1["err"], _check(tag, (y - y_ref).abs(), TOL[dtype] * rowsum))
            ms = _cuda_ms(lambda: ops.ell_spmv(val, col, x))
            plain_ms = _cuda_ms(lambda: reference.ell_spmv(val, col, x))
            print(f"    {ms:.4f} ms kernel, {plain_ms:.4f} ms plain")
            if dtype == torch.float32 and batch is None:
                k1["ms"], k1["plain_ms"] = ms, plain_ms
    report["ell_spmv"] = k1

    k2 = {"err": 0.0}
    for dtype in (torch.float32, torch.float64):
        val, col = _ell_operator(gen, dtype, dev)
        sinv, r, y = (
            torch.randn(N_ROWS, generator=gen, dtype=torch.float64).to(dtype).to(dev)
            for _ in range(3)
        )
        out = ops.ell_jacobi_sweep(val, col, sinv, r, y)
        out_ref = reference.ell_jacobi_sweep(val, col, sinv, r, y)
        absy = torch.cat([y.abs(), y.new_zeros(1)])
        scale = y.abs() + sinv.abs() * (r.abs() + (val.abs() * absy[col]).sum(-1))
        tag = f"ell_jacobi_sweep {str(dtype)[6:]}"
        k2["err"] = max(k2["err"], _check(tag, (out - out_ref).abs(), TOL[dtype] * scale))
        ms = _cuda_ms(lambda: ops.ell_jacobi_sweep(val, col, sinv, r, y))
        plain_ms = _cuda_ms(lambda: reference.ell_jacobi_sweep(val, col, sinv, r, y))
        print(f"    {ms:.4f} ms kernel, {plain_ms:.4f} ms plain")
        if dtype == torch.float32:
            k2["ms"], k2["plain_ms"] = ms, plain_ms
    report["ell_jacobi_sweep"] = k2

    k4 = {"err": 0.0}
    for dtype in (torch.float32, torch.float64):
        for j0 in (0, 35, 69):
            h = torch.randn(RESTART + 1, generator=gen, dtype=torch.float64)
            h[j0 + 2 :] = 0
            theta = torch.rand(RESTART, generator=gen, dtype=torch.float64) * 6.28
            g = torch.zeros(RESTART + 1, dtype=torch.float64)
            g[: j0 + 1] = torch.randn(j0 + 1, generator=gen, dtype=torch.float64)
            inputs = [h, torch.cos(theta), torch.sin(theta), g]
            atol = torch.tensor(1e-6, dtype=dtype, device=dev)

            def fresh():
                arrays = [a.to(dtype=dtype, device=dev, copy=True) for a in inputs]
                j = torch.tensor(j0, dtype=torch.int32, device=dev)
                flag = torch.zeros((), dtype=torch.int32, device=dev)
                return arrays + [j, atol, flag]

            got, want = fresh(), fresh()
            ops.fgmres_givens(*got)
            reference.fgmres_givens(*want)
            scale = sum(float(a.abs().sum()) for a in want[:4]) + 1.0
            err = torch.stack(
                [(a - b).abs().max() for a, b in zip(got[:4], want[:4])]
            ).max()
            tag = f"fgmres_givens {str(dtype)[6:]} j={j0}"
            k4["err"] = max(k4["err"], _check(tag, err, TOL[dtype] * scale))
            same_int = all(int(a) == int(b) for a, b in zip(got[4::2], want[4::2]))
            _require(same_int, f"{tag}: j or flag disagrees")
            args = fresh()
            j_dev = args[4]

            def step(fn=ops.fgmres_givens):
                j_dev.fill_(j0)
                fn(*args)

            ms = _cuda_ms(step)
            plain_ms = _cuda_ms(lambda: step(reference.fgmres_givens))
            print(f"    {ms:.4f} ms kernel, {plain_ms:.4f} ms plain (both reset j)")
            if dtype == torch.float32 and j0 == 35:
                k4["ms"], k4["plain_ms"] = ms, plain_ms
    report["fgmres_givens"] = k4
    return report


def last_step_check(model) -> tuple[float, float]:
    """The last time step re-checked on the host CPU with the plain path:
    the md equations at the final state ``x_26`` with the previous-step
    state ``x_25`` of the last block. Returns ``|F| / sqrt(n)`` and the
    norm ``|dx| / sqrt(n)`` of one more Newton increment, ``J dx = -F``
    solved directly with scipy — the quantity the Newton tolerance bounds."""
    import scipy.sparse as sps
    import scipy.sparse.linalg as spla

    from porepy_tpu_torch.numerics.ad import compiler

    eq_sys = model.equation_system
    cs = eq_sys.compiled_system()
    subst = model._fused_block_substitution(cs)
    x_prev, x_last = (t.cpu() for t in model._last_block_states[-2:])
    data, vals = [], []
    for ce, smap in zip(cs.ces, subst):
        env = ce.env_spec.fetch(eq_sys, device="cpu")
        env = [x_prev[smap[i][0] : smap[i][1]] if i in smap else e for i, e in enumerate(env)]
        seeds = torch.tensor(ce.seeds, dtype=torch.float64)
        val, compressed = compiler.colored_jvps(ce.fn, x_last, env, seeds)
        data.append(compressed.numpy()[ce.gather_color, ce.rows])
        vals.append(val.numpy())
    rows, cols = cs.indices_np[:, 0], cs.indices_np[:, 1]
    J = sps.csr_matrix((np.concatenate(data), (rows, cols)), shape=cs.shape)
    F = np.concatenate(vals)
    dx = spla.spsolve(J.tocsc(), -F)
    sqrt_n = np.sqrt(F.size)
    return float(np.linalg.norm(F) / sqrt_n), float(np.linalg.norm(dx) / sqrt_n)


def timed_model(base):
    class Timed(base):
        """The md model with a synchronized wall clock around each fused
        block, keeping the last block's states for the residual check."""

        def fused_time_block(self, n_steps, nl_params):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            n = super().fused_time_block(n_steps, nl_params)
            torch.cuda.synchronize()
            if n:
                self.block_log.append((time.perf_counter() - tic, dict(self._ftb_last)))
            return n

        def _build_fused_time_block(self, *args, **kwargs):
            block = super()._build_fused_time_block(*args, **kwargs)

            def keep_states(*a):
                out = block(*a)
                self._last_block_states = out[0]
                return out

            return keep_states

    return Timed


def run_md(dev, cell_size: float = 1.0 / 128) -> dict:
    import porepy_tpu_torch as pt
    from porepy_tpu_torch.applications.benchmarking.cases import build_md_flow
    from porepy_tpu_torch.kernels import LAUNCHES, reset_launches
    from porepy_tpu_torch.numerics.linalg.krylov import FALLBACK_COUNTER

    print(f"phase 4: md at cell size {cell_size:g}, 26 steps on {dev}")
    Model, params = build_md_flow(cell_size, device=str(dev))
    model = timed_model(Model)(params)
    model.block_log = []
    fallbacks0 = FALLBACK_COUNTER["count"]
    reset_launches()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    model.prepare_simulation()
    model._prepared = True
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - tic
    tic = time.perf_counter()
    pt.run_time_dependent_model(model, params)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - tic
    launches = dict(LAUNCHES)

    eq_sys = model.equation_system
    x = eq_sys.get_variable_values(time_step_index=0)
    p = eq_sys.get_variable_values(["pressure"], time_step_index=0)
    print(f"  dofs {eq_sys.num_dofs()}, setup {setup_s:.3f} s, 26 steps {run_s:.3f} s")
    for i, (secs, rec) in enumerate(model.block_log):
        print(
            f"  block {i}: {secs:.4f} s, {rec['steps']} steps, "
            f"{rec['newton_iters']} Newton, {rec['krylov_iters']} Krylov, "
            f"{1e3 * secs / max(rec['newton_iters'], 1):.2f} ms per Newton iteration"
        )
    print(f"  kernel launches in the run: {launches}")
    res, inc = last_step_check(model)
    tol = 1e-10  # NewtonSolver's nl_convergence_tol, the md case's default
    print(
        f"  last step on the host, plain path: |F|/sqrt(n) {res:.3e}, "
        f"next Newton increment |dx|/sqrt(n) {inc:.3e}, tolerance {tol:.0e}"
    )
    print(f"  pressure in [{p.min():.6f}, {p.max():.6f}]")

    _require(model._ftb_blocks_committed == 3, f"blocks {model._ftb_blocks_committed}")
    _require(FALLBACK_COUNTER["count"] == fallbacks0, f"host fallbacks {FALLBACK_COUNTER}")
    _require(all(v > 0 for v in launches.values()), f"kernel not launched: {launches}")
    _require(bool(np.all(np.isfinite(x))), "non-finite state")
    _require(p.min() >= 0.0 and p.max() <= 1.0, f"pressure {p.min()}..{p.max()}")
    _require(inc <= tol, f"Newton increment {inc} > {tol}")
    newton = sum(rec["newton_iters"] for _s, rec in model.block_log)
    block_s = sum(s for s, _rec in model.block_log)
    return {
        "launches": launches,
        "setup_s": setup_s,
        "ms_per_newton": 1e3 * block_s / max(newton, 1),
    }


def compare_small(dev) -> None:
    import porepy_tpu_torch as pt
    from porepy_tpu_torch.applications.benchmarking.cases import build_md_flow

    print("phase 5: md 1/16 on the card against the host plain path")
    finals = []
    for device in (str(dev), "cpu"):
        Model, params = build_md_flow(1.0 / 16, device=device)
        model = Model(params)
        pt.run_time_dependent_model(model, params)
        _require(model._ftb_blocks_committed == 3, f"{device}: blocks committed")
        finals.append(model.equation_system.get_variable_values(time_step_index=0))
    err = float(np.abs(finals[0] - finals[1]).max())
    print(f"  max |cuda - cpu| {err:.3e} over {finals[0].size} dofs")
    _require(err <= 1e-8, f"cuda and cpu differ by {err}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from porepy_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"phase 1: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {name}")

    build.library()
    print(f"phase 2: kernels built in {build.build_seconds():.2f} s")

    report = check_kernels(dev)
    md = run_md(dev)
    compare_small(dev)

    sources = {
        "ell_spmv": ("ell_spmv.cu", "porepy_tpu/numerics/linalg/amg.py:59"),
        "ell_jacobi_sweep": ("ell_jacobi_sweep.cu", "porepy_tpu/numerics/linalg/amg.py:334"),
        "fgmres_givens": ("fgmres_givens.cu", "porepy_tpu/numerics/linalg/device_solver.py:198"),
    }
    kernels_line = {
        "kernels": [
            {
                "name": k,
                "route": "cuda",
                "source": "porepy_tpu_torch/kernels/csrc/" + src,
                "replaces": replaces,
                "launches": md["launches"][k],
                "max_abs_err": report[k]["err"],
                "ms": report[k]["ms"],
                "plain_ms": report[k]["plain_ms"],
            }
            for k, (src, replaces) in sources.items()
        ]
    }
    print(
        f"md 1/128 on {smi}: setup {md['setup_s']:.3f} s, "
        f"{md['ms_per_newton']:.2f} ms per Newton iteration (fused blocks)"
    )
    print(smi)
    print(json.dumps(kernels_line))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
