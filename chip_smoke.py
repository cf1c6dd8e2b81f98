"""Smoke test of porepy_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the script (non-zero exit) when it fails:

1. print the card (``nvidia-smi`` name and power limit, and torch's name);
2. build the hand-written kernels from ``porepy_tpu_torch/kernels/csrc``;
3. hold each md kernel against its plain PyTorch version at the md 1/128
   shapes (n = 18,157 rows, K = 9, B = 11 seeds; the Givens step at
   j = 0, 35, 69 of restart 70), with CUDA-event times over 100 calls.
   Tolerance: |kernel - plain| <= 1e-13 (float64) or 1e-5 (float32) times
   the row's sum of |terms|; the same for the structured (K12) and
   unstructured (K13) flow-step residuals and tangents at 32^3 (32,768
   cells, 101,376 faces), in f64 and f32;
4. run the md case at cell size 1/128 through ``run_time_dependent_model``
   for 26 time steps on the card, with every kernel's launch count reset
   just before and read just after; check 3 fused blocks committed, no host
   fallback solve, every md kernel launched, a finite state, pressure
   within the boundary data's range [0, 1], and the last step re-checked
   on the host with the plain path: its residual, and one more Newton
   increment (a direct solve) within the Newton tolerance;
5. run md at 1/16 on the card and on the host (plain path) and compare
   the final states (1e-8 max abs);
6. run the 3d case at 32^3 (32,768 dofs) for 26 steps with dense frozen
   block inverses (K6), as porepy_tpu ran it on the TPU: 3 fused blocks,
   no host fallback, dense active and not demoted, every K1/K4g/K6 kernel
   launched, a finite state with pressure in [1e5, 2e5] (the boundary data
   and the initial value), and one more host Newton increment <= 1e-10;
   prints setup, dense-build and Gauss-Jordan seconds and per-block times;
7. hold the K6 kernels against their plain versions at the 3d shapes: the
   scatter of the 3d block's pattern (223,232 entries) into a 32,768^2
   matrix, the pivot inverse on a batch of 128 x 128 blocks (one needing
   row swaps, one singular), the blocked inverse at n = 4,096 by kernel
   and plain route (max |S X - I| and the distance between the two X),
   and the apply with the 3d run's own 32,768^2 inverse (with GB/s);
8. the same 3d run with the AMG preconditioner instead (its numbers; 3
   blocks, no fallback);
9. 3d at 1/16 with dense inverses on the card and on the host (plain
   path): final states within 1e-8 of max |p|;
10. the structured flow step (K12) at 32^3 as porepy_tpu's ``structured``
   bench case runs it: 7 chained Newton steps from p = 2e5 (median ms),
   then Newton to |r| < 1e-6 or to the residual's rounding floor, on the
   card and on the host (plain path, 1e-6 abs apart), and the unstructured
   step (K13) on the same problem (1e-4 abs from the structured one).

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
MD_KERNELS = ("ell_spmv", "ell_jacobi_sweep", "fgmres_givens")
DENSE_KERNELS = ("dense_block_scatter", "gj_pivot_inverse", "dense_block_apply")
N3D = 32
FLUID_3D = dict(
    permeability=1.0, porosity=0.1, viscosity=1e-3, compressibility=1e-6,
    rho_ref=1000.0, p_ref=1.0e5, dt=1.0,
)


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
    _require(all(launches[k] > 0 for k in MD_KERNELS), f"kernel not launched: {launches}")
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


def _bc_x(x, y, z):
    return 1e5 + 1e4 * (1 - np.asarray(x))


def _bc_faces(fc):
    return 1e5 + 1e4 * (1 - fc[0])


def check_flow_kernels(dev) -> dict:
    """K12 and K13 residual/tangent kernels against their plain versions
    at 32^3, f64 and f32, with CUDA-event times."""
    from porepy_tpu_torch.kernels import ops, reference
    from porepy_tpu_torch.parallel.flow_step import build_cart_flow_kernel
    from porepy_tpu_torch.parallel.structured_flow import build_structured_flow_kernel

    print(f"phase 3b: flow-step kernels against their plain versions at {N3D}^3")
    shape = (N3D,) * 3
    ks, _ = build_structured_flow_kernel(shape, (1.0, 1.0, 1.0), bc_pressure=_bc_x, device=dev, **FLUID_3D)
    ku, _ = build_cart_flow_kernel(list(shape), [1, 1, 1], bc_pressure=_bc_faces, device=dev, **FLUID_3D)
    print(f"  cells {ku.num_cells}, faces {ku.num_faces}")
    gen = torch.Generator().manual_seed(1)
    report = {k: {"err": 0.0} for k in ("structured_residual", "structured_jvp", "tpfa_residual", "tpfa_jvp")}
    for dtype in (torch.float64, torch.float32):
        s_args = (*ks._as_dtype(dtype)._arrays(), ks._coef().to(dtype))
        u_args = list(ku._arrays()) + [ku._coef()]
        for i in (2, 4, 5, 8):  # t, bc_val, pv, coef
            u_args[i] = u_args[i].to(dtype)
        for names, args, n_shape in (
            (("structured_residual", "structured_jvp"), s_args, shape),
            (("tpfa_residual", "tpfa_jvp"), tuple(u_args), (ku.num_cells,)),
        ):
            p, q = (
                (2e5 + 1e4 * torch.randn(n_shape, generator=gen, dtype=torch.float64)).to(dtype).to(dev)
                for _ in range(2)
            )
            v = torch.randn(n_shape, generator=gen, dtype=torch.float64).to(dtype).to(dev)
            for name, second in zip(names, (q, v)):
                kern, plain = getattr(ops, name), getattr(reference, name)
                got, want = kern(p, second, *args), plain(p, second, *args)
                # The scale of the summed terms: the largest entry of the
                # result and of the result along |q|.
                scale = want.abs().max() + plain(p, second.abs(), *args).abs().max()
                tag = f"{name} {str(dtype)[6:]}"
                err = _check(tag, (got - want).abs(), TOL[dtype] * scale)
                report[name]["err"] = max(report[name]["err"], err)
                ms = _cuda_ms(lambda: kern(p, second, *args))
                plain_ms = _cuda_ms(lambda: plain(p, second, *args))
                print(f"    {ms:.4f} ms kernel, {plain_ms:.4f} ms plain")
                if dtype == torch.float64:
                    report[name]["ms"], report[name]["plain_ms"] = ms, plain_ms
    return report


def run_3d(dev, dense: bool, cell_size: float = 1.0 / N3D) -> dict:
    """The 3d case for 26 steps on ``dev``; with ``dense`` the dense frozen
    block inverse (K6), timed build by build."""
    import porepy_tpu_torch as pt
    from porepy_tpu_torch.applications.benchmarking.cases import build_3d_flow
    from porepy_tpu_torch.kernels import LAUNCHES, reset_launches
    from porepy_tpu_torch.numerics.linalg import device_solver as ds
    from porepy_tpu_torch.numerics.linalg.krylov import FALLBACK_COUNTER

    phase = "6" if dense else "8"
    print(f"phase {phase}: 3d at cell size {cell_size:g}, 26 steps on {dev}, dense_precond={dense}")
    Model, params = build_3d_flow(cell_size, device=str(dev))
    params["dense_precond"] = dense
    model = timed_model(Model)(params)
    model.block_log = []
    times = {"build": [], "inverse": [], "gj": []}

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[key].append(time.perf_counter() - tic)
            return out

        return wrapper

    patched = [
        (ds._BlockPrecondBuilder, "_build_dense_block", "build"),
        (ds, "_dense_inv_fn", "inverse"),
        (ds, "_dense_block_inv", "gj"),
    ]
    originals = [(obj, name, getattr(obj, name)) for obj, name, _k in patched]
    for obj, name, key in patched:
        setattr(obj, name, timed(getattr(obj, name), key))
    try:
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
    finally:
        for obj, name, fn in originals:
            setattr(obj, name, fn)

    eq_sys = model.equation_system
    x = eq_sys.get_variable_values(time_step_index=0)
    solver = next(iter(model._device_solvers.values()))
    print(f"  dofs {eq_sys.num_dofs()}, setup {setup_s:.3f} s, 26 steps {run_s:.3f} s")
    if dense:
        print(
            f"  dense builds {len(times['build'])}: "
            + ", ".join(
                f"{b:.3f} s (inverse {i:.3f} s, Gauss-Jordan alone {g:.3f} s)"
                for b, i, g in zip(times["build"], times["inverse"], times["gj"])
            )
        )
    for i, (secs, rec) in enumerate(model.block_log):
        print(
            f"  block {i}: {secs:.4f} s, {rec['steps']} steps, "
            f"{rec['newton_iters']} Newton, {rec['krylov_iters']} Krylov, "
            f"{1e3 * secs / max(rec['newton_iters'], 1):.2f} ms per Newton iteration"
        )
    print(f"  kernel launches in the run: {launches}")
    print(f"  pressure in [{x.min():.6f}, {x.max():.6f}]")
    _require(model._ftb_blocks_committed == 3, f"blocks {model._ftb_blocks_committed}")
    _require(FALLBACK_COUNTER["count"] == fallbacks0, f"host fallbacks {FALLBACK_COUNTER}")
    newton = sum(rec["newton_iters"] for _s, rec in model.block_log)
    block_s = sum(s for s, _rec in model.block_log)
    out = {
        "launches": launches,
        "setup_s": setup_s,
        "ms_per_newton": 1e3 * block_s / max(newton, 1),
        "blocks": [(s, dict(rec)) for s, rec in model.block_log],
    }
    if not dense:
        return out
    _require(solver._dense and solver._builder._block_dense == {0: True}, "dense demoted")
    needed = ("ell_spmv", "fgmres_givens") + DENSE_KERNELS
    _require(all(launches[k] > 0 for k in needed), f"kernel not launched: {launches}")
    _require(bool(np.all(np.isfinite(x))), "non-finite state")
    _require(x.min() >= 1e5 and x.max() <= 2e5, f"pressure {x.min()}..{x.max()}")
    res, inc = last_step_check(model)
    tol = 1e-10
    print(
        f"  last step on the host, plain path: |F|/sqrt(n) {res:.3e}, "
        f"next Newton increment |dx|/sqrt(n) {inc:.3e}, tolerance {tol:.0e}"
    )
    _require(inc <= tol, f"Newton increment {inc} > {tol}")
    cs = eq_sys.compiled_system()
    out.update(
        build_s=times["build"], inverse_s=times["inverse"], gj_s=times["gj"],
        pattern=(cs.indices_np[:, 0], cs.indices_np[:, 1], cs.shape[0]),
        D=solver._m_state["dense"][0],
    )
    return out


def check_dense_kernels(dev, d3) -> dict:
    """K6 kernels against their plain versions at the 3d shapes."""
    from porepy_tpu_torch.kernels import ops, reference
    from porepy_tpu_torch.numerics.linalg import device_solver as ds

    print("phase 7: dense-block kernels against their plain versions")
    report = {}
    gen = torch.Generator().manual_seed(2)

    rows, cols, ni = d3["pattern"]
    n_pad = -(-ni // ds._DENSE_GJ_BLOCK) * ds._DENSE_GJ_BLOCK
    vals = torch.randn(rows.size, generator=gen).to(dev)
    rows_t = torch.tensor(rows.astype(np.int32), device=dev)
    cols_t = torch.tensor(cols.astype(np.int32), device=dev)
    D = ops.dense_block_scatter(vals, rows_t, cols_t, ni, n_pad)
    D_ref = reference.dense_block_scatter(vals, rows_t, cols_t, ni, n_pad)
    err = float((D - D_ref).abs().max())
    print(f"  dense_block_scatter ni {ni}, nnz {rows.size}: max |err| {err:.3e} (must be 0: plain stores)")
    _require(err == 0.0, "dense_block_scatter disagrees with its plain version")
    del D, D_ref
    ms = _cuda_ms(lambda: ops.dense_block_scatter(vals, rows_t, cols_t, ni, n_pad), 10)
    plain_ms = _cuda_ms(lambda: reference.dense_block_scatter(vals, rows_t, cols_t, ni, n_pad), 10)
    print(f"    {ms:.4f} ms kernel, {plain_ms:.4f} ms plain (each includes zeroing {n_pad}^2 f32)")
    report["dense_block_scatter"] = {"err": err, "ms": ms, "plain_ms": plain_ms}

    # Pivot inverses: well-conditioned blocks, one with a zero leading entry
    # (needs a row swap) and one singular (must be flagged).
    b, batch = ds._DENSE_GJ_BLOCK, 64
    a = torch.randn(batch, b, b, generator=gen, dtype=torch.float64) / b**0.5 + 4 * torch.eye(b, dtype=torch.float64)
    a[0, [0, 1]] = a[0, [1, 0]]
    a[0, 0, 0] = 0.0
    a[1] = torch.outer(torch.arange(1.0, b + 1, dtype=torch.float64), torch.arange(1.0, b + 1, dtype=torch.float64))
    report["gj_pivot_inverse"] = {"err": 0.0}
    for dtype in (torch.float32, torch.float64):
        ad = a.to(dtype).to(dev)
        flag = torch.zeros(batch, dtype=torch.int32, device=dev)
        inv = ops.gj_pivot_inverse(ad, flag)
        flag_ref = torch.zeros(batch, dtype=torch.int32, device=dev)
        inv_ref = reference.gj_pivot_inverse(ad, flag_ref)
        flags = flag.cpu().tolist()
        _require(flags == [0, 1] + [0] * (batch - 2), f"gj flags {flags[:4]}...")
        _require(flag_ref.cpu().tolist() == flags, "gj flags differ from the plain version's")
        good = [0] + list(range(2, batch))
        # Inverse of a matrix with condition number ~3: |X - X_ref| <= TOL
        # times b times max |X| (b-term sums, both in dtype).
        e = (inv[good] - inv_ref[good]).abs().max()
        bound = TOL[dtype] * b * inv_ref[good].abs().max()
        err = _check(f"gj_pivot_inverse {str(dtype)[6:]} {batch} x {b}^2", e, bound)
        report["gj_pivot_inverse"]["err"] = max(report["gj_pivot_inverse"]["err"], err)
        ms = _cuda_ms(lambda: ops.gj_pivot_inverse(ad, flag))
        plain_ms = _cuda_ms(lambda: reference.gj_pivot_inverse(ad, flag_ref))
        print(f"    {ms:.4f} ms kernel, {plain_ms:.4f} ms plain (torch.linalg.inv_ex)")
        if dtype == torch.float32:
            report["gj_pivot_inverse"].update(ms=ms, plain_ms=plain_ms)

    # The whole blocked inverse at n = 4096, kernel route against plain
    # route. Bound: f32 and cond(S) ~ 3 give |S X - I| ~ n eps_f32 cond at
    # worst (1.5e-3); the two routes differ only in the pivot inverses.
    n = 4096
    S = (torch.randn(n, n, generator=gen) / n**0.5 + 4 * torch.eye(n)).to(dev)
    eye = torch.eye(n, device=dev, dtype=torch.float64)
    routes = {}
    for route, piv in (("kernel", ops.gj_pivot_inverse), ("plain", reference.gj_pivot_inverse)):
        ds._dense_block_inv(S.clone(), pivot_inverse=piv)  # warm-up
        torch.cuda.synchronize()
        tic = time.perf_counter()
        X = ds._dense_block_inv(S.clone(), pivot_inverse=piv)
        torch.cuda.synchronize()
        routes[route] = (X, time.perf_counter() - tic)
    for route, (X, secs) in routes.items():
        res = float((S.double() @ X.double() - eye).abs().max())
        print(f"  blocked inverse n {n}, {route} route: max |S X - I| {res:.3e}, {secs:.4f} s")
        _require(res <= 1.5e-3, f"{route} blocked inverse residual {res}")
    dist = float((routes["kernel"][0] - routes["plain"][0]).abs().max() / routes["plain"][0].abs().max())
    print(f"  max |X_kernel - X_plain| / max |X| {dist:.3e} (bound 1e-4)")
    _require(dist <= 1e-4, "blocked inverse routes differ")
    del routes, S

    D = d3["D"]
    report["dense_block_apply"] = {"err": 0.0}
    for dtype in (torch.float32, torch.float64):
        r = torch.randn(ni, generator=gen, dtype=torch.float64).to(dtype).to(dev)
        y = ops.dense_block_apply(D, r)
        y_ref = reference.dense_block_apply(D, r)
        scale = reference.dense_block_apply(D.abs(), r.abs())
        err = _check(f"dense_block_apply {str(dtype)[6:]} n {ni}", (y - y_ref).abs(), TOL[torch.float32] * scale)
        report["dense_block_apply"]["err"] = max(report["dense_block_apply"]["err"], err)
        ms = _cuda_ms(lambda: ops.dense_block_apply(D, r), 20)
        plain_ms = _cuda_ms(lambda: reference.dense_block_apply(D, r), 20)
        gbs = 4.0 * ni * ni / (ms * 1e-3) / 1e9
        print(f"    {ms:.4f} ms kernel ({gbs:.0f} GB/s of D), {plain_ms:.4f} ms plain")
        if dtype == torch.float32:
            report["dense_block_apply"].update(ms=ms, plain_ms=plain_ms, gb_s=gbs)
    return report


def compare_3d_small(dev) -> None:
    import porepy_tpu_torch as pt
    from porepy_tpu_torch.applications.benchmarking.cases import build_3d_flow

    print("phase 9: 3d 1/16 with dense inverses on the card against the host plain path")
    finals = []
    for device in (str(dev), "cpu"):
        Model, params = build_3d_flow(1.0 / 16, device=device)
        params["dense_precond"] = True
        model = Model(params)
        pt.run_time_dependent_model(model, params)
        _require(model._ftb_blocks_committed == 3, f"{device}: blocks committed")
        _require(next(iter(model._device_solvers.values()))._dense, f"{device}: dense demoted")
        finals.append(model.equation_system.get_variable_values(time_step_index=0))
    err = float(np.abs(finals[0] - finals[1]).max())
    scale = float(np.abs(finals[1]).max())
    print(f"  max |cuda - cpu| {err:.3e} over {finals[0].size} dofs, max |p| {scale:.6e}")
    _require(err <= 1e-8 * scale, f"cuda and cpu differ by {err}")


def _newton_to_floor(step, p0, tol=1e-6, max_iter=20):
    """Newton from ``p0`` until |r| < tol or the residual stops falling
    (|r_k| > |r_{k-1}| / 2: its rounding floor). Returns the state and
    the residual history."""
    p, hist = p0, []
    for _ in range(max_iter):
        p, rn = step(p, p0)
        hist.append(float(rn))
        if hist[-1] < tol or (len(hist) > 1 and hist[-1] > 0.5 * hist[-2]):
            break
    return p, hist


def run_flow_steps(dev) -> dict:
    from porepy_tpu_torch.kernels import LAUNCHES, reset_launches
    from porepy_tpu_torch.parallel.flow_step import build_cart_flow_kernel
    from porepy_tpu_torch.parallel.structured_flow import build_structured_flow_kernel

    print(f"phase 10: structured (K12) and unstructured (K13) flow steps at {N3D}^3")
    shape = (N3D,) * 3
    out = {}
    finals = []
    for on_card, device in ((True, dev), (False, torch.device("cpu"))):
        kernel, _ = build_structured_flow_kernel(shape, (1.0, 1.0, 1.0), bc_pressure=_bc_x, device=device, **FLUID_3D)
        p_prev = torch.full(shape, 2.0e5, dtype=torch.float64, device=device)
        if on_card:
            reset_launches()
            kernel.newton_step(p_prev, p_prev)
            torch.cuda.synchronize()
            times = []
            p = p_prev
            for _ in range(7):
                tic = time.perf_counter()
                p = kernel.newton_step(p, p_prev)[0]
                torch.cuda.synchronize()
                times.append(time.perf_counter() - tic)
            out["structured_ms"] = 1e3 * float(np.median(times))
            print(f"  structured, 7 chained Newton steps: median {out['structured_ms']:.3f} ms per step")
        tic = time.perf_counter()
        p, hist = _newton_to_floor(kernel.newton_step, p_prev)
        if on_card:
            torch.cuda.synchronize()
            out["structured_launches"] = dict(LAUNCHES)
        print(f"  structured on {device}: {len(hist)} Newton steps in {time.perf_counter() - tic:.3f} s, |r| {['%.3e' % h for h in hist]}")
        finals.append(p.cpu().numpy())
    err = float(np.abs(finals[0] - finals[1]).max())
    print(f"  structured, max |card - host| {err:.3e}")
    _require(err <= 1e-6, f"structured card and host differ by {err}")

    kernel, p0 = build_cart_flow_kernel(list(shape), [1, 1, 1], bc_pressure=_bc_faces, device=dev, **FLUID_3D)
    q_prev = torch.full((kernel.num_cells,), 2.0e5, dtype=torch.float64, device=dev)
    reset_launches()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    q, hist = _newton_to_floor(kernel.newton_step, q_prev)
    torch.cuda.synchronize()
    out["tpfa_launches"] = dict(LAUNCHES)
    print(f"  unstructured on {dev}: {len(hist)} Newton steps in {time.perf_counter() - tic:.3f} s, |r| {['%.3e' % h for h in hist]}")
    # CartGrid numbers cells x fastest.
    q3 = q.cpu().numpy().reshape(shape[::-1]).T
    err = float(np.abs(finals[0] - q3).max())
    print(f"  max |structured - unstructured| {err:.3e}")
    _require(err < 1e-4, f"structured and unstructured differ by {err}")
    for key, names in (("structured_launches", ("structured_residual", "structured_jvp")),
                       ("tpfa_launches", ("tpfa_residual", "tpfa_jvp"))):
        print(f"  kernel launches ({key[:-9]} run): {out[key]}")
        _require(all(out[key][k] > 0 for k in names), f"{names} not launched: {out[key]}")
    return out


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
    report.update(check_flow_kernels(dev))
    md = run_md(dev)
    compare_small(dev)
    d3 = run_3d(dev, dense=True)
    report.update(check_dense_kernels(dev, d3))
    del d3["D"]
    torch.cuda.empty_cache()
    d3_amg = run_3d(dev, dense=False)
    compare_3d_small(dev)
    flow = run_flow_steps(dev)

    csrc = "porepy_tpu_torch/kernels/csrc/"
    kernels = {
        "ell_spmv": ("ell_spmv.cu", "porepy_tpu/numerics/linalg/amg.py:59", md["launches"]),
        "ell_jacobi_sweep": ("ell_jacobi_sweep.cu", "porepy_tpu/numerics/linalg/amg.py:334", md["launches"]),
        "fgmres_givens": ("fgmres_givens.cu", "porepy_tpu/numerics/linalg/device_solver.py:198", md["launches"]),
        "dense_block_scatter": ("dense_block.cu", "porepy_tpu/numerics/linalg/device_solver.py:141", d3["launches"]),
        "gj_pivot_inverse": ("dense_block.cu", "porepy_tpu/numerics/linalg/device_solver.py:104", d3["launches"]),
        "dense_block_apply": ("dense_block.cu", "porepy_tpu/numerics/linalg/device_solver.py:702", d3["launches"]),
        "structured_residual": ("structured_flow.cu", "porepy_tpu/parallel/structured_flow.py:69", flow["structured_launches"]),
        "structured_jvp": ("structured_flow.cu", "porepy_tpu/parallel/structured_flow.py:116", flow["structured_launches"]),
        "tpfa_residual": ("tpfa_flow.cu", "porepy_tpu/parallel/flow_step.py:72", flow["tpfa_launches"]),
        "tpfa_jvp": ("tpfa_flow.cu", "porepy_tpu/parallel/flow_step.py:104", flow["tpfa_launches"]),
    }
    kernels_line = {
        "kernels": [
            {
                "name": k,
                "route": "cuda",
                "source": csrc + src,
                "replaces": replaces,
                "launches": launches[k],
                "max_abs_err": report[k]["err"],
                "ms": report[k]["ms"],
                "plain_ms": report[k]["plain_ms"],
            }
            for k, (src, replaces, launches) in kernels.items()
        ]
    }
    print(
        f"md 1/128 on {smi}: setup {md['setup_s']:.3f} s, "
        f"{md['ms_per_newton']:.2f} ms per Newton iteration (fused blocks)"
    )
    print(
        f"3d 32^3 on {smi}: dense: setup {d3['setup_s']:.3f} s, dense build "
        f"{sum(d3['build_s']):.3f} s (Gauss-Jordan {sum(d3['gj_s']):.3f} s), "
        f"{d3['ms_per_newton']:.2f} ms per Newton iteration; AMG: setup "
        f"{d3_amg['setup_s']:.3f} s, {d3_amg['ms_per_newton']:.2f} ms per Newton iteration "
        f"(reference CPU: 6691 ms)"
    )
    print(f"structured 32^3 on {smi}: {flow['structured_ms']:.3f} ms per Newton step (median of 7)")
    print(smi)
    print(json.dumps(kernels_line))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
