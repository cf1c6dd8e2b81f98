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
   step (K13) on the same problem (1e-4 abs from the structured one);
11. hold the batched interaction-region solve (K10) against its plain
   version on the chunks that the discretization of the biot 1/64 model
   (MPSA/Biot and MPFA) and of a 3d 16^3 Biot problem build (the largest
   bucket (81, 32, 80) at the chunk size ``max_batch_elements`` gives), on
   a batch with a zero leading entry and on one too large for shared
   memory: |kernel - plain| <= 1e-12 max |plain| per bucket, with
   CUDA-event times of kernel, plain version and the host-device copies;
12. run the biot case at 1/64 (12,288 dofs) for 26 steps, its
   discretization by K10 (``PPT_LOCAL_SOLVE_DEVICE=1`` set just before
   ``prepare_simulation`` and removed after), once with the SA-AMG field
   split (rigid-body modes on u, fixed-stress stabilization) and once with
   dense frozen block inverses: 3 blocks, no host fallback, K10 launched in
   the discretization, the block kernels launched, a finite state and one
   more host Newton increment <= 1e-10; prints setup seconds, the
   discretization seconds by K10 and by host LAPACK, ms per Newton
   iteration and the reference's 567 ms;
13. biot 1/16 (10 steps) and the fractured poromechanics "contact" case
   (``device_gmres``) on the card against the host plain path (1e-8 of
   each field's max), and every Biot matrix at 1/64 by K10 against the
   host LAPACK route (1e-12 relative);
14. the Jacobi-Krylov route (K18) on the first Newton system of biot 1/64
   (12,288 dofs): every K18 operator call of three BiCGStab iterations and
   of one GMRES(30) restart held against its plain version (1e-12 of the
   plain result's largest entry), whole solves by kernels and by the plain
   iterations (1e-9 of max |x|), the times of one iteration's and one
   restart's kernels; then biot 1/64 for 26 steps with
   ``linear_solver="jax_bicgstab"`` and ``"jax_gmres"`` (the host Newton
   loop): 0 host fallbacks, K1 and K18 launched, u and p within 1e-8 of
   each field's largest value of phase 12's AMG run at t = 10, 18, 26, one
   more host Newton increment <= 1e-10; ms per Newton iteration, host
   assembly and solve ms, Krylov iterations per solve;
15. the constant-K flash (K17) at 2048^2 points, nc = 2 and 3, against its
   plain version (V, x, y within 1e-12, equal flags and iteration counts),
   and ``ConstantKFlash.compute_flash`` on the card;
16. the table lookup (K16) of a 201 x 201 table at 2048^2 points, inside
   and outside the table: value and four tangents against the plain
   version (1e-13 of the largest value), then ``tab(p, T)`` in an
   ``EquationSystem`` on a 1024^2 grid, evaluated and assembled on the
   card against the CPU (1e-12), with K16 launched;
17. the batched block inverse (K11) on the interaction-region matrices of
   phase 11 (3,969 blocks of 20 from biot 1/64, 1,374 of 81 from the 3d
   16^3 Biot problem), a batch with a zero leading entry and one of 160
   (device workspace): the kernel against its plain version (1e-12 of the
   plain result's largest entry), max |A X - I| per block within 1e-10
   ||A|| ||X|| (max-row-sum norms), CUDA-event times of kernel, plain
   version, ``torch.linalg.inv_ex`` and the copies; then a block-diagonal
   matrix of sizes 1-12, 20, 81 and 160 through ``invert_diagonal_blocks``
   on the card (one launch per size) against ``method="python"``;
18. the dof-sharded Newton solve (K19) on md 1/128: (a) its first Jacobian
   in the solver's ELL layout split into 4 row shards on the card, halo
   plans built in one process, ``halo_pack`` and ``ell_spmv_split`` per
   shard against K1's global product and the plain versions (phase 3's
   rule), halo sizes with and without the spatial dof permutation, times
   against ``torch.mv`` on each shard's CSR; (b) ``ShardedNewton`` in a
   one-rank NCCL group (a ``FileStore`` in a temporary directory):
   ``solve_once`` three times beside the unsharded solve of the same system
   (increments within 1e-12 relative), one time step by ``step()`` to the
   Newton tolerance against the unsharded Newton loop (1e-10), 0 host
   fallbacks, ``ell_spmv_split`` launched and K1 launched in the
   preconditioner; (c) the first K10 chunk of biot 1/64 through
   ``set_batch_mesh`` against the unsharded route (1e-12).

The line before the last is a JSON object with one entry per kernel (ms,
plain ms, the bound and what sets it, the time of one PyTorch call of the
same function where there is one); the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA card, or
without the rest of the repository beside it, the script exits non-zero
before printing either.
"""

from __future__ import annotations

import contextlib
import json
import os
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
# The least time of a kernel's work: its bytes (each input read once, each
# output written once) over the H100's 3.35 TB/s, or its operations over the
# card's peak for the type outside the tensor cores, which none of these
# kernels use: 67 TFLOP/s in f32, 34 TFLOP/s in f64 (NVIDIA's H100 SXM data
# sheet).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


def _bound(nbytes: float, flops: float, dtype=torch.float64) -> tuple[float, str]:
    """``(bound_ms, bound_by)`` of work in ``dtype`` that moves ``nbytes``
    and does ``flops`` operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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
                # The yardstick: torch.mv of the same matrix in CSR (cuSPARSE).
                real = col < N_ROWS
                crow = torch.zeros(N_ROWS + 1, dtype=torch.int64, device=dev)
                crow[1:] = torch.cumsum(real.sum(1), 0)
                csr = torch.sparse_csr_tensor(crow, col[real].long(), val[real], size=(N_ROWS, N_ROWS))
                k1.update(
                    ms=ms, plain_ms=plain_ms, library_ms=_cuda_ms(lambda: torch.mv(csr, x)),
                    bytes=val.numel() * 8 + 2 * N_ROWS * 4, flops=2 * int(real.sum()),
                    dtype=torch.float32,
                )
                print(f"    {k1['library_ms']:.4f} ms torch.mv on the CSR matrix")
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
            nnz = int((col < N_ROWS).sum())
            k2.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                      bytes=val.numel() * 8 + 4 * N_ROWS * 4, flops=2 * nnz + 3 * N_ROWS,
                      dtype=torch.float32)
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
                # hcol, g read and written, cs, sn read (j entries) and one
                # of each written; 6 operations per rotation applied.
                k4.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                          bytes=4 * (4 * (RESTART + 1) + 2 * j0 + 2), flops=6 * (j0 + 1) + 8,
                          dtype=torch.float32)
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
                # The state at the end of each block, by its time.
                self.block_states[self.time_manager.time] = self.equation_system.get_variable_values(
                    time_step_index=0
                )
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
    model.block_states = {}
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
                    inputs = [p, second] + [a for a in args if torch.is_tensor(a)]
                    n_cells = p.numel()
                    report[name].update(
                        ms=ms, plain_ms=plain_ms, library_ms=None,
                        bytes=sum(a.numel() * a.element_size() for a in inputs) + 8 * n_cells,
                        # ~40 operations per cell (3 face fluxes with their
                        # densities, the divergence, the accumulation).
                        flops=40 * n_cells,
                    )
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
    model.block_states = {}
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
    report["dense_block_scatter"] = {
        "err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
        "bytes": 4.0 * n_pad * n_pad + 12 * rows.size, "flops": 0, "dtype": torch.float32,
    }

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
            lib_ms = _cuda_ms(lambda: torch.linalg.inv_ex(ad))
            print(f"    {lib_ms:.4f} ms torch.linalg.inv_ex alone")
            report["gj_pivot_inverse"].update(
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bytes=2 * ad.numel() * 4 + batch * 4, flops=2.0 * batch * b**3,
                dtype=torch.float32,
            )

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
            lib_ms = _cuda_ms(lambda: torch.mv(D, r), 20) if D.shape[0] == ni else None
            print(f"    {lib_ms} ms torch.mv")
            report["dense_block_apply"].update(
                ms=ms, plain_ms=plain_ms, gb_s=gbs, library_ms=lib_ms,
                bytes=4.0 * ni * ni + 8 * ni, flops=2.0 * ni * ni, dtype=torch.float32,
            )
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


# -- K10 and the biot case --------------------------------------------------------

BIOT_MECH_KEYS = ("stress", "bound_stress", "bound_displacement_cell", "bound_displacement_face")
BIOT_COUPLING_KEYS = (
    "scalar_gradient", "displacement_divergence", "boundary_displacement_divergence",
    "mpsa_consistency", "bound_displacement_pressure",
)


@contextlib.contextmanager
def _local_solves(route: str):
    """Region solves by ``route`` inside the block: ``"k10"`` sets
    ``PPT_LOCAL_SOLVE_DEVICE=1`` and removes it after, ``"host"`` leaves the
    default."""
    if route == "host":
        yield
        return
    os.environ["PPT_LOCAL_SOLVE_DEVICE"] = "1"
    try:
        yield
    finally:
        del os.environ["PPT_LOCAL_SOLVE_DEVICE"]


def _capture_chunks(run) -> dict:
    """The dense ``(a, rhs, w)`` chunks that ``iter_solve_and_contract``
    builds while ``run()`` discretizes by the host route: the first chunk of
    each ``(n, m, q)`` bucket."""
    from porepy_tpu_torch.numerics.fv import local_solves as ls

    chunks = {}
    solve = ls._solve_chunk

    def record(a, rhs, w):
        chunks.setdefault((a.shape[1], rhs.shape[2], w.shape[1]), (a, rhs, w))
        return ls._solve_chunk_host(a, rhs, w)

    ls._solve_chunk = record
    try:
        run()
    finally:
        ls._solve_chunk = solve
    return chunks


def _biot_problem(pt, nx):
    """Grid and data of a ``Biot("mechanics")`` discretization on a unit
    Cartesian grid, with the inputs of the Biot matrix parity test: seeded
    moduli, alternating Dirichlet/Neumann boundary faces."""
    g = pt.CartGrid(list(nx), [1.0] * len(nx))
    g.compute_geometry()
    rng = np.random.default_rng(5 + len(nx))
    nc = g.num_cells
    bf = g.get_boundary_faces()
    d = pt.initialize_data(
        {},
        "mechanics",
        {
            "fourth_order_tensor": pt.FourthOrderTensor(rng.uniform(0.5, 2.0, nc), rng.uniform(0.5, 2.0, nc)),
            "bc": pt.BoundaryConditionVectorial(g, bf, ["dir" if i % 2 == 0 else "neu" for i in range(bf.size)]),
            "scalar_vector_mappings": {"flow": 0.8},
        },
    )
    return g, d


def _biot_matrices(g, d) -> dict:
    import porepy_tpu_torch as pt

    pt.Biot("mechanics").discretize(g, d)
    md = d[pt.DISCRETIZATION_MATRICES]["mechanics"]
    out = {k: md[k] for k in BIOT_MECH_KEYS}
    out.update({k: md[k]["flow"] for k in BIOT_COUPLING_KEYS})
    return out


def check_region_kernel(dev) -> dict:
    """K10 against its plain version on real and synthetic region batches."""
    import porepy_tpu_torch as pt
    from porepy_tpu_torch.applications.benchmarking.cases import build_biot
    from porepy_tpu_torch.kernels import ops, reference

    print("phase 11: the region-solve kernel (K10) against its plain version")
    Model, params = build_biot(1.0 / 64, device=str(dev))
    batches = [("biot 1/64", k, v) for k, v in _capture_chunks(lambda: Model(params).prepare_simulation()).items()]
    g3, d3 = _biot_problem(pt, [16, 16, 16])
    batches += [("biot 3d 16^3", k, v) for k, v in _capture_chunks(lambda: _biot_matrices(g3, d3)).items()]
    gen = np.random.default_rng(11)
    for B, n, m, q, what in ((64, 20, 12, 20, "zero leading entry"), (3, 180, 20, 30, "device workspace")):
        a = gen.standard_normal((B, n, n)) + 0.5 * n * np.eye(n)
        a *= 10.0 ** gen.uniform(-3, 3, (B, n, 1))
        a[0, 0, 0] = 0.0
        batches.append(("synthetic, " + what, (n, m, q), (a, gen.standard_normal((B, n, m)), gen.standard_normal((B, q, n)))))

    main_bucket = max(k for src, k, _ in batches if src == "biot 1/64")
    # For phases 17 and 18: the region matrices of the two real buckets
    # that K11 inverts, and the first and the largest chunks of the biot
    # discretization.
    chunks = [arrays for src, k, arrays in batches if src == "biot 1/64" and k in (batches[0][1], main_bucket)]
    report = {"err": 0.0, "buckets": [], "chunks": chunks, "real_a": [
        (src, arrays[0]) for src, k, arrays in batches
        if (src, k) == ("biot 1/64", main_bucket) or (src == "biot 3d 16^3" and k[0] == 81)
    ]}
    for source, (n, m, q), arrays in batches:
        B = arrays[0].shape[0]
        host = [torch.from_numpy(x) for x in arrays]
        a, rhs, w = (x.to(dev) for x in host)
        got = ops.region_solve(a, rhs, w)
        want = reference.region_solve_contract(a, rhs, w)
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        tag = f"region_solve {source}: B {B}, n {n}, m {m}, q {q}"
        _check(tag, torch.tensor(err), 1e-12 * scale)
        report["err"] = max(report["err"], err)
        reps = 20
        ms = _cuda_ms(lambda: ops.region_solve(a, rhs, w), reps)
        plain_ms = _cuda_ms(lambda: reference.region_solve_contract(a, rhs, w), reps)
        h2d_ms = _cuda_ms(lambda: [x.to(dev) for x in host], reps)
        d2h_ms = _cuda_ms(lambda: got.cpu(), reps)
        print(
            f"    rel err {err / scale:.3e}; {ms:.4f} ms kernel, {plain_ms:.4f} ms plain; "
            f"copies {h2d_ms:.4f} ms to the card, {d2h_ms:.4f} ms back"
        )
        report["buckets"].append(dict(source=source, B=B, n=n, m=m, q=q, ms=ms, plain_ms=plain_ms))
        if source == "biot 1/64" and (n, m, q) == main_bucket:
            # The yardstick: torch.linalg.solve and the contraction, unscaled.
            lib_ms = _cuda_ms(lambda: w @ torch.linalg.solve(a, rhs), reps)
            print(f"    {lib_ms:.4f} ms torch.linalg.solve + w @ x")
            report.update(
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bytes=8.0 * B * (n * n + n * m + q * n + q * m),
                flops=B * (2.0 / 3.0 * n**3 + 2.0 * n * n * m + 2.0 * q * n * m),
            )
    return report


def run_biot(dev, dense: bool) -> dict:
    """The biot case at 1/64 for 26 steps on ``dev``, discretized by K10."""
    import porepy_tpu_torch as pt
    from porepy_tpu_torch.applications.benchmarking.cases import build_biot
    from porepy_tpu_torch.kernels import LAUNCHES, reset_launches
    from porepy_tpu_torch.numerics.linalg.krylov import FALLBACK_COUNTER

    print(f"phase 12: biot at cell size 1/64, 26 steps on {dev}, dense_precond={dense}, discretized by K10")
    Model, params = build_biot(1.0 / 64, device=str(dev))
    params["dense_precond"] = dense
    model = timed_model(Model)(params)
    model.block_log = []
    model.block_states = {}
    disc_s = []
    discretize = model.discretize

    def timed_discretize():
        tic = time.perf_counter()
        discretize()
        torch.cuda.synchronize()
        disc_s.append(time.perf_counter() - tic)

    model.discretize = timed_discretize
    fallbacks0 = FALLBACK_COUNTER["count"]
    reset_launches()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    with _local_solves("k10"):
        model.prepare_simulation()
    model._prepared = True
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - tic
    disc_launches = LAUNCHES["region_solve"]
    tic = time.perf_counter()
    pt.run_time_dependent_model(model, params)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - tic
    launches = dict(LAUNCHES)
    model.discretize = discretize

    eq_sys = model.equation_system
    x = eq_sys.get_variable_values(time_step_index=0)
    solver = next(iter(model._device_solvers.values()))
    print(
        f"  dofs {eq_sys.num_dofs()}, setup {setup_s:.3f} s (discretization by K10 "
        f"{sum(disc_s):.3f} s, {disc_launches} launches), 26 steps {run_s:.3f} s"
    )
    for i, (secs, rec) in enumerate(model.block_log):
        print(
            f"  block {i}: {secs:.4f} s, {rec['steps']} steps, "
            f"{rec['newton_iters']} Newton, {rec['krylov_iters']} Krylov, "
            f"{1e3 * secs / max(rec['newton_iters'], 1):.2f} ms per Newton iteration"
        )
    print(f"  kernel launches in the run: {launches}")
    _require(model._ftb_blocks_committed == 3, f"blocks {model._ftb_blocks_committed}")
    _require(FALLBACK_COUNTER["count"] == fallbacks0, f"host fallbacks {FALLBACK_COUNTER}")
    _require(disc_launches > 0, "region_solve not launched in the discretization")
    needed = ("ell_spmv", "fgmres_givens") + (DENSE_KERNELS if dense else ("ell_jacobi_sweep",))
    _require(all(launches[k] > 0 for k in needed), f"kernel not launched: {launches}")
    _require(solver._dense == dense, f"dense {solver._dense}")
    if dense:
        _require(solver._builder._block_dense == {0: True, 1: True}, f"dense blocks {solver._builder._block_dense}")
    _require(bool(np.all(np.isfinite(x))), "non-finite state")
    res, inc = last_step_check(model)
    tol = 1e-10
    print(
        f"  last step on the host, plain path: |F|/sqrt(n) {res:.3e}, "
        f"next Newton increment |dx|/sqrt(n) {inc:.3e}, tolerance {tol:.0e}"
    )
    _require(inc <= tol, f"Newton increment {inc} > {tol}")
    newton = sum(rec["newton_iters"] for _s, rec in model.block_log)
    krylov = sum(rec["krylov_iters"] for _s, rec in model.block_log)
    block_s = sum(s for s, _rec in model.block_log)
    out = {
        "launches": launches,
        "setup_s": setup_s,
        "disc_k10_s": sum(disc_s),
        "ms_per_newton": 1e3 * block_s / max(newton, 1),
        "newton": newton,
        "krylov": krylov,
        "states": {**model.block_states, 26.0: eq_sys.get_variable_values(time_step_index=0)},
        "dofs": {v: eq_sys.dofs_of([v]) for v in ("u", "pressure")},
    }
    if not dense:
        # Both routes once more on the prepared model, in turns.
        for route in ("host", "k10", "host", "k10"):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            with _local_solves(route):
                model.discretize()
            torch.cuda.synchronize()
            out.setdefault(f"disc_{route}_turns", []).append(time.perf_counter() - tic)
        print(
            f"  discretization again, in turns: host LAPACK {out['disc_host_turns']} s, "
            f"K10 {out['disc_k10_turns']} s"
        )
    return out


def build_fractured_poromechanics(device: str):
    """The fractured poromechanics case of the poromechanics parity tests:
    a unit square at cell size 1/4 with one horizontal fracture, the north
    side sheared and compressed ("contact" boundary data), one time step."""
    import porepy_tpu_torch as pt

    class Model(pt.Poromechanics):
        def set_fractures(self):
            self._fractures = [pt.LineFracture(np.array([[0.25, 0.75], [0.5, 0.5]]))]

        def bc_values_displacement(self, bg):
            vals = np.zeros((self.nd, bg.num_cells))
            north = self.domain_boundary_sides(bg).north
            vals[0, north] = 0.01
            vals[1, north] = -0.005
            return vals.ravel("F")

        def bc_values_pressure(self, bg):
            return 1e-3 * (1.0 - bg.cell_centers[1])

        def initialize_data_saving(self):
            pass

        def save_data_time_step(self):
            pass

    params = {
        "grid_type": "cartesian",
        "meshing_arguments": {"cell_size": 0.25},
        "material_constants": {
            "solid": pt.SolidConstants(
                residual_aperture=0.01, normal_permeability=1.0, permeability=1.0, porosity=0.1,
            ),
            "fluid": pt.FluidComponent(compressibility=1e-3, viscosity=1.0, density=1.0),
        },
        "time_manager": pt.TimeManager([0, 1.0], 1.0, constant_dt=True),
        "linear_solver": "device_gmres",
        "device": device,
    }
    return Model(params), params


def compare_poro_small(dev) -> None:
    import porepy_tpu_torch as pt
    from porepy_tpu_torch.applications.benchmarking.cases import build_biot

    print("phase 13: poromechanics on the card against the host plain path")
    runs = {}
    for device in (str(dev), "cpu"):
        Model, params = build_biot(1.0 / 16, device=device)
        # Ten steps: at t = 26 the pressure has decayed to ~7e-12, below
        # the Newton tolerance, where a relative bound measures rounding.
        params["time_manager"] = pt.TimeManager([0, 10.0], 1.0, constant_dt=True)
        params["dense_precond"] = False
        model = Model(params)
        with _local_solves("host" if device == "cpu" else "k10"):
            model.prepare_simulation()
        model._prepared = True
        pt.run_time_dependent_model(model, params)
        _require(model._ftb_blocks_committed == 1, f"{device}: blocks committed")
        runs[device] = model
    for var in ("u", "pressure"):
        got, want = (
            runs[d].equation_system.get_variable_values([var], time_step_index=0) for d in (str(dev), "cpu")
        )
        err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
        print(f"  biot 1/16 {var}: max |card - host| {err:.3e}, max |{var}| {scale:.3e}")
        _require(err <= 1e-8 * scale, f"biot 1/16 {var}: card and host differ by {err}")

    finals = {}
    for device in (str(dev), "cpu"):
        model, params = build_fractured_poromechanics(device)
        pt.run_time_dependent_model(model, params)
        finals[device] = model
    for var in ("pressure", "u", "contact_traction", "u_interface", "interface_darcy_flux"):
        got, want = (finals[d].equation_system.get_variable_values([var], iterate_index=0) for d in (str(dev), "cpu"))
        err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
        print(f"  fractured, contact: {var}: max |card - host| {err:.3e}, max |{var}| {scale:.3e}")
        _require(bool(np.all(np.isfinite(got))), f"fractured {var} not finite")
        _require(err <= 1e-8 * scale, f"fractured {var}: card and host differ by {err}")

    mats = {}
    for route in ("k10", "host"):
        with _local_solves(route):
            mats[route] = _biot_matrices(*_biot_problem(pt, [64, 64]))
    for key, want in mats["host"].items():
        diff = abs(mats["k10"][key] - want)
        err = diff.max() if diff.nnz else 0.0
        scale = abs(want).max()
        print(f"  Biot 1/64 {key}: max |K10 - host| / max |host| {err / scale:.3e}")
        _require(err <= 1e-12 * scale, f"Biot matrix {key}: K10 and host differ by {err}")


# -- K18, K17, K16 ----------------------------------------------------------------


def _first_newton_system(dev, cell_size: float = 1.0 / 64):
    """The first Newton system of the biot case, host-assembled (scipy)."""
    from porepy_tpu_torch.applications.benchmarking.cases import build_biot

    Model, params = build_biot(cell_size, device=str(dev))
    params.pop("fused_time_steps")
    params.pop("fused_commit_states")
    params["linear_solver"] = "jax_bicgstab"
    model = Model(params)
    model.prepare_simulation()
    model.before_nonlinear_loop()
    model.before_nonlinear_iteration()
    model.assemble_linear_system()
    A, b = model.linear_system
    return A.tocsr(), np.asarray(b)


class _Holding:
    """A ``run`` hook for the fused Krylov loops: the first ``limit`` K18
    calls run by the kernel and by its plain version on copies of the same
    inputs, every tensor argument is compared (1e-12 of the plain result's
    largest entry; integer flags exactly), and the loop continues with the
    kernel's results; later calls run the kernel alone."""

    def __init__(self, limit: int):
        self.limit = limit
        self.held = 0
        self.err = {}

    def __call__(self, name, *args):
        from porepy_tpu_torch.kernels import ops, reference

        if self.held >= self.limit:
            getattr(ops, name)(*args)
            return
        self.held += 1
        copies = [[a.clone() if torch.is_tensor(a) else a for a in args] for _ in range(2)]
        getattr(ops, name)(*copies[0])
        getattr(reference, name)(*copies[1])
        for a, k, w in zip(args, *copies):
            if not torch.is_tensor(a):
                continue
            if a.dtype == torch.float64:
                err = float((k - w).abs().max()) if a.numel() else 0.0
                bound = 1e-12 * float(w.abs().max()) if a.numel() else 0.0
                _require(err <= bound, f"{name}: kernel and plain differ by {err} (bound {bound})")
                self.err[name] = max(self.err.get(name, 0.0), err)
            else:
                _require(torch.equal(k, w), f"{name}: integer outputs differ")
            a.copy_(k)


def check_krylov(dev, A, b) -> dict:
    """K18a and K18b on the biot 1/64 system: every pass of three BiCGStab
    iterations and of one GMRES restart held against its plain version,
    whole solves against the plain iterations, and times."""
    from porepy_tpu_torch.kernels import ops, reference
    from porepy_tpu_torch.numerics.ad.compiler import _device_const_matrix, _EllMat
    from porepy_tpu_torch.numerics.linalg import krylov

    n = A.shape[0]
    print(f"phase 14: the Krylov kernels (K18a, K18b) on the biot 1/64 system, n {n}, nnz {A.nnz}")
    mat = _device_const_matrix(A, dev)
    _require(isinstance(mat, _EllMat), "biot 1/64 is not in ELL layout")

    def mv(v):
        return ops.ell_spmv(mat.val, mat.col, v)

    dinv = torch.tensor(krylov._inverse_diagonal(A), device=dev)
    bt = torch.tensor(b, device=dev)
    b_dot = float(b @ b)
    tol, maxiter = 1e-12, max(200, 4 * n)
    report = {}
    for method, names, limit in (("bicgstab", ops.K18A, 2 + 3 * 8), ("gmres", ops.K18B, 2 + 94)):
        hold = _Holding(limit)
        if method == "bicgstab":
            krylov._bicgstab_fused(mv, bt, dinv, tol**2 * b_dot, maxiter, run=hold)
        else:
            krylov._gmres_fused(mv, bt, dinv, tol * np.sqrt(b_dot), maxiter, 30, run=hold)
        _require(all(name in hold.err for name in names), f"{method}: not every K18 operator was held")
        print(f"  {method}: {hold.held} calls held, max |kernel - plain| per operator {hold.err}")

        def fused():
            if method == "bicgstab":
                return krylov._bicgstab_fused(mv, bt, dinv, tol**2 * b_dot, maxiter)
            return krylov._gmres_fused(mv, bt, dinv, tol * np.sqrt(b_dot), maxiter, 30)

        def plain():
            solve = krylov.gmres if method == "gmres" else krylov.bicgstab
            kwargs = {"restart": 30} if method == "gmres" else {}
            return solve(mv, bt, tol=tol, maxiter=maxiter, M=lambda v: dinv * v, **kwargs)[0]

        times = {}
        for route in ("kernel", "plain", "kernel", "plain"):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            out = fused() if route == "kernel" else plain()
            torch.cuda.synchronize()
            times.setdefault(route, []).append(time.perf_counter() - tic)
            if route == "kernel":
                x_k, iters = out
            else:
                x_p = out
        err = float((x_k - x_p).abs().max())
        scale = float(x_p.abs().max())
        res = np.linalg.norm(b - A @ x_k.cpu().numpy()) / np.linalg.norm(b)
        print(
            f"  {method} whole solve: {iters} iterations, |b - A x| / |b| {res:.3e}, "
            f"max |kernel - plain| {err:.3e} of max |x| {scale:.3e}; "
            f"in turns kernel {times['kernel']} s, plain {times['plain']} s"
        )
        _require(err <= 1e-9 * scale, f"{method}: kernel and plain solves differ by {err}")
        report[method] = {"err": max([err] + list(hold.err.values())), "iters": iters,
                          "solve_s": times}

    # Times of one iteration's vector work (K18a) and of one restart's
    # Arnoldi and restart work (K18b), matvecs excluded, on a live state.
    nb = -(-n // reference.KRYLOV_BLOCK)
    gen = torch.Generator(device=dev).manual_seed(14)
    vec = [torch.randn(n, generator=gen, dtype=torch.float64, device=dev) for _ in range(10)]
    x, r, rhat, p, q, phat, s_, shat, t, q2 = vec
    st = torch.rand(reference.BICG_SLOTS, generator=gen, dtype=torch.float64, device=dev) + 0.5
    st[reference.BICG_EXIT] = 0.0
    partials = torch.zeros(3, nb, dtype=torch.float64, device=dev)
    cont = torch.zeros(1, dtype=torch.int32, device=dev)

    def bicgstab_iteration(lib):
        lib.bicgstab_p(r, q, dinv, st, p, phat)
        lib.krylov_dots(rhat, q2, rhat, q2, partials, 1)
        lib.bicgstab_scalars(partials, st, cont, reference.STAGE_ALPHA)
        lib.bicgstab_s(r, q2, dinv, st, s_, shat, partials)
        lib.krylov_dots(t, s_, t, t, partials[1:], 2)
        lib.bicgstab_scalars(partials, st, cont, reference.STAGE_OMEGA)
        lib.bicgstab_xr(x, r, phat, shat, s_, t, rhat, st, partials)
        lib.bicgstab_scalars(partials, st, cont, reference.STAGE_NEXT)

    snapshot = [v.clone() for v in vec] + [st.clone()]

    def restore():
        for v, v0 in zip(vec + [st], snapshot):
            v.copy_(v0)

    ms_a = _cuda_ms(lambda: (restore(), bicgstab_iteration(ops)), 50)
    plain_a = _cuda_ms(lambda: (restore(), bicgstab_iteration(reference)), 20)
    restore_ms = _cuda_ms(restore, 50)
    ms_a, plain_a = ms_a - restore_ms, plain_a - restore_ms
    # 8 input vectors (r, p, q, the new q, t, dinv, rhat, x) read and 6
    # output vectors (p, phat, s, shat, x, r) written; ~24 operations per
    # entry.
    bound_a = _bound(14 * 8.0 * n, 24.0 * n)
    print(f"  K18a, one BiCGStab iteration without its 2 matvecs: {ms_a:.4f} ms kernels (8 launches), "
          f"{plain_a:.4f} ms plain; bound {bound_a[0]:.6f} ms ({bound_a[1]})")
    report["bicgstab_step"] = {"err": report["bicgstab"]["err"], "ms": ms_a, "plain_ms": plain_a,
                               "library_ms": None, "bound": bound_a}

    R = 30
    V = torch.linalg.qr(torch.randn(n, R + 1, generator=gen, dtype=torch.float64, device=dev))[0].T.contiguous()
    av = [torch.randn(n, generator=gen, dtype=torch.float64, device=dev) for _ in range(R)]
    H = torch.empty(R, R + 1, dtype=torch.float64, device=dev)
    y = torch.empty(R, dtype=torch.float64, device=dev)
    w = torch.empty(n, dtype=torch.float64, device=dev)
    gparts = torch.zeros(R + 3, nb, dtype=torch.float64, device=dev)
    flags = torch.zeros(R + 1, dtype=torch.int32, device=dev)
    gst = torch.tensor([1e-12, 1.0], dtype=torch.float64, device=dev)
    xg = torch.zeros(n, dtype=torch.float64, device=dev)
    V0 = V.clone()

    def restart_work(lib):
        V.copy_(V0)
        flags.zero_()
        for j in range(R):
            lib.cgs_project(av[j], dinv, V, w, gparts, flags, j)
            lib.cgs_update(V, w, gparts, flags, j)
            lib.cgs_normalize(w, V, H, gparts, flags, j)
        lib.gmres_lstsq(H, gst, y)
        lib.gmres_correct(V, y, xg)
        lib.gmres_residual(bt, av[0], dinv, w, gparts)
        lib.gmres_restart(w, V, H, gparts, flags, gst, cont)

    copy_ms = _cuda_ms(lambda: (V.copy_(V0), flags.zero_()), 20)
    ms_b = _cuda_ms(lambda: restart_work(ops), 20) - copy_ms
    plain_b = _cuda_ms(lambda: restart_work(reference), 5) - copy_ms
    # In: V[0], the 30 matvec outputs, dinv, b, A x, x; out: V[1..30], x,
    # H, y. Operations: the projections and updates, 4 (k + 1) n per step.
    bound_b = _bound(8.0 * (65 * n + 2 * R * (R + 1)), 4.0 * n * R * (R + 1) / 2 + 6.0 * n * R)
    w29 = torch.randn(n, generator=gen, dtype=torch.float64, device=dev)
    proj_ms = _cuda_ms(lambda: ops.cgs_project(w29, dinv, V, w, gparts, flags, R - 1))
    mv_ms = _cuda_ms(lambda: torch.mv(V, w29))
    print(f"  K18b, one GMRES(30) restart without its 31 matvecs: {ms_b:.4f} ms kernels (94 launches), "
          f"{plain_b:.4f} ms plain; bound {bound_b[0]:.6f} ms ({bound_b[1]}); "
          f"cgs_project at k = 29 {proj_ms:.4f} ms, torch.mv(V, w) {mv_ms:.4f} ms")
    report["gmres_arnoldi"] = {"err": report["gmres"]["err"], "ms": ms_b, "plain_ms": plain_b,
                               "library_ms": None, "bound": bound_b}
    return report


def run_biot_krylov(dev, method: str, device_gmres: dict, cell_size: float = 1.0 / 64) -> dict:
    """biot 1/64 for 26 steps with ``linear_solver="jax_<method>"``: the
    per-step host Newton loop, host assembly, K18 solves on the card; its
    states against those of the ``device_gmres`` run (phase 12) at the ends
    of that run's fused blocks (t = 10, 18, 26)."""
    import scipy.sparse.linalg as sps_linalg

    import porepy_tpu_torch as pt
    from porepy_tpu_torch.applications.benchmarking.cases import build_biot
    from porepy_tpu_torch.kernels import LAUNCHES, ops, reset_launches
    from porepy_tpu_torch.numerics.linalg import krylov

    solver = "jax_" + method
    print(f"phase 14: biot at cell size {cell_size:g}, 26 steps on {dev}, linear_solver={solver}")
    Model, params = build_biot(cell_size, device=str(dev))
    params.pop("fused_time_steps")
    params.pop("fused_commit_states")
    params["linear_solver"] = solver
    log = {"assemble": [], "solve": [], "iters": [], "steps": 0, "states": {}}
    reference_states = device_gmres["states"]

    class Logged(Model):
        def assemble_linear_system(self):
            tic = time.perf_counter()
            super().assemble_linear_system()
            log["assemble"].append(time.perf_counter() - tic)

        def solve_linear_system(self):
            tic = time.perf_counter()
            x = super().solve_linear_system()
            log["solve"].append(time.perf_counter() - tic)
            log["iters"].append(krylov.LAST_SOLVE["iterations"])
            return x

        def after_nonlinear_convergence(self):
            log["steps"] += 1
            if log["steps"] == 26:
                # One more Newton increment at the converged state of the
                # last step, by a direct host solve.
                A, b = self.equation_system.assemble()
                dx = sps_linalg.spsolve(A.tocsc(), b)
                log["increment"] = float(np.linalg.norm(dx) / np.sqrt(dx.size))
            super().after_nonlinear_convergence()
            if float(self.time_manager.time) in reference_states:
                log["states"][float(self.time_manager.time)] = self.equation_system.get_variable_values(
                    time_step_index=0
                )

    model = Logged(params)
    fallbacks0 = krylov.FALLBACK_COUNTER["count"]
    tic = time.perf_counter()
    model.prepare_simulation()
    model._prepared = True
    setup_s = time.perf_counter() - tic
    reset_launches()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    pt.run_time_dependent_model(model, params)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - tic
    launches = dict(LAUNCHES)
    eq_sys = model.equation_system
    newton = len(log["solve"])
    iters = np.array(log["iters"])
    print(
        f"  dofs {eq_sys.num_dofs()}, setup {setup_s:.3f} s, 26 steps {run_s:.3f} s, {newton} Newton iterations, "
        f"{1e3 * run_s / max(newton, 1):.2f} ms per Newton iteration; per Newton iteration host assembly "
        f"{1e3 * np.mean(log['assemble']):.2f} ms, solve {1e3 * np.mean(log['solve']):.2f} ms; Krylov "
        f"iterations per solve mean {iters.mean():.1f}, min {iters.min()}, max {iters.max()}"
    )
    print(f"  kernel launches in the run: {launches}")
    names = ops.K18A if method == "bicgstab" else ops.K18B
    _require(krylov.FALLBACK_COUNTER["count"] == fallbacks0, f"host fallbacks {krylov.FALLBACK_COUNTER}")
    _require(launches["ell_spmv"] > 0 and all(launches[k] > 0 for k in names), f"kernel not launched: {launches}")
    _require(log["steps"] == 26, f"{log['steps']} steps")
    # Each field within 1e-8 of its largest value over the three states: by
    # t = 26 the pressure has decayed to ~7e-12, below what the Newton
    # tolerance (1e-10) resolves, and a bound relative to that state's own
    # maximum would measure rounding (1e-17 absolute apart on the CPU at
    # 1/16 and 1/64), so the pressure's scale is its t = 10 maximum.
    _require(sorted(log["states"]) == sorted(reference_states), f"states at {sorted(log['states'])}")
    for var, dofs in device_gmres["dofs"].items():
        scale = max(float(np.abs(x[dofs]).max()) for x in reference_states.values())
        for t, want in sorted(reference_states.items()):
            got = log["states"][t][dofs]
            err = float(np.abs(got - want[dofs]).max())
            print(f"  t = {t:g}, {var}: max |{solver} - device_gmres| {err:.3e}, max |{var}| "
                  f"{float(np.abs(want[dofs]).max()):.3e} (scale {scale:.3e})")
            _require(err <= 1e-8 * scale, f"{solver} {var} at t = {t} differs from device_gmres by {err}")
    tol = 1e-10
    print(f"  last step on the host: next Newton increment |dx|/sqrt(n) {log['increment']:.3e}, tolerance {tol:.0e}")
    _require(log["increment"] <= tol, f"Newton increment {log['increment']} > {tol}")
    return {
        "launches": sum(launches[k] for k in names), "ms_per_newton": 1e3 * run_s / max(newton, 1),
        "newton": newton, "iters_mean": float(iters.mean()), "assemble_ms": 1e3 * np.mean(log["assemble"]),
        "solve_ms": 1e3 * np.mean(log["solve"]), "run_s": run_s,
    }


N_POINTS = 2048 * 2048
NX_TABLE = 1024


def _fluid(pt, nc):
    from porepy_tpu_torch.compositional._core import PhysicalState
    from porepy_tpu_torch.compositional.base import Fluid, Phase

    comps = [pt.FluidComponent(name=f"c{i}") for i in range(nc)]
    phases = [Phase(PhysicalState.liquid, "liquid"), Phase(PhysicalState.gas, "gas")]
    for ph in phases:
        ph.components = comps
    return Fluid(comps, phases)


def check_flash(dev) -> dict:
    """K17 at 2048^2 points against its plain version, and ConstantKFlash
    through its public entry point on the card."""
    import porepy_tpu_torch as pt
    from porepy_tpu_torch.kernels import LAUNCHES, ops, reference, reset_launches

    print(f"phase 15: the constant-K flash (K17) at {N_POINTS} points")
    report = {"err": 0.0}
    for K in ([2.5, 0.3], [3.0, 0.8, 0.2]):
        nc = len(K)
        raw = np.random.default_rng(15 + nc).random((nc, N_POINTS)) + 0.02
        z_host = raw / raw.sum(axis=0)
        zs = torch.tensor(z_host, device=dev)
        Kt = torch.tensor(K, dtype=torch.float64, device=dev)
        got = ops.rachford_rice(zs, Kt, 150, 1e-8)
        want = reference.rachford_rice(zs, Kt, 150, 1e-8)
        for tag, g, w in zip(("V", "x", "y"), got[:3], want[:3]):
            err = _check(f"rachford_rice nc {nc} {tag}", (g - w).abs(), torch.tensor(1e-12, device=dev))
            report["err"] = max(report["err"], err)
        _require(torch.equal(got[3], want[3]), f"nc {nc}: converged flags differ")
        _require(torch.equal(got[4], want[4]), f"nc {nc}: iteration counts differ")
        iters = got[4].long()
        ms = _cuda_ms(lambda: ops.rachford_rice(zs, Kt, 150, 1e-8), 10)
        plain_ms = _cuda_ms(lambda: reference.rachford_rice(zs, Kt, 150, 1e-8), 2)
        copy_ms = _cuda_ms(lambda: torch.tensor(z_host, device=dev), 5)
        back_ms = _cuda_ms(lambda: [a.cpu() for a in got[:4]], 5)
        # Per iteration 9 nc + 5 operations, per point 11 nc + 12 around the
        # iterations; bytes: z in, V, x, y, the flags and counts out.
        flops = float(iters.sum()) * (9 * nc + 5) + N_POINTS * (11 * nc + 12)
        bound = _bound(8.0 * (3 * nc + 1) * N_POINTS + 5.0 * N_POINTS, flops)
        two_phase = int(((got[0] > 0) & (got[0] < 1)).sum())
        print(
            f"    {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, copies {copy_ms:.4f} ms to the card, "
            f"{back_ms:.4f} ms back; {two_phase} two-phase points, {int(iters.sum())} iterations "
            f"(mean {float(iters.float().mean()):.2f}, max {int(iters.max())}); bound {bound[0]:.4f} ms ({bound[1]})"
        )
        if nc == 3:
            report.update(ms=ms, plain_ms=plain_ms, library_ms=None, bound=bound)
        reset_launches()
        flash = pt.ConstantKFlash(_fluid(pt, nc), K)
        state, success, _ = flash.compute_flash(list(z_host))
        launches = LAUNCHES["rachford_rice"]
        _require(launches > 0, "ConstantKFlash did not launch K17")
        _require(np.array_equal(state.y[1], got[0].cpu().numpy()), "compute_flash V differs from the kernel's")
        _require(np.array_equal(success == 0, got[3].cpu().numpy()), "compute_flash flags differ")
        print(f"  ConstantKFlash.compute_flash on {flash.device}, nc {nc}: {launches} launch, "
              f"{int((success == 0).sum())} of {success.size} converged")
        report["launches"] = launches
    return report


def _table_fn(p, T):
    return np.log(p + 1e6) * np.exp(-T / 300.0) + 1e-8 * p * np.sin(T / 20.0)


TABLE = ([1e5, 280.0], [5e7, 480.0], [201, 201])


def _table_system(pt, nx, device):
    from porepy_tpu_torch.grids.md_grid import MixedDimensionalGrid

    g = pt.CartGrid([nx, nx], physdims=[1.0, 1.0])
    g.compute_geometry()
    mdg = MixedDimensionalGrid()
    mdg.add_subdomains(g)
    mdg.compute_geometry()
    es = pt.ad.EquationSystem(mdg, device=device)
    p = es.create_variables("pressure", dof_info={"cells": 1}, subdomains=[g])
    T = es.create_variables("temperature", dof_info={"cells": 1}, subdomains=[g])
    rng = np.random.default_rng(16)
    (lo_p, lo_T), (hi_p, hi_T), _ = TABLE
    # A tenth of the span beyond each side of the table on both axes.
    es.set_variable_values(rng.uniform(lo_p - 0.1 * (hi_p - lo_p), hi_p + 0.1 * (hi_p - lo_p), g.num_cells), ["pressure"], iterate_index=0)
    es.set_variable_values(rng.uniform(lo_T - 0.1 * (hi_T - lo_T), hi_T + 0.1 * (hi_T - lo_T), g.num_cells), ["temperature"], iterate_index=0)
    fun = pt.ad.InterpolatedFunction(_table_fn, "tab", *TABLE)
    op = fun(p, T)
    op.set_name("table_equation")
    es.set_equation(op, [g], {"cells": 1})
    return es, op, fun


def check_lookup(dev) -> dict:
    """K16 at 2048^2 points against its plain version, then inside an
    EquationSystem on a 1024^2 grid on the card against the CPU."""
    import porepy_tpu_torch as pt
    from porepy_tpu_torch.kernels import LAUNCHES, ops, reference, reset_launches

    print(f"phase 16: the table lookup (K16), a 201 x 201 table at {N_POINTS} points")
    fun = pt.ad.InterpolatedFunction(_table_fn, "tab", *TABLE)
    tab = fun.device_table(dev)
    rng = np.random.default_rng(17)
    lo, hi = np.array(TABLE[0]), np.array(TABLE[1])
    span = hi - lo
    x = torch.tensor(rng.uniform(lo - 0.1 * span, hi + 0.1 * span, (N_POINTS, 2)).T.copy(), device=dev)
    dx = torch.tensor(rng.standard_normal((4, 2, N_POINTS)) * span[None, :, None] * 1e-3, device=dev)
    args = (tab["values"], tab["fgeom"], tab["igeom"], x)
    outside = int(((x < torch.tensor(lo, device=dev)[:, None]) | (x > torch.tensor(hi, device=dev)[:, None])).any(0).sum())
    report = {"err": 0.0}
    for tag, kern, plain in (
        ("value", lambda: ops.interp_lookup(*args), lambda: reference.interp_lookup(*args)),
        ("tangent B=4", lambda: ops.interp_tangent(*args, dx), lambda: reference.interp_tangent(*args, dx)),
    ):
        got, want = kern(), plain()
        err = _check(f"interp_lookup {tag} ({outside} points outside the table)",
                     (got - want).abs(), 1e-13 * want.abs().max())
        report["err"] = max(report["err"], err)
        ms, plain_ms = _cuda_ms(kern, 20), _cuda_ms(plain, 5)
        n_seeds = dx.shape[0] if tag != "value" else 0
        # Bytes: the 2 coordinates and 2 B seed entries in, 1 or B results
        # out, the table once. Operations: ~20 per point for the cell and
        # the 4 weights, ~36 per seed for the weight tangents and sums.
        bound = _bound(
            8.0 * N_POINTS * (2 + 2 * n_seeds + max(n_seeds, 1)) + tab["values"].numel() * 8,
            N_POINTS * (20.0 + 36.0 * n_seeds),
        )
        print(f"    {ms:.4f} ms kernel, {plain_ms:.4f} ms plain; bound {bound[0]:.4f} ms ({bound[1]})")
        if tag != "value":
            report.update(ms=ms, plain_ms=plain_ms, library_ms=None, bound=bound)

    nx = NX_TABLE
    out = {}
    for device in (str(dev), "cpu"):
        es, op, _fun = _table_system(pt, nx, device)
        reset_launches()
        tic = time.perf_counter()
        val = es.evaluate(op)
        data, b, _cs = es.assemble_device()
        data = data.cpu().numpy()
        out[device] = (val, data, b.cpu().numpy(), time.perf_counter() - tic, LAUNCHES["interp_lookup"])
    for i, tag in ((0, "evaluate"), (1, "Jacobian"), (2, "residual")):
        got, want = out[str(dev)][i], out["cpu"][i]
        err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
        print(f"  EquationSystem {nx}^2, {tag}: max |card - cpu| {err:.3e}, max {scale:.3e}")
        _require(err <= 1e-12 * scale, f"{tag}: card and cpu differ by {err}")
    launches = out[str(dev)][4]
    print(f"  evaluate + assembly on the card {out[str(dev)][3]:.3f} s, on the CPU {out['cpu'][3]:.3f} s; K16 launches {launches}")
    _require(launches > 0, "the EquationSystem run did not launch K16")
    report["launches"] = launches
    return report


# -- K11, K19 ---------------------------------------------------------------------


def _inf_norm(m: torch.Tensor) -> torch.Tensor:
    return m.abs().sum(2).amax(1)


def check_block_inverse(dev, real) -> dict:
    """K11 on the real region matrices and two synthetic batches against
    its plain version, then ``invert_diagonal_blocks`` on the card."""
    import scipy.sparse as sps

    from porepy_tpu_torch.kernels import LAUNCHES, ops, reference, reset_launches
    from porepy_tpu_torch.numerics.linalg.matrix_operations import invert_diagonal_blocks

    print("phase 17: the batched block inverse (K11) against its plain version")
    gen = np.random.default_rng(17)
    batches = list(real)
    a = gen.standard_normal((64, 20, 20)) + 10.0 * np.eye(20)
    a[0, 0, 0] = 0.0
    batches.append(("synthetic, zero leading entry", a))
    batches.append(("synthetic, device workspace", gen.standard_normal((3, 160, 160)) + 80.0 * np.eye(160)))
    report = {"err": 0.0}
    for source, arr in batches:
        B, n = arr.shape[0], arr.shape[1]
        host = torch.from_numpy(np.ascontiguousarray(arr))
        A = host.to(dev)
        X = ops.block_inverse(A)
        W = reference.block_inverse(A)
        err = float((X - W).abs().max())
        scale = float(W.abs().max())
        _check(f"block_inverse {source}: B {B}, n {n}", torch.tensor(err), 1e-12 * scale)
        report["err"] = max(report["err"], err)
        eye = torch.eye(n, dtype=A.dtype, device=dev)
        resid = (A @ X - eye).abs().amax(dim=(1, 2))
        worst = float((resid / (_inf_norm(A) * _inf_norm(X))).max())
        print(f"    max |A X - I| / (||A|| ||X||) {worst:.3e} (bound 1e-10)")
        _require(worst <= 1e-10, f"block_inverse {source}: residual {worst}")
        reps = 20
        ms = _cuda_ms(lambda: ops.block_inverse(A), reps)
        plain_ms = _cuda_ms(lambda: reference.block_inverse(A), reps)
        lib_ms = _cuda_ms(lambda: torch.linalg.inv_ex(A), reps)
        h2d_ms = _cuda_ms(lambda: host.to(dev), reps)
        d2h_ms = _cuda_ms(lambda: X.cpu(), reps)
        nbytes, flops = 2 * 8.0 * B * n * n, 2.0 * B * n**3
        bound = _bound(nbytes, flops)
        print(
            f"    {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, {lib_ms:.4f} ms torch.linalg.inv_ex; "
            f"bound {bound[0]:.4f} ms ({bound[1]}); copies {h2d_ms:.4f} ms to the card, {d2h_ms:.4f} ms back"
        )
        if source == "biot 3d 16^3":
            report.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound=bound)

    # The entry point on one block-diagonal matrix of both real sizes and
    # a few odd ones, seeded and well conditioned (cond < 10), so that
    # Gauss-Jordan and LAPACK's LU inverse agree to rounding.
    sizes = np.array(list(range(1, 13)) + [20] * 6 + [81] * 4 + [160])
    sizes = sizes[gen.permutation(sizes.size)]
    mat = sps.block_diag([sps.csr_matrix(gen.standard_normal((k, k)) + k * np.eye(k)) for k in sizes], format="csr")
    reset_launches()
    got = invert_diagonal_blocks(mat, sizes)
    torch.cuda.synchronize()
    launches = LAUNCHES["block_inverse"]
    want = invert_diagonal_blocks(mat, sizes, method="python")
    err = float(abs(got - want).max())
    scale = float(abs(want).max())
    print(f"  invert_diagonal_blocks, {sizes.size} blocks of {np.unique(sizes).size} sizes (n {mat.shape[0]}): "
          f"max |card - python| {err:.3e}, max {scale:.3e}; K11 launches {launches}")
    _require(err <= 1e-12 * scale, f"invert_diagonal_blocks: card and python differ by {err}")
    _require(launches == np.unique(sizes).size, f"K11 launches {launches}")
    report["launches"] = launches
    return report


def check_halo_kernels(dev, model, n_shards: int = 4) -> dict:
    """Phase 18a: md 1/128's first Jacobian in 4 row shards on the card."""
    from porepy_tpu_torch.kernels import LAUNCHES, ops, reference, reset_launches
    from porepy_tpu_torch.numerics.linalg.device_solver import DeviceLinearSolver
    from porepy_tpu_torch.parallel import halo
    from porepy_tpu_torch.parallel.placement import PermutedSystem, nnz_locality, spatial_dof_permutation

    eq = model.equation_system
    cs = eq.compiled_system()
    solver = model._device_solver_for(cs)
    data, _b = cs.assemble(eq)
    n = solver.n
    val64 = torch.cat([data, data.new_zeros(1)])[solver._ell_sel]
    col = solver._ell_col
    plans = halo.local_plans(col.cpu().numpy(), n, n_shards)
    print(f"phase 18a: md 1/128's Jacobian (n {n}, K {col.shape[1]}) in {n_shards} row shards on the card")
    perm, _ = spatial_dof_permutation(eq, model.mdg, n_shards)
    psys = PermutedSystem(cs, perm)
    psys.device = cs.device
    pplans = halo.local_plans(DeviceLinearSolver(psys)._ell_col.cpu().numpy(), n, n_shards)
    print(f"  rows per shard {[p.n_own for p in plans]}; halo entries per shard {[p.n_halo for p in plans]}, "
          f"with the spatial permutation {[p.n_halo for p in pplans]}; nnz locality "
          f"{nnz_locality(cs, n_shards):.4f}, with it {nnz_locality(cs, n_shards, perm):.4f}")
    cols = [torch.tensor(p.col, device=dev) for p in plans]
    idx = [torch.tensor(p.send_idx, device=dev) for p in plans]
    gen = torch.Generator().manual_seed(18)
    report = {"halo_pack": {"err": 0.0}, "ell_spmv_split": {"err": 0.0}}
    for dtype in (torch.float64, torch.float32):
        val = val64.to(dtype)
        x = torch.randn(n, generator=gen, dtype=torch.float64).to(dtype).to(dev)
        own = [x[p.lo : p.hi] for p in plans]
        vals = [val[p.lo : p.hi] for p in plans]

        def run(pack, spmv):
            sends = [pack(o, i) for o, i in zip(own, idx)]
            halos = halo.exchange_local(plans, sends)
            return sends, halos, [spmv(v, c, o, h) for v, c, o, h in zip(vals, cols, own, halos)]

        reset_launches()
        sends, halos, ys = run(ops.halo_pack, ops.ell_spmv_split)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        p_sends, _p_halos, p_ys = run(reference.halo_pack, reference.ell_spmv_split)
        tag = str(dtype)[6:]
        pack_err = max(float((a - b).abs().max()) for a, b in zip(sends, p_sends))
        _check(f"halo_pack {tag}, {n_shards} shards", torch.tensor(pack_err), 0.0)
        got = torch.cat(ys)
        absx = torch.cat([x.abs(), x.new_zeros(1)])
        rowsum = (val.abs() * absx[col]).sum(-1)
        k1 = ops.ell_spmv(val, col, x)
        err = max(
            _check(f"ell_spmv_split {tag}, {n_shards} shards, against K1", (got - k1).abs(), TOL[dtype] * rowsum),
            _check(f"ell_spmv_split {tag} against its plain version", (got - torch.cat(p_ys)).abs(), TOL[dtype] * rowsum),
        )
        report["halo_pack"]["err"] = max(report["halo_pack"]["err"], pack_err)
        report["ell_spmv_split"]["err"] = max(report["ell_spmv_split"]["err"], err)
        if dtype != torch.float32:
            continue
        # The inner Krylov matvec is f32: time it, per call over the shards.
        csrs = []
        for p, v, c in zip(plans, vals, cols):
            real = c < p.n_own + p.n_halo
            crow = torch.zeros(p.n_own + 1, dtype=torch.int64, device=dev)
            crow[1:] = torch.cumsum(real.sum(1), 0)
            csrs.append(torch.sparse_csr_tensor(crow, c[real].long(), v[real], size=(p.n_own, p.n_own + p.n_halo)))
        xcat = [torch.cat([o, h]) for o, h in zip(own, halos)]
        per = 1.0 / n_shards
        t = {
            "split": _cuda_ms(lambda: [ops.ell_spmv_split(v, c, o, h) for v, c, o, h in zip(vals, cols, own, halos)]) * per,
            "split_plain": _cuda_ms(lambda: [reference.ell_spmv_split(v, c, o, h) for v, c, o, h in zip(vals, cols, own, halos)]) * per,
            "split_lib": _cuda_ms(lambda: [torch.mv(m, xc) for m, xc in zip(csrs, xcat)]) * per,
            "pack": _cuda_ms(lambda: [ops.halo_pack(o, i) for o, i in zip(own, idx)]) * per,
            "pack_plain": _cuda_ms(lambda: [reference.halo_pack(o, i) for o, i in zip(own, idx)]) * per,
            "pack_lib": _cuda_ms(lambda: [torch.index_select(o, 0, i) for o, i in zip(own, idx)]) * per,
        }
        print(f"    per shard call, f32: ell_spmv_split {t['split']:.4f} ms, plain {t['split_plain']:.4f}, "
              f"torch.mv on the CSR {t['split_lib']:.4f}; halo_pack {t['pack']:.4f} ms, plain {t['pack_plain']:.4f}, "
              f"torch.index_select {t['pack_lib']:.4f}")
        nnz = sum(int((c < p.n_own + p.n_halo).sum()) for p, c in zip(plans, cols))
        n_send = sum(len(p.send_idx) for p in plans)
        # Per call, the mean over the shards: val and col (K entries a row)
        # read, x_own and the halo read, y written; 2 operations a nonzero.
        report["ell_spmv_split"].update(
            ms=t["split"], plain_ms=t["split_plain"], library_ms=t["split_lib"],
            bound=_bound(per * (n * col.shape[1] * 8 + 2 * n * 4 + sum(p.n_halo for p in plans) * 4),
                         per * 2 * nnz, torch.float32),
        )
        report["halo_pack"].update(
            ms=t["pack"], plain_ms=t["pack_plain"], library_ms=t["pack_lib"],
            bound=_bound(per * n_send * 12, 0, torch.float32), launches=launches["halo_pack"],
        )
    print(f"  launches of the four shards' matvec: halo_pack {report['halo_pack']['launches']}")
    _require(report["halo_pack"]["launches"] > 0, "halo_pack not launched")
    return report


def _newton_time_step(model, step, max_iter: int = 10) -> tuple[np.ndarray, int]:
    """Newton iterations by ``step()`` until the increment is below the
    model's tolerance; returns the state and the iteration count."""
    tol = model.params.get("nl_convergence_tol", 1e-10)
    for it in range(1, max_iter + 1):
        model.before_nonlinear_iteration()
        dx, _res = step()
        if model.compute_nonlinear_increment_norm(dx) < tol:
            return model.equation_system.get_variable_values(iterate_index=0), it
    raise RuntimeError(f"chip_smoke check failed: no Newton convergence in {max_iter} iterations")


def run_sharded(dev, chunks) -> dict:
    """Phase 18: the K19 kernels at 4 row shards, ``ShardedNewton`` on md
    1/128 in a one-rank NCCL group, and the sharded region batches."""
    import tempfile

    import torch.distributed as dist

    from porepy_tpu_torch.applications.benchmarking.cases import build_md_flow
    from porepy_tpu_torch.kernels import LAUNCHES, reset_launches
    from porepy_tpu_torch.numerics.fv import local_solves
    from porepy_tpu_torch.numerics.linalg.krylov import FALLBACK_COUNTER
    from porepy_tpu_torch.parallel.sharded import ShardedNewton, make_dof_mesh

    print("phase 18: the dof-sharded Newton solve (K19) on md 1/128")
    Model, params = build_md_flow(1.0 / 128, device=str(dev))
    model = Model(params)
    model.prepare_simulation()
    model.before_nonlinear_loop()
    model.before_nonlinear_iteration()
    eq = model.equation_system
    x0 = eq.get_variable_values(iterate_index=0)
    kernels = check_halo_kernels(dev, model)

    def timed(fn):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - tic)

    # NCCL's bootstrap socket stays on the loopback: the group has one rank.
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    launches = dict.fromkeys(LAUNCHES, 0)
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1, device_id=dev)
        try:
            mesh = make_dof_mesh()
            print(f"phase 18b: ShardedNewton in a one-rank NCCL group on {mesh.device}")
            fallbacks0 = FALLBACK_COUNTER["count"]

            def counted(fn):
                """``fn()`` with the launches it makes added to the sharded
                path's counts (the unsharded runs between are not)."""
                reset_launches()
                out = fn()
                torch.cuda.synchronize()
                for k, v in LAUNCHES.items():
                    launches[k] += v
                return out

            sn = ShardedNewton(model, mesh)
            (dx_s, res_s), first_ms = counted(lambda: timed(sn.solve_once))

            def unsharded_once():
                data, b = sn.assemble()
                return sn.solver.solve(data, b)

            dx_u, _ = timed(unsharded_once)
            sharded_ms, unsharded_ms = [], []
            for sharded_first in (True, False, True):
                for is_sharded in (sharded_first, not sharded_first):
                    if is_sharded:
                        sharded_ms.append(counted(lambda: timed(sn.solve_once))[1])
                    else:
                        unsharded_ms.append(timed(unsharded_once)[1])
            dx_diff = float(np.abs(dx_s - dx_u).max())
            scale = float(np.abs(dx_u).max())
            print(f"  solve_once {first_ms:.2f} ms first, then {[round(t, 2) for t in sharded_ms]} ms; unsharded "
                  f"assembly + solve {[round(t, 2) for t in unsharded_ms]} ms; |r| {res_s:.3e}, "
                  f"{sn.solver.last_stats['krylov_iters']} Krylov iterations")
            print(f"  increments: max |sharded - unsharded| {dx_diff:.3e} (max |dx| {scale:.3e}; bit-equal: {dx_diff == 0.0})")
            _require(dx_diff <= 1e-12 * scale, f"sharded and unsharded increments differ by {dx_diff}")

            x_s, newton = counted(lambda: _newton_time_step(model, sn.step))
            eq.set_variable_values(x0, iterate_index=0)
            model.update_derived_quantities()

            def unsharded_step():
                data, b = sn.assemble()
                dx = sn.solver.solve(data, b)
                model.after_nonlinear_iteration(dx)
                return dx, None

            x_u, newton_u = _newton_time_step(model, unsharded_step)
            state_diff = float(np.abs(x_s - x_u).max())
            fallbacks = FALLBACK_COUNTER["count"] - fallbacks0
            print(f"  one time step: {newton} Newton iterations sharded, {newton_u} unsharded; max |state "
                  f"difference| {state_diff:.3e}; host fallbacks {fallbacks}")
            print(f"  kernel launches of the sharded runs: ell_spmv_split {launches['ell_spmv_split']}, "
                  f"ell_spmv (K1, the preconditioner) {launches['ell_spmv']}, halo_pack {launches['halo_pack']}")
            _require(state_diff <= 1e-10, f"sharded and unsharded states differ by {state_diff}")
            _require(fallbacks == 0, f"host fallbacks {fallbacks}")
            _require(launches["ell_spmv_split"] > 0, "ell_spmv_split not launched")
            _require(launches["ell_spmv"] > 0, "K1 not launched in the preconditioner")

            print("phase 18c: the first and the largest K10 chunks of biot 1/64 through set_batch_mesh")
            for chunk in chunks:
                local_solves.set_batch_mesh(mesh)
                try:
                    got = local_solves._solve_chunk_device(*chunk)
                finally:
                    local_solves.set_batch_mesh(None)
                want = local_solves._solve_chunk_device(*chunk)
                err = float(np.abs(got - want).max())
                print(f"  B {chunk[0].shape[0]}, n {chunk[0].shape[1]}: max |sharded - unsharded| {err:.3e}")
                _require(err <= 1e-12 * float(np.abs(want).max()), f"sharded region batch differs by {err}")
        finally:
            dist.destroy_process_group()
    return {
        "kernels": kernels,
        "launches": launches,
        "sharded_ms": float(np.median(sharded_ms)),
        "unsharded_ms": float(np.median(unsharded_ms)),
        "dx_diff": dx_diff,
        "newton": newton,
    }


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
    report["region_solve"] = check_region_kernel(dev)
    biot = run_biot(dev, dense=False)
    biot_dense = run_biot(dev, dense=True)
    compare_poro_small(dev)
    report.update(check_krylov(dev, *_first_newton_system(dev)))
    bicg = run_biot_krylov(dev, "bicgstab", biot)
    gmres = run_biot_krylov(dev, "gmres", biot)
    report["rachford_rice"] = check_flash(dev)
    report["interp_lookup"] = check_lookup(dev)
    tic = time.perf_counter()
    report["block_inverse"] = check_block_inverse(dev, report["region_solve"].pop("real_a"))
    sharded = run_sharded(dev, report["region_solve"].pop("chunks"))
    report.update(sharded["kernels"])
    print(f"phases 17-18 took {time.perf_counter() - tic:.1f} s")

    csrc = "porepy_tpu_torch/kernels/csrc/"
    kernels = {
        "ell_spmv": ("ell_spmv.cu", "porepy_tpu/numerics/linalg/amg.py:59", md["launches"]["ell_spmv"]),
        "ell_jacobi_sweep": ("ell_jacobi_sweep.cu", "porepy_tpu/numerics/linalg/amg.py:334", md["launches"]["ell_jacobi_sweep"]),
        "fgmres_givens": ("fgmres_givens.cu", "porepy_tpu/numerics/linalg/device_solver.py:198", md["launches"]["fgmres_givens"]),
        "dense_block_scatter": ("dense_block.cu", "porepy_tpu/numerics/linalg/device_solver.py:141", d3["launches"]["dense_block_scatter"]),
        "gj_pivot_inverse": ("dense_block.cu", "porepy_tpu/numerics/linalg/device_solver.py:104", d3["launches"]["gj_pivot_inverse"]),
        "dense_block_apply": ("dense_block.cu", "porepy_tpu/numerics/linalg/device_solver.py:702", d3["launches"]["dense_block_apply"]),
        "structured_residual": ("structured_flow.cu", "porepy_tpu/parallel/structured_flow.py:69", flow["structured_launches"]["structured_residual"]),
        "structured_jvp": ("structured_flow.cu", "porepy_tpu/parallel/structured_flow.py:116", flow["structured_launches"]["structured_jvp"]),
        "tpfa_residual": ("tpfa_flow.cu", "porepy_tpu/parallel/flow_step.py:72", flow["tpfa_launches"]["tpfa_residual"]),
        "tpfa_jvp": ("tpfa_flow.cu", "porepy_tpu/parallel/flow_step.py:104", flow["tpfa_launches"]["tpfa_jvp"]),
        "region_solve": ("region_solve.cu", "porepy_tpu/numerics/fv/local_solves.py:168", biot["launches"]["region_solve"]),
        "bicgstab_step": ("krylov.cu", "porepy_tpu/numerics/linalg/krylov.py:42", bicg["launches"]),
        "gmres_arnoldi": ("krylov.cu", "porepy_tpu/numerics/linalg/krylov.py:42", gmres["launches"]),
        "rachford_rice": ("flash.cu", "porepy_tpu/compositional/flash.py:80", report["rachford_rice"]["launches"]),
        "interp_lookup": ("interp_lookup.cu", "porepy_tpu/numerics/ad/operator_functions.py:117", report["interp_lookup"]["launches"]),
        "block_inverse": ("block_inverse.cu", "porepy_tpu/numerics/linalg/matrix_operations.py:105", report["block_inverse"]["launches"]),
        # A one-rank group has no halo: halo_pack's launches are those of
        # the four row shards of phase 18a.
        "halo_pack": ("halo_spmv.cu", "porepy_tpu/numerics/linalg/device_solver.py:947", report["halo_pack"]["launches"]),
        "ell_spmv_split": ("halo_spmv.cu", "porepy_tpu/numerics/linalg/device_solver.py:947", sharded["launches"]["ell_spmv_split"]),
    }
    entries = []
    for k, (src, replaces, launches) in kernels.items():
        r = report[k]
        bound_ms, bound_by = r["bound"] if "bound" in r else _bound(
            r["bytes"], r["flops"], r.get("dtype", torch.float64)
        )
        entries.append({
            "name": k, "route": "cuda", "source": csrc + src, "replaces": replaces,
            "launches": launches, "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": r["library_ms"],
        })
    kernels_line = {"kernels": entries}
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
    for tag, b in (("AMG", biot), ("dense", biot_dense)):
        print(
            f"biot 1/64 on {smi}, {tag}: setup {b['setup_s']:.3f} s (discretization by K10 "
            f"{b['disc_k10_s']:.3f} s), {b['ms_per_newton']:.2f} ms per Newton iteration, "
            f"{b['newton']} Newton / {b['krylov']} Krylov in the blocks (reference CPU: 567 ms)"
        )
    print(f"biot 1/64 discretization in turns on {smi}: host LAPACK {biot['disc_host_turns']} s, K10 {biot['disc_k10_turns']} s")
    for tag, r in (("jax_bicgstab", bicg), ("jax_gmres", gmres)):
        print(
            f"biot 1/64 on {smi}, {tag}: {r['ms_per_newton']:.2f} ms per Newton iteration ({r['newton']} "
            f"Newton, {r['iters_mean']:.1f} Krylov iterations per solve), host assembly {r['assemble_ms']:.2f} ms, "
            f"solve {r['solve_ms']:.2f} ms per Newton iteration"
        )
    print(
        f"md 1/128 sharded on {smi}, one-rank NCCL group: solve_once {sharded['sharded_ms']:.2f} ms "
        f"(median of 3) against the unsharded assembly and solve {sharded['unsharded_ms']:.2f} ms, "
        f"increments {sharded['dx_diff']:.3e} apart; a time step in {sharded['newton']} Newton iterations"
    )
    for e in entries:
        print(f"kernel {e['name']} on {smi}: {e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, "
              f"bound {e['bound_ms']:.6f} ms ({e['bound_by']}), library {e['library_ms']}, launches {e['launches']}")
    print(smi)
    print(json.dumps(kernels_line))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
