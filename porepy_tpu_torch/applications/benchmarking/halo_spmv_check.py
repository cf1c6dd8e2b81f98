"""K19's launcher (``HaloOperator``: ``halo_interior``, the exchange,
``halo_boundary``) on the card, against its plain versions, K1, and the
two-launch route it replaced.

    python3 -m porepy_tpu_torch.applications.benchmarking.halo_spmv_check

On md 1/128's first Jacobian in the solver's ELL layout (n 18,157, K 9),
split into 4 row shards and into 1, in f64 and f32, it prints what ``nvcc
-Xptxas -v`` reports for ``halo_spmv.cu``; holds each launch against its
plain version (the send buffer and the interior rows after launch A, the
boundary rows after launch B), the shards against K1 (``EllOperator``) on
the whole matrix, and the two-launch route against the same rows, all to
the bit; then times, in turns, per shard call in f32: the launcher, the
two-launch route (``halo_pack`` then ``ell_spmv_split``, each a custom
operator, built from the parent's ``halo_spmv.cu`` in ``two_launch/``
beside this script), and ``index_select`` + ``torch.mv`` on the shard's CSR
matrix, each by host µs a call, device µs by CUDA-graph replay, ms by CUDA
events over back-to-back calls, and launches a matvec; at 1 shard K1's
launcher too; then each launch alone, its plain version, the PyTorch calls
that compute its rows (``index_select`` for the send buffer and
``torch.mv`` on the rows' CSR matrix), and the bounds (bytes). The exchange is done
once, in the process, before the times. Needs a
CUDA card and ``nvcc``; exits non-zero when a launch and its plain version
differ.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from porepy_tpu_torch.applications.benchmarking.krylov_cycle_check import _CFLAGS, _nvcc, ptxas_report
from porepy_tpu_torch.applications.benchmarking.timing import cuda_ms, graph_us, host_us

OLD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "two_launch")
_SUFFIX = {torch.float32: "_f32", torch.float64: "_f64"}
#: Launches of the two-launch route since the last reset.
OLD_LAUNCHES = {"halo_pack": 0, "ell_spmv_split": 0}
_OLD = {}


# -- the two-launch route ---------------------------------------------------------


def old_route(workdir: str):
    """``(halo_pack, ell_spmv_split)``: the replaced route's two custom
    operators over ``OLD_DIR/halo_spmv.cu`` built with ``nvcc`` into a
    library with a plain C interface, each checking its tensors and
    allocating its output on every call, as they did on the sharded path."""
    if "ops" in _OLD:
        return _OLD["ops"]
    so = os.path.join(workdir, "old_k19.so")
    subprocess.run([_nvcc(), *_CFLAGS, "-shared", "-Xcompiler", "-fPIC", "-o", so,
                    os.path.join(OLD_DIR, "halo_spmv.cu")], check=True)
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    for suffix in _SUFFIX.values():
        for name, argtypes in (("ppt_halo_pack", [P] * 3 + [I, P]),
                               ("ppt_ell_spmv_split", [P] * 5 + [I] * 4 + [P])):
            fn = getattr(lib, name + suffix)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int

    def launch(name, dtype, *args):
        rc = getattr(lib, f"ppt_{name}{_SUFFIX[dtype]}")(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{name}: CUDA error {rc}")
        OLD_LAUNCHES[name] += 1

    def check(name, tensors):
        for arg, t in tensors.items():
            if not t.is_cuda or not t.is_contiguous():
                raise ValueError(f"{name}: {arg} must be a contiguous CUDA tensor")

    @torch.library.custom_op("ppt_halo_check::halo_pack", mutates_args=())
    def halo_pack(x_own: torch.Tensor, send_idx: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError("the two-launch route runs on the card only")

    @halo_pack.register_kernel("cuda")
    def _(x_own, send_idx):
        if send_idx.dtype != torch.int32:
            raise TypeError("halo_pack: send_idx must be int32")
        check("halo_pack", {"x_own": x_own, "send_idx": send_idx})
        send = torch.empty(send_idx.shape[0], dtype=x_own.dtype, device=x_own.device)
        if send.numel():
            launch("halo_pack", x_own.dtype, x_own.data_ptr(), send_idx.data_ptr(), send.data_ptr(), send.numel())
        return send

    @torch.library.custom_op("ppt_halo_check::ell_spmv_split", mutates_args=())
    def ell_spmv_split(val: torch.Tensor, col: torch.Tensor, x_own: torch.Tensor,
                       x_halo: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError("the two-launch route runs on the card only")

    @ell_spmv_split.register_kernel("cuda")
    def _(val, col, x_own, x_halo):
        if col.dtype != torch.int32 or val.dtype != x_own.dtype or x_halo.dtype != x_own.dtype:
            raise TypeError("ell_spmv_split: needs val, x_own, x_halo of one dtype and int32 col")
        check("ell_spmv_split", {"val": val, "col": col, "x_own": x_own, "x_halo": x_halo})
        n_rows, K = val.shape
        y = torch.empty(n_rows, dtype=x_own.dtype, device=x_own.device)
        if n_rows:
            launch("ell_spmv_split", x_own.dtype, val.data_ptr(), col.data_ptr(), x_own.data_ptr(),
                   x_halo.data_ptr(), y.data_ptr(), n_rows, K, x_own.shape[0], x_halo.shape[0])
        return y

    _OLD["ops"] = (halo_pack, ell_spmv_split)
    return _OLD["ops"]


# -- the checks ---------------------------------------------------------------------


def md_jacobian_ell(model):
    """The model's Jacobian at its current state in its device solver's ELL
    layout: ``(val float64, col int32, n)``."""
    eq = model.equation_system
    cs = eq.compiled_system()
    solver = model._device_solver_for(cs)
    data, _b = cs.assemble(eq)
    return torch.cat([data, data.new_zeros(1)])[solver._ell_sel], solver._ell_col, solver.n


class Shards:
    """One matrix in ``size`` row shards on the card: the plans, the
    operators, ``x``'s rows, and the halos once exchanged."""

    def __init__(self, val, col, n: int, size: int, x) -> None:
        from porepy_tpu_torch import kernels
        from porepy_tpu_torch.parallel import halo

        dev = val.device
        self.size = size
        self.plans = halo.local_plans(col.cpu().numpy(), n, size)
        self.tables = [p.tensors(dev) for p in self.plans]
        self.vals = [val[p.lo : p.hi] for p in self.plans]
        self.own = [x[p.lo : p.hi] for p in self.plans]
        self.ops = [kernels.HaloOperator(v, *t, p.n_halo) for v, t, p in zip(self.vals, self.tables, self.plans)]


def compare(val, col, n: int, size: int, x, old) -> dict:
    """Each launch of ``size`` shards against its plain version, the shards
    against K1 and against the two-launch route, all to the bit. Returns
    ``{"shards", "launches", "equal": {...}, "err": max |y - K1|}``."""
    from porepy_tpu_torch import kernels
    from porepy_tpu_torch.kernels import reference
    from porepy_tpu_torch.parallel import halo

    sh = Shards(val, col, n, size, x)
    kernels.reset_launches()
    ys = [op.interior(o) for op, o in zip(sh.ops, sh.own)]
    equal = {"send": True, "interior": True, "boundary": True}
    plains = []
    for op, v, t, o, y in zip(sh.ops, sh.vals, sh.tables, sh.own, ys):
        c, idx, inner, _bnd = t
        send, y_plain = reference.halo_interior(v, c, o, idx, inner)
        equal["send"] &= torch.equal(op.send, send)
        equal["interior"] &= torch.equal(y[inner.long()], y_plain[inner.long()])
        plains.append(y_plain)
    for op, h in zip(sh.ops, halo.exchange_local(sh.plans, [op.send for op in sh.ops])):
        op.recv.copy_(h)
    ys = [op.boundary(o, y) for op, o, y in zip(sh.ops, sh.own, ys)]
    for op, v, t, o, y, y_plain in zip(sh.ops, sh.vals, sh.tables, sh.own, ys, plains):
        c, _idx, _inner, bnd = t
        equal["boundary"] &= torch.equal(y, reference.halo_boundary(v, c, o, op.recv, bnd, y_plain))
    torch.cuda.synchronize()
    launches = {k: kernels.LAUNCHES[k] for k in ("halo_interior", "halo_boundary")}
    got = torch.cat(ys)
    k1 = kernels.EllOperator(val, col)(x)
    equal["K1"] = torch.equal(got, k1)
    pack, split = old
    sends = [pack(o, t[1]) for o, t in zip(sh.own, sh.tables)]
    old_y = torch.cat([split(v, t[0], o, h) for v, t, o, h in
                       zip(sh.vals, sh.tables, sh.own, halo.exchange_local(sh.plans, sends))])
    equal["two-launch route"] = torch.equal(got, old_y)
    return {"shards": sh, "launches": launches, "equal": equal, "err": float((got - k1).abs().max())}


def _csr(v, c, n_rows: int, n_cols: int):
    real = c < n_cols
    crow = torch.zeros(n_rows + 1, dtype=torch.int64, device=v.device)
    crow[1:] = torch.cumsum(real.sum(1), 0)
    return torch.sparse_csr_tensor(crow, c[real].long(), v[real], size=(n_rows, n_cols))


def time_routes(sh: Shards, old, turns=("launcher", "two-launch", "library", "library", "two-launch", "launcher")) -> dict:
    """Per shard call, in ``turns``: host µs a call, device µs by graph
    replay and ms by CUDA events over back-to-back calls of the launcher
    (launch A then B), the two-launch route and ``index_select`` +
    ``torch.mv`` on the shard's CSR matrix, with the halos exchanged once
    before; launches of one matvec of every shard. At 1 shard K1's
    launcher on the whole matrix joins the turns."""
    from porepy_tpu_torch import kernels

    pack, split = old
    halos = [op.recv for op in sh.ops]
    xcat = [torch.cat([o, h]) for o, h in zip(sh.own, halos)]
    csrs = [_csr(v, t[0], p.n_own, p.n_own + p.n_halo) for v, t, p in zip(sh.vals, sh.tables, sh.plans)]
    routes = {
        "launcher": lambda: [op.boundary(o, op.interior(o)) for op, o in zip(sh.ops, sh.own)],
        "two-launch": lambda: [(pack(o, t[1]), split(v, t[0], o, h))
                               for v, t, o, h in zip(sh.vals, sh.tables, sh.own, halos)],
        "library": lambda: [(torch.index_select(o, 0, t[1]), torch.mv(m, xc))
                            for o, t, m, xc in zip(sh.own, sh.tables, csrs, xcat)],
    }
    if sh.size == 1:
        k1 = kernels.EllOperator(sh.vals[0], sh.tables[0][0])
        routes["K1"] = lambda: k1(sh.own[0])
        turns = turns + ("K1", "K1")
    out = {name: {"host_us": [], "device_us": [], "ms": []} for name in routes}
    for name in turns:
        fn, r = routes[name], out[name]
        r["host_us"].append(host_us(fn) / sh.size)
        r["device_us"].append(graph_us(fn) / sh.size)
        r["ms"].append(cuda_ms(fn) / sh.size)
    for name, fn in routes.items():
        kernels.reset_launches()
        for k in OLD_LAUNCHES:
            OLD_LAUNCHES[k] = 0
        fn()
        torch.cuda.synchronize()
        count = sum(kernels.LAUNCHES.values()) + sum(OLD_LAUNCHES.values())
        out[name]["launches"] = count / sh.size if name != "library" else None
    return out


def _bytes(p, rows, size: int, send: bool) -> int:
    """Bytes that the rows ``rows`` of plan ``p`` move at least: their val
    and col, the distinct entries of ``x_own`` and the halo they read, and
    their results written; the row list only where the rows are a part of
    the shard's (the whole shard's product needs none: K1 computes it
    without one); with ``send``, the send indices read and the send buffer
    written."""
    cols = p.col[rows]
    need = np.unique(cols[cols < p.n_own + p.n_halo]).size
    listed = 4 if len(rows) < p.n_own else 0
    nbytes = len(rows) * (p.col.shape[1] * (size + 4) + listed + size) + need * size
    return nbytes + (len(p.send_idx) * (4 + size) if send else 0)


def bounds_ms(sh: Shards, dtype) -> dict:
    """Least ms of one shard call, the mean over the shards, by bytes over
    3.35 TB/s (the sums' 2 operations a nonzero are far below the card's
    rate): ``{"interior", "boundary", "launcher"}`` (launch A, launch B, both)."""
    size = torch.finfo(dtype).bits // 8
    out = {"interior": 0, "boundary": 0, "launcher": 0}
    for p in sh.plans:
        out["interior"] += _bytes(p, p.interior, size, True)
        out["boundary"] += _bytes(p, p.boundary, size, False)
        out["launcher"] += _bytes(p, np.arange(p.n_own), size, True)
    return {k: 1e3 * v / sh.size / 3.35e12 for k, v in out.items()}


def time_launches(sh: Shards) -> dict:
    """Per shard call: each launch alone and its plain version (ms by CUDA
    events over back-to-back calls, device µs by graph replay), and the
    PyTorch calls that compute the launch's output: for launch A
    ``index_select`` for the send buffer (none where it is empty) and
    ``torch.mv`` on the interior rows' CSR matrix, for launch B ``torch.mv``
    on the boundary rows' CSR matrix. At 1 shard every row is interior and
    launch A is the whole matvec: launch B is not timed."""
    from porepy_tpu_torch.kernels import reference

    ys = [op.interior(o) for op, o in zip(sh.ops, sh.own)]
    csr_a = [_csr(v[t[2].long()], t[0][t[2].long()], len(p.interior), p.n_own)
             for v, t, p in zip(sh.vals, sh.tables, sh.plans)]
    sends = [t[1] if len(p.send_idx) else None for t, p in zip(sh.tables, sh.plans)]
    fns = {
        "interior": lambda: [op.interior(o) for op, o in zip(sh.ops, sh.own)],
        "interior plain": lambda: [reference.halo_interior(v, t[0], o, t[1], t[2])
                                   for v, t, o in zip(sh.vals, sh.tables, sh.own)],
        "interior library": lambda: [(None if i is None else torch.index_select(o, 0, i), torch.mv(m, o))
                                     for o, i, m in zip(sh.own, sends, csr_a)],
    }
    if sh.size > 1:
        csr_b = [_csr(v[t[3].long()], t[0][t[3].long()], len(p.boundary), p.n_own + p.n_halo)
                 for v, t, p in zip(sh.vals, sh.tables, sh.plans)]
        xcat = [torch.cat([o, op.recv]) for o, op in zip(sh.own, sh.ops)]
        fns.update({
            "boundary": lambda: [op.boundary(o, y) for op, o, y in zip(sh.ops, sh.own, ys)],
            "boundary plain": lambda: [reference.halo_boundary(v, t[0], o, op.recv, t[3], y)
                                       for v, t, o, op, y in zip(sh.vals, sh.tables, sh.own, sh.ops, ys)],
            "boundary library": lambda: [torch.mv(m, xc) for m, xc in zip(csr_b, xcat)],
        })
    out = {name: {"ms": cuda_ms(fn, 20 if "plain" in name else 100) / sh.size} for name, fn in fns.items()}
    for name in fns:
        if "plain" not in name:
            out[name]["device_us"] = graph_us(fns[name]) / sh.size
    return out


def report(val64, col, n: int, old, sizes=(4, 1), seed: int = 18, timed=torch.float32) -> dict:
    """:func:`compare` at each size in f64 and f32, then :func:`time_routes`
    in ``timed``; prints each. ``{(size, dtype name): {...}}``."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for size in sizes:
        for dtype in (torch.float64, torch.float32):
            tag = str(dtype)[6:]
            x = torch.randn(n, generator=gen, dtype=torch.float64).to(dtype).to(val64.device)
            r = compare(val64.to(dtype), col, n, size, x, old)
            sh = r.pop("shards")
            print(f"  {size} shard(s), {tag}: rows per shard {[p.n_own for p in sh.plans]}, boundary rows "
                  f"{[len(p.boundary) for p in sh.plans]}, halo {[p.n_halo for p in sh.plans]}; launches "
                  f"{r['launches']}; bit-equal {r['equal']}")
            if dtype == timed:
                r["times"] = time_routes(sh, old)
                r["bounds"] = bounds_ms(sh, dtype)
                for name, t in r["times"].items():
                    print(f"    per shard call, {name}: host us {[round(v, 2) for v in t['host_us']]}, device us "
                          f"{[round(v, 3) for v in t['device_us']]}, ms {[round(v, 4) for v in t['ms']]}, "
                          f"launches a matvec {t['launches']}")
                r["launch_times"] = time_launches(sh)
                for name, t in r["launch_times"].items():
                    print(f"    per shard call, {name}: {t['ms']:.4f} ms"
                          + (f", device {t['device_us']:.3f} us" if "device_us" in t else ""))
                print("    bound us (bytes): " + ", ".join(f"{k} {1e3 * v:.4f}" for k, v in r["bounds"].items()))
            out[(size, tag)] = r
    return out


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        print("halo_spmv_check: no CUDA device available", file=sys.stderr)
        return 1
    from porepy_tpu_torch.applications.benchmarking.cases import build_md_flow
    from porepy_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"{smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    build.library()
    print(f"kernels built in {build.build_seconds():.2f} s")
    with tempfile.TemporaryDirectory() as work:
        ptxas_report([os.path.join(build.CSRC, "halo_spmv.cu"), os.path.join(build.CSRC, "ell_spmv.cu")], work)
        old = old_route(work)
        tic = time.perf_counter()
        Model, params = build_md_flow(1.0 / 128, device=str(dev))
        model = Model(params)
        model.prepare_simulation()
        model.before_nonlinear_loop()
        model.before_nonlinear_iteration()
        val, col, n = md_jacobian_ell(model)
        print(f"md 1/128's first Jacobian: n {n}, K {col.shape[1]}, built in {time.perf_counter() - tic:.1f} s")
        out = report(val, col, n, old)
    ok = all(all(r["equal"].values()) for r in out.values())
    print(f"halo_spmv_check on {smi}: every launch, K1 and the two-launch route to the bit: {ok}")
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
