"""K19's launcher (``HaloOperator``) and the halo plan's row split.

On P = 1, 2, 3, 4, 8 row shards of the md 1/16 test model's Jacobian
(the fixture of ``tests/test_torch_sharded.py``), in one process:

- the plan's interior and boundary rows partition each shard's rows, a
  boundary row being exactly one that reads a halo column;
- the CPU route (the plain versions), composed with the in-process
  exchange, gives ``reference.ell_spmv_split``'s rows bit for bit and
  launches nothing;
- the concatenated shards agree with ``porepy_tpu``'s ``ell_matvec`` on the
  same ELL and a seeded ``x`` within ``1e-14 * sum_k |val x|`` per row.

The cuda-marked cases run the kernels on the card: each launch against its
plain version bit for bit, and one shard against K1. This module imports no
jax at its top (the card's machine has none); the jax side runs inside its
test.
"""

import numpy as np
import pytest
import torch

from porepy_tpu_torch import kernels
from porepy_tpu_torch.kernels import build, reference
from porepy_tpu_torch.parallel import halo

from test_torch_sharded import _md_params, _port_model

torch.set_num_threads(1)

SIZES = [1, 2, 3, 4, 8]
I32 = dict(dtype=torch.int32)


@pytest.fixture(scope="module")
def md_ell():
    """The md test model's first Jacobian in the port solver's ELL layout:
    ``(val, col, n)``."""
    from porepy_tpu_torch.numerics.linalg.device_solver import DeviceLinearSolver

    m = _port_model(_md_params)
    data, _b, cs = m.equation_system.assemble_device()
    solver = DeviceLinearSolver(cs)
    val = torch.cat([data, data.new_zeros(1)])[solver._ell_sel]
    return val, solver._ell_col, solver.n


def _x(n: int, seed: int) -> torch.Tensor:
    return torch.tensor(np.random.default_rng(seed).standard_normal(n))


def _operators(val, plans, device="cpu"):
    return [kernels.HaloOperator(val[p.lo : p.hi], *p.tensors(device), p.n_halo) for p in plans]


@pytest.mark.parametrize("size", SIZES)
def test_plan_splits_rows_into_interior_and_boundary(md_ell, size):
    _val, col, n = md_ell
    plans = halo.local_plans(col.numpy(), n, size)
    for p in plans:
        assert p.interior.dtype == np.int32 and p.boundary.dtype == np.int32
        assert np.all(np.diff(p.interior) > 0) and np.all(np.diff(p.boundary) > 0)
        both = np.sort(np.concatenate([p.interior, p.boundary]))
        np.testing.assert_array_equal(both, np.arange(p.n_own))
        reads_halo = ((p.col >= p.n_own) & (p.col < p.n_own + p.n_halo)).any(axis=1)
        np.testing.assert_array_equal(p.boundary, np.flatnonzero(reads_halo))
    if size == 1:
        assert plans[0].boundary.size == 0 and plans[0].interior.size == n
    else:
        assert all(p.boundary.size for p in plans)


@pytest.mark.parametrize("size", SIZES)
def test_cpu_operator_matches_split_reference(md_ell, size):
    val, col, n = md_ell
    x = _x(n, 10 + size)
    plans = halo.local_plans(col.numpy(), n, size)
    ops_ = _operators(val, plans)
    before = dict(kernels.LAUNCHES)
    ys = halo.matvec_local(plans, ops_, [x[p.lo : p.hi] for p in plans])
    assert kernels.LAUNCHES == before, "the CPU route launched a kernel"
    halos = halo.exchange_local(
        plans, [reference.halo_pack(x[p.lo : p.hi], torch.tensor(p.send_idx)) for p in plans]
    )
    for p, op, y, h in zip(plans, ops_, ys, halos):
        assert torch.equal(op.recv, h)
        want = reference.ell_spmv_split(val[p.lo : p.hi], torch.tensor(p.col), x[p.lo : p.hi], h)
        assert torch.equal(y, want)


@pytest.mark.parametrize("size", SIZES)
def test_shards_match_jax_ell_matvec(md_ell, size):
    pytest.importorskip("jax")
    from porepy_tpu.numerics.linalg.amg import ell_matvec

    val, col, n = md_ell
    x = _x(n, 20 + size)
    plans = halo.local_plans(col.numpy(), n, size)
    got = torch.cat(halo.matvec_local(plans, _operators(val, plans), [x[p.lo : p.hi] for p in plans]))
    want = np.asarray(ell_matvec(val.numpy(), col.numpy(), x.numpy()))
    scale = reference.ell_spmv(val.abs(), col, x.abs()).numpy()
    assert got.shape == want.shape
    assert np.all(np.abs(got.numpy() - want) <= 1e-14 * scale)


def test_operator_reuses_its_buffers_and_returns_new_results(md_ell):
    val, col, n = md_ell
    plans = halo.local_plans(col.numpy(), n, 3)
    ops_ = _operators(val, plans)
    sends, recvs = [op.send for op in ops_], [op.recv for op in ops_]
    xs = [x[p.lo : p.hi] for x in (_x(n, 1),) for p in plans]
    first = halo.matvec_local(plans, ops_, xs)
    second = halo.matvec_local(plans, ops_, xs)
    for op, s, r, a, b in zip(ops_, sends, recvs, first, second):
        assert op.send is s and op.recv is r
        assert a is not b and torch.equal(a, b)


def test_operator_refuses_wrong_types_and_devices():
    val = torch.zeros(2, 1, dtype=torch.float64)
    plan = (torch.zeros(2, 1, **I32), torch.zeros(1, **I32), torch.arange(2, **I32), torch.zeros(0, **I32))
    with pytest.raises(TypeError, match="val must be float32/float64"):
        kernels.HaloOperator(val.half(), *plan, 0)
    for k in range(4):
        bad = list(plan)
        bad[k] = bad[k].long()
        with pytest.raises(TypeError, match="int32"):
            kernels.HaloOperator(val, *bad, 0)
    with pytest.raises(ValueError, match="every row once"):
        kernels.HaloOperator(val, plan[0], plan[1], plan[2][:1], plan[3], 0)
    op = kernels.HaloOperator(val, *plan, 0)
    with pytest.raises(TypeError, match="float32"):
        op.interior(torch.zeros(2, dtype=torch.float32))
    with pytest.raises(ValueError, match="shape"):
        op.interior(torch.zeros(3, dtype=torch.float64))
    # A tensor off the CPU takes the card's route, which refuses the CPU
    # plan; an x_own off the CPU is refused by the CPU plan.
    with pytest.raises(ValueError, match="col is on cpu, expected cuda"):
        kernels.HaloOperator(val.to("meta"), *plan, 0)
    with pytest.raises(ValueError, match="x_own is on meta"):
        op.interior(torch.zeros(2, dtype=torch.float64, device="meta"))


def test_build_flags_follow_the_headers(tmp_path):
    """A changed header changes the flags, so the build's hash, so the
    library is rebuilt."""
    for h in build.HEADERS:
        (tmp_path / h).write_text("// one\n")
    one = build.cflags(str(tmp_path))
    (tmp_path / build.HEADERS[0]).write_text("// two\n")
    assert build.cflags(str(tmp_path)) != one
    assert build.cflags()[: len(one) - 1] == one[:-1]


# -- on the card --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("size", [1, 3])
def test_cuda_launches_match_plain(cuda, md_ell, dtype, size):
    """Each launch against its plain version bit for bit (the send buffer
    and the interior rows after launch A, the boundary rows after launch
    B), the launches counted, and the shards equal to K1."""
    val, col, n = md_ell
    val = val.to(dtype=dtype, device=cuda)
    x = _x(n, 30 + size).to(dtype=dtype, device=cuda)
    plans = halo.local_plans(col.numpy(), n, size)
    ops_ = _operators(val, plans, cuda)
    xs = [x[p.lo : p.hi] for p in plans]
    kernels.reset_launches()
    ys = [op.interior(xo) for op, xo in zip(ops_, xs)]
    plain = []
    for p, op, xo, y in zip(plans, ops_, xs, ys):
        c, idx, inner, _bnd = p.tensors(cuda)
        send, y_plain = reference.halo_interior(val[p.lo : p.hi], c, xo, idx, inner)
        assert torch.equal(op.send, send)
        assert torch.equal(y[inner.long()], y_plain[inner.long()])
        plain.append(y_plain)
    for op, h in zip(ops_, halo.exchange_local(plans, [op.send for op in ops_])):
        op.recv.copy_(h)
    ys = [op.boundary(xo, y) for op, xo, y in zip(ops_, xs, ys)]
    for p, op, xo, y, y_plain in zip(plans, ops_, xs, ys, plain):
        c, _idx, _inner, bnd = p.tensors(cuda)
        assert torch.equal(y, reference.halo_boundary(val[p.lo : p.hi], c, xo, op.recv, bnd, y_plain))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["halo_interior"] == size
    assert kernels.LAUNCHES["halo_boundary"] == (0 if size == 1 else size)
    assert torch.equal(torch.cat(ys), kernels.EllOperator(val, col.to(cuda))(x))


@pytest.mark.cuda
def test_cuda_operator_refuses_cpu_tensors(cuda, md_ell):
    val, col, n = md_ell
    (p,) = halo.local_plans(col.numpy(), n, 1)
    with pytest.raises(ValueError, match="expected cuda"):
        kernels.HaloOperator(val.to(cuda), *p.tensors("cpu"), p.n_halo)
    op = kernels.HaloOperator(val.to(cuda), *p.tensors(cuda), p.n_halo)
    with pytest.raises(ValueError, match="expected the plan's card"):
        op.interior(_x(n, 0))
    cpu_op = kernels.HaloOperator(val, *p.tensors("cpu"), p.n_halo)
    with pytest.raises(ValueError, match="the plan on the cpu"):
        cpu_op.interior(_x(n, 0).to(cuda))
