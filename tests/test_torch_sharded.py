"""The dof-sharded Newton solve (K19) of porepy_tpu_torch.

- K19's launcher (``HaloOperator``, its plain versions on the CPU) on P =
  1, 2, 3, 4, 8 row shards of the md 1/16 test model's Jacobian, in one
  process (the halo exchange done in-process): their concatenation is the
  global ``ell_spmv``.
- A gloo world of 2 and one of 4 CPU processes (spawned once each, by a
  module fixture) run ``ShardedNewton`` on the model of
  ``tests/parallel/test_sharded_framework.py`` and, at 4 ranks, the biot
  model of ``tests/parallel/test_sharding_depth.py``; rank 0 writes what
  every rank saw, and the tests hold it against the port's single-process
  solve, ``porepy_tpu``'s solve, and ``spsolve``.

The workers import this module by name, so it imports no jax at its top:
the jax side runs inside the tests.
"""

import datetime
import os
import pickle
import traceback

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from porepy_tpu_torch import kernels
from porepy_tpu_torch.kernels import ops, reference
from porepy_tpu_torch.parallel import halo

torch.set_num_threads(1)

WORLDS = (2, 4)
# A hang in a world fails its fixture, not the suite.
JOIN_S, GLOO_S = 120, 60


def _md_params(pp):
    """The md flow test model of ``tests/parallel/test_sharded_framework.py``
    (cell size 1/16, one fracture, 280 dofs), for either package."""

    class MD(pp.SinglePhaseFlow):
        def set_fractures(self):
            self._fractures = [pp.LineFracture(np.array([[0.25, 0.75], [0.5, 0.5]]))]

        def bc_values_pressure(self, bg):
            return 1.0 - bg.cell_centers[1]

        def initialize_data_saving(self):
            pass

        def save_data_time_step(self):
            pass

    params = {
        "grid_type": "cartesian",
        "meshing_arguments": {"cell_size": 1 / 16},
        "material_constants": {
            "solid": pp.SolidConstants(
                permeability=1.0, porosity=0.1, residual_aperture=0.01, normal_permeability=1.0
            ),
            "fluid": pp.FluidComponent(compressibility=1e-6, viscosity=1.0, density=1.0),
        },
        "time_manager": pp.TimeManager([0, 1.0], 1.0, constant_dt=True),
        "linear_solver": "device_gmres",
        "dense_precond": False,
    }
    return MD, params


def _biot_params(pp):
    """The poromechanics model of ``tests/parallel/test_sharding_depth.py``
    (cell size 1/8)."""

    class M(pp.Poromechanics):
        def bc_values_displacement(self, bg):
            vals = np.zeros((self.nd, bg.num_cells))
            vals[1, self.domain_boundary_sides(bg).north] = -0.001
            return vals.ravel("F")

        def initialize_data_saving(self):
            pass

        def save_data_time_step(self):
            pass

    params = {
        "grid_type": "cartesian",
        "meshing_arguments": {"cell_size": 1 / 8},
        "material_constants": {
            "solid": pp.SolidConstants(
                shear_modulus=1.0, lame_lambda=1.0, permeability=1e-2, porosity=0.1,
                biot_coefficient=0.8, specific_storage=0.1,
            ),
            "fluid": pp.FluidComponent(viscosity=1.0, density=1.0, compressibility=1e-2),
        },
        "time_manager": pp.TimeManager([0, 1.0], 1.0, constant_dt=True),
        "linear_solver": "device_gmres",
        "dense_precond": False,
    }
    return M, params


def _prepared(Model, params):
    m = Model(params)
    m.prepare_simulation()
    m.before_nonlinear_loop()
    m.before_nonlinear_iteration()
    return m


def _port_model(params_fn):
    import porepy_tpu_torch as pt

    Model, params = params_fn(pt)
    params["device"] = "cpu"
    return _prepared(Model, params)


def _region_batch():
    """The batch of ``test_local_solves_batch_sharded_over_mesh``: B = 21."""
    rng = np.random.default_rng(12)
    B, n, m, k = 21, 7, 7, 4
    a = rng.normal(size=(B, n, n)) + 5 * np.eye(n)
    return a, rng.normal(size=(B, n, m)), rng.normal(size=(B, k, n))


def _run_rank(size: int) -> dict:
    """What one rank of a gloo world computes through the port."""
    import porepy_tpu_torch as pt  # noqa: F401
    from porepy_tpu_torch.numerics.fv import local_solves
    from porepy_tpu_torch.parallel.placement import nnz_locality, spatial_dof_permutation
    from porepy_tpu_torch.parallel.sharded import ShardedNewton, make_dof_mesh

    mesh = make_dof_mesh(devices="cpu")
    m = _port_model(_md_params)
    eq = m.equation_system
    sn = ShardedNewton(m, mesh)
    out = {"rank": mesh.rank, "bounds": (sn.shard.lo, sn.shard.hi)}
    out["dx"], out["res"] = sn.solve_once()
    data, b, cs = eq.assemble_device()
    out["dx_single"] = m._device_solver_for(cs).solve(data, b)
    x_own, _res = sn.solver.solve_device(data, sn.shard.own(b))
    out["own_rows"] = int(x_own.shape[0])

    perm, _part = spatial_dof_permutation(eq, m.mdg, size)
    out["locality"] = (nnz_locality(cs, size), nnz_locality(cs, size, perm))
    out["dx_perm"], out["res_perm"] = ShardedNewton(m, mesh, dof_permutation=perm).solve_once()

    a, rhs, w = _region_batch()
    local_solves.set_batch_mesh(mesh)
    try:
        out["batch"] = local_solves._solve_chunk_device(a, rhs, w)
        out["batch_pad"] = local_solves._shard_batch(a, rhs, w)[3]
    finally:
        local_solves.set_batch_mesh(None)

    before = eq.get_variable_values(iterate_index=0)
    out["step_dx"], out["step_res"] = sn.step()
    out["step_before"] = before
    out["step_after"] = eq.get_variable_values(iterate_index=0)

    if size == 4:
        mb = _port_model(_biot_params)
        out["biot_dx"], out["biot_res"] = ShardedNewton(mb, mesh).solve_once()
        data, b, cs = mb.equation_system.assemble_device()
        A = sps.csr_matrix(
            (data.numpy(), (cs.indices_np[:, 0], cs.indices_np[:, 1])), shape=cs.shape
        )
        out["biot_direct"] = sps.linalg.spsolve(A, b.numpy())
    return out


def _world(rank: int, size: int, store: str, out: str) -> None:
    """One spawned rank: run, gather every rank's results on rank 0, which
    writes them to ``out``; a failure leaves its traceback beside it."""
    import torch.distributed as dist

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method="file://" + store, rank=rank, world_size=size,
            timeout=datetime.timedelta(seconds=GLOO_S),
        )
        result = _run_rank(size)
        every = [None] * size
        dist.all_gather_object(every, result)
        if rank == 0:
            with open(out, "wb") as fh:
                pickle.dump(every, fh)
        dist.destroy_process_group()
    except BaseException:
        with open(f"{out}.rank{rank}.err", "w") as fh:
            fh.write(traceback.format_exc())
        raise


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """``{P: [rank 0's results, ..., rank P - 1's]}`` for the gloo worlds,
    both started together."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    tmp = tmp_path_factory.mktemp("worlds")
    procs = {}
    for size in WORLDS:
        store, out = str(tmp / f"store{size}"), str(tmp / f"out{size}.pkl")
        procs[size] = (out, [ctx.Process(target=_world, args=(r, size, store, out)) for r in range(size)])
        for p in procs[size][1]:
            p.start()
    results = {}
    for size, (out, ps) in procs.items():
        for p in ps:
            p.join(JOIN_S)
        hung = [p for p in ps if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(5)
        errs = [open(f).read() for f in sorted(tmp.glob(f"out{size}.pkl.rank*.err"))]
        assert not hung and all(p.exitcode == 0 for p in ps), (
            f"world of {size}: exit codes {[p.exitcode for p in ps]}\n" + "\n".join(errs)
        )
        with open(out, "rb") as fh:
            results[size] = pickle.load(fh)
    return results


@pytest.fixture(scope="module")
def jax_increment():
    """``porepy_tpu``'s solve of the md test model's first Newton system
    (``_device_solver_for(cs).solve``, ``dense=False``)."""
    pytest.importorskip("jax")
    import porepy_tpu as pt_jax

    m = _prepared(*_md_params(pt_jax))
    data, b, cs = m.equation_system.assemble_device()
    return np.asarray(m._device_solver_for(cs).solve(data, b))


@pytest.fixture(scope="module")
def md_ell():
    """The md test model's first Jacobian in the port solver's ELL layout:
    ``(val, col, n)``."""
    from porepy_tpu_torch.numerics.linalg.device_solver import DeviceLinearSolver

    m = _port_model(_md_params)
    data, _b, cs = m.equation_system.assemble_device()
    solver = DeviceLinearSolver(cs)
    val = torch.cat([data, data.new_zeros(1)])[solver._ell_sel]
    return val, solver._ell_col, solver.n, m


# -- the K19 kernels' plain versions, in one process ----------------------------------


@pytest.mark.parametrize("size", [1, 2, 3, 4, 8])
def test_split_spmv_concatenates_to_global_spmv(md_ell, size):
    val, col, n, _m = md_ell
    x = torch.tensor(np.random.default_rng(size).standard_normal(n))
    want = reference.ell_spmv(val, col, x)
    plans = halo.local_plans(col.numpy(), n, size)
    assert [(p.lo, p.hi) for p in plans] == halo.shard_bounds(n, size)
    ops_ = [kernels.HaloOperator(val[p.lo : p.hi], *p.tensors("cpu"), p.n_halo) for p in plans]
    before = dict(kernels.LAUNCHES)
    got = torch.cat(halo.matvec_local(plans, ops_, [x[p.lo : p.hi] for p in plans]))
    assert kernels.LAUNCHES == before, "the CPU route launched a kernel"
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-14 * float(want.abs().max())
    # Every remote column is received exactly once per reading rank, and
    # one shard holding every row has no halo.
    for p in plans:
        assert p.n_halo == sum(p.recv_counts) and len(p.send_idx) == sum(p.send_counts)
        assert int(p.col.max()) <= p.n_own + p.n_halo
    assert plans[0].exchange == (size > 1)


def test_split_spmv_reads_padding_as_zero():
    """The padding column ``n_own + n_halo`` reads zero, whatever its value."""
    val = torch.tensor([[2.0, 3.0, 5.0]])
    col = torch.tensor([[0, 2, 3]], dtype=torch.int32)
    x_own, x_halo = torch.tensor([1.0, 7.0]), torch.tensor([10.0])
    assert reference.ell_spmv_split(val, col, x_own, x_halo).tolist() == [2.0 + 30.0]
    i32 = dict(dtype=torch.int32)
    op = kernels.HaloOperator(
        torch.tensor([[2.0, 3.0, 5.0], [1.0, 1.0, 0.0], [4.0, 0.0, 0.0]]),
        torch.tensor([[0, 3, 4], [1, 4, 4], [2, 4, 4]], **i32),
        torch.tensor([2, 0], **i32), torch.tensor([1, 2], **i32), torch.tensor([0], **i32), 1,
    )
    x = torch.tensor([4.0, 5.0, 6.0])
    y = op.interior(x)
    assert op.send.tolist() == [6.0, 4.0]
    assert y[1:].tolist() == [5.0, 24.0]
    op.recv.fill_(10.0)
    assert op.boundary(x, y).tolist() == [8.0 + 30.0, 5.0, 24.0]


def test_k19_cuda_wrappers_refuse_cpu_tensors():
    """An operator with any tensor off the CPU takes the card's route, where
    a CPU plan, a CPU ``x_own`` or a non-int32 table is refused."""
    i32 = dict(dtype=torch.int32)
    val = torch.zeros(2, 1, dtype=torch.float64)
    plan = (torch.zeros(2, 1, **i32), torch.zeros(1, **i32), torch.arange(2, **i32), torch.zeros(0, **i32))
    with pytest.raises(ValueError, match="col is on cpu, expected cuda"):
        ops.HaloOperator(val.to("meta"), *plan, 0)
    with pytest.raises(ValueError, match="is on meta, the plan on the cpu"):
        ops.HaloOperator(val, *plan, 0).interior(torch.zeros(2, dtype=torch.float64, device="meta"))
    with pytest.raises(TypeError, match="int32"):
        ops.HaloOperator(val, plan[0], plan[1].long(), *plan[2:], 0)


# -- the mesh and its errors ------------------------------------------------------------


def test_make_dof_mesh_needs_a_process_group():
    from porepy_tpu_torch.parallel.sharded import make_dof_mesh

    with pytest.raises(RuntimeError, match="init_process_group"):
        make_dof_mesh()


def test_make_dof_mesh_refuses_cuda_without_nccl(tmp_path):
    """In a one-rank gloo group: a CPU mesh works, a CUDA mesh raises
    (never a quiet gloo or CPU fallback), and ``n_devices`` must be the
    world size."""
    import torch.distributed as dist

    from porepy_tpu_torch.parallel.sharded import make_dof_mesh

    dist.init_process_group(
        "gloo", init_method="file://" + str(tmp_path / "store"), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=GLOO_S),
    )
    try:
        mesh = make_dof_mesh(devices="cpu")
        assert (mesh.rank, mesh.size, mesh.device) == (0, 1, torch.device("cpu"))
        with pytest.raises(RuntimeError, match="nccl"):
            make_dof_mesh()
        with pytest.raises(ValueError, match="world size"):
            make_dof_mesh(2, devices="cpu")
    finally:
        dist.destroy_process_group()


def test_sharded_newton_refuses_a_mesh_on_another_device(md_ell):
    from porepy_tpu_torch.parallel.sharded import DofMesh, ShardedNewton

    m = md_ell[3]
    with pytest.raises(ValueError, match="mesh"):
        ShardedNewton(m, DofMesh(None, 0, 1, torch.device("cuda", 0)))


# -- the gloo worlds ----------------------------------------------------------------------


@pytest.mark.parametrize("size", WORLDS)
def test_sharded_solve_matches_single_process_and_jax(worlds, jax_increment, size):
    """The gathered ``solve_once`` increment on every rank: within 1e-10
    relative of the port's single-process solve, and within 1e-8 of max
    |dx| of ``porepy_tpu``'s."""
    ranks = worlds[size]
    single = ranks[0]["dx_single"]
    scale = np.abs(single).max()
    for r in ranks:
        assert np.isfinite(r["res"])
        np.testing.assert_array_equal(r["dx"], ranks[0]["dx"])
        assert np.abs(r["dx"] - single).max() <= 1e-10 * scale
    assert np.abs(ranks[0]["dx"] - jax_increment).max() <= 1e-8 * np.abs(jax_increment).max()


@pytest.mark.parametrize("size", WORLDS)
def test_solve_device_shards_have_their_row_counts(worlds, size):
    ranks = worlds[size]
    n = ranks[0]["dx"].size
    assert [r["bounds"] for r in ranks] == halo.shard_bounds(n, size)
    for r in ranks:
        assert r["own_rows"] == r["bounds"][1] - r["bounds"][0]
    assert sum(r["own_rows"] for r in ranks) == n


@pytest.mark.parametrize("size", WORLDS)
def test_sharded_step_updates_state(worlds, size):
    for r in worlds[size]:
        assert np.isfinite(r["step_res"])
        assert np.allclose(r["step_after"], r["step_before"] + r["step_dx"])
        np.testing.assert_array_equal(r["step_after"], worlds[size][0]["step_after"])


@pytest.mark.parametrize("size", WORLDS)
def test_spatial_permutation_localizes_and_matches(worlds, size):
    """The spatial dof permutation raises the shard-local share of the
    nonzeros above 0.8 and above the plain split's, and its sharded solve
    reproduces the plain split's increment (1e-6 of max |dx|)."""
    r = worlds[size][0]
    plain, spatial = r["locality"]
    assert spatial > plain and spatial > 0.8, (plain, spatial)
    assert np.isfinite(r["res_perm"])
    assert np.abs(r["dx_perm"] - r["dx"]).max() <= 1e-6 * np.abs(r["dx"]).max()


def test_sharded_biot_matches_spsolve(worlds):
    """Coupled poromechanics (field split with fixed-stress stabilization)
    over 4 ranks against a direct solve, 1e-8 of max |dx|."""
    r = worlds[4][0]
    assert np.isfinite(r["biot_res"])
    scale = np.abs(r["biot_direct"]).max()
    assert np.abs(r["biot_dx"] - r["biot_direct"]).max() <= 1e-8 * scale


@pytest.mark.parametrize("size", WORLDS)
def test_local_solves_batch_sharded_over_mesh(worlds, size):
    """The region batch (B = 21, padded with identity systems to a
    multiple of the world size) split over the ranks and gathered, against
    the host LAPACK route."""
    from porepy_tpu_torch.numerics.fv import local_solves

    want = local_solves._solve_chunk_host(*_region_batch())
    for r in worlds[size]:
        assert r["batch_pad"] == (-21) % size
        assert r["batch"].shape == want.shape
        np.testing.assert_allclose(r["batch"], want, rtol=1e-9, atol=1e-11)


# -- on the card --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_cuda_halo_kernels_match_plain(cuda, md_ell, dtype):
    """K19's launcher at 1 and 3 shards of the md test Jacobian: the
    shards' rows bit-equal to the plain yardstick's, and to K1 (every row
    summed in K1's order, wherever its entries come from)."""
    val, col, n, _m = md_ell
    val = val.to(dtype=dtype, device=cuda)
    x = torch.tensor(np.random.default_rng(3).standard_normal(n), dtype=dtype, device=cuda)
    for size in (1, 3):
        plans = halo.local_plans(col.numpy(), n, size)
        ops_ = [kernels.HaloOperator(val[p.lo : p.hi], *p.tensors(cuda), p.n_halo) for p in plans]
        got = torch.cat(halo.matvec_local(plans, ops_, [x[p.lo : p.hi] for p in plans]))
        torch.cuda.synchronize()
        halos = [op.recv for op in ops_]
        want = torch.cat(
            [
                reference.ell_spmv_split(val[p.lo : p.hi], torch.tensor(p.col, device=cuda), x[p.lo : p.hi], h)
                for p, h in zip(plans, halos)
            ]
        )
        assert torch.equal(got, want)
        k1 = kernels.EllOperator(val, col.to(cuda))(x)
        assert torch.equal(got, k1)
