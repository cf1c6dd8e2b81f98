"""The batched interaction-region solve (K10) of porepy_tpu_torch against
porepy_tpu, on the CPU: the port's device route runs the kernel's plain
version there, and only when the CPU is asked for explicitly."""

import numpy as np
import pytest
import torch

import porepy_tpu as pt_jax
import porepy_tpu_torch as pt_torch
from porepy_tpu.numerics.fv import local_solves as ls_jax
from porepy_tpu_torch import kernels
from porepy_tpu_torch.kernels import ops, reference
from porepy_tpu_torch.numerics.fv import local_solves as ls_torch

torch.set_num_threads(1)

CPU = torch.device("cpu")

# (B, n, m, q): the buckets of the biot 1/64 grid and the largest of a 3d
# 16^3 grid, at a small batch.
BUCKETS = [(4, 8, 7, 9), (5, 12, 10, 14), (6, 20, 12, 20), (3, 81, 32, 80)]


def _batch(B, n, m, q, seed, zero_lead=False):
    """Seeded region systems with row scales spread over six decades, as
    the flux/pressure rows of MPSA regions are."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((B, n, n)) + 0.5 * n * np.eye(n)
    a *= 10.0 ** rng.uniform(-3, 3, (B, n, 1))
    if zero_lead:
        # Region 0 needs a row swap at the first step.
        a[0, 0, 0] = 0.0
    rhs = rng.standard_normal((B, n, m))
    w = rng.standard_normal((B, q, n))
    return a, rhs, w


@pytest.mark.parametrize(
    "shape,zero_lead",
    [(s, False) for s in BUCKETS] + [((4, 20, 12, 20), True)],
    ids=["n8", "n12", "n20", "n81", "n20-zero-lead"],
)
def test_device_route_matches_jax_device_route(shape, zero_lead):
    """The port's device route on the CPU and the plain K10 version against
    porepy_tpu's device kernel in its f64 branch (off the TPU), 1e-12 of
    the largest output entry."""
    a, rhs, w = _batch(*shape, seed=sum(shape), zero_lead=zero_lead)
    want = np.asarray(ls_jax._solve_chunk_device(a, rhs, w))
    before = dict(kernels.LAUNCHES)
    got = ls_torch._solve_chunk_device(a, rhs, w, device=CPU)
    plain = reference.region_solve_contract(*(torch.tensor(x) for x in (a, rhs, w))).numpy()
    assert kernels.LAUNCHES == before, "the CPU route launched a kernel"
    assert got.shape == want.shape == (shape[0], shape[3], shape[2])
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-12 * scale
    assert np.abs(plain - want).max() <= 1e-12 * scale
    host = ls_torch._solve_chunk_host(a, rhs, w)
    assert np.abs(host - want).max() <= 1e-12 * scale


_BIOT_MECH_KEYS = (
    "stress",
    "bound_stress",
    "bound_displacement_cell",
    "bound_displacement_face",
)
_BIOT_COUPLING_KEYS = (
    "scalar_gradient",
    "displacement_divergence",
    "boundary_displacement_divergence",
    "mpsa_consistency",
    "bound_displacement_pressure",
)


def _biot_matrices(pp, nx):
    """``Biot("mechanics").discretize`` on a Cartesian grid with the inputs
    of ``tests/models/test_poromechanics.py::test_biot_matrix_parity``."""
    rng = np.random.default_rng(5 + len(nx))
    nc = int(np.prod(nx))
    mu = rng.uniform(0.5, 2.0, nc)
    lmbda = rng.uniform(0.5, 2.0, nc)
    g = pp.CartGrid(list(nx))
    g.compute_geometry()
    bf = g.get_boundary_faces()
    cond = ["dir" if i % 2 == 0 else "neu" for i in range(bf.size)]
    d = pp.initialize_data(
        {},
        "mechanics",
        {
            "fourth_order_tensor": pp.FourthOrderTensor(mu, lmbda),
            "bc": pp.BoundaryConditionVectorial(g, bf, cond),
            "scalar_vector_mappings": {"flow": 0.8},
        },
    )
    pp.Biot("mechanics").discretize(g, d)
    md = d[pp.DISCRETIZATION_MATRICES]["mechanics"]
    out = {k: md[k] for k in _BIOT_MECH_KEYS}
    out.update({k: md[k]["flow"] for k in _BIOT_COUPLING_KEYS})
    return out


@pytest.mark.parametrize("nx", [[4, 3], [3, 2, 2]], ids=["2d", "3d"])
def test_biot_discretize_device_route_matches_jax(monkeypatch, nx):
    """Every Biot matrix by the port's device route (``PPT_LOCAL_SOLVE_DEVICE=1``,
    plain K10 on the CPU) against porepy_tpu's default host route, 1e-10
    relative per matrix."""
    calls = []
    device_route = ls_torch._solve_chunk_device

    def on_cpu(a, rhs, w):
        calls.append(a.shape)
        return device_route(a, rhs, w, device=CPU)

    monkeypatch.setattr(ls_torch, "_solve_chunk_device", on_cpu)
    monkeypatch.setenv("PPT_LOCAL_SOLVE_DEVICE", "1")
    got = _biot_matrices(pt_torch, nx)
    monkeypatch.delenv("PPT_LOCAL_SOLVE_DEVICE")
    want = _biot_matrices(pt_jax, nx)
    assert calls, "the device route was not taken"
    for key, ref in want.items():
        diff = abs(got[key] - ref)
        mx = diff.max() if diff.nnz else 0.0
        assert mx <= 1e-10 * max(abs(ref).max(), 1e-300), key


def test_device_route_without_cuda_raises(monkeypatch):
    """``PPT_LOCAL_SOLVE_DEVICE=1`` with no CUDA device raises at the first
    chunk; the host route is not taken instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    host_calls = []
    monkeypatch.setattr(ls_torch, "_solve_chunk_host", lambda *a: host_calls.append(1))
    monkeypatch.setenv("PPT_LOCAL_SOLVE_DEVICE", "1")
    g = pt_torch.CartGrid([3, 2])
    g.compute_geometry()
    d = pt_torch.initialize_data(
        {},
        "mechanics",
        {
            "fourth_order_tensor": pt_torch.FourthOrderTensor(np.ones(6), np.ones(6)),
            "bc": pt_torch.BoundaryConditionVectorial(g),
        },
    )
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_torch.Mpsa("mechanics").discretize(g, d)
    assert host_calls == []


def test_route_switch_is_read_at_call_time(monkeypatch):
    """The switch is read per chunk: without it the host route runs."""
    a, rhs, w = _batch(2, 8, 7, 9, seed=3)
    taken = []
    monkeypatch.setattr(ls_torch, "_solve_chunk_host", lambda *x: taken.append("host"))
    monkeypatch.setattr(ls_torch, "_solve_chunk_device", lambda *x: taken.append("device"))
    monkeypatch.delenv("PPT_LOCAL_SOLVE_DEVICE", raising=False)
    ls_torch._solve_chunk(a, rhs, w)
    monkeypatch.setenv("PPT_LOCAL_SOLVE_DEVICE", "1")
    ls_torch._solve_chunk(a, rhs, w)
    assert taken == ["host", "device"]


def test_batch_mesh_is_refused():
    """Anything but a dof mesh (or ``None``) is refused as a batch mesh
    (the sharded batches themselves: ``tests/test_torch_sharded.py``)."""
    ls_torch.set_batch_mesh(None)
    with pytest.raises(TypeError, match="DofMesh"):
        ls_torch.set_batch_mesh(object())
    assert ls_torch._BATCH_MESH is None


def test_region_solve_cuda_wrapper_refuses_without_falling_back():
    """The CUDA entry of the operator takes float64 CUDA tensors only; it
    raises for anything else instead of running the plain version."""
    a, rhs, w = (torch.tensor(x) for x in _batch(2, 8, 7, 9, seed=4))
    with pytest.raises(TypeError, match="float64"):
        ops._region_solve_cuda(a.float(), rhs.float(), w.float())
    with pytest.raises(ValueError, match="expected cuda"):
        ops._region_solve_cuda(a, rhs, w)
    with pytest.raises(ValueError, match=r"\(B, n, n\)"):
        ops._region_solve_cuda(a[:, :, :4], rhs, w)
