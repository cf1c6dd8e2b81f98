"""K10's ordered plain version (``reference.region_solve_ordered``: the
kernel's pivots, operations and order) against porepy_tpu's device route
(``_solve_chunk_device``, its f64 branch off the TPU) and against the
``torch.linalg.solve`` plain version, on seeded batches at the records'
shapes, at the route edges and on the real biot region chunks of small
grids; on a card, the kernel against the ordered version to the bit.

The JAX package is imported inside the tests that need it, so the
``cuda``-marked tests run on a card without jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_region_solve_ordered.py -m cuda
"""

import numpy as np
import pytest
import torch

from porepy_tpu_torch import kernels
from porepy_tpu_torch.applications.benchmarking.cases import biot_matrices, biot_problem, capture_chunks
from porepy_tpu_torch.kernels import ops, reference

torch.set_num_threads(1)

# (B, n, m, q): the main biot 1/64 bucket, the 3d 16^3 buckets of 27 and 81
# unknowns, and the edges of the routes (n = 32, n + m = 64: the warp
# route's largest; n = 33 or n + m = 65: a 16 x 16 block; n = 96, m = 128:
# the block's largest; n = 97: shared memory).
SHAPES = {
    "n20": (4, 20, 12, 20),
    "n27": (3, 27, 20, 32),
    "n81": (2, 81, 32, 80),
    "n32-warp": (3, 32, 32, 20),
    "n32-block": (3, 32, 33, 20),
    "n33-block": (3, 33, 31, 20),
    "n96-block": (2, 96, 128, 40),
    "n97-shared": (2, 97, 20, 30),
}
ROUTES = {"n32-warp": "warp", "n32-block": "block16", "n33-block": "block16", "n96-block": "block16",
          "n97-shared": "shared"}


def _batch(B, n, m, q, seed, zero_lead=False):
    """Seeded region systems with row scales spread over six decades, as
    the flux/pressure rows of MPSA regions are; with ``zero_lead`` region 0
    needs a row swap at the first step."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((B, n, n)) + 0.5 * n * np.eye(n)
    a *= 10.0 ** rng.uniform(-3, 3, (B, n, 1))
    if zero_lead:
        a[0, 0, 0] = 0.0
    return a, rng.standard_normal((B, n, m)), rng.standard_normal((B, q, n))


@pytest.fixture
def jax_solve():
    """porepy_tpu's device route on the CPU (its f64 branch)."""
    pytest.importorskip("jax")
    from porepy_tpu.numerics.fv import local_solves as ls_jax

    return lambda a, rhs, w: np.asarray(ls_jax._solve_chunk_device(a, rhs, w))


def _close(got, want, what):
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= 1e-12 * scale, f"{what}: {err:.3e} of {scale:.3e}"


@pytest.mark.parametrize(
    "shape,zero_lead",
    [(s, False) for s in SHAPES.values()] + [(SHAPES["n20"], True)],
    ids=list(SHAPES) + ["n20-zero-lead"],
)
def test_ordered_matches_jax_and_linalg(jax_solve, shape, zero_lead):
    """The ordered plain version against porepy_tpu's ``jnp.linalg.solve``
    route and the ``torch.linalg.solve`` plain version: 1e-12 of the
    largest output entry."""
    a, rhs, w = _batch(*shape, seed=sum(shape), zero_lead=zero_lead)
    want = jax_solve(a, rhs, w)
    t = [torch.tensor(x) for x in (a, rhs, w)]
    got = reference.region_solve_ordered(*t).numpy()
    assert got.shape == want.shape == (shape[0], shape[3], shape[2])
    _close(got, want, "ordered against porepy_tpu")
    _close(reference.region_solve_contract(*t).numpy(), want, "linalg.solve against porepy_tpu")


@pytest.mark.parametrize("nx", [[4, 3], [3, 2, 2]], ids=["2d", "3d"])
def test_ordered_matches_jax_on_biot_chunks(jax_solve, nx):
    """Every bucket of a small Biot discretization's region chunks
    (captured on the CPU by the host route): the ordered plain version
    against porepy_tpu's route, 1e-12 of the largest entry."""
    chunks = capture_chunks(lambda: biot_matrices(*biot_problem(nx)))
    assert len(chunks) >= 2
    for (n, m, q), (a, rhs, w) in chunks.items():
        got = reference.region_solve_ordered(*(torch.tensor(x) for x in (a, rhs, w))).numpy()
        _close(got, jax_solve(a, rhs, w), f"bucket n {n}, m {m}, q {q}")


def test_ordered_does_not_depend_on_the_row_order():
    """With distinct pivot candidates, the partial pivoting takes the same
    rows whatever their order, so permuting the rows of ``[A | RHS]`` gives
    the same bits (the kernel's logical positions rely on it)."""
    a, rhs, w = (torch.tensor(x) for x in _batch(*SHAPES["n20"], seed=8))
    perm = torch.randperm(a.shape[1], generator=torch.Generator().manual_seed(3))
    got = reference.region_solve_ordered(a, rhs, w)
    assert reference.same_bits(got, reference.region_solve_ordered(a[:, perm], rhs[:, perm], w))


def test_ordered_zero_pivot_leaves_nonfinite():
    """A singular region divides by zero: inf/NaN in its output, nothing
    flags or hides it; the other regions are untouched."""
    a, rhs, w = (torch.tensor(x) for x in _batch(2, 6, 3, 4, seed=9))
    a[1] = 0.0
    got = reference.region_solve_ordered(a, rhs, w)
    assert not torch.isfinite(got[1]).all()
    assert reference.same_bits(got[0], reference.region_solve_ordered(a[:1], rhs[:1], w[:1])[0])


def test_device_route_plain_is_linalg_solve():
    """The CPU route of the operator is ``region_solve_contract``, within
    1e-12 of the ordered version; it launches nothing."""
    a, rhs, w = (torch.tensor(x) for x in _batch(*SHAPES["n27"], seed=4))
    before = dict(kernels.LAUNCHES)
    got = kernels.region_solve(a, rhs, w)
    assert kernels.LAUNCHES == before
    assert reference.same_bits(got, reference.region_solve_contract(a, rhs, w))
    _close(got.numpy(), reference.region_solve_ordered(a, rhs, w).numpy(), "contract against ordered")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ROUTES))
def test_route_edges(cuda, name):
    """The routes the kernel takes at the edges, as the kernel library
    states them (``route`` in ``csrc/region_solve.cu``, which builds with
    the library)."""
    B, n, m, q = SHAPES[name]
    assert ops.region_solve_route(n, m) == ROUTES[name]
    assert ops.region_solve_route(180, 20) == "workspace"


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,zero_lead",
    [(s, True) for s in SHAPES.values()]
    + [((64, 20, 12, 20), True), ((3, 180, 20, 30), True), ((5, 2, 5, 4), False), ((3, 40, 30, 60), True),
       ((9, 20, 12, 200), True), ((3, 32, 32, 1000), True), ((4, 8, 8, 4000), True)],
    ids=list(SHAPES) + ["n20-b64", "n180-workspace", "n2", "n40-q60-block", "n20-q200-warp",
                        "n32-q1000-warp-global-w", "n8-q4000-warp-global-w"],
)
def test_cuda_region_solve_equals_ordered(cuda, shape, zero_lead):
    """K10 on every route: one launch, the ordered plain version's bits on
    the same inputs, within 1e-12 of the ``linalg.solve`` version."""
    a, rhs, w = (torch.tensor(x, device=cuda) for x in _batch(*shape, seed=31 + sum(shape), zero_lead=zero_lead))
    before = kernels.LAUNCHES["region_solve"]
    got = kernels.region_solve(a, rhs, w)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["region_solve"] == before + 1
    assert reference.same_bits(got, reference.region_solve_ordered(a, rhs, w))
    _close(got.cpu().numpy(), reference.region_solve_contract(a, rhs, w).cpu().numpy(), "kernel against linalg")
