"""K15's one kernel (``upwind_dual``: the value and every tangent of a dual
rule in one launch) on the CPU, through its plain version
``reference.upwind_dual``: each kind (flux, apply, pair, interface) against
porepy_tpu's functions and ``jax.jvp``; against the parent's two-call route
(and, for the interface, ``forward.mul``'s ``dual_ew``) to the bit over
flux ties, missing cells, Neumann and Dirichlet-inflow faces, ``None``
seeds, B = 0, 1 and 33 and strided seed rows; one launcher call a dual rule
and an assembly of md and tracer equal to the parent rules' to the bit. The
tests marked ``cuda`` hold the launch against the plain version on a card;
run them there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_upwind_dual.py -m cuda
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import porepy_tpu_torch as pt_torch
from porepy_tpu_torch.applications.benchmarking import cases
from porepy_tpu_torch.applications.benchmarking import upwind_calls
from porepy_tpu_torch.kernels import ops, reference
from porepy_tpu_torch.numerics.ad.forward import Dual
from porepy_tpu_torch.numerics.fv import upwind as up_torch

torch.set_num_threads(1)

# jax and porepy_tpu are imported where a test compares with them, so that
# the tests marked cuda run on a machine without jax.

# Against jax: the same IEEE operations on the same inputs; a tangent's
# sums of products may be taken in another order.
TOL = 1e-13
KINDS = ("flux", "apply", "pair", "interface")


def _grid_and_bc(pt, n=7):
    """A 7 x 7 grid: Dirichlet on the west and south faces, Neumann on the
    others."""
    g = pt.CartGrid(np.array([n, n]), np.array([1.0, 1.0]))
    g.compute_geometry()
    faces = g.get_all_boundary_faces()
    west_south = faces[(g.face_centers[0, faces] < 1e-9) | (g.face_centers[1, faces] < 1e-9)]
    return g, pt.BoundaryCondition(g, west_south, "dir")


@pytest.fixture(scope="module")
def geoms():
    gt, bct = _grid_and_bc(pt_torch)
    return up_torch.UpwindGeometry([gt], [bct])


@pytest.fixture(scope="module")
def geom_jax():
    import porepy_tpu as pt_jax
    from porepy_tpu.numerics.fv import upwind as up_jax

    gj, bcj = _grid_and_bc(pt_jax)
    return up_jax.UpwindGeometry([gj], [bcj])


def _geometry(gt, dev="cpu"):
    g = gt.on(dev)
    return tuple(g[k] for k in ("lo", "hi", "is_dir", "is_neu", "sgn_div"))


def _direction(rng, n):
    """A flux with both signs, exact zeros of both signs among them."""
    q = rng.standard_normal(n)
    q[::5] = 0.0
    q[2::7] = -0.0
    return q


def _operands(kind, gt, B, seed=0, missing=(), strided=False):
    """Primals and seeds of ``kind`` (numpy-made from ``seed``); the seeds
    named in ``missing`` are ``None``; ``strided``: the seed rows are slices
    of wider arrays (row stride above their length)."""
    rng = np.random.default_rng(seed)
    nf = gt.lo.size
    n1 = gt.num_cells if kind in ("flux", "apply") else nf
    lengths = (nf, n1, nf)
    primals = [torch.tensor(_direction(rng, nf)), torch.tensor(rng.standard_normal(n1)),
               torch.tensor(rng.standard_normal(nf))]
    if kind == "apply":
        primals[2] = None
    if not B:
        return primals, None
    seeds = []
    for i, n in enumerate(lengths):
        wide = torch.tensor(rng.standard_normal((B, n + (5 if strided else 0))))
        seeds.append(None if i in missing else wide[:, :n])
    if kind == "apply":
        seeds[0] = seeds[2] = None
    if kind == "pair":
        seeds[0] = None
    return primals, seeds


def _jax_fn(kind, gj):
    """porepy_tpu's function of each kind, of the three primals."""
    import jax
    import jax.numpy as jnp
    from porepy_tpu.numerics.fv import upwind as up_jax

    if kind == "flux":
        def f(q, w, bc):
            dir_mask, neu_coeff = up_jax.upwind_boundary_masks(gj, q)
            return q * up_jax.upwind_apply(gj, q, w) + dir_mask * q * bc + neu_coeff * bc
    elif kind == "apply":
        def f(q, w, _unused):
            return up_jax.upwind_apply(gj, q, w)
    elif kind == "pair":
        def f(s, a, b):
            return jnp.where(jax.lax.stop_gradient(s) >= 0, a, b)
    else:
        f = _interface_upwind_jax()
    return f


class _Op:
    def __matmul__(self, other):
        return self

    def primary_to_mortar_avg(self):
        return self

    def secondary_to_mortar_avg(self):
        return self


def _interface_upwind_jax():
    """The function ``f`` of porepy_tpu's ``interface_upwind`` node
    (``AdvectiveFlux.interface_advective_flux``), taken from the method
    itself with its operators stubbed."""
    from porepy_tpu.models import constitutive_laws as cl_jax

    captured = {}

    class Function:
        def __init__(self, f, name, pattern_fn):
            captured[name] = f

        def __call__(self, *args):
            return None

    stub_ad = SimpleNamespace(MortarProjections=lambda *a, **k: _Op(), Trace=lambda *a: _Op(),
                              Function=Function)
    model = SimpleNamespace(interfaces_to_subdomains=lambda i: [], mdg=None, interface_darcy_flux=lambda i: None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cl_jax, "ad", stub_ad)
        cl_jax.AdvectiveFlux.interface_advective_flux(model, [], _Op(), None)
    return captured["interface_upwind"]


def _same(a, b) -> bool:
    """Equal, NaN where the other is NaN."""
    nan = torch.isnan(b)
    return a.shape == b.shape and torch.equal(torch.isnan(a), nan) and torch.equal(a[~nan], b[~nan])


def _plain_dual(kind, gt, primals, seeds):
    launcher = gt.launcher(kind, -1) if kind in ("flux", "apply") else ops.upwind_pair_launcher(kind, -1)
    return launcher(primals, seeds)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_dual_matches_jax_and_jvp(geoms, geom_jax, kind):
    """Value and every tangent row against porepy_tpu's function and
    ``jax.jvp`` at the same seeds (a missing seed is a zero tangent)."""
    import jax
    import jax.numpy as jnp

    gj, gt = geom_jax, geoms
    B = 4
    primals, seeds = _operands(kind, gt, B, seed=11)
    val, tan = _plain_dual(kind, gt, primals, seeds)
    f = _jax_fn(kind, gj)
    pj = [jnp.asarray(np.zeros(gt.lo.size) if p is None else p.numpy()) for p in primals]
    for b in range(B):
        tj = [jnp.zeros_like(p) if s is None else jnp.asarray(s[b].numpy()) for p, s in zip(pj, seeds)]
        want, want_t = jax.jvp(f, tuple(pj), tuple(tj))
        scale = max(float(np.abs(np.asarray(want)).max()), 1.0)
        assert np.abs(val.numpy() - np.asarray(want)).max() <= TOL * scale
        scale_t = max(float(np.abs(np.asarray(want_t)).max()), 1.0)
        assert np.abs(tan[b].numpy() - np.asarray(want_t)).max() <= TOL * scale_t


def test_interface_tie_and_nan_match_jax():
    """``lam = +-0`` takes the primary side, NaN the secondary, value and
    tangent as porepy_tpu's node gives them."""
    import jax
    import jax.numpy as jnp

    lam = np.array([1.5, 0.0, -0.0, -2.0, np.nan])
    a, b = np.arange(1.0, 6.0), -np.arange(1.0, 6.0)
    dlam, da, db = np.full(5, 0.5), np.full(5, 2.0), np.full(5, 3.0)
    want, want_t = jax.jvp(_interface_upwind_jax(), tuple(map(jnp.asarray, (lam, a, b))),
                           tuple(map(jnp.asarray, (dlam, da, db))))
    launcher = ops.upwind_pair_launcher("interface", -1)
    val, tan = launcher([torch.tensor(x) for x in (lam, a, b)], [torch.tensor(x)[None] for x in (dlam, da, db)])
    assert np.array_equal(val.numpy(), np.asarray(want), equal_nan=True)
    assert np.array_equal(tan[0].numpy(), np.asarray(want_t), equal_nan=True)


_CASES = [
    pytest.param(0, (), False, id="B0"),
    pytest.param(1, (), False, id="B1"),
    pytest.param(33, (), False, id="B33"),
    pytest.param(5, (), True, id="strided"),
    pytest.param(3, (0,), False, id="no_first_seed"),
    pytest.param(3, (1,), True, id="no_cell_or_first_candidate_seed"),
    pytest.param(3, (2,), False, id="no_last_seed"),
    pytest.param(3, (0, 2), False, id="one_seed"),
    pytest.param(3, (0, 1, 2), False, id="no_seed"),
]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("B, missing, strided", _CASES)
def test_plain_dual_equals_parent_route_to_the_bit(geoms, kind, B, missing, strided):
    """The one-launch function against the parent's route on the same
    operands: the value call and the tangent call of the parent's plain
    operators, and for the interface ``forward.mul``'s plain ``dual_ew``.
    The grid has missing cells on its boundary, Neumann faces and Dirichlet
    faces with inflow from outside, and the flux has zeros of both signs."""
    gt = geoms
    primals, seeds = _operands(kind, gt, B, seed=B + 7 * len(missing), missing=missing, strided=strided)
    g = _geometry(gt)
    launcher = gt.launcher(kind, -1) if kind in ("flux", "apply") else ops.upwind_pair_launcher(kind, -1)
    got = launcher(primals, seeds)
    want = upwind_calls.parent_route()(launcher, primals, seeds)
    assert _same(got[0], want[0])
    assert (got[1] is None) == (want[1] is None)
    if got[1] is not None:
        assert _same(got[1], want[1])
    # The kinds that read the geometry see each kind of face.
    dir_in = g[2] & torch.where(primals[0] >= 0, g[0] < 0, g[1] < 0)
    assert bool(g[3].any()) and bool(dir_in.any()) and bool((g[0] < 0).any())


def test_dual_rules_call_their_launcher_once(geoms, monkeypatch):
    """Each dual rule is one ``upwind_dual`` call (one launch on the card),
    the interface rule with its product inside."""
    gt = geoms
    calls = []
    plain = ops.upwind_dual

    def counted(launcher, primals, seeds=None):
        calls.append(launcher.kind)
        return plain(launcher, primals, seeds)

    monkeypatch.setattr(ops, "upwind_dual", counted)
    rng = np.random.default_rng(3)
    nf, nc, B = gt.lo.size, gt.num_cells, 4

    def dual(n):
        return Dual(torch.tensor(rng.standard_normal(n)), torch.tensor(rng.standard_normal((B, n))))

    q, w, bc = dual(nf), dual(nc), dual(nf)
    out = up_torch.upwind_flux_dual(gt, q, w, bc)
    assert out.tan.shape == (B, nf) and out.stacked() is not None
    up_torch.upwind_apply_dual(gt, q, w)
    up_torch.upwind_select_pair_dual(q, bc, Dual(bc.val))
    lam = up_torch.upwind_interface_dual(q, bc, dual(nf))
    assert calls == ["flux", "apply", "pair", "interface"]
    assert lam.tan.shape == (B, nf)


def _prepared(build, cell_size):
    Model, params = build(cell_size, device="cpu")
    model = Model(params)
    model.prepare_simulation()
    return model


@pytest.mark.parametrize("case, calls", [("md", ["flux", "interface", "interface"]),
                                         ("tracer", ["flux", "interface", "interface"] * 2)])
def test_assembly_equals_parent_rules_to_the_bit(case, calls):
    """One assembly of md 1/16 and of tracer 1/16 (the compiled system's
    K8 pass) makes one ``upwind_dual`` call a rule (md 3, tracer 6; the
    parent made 6 and 12 K15 calls and 2 and 4 ``dual_ew`` products), and
    equals the assembly through the parent's rules to the bit."""
    build = cases.build_md_flow if case == "md" else cases.build_tracer
    model = _prepared(build, 1.0 / 16)
    es = model.equation_system
    cs = es.compiled_system()
    captured = upwind_calls.assembly_calls(model, case)
    assert [c["kind"] for c in captured] == calls
    assert all(upwind_calls.batch_of(c) > 0 for c in captured)
    got = [t.clone() for t in cs.assemble(es)]
    with upwind_calls.parent_rules():
        want = cs.assemble(es)
    for a, b in zip(got, want):
        assert _same(a, b)


def test_launcher_refuses_what_the_kernel_does_not_take(geoms):
    """A launch needs CUDA tensors, both candidates cannot be missing, a
    geometry-less kind takes no geometry, and a kind is one of four."""
    gt = geoms
    q = torch.zeros(gt.lo.size, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        gt.launcher("flux", -1).rows((q, torch.zeros(gt.num_cells, dtype=torch.float64), q))
    with pytest.raises(ValueError, match="candidate"):
        ops.upwind_select_pair(q, None, None)
    with pytest.raises(ValueError, match="geometry"):
        ops.UpwindLauncher("pair", _geometry(gt))
    with pytest.raises(ValueError, match="kind"):
        ops.UpwindLauncher("select")


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_launch_equals_plain_at_tile_edges(cuda, kind):
    """One launch a call, the value and tangent rows equal to the plain
    version to the bit at sizes around the 64-element tile, B = 0, 1, 33,
    missing seeds and strided rows."""
    rng = np.random.default_rng(17)
    for n in (1, 63, 64, 65, 200):
        nc = max(n // 2, 1)
        lo = torch.tensor(rng.integers(-1, nc, n), device=cuda)
        hi = torch.tensor(rng.integers(-1, nc, n), device=cuda)
        is_dir = torch.tensor(rng.random(n) < 0.3, device=cuda)
        is_neu = torch.tensor(rng.random(n) < 0.2, device=cuda) & ~is_dir
        sgn = torch.tensor(rng.choice([-1.0, 1.0], n), device=cuda)
        geometry = (lo, hi, is_dir, is_neu, sgn) if kind in ("flux", "apply") else None
        launcher = ops.UpwindLauncher(kind, geometry)
        n1 = nc if kind in ("flux", "apply") else n
        for B, missing in ((0, ()), (1, ()), (33, ()), (3, (0,)), (3, (1,)), (3, (2,))):
            s = torch.tensor(_direction(rng, n), device=cuda)
            primals = [s, torch.tensor(rng.standard_normal(n1), device=cuda),
                       torch.tensor(rng.standard_normal(n), device=cuda)]
            seeds = None
            if B:
                seeds = [None if i in missing else torch.tensor(rng.standard_normal((B, m + 3)), device=cuda)[:, :m]
                         for i, m in enumerate((n, n1, n))]
                if all(seeds[i] is None for i in ops._UPWIND_SEEDS[kind]):
                    seeds = None
            before = dict(ops.LAUNCHES)
            got = launcher(primals, seeds)
            torch.cuda.synchronize()
            assert ops.LAUNCHES[launcher.name] == before[launcher.name] + 1
            assert sum(ops.LAUNCHES.values()) == sum(before.values()) + 1
            want = reference.upwind_dual(kind, geometry, primals, seeds)
            assert _same(got[0], want[0])
            assert (got[1] is None) == (want[1] is None)
            if got[1] is not None:
                assert _same(got[1], want[1])


@pytest.mark.cuda
def test_cuda_entry_points_are_one_launch_of_the_kernel(cuda, geoms):
    """The ``torch.func`` route's entry points: a value launch, or a launch
    of the tangent rows alone, equal to the plain versions."""
    gt = geoms
    g = _geometry(gt, cuda)
    rng = np.random.default_rng(5)
    nf, nc, B = gt.lo.size, gt.num_cells, 6
    dev = lambda a: torch.tensor(a, device=cuda)  # noqa: E731
    q, w, bc = dev(_direction(rng, nf)), dev(rng.standard_normal(nc)), dev(rng.standard_normal(nf))
    dq, dw = dev(rng.standard_normal((B, nf))), dev(rng.standard_normal((B, nc)))
    before = ops.LAUNCHES["upwind_flux"]
    assert _same(ops.upwind_flux(q, w, bc, *g), reference.upwind_flux(q, w, bc, *g))
    assert _same(ops.upwind_flux_tangent(q, w, bc, dq, dw, None, *g),
                 reference.upwind_flux_tangent(q, w, bc, dq, dw, None, *g))
    assert ops.LAUNCHES["upwind_flux"] == before + 2
    qs = dev(rng.standard_normal((B, nf)))
    assert _same(ops.upwind_flux(qs, w, bc, *g), reference.upwind_flux(qs, w, bc, *g))
    assert _same(ops.upwind_select(qs, dw, *g[:4]), reference.upwind_select(qs, dw, *g[:4]))
    assert _same(ops.upwind_select_pair(q, dq, None), reference.upwind_select_pair(q, dq, None))
