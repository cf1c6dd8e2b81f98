"""The upstream selection (K15) of porepy_tpu_torch against porepy_tpu on
the CPU (the plain versions of the kernels): ``upwind_apply``, the boundary
masks and the advective face flux, their forward-mode tangents against
``jax.jvp``, the batched seeds of the assembly (``vmap`` over ``jvp``), and
the tie conventions (``q = 0.0`` and ``q = -0.0`` pick ``lo``; the interface
selection takes the primary side at ``lam = 0``; ``maximum`` at equal
arguments follows the first argument). The tests marked ``cuda`` hold the
kernels against their plain versions on a card; run them there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_upwind_kernel.py -m cuda
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import porepy_tpu as pt_jax
import porepy_tpu_torch as pt_torch
from porepy_tpu.numerics.fv import upwind as up_jax
from porepy_tpu_torch.kernels import functions as kfn
from porepy_tpu_torch.kernels import ops, reference
from porepy_tpu_torch.numerics.fv import upwind as up_torch

torch.set_num_threads(1)

# Against jax: both sides run the same IEEE operations on the same inputs;
# the sums of two or three products may be taken in another order.
TOL = 1e-14


def _grid_and_bc(pt, n=6):
    g = pt.CartGrid(np.array([n, n]), np.array([1.0, 1.0]))
    g.compute_geometry()
    faces = g.get_all_boundary_faces()
    west_south = faces[(g.face_centers[0, faces] < 1e-9) | (g.face_centers[1, faces] < 1e-9)]
    bc = pt.BoundaryCondition(g, west_south, "dir")
    return g, bc


@pytest.fixture(scope="module")
def geoms():
    gj, bcj = _grid_and_bc(pt_jax)
    gt, bct = _grid_and_bc(pt_torch)
    return up_jax.UpwindGeometry([gj], [bcj]), up_torch.UpwindGeometry([gt], [bct])


def _fields(geom_t, seed=0, ties=True):
    """Face flux with both signs on every kind of face, exact zeros of both
    signs among them, a cell field and boundary values."""
    rng = np.random.default_rng(seed)
    nf, nc = geom_t.lo.size, geom_t.num_cells
    q = rng.standard_normal(nf)
    if ties:
        q[::5] = 0.0
        q[2::7] = -0.0
    return q, rng.standard_normal(nc), rng.standard_normal(nf)


def _flux_jax(gj):
    def f(q, w, bc):
        dir_mask, neu_coeff = up_jax.upwind_boundary_masks(gj, q)
        return q * up_jax.upwind_apply(gj, q, w) + dir_mask * q * bc + neu_coeff * bc

    return f


def test_apply_and_masks_match_jax_with_ties(geoms):
    gj, gt = geoms
    q, w, _bc = _fields(gt)
    want = np.asarray(up_jax.upwind_apply(gj, jnp.asarray(q), jnp.asarray(w)))
    got = up_torch.upwind_apply(gt, torch.tensor(q), torch.tensor(w)).numpy()
    assert np.array_equal(got, want)
    want_masks = up_jax.upwind_boundary_masks(gj, jnp.asarray(q))
    got_masks = up_torch.upwind_boundary_masks(gt, torch.tensor(q))
    for a, b in zip(got_masks, want_masks):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("zero", [0.0, -0.0], ids=["plus_zero", "minus_zero"])
def test_zero_flux_picks_lo(geoms, zero):
    """``q = 0.0`` and ``q = -0.0`` both count as flow from ``lo`` (``>=``
    in IEEE arithmetic), in both packages."""
    gj, gt = geoms
    nf, nc = gt.lo.size, gt.num_cells
    w = np.arange(1.0, nc + 1.0)
    q = np.full(nf, zero)
    got = up_torch.upwind_apply(gt, torch.tensor(q), torch.tensor(w)).numpy()
    want = np.asarray(up_jax.upwind_apply(gj, jnp.asarray(q), jnp.asarray(w)))
    assert np.array_equal(got, want)
    interior = (gt.lo >= 0) & (gt.hi >= 0)
    assert interior.any() and np.array_equal(got[interior], w[gt.lo[interior]])
    # NaN is not >= 0: the other side.
    got_nan = up_torch.upwind_apply(gt, torch.tensor(np.full(nf, np.nan)), torch.tensor(w)).numpy()
    assert np.array_equal(got_nan[interior], w[gt.hi[interior]])


def test_flux_and_tangents_match_jax(geoms):
    gj, gt = geoms
    q, w, bc = _fields(gt, seed=1)
    dq, dw, dbc = _fields(gt, seed=2, ties=False)
    f_jax = _flux_jax(gj)
    want, want_t = jax.jvp(
        f_jax, tuple(map(jnp.asarray, (q, w, bc))), tuple(map(jnp.asarray, (dq, dw, dbc)))
    )
    got, got_t = torch.func.jvp(
        lambda *a: up_torch.upwind_flux(gt, *a),
        tuple(map(torch.tensor, (q, w, bc))),
        tuple(map(torch.tensor, (dq, dw, dbc))),
    )
    scale = max(np.abs(np.asarray(want)).max(), 1.0)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL * scale
    scale_t = max(np.abs(np.asarray(want_t)).max(), 1.0)
    assert np.abs(got_t.numpy() - np.asarray(want_t)).max() <= TOL * scale_t


def test_flux_seeds_batch_into_one_call(geoms, monkeypatch):
    """``vmap`` over ``jvp`` hands the whole batch of seeds to one call of
    the tangent operator; an input that carries no seed arrives as one
    unbatched row of zeros."""
    gj, gt = geoms
    q, w, bc = map(torch.tensor, _fields(gt, seed=3))
    rng = np.random.default_rng(4)
    B = 5
    dqs = torch.tensor(rng.standard_normal((B, q.numel())))
    dws = torch.tensor(rng.standard_normal((B, w.numel())))
    calls = []
    plain = ops.upwind_flux_tangent

    def counted(*args):
        calls.append(tuple(None if a is None else tuple(a.shape) for a in args[3:6]))
        return plain(*args)

    monkeypatch.setattr(ops, "upwind_flux_tangent", counted)

    def one(dq, dw):
        # bc is a constant of the residual: no seed.
        return torch.func.jvp(lambda a, b: up_torch.upwind_flux(gt, a, b, bc), (q, w), (dq, dw))

    val, tan = torch.func.vmap(one)(dqs, dws)
    assert calls == [((B, q.numel()), (B, w.numel()), (q.numel(),))]
    f_jax = _flux_jax(gj)
    for b in range(B):
        _v, want_t = jax.jvp(
            lambda a, c: f_jax(a, c, jnp.asarray(bc.numpy())),
            (jnp.asarray(q.numpy()), jnp.asarray(w.numpy())),
            (jnp.asarray(dqs[b].numpy()), jnp.asarray(dws[b].numpy())),
        )
        assert np.abs(tan[b].numpy() - np.asarray(want_t)).max() <= TOL * 10
    assert torch.equal(val[0], up_torch.upwind_flux(gt, q, w, bc))


def test_batched_primal_flux(geoms):
    """A batch of primal fluxes (``vmap`` over the value) selects per row."""
    _gj, gt = geoms
    rng = np.random.default_rng(5)
    qs = torch.tensor(rng.standard_normal((3, gt.lo.size)))
    _q, w, bc = map(torch.tensor, _fields(gt, seed=6))
    got = torch.func.vmap(lambda a: up_torch.upwind_flux(gt, a, w, bc))(qs)
    for b in range(3):
        assert torch.equal(got[b], up_torch.upwind_flux(gt, qs[b], w, bc))


def test_interface_selection_tie_matches_jax():
    """``lam >= 0`` takes the primary trace, ``lam = +-0`` included; the
    tangent follows the same side and none comes through the selection."""
    lam = np.array([1.5, 0.0, -0.0, -2.0, np.nan])
    wp, ws = np.arange(1.0, 6.0), -np.arange(1.0, 6.0)
    dlam, dwp, dws = np.full(5, 0.5), np.full(5, 2.0), np.full(5, 3.0)

    def f_jax(lam_v, a, b):
        take_primary = jax.lax.stop_gradient(lam_v) >= 0
        return lam_v * jnp.where(take_primary, a, b)

    want, want_t = jax.jvp(
        f_jax, tuple(map(jnp.asarray, (lam, wp, ws))), tuple(map(jnp.asarray, (dlam, dwp, dws)))
    )
    got, got_t = torch.func.jvp(
        lambda l, a, b: l * up_torch.upwind_select_pair(l, a, b),
        tuple(map(torch.tensor, (lam, wp, ws))),
        tuple(map(torch.tensor, (dlam, dwp, dws))),
    )
    assert np.array_equal(got.numpy(), np.asarray(want), equal_nan=True)
    assert np.array_equal(got_t.numpy(), np.asarray(want_t), equal_nan=True)
    sel = up_torch.upwind_select_pair(*map(torch.tensor, (lam, wp, ws))).numpy()
    assert np.array_equal(sel, [1.0, 2.0, 3.0, -4.0, -5.0])


def test_maximum_tie_takes_first_argument_derivative():
    """``maximum(a, b)`` at ``a == b`` carries the first argument's
    derivative, as in porepy_tpu."""
    from porepy_tpu.grids.md_grid import MixedDimensionalGrid as MdgJax
    from porepy_tpu_torch.grids.md_grid import MixedDimensionalGrid as MdgTorch

    a = np.array([1.0, 2.0, 3.0, 0.0])
    vals = {}
    for pt, key, Mdg, kwargs in (
        (pt_jax, "jax", MdgJax, {}), (pt_torch, "torch", MdgTorch, {"device": "cpu"})
    ):
        g = pt.CartGrid(np.array([4, 1]), np.array([1.0, 1.0]))
        g.compute_geometry()
        mdg = Mdg()
        mdg.add_subdomains([g])
        es = pt.ad.EquationSystem(mdg, **kwargs)
        es.create_variables("x", {"cells": 1}, subdomains=[g])
        es.set_variable_values(a, ["x"], iterate_index=0, time_step_index=0)
        x = es.md_variable("x", [g])
        op = pt.ad.functions.maximum(pt.ad.Scalar(3.0) * x, x + pt.ad.DenseArray(2.0 * a))
        res = op.value_and_jacobian(es)
        vals[key] = (np.asarray(res.val), res.jac.toarray())
    assert np.array_equal(vals["torch"][0], vals["jax"][0])
    assert np.array_equal(vals["torch"][1], vals["jax"][1])
    # 3 x == x + 2 a at x = a: the tie everywhere; derivative 3 of the first.
    assert np.array_equal(np.diag(vals["torch"][1]), np.full(4, 3.0))


def test_wrappers_refuse_what_the_kernel_does_not_take():
    """The CUDA path raises on a CPU tensor handed to it directly, and the
    operators raise without any seed or candidate: nothing falls back."""
    q = torch.zeros(4, dtype=torch.float64)
    idx = torch.zeros(4, dtype=torch.int64)
    flag = torch.zeros(4, dtype=torch.bool)
    with pytest.raises((ValueError, TypeError)):
        ops._upwind_flux_cuda(q, q, q, None, None, None, idx, idx, flag, flag, q, False)
    with pytest.raises(ValueError, match="at least one seed"):
        ops.upwind_flux_tangent(q, q, q, None, None, None, idx, idx, flag, flag, q)
    with pytest.raises(ValueError, match="at least one candidate"):
        ops.upwind_select_pair(q, None, None)


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_upwind_kernels_match_plain(cuda, geoms):
    _gj, gt = geoms
    g = gt.on(cuda)
    gc = gt.on("cpu")
    q, w, bc = _fields(gt, seed=7)
    rng = np.random.default_rng(8)
    B = 16
    seeds = [rng.standard_normal((B, n)) for n in (q.size, w.size, bc.size)]
    dev = lambda a: torch.tensor(a, device=cuda)  # noqa: E731
    geo = (g["lo"], g["hi"], g["is_dir"], g["is_neu"], g["sgn_div"])
    geo_c = (gc["lo"], gc["hi"], gc["is_dir"], gc["is_neu"], gc["sgn_div"])
    got = ops.upwind_flux(dev(q), dev(w), dev(bc), *geo).cpu()
    want = reference.upwind_flux(*map(torch.tensor, (q, w, bc)), *geo_c)
    assert torch.equal(got, want)
    got_t = ops.upwind_flux_tangent(dev(q), dev(w), dev(bc), *map(dev, seeds), *geo).cpu()
    want_t = reference.upwind_flux_tangent(
        *map(torch.tensor, (q, w, bc)), *map(torch.tensor, seeds), *geo_c
    )
    assert (got_t - want_t).abs().max() <= 1e-12 * want_t.abs().max()
    got_s = ops.upwind_select(dev(q), dev(seeds[1]), *geo[:4]).cpu()
    want_s = reference.upwind_select(torch.tensor(q), torch.tensor(seeds[1]), *geo_c[:4])
    assert torch.equal(got_s, want_s)
    s, a, b = dev(q), dev(seeds[0]), dev(seeds[2])
    assert torch.equal(
        ops.upwind_select_pair(s, a, None).cpu(),
        reference.upwind_select_pair(s.cpu(), a.cpu(), None),
    )
    assert torch.equal(
        ops.upwind_select_pair(s, a, b).cpu(),
        reference.upwind_select_pair(s.cpu(), a.cpu(), b.cpu()),
    )
    # Through the autograd functions, as the assembly calls them.
    val, tan = torch.func.vmap(
        lambda dq, dw: torch.func.jvp(
            lambda x, y: kfn.upwind_flux(x, y, dev(bc), *geo), (dev(q), dev(w)), (dq, dw)
        )
    )(dev(seeds[0]), dev(seeds[1]))
    want_t2 = reference.upwind_flux_tangent(
        *map(torch.tensor, (q, w, bc)), torch.tensor(seeds[0]), torch.tensor(seeds[1]), None, *geo_c
    )
    assert torch.equal(val[0].cpu(), want)
    assert (tan.cpu() - want_t2).abs().max() <= 1e-12 * want_t2.abs().max()
