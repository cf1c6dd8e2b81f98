"""K14's one-launch op ``kernels.tpfa_ad_dual`` (the value and all tangents
of the differentiable TPFA flux or pressure trace of one subdomain, behind
the geometry's ``TpfaAdLauncher``) on the CPU, where it runs its plain
version: against porepy_tpu's ``flux_fn``/``trace_fn`` and ``jax.jvp`` with
the seeds the model's path hands it (``dvol`` and ``dbco`` None), the same
bits as the separate value and tangent calls it replaced, the trace's list
of boundary faces, a cell of zero permeability, and a ``DarcysLawAd``
assembly through the dual rule against the two-call route. The kernel
itself is held to this plain version on a card by
``test_cuda_tpfa_ad_kernels_match_plain`` in ``test_torch_darcys_law_ad.py``
and by ``chip_smoke.py`` phase 19, and to the parent's value and tangent
launches by the test marked ``cuda`` here; run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tpfa_ad_dual.py -m cuda
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import porepy_tpu as pt_jax
import porepy_tpu_torch as pt_torch
from porepy_tpu.models.darcys_law_ad import _DiffTpfaGeometry as GeomJax
from porepy_tpu_torch import interop
from porepy_tpu_torch.applications.benchmarking.cases import build_darcy_ad
from porepy_tpu_torch.kernels import ops, reference
from porepy_tpu_torch.models.darcys_law_ad import _DiffTpfaGeometry as GeomTorch
from test_torch_darcys_law_ad import GRIDS, TOL_KERNEL, _close, _fields

torch.set_num_threads(1)

# The seeds of the model's path: dk9, dp and dlam; dvol and dbco None.
PATH_SEEDS = (True, False, True, False, True)


def _geometries(grid):
    sds_j, bc_j = GRIDS[grid](pt_jax)
    sds_t, bc_t = GRIDS[grid](pt_torch)
    gj, gt = GeomJax(sds_j, bc_j), GeomTorch(sds_t, bc_t)
    return gj, gt, interop.tpfa_ad_geometry_from(gj, "cpu")


def _spans(gt, i):
    co, fo = gt.cell_offsets, gt.face_offsets
    return ((9 * co[i], 9 * co[i + 1]), (co[i], co[i + 1]), (co[i], co[i + 1]),
            (fo[i], fo[i + 1]), (fo[i], fo[i + 1]))


def _seeds(gt, B, live, seed):
    """``B`` rows of each seed (numpy), zero where ``live`` is false."""
    rng = np.random.default_rng(seed)
    nc, nf = gt.num_cells, gt.num_faces
    sizes = (9 * nc, nc, nc, nf, nf)
    return [rng.standard_normal((B, n)) if on else np.zeros((B, n)) for n, on in zip(sizes, live)]


def _dual_all(kgeoms, gt, primals, seeds, live, trace):
    """The op over every subdomain, concatenated: ``(value, tangents)``."""
    vals, tans = [], []
    for i, kg in enumerate(kgeoms):
        spans = _spans(gt, i)
        prim = [torch.tensor(p[lo:hi]) for p, (lo, hi) in zip(primals, spans)]
        sd = [torch.tensor(s[:, lo:hi]) if on else None for s, on, (lo, hi) in zip(seeds, live, spans)]
        val, tan = ops.tpfa_ad_dual(kg, prim, sd, trace)
        vals.append(val)
        tans.append(tan)
    return torch.cat(vals), torch.cat(tans, dim=1)


@pytest.mark.parametrize("B", [1, 3, 10])
@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("which", ["flux", "trace"])
def test_dual_plain_matches_jax(which, grid, B):
    """(a) Value and B tangents of one call against porepy_tpu's function
    and ``jax.jvp`` (the absent seeds as zero tangents there)."""
    gj, gt, kgeoms = _geometries(grid)
    trace = which == "trace"
    f_jax = gj.trace_fn() if trace else gj.flux_fn()
    primals, _ = _fields(gt, "full", zero_cell=False, seed=31 * B + len(grid) + len(which))
    seeds = _seeds(gt, B, PATH_SEEDS, seed=B)
    val, tan = _dual_all(kgeoms, gt, primals, seeds, PATH_SEEDS, trace)
    pj = tuple(map(jnp.asarray, primals))
    want = f_jax(*pj)
    want_t = jax.vmap(lambda *t: jax.jvp(f_jax, pj, t)[1])(*map(jnp.asarray, seeds))
    assert tan.shape == (B, gt.num_faces)
    _close(val.numpy(), want, TOL_KERNEL)
    _close(tan.numpy(), want_t, TOL_KERNEL)


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("which", ["flux", "trace"])
def test_dual_equals_the_separate_calls(which, grid):
    """(b) One call gives the bits of the value call and the tangent call
    that the dual rule made before, for the path's seeds and for every
    seed; with no seed it gives the value alone. On the CPU both sides run
    the plain version, so this holds the op's wiring (rows, seeds, the
    value alone); ``test_cuda_dual_equals_the_parents_pair`` holds the
    launch against the parent's two launches."""
    _gj, gt, kgeoms = _geometries(grid)
    trace = which == "trace"
    plain = reference.tpfa_ad_trace if trace else reference.tpfa_ad_flux
    value_op = ops.tpfa_ad_trace if trace else ops.tpfa_ad_flux
    tangent_op = ops.tpfa_ad_trace_tangent if trace else ops.tpfa_ad_flux_tangent
    primals, _ = _fields(gt, "iso", zero_cell=False, seed=7)
    for live in (PATH_SEEDS, (True,) * 5):
        seeds = _seeds(gt, 4, live, seed=8)
        for i, kg in enumerate(kgeoms):
            spans = _spans(gt, i)
            prim = [torch.tensor(p[lo:hi]) for p, (lo, hi) in zip(primals, spans)]
            sd = [torch.tensor(s[:, lo:hi]) if on else None for s, on, (lo, hi) in zip(seeds, live, spans)]
            val, tan = ops.tpfa_ad_dual(kg, prim, sd, trace)
            assert torch.equal(val, plain(kg, *prim))
            assert torch.equal(val, value_op(kg, *prim))
            assert torch.equal(tan, reference.tpfa_ad_tangent(plain, kg, prim, sd))
            assert torch.equal(tan, tangent_op(kg, prim, sd))
            val0, tan0 = ops.tpfa_ad_dual(kg, prim, [None] * 5, trace)
            assert tan0 is None and torch.equal(val0, val)
            assert ops.tpfa_ad_dual(kg, prim, None, trace)[1] is None


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_boundary_list_matches_masks(grid):
    """(c) The geometry's list of raw Dirichlet or Neumann faces, built once
    through ``interop.tpfa_ad_geometry_from``, against porepy_tpu's masks;
    carried through ``tensors()``/``trusted()``, and one launcher per kind."""
    gj, gt, kgeoms = _geometries(grid)
    for kg, bnd, kt in zip(kgeoms, gj.masks, gt.kernel_geometry("cpu")):
        want = np.flatnonzero(np.asarray(bnd.is_dir_raw) | np.asarray(bnd.is_neu_raw))
        got = kg["boundary_faces"]
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
        assert want.size and want.size < kg.num_faces
        assert np.array_equal(kt["boundary_faces"].numpy(), want)
        again = ops.TpfaAdGeometry.trusted(kg.tensors())
        assert len(kg.tensors()) == len(ops.TpfaAdGeometry.TENSORS)
        assert torch.equal(again["boundary_faces"], got)
        assert kg.launcher(True) is kg.launcher(True) and kg.launcher(False) is not kg.launcher(True)
        assert kg.launcher(True).name == "tpfa_ad_trace" and kg.launcher(False).name == "tpfa_ad_flux"


@pytest.mark.parametrize("which", ["flux", "trace"])
def test_zero_permeability_cell_non_finite_where_jax(which):
    """(d) A cell with ``K = 0``: the one call's tangent is non-finite on
    exactly the faces where ``jax.jvp`` of porepy_tpu's function is, with
    the path's seeds, and equal elsewhere; the values agree."""
    gj, gt, kgeoms = _geometries("cart_3d")
    trace = which == "trace"
    f_jax = gj.trace_fn() if trace else gj.flux_fn()
    primals, _ = _fields(gt, "full", zero_cell=True, seed=5)
    seeds = _seeds(gt, 3, PATH_SEEDS, seed=6)
    val, tan = _dual_all(kgeoms, gt, primals, seeds, PATH_SEEDS, trace)
    pj = tuple(map(jnp.asarray, primals))
    want_t = np.asarray(jax.vmap(lambda *t: jax.jvp(f_jax, pj, t)[1])(*map(jnp.asarray, seeds)))
    _close(val.numpy(), f_jax(*pj), TOL_KERNEL)
    bad = ~np.isfinite(tan.numpy())
    assert np.array_equal(bad, ~np.isfinite(want_t))
    _close(tan.numpy(), want_t, TOL_KERNEL)
    # The flux's tangent is non-finite on the zero cell's faces; the trace
    # keeps it off faces that are not Neumann.
    if not trace:
        assert bad.any()
    else:
        assert not bad[:, ~kgeoms[0]["is_neu_raw"].numpy()].any()


def test_darcy_ad_assembly_one_call_per_subdomain():
    """(e) A ``DarcysLawAd`` assembly (1/16, both subdomains) through the
    dual rule's one call a subdomain and function gives the Jacobian and
    residual of the two-call route (the value, then the tangents, as the
    rule called them before) to the bit."""
    Model, params = build_darcy_ad(1.0 / 16, "cpu")
    model = Model(params)
    model.prepare_simulation()
    es = model.equation_system
    cs = es.compiled_system()
    x0 = es._global_vector()
    rng = np.random.default_rng(12)
    x = torch.tensor(x0 + 0.05 * (np.abs(x0).max() + 1.0) * rng.uniform(0.0, 1.0, x0.size))
    envs = cs._envs(es)
    n_sub = len([sd for sd in model.mdg.subdomains() if sd.dim > 0])
    calls = {False: [], True: []}
    one_call = ops.tpfa_ad_dual

    def counted(geom, primals, seeds=None, trace=False):
        out = one_call(geom, primals, seeds, trace)
        calls[bool(trace)].append(out[1].shape[0])
        return out

    def two_calls(geom, primals, seeds=None, trace=False):
        plain = reference.tpfa_ad_trace if trace else reference.tpfa_ad_flux
        return plain(geom, *primals), reference.tpfa_ad_tangent(plain, geom, primals, seeds)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "tpfa_ad_dual", counted)
        data, rhs = cs._data_and_rhs(x, envs)
        mp.setattr(ops, "tpfa_ad_dual", two_calls)
        data2, rhs2 = cs._data_and_rhs(x, envs)
    assert n_sub == 2 and len(calls[False]) == n_sub and len(calls[True]) == n_sub
    assert min(calls[False] + calls[True]) >= 1
    assert torch.equal(data, data2) and torch.equal(rhs, rhs2)
    assert torch.isfinite(data).all() and torch.isfinite(rhs).all()


# -- on the card ------------------------------------------------------------------


@pytest.fixture(scope="module")
def parent_pair(tmp_path_factory):
    """The parent's value and tangent launches (``tpfa_ad_check.parent_dual``,
    built from ``parent_tpfa_ad/tpfa_ad.cu``); skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from porepy_tpu_torch.applications.benchmarking import tpfa_ad_check

    tpfa_ad_check.parent_library(str(tmp_path_factory.mktemp("parent_k14")))
    return tpfa_ad_check.parent_dual


@pytest.mark.cuda
@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("which", ["flux", "trace"])
def test_cuda_dual_equals_the_parents_pair(parent_pair, which, grid):
    """(b) on the card: the one launch gives the bits of the parent's value
    launch and tangent launch, for the path's seeds and for every seed, and
    the parent's value launch alone without a seed."""
    _gj, gt, _kgeoms = _geometries(grid)
    trace = which == "trace"
    primals, _ = _fields(gt, "iso", zero_cell=False, seed=7)
    for live in (PATH_SEEDS, (True,) * 5):
        seeds = _seeds(gt, 4, live, seed=8)
        for i, kg in enumerate(gt.kernel_geometry("cuda")):
            spans = _spans(gt, i)
            prim = [torch.tensor(p[lo:hi], device="cuda") for p, (lo, hi) in zip(primals, spans)]
            sd = [torch.tensor(s[:, lo:hi], device="cuda") if on else None
                  for s, on, (lo, hi) in zip(seeds, live, spans)]
            for seed_set in (sd, None):
                got = ops.tpfa_ad_dual(kg, prim, seed_set, trace)
                want = parent_pair(kg, prim, seed_set, trace)
                assert (got[1] is None) == (seed_set is None) == (want[1] is None)
                assert all(torch.equal(a, b) for a, b in zip(got, want) if a is not None)
