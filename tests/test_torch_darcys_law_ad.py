"""The differentiable TPFA flux path (K14, ``DarcysLawAd``) of
porepy_tpu_torch against porepy_tpu on the CPU: the plain versions of the
``tpfa_ad_flux``, ``tpfa_ad_trace`` and ``segment_sum_sorted`` kernels and
the port's ``flux_fn``/``trace_fn`` against porepy_tpu's, values and
``jax.jvp`` tangents, on a 2d fractured and a 3d Cartesian grid, isotropic
and full tensors, with a cell of zero permeability; and the three model
tests of ``tests/models/test_darcys_law_ad.py`` in the port, values and
Jacobians also compared with porepy_tpu. The test marked ``cuda`` holds the
kernels against their plain versions on a card; run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_darcys_law_ad.py -m cuda
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
from porepy_tpu_torch.kernels import functions as kfn
from porepy_tpu_torch.kernels import ops
from porepy_tpu_torch.models.darcys_law_ad import _DiffTpfaGeometry as GeomTorch
from porepy_tpu_torch.numerics.fv.fv_mesh import FvMesh

torch.set_num_threads(1)

# Plain versions against jax: the same operations, sums of two or three
# terms possibly in another order; relative to the largest entry.
TOL_KERNEL = 1e-13
# Model values and Jacobians against porepy_tpu.
TOL_MODEL = 1e-12


def _base_flow(pt):
    class BaseFlow(pt.SinglePhaseFlow):
        def initialize_data_saving(self):
            pass

        def save_data_time_step(self):
            pass

        def bc_values_pressure(self, bg):
            return 1.0 - bg.cell_centers[0]

        def darcy_flux_discretization(self, subdomains):
            return pt.ad.TpfaAd(self.darcy_keyword, subdomains, self.mdg)

    return BaseFlow


def _ad_flow(pt):
    class AdFlow(pt.DarcysLawAd, _base_flow(pt)):
        pass

    return AdFlow


def _nonlinear_flow(pt):
    class PressureDependentPerm:
        """k(p) = k0 * (1 + 0.3 p), mixed in above the Ad law."""

        def permeability(self, subdomains):
            size = sum(sd.num_cells for sd in subdomains)
            k0 = pt.ad.wrap_as_dense_ad_array(self.solid.permeability, size)
            k = k0 * (pt.ad.Scalar(1.0) + pt.ad.Scalar(0.3) * self.pressure(subdomains))
            return self.isotropic_second_order_tensor(subdomains, k)

    class NonlinearFlow(PressureDependentPerm, _ad_flow(pt)):
        pass

    return NonlinearFlow


def _cubic_law_md(pt):
    class CubicLawMd(
        pt.DarcysLawAd, pt.constitutive_laws.CubicLawPermeability, _base_flow(pt)
    ):
        def set_fractures(self):
            self._fractures = [pt.LineFracture(np.array([[0.25, 0.75], [0.5, 0.5]]))]

    return CubicLawMd


def _params(pt, extra=None):
    params = {
        "grid_type": "cartesian",
        "meshing_arguments": {"cell_size": 0.25},
        "material_constants": {
            "solid": pt.SolidConstants(permeability=2.0, porosity=0.1),
        },
    }
    if pt is pt_torch:
        params["device"] = "cpu"
    params.update(extra or {})
    return params


def _cubic_params(pt):
    return _params(
        pt,
        {
            "material_constants": {
                "solid": pt.SolidConstants(
                    permeability=1.0,
                    porosity=0.1,
                    residual_aperture=1e-3,
                    normal_permeability=1.0,
                ),
            },
        },
    )


# -- the kernels' plain versions against porepy_tpu -------------------------------


def _fractured_2d(pt):
    m = _cubic_law_md(pt)(_cubic_params(pt))
    m.prepare_simulation()
    sds = [sd for sd in m.mdg.subdomains() if sd.dim > 0]
    return sds, m.bc_type_darcy_flux


def _cart_3d(pt):
    g = pt.CartGrid(np.array([4, 3, 3]), np.array([1.0, 1.0, 1.0]))
    g.compute_geometry()
    faces = g.get_all_boundary_faces()
    dir_faces = faces[g.face_centers[0, faces] < 0.6]

    def bc_of(sd):
        return pt.BoundaryCondition(sd, dir_faces, "dir")

    return [g], bc_of


GRIDS = {"fractured_2d": _fractured_2d, "cart_3d": _cart_3d}


def _fields(geom, tensor, zero_cell, seed):
    """Primal fields and two seeds of each; ``k9`` symmetric positive
    definite per cell (``tensor="full"``) or a multiple of the identity."""
    rng = np.random.default_rng(seed)
    nc, nf = geom.num_cells, geom.num_faces

    def k9_of(scale):
        if tensor == "iso":
            k = scale[:, None, None] * np.eye(3)[None]
        else:
            a = rng.standard_normal((nc, 3, 3))
            k = scale[:, None, None] * (np.eye(3)[None] + 0.1 * (a + a.transpose(0, 2, 1)))
        return k.reshape(-1)

    scale = 0.5 + rng.random(nc)
    if zero_cell:
        scale[nc // 2] = 0.0
    primals = (k9_of(scale), 0.5 + rng.random(nc), rng.standard_normal(nc),
               rng.standard_normal(nf), rng.standard_normal(nf))
    seeds = [
        (k9_of(rng.standard_normal(nc)), rng.standard_normal(nc), rng.standard_normal(nc),
         rng.standard_normal(nf), rng.standard_normal(nf))
        for _ in range(2)
    ]
    return primals, seeds


def _close(got, want, tol):
    want = np.asarray(want)
    got = np.asarray(got)
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    scale = max(np.abs(want[fin]).max(), 1.0) if fin.any() else 1.0
    assert np.abs(got[fin] - want[fin]).max() <= tol * scale


@pytest.mark.parametrize("tensor", ["iso", "full"])
@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("which", ["flux", "trace"])
def test_flux_and_trace_match_jax(which, grid, tensor):
    """Values and tangents of the op's plain version (from porepy_tpu's
    geometry arrays) and of the port's own ``flux_fn``/``trace_fn`` against
    porepy_tpu's function and its ``jax.jvp``; batched seeds in one call."""
    sds_j, bc_j = GRIDS[grid](pt_jax)
    sds_t, bc_t = GRIDS[grid](pt_torch)
    gj, gt = GeomJax(sds_j, bc_j), GeomTorch(sds_t, bc_t)
    f_jax = gj.flux_fn() if which == "flux" else gj.trace_fn()
    f_torch = gt.flux_fn() if which == "flux" else gt.trace_fn()
    kgeoms = interop.tpfa_ad_geometry_from(gj, "cpu")
    op = kfn.tpfa_ad_flux if which == "flux" else kfn.tpfa_ad_trace
    co, fo = gt.cell_offsets, gt.face_offsets

    def f_kernel(k9, vol, p, bco, lam):
        return torch.cat([
            op(kg, k9[9 * co[i]:9 * co[i + 1]], vol[co[i]:co[i + 1]], p[co[i]:co[i + 1]],
               bco[fo[i]:fo[i + 1]], lam[fo[i]:fo[i + 1]])
            for i, kg in enumerate(kgeoms)
        ])

    primals, seeds = _fields(gt, tensor, zero_cell=False, seed=100 * len(which) + 10 * len(grid) + len(tensor))
    pj = tuple(map(jnp.asarray, primals))
    pt_ = tuple(map(torch.tensor, primals))
    want = f_jax(*pj)
    want_t = [jax.jvp(f_jax, pj, tuple(map(jnp.asarray, s)))[1] for s in seeds]
    stacked = tuple(torch.tensor(np.stack([s[i] for s in seeds])) for i in range(5))
    for f in (f_torch, f_kernel):
        _close(f(*pt_).numpy(), want, TOL_KERNEL)
        val, tan = torch.func.vmap(lambda *s: torch.func.jvp(f, pt_, s))(*stacked)
        for b in range(2):
            _close(tan[b].numpy(), want_t[b], TOL_KERNEL)
        assert torch.equal(val[0], f(*pt_))


def test_zero_permeability_cell():
    """A cell with ``K = 0``: ``t_hf = 0``, ``1 / t_hf = inf``, ``t = 0`` on
    its faces in both packages, and the values agree everywhere. The
    tangent on those faces is not finite in either package (0 * inf in the
    chain rule of the two reciprocals); it is finite and equal elsewhere."""
    sds_j, bc_j = _cart_3d(pt_jax)
    sds_t, bc_t = _cart_3d(pt_torch)
    gj, gt = GeomJax(sds_j, bc_j), GeomTorch(sds_t, bc_t)
    primals, seeds = _fields(gt, "full", zero_cell=True, seed=5)
    pj = tuple(map(jnp.asarray, primals))
    pt_ = tuple(map(torch.tensor, primals))
    kg = interop.tpfa_ad_geometry_from(gj, "cpu")[0]
    want, want_t = jax.jvp(gj.flux_fn(), pj, tuple(map(jnp.asarray, seeds[0])))
    assert np.all(np.isfinite(np.asarray(want)))
    cell = gt.num_cells // 2
    mesh = gt.meshes[0]
    touched = np.unique(mesh.fi.numpy()[mesh.ci.numpy() == cell])
    interior = touched[np.diff(mesh.face_ptr.numpy())[touched] == 2]
    assert interior.size and np.all(np.asarray(want)[interior] == 0.0)
    for f in (gt.flux_fn(), lambda *a: kfn.tpfa_ad_flux(kg, *a)):
        got, got_t = torch.func.jvp(f, pt_, tuple(map(torch.tensor, seeds[0])))
        _close(got.numpy(), want, TOL_KERNEL)
        bad = ~np.isfinite(got_t.numpy())
        assert np.array_equal(bad, ~np.isfinite(np.asarray(want_t)))
        assert set(np.where(bad)[0]) <= set(touched) and bad.any()
        _close(got_t.numpy(), want_t, TOL_KERNEL)
    # The trace keeps such tangents off faces that are not Neumann.
    want_tr, want_tr_t = jax.jvp(gj.trace_fn(), pj, tuple(map(jnp.asarray, seeds[0])))
    got_tr, got_tr_t = torch.func.jvp(
        lambda *a: kfn.tpfa_ad_trace(kg, *a), pt_, tuple(map(torch.tensor, seeds[0]))
    )
    _close(got_tr.numpy(), want_tr, TOL_KERNEL)
    not_neu = ~kg["is_neu_raw"].numpy()
    assert np.all(np.isfinite(got_tr_t.numpy()[not_neu]))
    assert np.all(np.isfinite(np.asarray(want_tr_t)[not_neu]))


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_divergence_and_face_sums_match_jax(grid):
    """``divergence_apply`` and the half-face sums through the sorted
    segment sum: equal to porepy_tpu's segment sums, the same bits as the
    ``index_add_`` they replace, linear under ``jvp``, batched in one call."""
    from porepy_tpu.numerics.fv.fv_mesh import FvMesh as FvMeshJax

    sds_j, _ = GRIDS[grid](pt_jax)
    sds_t, _ = GRIDS[grid](pt_torch)
    rng = np.random.default_rng(2)
    for sd_j, sd_t in zip(sds_j, sds_t):
        mj, mt = FvMeshJax.from_grid(sd_j), FvMesh.from_grid(sd_t)
        face_field = rng.standard_normal((3, mt.num_faces))
        want = np.asarray(mj.divergence_apply(jnp.asarray(face_field)))
        got = mt.divergence_apply(torch.tensor(face_field))
        assert np.abs(got.numpy() - want).max() <= TOL_KERNEL * np.abs(want).max()
        x = torch.tensor(rng.standard_normal((3, mt.num_half_faces)))
        old = torch.zeros(3, mt.num_faces, dtype=torch.float64).index_add_(1, mt.fi, x)
        assert torch.equal(mt.face_sum(x), old)
        want_f = np.asarray(jax.ops.segment_sum(
            jnp.asarray(x.numpy().T), mj.fi, num_segments=mj.num_faces)).T
        assert np.abs(mt.face_sum(x).numpy() - want_f).max() <= TOL_KERNEL * np.abs(want_f).max()
        val, tan = torch.func.vmap(
            lambda s: torch.func.jvp(mt.face_sum, (x[0],), (s,))
        )(x[1:])
        assert torch.equal(tan, mt.face_sum(x[1:])) and torch.equal(val[0], mt.face_sum(x[0]))


def test_wrappers_refuse_what_the_kernel_does_not_take():
    sds_t, bc_t = _cart_3d(pt_torch)
    gt = GeomTorch(sds_t, bc_t)
    kg = gt.kernel_geometry("cpu")[0]
    primals, _ = _fields(gt, "iso", False, 0)
    pt_ = tuple(map(torch.tensor, primals))
    with pytest.raises(ValueError, match="expected cuda"):
        kg.launcher(False)._cuda(pt_, None)
    with pytest.raises(ValueError, match="at least one seed"):
        ops.tpfa_ad_flux_tangent(kg, pt_, (None,) * 5)
    with pytest.raises(NotImplementedError, match="batched primal"):
        torch.func.vmap(lambda p: kfn.tpfa_ad_flux(kg, pt_[0], pt_[1], p, pt_[3], pt_[4]))(
            torch.stack([pt_[2], pt_[2]])
        )
    with pytest.raises(TypeError, match="must be"):
        ops.TpfaAdGeometry(**{**kg.arrays, "ci": kg["ci"].long()})


# -- the model tests of tests/models/test_darcys_law_ad.py ------------------------


def test_matches_stored_matrix_law_constant_permeability():
    """With constant permeability the in-residual TPFA flux equals the
    stored-matrix flux, values and Jacobians, and both equal porepy_tpu's."""
    out = {}
    for pt in (pt_jax, pt_torch):
        m_ref = _base_flow(pt)(_params(pt))
        m_ref.prepare_simulation()
        m_ad = _ad_flow(pt)(_params(pt))
        m_ad.prepare_simulation()
        rng = np.random.default_rng(3)
        x = rng.random(m_ref.equation_system.num_dofs())
        for m in (m_ref, m_ad):
            m.equation_system.set_variable_values(x, iterate_index=0)
        sds = m_ref.mdg.subdomains()
        q_ref = m_ref.equation_system.evaluate(m_ref.darcy_flux(sds))
        q_ad = m_ad.equation_system.evaluate(m_ad.darcy_flux(m_ad.mdg.subdomains()))
        assert np.allclose(q_ad, q_ref, atol=1e-12)
        J_ref = m_ref.darcy_flux(sds).value_and_jacobian(m_ref.equation_system).jac.toarray()
        J_ad = m_ad.darcy_flux(m_ad.mdg.subdomains()).value_and_jacobian(
            m_ad.equation_system
        ).jac.toarray()
        assert np.allclose(J_ad, J_ref, atol=1e-12)
        out[pt] = (np.asarray(q_ad), J_ad)
    _close(out[pt_torch][0], out[pt_jax][0], TOL_MODEL)
    _close(out[pt_torch][1], out[pt_jax][1], TOL_MODEL)


def test_jacobian_includes_permeability_derivative():
    """Finite-difference check of d(flux)/dp including the k(p) term, and
    the same value and Jacobian as porepy_tpu."""
    out = {}
    for pt in (pt_jax, pt_torch):
        m = _nonlinear_flow(pt)(_params(pt))
        m.prepare_simulation()
        eq = m.equation_system
        sds = m.mdg.subdomains()
        rng = np.random.default_rng(11)
        x0 = 0.5 + 0.1 * rng.random(eq.num_dofs())
        eq.set_variable_values(x0, iterate_index=0)
        flux_op = m.darcy_flux(sds)
        res = flux_op.value_and_jacobian(eq)
        J = res.jac.toarray()
        out[pt] = (np.asarray(res.val), J)
        if pt is pt_jax:
            continue
        eps = 1e-6
        for dof in rng.choice(eq.num_dofs(), size=5, replace=False):
            xp = x0.copy()
            xp[dof] += eps
            xm = x0.copy()
            xm[dof] -= eps
            qp = np.asarray(eq.evaluate(flux_op, state=xp))
            qm = np.asarray(eq.evaluate(flux_op, state=xm))
            fd = (qp - qm) / (2 * eps)
            assert np.allclose(J[:, dof], fd, atol=1e-6), dof
    _close(out[pt_torch][0], out[pt_jax][0], TOL_MODEL)
    _close(out[pt_torch][1], out[pt_jax][1], TOL_MODEL)


def test_cubic_law_md_model_runs():
    """The md model with cubic-law fracture permeability runs, and its
    pressure, its pressure trace and the Jacobian of its flux at the final
    state equal porepy_tpu's."""
    out = {}
    for pt in (pt_jax, pt_torch):
        params = _cubic_params(pt)
        m = _cubic_law_md(pt)(params)
        pt.run_time_dependent_model(m, params)
        p = m.equation_system.get_variable_values(["pressure"], time_step_index=0)
        assert p.min() > -1e-8 and p.max() < 1.0 + 1e-8
        sd_f = m.mdg.subdomains(dim=1)[0]
        kf = m.equation_system.evaluate(m.cubic_law_permeability([sd_f]))
        a = m.equation_system.evaluate(m.aperture([sd_f]))
        assert np.allclose(np.asarray(kf).reshape(-1, 9)[:, 0], a**2 / 12)
        out[pt] = m
    mj, mt = out[pt_jax], out[pt_torch]
    state = interop.get_model_state(mj)
    _close(interop.get_model_state(mt)["pressure"], state["pressure"], TOL_MODEL)
    # Both packages linearize the flux and the trace at porepy_tpu's state.
    interop.set_model_state(mt, state)
    for name in ("darcy_flux", "pressure_trace"):
        res = []
        for m in (mj, mt):
            sds = [sd for sd in m.mdg.subdomains() if sd.dim > 0]
            res.append(getattr(m, name)(sds).value_and_jacobian(m.equation_system))
        _close(res[1].val, res[0].val, TOL_MODEL)
        _close(res[1].jac.toarray(), res[0].jac.toarray(), TOL_MODEL)


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_cuda_tpfa_ad_kernels_match_plain(cuda, grid):
    sds_t, bc_t = GRIDS[grid](pt_torch)
    gt = GeomTorch(sds_t, bc_t)
    primals, _ = _fields(gt, "full", False, 9)
    rng = np.random.default_rng(10)
    B = 16
    seeds = [rng.standard_normal((B, p.size)) for p in primals]
    for fn in (gt.flux_fn(), gt.trace_fn()):
        on = lambda dev: torch.func.vmap(  # noqa: E731
            lambda *s: torch.func.jvp(fn, tuple(torch.tensor(p, device=dev) for p in primals), s)
        )(*(torch.tensor(s, device=dev) for s in seeds))
        val_c, tan_c = on("cpu")
        val_g, tan_g = on(cuda)
        assert (val_g.cpu() - val_c).abs().max() <= 1e-12 * val_c.abs().max()
        assert (tan_g.cpu() - tan_c).abs().max() <= 1e-12 * tan_c.abs().max()
    # The one-launch op of the dual rule against its plain version, with
    # every seed and with dvol and dbco None as on the model's path; the
    # trace's unlisted faces exactly 0 in every row, the same bits twice.
    for i, kg in enumerate(gt.kernel_geometry(cuda)):
        kc = gt.kernel_geometry("cpu")[i]
        co, fo = gt.cell_offsets, gt.face_offsets
        spans = ((9 * co[i], 9 * co[i + 1]), (co[i], co[i + 1]), (co[i], co[i + 1]),
                 (fo[i], fo[i + 1]), (fo[i], fo[i + 1]))
        prim = [torch.tensor(p[lo:hi]) for p, (lo, hi) in zip(primals, spans)]
        full = [torch.tensor(s[:, lo:hi]) for s, (lo, hi) in zip(seeds, spans)]
        listed = (kc["is_dir_raw"] | kc["is_neu_raw"]).numpy()
        for seed_set in (full, [full[0], None, full[2], None, full[4]], None):
            for trace in (False, True):
                want = ops.tpfa_ad_dual(kc, prim, seed_set, trace)

                def launch():
                    return ops.tpfa_ad_dual(
                        kg, [t.to(cuda) for t in prim],
                        None if seed_set is None else [None if t is None else t.to(cuda) for t in seed_set],
                        trace,
                    )

                got = launch()
                assert (got[1] is None) == (seed_set is None)
                for a, b in zip(got, want):
                    if b is None:
                        continue
                    assert (a.cpu() - b).abs().max() <= 1e-12 * b.abs().max().clamp_min(1e-300)
                    if trace:
                        assert np.all(a.cpu().numpy()[..., ~listed] == 0.0)
                again = launch()
                assert all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)
    mesh = gt.meshes[0]
    x = torch.tensor(rng.standard_normal((B, mesh.num_half_faces)))
    mesh_g = FvMesh.from_grid(sds_t[0], device=cuda)
    assert torch.equal(mesh_g.face_sum(x.to(cuda)).cpu(), mesh.face_sum(x))
    assert torch.equal(mesh_g.cell_sum(x.to(cuda)).cpu(), mesh.cell_sum(x))
