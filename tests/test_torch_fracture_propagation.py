"""Fracture propagation and the displacement-correlation SIFs through
porepy_tpu_torch on the CPU (``numerics/fracture_deformation/*`` and
``numerics/displacement_correlation.py``, copied from porepy_tpu):
``tests/numerics/test_propagation.py`` and
``tests/numerics/test_displacement_correlation.py`` on the port, each
against porepy_tpu on the same inputs (both packages in one process): the
opened faces, the grids and the remapped state rings equal exactly, the
SIFs and the solutions within ``PARITY_TOL`` relative. Then the tension
model of phase 31 of ``chip_smoke.py`` at 16 x 16 by the port's device
route against porepy_tpu's, step by step."""

from importlib import import_module

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import porepy_tpu as pt_jax
import porepy_tpu_torch as pt

torch.set_num_threads(1)

#: SIFs and solved fields of the port against porepy_tpu's, relative to
#: the largest value: measured within 1.8e-16 (the SIFs of the tension run
#: and of the displacement correlation, both by a direct solve), 3.0e-16
#: (the tension run's state) and 0 (the flow pressures).
PARITY_TOL = 1e-10

PACKAGES = {"port": pt, "ref": pt_jax}


def _meshing(mod):
    return import_module(f"{mod.__name__}.fracs.meshing")


def _propagate(mod):
    return import_module(f"{mod.__name__}.numerics.fracture_deformation").propagate_fractures


def _mdg(mod, frac):
    return _meshing(mod).cart_grid([np.array(frac)], np.array([4, 4]), physdims=[1.0, 1.0])


def _mdg_3d(mod, xmax):
    frac = np.array([[0.25, xmax, xmax, 0.25], [0.25, 0.25, 0.75, 0.75], [0.5, 0.5, 0.5, 0.5]])
    return _meshing(mod).cart_grid([frac], np.array([4, 4, 4]), physdims=[1.0, 1.0, 1.0])


def _face_at(sd, center):
    d = np.linalg.norm(sd.face_centers[: len(center)] - np.asarray(center)[:, None], axis=0)
    return int(d.argmin())


def _sparse_equal(a, b) -> None:
    # As floats: scipy does not sort the indices of a boolean matrix.
    a, b = sps.csc_matrix(a).astype(np.float64), sps.csc_matrix(b).astype(np.float64)
    a.sort_indices()
    b.sort_indices()
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


def _assert_grids_equal(g, h) -> None:
    """Two grids (the port's, porepy_tpu's) equal exactly: sizes, nodes,
    the face-node and cell-face maps, the geometry and the tags."""
    assert (g.dim, g.num_cells, g.num_faces, g.num_nodes) == (h.dim, h.num_cells, h.num_faces, h.num_nodes)
    np.testing.assert_array_equal(g.nodes, h.nodes)
    _sparse_equal(g.face_nodes, h.face_nodes)
    _sparse_equal(g.cell_faces, h.cell_faces)
    for attr in ("face_centers", "face_normals", "face_areas", "cell_centers", "cell_volumes"):
        np.testing.assert_array_equal(getattr(g, attr), getattr(h, attr), err_msg=attr)
    assert set(g.tags) == set(h.tags)
    for key in g.tags:
        np.testing.assert_array_equal(np.asarray(g.tags[key]), np.asarray(h.tags[key]), err_msg=key)
    if hasattr(h, "global_point_ind"):
        np.testing.assert_array_equal(g.global_point_ind, h.global_point_ind)


def _assert_mdgs_equal(a, b) -> None:
    """Two md grids equal exactly: every subdomain grid, the propagation
    bookkeeping in its data, and every interface's cell count, sides and
    projections."""
    for dim in range(a.dim_max(), -1, -1):
        sa, sb = a.subdomains(dim=dim), b.subdomains(dim=dim)
        assert len(sa) == len(sb)
        for g, h in zip(sa, sb):
            _assert_grids_equal(g, h)
            da, db = a.subdomain_data(g), b.subdomain_data(h)
            for key in ("split_faces", "new_faces", "new_cells"):
                assert (key in da) == (key in db), key
                if key in da:
                    np.testing.assert_array_equal(da[key], db[key], err_msg=key)
    ia, ib = list(a.interfaces()), list(b.interfaces())
    assert len(ia) == len(ib)
    for m, n in zip(ia, ib):
        assert (m.num_cells, m.num_sides()) == (n.num_cells, n.num_sides())
        _sparse_equal(m.primary_to_mortar_int(), n.primary_to_mortar_int())
        _sparse_equal(m.secondary_to_mortar_int(), n.secondary_to_mortar_int())


def _propagated_2d(mod):
    mdg = _mdg(mod, [[0.25, 0.5], [0.5, 0.5]])
    sd_h, sd_l = mdg.subdomains(dim=2)[0], mdg.subdomains(dim=1)[0]
    _propagate(mod)(mdg, {sd_l: np.array([_face_at(sd_h, [0.625, 0.5])])})
    mdg.compute_geometry()
    return mdg


def _propagated_3d(mod):
    mdg = _mdg_3d(mod, 0.5)
    sd_h, sd_l = mdg.subdomains(dim=3)[0], mdg.subdomains(dim=2)[0]
    faces = np.array([_face_at(sd_h, c) for c in ([0.625, 0.375, 0.5], [0.625, 0.625, 0.5])])
    _propagate(mod)(mdg, {sd_l: faces})
    mdg.compute_geometry()
    return mdg


def test_propagation_matches_direct_meshing():
    """``test_propagation.py::test_propagation_matches_direct_meshing`` on
    the port, and the port's propagated md grid equal to porepy_tpu's."""
    mdg = _propagated_2d(pt)
    sd_h, sd_l = mdg.subdomains(dim=2)[0], mdg.subdomains(dim=1)[0]
    direct = _mdg(pt, [[0.25, 0.75], [0.5, 0.5]])
    dh, dl = direct.subdomains(dim=2)[0], direct.subdomains(dim=1)[0]
    assert sd_l.num_cells == dl.num_cells == 2
    assert sd_h.num_faces == dh.num_faces and sd_h.num_nodes == dh.num_nodes
    assert np.isclose(sd_l.cell_volumes.sum(), dl.cell_volumes.sum())
    intf, dintf = list(mdg.interfaces())[0], list(direct.interfaces())[0]
    assert intf.num_cells == dintf.num_cells and intf.num_sides() == dintf.num_sides()
    data_h = mdg.subdomain_data(sd_h)
    assert data_h["split_faces"].size == 1 and data_h["new_faces"].size == 1
    assert mdg.subdomain_data(sd_l)["new_cells"].tolist() == [1]
    _assert_mdgs_equal(mdg, _propagated_2d(pt_jax))


def _flow_pressure(mod, grid, nd: int):
    """``SinglePhaseFlow`` on ``grid`` (the mirrored tests' model), one
    step, by a direct solve: the host pressure sorted by cell center, and
    the model."""

    class M(mod.SinglePhaseFlow):
        def set_geometry(self):
            self.mdg = grid
            self.nd = nd
            box = {"xmin": 0, "xmax": 1, "ymin": 0, "ymax": 1}
            if nd == 3:
                box.update(zmin=0, zmax=1)
            self._domain = mod.Domain(box)
            self.set_well_network()

        def set_well_network(self):
            self.well_network = None

        def bc_values_pressure(self, bg):
            return 1.0 - bg.cell_centers[1 if nd == 2 else 0]

        def initialize_data_saving(self):
            pass

        def save_data_time_step(self):
            pass

    params = {
        "material_constants": {
            "solid": mod.SolidConstants(
                permeability=1.0, porosity=0.1, residual_aperture=0.01, normal_permeability=1.0
            )
        },
        "time_manager": mod.TimeManager([0, 1.0], 1.0, constant_dt=True),
        "linear_solver": "scipy_sparse",
    }
    if mod is pt:
        params["device"] = "cpu"
    m = M(params)
    mod.run_time_dependent_model(m, params)
    sd = grid.subdomains(dim=nd)[0]
    p = m.equation_system.get_variable_values([m.pressure([sd])], time_step_index=0)
    return p[np.lexsort(sd.cell_centers[:nd])], m


def _close(a, b, tol=PARITY_TOL) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert float(np.abs(a - b).max()) <= tol * max(float(np.abs(b).max()), 1e-300)


@pytest.mark.parametrize("nd", [2, 3])
def test_propagated_mdg_solves_flow_like_direct(nd):
    """``test_propagated_mdg_solves_flow_like_direct`` (2d) and
    ``test_propagated_3d_mdg_solves_flow_like_direct`` on the port: the
    propagated grid's pressure equal to the directly meshed one's (1e-10),
    and to porepy_tpu's on its propagated grid (``PARITY_TOL``)."""
    if nd == 2:
        p_prop, m = _flow_pressure(pt, _propagated_2d(pt), 2)
        p_direct, _ = _flow_pressure(pt, _mdg(pt, [[0.25, 0.75], [0.5, 0.5]]), 2)
        assert np.allclose(p_prop, p_direct, atol=1e-10)
        ref, r = _flow_pressure(pt_jax, _propagated_2d(pt_jax), 2)
    else:
        p_prop, m = _flow_pressure(pt, _propagated_3d(pt), 3)
        p_direct, _ = _flow_pressure(pt, _mdg_3d(pt, 0.75), 3)
        assert p_prop.size == p_direct.size
        assert np.allclose(np.sort(p_prop), np.sort(p_direct), atol=1e-10)
        ref, r = _flow_pressure(pt_jax, _propagated_3d(pt_jax), 3)
    _close(p_prop, ref)
    _close(m.equation_system.get_variable_values(time_step_index=0), r.equation_system.get_variable_values(time_step_index=0))


def _remapped_rings(mod):
    mdg = _mdg(mod, [[0.25, 0.5], [0.5, 0.5]])
    sd_l, sd_h = mdg.subdomains(dim=1)[0], mdg.subdomains(dim=2)[0]
    intf = list(mdg.interfaces())[0]
    storage = import_module(f"{mod.__name__}.utils.solution_storage")
    storage.set_solution_values(
        "pressure", np.array([7.0]), mdg.subdomain_data(sd_l), time_step_index=0, iterate_index=0
    )
    lam = np.arange(intf.num_cells, dtype=float) + 1.0
    storage.set_solution_values("flux", lam, mdg.interface_data(intf), time_step_index=0, iterate_index=0)
    per_side = intf.num_cells // intf.num_sides()
    _propagate(mod)(mdg, {sd_l: np.array([_face_at(sd_h, [0.625, 0.5])])})
    rings = {}
    for name, data in (("pressure", mdg.subdomain_data(sd_l)), ("flux", mdg.interface_data(intf))):
        for kind in ("time_step_index", "iterate_index"):
            rings[name, kind] = storage.get_solution_values(name, data, **{kind: 0})
    return rings, lam, per_side, intf


def test_state_rings_are_remapped():
    """``test_state_rings_are_remapped`` on the port, and every remapped
    ring (both fields, time step and iterate) equal to porepy_tpu's."""
    rings, lam, per_side, intf = _remapped_rings(pt)
    assert rings["pressure", "iterate_index"].tolist() == [7.0, 0.0]
    lam_new = rings["flux", "iterate_index"]
    assert lam_new.size == intf.num_cells
    per_new = intf.num_cells // intf.num_sides()
    for s in range(intf.num_sides()):
        assert np.allclose(lam_new[s * per_new: s * per_new + per_side], lam[s * per_side: (s + 1) * per_side])
    ref, _, _, _ = _remapped_rings(pt_jax)
    assert rings.keys() == ref.keys()
    for key, want in ref.items():
        np.testing.assert_array_equal(rings[key], want, err_msg=str(key))


def _grower(mod):
    propagation = import_module(f"{mod.__name__}.numerics.fracture_deformation")

    class Grower(propagation.FracturePropagation, mod.SinglePhaseFlow):
        def set_geometry(self):
            self.mdg = _mdg(mod, [[0.25, 0.5], [0.5, 0.5]])
            self.nd = 2
            self._domain = mod.Domain({"xmin": 0, "xmax": 1, "ymin": 0, "ymax": 1})
            self.well_network = None

        def set_well_network(self):
            self.well_network = None

        def bc_values_pressure(self, bg):
            return 1.0 - bg.cell_centers[1]

        def propagation_faces(self):
            sd_l, sd_h = self.mdg.subdomains(dim=1)[0], self.mdg.subdomains(dim=2)[0]
            if sd_l.num_cells >= 2 or self.time_manager.time < 1.0:
                return {sd_l: np.empty(0, dtype=int)}
            return {sd_l: np.array([_face_at(sd_h, [0.625, 0.5])])}

        def initialize_data_saving(self):
            pass

        def save_data_time_step(self):
            pass

    params = {
        "material_constants": {
            "solid": mod.SolidConstants(
                permeability=1.0, porosity=0.1, residual_aperture=0.01, normal_permeability=1.0
            )
        },
        "time_manager": mod.TimeManager([0, 3.0], 1.0, constant_dt=True),
    }
    if mod is pt:
        params["device"] = "cpu"
    m = Grower(params)
    mod.run_time_dependent_model(m, params)
    return m


def test_propagation_model_mixin():
    """``test_propagation_model_mixin`` on the port: the scheduled growth
    after the first step, the model solving on after it; the final grids
    equal to porepy_tpu's and the state within ``PARITY_TOL``."""
    m = _grower(pt)
    assert m.mdg.subdomains(dim=1)[0].num_cells == 2
    assert m.has_propagated() in (True, False)
    p = m.equation_system.get_variable_values(time_step_index=0)
    assert p.size == m.equation_system.num_dofs() and np.all(np.isfinite(p))
    r = _grower(pt_jax)
    _assert_mdgs_equal(m.mdg, r.mdg)
    _close(p, r.equation_system.get_variable_values(time_step_index=0))


def _tension_model(mod):
    """``test_propagation.py``'s ``_TensionPropagation`` for ``mod``: a
    horizontal fracture in a plate pulled apart at north and south."""

    class TensionPropagation(mod.ConformingFracturePropagation, mod.MomentumBalance):
        def __init__(self, params, mdg):
            self._injected_mdg = mdg
            super().__init__(params)

        def set_geometry(self):
            self.mdg = self._injected_mdg
            self.nd = 2
            self._domain = mod.Domain({"xmin": 0, "xmax": 1, "ymin": 0, "ymax": 1})
            mod.set_local_coordinate_projections(self.mdg)
            self.set_well_network()

        def set_well_network(self):
            self.well_network = None

        def bc_type_mechanics(self, sd):
            sides = self.domain_boundary_sides(sd)
            bc = mod.BoundaryConditionVectorial(sd, sides.north | sides.south, "dir")
            bc.internal_to_dirichlet(sd)
            return bc

        def bc_values_displacement(self, bg):
            sides = self.domain_boundary_sides(bg)
            vals = np.zeros((self.nd, bg.num_cells))
            vals[1, sides.north] = 0.01
            vals[1, sides.south] = -0.01
            return vals.ravel("F")

        def initialize_data_saving(self):
            pass

        def save_data_time_step(self):
            pass

    return TensionPropagation


def _tension_params(mod, critical: float, **extra):
    params = {
        "critical_sifs": [critical, critical],
        "times_to_export": [],
        "time_manager": mod.TimeManager([0, 1.0], 1.0, constant_dt=True),
        "material_constants": {
            "solid": mod.SolidConstants(shear_modulus=1.0, lame_lambda=1.0, residual_aperture=1e-3)
        },
    }
    if mod is pt:
        params["device"] = "cpu"
    params.update(extra)
    return params


def _tension_run(mod, critical: float):
    mdg = _mdg(mod, [[0.25, 0.5], [0.5, 0.5]])
    params = _tension_params(mod, critical)
    m = _tension_model(mod)(params, mdg)
    mod.run_time_dependent_model(m, params)
    return m


@pytest.fixture(scope="module")
def tension_runs():
    return {c: (_tension_run(pt, c), _tension_run(pt_jax, c)) for c in (1e-4, 1e4)}


@pytest.mark.parametrize("critical,expect_growth", [(1e-4, True), (1e4, False)])
def test_conforming_propagation_tension(tension_runs, critical, expect_growth):
    """``test_conforming_propagation_tension`` on the port, and against
    porepy_tpu: the same grids after the step, the stored SIFs within
    ``PARITY_TOL`` and the same faces marked to propagate."""
    m, r = tension_runs[critical]
    sd_l = m.mdg.subdomains(dim=1)[0]
    sifs = m.mdg.subdomain_data(sd_l).get("SIFs")
    assert sifs is not None and sifs[0].max() > 0
    if expect_growth:
        assert m.has_propagated() and sd_l.num_cells > 1
    else:
        assert not m.has_propagated() and sd_l.num_cells == 1
    _assert_mdgs_equal(m.mdg, r.mdg)
    data_r = r.mdg.subdomain_data(r.mdg.subdomains(dim=1)[0])
    _close(sifs, data_r["SIFs"])
    np.testing.assert_array_equal(m.mdg.subdomain_data(sd_l)["propagate_faces"], data_r["propagate_faces"])
    _close(m.equation_system.get_variable_values(time_step_index=0), r.equation_system.get_variable_values(time_step_index=0))


def test_propagation_3d_matches_direct_meshing():
    """``test_propagation_3d_matches_direct_meshing`` on the port, and the
    port's grown 3d md grid equal to porepy_tpu's."""
    mdg = _propagated_3d(pt)
    sd_h, sd_l = mdg.subdomains(dim=3)[0], mdg.subdomains(dim=2)[0]
    direct = _mdg_3d(pt, 0.75)
    dh, dl = direct.subdomains(dim=3)[0], direct.subdomains(dim=2)[0]
    assert sd_l.num_cells == dl.num_cells == 4
    assert sd_h.num_faces == dh.num_faces and sd_h.num_nodes == dh.num_nodes
    assert np.isclose(sd_l.cell_volumes.sum(), dl.cell_volumes.sum())
    intf, dintf = list(mdg.interfaces())[0], list(direct.interfaces())[0]
    assert intf.num_cells == dintf.num_cells and intf.num_sides() == dintf.num_sides()
    assert int(sd_l.tags["tip_faces"].sum()) == int(dl.tags["tip_faces"].sum())
    _assert_mdgs_equal(mdg, _propagated_3d(pt_jax))


def test_propagation_partial_rediscretization_matches_full(tension_runs):
    """``test_propagation_partial_rediscretization_matches_full`` on the
    port: after growth the partially updated MPSA matrices equal a
    from-scratch discretization of the grown grid, and equal porepy_tpu's
    partially updated ones exactly."""
    m, r = tension_runs[1e-4]
    assert m.has_propagated()
    sd = m.mdg.subdomains(dim=2)[0]
    partial = dict(m.mdg.subdomain_data(sd)[pt.DISCRETIZATION_MATRICES]["mechanics"])
    d2 = pt.initialize_data(
        {}, "mechanics", {"bc": m.bc_type_mechanics(sd), "fourth_order_tensor": m.stiffness_tensor(sd)}
    )
    pt.Mpsa("mechanics").discretize(sd, d2)
    for key, full in d2[pt.DISCRETIZATION_MATRICES]["mechanics"].items():
        diff = abs(partial[key] - full)
        assert (diff.max() if diff.nnz else 0.0) < 1e-12, key
    ref = r.mdg.subdomain_data(r.mdg.subdomains(dim=2)[0])[pt_jax.DISCRETIZATION_MATRICES]["mechanics"]
    assert partial.keys() == ref.keys()
    for key, want in ref.items():
        _sparse_equal(partial[key], want)


# -- the displacement correlation (tests/numerics/test_displacement_correlation.py)


def _dc(mod):
    return import_module(f"{mod.__name__}.numerics.displacement_correlation")


def test_sif_from_delta_u_inverts_near_tip_field():
    """The formula maps the analytic near-tip jump back to K in every mode,
    and equals porepy_tpu's to the bit."""
    mu, kappa = 1.7, 2.2
    rm = np.array([0.05, 0.1, 0.2])
    K = np.array([3.0, 5.0, 7.0])
    d_u = np.zeros((3, 3))
    d_u[1] = (kappa + 1.0) / mu * K * np.sqrt(rm / (2.0 * np.pi))
    d_u[0] = (kappa + 1.0) / mu * K * np.sqrt(rm / (2.0 * np.pi))
    d_u[2] = 4.0 / mu * K * np.sqrt(rm / (2.0 * np.pi))
    sifs = _dc(pt).sif_from_delta_u(d_u, rm, mu, kappa)
    np.testing.assert_allclose(sifs, np.vstack([K, K, K]), rtol=1e-12)
    np.testing.assert_array_equal(sifs, _dc(pt_jax).sif_from_delta_u(d_u, rm, mu, kappa))


def test_determine_onset():
    sifs = np.array([[1.0, 3.0, 0.5], [0.0, 0.0, 2.0]])
    for mod in PACKAGES.values():
        np.testing.assert_array_equal(_dc(mod).determine_onset(sifs, np.array([2.0, 1.5])), [False, True, True])


def _solved(mod):
    """``test_displacement_correlation.py``'s ``solved`` fixture for
    ``mod``: a fracture from 0.3 to 0.7 on a 10 x 10 grid, the north side
    pulled up by 0.01."""

    class Tension(mod.MomentumBalance):
        def __init__(self, params, mdg):
            self._mdg_pre = mdg
            super().__init__(params)

        def set_geometry(self):
            self.mdg = self._mdg_pre
            self.nd = 2
            self._domain = mod.Domain({"xmin": 0, "xmax": 1, "ymin": 0, "ymax": 1})
            mod.set_local_coordinate_projections(self.mdg)
            self.set_well_network()

        def bc_values_displacement(self, bg):
            vals = np.zeros((self.nd, bg.num_cells))
            vals[1, self.domain_boundary_sides(bg).north] = 0.01
            return vals.ravel("F")

        def initialize_data_saving(self):
            pass

        def save_data_time_step(self):
            pass

    mdg = _meshing(mod).cart_grid([np.array([[0.3, 0.7], [0.5, 0.5]])], np.array([10, 10]), physdims=[1.0, 1.0])
    params = {
        "material_constants": {
            "solid": mod.SolidConstants(shear_modulus=1.0, lame_lambda=1.0, residual_aperture=1e-3)
        },
    }
    if mod is pt:
        params["device"] = "cpu"
    m = Tension(params, mdg)
    mod.run_time_dependent_model(m, params)
    return m


@pytest.fixture(scope="module")
def solved():
    return _solved(pt), _solved(pt_jax)


def test_tip_sifs_match_model_mixin(solved):
    """The standalone estimator and the propagation mixin's read the same
    mortar jump: their mode-I SIFs agree (1e-12), and both equal
    porepy_tpu's within ``PARITY_TOL`` with the same tip faces."""
    m, r = solved
    mu, lam = float(m.solid.shear_modulus), float(m.solid.lame_lambda)
    kappa = 3.0 - 4.0 * lam / (2.0 * (lam + mu))
    sd_l = m.mdg.subdomains(dim=1)[0]
    sifs, tip_faces = _dc(pt).tip_sifs(m.mdg, None, mu=mu, kappa=kappa)[sd_l]
    assert tip_faces.size == 2 and np.all(sifs[0] > 0)

    class Mix(pt.ConformingFracturePropagation, type(m)):
        pass

    mix = Mix.__new__(Mix)
    mix.__dict__.update(m.__dict__)
    sifs_mix, tips_mix, _bases = mix._displacement_correlation(sd_l, list(m.mdg.interfaces())[0])
    np.testing.assert_array_equal(tip_faces, tips_mix)
    np.testing.assert_allclose(sifs[0], sifs_mix[0], rtol=1e-12)
    sifs_ref, tips_ref = _dc(pt_jax).tip_sifs(r.mdg, None, mu=mu, kappa=kappa)[r.mdg.subdomains(dim=1)[0]]
    np.testing.assert_array_equal(tip_faces, tips_ref)
    _close(sifs, sifs_ref)


def test_griffith_anchor(solved):
    """K_I within 40% of sigma sqrt(pi a) for the centre crack."""
    m, _ = solved
    sd_l = m.mdg.subdomains(dim=1)[0]
    sifs, _tips = _dc(pt).tip_sifs(m.mdg, None, mu=1.0, kappa=2.0)[sd_l]
    K_analytic = 3.0 * 0.01 * np.sqrt(np.pi * 0.2)
    for K in sifs[0]:
        assert 0.6 * K_analytic < K < 1.4 * K_analytic, (K, K_analytic)


def test_faces_to_open_selects_tip_continuations(solved):
    """With a low critical SIF both tips open the host faces on the
    fracture line beyond them, the same faces as porepy_tpu's; with a high
    one none."""
    m, r = solved
    faces, sifs = _dc(pt).faces_to_open(m.mdg, None, critical_sifs=np.array([1e-8, 1e-8]), mu=1.0, kappa=2.0)
    sd_l, sd_h = m.mdg.subdomains(dim=1)[0], m.mdg.subdomains(dim=2)[0]
    got = faces[sd_l]
    assert got.size == 2
    fc = sd_h.face_centers[:, got]
    assert np.allclose(fc[1], 0.5, atol=1e-12)
    assert np.all((fc[0] < 0.3) | (fc[0] > 0.7))
    faces_ref, _ = _dc(pt_jax).faces_to_open(r.mdg, None, critical_sifs=np.array([1e-8, 1e-8]), mu=1.0, kappa=2.0)
    np.testing.assert_array_equal(got, faces_ref[r.mdg.subdomains(dim=1)[0]])
    faces_hi, _ = _dc(pt).faces_to_open(m.mdg, None, critical_sifs=np.array([1e9, 1e9]), mu=1.0, kappa=2.0)
    assert faces_hi[sd_l].size == 0


def test_estimate_rm(solved):
    m, r = solved
    rm = _dc(pt).estimate_rm(m.mdg.subdomains(dim=1)[0])
    assert rm.shape == (2,)
    np.testing.assert_allclose(rm, 0.05, rtol=1e-10)
    np.testing.assert_array_equal(rm, _dc(pt_jax).estimate_rm(r.mdg.subdomains(dim=1)[0]))


# -- phase 31's model on the device route -----------------------------------------


def _growth_by_step(mod, n: int, steps: int, **extra) -> list:
    """The tension model on an ``n`` x ``n`` grid, ``critical_sifs`` 1e-4,
    ``steps`` steps: after each step the host faces opened, the fracture's
    cell count and the stored mode-I SIFs at the tips."""
    mdg = _meshing(mod).cart_grid([np.array([[0.25, 0.5], [0.5, 0.5]])], np.array([n, n]), physdims=[1.0, 1.0])
    params = _tension_params(mod, 1e-4, time_manager=mod.TimeManager([0, float(steps)], 1.0, constant_dt=True),
                             **extra)
    log = []

    class Logged(_tension_model(mod)):
        def evaluate_propagation(self):
            super().evaluate_propagation()
            sd_l, sd_h = self.mdg.subdomains(dim=1)[0], self.mdg.subdomains(dim=2)[0]
            sifs = self.mdg.subdomain_data(sd_l)["SIFs"][0]
            log.append({
                "opened": np.asarray(self.mdg.subdomain_data(sd_h).get("new_faces", [])).copy(),
                "cells": sd_l.num_cells,
                "sifs": sifs[sifs != 0].copy(),
            })

    m = Logged(params, mdg)
    mod.run_time_dependent_model(m, params)
    return log


def test_tension_growth_on_the_device_route():
    """Phase 31's model at 16 x 16, 4 steps, by ``device_gmres`` with dense
    block inverses (20 Newton iterations) in both packages, the port's
    kernels by their plain versions on the CPU: the fracture grows every
    step, the opened faces and cell counts equal at every step, the tip
    SIFs within 1e-8 relative (both Newton loops stop at an increment of
    1e-10; measured 7.1e-14)."""
    extra = {"linear_solver": "device_gmres", "dense_precond": True, "max_iterations": 20}
    got = _growth_by_step(pt, 16, 4, **extra)
    want = _growth_by_step(pt_jax, 16, 4, **extra)
    assert len(got) == len(want) == 4
    cells = [4] + [s["cells"] for s in got]
    assert all(b > a for a, b in zip(cells, cells[1:])), cells
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["opened"], w["opened"])
        assert g["cells"] == w["cells"]
        _close(g["sifs"], w["sifs"], 1e-8)


def test_rebuild_frees_the_old_topology(monkeypatch):
    """Phase 31's model at 16 x 16 by the device route, 3 steps: after each
    step's solve on the rebuilt system, no compiled system, device solver
    or dense block inverse of the topology before survives, and the
    compiler's global table of device constants does not grow from one
    rebuild to the next (it held every topology's constant matrices for
    the process's lifetime before: ``porepy_tpu``'s
    ``compiler._DEVICE_CONSTS`` still does)."""
    import gc

    import chip_smoke
    from porepy_tpu_torch.numerics.ad import compiler
    from porepy_tpu_torch.numerics.fracture_deformation import propagation_model

    sizes = []
    rebuild = propagation_model.FracturePropagation._rebuild_after_propagation

    def counted(self):
        rebuild(self)
        gc.collect()
        sizes.append(len(compiler._DEVICE_CONSTS))

    monkeypatch.setattr(propagation_model.FracturePropagation, "_rebuild_after_propagation", counted)
    m, _ = chip_smoke.propagation_case(16, torch.device("cpu"), steps=3)
    assert [s["cells"] for s in m.steps] == [6, 7, 8]
    assert [s["alive_before"] for s in m.steps] == [0, 0, 0] and [s["watched"] for s in m.steps][1:] == [4, 4]
    assert len(sizes) == 3 and sizes[2] <= sizes[1] <= sizes[0], sizes
