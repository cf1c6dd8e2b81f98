"""Fracture damage through porepy_tpu_torch on the CPU
(``models/fracture_damage.py`` and ``examples/fracture_damage.py``, copied
from porepy_tpu): ``tests/models/test_fracture_damage.py``'s checks for
both history equations, each model's final state against porepy_tpu's on
the same inputs (both packages in one process), the example's model at
cell size 1/8 in both packages, and the ``damage`` bench case on its
device route on the CPU against the direct solve."""

import numpy as np
import pytest
import torch

import porepy_tpu as pt_jax
import porepy_tpu_torch as pt
from porepy_tpu.examples.fracture_damage import FractureDamageModel as DamageJax
from porepy_tpu.models import fracture_damage as damage_jax
from porepy_tpu_torch.examples import FractureDamageModel
from porepy_tpu_torch.models import fracture_damage as damage

torch.set_num_threads(1)

#: The port's final damage history, contact traction and displacement
#: against porepy_tpu's, both by a direct solve, relative to each field's
#: largest value. Measured: the anisotropic history within 1.3e-11 on the
#: 4 x 4 plate and 8.3e-11 in the example at 1/8 (its normalized slip
#: direction and Heaviside amplify the last bits of the Newton iterate),
#: the tractions within 2.8e-12, the displacements within 8.4e-14; with
#: the isotropic history every field within 4e-16.
PARITY_TOL = 1e-10

FIELDS = ("damage_history", "contact_traction", "u")


def _shear_base(mod):
    """``tests/models/test_fracture_damage.py``'s sheared plate for the
    package ``mod``: one horizontal fracture on a 4 x 4 Cartesian grid,
    the north side compressed and moved along x by 0.05 t."""
    from importlib import import_module

    meshing = import_module(f"{mod.__name__}.fracs.meshing")

    class ShearBase(mod.MomentumBalance):
        def __init__(self, params):
            self._injected_mdg = meshing.cart_grid(
                [np.array([[0.25, 0.75], [0.5, 0.5]])], np.array([4, 4]), physdims=[1.0, 1.0]
            )
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
            vals[0, sides.north] = 0.05 * self.time_manager.time
            vals[1, sides.north] = -0.01
            return vals.ravel("F")

        def initialize_data_saving(self):
            pass

        def save_data_time_step(self):
            pass

    return ShearBase


def _damage_model(mod, dmod, history: str):
    history_eq = {"isotropic": dmod.IsotropicHistoryEquation, "anisotropic": dmod.AnisotropicHistoryEquation}

    class Model(
        mod.constitutive_laws.FrictionDamage,
        mod.constitutive_laws.DilationDamage,
        dmod.DamageHistoryVariable,
        history_eq[history],
        _shear_base(mod),
    ):
        pass

    return Model


def _solid(mod):
    return mod.SolidConstants(
        shear_modulus=1.0,
        lame_lambda=1.0,
        friction_coefficient=0.3,
        residual_aperture=1e-3,
        initial_friction_damage=0.5,
        friction_damage_decay=5.0,
        initial_dilation_damage=0.5,
        dilation_damage_decay=5.0,
    )


def _params(mod, **extra):
    """The mirrored test's parameters for ``mod``: 3 steps of 1.0, up to 40
    Newton iterations."""
    params = {
        "times_to_export": [],
        "time_manager": mod.TimeManager([0, 3.0], 1.0, constant_dt=True),
        "material_constants": {"solid": _solid(mod)},
        "max_iterations": 40,
    }
    params.update(extra)
    return params


def _run(cls, mod, params):
    m = cls(params)
    mod.run_time_dependent_model(m, params)
    return m


def _fields(m, names=FIELDS) -> dict:
    es = m.equation_system
    return {n: np.asarray(es.get_variable_values([n], time_step_index=0)) for n in names}


def _assert_fields_match(got: dict, want: dict, tol: float) -> None:
    for name, b in want.items():
        a = got[name]
        assert a.shape == b.shape, name
        scale = max(float(np.abs(b).max()), 1e-300)
        diff = float(np.abs(a - b).max())
        assert diff <= tol * scale, f"{name}: {diff:.3e} of {scale:.3e}"


@pytest.fixture(scope="module", params=["isotropic", "anisotropic"])
def damage_pair(request):
    """The mirrored test's model with the history equation of the param, in
    the port (CPU) and in porepy_tpu."""
    port = _run(_damage_model(pt, damage, request.param), pt, _params(pt, device="cpu"))
    ref = _run(_damage_model(pt_jax, damage_jax, request.param), pt_jax, _params(pt_jax))
    return port, ref


def test_damage_history_accumulates(damage_pair):
    """``tests/models/test_fracture_damage.py::test_damage_history_accumulates``
    on the port: a positive history, damage factors between the intact 1 and
    the fully damaged 0.5, and the history equal to the integrated slip over
    the stored time steps."""
    m, _ = damage_pair
    es = m.equation_system
    h = es.get_variable_values(["damage_history"], time_step_index=0)
    assert np.all(h >= 0)
    assert h.max() > 1e-4
    fracture = m.mdg.subdomains(dim=1)
    fd = np.asarray(es.evaluate(m.friction_damage(fracture)))
    dd = np.asarray(es.evaluate(m.dilation_damage(fracture)))
    assert np.all(fd < 1.0) and np.all(fd > 0.5)
    assert np.all(dd < 1.0) and np.all(dd > 0.5)
    u_t = m.tangential_component(fracture) @ m.plastic_displacement_jump(fracture)
    states = [np.asarray(es.evaluate(u_t))] + [
        np.asarray(es.evaluate(u_t.previous_timestep(i + 1))) for i in range(1, 4)
    ]
    expected = np.zeros(h.size)
    for a, b in zip(states[:-1], states[1:]):
        expected += np.abs(a - b)
    assert np.allclose(h, expected, atol=1e-8)


def test_damage_matches_porepy_tpu(damage_pair):
    """The final history, tractions and displacements equal porepy_tpu's
    within ``PARITY_TOL`` of each field's largest value, after the same
    Newton iterations, and the damage factors likewise."""
    m, ref = damage_pair
    _assert_fields_match(_fields(m), _fields(ref), PARITY_TOL)
    assert m.nonlinear_solver_statistics.num_iteration == ref.nonlinear_solver_statistics.num_iteration
    for law in ("friction_damage", "dilation_damage"):
        got = np.asarray(m.equation_system.evaluate(getattr(m, law)(m.mdg.subdomains(dim=1))))
        want = np.asarray(ref.equation_system.evaluate(getattr(ref, law)(ref.mdg.subdomains(dim=1))))
        np.testing.assert_allclose(got, want, rtol=PARITY_TOL, atol=0)


def _example_params(mod, cell_size: float, **extra):
    """``examples/fracture_damage.py``'s ``run`` parameters at
    ``cell_size``."""
    params = {
        "grid_type": "cartesian",
        "meshing_arguments": {"cell_size": cell_size},
        "times_to_export": [],
        "time_manager": mod.TimeManager([0, 3.0], 1.0, constant_dt=True),
        "material_constants": {"solid": _solid(mod)},
    }
    params.update(extra)
    return params


def test_example_model_matches_porepy_tpu():
    """The example's ``FractureDamageModel`` (the flat ``examples`` name) at
    cell size 1/8 (128 cells, 4 fracture cells) in both packages: the
    history, the tractions and the displacements within ``PARITY_TOL``, and
    the history grown along the fracture."""
    assert pt.examples.FractureDamageModel is FractureDamageModel
    m = _run(FractureDamageModel, pt, _example_params(pt, 1.0 / 8, device="cpu"))
    ref = _run(DamageJax, pt_jax, _example_params(pt_jax, 1.0 / 8))
    got = _fields(m)
    _assert_fields_match(got, _fields(ref), PARITY_TOL)
    assert got["damage_history"].size == 4 and np.all(got["damage_history"] > 0)


def test_example_run_entry_point():
    """``examples.fracture_damage.run``, the example's own entry point, runs
    its cell size 1/4 on the port's default device when there is one; on
    the CPU the same model through ``run_time_dependent_model``."""
    from porepy_tpu_torch.examples import fracture_damage as example

    if torch.cuda.is_available():
        m = example.run()
    else:
        m = _run(FractureDamageModel, pt, _example_params(pt, 0.25, device="cpu"))
    h = m.equation_system.get_variable_values(["damage_history"], time_step_index=0)
    assert h.size == 2 and np.all(h > 0)


#: The bench case's device route (``device_gmres``, dense block inverses,
#: each Krylov solve to 1e-11) against the direct solve on the same model,
#: the kernels' plain versions on the CPU: both converge to the Newton
#: tolerance (increment 1e-10), so the fields agree to about that. Measured
#: at 1/16: the anisotropic history within 1.5e-11 of its largest value,
#: the tractions 4.7e-13, the displacements 9.2e-15; the isotropic fields
#: within 5.8e-15.
ROUTE_TOL = 1e-9


@pytest.mark.parametrize("history", ["anisotropic", "isotropic"])
def test_bench_case_device_route(history):
    """``cases.build_fracture_damage`` (the ``damage`` case) at 1/16 on the
    CPU by its device route: 1,056 dofs, the fused Newton loop of each step
    converging, a non-decreasing history, the damage laws of
    ``constitutive_laws`` from it, and the fields against the direct
    solve."""
    from porepy_tpu_torch.applications.benchmarking import cases

    assert cases.CASE_BUILDERS["damage"] is cases.build_fracture_damage
    Model, params = cases.build_fracture_damage(1.0 / 16, device="cpu", history=history)

    class Recorded(Model):
        def after_nonlinear_convergence(self):
            super().after_nonlinear_convergence()
            self.h_steps.append(self.equation_system.get_variable_values(["damage_history"], time_step_index=0))

    m = Recorded(params)
    m.h_steps = []
    pt.run_time_dependent_model(m, params)
    es = m.equation_system
    assert es.num_dofs() == 16 * 16 * 2 + 8 * 3 + 32
    h = m.h_steps
    assert len(h) == 3 and np.all(h[0] >= 0) and np.all(np.diff(np.stack(h), axis=0) >= 0)
    fracture = m.mdg.subdomains(dim=1)
    solid = params["material_constants"]["solid"]
    for law, d0, c in (
        ("friction_damage", solid.initial_friction_damage, solid.friction_damage_decay),
        ("dilation_damage", solid.initial_dilation_damage, solid.dilation_damage_decay),
    ):
        got = np.asarray(es.evaluate(getattr(m, law)(fracture)))
        np.testing.assert_allclose(got, 1.0 + (d0 - 1.0) * np.exp(-c * h[-1]), rtol=0, atol=1e-12)
    _, direct_params = cases.build_fracture_damage(1.0 / 16, device="cpu", history=history)
    direct_params["linear_solver"] = "scipy_sparse"
    direct = _run(Model, pt, direct_params)
    _assert_fields_match(_fields(m), _fields(direct), ROUTE_TOL)
