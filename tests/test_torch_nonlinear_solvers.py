"""The nonlinear solver extensions through porepy_tpu_torch on the CPU
(``numerics/nonlinear/{line_search,anderson_acceleration}.py``, copied
from porepy_tpu): the tests of ``tests/numerics/test_solvers.py``, each
also against porepy_tpu's run on the same inputs (both packages in one
process)."""

import numpy as np
import pytest
import torch

import porepy_tpu as pt_jax
import porepy_tpu_torch as pt

torch.set_num_threads(1)


def _contact_model(pkg):
    """``test_solvers.py``'s sliding-contact model for ``pkg``: one
    fracture in the unit square, the north side sheared and compressed."""

    class Model(pkg.ContactIndicators, pkg.MomentumBalance):
        def set_fractures(self):
            self._fractures = [np.array([[0.25, 0.75], [0.5, 0.5]])]

        def meshing_arguments(self):
            return {"cell_size": 0.25}

        def bc_values_displacement(self, bg):
            vals = np.zeros((self.nd, bg.num_cells))
            north = self.domain_boundary_sides(bg).north
            vals[0, north] = 0.05
            vals[1, north] = -0.002
            return vals.ravel("F")

        def initialize_data_saving(self):
            pass

        def save_data_time_step(self):
            pass

    return Model


def _contact_solver(pkg):
    class Solver(pkg.ConstraintLineSearch, pkg.SplineInterpolationLineSearch, pkg.LineSearchNewtonSolver):
        pass

    return Solver


def _traction(pkg, line_search: bool, **extra):
    params = {"suppress_export": True, **extra}
    if line_search:
        params.update(
            global_line_search=True,
            local_line_search=True,
            adaptive_indicator_scaling=True,
            nonlinear_solver=_contact_solver(pkg),
            nl_convergence_tol_res=1e-10,
        )
    m = _contact_model(pkg)(params)
    pkg.run_time_dependent_model(m, params)
    return np.asarray(m.equation_system.get_variable_values(["contact_traction"], iterate_index=0))


@pytest.fixture(scope="module")
def tractions():
    return {
        (pkg.__name__, ls): _traction(pkg, ls, **({"device": "cpu"} if pkg is pt else {}))
        for pkg in (pt, pt_jax)
        for ls in (False, True)
    }


def test_constraint_line_search_contact_model(tractions):
    """The constraint-aware line-search Newton converges to plain Newton's
    sliding-contact solution within 1e-10."""
    plain, ls = tractions[("porepy_tpu_torch", False)], tractions[("porepy_tpu_torch", True)]
    assert np.abs(plain).max() > 1e-3
    assert np.abs(plain - ls).max() < 1e-10


@pytest.mark.parametrize("line_search", [False, True])
def test_contact_traction_equals_porepy_tpus(tractions, line_search):
    """Each route's traction within 1e-10 of porepy_tpu's same route."""
    mine, theirs = tractions[("porepy_tpu_torch", line_search)], tractions[("porepy_tpu", line_search)]
    assert mine.shape == theirs.shape
    assert np.abs(mine - theirs).max() < 1e-10


def _anderson_error(pkg, accelerate: bool) -> float:
    """``test_solvers.py``'s contractive linear fixed point, 25 iterations
    of Picard or of depth-2 Anderson through ``pkg``."""
    rng = np.random.default_rng(5)
    n = 10
    A = 0.9 * np.diag(rng.uniform(0.5, 1.0, n))
    b = rng.random(n)
    x_true = np.linalg.solve(np.eye(n) - A, b)
    acc = pkg.AndersonAcceleration(dimension=n, depth=2)
    x = np.zeros(n)
    for it in range(25):
        gx = A @ x + b
        x = acc.apply(gx, gx - x, it) if accelerate else gx
    return float(np.linalg.norm(x - x_true))


def test_anderson_acceleration_speeds_up_fixed_point():
    """Anderson depth 2 ends below 1e-2 of Picard's error, and equals
    porepy_tpu's Anderson to the bit."""
    err_plain, err_acc = _anderson_error(pt, False), _anderson_error(pt, True)
    assert err_acc < 1e-2 * err_plain
    assert err_acc == _anderson_error(pt_jax, True)
