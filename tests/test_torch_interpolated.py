"""The table lookup of InterpolatedFunction (K16) in porepy_tpu_torch
against porepy_tpu on the CPU (the plain version of the kernel): values
and forward-mode tangents of 1d, 2d and 3d tables, with points outside the
table, and the lookup inside a compiled equation, evaluated and assembled
through the autograd Function."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import porepy_tpu as pt_jax
import porepy_tpu_torch as pt_torch
from porepy_tpu_torch.grids.md_grid import MixedDimensionalGrid
from porepy_tpu_torch.kernels import reference

torch.set_num_threads(1)

TABLES = {
    1: (lambda x: np.exp(x), [0.0], [1.0], [101]),
    2: (lambda p, T: np.sin(3 * p) * np.cos(T) + p * T, [1.0, 280.0], [5.0, 400.0], [41, 61]),
    3: (lambda a, b, c: a * b - np.cos(c) + a**2 * c, [0.0, -1.0, 0.5], [1.0, 1.0, 2.0], [9, 11, 7]),
}


def _points(d, n=300, seed=0):
    """Points over the table and 20% beyond each side of every axis."""
    _f, lo, hi, _npt = TABLES[d]
    rng = np.random.default_rng(seed + d)
    lo, hi = np.array(lo), np.array(hi)
    span = hi - lo
    return rng.uniform(lo - 0.2 * span, hi + 0.2 * span, (n, d)).T


def _term_scales(fun, x, seeds):
    """Per point, the sum of the magnitudes of the terms that the value and
    each seed's tangent add up (outside the table the weights grow with the
    distance): the scale of their rounding in another summation order."""
    c = fun.device_table("cpu")
    xt = torch.tensor(x)
    d = x.shape[0]
    frac, corners = reference._interp_corners(c["values"], c["fgeom"], c["igeom"], xt)
    df = torch.tensor(seeds).abs() / c["fgeom"][d:][None, :, None]
    val = torch.zeros(x.shape[1], dtype=torch.float64)
    tan = torch.zeros(seeds.shape[0], x.shape[1], dtype=torch.float64)
    for bits, v in corners:
        f = [(frac[k] if bits[k] else 1 - frac[k]).abs() for k in range(d)]
        val += torch.prod(torch.stack(f), 0) * v.abs()
        for k in range(d):
            term = df[:, k]
            for m in range(d):
                if m != k:
                    term = term * f[m]
            tan += term * v.abs()
    return val.numpy(), tan.numpy()


@pytest.mark.parametrize("d", [1, 2, 3], ids=["1d", "2d", "3d"])
def test_lookup_and_tangents_match_jax(d):
    """Value and ``vmap(jvp)`` tangents (4 seeds) against ``jax.jvp`` of
    ``porepy_tpu``'s lookup: 1e-13 of the magnitude of the summed terms per
    point (the two sum the corner terms in another order)."""
    f, lo, hi, npt = TABLES[d]
    fun_j = pt_jax.ad.InterpolatedFunction(f, "tab", lo, hi, npt)
    fun_t = pt_torch.ad.InterpolatedFunction(f, "tab", lo, hi, npt)
    x = _points(d)
    outside = np.any((x < np.array(lo)[:, None]) | (x > np.array(hi)[:, None]), axis=0)
    assert 0 < outside.sum() < x.shape[1]
    seeds = np.random.default_rng(10 + d).standard_normal((4, d, x.shape[1]))

    def g(xx):
        return fun_t.func(*xx)

    xt = torch.tensor(x)
    vals, tangents = torch.func.vmap(lambda s: torch.func.jvp(g, (xt,), (s,)))(torch.tensor(seeds))
    val_scale, tan_scale = _term_scales(fun_t, x, seeds)
    want = np.asarray(fun_j.func(*jnp.asarray(x)))
    assert np.all(np.abs(vals[0].numpy() - want) <= 1e-13 * val_scale)
    for s, got, scale in zip(seeds, tangents, tan_scale):
        _, want_t = jax.jvp(
            lambda *a: fun_j.func(*a), tuple(jnp.asarray(x)), tuple(jnp.asarray(s))
        )
        assert np.all(np.abs(got.numpy() - np.asarray(want_t)) <= 1e-13 * scale)


def _mdg(pt, g):
    g.compute_geometry()
    mdg = pt.MixedDimensionalGrid() if hasattr(pt, "MixedDimensionalGrid") else MixedDimensionalGrid()
    mdg.add_subdomains(g)
    mdg.compute_geometry()
    return mdg


def test_interpolated_function_in_compiled_residual():
    """Mirror of ``tests/utils/test_tables_adtree.py``'s test: the lookup
    inside a compiled equation equals direct table interpolation."""
    g = pt_torch.CartGrid([4], physdims=[1.0])
    es = pt_torch.ad.EquationSystem(_mdg(pt_torch, g), device="cpu")
    p = es.create_variables("p", dof_info={"cells": 1}, subdomains=[g])
    es.set_variable_values(np.array([0.1, 0.4, 0.7, 0.9]), ["p"], iterate_index=0)
    fun = pt_torch.ad.InterpolatedFunction(lambda x: np.exp(x), "exp_table", 0.0, 1.0, 101)
    vals = es.evaluate(fun(p))
    exact = fun.table.interpolate(np.array([[0.1, 0.4, 0.7, 0.9]]))[0]
    assert np.allclose(vals, exact)
    assert np.abs(vals - np.exp([0.1, 0.4, 0.7, 0.9])).max() < 1e-3


def _table_system(pt, device=None):
    """p and T on a 7 x 5 grid, the equation ``tab(p, T) = 0`` with the 2d
    table, some cells' states outside it."""
    f, lo, hi, npt = TABLES[2]
    g = pt.CartGrid([7, 5], physdims=[1.0, 1.0])
    mdg = _mdg(pt, g)
    es = pt.ad.EquationSystem(mdg) if device is None else pt.ad.EquationSystem(mdg, device=device)
    p = es.create_variables("pressure", dof_info={"cells": 1}, subdomains=[g])
    T = es.create_variables("temperature", dof_info={"cells": 1}, subdomains=[g])
    x = _points(2, n=g.num_cells, seed=5)
    es.set_variable_values(x[0], ["pressure"], iterate_index=0)
    es.set_variable_values(x[1], ["temperature"], iterate_index=0)
    op = pt.ad.InterpolatedFunction(f, "tab", lo, hi, npt)(p, T)
    op.set_name("table_equation")
    es.set_equation(op, [g], {"cells": 1})
    return es


def test_assembly_goes_through_the_lookup_function(monkeypatch):
    """The assembled Jacobian and residual of ``tab(p, T)`` equal
    ``porepy_tpu``'s (1e-12 of the largest entry), and the tangents reach
    the K16 tangent as one batch of the colored JVP seeds."""
    calls = []
    tangent = reference.interp_tangent

    def spy(values, fgeom, igeom, x, dx):
        calls.append(tuple(dx.shape))
        return tangent(values, fgeom, igeom, x, dx)

    monkeypatch.setattr(reference, "interp_tangent", spy)
    es_t = _table_system(pt_torch, device="cpu")
    A_t, b_t = es_t.assemble()
    A_j, b_j = _table_system(pt_jax).assemble()
    assert calls and all(len(s) == 3 and s[0] >= 2 and s[1] == 2 for s in calls), calls
    assert np.abs(b_t - b_j).max() <= 1e-12 * np.abs(b_j).max()
    A_t, A_j = A_t.toarray(), A_j.toarray()
    assert np.abs(A_t - A_j).max() <= 1e-12 * np.abs(A_j).max()
    data, b_dev, _cs = es_t.assemble_device()
    assert np.abs(b_dev.numpy() - b_t).max() <= 1e-12 * np.abs(b_t).max()
