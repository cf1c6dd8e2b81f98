"""K8's root scatter on the CPU: each equation's root program writes its
Jacobian nonzeros and its rows of the right-hand side
(``DualExecutor.scatter``, ``DualEwLauncher.scatter``, the plain version
``reference.dual_ew_scatter``), where the parent's assembly wrote each root
in ``dual_ew``'s row layout and gathered the nonzeros with ``jac_gather``.

(a) md 1/16, tracer 1/8, ``DarcysLawAd`` 1/16 and biot 1/16 at a state away
    from the initial one: ``_data_and_rhs`` and ``_rhs_only`` equal the
    compressed route followed by ``reference.jac_gather`` to the bit, and
    porepy_tpu's ``_CompiledSystem`` on the same state within 1e-12 of the
    largest entry (``jax.linearize`` and ``vmap`` against the dual pass:
    sums in another order);
(b) an equation whose root is not a fused program (a bare unknown) takes the
    identity program, with the same bits;
(c) the plain scatter against ``reference.dual_ew`` and the gather, to the
    bit, for one program of every family of opcodes, constant and scalar
    operands among the inputs;
(d) the tiles of ``RootScatter``, the checks of the scatter call, and that
    the separate gather kernel is gone.

The test marked ``cuda`` of ``test_torch_forward_ad.py``
(``test_cuda_jac_gather_matches_plain``) holds the kernel to the plain
version on a card.
"""

import jax
import numpy as np
import pytest
import torch

import porepy_tpu as pt_jax
import porepy_tpu_torch as pt_torch
from porepy_tpu.applications.benchmarking import cases as cases_jax
from porepy_tpu_torch.applications.benchmarking import cases as cases_torch
from porepy_tpu_torch.applications.benchmarking.dual_pivot_check import family_programs
from porepy_tpu_torch.grids.md_grid import MixedDimensionalGrid
from porepy_tpu_torch.interop import tensors_from_numpy
from porepy_tpu_torch.kernels import build, ops, reference
from porepy_tpu_torch.numerics import ad
from porepy_tpu_torch.numerics.ad import compiler, forward

torch.set_num_threads(1)

#: The port against porepy_tpu, relative to the largest entry.
TOL_JAX = 1e-12


def _darcy(pt, cases, size):
    """``cases.build_darcy_ad``'s model and parameters at ``size``, built
    from either package (``cases`` its benchmarking cases, for the md
    case's materials)."""

    class PressureDependentPerm:
        def permeability(self, subdomains):
            n = sum(sd.num_cells for sd in subdomains)
            k0 = pt.ad.wrap_as_dense_ad_array(self.solid.permeability, n)
            k = k0 * (pt.ad.Scalar(1.0) + pt.ad.Scalar(0.3) * self.pressure(subdomains))
            return self.isotropic_second_order_tensor(subdomains, k)

    class Model(
        PressureDependentPerm,
        pt.DarcysLawAd,
        pt.constitutive_laws.CubicLawPermeability,
        cases._nosave(pt.SinglePhaseFlow),
    ):
        def set_fractures(self):
            self._fractures = [pt.LineFracture(np.array([[0.25, 0.75], [0.5, 0.5]]))]

        def bc_values_pressure(self, bg):
            return 1.0 - bg.cell_centers[0]

        def darcy_flux_discretization(self, subdomains):
            return pt.ad.TpfaAd(self.darcy_keyword, subdomains, self.mdg)

    params = {
        "grid_type": "cartesian",
        "meshing_arguments": {"cell_size": size},
        "material_constants": cases._mat_flow(),
    }
    return Model, params


def _builders(case):
    """``(port model and params, porepy_tpu model and params)`` of a case."""
    if case == "md":
        Model, params = cases_torch.build_md_flow(1.0 / 16, device="cpu")
        return (Model, params), cases_jax.build_md_flow(1.0 / 16)
    if case == "darcy_ad":
        Model, params = _darcy(pt_torch, cases_torch, 1.0 / 16)
        params["device"] = "cpu"
        return (Model, params), _darcy(pt_jax, cases_jax, 1.0 / 16)
    size = {"tracer": 1.0 / 8, "biot": 1.0 / 16}[case]
    make_t = {"tracer": cases_torch.build_tracer, "biot": cases_torch.build_biot}[case]
    make_j = {"tracer": cases_jax.build_tracer, "biot": cases_jax.build_biot}[case]
    Model_j, params_j = make_j()
    params_j["meshing_arguments"] = {"cell_size": size}
    return make_t(size, device="cpu"), (Model_j, params_j)


_PORT = {}


def _port(case):
    """The port's compiled system of ``case``, a state away from the
    initial one, and its env tensors; made once."""
    if case not in _PORT:
        (Model, params), _jax = _builders(case)
        model = Model(params)
        model.prepare_simulation()
        es = model.equation_system
        cs = es.compiled_system()
        x0 = es._global_vector()
        rng = np.random.default_rng(19)
        x = x0 + 0.05 * (np.abs(x0).max() + 1.0) * rng.uniform(0.0, 1.0, x0.size)
        _PORT[case] = (model, cs, x, cs._envs(es))
    return _PORT[case]


def _compressed_route(cs, x, envs):
    """The parent's assembly: each equation's pass in the row layout, then
    the gather into the nonzero order (``reference.jac_gather``)."""
    vals, tans = [], []
    for ce, env, colors in zip(cs.ces, envs, cs._colors):
        val, tan = compiler.dual_jvps(ce.fn, x, env, colors, ce.n_colors)
        vals.append(val)
        tans.append(tan)
    gc = torch.tensor(np.concatenate([ce.gather_color for ce in cs.ces]), dtype=torch.int32)
    gr = torch.tensor(np.concatenate([ce.rows for ce in cs.ces]), dtype=torch.int32)
    return reference.jac_gather(vals, tans, gc, gr, cs._nnz_offsets, cs._row_offsets)


CASES = ["md", "tracer", "darcy_ad", "biot"]


# -- (a) the assembly --------------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_scatter_route_equals_compressed_route(case):
    _model, cs, x, envs = _port(case)
    x = torch.tensor(x)
    data, rhs = cs._data_and_rhs(x, envs)
    want_data, want_rhs = _compressed_route(cs, x, envs)
    assert torch.equal(data, want_data) and torch.equal(rhs, want_rhs)
    assert torch.equal(cs._rhs_only(x, envs), want_rhs)
    # Every equation of the cases has a fused program at its root.
    for ce in cs.ces:
        ex = ce.fn.dual
        assert ex._root_steps == len(ex._steps) - 1
        assert ex._root_program[0] is not forward._IDENTITY.launcher()


@pytest.mark.parametrize("case", CASES)
def test_scatter_route_matches_jax(case):
    _model, cs_t, x, _envs = _port(case)
    _port_builders, (Model_j, params_j) = _builders(case)
    m_jax = Model_j(params_j)
    m_jax.prepare_simulation()
    cs_j = m_jax.equation_system.compiled_system()
    assert cs_t.names == cs_j.names
    envs = cs_j._envs_host(m_jax.equation_system)
    data_j, b_j = cs_j._data_and_rhs_host(x, envs)
    data_t, b_t = cs_t._data_and_rhs(torch.tensor(x), tensors_from_numpy(envs, "cpu"))
    assert data_t.shape == data_j.shape and b_t.shape == b_j.shape
    assert np.abs(data_t.numpy() - data_j).max() <= TOL_JAX * np.abs(data_j).max()
    assert np.abs(b_t.numpy() - b_j).max() <= TOL_JAX * np.abs(b_j).max()
    rhs_j = np.asarray(cs_j._rhs_only(jax.numpy.asarray(x), envs))
    rhs_t = cs_t._rhs_only(torch.tensor(x), tensors_from_numpy(envs, "cpu")).numpy()
    assert np.abs(rhs_t - rhs_j).max() <= TOL_JAX * np.abs(rhs_j).max()


# -- (b) a root that is not a fused program ------------------------------------------


def test_bare_variable_root_takes_identity_program():
    g = pt_torch.CartGrid(np.array([5, 4]), np.array([1.0, 1.0]))
    g.compute_geometry()
    mdg = MixedDimensionalGrid()
    mdg.add_subdomains([g])
    es = ad.EquationSystem(mdg, device="cpu")
    u = es.create_variables("u", subdomains=[g])
    v = es.create_variables("v", subdomains=[g])
    n = g.num_cells
    es.set_variable_values(np.linspace(-1.0, 2.0, 2 * n), iterate_index=0)
    es.update_equation("bare", u)
    es.update_equation("product", u * v)
    cs = es.compiled_system()
    bare, product = (ce.fn.dual for ce in cs.ces)
    assert bare._root_steps == len(bare._steps)
    assert bare._root_program[0] is forward._IDENTITY.launcher()
    assert product._root_steps == len(product._steps) - 1
    x = torch.tensor(es._global_vector())
    envs = cs._envs(es)
    data, rhs = cs._data_and_rhs(x, envs)
    want_data, want_rhs = _compressed_route(cs, x, envs)
    assert torch.equal(data, want_data) and torch.equal(rhs, want_rhs)
    assert torch.equal(cs._rhs_only(x, envs), want_rhs)
    assert torch.equal(rhs[:n], -x[:n])
    assert torch.equal(data[: cs._nnz_offsets[1]], torch.ones(n, dtype=torch.float64))


# -- (c) the plain scatter -----------------------------------------------------------


def _pattern(rng, n, batch):
    gc, gr = [], []
    for r in range(n):
        k = int(rng.integers(0, min(4, batch) + 1))
        gc.extend(rng.permutation(batch)[:k])
        gr.extend([r] * k)
    return torch.tensor(gc, dtype=torch.int32), torch.tensor(gr, dtype=torch.int32)


@pytest.mark.parametrize("family", sorted(family_programs()))
@pytest.mark.parametrize("operands", ["all", "constants", "scalars"])
def test_plain_scatter_equals_dual_ew_then_gather(family, operands):
    program, _order = family_programs()[family]
    rng = np.random.default_rng(7)
    n, batch = 97, 5
    inputs = []
    for k in range(program.n_inputs):
        val = torch.tensor(rng.uniform(-1.0, 1.0, n))
        tan = torch.tensor(rng.standard_normal((batch, n)))
        if operands == "constants" and k % 2:
            tan = None
        if operands == "scalars" and k == 1:
            val, tan = torch.tensor(0.3), torch.tensor(rng.standard_normal((batch, 1)))
        inputs.append((val, tan))
    gc, gr = _pattern(rng, n, batch)
    val, tan = reference.dual_ew(program.instrs, program.imm, inputs, batch)
    got_rhs, got_data = reference.dual_ew_scatter(program.instrs, program.imm, inputs, batch, gc, gr)
    assert torch.equal(got_rhs, -val)
    want = torch.zeros(gc.shape[0], dtype=torch.float64) if tan is None else tan[gc.long(), gr.long()]
    assert torch.equal(got_data, want)
    assert reference.dual_ew_scatter(program.instrs, program.imm, inputs, 0, gc, gr)[1] is None


def test_launcher_scatter_on_the_cpu_writes_its_slices():
    """The launcher's CPU route writes the plain version's rows and nonzeros
    at the target's offsets and nothing else; a constant output writes
    zeros."""
    program = forward.compile_expr(forward.ExprOps.op("mul", forward._Expr("in", (), 0),
                                                      forward._Expr("in", (), 1)))[0]
    rng = np.random.default_rng(8)
    n, batch = 40, 3
    gc, gr = _pattern(rng, n, batch)
    target = ops.RootScatter(gc.numpy(), gr.numpy(), n, 5, 7, "cpu")
    data = torch.full((7 + gc.shape[0] + 2,), 9.0, dtype=torch.float64)
    rhs = torch.full((5 + n + 2,), 9.0, dtype=torch.float64)
    inputs = [(torch.tensor(rng.standard_normal(n)), torch.tensor(rng.standard_normal((batch, n)))),
              (torch.tensor(rng.standard_normal(n)), None)]
    program.launcher().scatter(inputs, batch, target, data, rhs)
    want_rhs, want_data = reference.dual_ew_scatter(program.instrs, program.imm, inputs, batch, gc, gr)
    assert torch.equal(rhs[5:-2], want_rhs) and torch.equal(data[7:-2], want_data)
    assert bool((rhs[:5] == 9.0).all() and (rhs[-2:] == 9.0).all() and (data[:7] == 9.0).all())
    consts = [(v, None) for v, _t in inputs]
    program.launcher().scatter(consts, batch, target, data, rhs)
    assert not bool(data[7:-2].any())


# -- (d) the tables and the checks -----------------------------------------------------


@pytest.mark.parametrize("rows", [0, 1, 31, 32, 33, 64, 100])
def test_root_scatter_tiles(rows):
    rng = np.random.default_rng(rows)
    gc, gr = _pattern(rng, rows, 6)
    target = ops.RootScatter(gc.numpy(), gr.numpy(), rows, 0, 0, "cpu")
    tile = target.tile.numpy()
    assert tile.shape == (-(-rows // 32) + 1,)
    assert tile[0] == 0 and tile[-1] == gc.shape[0]
    for b in range(tile.size - 1):
        rows_of = gr.numpy()[tile[b]:tile[b + 1]]
        assert bool(((rows_of >= 32 * b) & (rows_of < 32 * (b + 1))).all())
    assert target.max_pairs == (int(np.diff(tile).max()) if tile.size > 1 else 0)


def test_scatter_checks():
    with pytest.raises(ValueError):
        ops.RootScatter(np.array([0, 1]), np.array([1, 0]), 2, 0, 0, "cpu")  # not row-major
    with pytest.raises(ValueError):
        ops.RootScatter(np.array([0]), np.array([3]), 2, 0, 0, "cpu")  # a row outside
    program = forward._IDENTITY
    target = ops.RootScatter(np.array([0, 0]), np.array([0, 1]), 2, 0, 0, "cpu")
    inputs = [(torch.ones(2, dtype=torch.float64), torch.ones((1, 2), dtype=torch.float64))]
    with pytest.raises(ValueError):
        program.launcher().scatter(inputs, 1, target, torch.zeros(2, dtype=torch.float64),
                                   torch.zeros(1, dtype=torch.float64))  # rhs too short
    with pytest.raises(ValueError):
        program.launcher().scatter(inputs, 1, target, None, torch.zeros(2, dtype=torch.float64))
    three = [(torch.ones(3, dtype=torch.float64), None)]
    with pytest.raises(ValueError):
        program.launcher().scatter(three, 0, target, None, torch.zeros(3, dtype=torch.float64))


def test_the_separate_gather_is_gone():
    assert not hasattr(ops, "jac_gather") and "jac_gather" not in ops.LAUNCHES
    assert "dual_ew_scatter" in ops.LAUNCHES
    assert "ppt_jac_gather" not in build._SIGNATURES
    assert hasattr(reference, "jac_gather")  # the oracle of the parent's route
