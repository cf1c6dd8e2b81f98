"""The hand-written forward-mode pass of the assembly (K8) on the CPU.

(a) every opcode of the ``dual_ew`` program and every dual rule against
    ``torch.func.jvp`` of the same function (1e-14 of the largest entry; ties,
    broadcasts, empty and constant operands included);
(b) every equation of md 1/16, 3d 4^3, biot 1/16, tracer 1/8, the
    ``DarcysLawAd`` model 1/8 and the fractured poromechanics (contact) case:
    the executor against ``compiler.colored_jvps`` (1e-12 of the largest
    entry), with no node left without a rule;
(c) ``_data_and_rhs`` and ``_rhs_only`` against porepy_tpu's
    ``_CompiledSystem`` on the same state (the tolerances of
    ``test_torch_assembly.py``);
(d) the plain versions of ``dual_ew``, ``dual_gather`` and ``jac_gather``
    (the parent's last stage, the oracle of the root scatter) against numpy;
(e) the per-step launchers of the gathers: three passes in a row at
    different states equal to ``colored_jvps`` to the bit (md, biot,
    tracer), the unknowns' tangent rows written once per color set, no
    result aliasing a launcher's buffer.

All inputs come from numpy seeds. The tests marked ``cuda`` hold the CUDA
kernels against the plain versions and skip without a card (only the tests
of (c) import jax and porepy_tpu, inside the test):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_forward_ad.py -m cuda
"""

import warnings

import numpy as np
import pytest
import torch

import chip_smoke
import porepy_tpu_torch as pt
from porepy_tpu_torch.applications.benchmarking import cases as cases_torch
from porepy_tpu_torch.grids.md_grid import MixedDimensionalGrid
from porepy_tpu_torch.interop import tensors_from_numpy
from porepy_tpu_torch.kernels import ops, reference
from porepy_tpu_torch.numerics import ad
from porepy_tpu_torch.numerics.ad import compiler, forward
from porepy_tpu_torch.numerics.ad import functions as adf
from porepy_tpu_torch.numerics.fv import upwind

torch.set_num_threads(1)

B, N = 3, 7
TOL = 1e-14


def _t(a):
    return torch.tensor(np.asarray(a, dtype=float))


def _close(got, want, tol=TOL):
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.numel() == 0:
        return
    same_nan = torch.isnan(got) == torch.isnan(want)
    assert bool(same_nan.all()), "NaN pattern differs"
    got, want = torch.nan_to_num(got, nan=0.0), torch.nan_to_num(want, nan=0.0)
    scale = max(float(want.abs().max()), 1.0)
    assert float((got - want).abs().max()) <= tol * scale


def _jvp_reference(fn, vals, tans):
    """``(value, (B, n) tangents)`` of ``fn`` by ``torch.func``; a ``None``
    tangent marks a constant argument."""
    return forward.jvp_node(fn, [forward.Dual(v, t) for v, t in zip(vals, tans)]).pair()


def _program(name, n_args):
    E = forward.ExprOps
    ins = [forward._Expr("in", (), k) for k in range(n_args)]
    return forward.compile_expr(E.op(name, *ins))[0]


def _run(program, vals, tans, batch=B):
    return reference.dual_ew(program.instrs, program.imm, list(zip(vals, tans)), batch)


def _emit_and_run(rule, vals, tans, batch=B):
    """The program of an elementwise rule on ``vals`` and ``tans`` (given in
    argument order; the program numbers its inputs in the order it meets them)."""
    ins = [forward._Expr("in", (), k) for k in range(len(vals))]
    program, order = forward.compile_expr(rule.emit(forward.ExprOps, *ins))
    return _run(program, [vals[k] for k in order], [tans[k] for k in order], batch)


# -- (a) opcodes ------------------------------------------------------------------

_UNARY_DOMAIN = {
    "log": (0.5, 2.0), "arcsin": (-0.9, 0.9), "arccos": (-0.9, 0.9), "arccosh": (1.5, 3.0),
    "arctanh": (-0.9, 0.9), "sqrt": (0.5, 2.0),
}
_UNARY_TORCH = {
    "neg": torch.neg, "exp": torch.exp, "log": torch.log, "sin": torch.sin, "cos": torch.cos,
    "tan": torch.tan, "arcsin": torch.arcsin, "arccos": torch.arccos, "arctan": torch.arctan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh, "arcsinh": torch.arcsinh,
    "arccosh": torch.arccosh, "arctanh": torch.arctanh, "abs": torch.abs, "sqrt": torch.sqrt,
}


@pytest.mark.parametrize("name", sorted(_UNARY_TORCH))
def test_unary_opcode_matches_jvp(name):
    rng = np.random.default_rng(sorted(_UNARY_TORCH).index(name))
    lo, hi = _UNARY_DOMAIN.get(name, (-1.5, 1.5))
    x = _t(rng.uniform(lo, hi, N))
    dx = _t(rng.standard_normal((B, N)))
    program = _program(name, 1)
    val, tan = _run(program, [x], [dx])
    want_v, want_t = _jvp_reference(_UNARY_TORCH[name], [x], [dx])
    _close(val, want_v)
    _close(tan, want_t)
    # A constant argument: the value alone, no tangent.
    val, tan = _run(program, [x], [None])
    _close(val, want_v)
    assert tan is None


_BINARY_TORCH = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div, "pow": torch.pow,
}


@pytest.mark.parametrize("const", ["none", "first", "second"])
@pytest.mark.parametrize("shape", ["full", "scalar0", "scalar1", "empty"])
@pytest.mark.parametrize("name", sorted(_BINARY_TORCH))
def test_binary_opcode_matches_jvp(name, shape, const):
    rng = np.random.default_rng(7)
    n = 0 if shape == "empty" else N
    a = _t(rng.uniform(0.5, 2.0, n))
    da = _t(rng.standard_normal((B, n)))
    if shape == "scalar0":
        b, db = _t(rng.uniform(0.5, 2.0)), _t(rng.standard_normal((B, 1)))
    elif shape == "scalar1":
        b, db = _t(rng.uniform(0.5, 2.0, 1)), _t(rng.standard_normal((B, 1)))
    else:
        b, db = _t(rng.uniform(0.5, 2.0, n)), _t(rng.standard_normal((B, n)))
    tans = [None if const == "first" else da, None if const == "second" else db]
    program = _program(name, 2)
    val, tan = _run(program, [a, b], tans)
    want_v, want_t = _jvp_reference(_BINARY_TORCH[name], [a, b], tans)
    _close(val, want_v)
    _close(tan, want_t.expand(B, n) if want_t.shape != (B, n) else want_t)


def test_pow_with_constant_exponent_takes_no_log():
    """``a ** c`` at ``a <= 0`` with a constant exponent: finite tangents
    where ``torch.func`` has them (no ``log`` of the base)."""
    a = _t([-2.0, -0.5, 0.0, 0.0, 1.5])
    da = _t(np.random.default_rng(0).standard_normal((B, 5)))
    for c in (2.0, 3.0, 1.0, 0.0, -1.0):
        val, tan = _run(_program("pow", 2), [a, _t(c)], [da, None])
        want_v, want_t = _jvp_reference(lambda x: x ** c, [a], [da])
        _close(val, want_v)
        _close(tan, want_t)


def test_constant_operand_adds_no_term():
    """``a * b`` with a constant ``b = inf``: the tangent is ``da * b``, not
    ``da * b + a * 0`` (which would be NaN)."""
    a, b = _t([1.0, 0.0, 2.0]), _t([np.inf, np.inf, 1.0])
    da = _t(np.ones((B, 3)))
    val, tan = _run(_program("mul", 2), [a, b], [da, None])
    want_v, want_t = _jvp_reference(lambda x: x * b, [a], [da])
    _close(tan, want_t)
    assert bool(torch.isinf(tan[:, 0]).all())
    val, tan = _run(_program("div", 2), [b, a], [None, da])
    want_v, want_t = _jvp_reference(lambda x: b / x, [a], [da])
    _close(val, want_v)
    _close(tan, want_t)


def test_mask_and_select_opcodes():
    rng = np.random.default_rng(3)
    a = _t([0.0, 1.0, -1.0, 2.0, 2.0, np.nan])
    b = _t([0.0, 0.5, 3.0, 2.0, -2.0, 1.0])
    da, db = _t(rng.standard_normal((B, 6))), _t(rng.standard_normal((B, 6)))
    for name, fn in (("gt", torch.gt), ("ge", torch.ge)):
        val, tan = _run(_program(name, 2), [a, b], [da, db])
        assert tan is None
        assert torch.equal(val, fn(a, b).double())
    val, tan = _run(_program("leabs", 2), [a, b.abs()], [da, None])
    assert tan is None and torch.equal(val, (a.abs() <= b.abs()).double())
    val, tan = _run(_program("sign", 1), [a], [da])
    assert tan is None
    _close(val, torch.sign(a))
    val, tan = _run(_program("detach", 1), [a], [da])
    assert tan is None
    _close(val, a)
    mask = _t([1.0, 0.0, 1.0, 0.0, 2.0, 0.0])
    val, tan = _run(_program("select", 3), [mask, a, b], [None, da, db])
    _close(val, torch.where(mask != 0, a, b))
    _close(tan, torch.where(mask != 0, da, db))
    val, tan = _run(_program("select", 3), [mask, a, b], [None, None, db])
    _close(tan, torch.where(mask != 0, torch.zeros_like(db), db))
    val, tan = _run(_program("custom", 3), [a, b, b], [da, None, db])
    _close(val, a)
    _close(tan, b * db)


def test_values_only_without_seeds():
    x = _t(np.linspace(0.1, 1.0, N))
    val, tan = _run(_program("exp", 1), [x], [_t(np.ones((B, N)))], batch=0)
    assert tan is None
    _close(val, torch.exp(x))


def test_program_checks():
    with pytest.raises(ValueError):
        ops.DualProgram([("add", 0, 5, 0)], (), 2)  # reads an input that is not there
    with pytest.raises(ValueError):
        ops.DualProgram([("add", 0, reference.DUAL_MAX_INPUTS, 0)], (), 2)  # its own result
    with pytest.raises(ValueError):
        ops.DualProgram([("loadi", 1, 0, 0)], (1.0,), 1)
    with pytest.raises(ValueError):
        ops.DualProgram([("neg", 0, 0, 0)] * (reference.DUAL_MAX_INSTRS + 1), (), 1)
    program = ops.DualProgram([("mul", 0, 1, 0), ("gt", reference.DUAL_MAX_INPUTS, 0, 0)], (), 2)
    assert program.out_const((False, False))
    assert not _program("mul", 2).out_const((True, False))
    assert _program("mul", 2).out_const((True, True))


# -- (a) dual rules of the function library -----------------------------------------


def _rule_of(node):
    return node.func, node.func.dual_rule


def _elementwise_case(node, vals, tans, tol=TOL):
    func, rule = _rule_of(node)
    assert isinstance(rule, forward.Elementwise)
    val, tan = _emit_and_run(rule, vals, tans)
    want_v, want_t = _jvp_reference(func, vals, tans)
    _close(val, want_v, tol)
    if want_t is None or all(t is None for t in tans):
        assert tan is None
    elif tan is None:
        # A function of constant value (a step, a mask): torch.func gives zeros.
        assert not bool(want_t.any())
    else:
        _close(tan, want_t, tol)


_X = ad.DenseArray(np.zeros(N))

_LIBRARY_UNARY = [
    "exp", "log", "sin", "cos", "tan", "arcsin", "arccos", "arctan", "sinh", "cosh", "tanh",
    "arcsinh", "arccosh", "arctanh", "abs", "sign",
]


@pytest.mark.parametrize("name", _LIBRARY_UNARY)
def test_library_unary_rule(name):
    rng = np.random.default_rng(_LIBRARY_UNARY.index(name))
    lo, hi = _UNARY_DOMAIN.get(name, (-1.5, 1.5))
    x = _t(rng.uniform(lo, hi, N))
    dx = _t(rng.standard_normal((B, N)))
    _elementwise_case(getattr(adf, name)(_X), [x], [dx])
    _elementwise_case(getattr(adf, name)(_X), [x], [None])


def test_heaviside_rules():
    x = _t([-1.0, 0.0, -0.0, 2.0, 0.3, -0.2, np.nan])
    dx = _t(np.random.default_rng(0).standard_normal((B, 7)))
    for zerovalue in (0.5, 0.0, 1.0):
        _elementwise_case(adf.heaviside(_X, zerovalue), [x], [dx])
    _elementwise_case(adf.heaviside_smooth(_X, 1e-2), [x[:6]], [dx[:, :6]])
    _elementwise_case(adf.heaviside_smooth(_X), [x[:6]], [None])


@pytest.mark.parametrize("const", ["none", "first", "second"])
def test_maximum_rule_tie_follows_first_argument(const):
    a = _t([1.0, 2.0, 3.0, -1.0, 0.0])
    b = _t([1.0, 3.0, 2.0, -1.0, -0.0])  # ties at 0, 3, 4
    rng = np.random.default_rng(1)
    da, db = _t(rng.standard_normal((B, 5))), _t(rng.standard_normal((B, 5)))
    tans = [None if const == "first" else da, None if const == "second" else db]
    _elementwise_case(adf.maximum(_X, _X), [a, b], tans)
    if const == "none":
        _val, tan = _emit_and_run(adf.maximum(_X, _X).func.dual_rule, [a, b], tans)
        assert torch.equal(tan[:, [0, 3, 4]], da[:, [0, 3, 4]])
    # A scalar second argument is broadcast.
    _elementwise_case(adf.maximum(_X, 0.0), [a, _t(0.0)], [da, None])


@pytest.mark.parametrize("power", [-1.0, 0.5, 2.0, 3.0])
def test_safe_power_rule(power):
    x = _t([0.0, 1e-12, -2.0, 0.5, 3.0])
    if power == 0.5:
        x = x.abs()
    dx = _t(np.random.default_rng(2).standard_normal((B, 5)))
    node = adf.safe_power(power, 1e3 if power < 0 else 0.5, 1e-10, _X)
    _elementwise_case(node, [x], [dx])
    _elementwise_case(node, [x], [None])


def test_characteristic_rules():
    x = _t([0.0, 1e-10, -1e-10, 2e-10, 1.0, -3.0])
    dx = _t(np.ones((B, 6)))
    _elementwise_case(adf.characteristic_function(1e-10, _X), [x], [dx])
    from functools import partial

    from porepy_tpu_torch.models.contact_mechanics import _characteristic

    fn = ad.Function(
        partial(_characteristic, 1e-10), "open_state",
        dual_rule=forward.elementwise(lambda E, v: E.op("leabs", v, E.imm(1e-10))),
    )
    _elementwise_case(fn(_X), [x], [dx])


@pytest.mark.parametrize("nd", [1, 2, 3])
def test_l2_norm_rule(nd):
    rng = np.random.default_rng(nd)
    x = rng.standard_normal(nd * 5)
    x[:nd] = 0.0  # a zero vector: unit weights
    x, dx = _t(x), _t(rng.standard_normal((B, nd * 5)))
    node = adf.l2_norm(nd, ad.DenseArray(np.zeros(nd * 5)))
    func, rule = _rule_of(node)
    run = forward._Run(x, (), None, B)
    got = rule(run, forward.Dual(x, dx))
    want_v, want_t = _jvp_reference(func, [x], [dx])
    _close(got.val, want_v)
    _close(got.tan, want_t)
    # A constant argument, and a pass without seeds: the same program gives
    # the value alone.
    for r, arg in ((run, forward.Dual(x)), (forward._Run(x, (), None, 0), forward.Dual(x, dx))):
        got = rule(r, arg)
        assert got.tan is None
        _close(got.val, want_v)


def test_l2_norm_rule_runs_its_program_without_a_tangent(monkeypatch):
    """With a constant argument or no seeds the rule still goes through
    ``dual_ew`` (on a card: the kernel), never through the plain function."""
    calls = []
    real = ops.dual_ew
    monkeypatch.setattr(ops, "dual_ew", lambda *a: calls.append(a[2]) or real(*a))
    x = _t(np.arange(6.0))
    rule = adf.l2_norm(2, ad.DenseArray(np.zeros(6))).func.dual_rule
    rule(forward._Run(x, (), None, B), forward.Dual(x))
    rule(forward._Run(x, (), None, 0), forward.Dual(x))
    assert calls == [B, 0]


def test_surrogate_rule():
    """``v + sum_k d_k (x_k - detach(x_k))``: the stored value, the tangent
    ``sum_k d_k dx_k``."""
    rng = np.random.default_rng(5)
    v, d1, d2, x1, x2 = (_t(rng.standard_normal(N)) for _ in range(5))
    dx1, dx2 = _t(rng.standard_normal((B, N))), _t(rng.standard_normal((B, N)))

    class Holder:
        pass

    op = ad.SurrogateOperator.__new__(ad.SurrogateOperator)
    ad.SurrogateOperator.__init__(op, "s", [], [ad.Variable.__new__(ad.Variable)] * 2, Holder())
    rule = op.func.dual_rule
    val, tan = _emit_and_run(rule, [v, d1, d2, x1, x2], [None, None, None, dx1, dx2])
    _close(val, v)
    _close(tan, d1 * dx1 + d2 * dx2)
    want_v, want_t = _jvp_reference(op.func, [v, d1, d2, x1, x2], [None, None, None, dx1, dx2])
    _close(val, want_v)
    _close(tan, want_t)


def test_interpolated_and_diagonal_jacobian_rules():
    rng = np.random.default_rng(6)
    tab = ad.InterpolatedFunction(
        lambda p, T: p * p + np.sin(T), "tab", [0.0, 0.0], [2.0, 3.0], [21, 31]
    )
    p, T = _t(rng.uniform(-0.2, 2.2, N)), _t(rng.uniform(-0.2, 3.2, N))
    dp, dT = _t(rng.standard_normal((B, N))), _t(rng.standard_normal((B, N)))
    run = forward._Run(p, (), None, B)
    rule = tab.func.dual_rule
    for tans in ([dp, dT], [dp, None], [None, dT], [None, None]):
        got = rule(run, forward.Dual(p, tans[0]), forward.Dual(T, tans[1]))
        want_v, want_t = _jvp_reference(tab.func, [p, T], tans)
        _close(got.val, want_v, 1e-13)
        if want_t is None:
            assert got.tan is None
        else:
            _close(got.tan, want_t, 1e-13)

    def square_rule(run, a):
        return forward.run_program(_program("mul", 2), [a, a], run.batch)

    fn = ad.DiagonalJacobianFunction(lambda a: a * a, "sq", 3.0, dual_rule=square_rule)
    got = fn.func.dual_rule(run, forward.Dual(p, dp))
    want_v, want_t = _jvp_reference(fn.func, [p], [dp])
    _close(got.val, want_v)
    _close(got.tan, want_t)
    # An elementwise rule takes the scaling into its own program.
    fn = ad.DiagonalJacobianFunction(
        lambda a, b: a * torch.exp(b), "scaled", [3.0, -0.5],
        dual_rule=forward.elementwise(lambda E, a, b: E.op("mul", a, E.op("exp", b))),
    )
    assert isinstance(fn.func.dual_rule, forward.Elementwise)
    val, tan = _emit_and_run(fn.func.dual_rule, [p, T], [dp, None])
    want_v, want_t = _jvp_reference(fn.func, [p, T], [dp, None])
    _close(val, want_v)
    _close(tan, want_t)
    # Without a rule of its own the function goes through torch.func.
    assert not hasattr(ad.DiagonalJacobianFunction(lambda a: a * a, "sq", 3.0).func, "dual_rule")


def test_diagonal_jacobian_scaling_is_a_program(monkeypatch):
    """The multipliers of a function with a callable rule are applied by
    ``dual_ew`` (one launch per argument), not by tensor arithmetic."""
    calls = []
    real = ops.dual_ew
    monkeypatch.setattr(ops, "dual_ew", lambda *a: calls.append(a[0]) or real(*a))
    x, dx = _t(np.linspace(0.1, 1.0, N)), _t(np.ones((B, N)))
    fn = ad.DiagonalJacobianFunction(
        lambda a, b: a + b, "sum", [2.0, 4.0],
        dual_rule=lambda run, a, b: forward.run_program(_program("add", 2), [a, b], run.batch),
    )
    got = fn.func.dual_rule(forward._Run(x, (), None, B), forward.Dual(x, dx), forward.Dual(x))
    _close(got.val, 6.0 * x)
    _close(got.tan, 2.0 * dx)
    assert len(calls) == 3 and [c.imm for c in calls[:2]] == [(2.0,), (4.0,)]


def _upwind_geometry():
    g = pt.CartGrid(np.array([4, 3]), np.array([1.0, 1.0]))
    g.compute_geometry()
    faces = g.get_all_boundary_faces()
    bc = pt.BoundaryCondition(g, faces[g.face_centers[0, faces] < 0.5], "dir")
    return upwind.UpwindGeometry([g], [bc]), g


@pytest.mark.parametrize("const", ["none", "q", "w", "bc", "all"])
def test_upwind_dual_rules(const):
    geom, g = _upwind_geometry()
    rng = np.random.default_rng(8)
    nf, nc = g.num_faces, g.num_cells
    q_np = rng.standard_normal(nf)
    q_np[::4] = 0.0
    q_np[1::7] = -0.0
    q, w, bc = _t(q_np), _t(rng.standard_normal(nc)), _t(rng.standard_normal(nf))
    tans = {k: _t(rng.standard_normal((B, n))) for k, n in (("q", nf), ("w", nc), ("bc", nf))}
    for k in tans:
        if const in (k, "all"):
            tans[k] = None
    duals = [forward.Dual(v, tans[k]) for k, v in (("q", q), ("w", w), ("bc", bc))]
    got = upwind.upwind_flux_dual(geom, *duals)
    want_v, want_t = _jvp_reference(
        lambda *a: upwind.upwind_flux(geom, *a), [q, w, bc], [tans["q"], tans["w"], tans["bc"]]
    )
    _close(got.val, want_v)
    if const == "all":
        assert got.tan is None
    else:
        _close(got.tan, want_t)
    got = upwind.upwind_apply_dual(geom, duals[0], duals[1])
    want_v, want_t = _jvp_reference(
        lambda *a: upwind.upwind_apply(geom, *a), [q, w], [tans["q"], tans["w"]]
    )
    _close(got.val, want_v)
    if tans["w"] is None:
        assert got.tan is None
    else:
        _close(got.tan, want_t)
    got = upwind.upwind_select_pair_dual(duals[0], duals[2], forward.Dual(2.0 * bc, tans["q"]))
    want_v, want_t = _jvp_reference(
        upwind.upwind_select_pair, [q, bc, 2.0 * bc], [None, tans["bc"], tans["q"]]
    )
    _close(got.val, want_v)
    if tans["bc"] is None and tans["q"] is None:
        assert got.tan is None
    else:
        _close(got.tan, want_t)


def test_ruleless_node_goes_through_torch_func_and_is_counted():
    """A user function without a rule: differentiated by ``torch.func`` on
    its node alone, listed by the executor, same Jacobian."""
    g = pt.CartGrid(np.array([3, 2]), np.array([1.0, 1.0]))
    g.compute_geometry()
    mdg = MixedDimensionalGrid()
    mdg.add_subdomains([g])
    es = ad.EquationSystem(mdg, device="cpu")
    x = es.create_variables("x", subdomains=[g])
    es.set_variable_values(np.linspace(0.1, 1.0, g.num_cells), iterate_index=0)
    user = ad.Function(lambda a: torch.cos(a) * a, "user")
    ruled = ad.Function(
        lambda a: torch.cos(a) * a, "ruled",
        dual_rule=forward.elementwise(lambda E, a: E.op("mul", E.op("cos", a), a)),
    )
    values = {}
    for fn in (user, ruled):
        op = fn(x * 2.0) + ad.exp(x)
        if fn is user:
            with pytest.warns(UserWarning, match="'user' has no dual rule"):
                f, env_spec = compiler.build_function(op, es)
        else:
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                f, env_spec = compiler.build_function(op, es)
        assert f.dual.ruleless == (["user"] if fn is user else [])
        xt = torch.tensor(es._global_vector())
        colors = torch.arange(g.num_cells, dtype=torch.int32)
        val, tan = compiler.dual_jvps(f, xt, env_spec.fetch(es), colors, g.num_cells)
        want_v, want_t = compiler.colored_jvps(
            f, xt, env_spec.fetch(es), torch.eye(g.num_cells, dtype=torch.float64)
        )
        _close(val, want_v)
        _close(tan, want_t)
        values[fn.name] = tan
        jac = op.value_and_jacobian(es).jac.toarray()
        np.testing.assert_allclose(jac, tan.numpy().T, rtol=0, atol=1e-14)
    _close(values["user"], values["ruled"])


def test_elementwise_rule_that_outgrows_a_program_raises():
    """A rule the kernel cannot take is an error when the equation is
    compiled; it is not handed to ``torch.func``."""
    g = pt.CartGrid(np.array([3, 2]), np.array([1.0, 1.0]))
    g.compute_geometry()
    mdg = MixedDimensionalGrid()
    mdg.add_subdomains([g])
    es = ad.EquationSystem(mdg, device="cpu")
    x = es.create_variables("x", subdomains=[g])

    def long_chain(E, a):
        for _ in range(reference.DUAL_MAX_INSTRS + 1):
            a = E.op("sin", a)
        return a

    def many_inputs(E, *args):
        out = args[0]
        for a in args[1:]:
            out = E.op("add", out, a)
        return out

    def f(*args):
        return args[0]

    too_long = ad.Function(f, "too_long", dual_rule=forward.elementwise(long_chain))
    too_wide = ad.Function(f, "too_wide", dual_rule=forward.elementwise(many_inputs))
    consts = [ad.DenseArray(np.full(g.num_cells, float(k))) for k in range(reference.DUAL_MAX_INPUTS)]
    for op, name in ((too_long(x), "too_long"), (too_wide(x, *consts), "too_wide")):
        with pytest.raises(NotImplementedError, match=f"'{name}' does not fit one dual_ew program"):
            compiler.build_function(op, es)
    # One instruction and one input fewer both fit, inside a larger equation too.
    fits = ad.Function(
        f, "fits",
        dual_rule=forward.elementwise(lambda E, a: long_chain(E, a).args[0].args[0]),
    )
    wide = ad.Function(f, "wide", dual_rule=forward.elementwise(many_inputs))
    fn, _spec = compiler.build_function(fits(x) * 2.0 + wide(x, *consts[1:]), es)
    assert fn.dual.ruleless == []


def test_concat_empty_and_constant_operands():
    g = pt.CartGrid(np.array([3, 2]), np.array([1.0, 1.0]))
    g.compute_geometry()
    mdg = MixedDimensionalGrid()
    mdg.add_subdomains([g])
    es = ad.EquationSystem(mdg, device="cpu")
    x = es.create_variables("x", subdomains=[g])
    es.set_variable_values(np.linspace(0.1, 1.0, g.num_cells), iterate_index=0)
    n = g.num_cells
    const = ad.DenseArray(np.arange(2.0))
    empty = es.md_variable("x", [])
    op = ad.concat([x * x, const, empty, ad.Scalar(3.0) * x.previous_timestep(), ad.Scalar(2.0)])
    f, env_spec = compiler.build_function(op, es)
    xt = torch.tensor(es._global_vector())
    env = env_spec.fetch(es)
    val, tan = compiler.dual_jvps(f, xt, env, torch.arange(n, dtype=torch.int32), n)
    want_v, want_t = compiler.colored_jvps(f, xt, env, torch.eye(n, dtype=torch.float64))
    _close(val, want_v)
    _close(tan, want_t)
    assert compiler.dual_jvps(f, xt, env, None, 0)[1] is None
    # A residual that does not depend on x at all has no tangent.
    f, env_spec = compiler.build_function(const * ad.Scalar(2.0), es)
    val, tan = compiler.dual_jvps(f, xt, env_spec.fetch(es), torch.zeros(n, dtype=torch.int32), 1)
    assert tan is None
    _close(val, _t([0.0, 4.0]) / 2)


# -- (b) every equation of the cases ---------------------------------------------------

_MODELS = {}


def _model(case):
    if case not in _MODELS:
        if case == "darcy_ad":
            Model, params = cases_torch.build_darcy_ad(1.0 / 8, "cpu")
            model = Model(params)
        elif case == "contact":
            model, params = chip_smoke.build_fractured_poromechanics("cpu")
        else:
            make, size = {
                "md": (cases_torch.build_md_flow, 1.0 / 16),
                "3d": (cases_torch.build_3d_flow, 1.0 / 4),
                "biot": (cases_torch.build_biot, 1.0 / 16),
                "tracer": (cases_torch.build_tracer, 1.0 / 8),
            }[case]
            Model, params = make(size, device="cpu")
            model = Model(params)
        model.prepare_simulation()
        es = model.equation_system
        cs = es.compiled_system()
        x0 = es._global_vector()
        rng = np.random.default_rng(11)
        # Away from the initial state, so that every term is exercised.
        x = x0 + 0.05 * (np.abs(x0).max() + 1.0) * rng.uniform(0.0, 1.0, x0.size)
        _MODELS[case] = (model, cs, torch.tensor(x), cs._envs(es))
    return _MODELS[case]


_EQUATIONS = [
    ("md", "mass_balance_equation"),
    ("md", "interface_darcy_flux_equation"),
    ("3d", "mass_balance_equation"),
    ("biot", "mass_balance_equation"),
    ("biot", "momentum_balance_equation"),
    ("tracer", "mass_balance_equation"),
    ("tracer", "interface_darcy_flux_equation"),
    ("tracer", "component_mass_balance_equation_tracer"),
    ("darcy_ad", "mass_balance_equation"),
    ("darcy_ad", "interface_darcy_flux_equation"),
    ("contact", "mass_balance_equation"),
    ("contact", "interface_darcy_flux_equation"),
    ("contact", "momentum_balance_equation"),
    ("contact", "interface_force_balance_equation"),
    ("contact", "normal_fracture_deformation_equation"),
    ("contact", "tangential_fracture_deformation_equation"),
]


@pytest.mark.parametrize("case", ["md", "3d", "biot", "tracer", "darcy_ad", "contact"])
def test_equation_list_is_complete(case):
    _model_, cs, _x, _envs = _model(case)
    assert sorted(cs.names) == sorted(name for c, name in _EQUATIONS if c == case)


@pytest.mark.parametrize("case,name", _EQUATIONS)
def test_executor_matches_colored_jvps(case, name):
    _model_, cs, x, envs = _model(case)
    i = cs.names.index(name)
    ce, env = cs.ces[i], envs[i]
    assert ce.fn.dual.ruleless == []
    val, tan = compiler.dual_jvps(ce.fn, x, env, ce.colors_on(x.device), ce.n_colors)
    want_v, want_t = compiler.colored_jvps(ce.fn, x, env, torch.tensor(ce.seeds))
    _close(val, want_v, 1e-12)
    _close(tan, want_t, 1e-12)
    _close(compiler.dual_jvps(ce.fn, x, env, None, 0)[0], want_v, 1e-12)


@pytest.mark.parametrize("case", ["md", "3d", "biot", "tracer", "darcy_ad", "contact"])
def test_system_assembly_matches_plain_route(case):
    _model_, cs, x, envs = _model(case)
    data, b = cs._data_and_rhs(x, envs)
    want_data, want_b = chip_smoke.functorch_data_and_rhs(cs, x, envs)
    _close(data, want_data, 1e-12)
    _close(b, want_b, 1e-12)
    _close(cs._rhs_only(x, envs), chip_smoke.functorch_rhs_only(cs, x, envs), 1e-12)
    # The host route of one equation gives the same Jacobian.
    ce = cs.ces[0]
    val, jac = ce.residual_and_jacobian(x, envs[0], x.shape[0])
    lo, hi = cs._nnz_offsets[0], cs._nnz_offsets[1]
    np.testing.assert_allclose(jac.tocsr()[ce.rows, ce.cols].A1, data[lo:hi].numpy(), rtol=0, atol=0)


def test_stacked_layout_is_recognized():
    """Value and tangent rows that are views of one ``(B + 1, n)`` buffer
    (the layout the kernels write) go to the matvec as one batch; anything
    else does not pass for it."""
    buf = _t(np.random.default_rng(4).standard_normal((B + 1, N)))
    assert forward.Dual(buf[0], buf[1:]).stacked() is buf
    assert forward.Dual(buf[0], buf[1:].clone()).stacked() is None
    assert forward.Dual(buf[1], buf[2:]).stacked() is None
    assert forward.Dual(buf[0], buf[2:]).stacked() is None
    assert forward.Dual(buf[0]).stacked() is None
    wide = _t(np.zeros((B + 1, 2 * N)))
    assert forward.Dual(wide[0, :N], wide[1:, :N]).stacked() is None
    # The matvec gives the same result either way.
    from porepy_tpu_torch.numerics.ad.compiler import _EllMat
    import scipy.sparse as sps

    mat = _EllMat.from_scipy(sps.random(5, N, 0.5, random_state=1, format="csr"), "cpu")
    run = forward._Run(buf[0], (), None, B)
    one = forward._matmul(run, mat, forward.Dual(buf[0], buf[1:]))
    two = forward._matmul(run, mat, forward.Dual(buf[0].clone(), buf[1:].clone()))
    assert torch.equal(one.val, two.val) and torch.equal(one.tan, two.tan)
    assert one.stacked() is not None


def test_buffers_are_freed_after_their_last_consumer():
    _model_, cs, _x, _envs = _model("md")
    ex = cs.ces[0].fn.dual
    freed = [s for frees in ex._frees for s in frees]
    assert len(freed) == len(set(freed)) == len(ex._steps) - 1
    for i, (_step, _slot, inputs) in enumerate(ex._steps):
        for s in inputs:
            assert all(s not in frees for frees in ex._frees[:i])


# -- (c) against porepy_tpu ------------------------------------------------------------


@pytest.mark.parametrize("case", ["md", "tracer"])
def test_assembly_matches_jax(case):
    import jax.numpy as jnp

    from porepy_tpu.applications.benchmarking import cases as cases_jax

    make_jax, size = {
        "md": (cases_jax.build_md_flow, 1.0 / 16),
        "tracer": (cases_jax.build_tracer, 1.0 / 8),
    }[case]
    if case == "tracer":
        # porepy_tpu's build_tracer takes no size: set the same mesh by hand.
        Model, params = make_jax()
        params["meshing_arguments"] = {"cell_size": size}
    else:
        Model, params = make_jax(size)
    params["dense_precond"] = False
    m_jax = Model(params)
    m_jax.prepare_simulation()
    _m, cs_t, _x, _envs = _model(case)
    cs_j = m_jax.equation_system.compiled_system()
    assert cs_t.names == cs_j.names
    x0 = m_jax.equation_system._global_vector()
    x = x0 + np.random.default_rng(0).uniform(0.0, 1.0, x0.size)
    envs = cs_j._envs_host(m_jax.equation_system)
    data_j, b_j = cs_j._data_and_rhs_host(x, envs)
    data_t, b_t = cs_t._data_and_rhs(torch.tensor(x), tensors_from_numpy(envs, "cpu"))
    assert data_t.shape == data_j.shape and b_t.shape == b_j.shape
    assert np.abs(data_t.numpy() - data_j).max() <= 1e-12 * np.abs(data_j).max()
    assert np.abs(b_t.numpy() - b_j).max() <= 1e-12 * np.abs(b_j).max()
    rhs_j = np.asarray(cs_j._rhs_only(jnp.asarray(x), envs))
    rhs_t = cs_t._rhs_only(torch.tensor(x), tensors_from_numpy(envs, "cpu")).numpy()
    assert np.abs(rhs_t - rhs_j).max() <= 1e-13 * np.abs(rhs_j).max()


# -- (d) the plain versions against numpy ------------------------------------------------


def test_plain_dual_ew_against_numpy():
    """``(a * b + exp(c)) / s`` with a scalar ``s`` and a constant ``b``."""
    rng = np.random.default_rng(12)
    a, b, c = (rng.standard_normal(N) for _ in range(3))
    s = 1.7
    da, dc = rng.standard_normal((B, N)), rng.standard_normal((B, N))
    ds = rng.standard_normal((B, 1))
    E = forward.ExprOps
    ins = [forward._Expr("in", (), k) for k in range(4)]
    expr = E.op("div", E.op("add", E.op("mul", ins[0], ins[1]), E.op("exp", ins[2])), ins[3])
    program, order = forward.compile_expr(expr)
    assert order == [0, 1, 2, 3]
    val, tan = _run(program, [_t(a), _t(b), _t(c), _t(s)], [_t(da), None, _t(dc), _t(ds)])
    num = a * b + np.exp(c)
    np.testing.assert_allclose(val.numpy(), num / s, rtol=1e-15)
    want = (da * b + np.exp(c) * dc) / s - num / s ** 2 * ds
    np.testing.assert_allclose(tan.numpy(), want, rtol=0, atol=1e-14 * np.abs(want).max())


def test_plain_dual_gather_against_numpy():
    rng = np.random.default_rng(13)
    ndof, n_colors = 20, 4
    x = rng.standard_normal(ndof)
    colors = rng.integers(0, n_colors, ndof).astype(np.int32)
    idx = rng.permutation(ndof)[:9]
    val, tan = reference.dual_gather_var(_t(x), torch.tensor(idx), torch.tensor(colors), n_colors)
    np.testing.assert_array_equal(val.numpy(), x[idx])
    np.testing.assert_array_equal(
        tan.numpy(), (colors[idx][None, :] == np.arange(n_colors)[:, None]).astype(float)
    )
    assert reference.dual_gather_var(_t(x), torch.tensor(idx), None, 0)[1] is None
    pieces_np = [
        (rng.standard_normal(3), rng.standard_normal((n_colors, 3))),
        (rng.standard_normal(0), None),
        (rng.standard_normal(4), None),
        (rng.standard_normal(1), rng.standard_normal((n_colors, 1))),
    ]
    pieces = [(_t(v), None if t is None else _t(t)) for v, t in pieces_np]
    val, tan = reference.dual_gather_copy(pieces, n_colors)
    np.testing.assert_array_equal(val.numpy(), np.concatenate([v for v, _t_ in pieces_np]))
    want = np.concatenate(
        [np.zeros((n_colors, v.size)) if t is None else t for v, t in pieces_np], axis=1
    )
    np.testing.assert_array_equal(tan.numpy(), want)
    assert reference.dual_gather_copy(pieces[1:3], n_colors)[1] is None


def _jac_inputs(rng, n_eq=3):
    vals, tans, gc, rj, nnz_off, row_off = [], [], [], [], [0], [0]
    for e in range(n_eq):
        rows, colors, nnz = 5 + e, 2 + e, 7 + 2 * e
        vals.append(rng.standard_normal(rows))
        tans.append(None if e == 1 else rng.standard_normal((colors, rows)))
        gc.append(rng.integers(0, colors, nnz))
        rj.append(rng.integers(0, rows, nnz))
        nnz_off.append(nnz_off[-1] + nnz)
        row_off.append(row_off[-1] + rows)
    return vals, tans, np.concatenate(gc), np.concatenate(rj), nnz_off, row_off


def _scatter_pattern(rng, n, batch):
    """A row-major sparsity of ``n`` rows under ``batch`` colors: each row
    holds up to four nonzeros of distinct colors, some none."""
    gc, gr = [], []
    for r in range(n):
        k = int(rng.integers(0, min(4, batch) + 1))
        gc.extend(rng.permutation(batch)[:k])
        gr.extend([r] * k)
    return np.asarray(gc, dtype=np.int64), np.asarray(gr, dtype=np.int64)


def test_plain_jac_gather_against_numpy():
    vals, tans, gc, rj, nnz_off, row_off = _jac_inputs(np.random.default_rng(14))
    data, rhs = reference.jac_gather(
        [_t(v) for v in vals], [None if t is None else _t(t) for t in tans],
        torch.tensor(gc, dtype=torch.int32), torch.tensor(rj, dtype=torch.int32), nnz_off, row_off,
    )
    want = np.concatenate([
        np.zeros(nnz_off[e + 1] - nnz_off[e]) if t is None
        else t[gc[nnz_off[e]:nnz_off[e + 1]], rj[nnz_off[e]:nnz_off[e + 1]]]
        for e, t in enumerate(tans)
    ])
    np.testing.assert_array_equal(data.numpy(), want)
    np.testing.assert_array_equal(rhs.numpy(), -np.concatenate(vals))


# -- (e) the gathers' launchers ------------------------------------------------------------


@pytest.mark.parametrize("case", ["md", "biot", "tracer"])
def test_launchers_over_three_passes_match_colored_jvps(case):
    """Three passes of every equation at three states in a row, through the
    steps' launchers (the unknowns' buffers kept from pass to pass), equal
    ``colored_jvps`` at the same state to the bit; no pass rewrote the
    tangent rows, and the values alone follow the state too."""
    _model_, cs, x, envs = _model(case)
    rng = np.random.default_rng(31)
    for ce, env in zip(cs.ces, envs):
        colors = ce.colors_on(x.device)
        writes = None
        for _ in range(3):
            xk = x + 0.01 * (x.abs().max() + 1.0) * torch.tensor(rng.uniform(0.0, 1.0, x.shape[0]))
            val, tan = compiler.dual_jvps(ce.fn, xk, env, colors, ce.n_colors)
            want_v, want_t = compiler.colored_jvps(ce.fn, xk, env, torch.tensor(ce.seeds))
            assert torch.equal(val, want_v) and torch.equal(tan, want_t)
            assert torch.equal(compiler.dual_jvps(ce.fn, xk, env, None, 0)[0], want_v)
            gathers = ce.fn.dual._gathers
            if writes is None:
                writes = [g.seed_writes for g in gathers]
        assert gathers and all(w >= 1 for w in writes)
        assert [g.seed_writes for g in gathers] == writes


def test_tangent_rows_written_once_per_color_set():
    """``DualGatherVar`` writes the one-hot rows when it first sees a color
    set (the colors tensor, its version, the batch) and only the value row
    after; other colors, another batch or colors changed in place rewrite
    them. Each result equals the plain gather."""
    rng = np.random.default_rng(32)
    ndof, n_colors = 30, 4
    idx = torch.tensor(rng.permutation(ndof)[:17])
    colors = torch.tensor(rng.integers(0, n_colors, ndof).astype(np.int32))
    gather = ops.DualGatherVar(idx)

    def check(colors, batch, writes):
        x = _t(rng.standard_normal(ndof))
        val, tan = gather(x, colors, batch)
        want_v, want_t = reference.dual_gather_var(x, idx, colors, batch)
        assert torch.equal(val, want_v)
        assert (tan is None) if not batch else torch.equal(tan, want_t)
        assert gather.seed_writes == writes

    check(colors, n_colors, 1)
    check(colors, n_colors, 1)
    check(None, 0, 1)
    check(colors, n_colors, 1)
    other = torch.tensor(rng.integers(0, n_colors, ndof).astype(np.int32))
    check(other, n_colors, 2)
    check(colors, n_colors - 1, 3)
    colors[idx[0]] = (colors[idx[0]] + 1) % n_colors
    check(colors, n_colors - 1, 4)
    with pytest.raises(TypeError):
        gather(_t(np.zeros(ndof)), colors.long(), n_colors)
    with pytest.raises(TypeError):
        ops.DualGatherVar(idx.int())


def test_unknown_at_the_root_is_not_aliased():
    """An equation that is an unknown itself returns a copy of the step's
    buffer: a later pass leaves an earlier result as it was."""
    g = pt.CartGrid(np.array([3, 2]), np.array([1.0, 1.0]))
    g.compute_geometry()
    mdg = MixedDimensionalGrid()
    mdg.add_subdomains([g])
    es = ad.EquationSystem(mdg, device="cpu")
    x = es.create_variables("x", subdomains=[g])
    n = g.num_cells
    es.set_variable_values(np.linspace(0.1, 1.0, n), iterate_index=0)
    fn, env_spec = compiler.build_function(x, es)
    env = env_spec.fetch(es)
    colors = torch.arange(n, dtype=torch.int32)
    x0 = torch.tensor(es._global_vector())
    val, tan = compiler.dual_jvps(fn, x0, env, colors, n)
    kept = val.clone(), tan.clone()
    residual = compiler.dual_jvps(fn, x0, env, None, 0)[0]
    assert fn.dual._gathers and not any(
        g.holds(t) for g in fn.dual._gathers for t in (val, tan, residual)
    )
    compiler.dual_jvps(fn, 2.0 * x0 + 1.0, env, colors, n)
    compiler.dual_jvps(fn, 3.0 * x0, env, None, 0)
    assert torch.equal(val, kept[0]) and torch.equal(tan, kept[1])
    assert torch.equal(val, x0) and torch.equal(tan, torch.eye(n, dtype=torch.float64))
    assert torch.equal(residual, x0)


def _copy_pieces(rng, batch, lengths=(3, 1, 0, 4, 1, 6)):
    """Duals to concatenate: some with tangents, some constants, one-element
    and empty ones, and a one-element value that is a strided view."""
    pieces = [
        (_t(rng.standard_normal(k)), None if i % 3 == 2 else _t(rng.standard_normal((batch, k))))
        for i, k in enumerate(lengths)
    ]
    wide = _t(rng.standard_normal((2, 5)))
    pieces.append((wide[:, 2], _t(rng.standard_normal((batch, 2)))))
    pieces.append((wide[1, 3:4], None))
    return pieces


@pytest.mark.parametrize("batch", [3, 0])
def test_copy_launcher_matches_plain(batch):
    """``DualGatherCopy`` over calls with new values and a changed layout
    equals ``reference.dual_gather_copy``; all-constant pieces give no
    tangent."""
    rng = np.random.default_rng(33)
    copy = ops.DualGatherCopy()
    for lengths in ((3, 1, 0, 4, 1, 6), (3, 1, 0, 4, 1, 6), (0, 2, 5)):
        pieces = _copy_pieces(rng, max(batch, 1), lengths)
        val, tan = copy(pieces, batch)
        want_v, want_t = reference.dual_gather_copy(pieces, batch)
        assert torch.equal(val, want_v)
        assert (tan is None) == (want_t is None) and (tan is None or torch.equal(tan, want_t))
    consts = [(v, None) for v, _t_ in _copy_pieces(rng, 2)]
    assert copy(consts, 2)[1] is None


# -- the kernels on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_dual_ew_matches_plain(cuda):
    rng = np.random.default_rng(20)
    n, batch = 5000, 16
    E = forward.ExprOps
    ins = [forward._Expr("in", (), k) for k in range(4)]
    picked = E.op("select", E.op("gt", ins[1], ins[0]), ins[1], ins[0])
    expr = E.op("div", E.op("add", E.op("mul", picked, ins[2]), E.op("exp", ins[0])),
                E.op("pow", ins[3], E.imm(-2.0)))
    program = forward.compile_expr(expr)[0]
    host = [
        (_t(rng.standard_normal(n)), _t(rng.standard_normal((batch, n)))),
        (_t(rng.standard_normal(n)), None),
        (_t(rng.standard_normal(n)), _t(rng.standard_normal((batch, n)))),
        (_t(1.3), _t(rng.standard_normal((batch, 1)))),
    ]
    card = [(v.to(cuda), None if t is None else t.to(cuda)) for v, t in host]
    for b in (batch, 0):
        val, tan = ops.dual_ew(program, card, b)
        want_v, want_t = reference.dual_ew(program.instrs, program.imm, host, b)
        torch.cuda.synchronize()
        _close(val.cpu(), want_v, 1e-13)
        if b:
            _close(tan.cpu(), want_t, 1e-13)
        else:
            assert tan is None


@pytest.mark.cuda
def test_cuda_dual_gather_matches_plain(cuda):
    rng = np.random.default_rng(21)
    ndof, batch = 4000, 11
    x = _t(rng.standard_normal(ndof))
    colors = torch.tensor(rng.integers(0, batch, ndof).astype(np.int32))
    idx = torch.tensor(rng.permutation(ndof)[:1500])
    val, tan = ops.dual_gather_var(x.to(cuda), idx.to(cuda), colors.to(cuda), batch)
    want_v, want_t = reference.dual_gather_var(x, idx, colors, batch)
    assert torch.equal(val.cpu(), want_v) and torch.equal(tan.cpu(), want_t)
    pieces = [
        (_t(rng.standard_normal(k)), None if k % 3 == 0 else _t(rng.standard_normal((batch, k))))
        for k in (300, 1, 0, 77, 512, 9, 33, 1000, 5, 64)
    ]
    card = [(v.to(cuda), None if t is None else t.to(cuda)) for v, t in pieces]
    val, tan = ops.dual_gather_copy(card, batch)
    want_v, want_t = reference.dual_gather_copy(pieces, batch)
    assert torch.equal(val.cpu(), want_v) and torch.equal(tan.cpu(), want_t)


@pytest.mark.cuda
def test_cuda_jac_gather_matches_plain(cuda):
    """The assembly's last stage, now inside each root's launch: the scatter
    mode of ``dual_ew`` (``DualEwLauncher.scatter``) against its plain
    version to the bit, for equations with tangents, one whose output is a
    constant (zeros in its nonzeros) and a pass without seeds."""
    rng = np.random.default_rng(22)
    program = _program("div", 2)
    rows, batch = (300, 41, 77), 5
    pattern = [_scatter_pattern(rng, n, batch) for n in rows]
    nnz_off = np.concatenate([[0], np.cumsum([gc.size for gc, _gr in pattern])])
    row_off = np.concatenate([[0], np.cumsum(rows)])
    data = torch.full((int(nnz_off[-1]),), float("nan"), dtype=torch.float64, device=cuda)
    rhs = torch.full((int(row_off[-1]),), float("nan"), dtype=torch.float64, device=cuda)
    want_data, want_rhs = torch.empty_like(data).cpu(), torch.empty_like(rhs).cpu()
    for e, (n, (gc, gr)) in enumerate(zip(rows, pattern)):
        host = [
            (_t(rng.uniform(1.0, 2.0, n)), None if e == 1 else _t(rng.standard_normal((batch, n)))),
            (_t(rng.uniform(1.0, 2.0, n)), None if e == 1 else _t(rng.standard_normal((batch, n)))),
        ]
        card = [(v.to(cuda), None if t is None else t.to(cuda)) for v, t in host]
        target = ops.RootScatter(gc, gr, n, int(row_off[e]), int(nnz_off[e]), cuda)
        program.launcher().scatter(card, batch, target, data, rhs)
        v, d = reference.dual_ew_scatter(program.instrs, program.imm, host, batch,
                                         torch.tensor(gc, dtype=torch.int32), torch.tensor(gr, dtype=torch.int32))
        want_rhs[row_off[e]:row_off[e + 1]] = v
        want_data[nnz_off[e]:nnz_off[e + 1]] = d
    torch.cuda.synchronize()
    assert torch.equal(data.cpu(), want_data) and torch.equal(rhs.cpu(), want_rhs)
    assert not bool(want_data[nnz_off[1]:nnz_off[2]].any())
    rhs_only = torch.empty_like(rhs)
    for e, (n, (gc, gr)) in enumerate(zip(rows, pattern)):
        vals = [(_t(np.full(n, 1.5)).to(cuda), None), (_t(np.full(n, 3.0)).to(cuda), None)]
        target = ops.RootScatter(gc, gr, n, int(row_off[e]), int(nnz_off[e]), cuda)
        program.launcher().scatter(vals, 0, target, None, rhs_only)
    assert torch.equal(rhs_only.cpu(), torch.full_like(want_rhs, -0.5))


@pytest.mark.cuda
def test_cuda_l2_norm_rule_launches_dual_ew_without_a_tangent(cuda):
    """On card tensors the cell-wise norm goes through the kernel also where
    it has no tangent to compute (a constant argument, a pass without seeds)."""
    from porepy_tpu_torch.kernels import LAUNCHES, reset_launches

    rng = np.random.default_rng(23)
    nd, n, batch = 2, 300, 5
    x, dx = _t(rng.standard_normal(nd * n)), _t(rng.standard_normal((batch, nd * n)))
    node = adf.l2_norm(nd, ad.DenseArray(np.zeros(nd * n)))
    func, rule = _rule_of(node)
    xc, dxc = x.to(cuda), dx.to(cuda)
    want_v, want_t = _jvp_reference(func, [x], [dx])
    for b, arg in ((batch, forward.Dual(xc, dxc)), (batch, forward.Dual(xc)), (0, forward.Dual(xc, dxc))):
        reset_launches()
        got = rule(forward._Run(xc, (), None, b), arg)
        assert LAUNCHES["dual_ew"] == 1
        _close(got.val.cpu(), want_v, 1e-13)
        if b and arg.tan is not None:
            _close(got.tan.cpu(), want_t, 1e-13)
        else:
            assert got.tan is None


@pytest.mark.cuda
def test_cuda_gather_launchers_match_plain(cuda):
    """The launchers on the card: three calls of ``DualGatherVar`` at
    different states, another color set and values alone, and
    ``DualGatherCopy`` over 40 pieces (two launches) and a changed layout,
    each equal to the plain version; the tangent rows written once per set,
    two launches for the first call of a set and one after."""
    from porepy_tpu_torch.kernels import LAUNCHES

    rng = np.random.default_rng(24)
    ndof, batch = 4000, 11
    idx = torch.tensor(rng.permutation(ndof)[:1500])
    colors = torch.tensor(rng.integers(0, batch, ndof).astype(np.int32))
    gather = ops.DualGatherVar(idx.to(cuda))
    # A color set is one tensor: each is moved to the card once.
    sets = [(colors, colors.to(cuda), batch)] * 3 + [(None, None, 0)]
    sets.append((colors.flip(0), colors.flip(0).to(cuda), batch))
    for k, (c, c_card, b) in enumerate(sets):
        x = _t(rng.standard_normal(ndof))
        before = LAUNCHES["dual_gather"]
        val, tan = gather(x.to(cuda), c_card, b)
        want_v, want_t = reference.dual_gather_var(x, idx, c, b)
        torch.cuda.synchronize()
        assert torch.equal(val.cpu(), want_v) and (tan is None if not b else torch.equal(tan.cpu(), want_t))
        assert LAUNCHES["dual_gather"] - before == (2 if k in (0, 4) else 1)
    assert gather.seed_writes == 2
    copy = ops.DualGatherCopy()
    for lengths in ((300, 1, 0, 77, 512, 9, 33, 1000, 5, 64) * 4, (0, 17, 1, 300)):
        pieces = [
            (_t(rng.standard_normal(k)), None if k % 3 == 0 else _t(rng.standard_normal((batch, k))))
            for k in lengths
        ]
        card = [(v.to(cuda), None if t is None else t.to(cuda)) for v, t in pieces]
        before = LAUNCHES["dual_gather"]
        val, tan = copy(card, batch)
        want_v, want_t = reference.dual_gather_copy(pieces, batch)
        torch.cuda.synchronize()
        assert torch.equal(val.cpu(), want_v) and torch.equal(tan.cpu(), want_t)
        assert LAUNCHES["dual_gather"] - before == -(-len(lengths) // 32)
