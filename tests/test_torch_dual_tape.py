"""The lowering of a ``dual_ew`` program (K8) into the kernel's value code and
tangent tape, on the CPU.

A small numpy interpreter of the lowering (``_run_tape``: the value pass
leaving each instruction's partials, then the tape on slots, as
``csrc/dual_ad.cu`` runs them) is held against the plain version
``reference.dual_ew`` (1e-14 of the largest entry) and against ``jax.jvp`` of
the same jnp expression (1e-13), for every opcode under every pattern of
constant operands, for phase 22's program of ``chip_smoke.py`` and for
seeded random programs up to the limits (12 inputs, 36 instructions). The
slots stay within their limit, a program beyond the limits raises when it is
made, and the launcher on the CPU equals ``ops.dual_ew``. All inputs come
from numpy seeds; jax is imported inside the tests that use it.

The tests marked ``cuda`` hold the kernel against its plain version for each
opcode family at n in {1, 31, 16,969} and B in {0, 1, 16, 17}, with two
launches giving the same bits; they skip without a card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_dual_tape.py -m cuda
"""

import itertools

import numpy as np
import pytest
import torch

from porepy_tpu_torch.applications.benchmarking.dual_pivot_check import family_programs, phase22_program
from porepy_tpu_torch.kernels import ops, reference
from porepy_tpu_torch.numerics.ad import forward

torch.set_num_threads(1)

B, N = 3, 9
OPCODES = reference.DUAL_OPCODES
N_MAX = reference.DUAL_MAX_INPUTS

# The tape's entries, as ops numbers them.
_KINDS = ("load", "mul1", "div1", "mul2", "divb", "div2", "neg", "add", "sub", "sel")

_UNARY_NP = {
    "neg": np.negative, "exp": np.exp, "log": np.log, "sin": np.sin, "cos": np.cos, "tan": np.tan,
    "arcsin": np.arcsin, "arccos": np.arccos, "arctan": np.arctan, "sinh": np.sinh,
    "cosh": np.cosh, "tanh": np.tanh, "arcsinh": np.arcsinh, "arccosh": np.arccosh,
    "arctanh": np.arctanh, "abs": np.abs, "sign": np.sign, "sqrt": np.sqrt,
}
# The derivative factor of a unary opcode at x with result r, as the kernel
# computes it once an element.
_FACTOR_NP = {
    "exp": lambda x, r: r, "log": lambda x, r: x, "sin": lambda x, r: np.cos(x),
    "cos": lambda x, r: -np.sin(x), "tan": lambda x, r: 1.0 + r * r,
    "arcsin": lambda x, r: np.sqrt(1.0 - x * x), "arccos": lambda x, r: -np.sqrt(1.0 - x * x),
    "arctan": lambda x, r: 1.0 + x * x, "sinh": lambda x, r: np.cosh(x),
    "cosh": lambda x, r: np.sinh(x), "tanh": lambda x, r: 1.0 - r * r,
    "arcsinh": lambda x, r: np.sqrt(x * x + 1.0), "arccosh": lambda x, r: np.sqrt(x * x - 1.0),
    "arctanh": lambda x, r: 1.0 - x * x, "abs": lambda x, r: np.sign(x),
    "sqrt": lambda x, r: 2.0 * r,
}
_DOMAIN = {
    "log": (0.5, 2.0), "arcsin": (-0.9, 0.9), "arccos": (-0.9, 0.9), "arccosh": (1.5, 3.0),
    "arctanh": (-0.9, 0.9), "sqrt": (0.5, 2.0), "pow": (0.5, 2.0), "div": (0.5, 2.0),
}


def _run_tape(program, pattern, vals, tans, batch):
    """``(value, tangent rows)`` of ``program`` by its lowering for
    ``pattern``, in numpy: ``vals`` 1-d arrays of one length ``n`` (or 1),
    ``tans`` ``(batch, n)`` arrays or None."""
    tape = program.tape(pattern)
    n_in = program.n_inputs
    n = max(v.shape[0] for v in vals)
    V = [np.broadcast_to(v, (n,)).astype(float) for v in vals]
    P = [None] * tape.n_part
    with np.errstate(all="ignore"):
        for op, a, b, c, p0, p1 in tape.values:
            name = OPCODES[op]
            if name == "loadi":
                V.append(np.full(n, program.imm[a]))
                continue
            x, y = V[a], V[b]
            if name in _UNARY_NP:
                r = _UNARY_NP[name](x)
                if p0 >= 0:
                    P[p0] = _FACTOR_NP[name](x, r)
            elif name in ("add", "sub"):
                r = x + y if name == "add" else x - y
            elif name == "mul":
                r = x * y
                if p0 >= 0:
                    P[p0] = y
                if p1 >= 0:
                    P[p1] = x
            elif name == "div":
                r = x / y
                if p0 >= 0:
                    P[p0] = y
                if p1 >= 0:
                    P[p1] = r
            elif name == "pow":
                r = np.power(x, y)
                if p0 >= 0:
                    P[p0] = np.where(y == 0.0, 0.0, y * np.power(x, y - 1.0))
                if p1 >= 0:
                    P[p1] = np.where((x == 0.0) & (y >= 0.0), 0.0, r * np.log(x))
            elif name in ("gt", "ge", "leabs"):
                m = x > y if name == "gt" else x >= y if name == "ge" else np.abs(x) <= y
                r = m.astype(float)
            elif name == "select":
                r = np.where(x != 0.0, y, V[c])
                if p0 >= 0:
                    P[p0] = (x != 0.0).astype(float)
            elif name == "detach":
                r = x
            elif name == "custom":
                r = x
                if p0 >= 0:
                    P[p0] = y
            else:
                raise AssertionError(name)
            V.append(r)
        value = V[n_in + len(program.instrs) - 1]
        if tape.out_const or not batch:
            return value, None
        S = [None] * tape.n_slot
        for kind, dst, x, y, p0, p1 in tape.tape:
            kind = _KINDS[kind]
            if kind == "load":
                S[dst] = np.broadcast_to(tans[x], (batch, n))
                continue
            X = S[x] if x >= 0 else 0.0
            Y = S[y] if y >= 0 else 0.0
            P0 = P[p0] if p0 >= 0 else None
            P1 = P[p1] if p1 >= 0 else None
            S[dst] = {
                "mul1": lambda: X * P0,
                "div1": lambda: X / P0,
                "mul2": lambda: X * P0 + Y * P1,
                "divb": lambda: -(Y * P1) / P0,
                "div2": lambda: (X - Y * P1) / P0,
                "neg": lambda: -X,
                "add": lambda: X + Y,
                "sub": lambda: X - Y,
                "sel": lambda: np.where(P0 != 0.0, X, Y),
            }[kind]()
        return value, np.broadcast_to(S[tape.out_slot], (batch, n))


def _jnp_fn(program, pattern, const_vals):
    """The jnp function of ``program`` on its non-constant inputs (in input
    order), the constant ones closed over; the unary opcodes are the
    functions of porepy_tpu's ad library (``numerics/ad/functions.py``)."""
    import jax
    import jax.numpy as jnp

    import porepy_tpu as pp_jax
    from porepy_tpu.numerics.ad import functions as pf

    probe = pp_jax.ad.DenseArray(np.zeros(1))
    unary = {name: getattr(pf, name)(probe).func for name in _UNARY_NP if name not in ("neg", "sqrt")}
    unary.update(neg=jnp.negative, sqrt=jnp.sqrt)
    sg = jax.lax.stop_gradient

    def fn(*live):
        it = iter(live)
        regs = [const_vals[k] if pattern[k] else next(it) for k in range(program.n_inputs)]
        regs += [None] * (N_MAX - program.n_inputs)
        for op, a, b, c in program.instrs:
            name = OPCODES[op]
            if name == "loadi":
                regs.append(jnp.asarray(program.imm[a]))
            elif name in unary:
                regs.append(unary[name](regs[a]))
            elif name in ("add", "sub", "mul", "div", "pow"):
                f = {"add": jnp.add, "sub": jnp.subtract, "mul": jnp.multiply,
                     "div": jnp.divide, "pow": jnp.power}[name]
                regs.append(f(regs[a], regs[b]))
            elif name == "gt":
                regs.append((regs[a] > regs[b]).astype(jnp.float64))
            elif name == "ge":
                regs.append((regs[a] >= regs[b]).astype(jnp.float64))
            elif name == "leabs":
                regs.append((jnp.abs(regs[a]) <= regs[b]).astype(jnp.float64))
            elif name == "select":
                regs.append(jnp.where(regs[a] != 0.0, regs[b], regs[c]))
            elif name == "detach":
                regs.append(sg(regs[a]))
            elif name == "custom":
                # The value of a, the tangent b * dc.
                regs.append(sg(regs[a]) + sg(regs[b]) * (regs[c] - sg(regs[c])))
            else:
                raise AssertionError(name)
        return jnp.broadcast_to(regs[-1], jnp.broadcast_shapes(*(jnp.shape(r) for r in regs[:program.n_inputs])))

    return fn


def _jax_jvp(program, pattern, vals, tans, batch):
    import jax
    import jax.numpy as jnp

    import porepy_tpu  # noqa: F401  (enables float64 before any array is made)

    const_vals = [jnp.asarray(v) for v in vals]
    fn = _jnp_fn(program, pattern, const_vals)
    live = [k for k in range(program.n_inputs) if not pattern[k]]
    primals = tuple(const_vals[k] for k in live)
    value = fn(*primals)
    if not live:
        return np.asarray(value), None
    rows = [
        jax.jvp(fn, primals, tuple(jnp.asarray(np.broadcast_to(tans[k][r], vals[k].shape)) for k in live))[1]
        for r in range(batch)
    ]
    return np.asarray(value), np.stack([np.asarray(t) for t in rows])


def _close(got, want, tol):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.size == 0:
        return
    assert np.array_equal(np.isnan(got), np.isnan(want)), "NaN pattern differs"
    got, want = np.nan_to_num(got, nan=0.0), np.nan_to_num(want, nan=0.0)
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) <= tol * scale


def _inputs(program, seed, n=N, batch=B, domain=(-1.5, 1.5), masks=()):
    rng = np.random.default_rng(seed)
    vals = [rng.uniform(*domain, n) for _ in range(program.n_inputs)]
    for k in masks:
        vals[k] = (rng.random(n) < 0.5).astype(float)
    tans = [rng.standard_normal((batch, n)) for _ in range(program.n_inputs)]
    return vals, tans


def _check(program, pattern, vals, tans, batch=B, jax_tol=1e-13):
    """The interpreter against the plain version (1e-14) and jax.jvp."""
    got_v, got_t = _run_tape(program, pattern, vals, [None if c else t for c, t in zip(pattern, tans)], batch)
    inputs = [(torch.tensor(v), None if c else torch.tensor(t)) for v, t, c in zip(vals, tans, pattern)]
    want_v, want_t = reference.dual_ew(program.instrs, program.imm, inputs, batch)
    _close(got_v, want_v.numpy(), 1e-14)
    assert (got_t is None) == (want_t is None) == program.out_const(tuple(pattern)) or not batch
    if want_t is not None:
        _close(got_t, want_t.numpy(), 1e-14)
    if jax_tol is not None:
        jv, jt = _jax_jvp(program, pattern, vals, tans, batch)
        _close(got_v, jv, jax_tol)
        if got_t is not None:
            _close(got_t, jt, jax_tol)
        elif jt is not None:
            assert not np.any(jt), "a constant output with a non-zero jax tangent"


def _single(name, arity):
    E = forward.ExprOps
    ins = [forward._Expr("in", (), k) for k in range(arity)]
    return forward.compile_expr(E.op(name, *ins))[0]


_ARITY = {name: 1 for name in _UNARY_NP} | {
    "add": 2, "sub": 2, "mul": 2, "div": 2, "pow": 2, "gt": 2, "ge": 2, "leabs": 2,
    "select": 3, "custom": 3, "detach": 1,
}
_CASES = [
    (name, pattern)
    for name, arity in sorted(_ARITY.items())
    for pattern in itertools.product((False, True), repeat=arity)
]


@pytest.mark.parametrize("name,pattern", _CASES, ids=[f"{n}-{''.join('c' if c else 'd' for c in p)}" for n, p in _CASES])
def test_each_opcode_tape_matches_plain_and_jax(name, pattern):
    program = _single(name, _ARITY[name])
    lo, hi = _DOMAIN.get(name, (-1.5, 1.5))
    vals, tans = _inputs(program, _CASES.index((name, pattern)), domain=(lo, hi),
                         masks=(0,) if name == "select" else ())
    if name == "leabs":
        vals[1] = np.abs(vals[1])
    _check(program, pattern, vals, tans)


def test_pow_at_zero_base_and_zero_exponent():
    """The two derivative factors' guards: a constant exponent 0 gives a
    zero factor, a zero base with a non-negative exponent no log."""
    program = _single("pow", 2)
    vals = [np.array([0.0, 0.0, 1.5, 2.0, 0.0]), np.array([2.0, 0.0, 0.0, 3.0, 1.0])]
    tans = [np.ones((B, 5)), np.full((B, 5), 0.5)]
    for pattern in ((False, True), (False, False), (True, False)):
        _check(program, pattern, vals, tans, jax_tol=None)


@pytest.mark.parametrize("pattern", list(itertools.product((False, True), repeat=5)))
def test_phase22_program_every_pattern(pattern):
    program, order = phase22_program()
    vals, tans = _inputs(program, 22, domain=(0.5, 1.5))
    _check(program, pattern, vals, tans)
    # Without seeds: the value alone.
    got_v, got_t = _run_tape(program, pattern, vals, tans, 0)
    assert got_t is None


_RANDOM_OPS = ("add", "sub", "mul", "div", "neg", "exp", "sin", "cos", "tanh", "arctan", "abs",
               "sqrt", "log", "pow", "select", "gt", "custom", "loadi", "arcsinh")


def _random_program(rng, n_in, n_instr):
    """A seeded random program whose every value stays in the opcodes'
    domains: positive inputs, and sqrt, log and pow of abs + 1."""
    E = forward.ExprOps
    ins = [forward._Expr("in", (), k) for k in range(n_in)]
    pool = list(ins)
    count = 0

    def pick():
        return pool[int(rng.integers(len(pool)))]

    def positive(e):
        nonlocal count
        count += 3
        return E.op("add", E.op("abs", e), E.imm(1.0))

    while count < n_instr - 4:
        name = _RANDOM_OPS[int(rng.integers(len(_RANDOM_OPS)))]
        if name == "loadi":
            e, count = E.imm(float(rng.uniform(0.5, 2.0))), count + 1
        elif name in ("sqrt", "log"):
            e = E.op(name, positive(pick()))
            count += 1
        elif name == "pow":
            e = E.op("pow", positive(pick()), E.op("tanh", pick()))
            count += 2
        elif name == "div":
            e = E.op("div", pick(), positive(pick()))
            count += 1
        elif name == "select":
            e = E.op("select", E.op("gt", pick(), pick()), pick(), pick())
            count += 2
        elif name == "custom":
            e = E.op("custom", pick(), pick(), pick())
            count += 1
        elif name in ("add", "sub", "mul", "gt"):
            e = E.op(name, pick(), pick())
            count += 1
        else:
            e = E.op(name, pick())
            count += 1
        pool.append(e)
    # A root that reads the last few values, so that most of the program is live.
    root = pool[-1]
    for e in pool[-4:-1]:
        root = E.op("add", root, e)
    return forward.compile_expr(root)


@pytest.mark.parametrize("seed", range(12))
def test_random_programs_within_slot_limit(seed):
    rng = np.random.default_rng(100 + seed)
    n_in = int(rng.integers(1, N_MAX + 1))
    program, _order = _random_program(rng, n_in, reference.DUAL_MAX_INSTRS)
    assert len(program.instrs) <= reference.DUAL_MAX_INSTRS
    vals, tans = _inputs(program, seed, domain=(0.2, 1.2))
    patterns = [tuple(rng.random(program.n_inputs) < p) for p in (0.0, 0.3, 0.7)]
    for pattern in patterns:
        tape = program.tape(pattern)
        # At most one slot a value that can be alive: an input or a result.
        assert tape.n_slot <= program.n_inputs + len(program.instrs)
        assert tape.n_part <= 2 * len(program.instrs)
        _check(program, pattern, vals, tans, jax_tol=1e-12 if seed % 4 else 1e-13)


def test_slot_count_is_the_most_alive():
    """A chain reuses one slot; a balanced product of 8 inputs holds its 8
    loaded rows, the products reusing their slots."""
    E = forward.ExprOps
    x = forward._Expr("in", (), 0)
    e = x
    for _ in range(10):
        e = E.op("exp", E.op("sin", e))
    chain = forward.compile_expr(e)[0]
    assert chain.tape((False,)).n_slot == 1
    ins = [forward._Expr("in", (), k) for k in range(8)]
    level = ins
    while len(level) > 1:
        level = [E.op("mul", level[i], level[i + 1]) for i in range(0, len(level), 2)]
    tree = forward.compile_expr(level[0])[0]
    tape = tree.tape((False,) * 8)
    # Every input's row is loaded first (the kernel issues the loads before
    # the value pass), so all 8 are alive at the start.
    assert tape.n_slot == 8 and tape.n_load == 8
    assert sum(1 for entry in tape.tape if entry[0] == 0) == 8


def test_program_beyond_the_limits_raises_when_made():
    E = forward.ExprOps
    x = forward._Expr("in", (), 0)
    e = x
    for _ in range(reference.DUAL_MAX_INSTRS + 1):
        e = E.op("neg", e)
    with pytest.raises(ValueError, match="instructions outside"):
        forward.compile_expr(e)
    ins = [forward._Expr("in", (), k) for k in range(N_MAX + 1)]
    e = ins[0]
    for x in ins[1:]:
        e = E.op("add", e, x)
    with pytest.raises(ValueError, match="inputs outside"):
        forward.compile_expr(e)


def test_constant_copies_take_no_tape_entry():
    """``x + c`` and ``x - c`` reuse x's tangent: one load, nothing else;
    ``c - x`` negates it."""
    E = forward.ExprOps
    x, c = forward._Expr("in", (), 0), forward._Expr("in", (), 1)
    for name, kinds in (("add", ["load"]), ("sub", ["load"])):
        program = forward.compile_expr(E.op(name, x, c))[0]
        assert [_KINDS[t[0]] for t in program.tape((False, True)).tape] == kinds
    program = forward.compile_expr(E.op("sub", c, x))[0]
    assert [_KINDS[t[0]] for t in program.tape((True, False)).tape] == ["load", "neg"]
    # A tangent no output needs (a mask's operand) is not computed.
    program = forward.compile_expr(E.op("gt", E.op("exp", x), c))[0]
    tape = program.tape((False, False))
    assert tape.out_const and tape.tape == () and tape.n_part == 0


def test_kernel_code_decodes_to_the_tape():
    """The words the kernel reads: six a value record, then two a tape
    entry, packed as ``csrc/dual_ad.cu`` unpacks them; the loads first."""
    program, _order = phase22_program()
    tape = program.tape((False, False, True, True, False))
    assert tape.n_load == 3 and all(entry[0] == 0 for entry in tape.tape[: tape.n_load])
    assert all(entry[0] != 0 for entry in tape.tape[tape.n_load :])
    words = tape.code()
    assert len(words) == 6 * len(tape.values) + 2 * len(tape.tape)
    for j, rec in enumerate(tape.values):
        assert tuple(words[6 * j : 6 * j + 6]) == rec
    for q, entry in enumerate(tape.tape):
        w0, w1 = words[6 * len(tape.values) + 2 * q : 6 * len(tape.values) + 2 * q + 2]
        got = (w0 & 15, (w0 >> 4) & 63, ((w0 >> 10) & 127) - 1, ((w0 >> 17) & 127) - 1,
               (w1 & 255) - 1, ((w1 >> 8) & 255) - 1)
        assert got == entry


@pytest.mark.parametrize("batch", [0, 1, B])
def test_launcher_on_the_cpu_equals_dual_ew(batch):
    program, _order = phase22_program()
    vals, tans = _inputs(program, 3, batch=max(batch, 1), domain=(0.5, 1.5))
    inputs = [(torch.tensor(v), None if k == 2 else torch.tensor(t)) for k, (v, t) in enumerate(zip(vals, tans))]
    launch = ops.DualEwLauncher(program)
    got = launch(inputs, batch)
    want = ops.dual_ew(program, inputs, batch)
    assert torch.equal(got[0], want[0])
    assert (got[1] is None) == (want[1] is None)
    if got[1] is not None:
        assert torch.equal(got[1], want[1])
    assert program.launcher() is program.launcher()


# -- on the card ----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["unary_a", "unary_b", "unary_c", "unary_d", "binary", "masks", "custom"])
@pytest.mark.parametrize("n", [1, 31, 16969])
@pytest.mark.parametrize("batch", [0, 1, 16, 17])
def test_cuda_dual_ew_matches_plain_by_family(cuda, family, n, batch):
    program, _order = family_programs()[family]
    rng = np.random.default_rng(n + 100 * batch)
    launch = ops.DualEwLauncher(program)
    for pattern in ((False,) * program.n_inputs, (False, True) * 2, (True, False, False, True)):
        pattern = pattern[: program.n_inputs]
        vals = [torch.tensor(rng.uniform(-1.0, 1.0, n), device=cuda) for _ in range(program.n_inputs)]
        inputs = [
            (v, None if c else torch.tensor(rng.standard_normal((batch, n)), device=cuda))
            for v, c in zip(vals, pattern)
        ]
        got = launch(inputs, batch)
        again = launch(inputs, batch)
        torch.cuda.synchronize()
        want = reference.dual_ew(program.instrs, program.imm, inputs, batch)
        for g, a, w in zip(got, again, want):
            assert (g is None) == (w is None)
            if g is None:
                continue
            # Two launches: the same bits (NaN where the other has NaN).
            assert torch.equal(torch.isnan(g), torch.isnan(a))
            assert torch.equal(g.nan_to_num(0.0), a.nan_to_num(0.0))
            assert g.shape == w.shape
            nan = torch.isnan(w)
            assert torch.equal(torch.isnan(g), nan)
            scale = max(float(w.masked_fill(nan, 0.0).abs().max()) if w.numel() else 0.0, 1.0)
            assert float((g - w).masked_fill(nan, 0.0).abs().max()) <= 1e-13 * scale
