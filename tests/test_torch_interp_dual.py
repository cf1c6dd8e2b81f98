"""K16's dual call (``reference.interp_dual``, behind
``kernels.InterpLauncher``) against porepy_tpu's ``lookup`` and ``jax.jvp``
and against the plain pair ``reference.interp_lookup`` / ``interp_tangent``,
for 1d, 2d and 3d tables with points outside the table and a constant
argument; the kernel's corner-block table (``reference.corner_table``)
against the flat table; on a card, the kernel against the plain versions to
the bit.

The JAX package is imported inside the tests that need it, so the
``cuda``-marked tests run on a card without jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_interp_dual.py -m cuda
"""

import numpy as np
import pytest
import torch

import porepy_tpu_torch as pt_torch
from porepy_tpu_torch import kernels
from porepy_tpu_torch.kernels import reference

torch.set_num_threads(1)

TABLES = {
    1: (lambda x: np.exp(x), [0.0], [1.0], [101]),
    2: (lambda p, T: np.sin(3 * p) * np.cos(T) + p * T, [1.0, 280.0], [5.0, 400.0], [41, 61]),
    3: (lambda a, b, c: a * b - np.cos(c) + a**2 * c, [0.0, -1.0, 0.5], [1.0, 1.0, 2.0], [9, 11, 7]),
    4: (lambda a, b, c, e: a * b + c * e, [0.0] * 4, [1.0] * 4, [3, 4, 5, 3]),
}
B = 4


def _cases(dims):
    """``(d, constant)`` pairs: every argument seeded, and argument 0
    constant where another argument carries the tangents."""
    return [pytest.param(d, c, id=f"{d}d-{'constant-arg' if c == 0 else 'seeded'}")
            for d in dims for c in (None, 0) if not (d == 1 and c == 0)]


def _inputs(d, n=300, seed=0):
    """The table's tensors, points over the table and 20% beyond each side
    of every axis ``(d, N)``, and seeds ``(B, d, N)``."""
    f, lo, hi, npt = TABLES[d]
    fun = pt_torch.ad.InterpolatedFunction(f, "tab", lo, hi, npt)
    rng = np.random.default_rng(seed + d)
    lo, hi = np.array(lo), np.array(hi)
    span = hi - lo
    x = rng.uniform(lo - 0.2 * span, hi + 0.2 * span, (n, d)).T.copy()
    outside = np.any((x < lo[:, None]) | (x > hi[:, None]), axis=0)
    assert 0 < outside.sum() < n
    seeds = rng.standard_normal((B, d, n))
    return fun, fun.device_table("cpu"), torch.tensor(x), torch.tensor(seeds)


def _tans(dx, constant=None):
    """Per-coordinate ``(B, N)`` tangents, ``None`` for ``constant``."""
    return [None if k == constant else dx[:, k] for k in range(dx.shape[1])]


def _dual(c, x, tans):
    return reference.interp_dual(c["values"], c["fgeom"], c["igeom"], list(x), tans)


@pytest.mark.parametrize("d", [1, 2, 3, 4], ids=["1d", "2d", "3d", "4d"])
def test_corner_table_holds_each_cells_corners(d):
    """Row ``cell`` of the corner table holds the ``2^d`` corner values of
    that cell (first axis fastest) in ``itertools.product`` order, ``2^d``
    times the flat table's entries less the last point of each axis."""
    _f, _lo, _hi, npt = TABLES[d]
    _fun, c, _x, _dx = _inputs(d)
    corners, cgeom = reference.corner_table(c["values"], c["igeom"])
    cells = np.prod(np.array(npt) - 1)
    assert corners.shape == (cells, 2**d) and corners.is_contiguous()
    assert cgeom.dtype == torch.int32 and cgeom[:d].tolist() == list(npt)
    strides = c["igeom"][d:].tolist()
    rng = np.random.default_rng(d)
    for cell in rng.integers(0, cells, 20):
        base, rest = [], int(cell)
        for k in range(d):
            base.append(rest % (npt[k] - 1))
            rest //= npt[k] - 1
        assert int(sum(b * s for b, s in zip(base, cgeom[d:].tolist()))) == cell
        for corner in range(2**d):
            bits = [(corner >> (d - 1 - k)) & 1 for k in range(d)]
            flat = sum((b + e) * s for b, e, s in zip(base, bits, strides))
            assert reference.same_bits(corners[cell, corner], c["values"][flat])


@pytest.mark.parametrize("d", [1, 2, 3, 4], ids=["1d", "2d", "3d", "4d"])
def test_corner_block_holds_what_the_flat_lookup_reads(d):
    """A point's corner block, found as the kernel finds it (the clamped
    cell and the cell strides of ``cgeom``), holds bit for bit the corner
    values that the flat lookup gathers, in its order, points outside the
    table included: the lookup through the corner table is the flat
    lookup."""
    _fun, c, x, _dx = _inputs(d)
    corners, cgeom = reference.corner_table(c["values"], c["igeom"])
    low, h = c["fgeom"][:d], c["fgeom"][d:]
    npt, cstride = cgeom[:d].long(), cgeom[d:].long()
    base = torch.floor((x - low[:, None]) / h[:, None]).long()
    base = torch.minimum(torch.clamp(base, min=0), (npt - 2)[:, None])
    block = corners[sum(base[k] * cstride[k] for k in range(d))]
    _frac, flat = reference._interp_corners(c["values"], c["fgeom"], c["igeom"], x)
    for corner, (_bits, v) in enumerate(flat):
        assert reference.same_bits(block[:, corner], v)


@pytest.mark.parametrize("d,constant", _cases([1, 2, 3, 4]))
def test_dual_rows_equal_the_old_plain_pair(d, constant):
    """Row 0 equals ``interp_lookup`` and rows ``1 ..`` ``interp_tangent``
    with the constant argument's seeds zero, to the bit."""
    _fun, c, x, dx = _inputs(d)
    args = (c["values"], c["fgeom"], c["igeom"], x)
    seeds = dx.clone()
    if constant is not None:
        seeds[:, constant] = 0.0
    out = _dual(c, x, _tans(dx, constant))
    assert out.shape == (1 + B, x.shape[1])
    assert reference.same_bits(out[0], reference.interp_lookup(*args))
    assert reference.same_bits(out[1:], reference.interp_tangent(*args, seeds))
    value_only = _dual(c, x, None)
    assert value_only.shape == (1, x.shape[1]) and reference.same_bits(value_only[0], out[0])


@pytest.mark.parametrize("d,constant", _cases([1, 2, 3]))
def test_dual_matches_jax_lookup_and_jvp(d, constant):
    """The dual rows against ``porepy_tpu``'s lookup and ``jax.jvp`` of it
    (the constant argument's tangent zero): 1e-13 of the magnitude of the
    summed terms per point (the two sum the corner terms in another
    order)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import porepy_tpu as pt_jax

    f, lo, hi, npt = TABLES[d]
    fun_j = pt_jax.ad.InterpolatedFunction(f, "tab", lo, hi, npt)
    _fun, c, x, dx = _inputs(d)
    out = _dual(c, x, _tans(dx, constant))
    # The scale of each row's rounding: the sum of its terms' magnitudes.
    frac, corners = reference._interp_corners(c["values"], c["fgeom"], c["igeom"], x)
    h = c["fgeom"][d:]
    val_scale = torch.zeros(x.shape[1], dtype=torch.float64)
    tan_scale = torch.zeros(B, x.shape[1], dtype=torch.float64)
    for bits, v in corners:
        w = [(frac[k] if bits[k] else 1 - frac[k]).abs() for k in range(d)]
        val_scale += torch.prod(torch.stack(w), 0) * v.abs()
        for k in range(d):
            term = dx[:, k].abs() / h[k]
            for m in range(d):
                if m != k:
                    term = term * w[m]
            tan_scale += term * v.abs()
    xj = tuple(jnp.asarray(x.numpy()))
    want = np.asarray(fun_j.func(*xj))
    assert np.all(np.abs(out[0].numpy() - want) <= 1e-13 * val_scale.numpy())
    for b in range(B):
        seed = dx[b].numpy().copy()
        if constant is not None:
            seed[constant] = 0.0
        _, want_t = jax.jvp(lambda *a: fun_j.func(*a), xj, tuple(jnp.asarray(seed)))
        assert np.all(np.abs(out[1 + b].numpy() - np.asarray(want_t)) <= 1e-13 * tan_scale[b].numpy())


def test_launcher_on_the_cpu_runs_the_plain_version():
    """``InterpLauncher`` on CPU tensors: the dual call is
    ``reference.interp_dual``'s rows, ``rows`` the value ``(N,)`` or the
    tangent rows ``(B, N)``; nothing is launched."""
    _fun, c, x, dx = _inputs(2)
    launcher = c["launcher"]
    assert launcher is kernels.interp_launcher(c["values"], c["fgeom"], c["igeom"])
    before = dict(kernels.LAUNCHES)
    tans = _tans(dx, 1)
    want = _dual(c, x, tans)
    assert reference.same_bits(launcher(list(x), tans), want)
    assert reference.same_bits(launcher.rows(list(x)), want[0])
    assert reference.same_bits(launcher.rows(list(x), tans), want[1:])
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="at least one tangent"):
        launcher.rows(list(x), [None, None])


def test_launcher_refuses_the_cpu_for_the_kernel():
    """The launch itself takes CUDA tensors only: on CPU tensors it raises
    rather than running anything."""
    _fun, c, x, dx = _inputs(2)
    launcher = kernels.InterpLauncher(c["values"], c["fgeom"], c["igeom"])
    with pytest.raises(ValueError, match="CUDA tensors"):
        launcher._launch(list(x), None, True)
    with pytest.raises(TypeError, match="float64"):
        kernels.InterpLauncher(c["values"].float(), c["fgeom"], c["igeom"])


def test_dual_rule_is_one_call_with_stacked_rows():
    """The function's dual rule returns value and tangents as rows of one
    buffer (``Dual.stacked``), from one call of the launcher."""
    from porepy_tpu_torch.numerics.ad import forward

    fun, c, x, dx = _inputs(2)
    calls = []
    launcher = c["launcher"]
    original = type(launcher).__call__

    def spy(self, xs, tans=None):
        calls.append(tans is not None)
        return original(self, xs, tans)

    duals = [forward.Dual(x[0].clone(), dx[:, 0].contiguous()), forward.Dual(x[1].clone())]
    type(launcher).__call__ = spy
    try:
        out = fun.func.dual_rule(None, *duals)
    finally:
        type(launcher).__call__ = original
    assert calls == [True]
    assert out.stacked() is not None
    want = _dual(c, x, [dx[:, 0], None])
    assert reference.same_bits(out.val, want[0]) and reference.same_bits(out.tan, want[1:])


def _transposed_tangent_rule(fun, x, dx):
    """The dual rule's value and tangents where argument 0's tangent has
    rows of stride ``B`` (``(mat @ tan.T).T``, as a CSR projection gives
    it), and the plain rows of the same seeds."""
    from porepy_tpu_torch.numerics.ad import forward

    tan = dx[:, 0].T.contiguous().T
    assert tan.stride(1) != 1
    out = fun.func.dual_rule(None, forward.Dual(x[0].clone(), tan), forward.Dual(x[1].clone(), dx[:, 1].contiguous()))
    c = fun.device_table(x.device)
    return out, _dual(c, x, [dx[:, 0], dx[:, 1]])


def test_dual_rule_takes_a_transposed_tangent():
    """A tangent whose rows are not unit-stride gives the plain rows of
    its values, to the bit."""
    fun, _c, x, dx = _inputs(2)
    out, want = _transposed_tangent_rule(fun, x, dx)
    assert reference.same_bits(out.val, want[0]) and reference.same_bits(out.tan, want[1:])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d,constant", _cases([1, 2, 3]))
def test_cuda_interp_dual_equals_plain(cuda, d, constant):
    """K16: the value, the tangent rows and the dual call, each one launch,
    the plain versions' bits on the same inputs."""
    fun, _c, x, dx = _inputs(d, n=5000)
    c = fun.device_table(cuda)
    x, dx = x.to(cuda), dx.to(cuda)
    tans = _tans(dx, constant)
    launcher = c["launcher"]
    want = _dual(c, x, tans)
    before = kernels.LAUNCHES["interp_lookup"]
    got = [launcher(list(x), tans), launcher.rows(list(x)), launcher.rows(list(x), tans)]
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["interp_lookup"] == before + 3
    assert reference.same_bits(got[0], want)
    assert reference.same_bits(got[1], want[0])
    assert reference.same_bits(got[2], want[1:])
    args = (c["values"], c["fgeom"], c["igeom"], x)
    assert reference.same_bits(kernels.interp_lookup(*args), want[0])


@pytest.mark.cuda
def test_cuda_dual_rule_takes_a_transposed_tangent(cuda):
    """On the card the dual rule copies a tangent of non-unit-stride rows
    and launches once: the plain rows' bits."""
    fun, _c, x, dx = _inputs(2, n=5000)
    x, dx = x.to(cuda), dx.to(cuda)
    before = kernels.LAUNCHES["interp_lookup"]
    out, want = _transposed_tangent_rule(fun, x, dx)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["interp_lookup"] == before + 1
    assert reference.same_bits(out.val, want[0]) and reference.same_bits(out.tan, want[1:])
