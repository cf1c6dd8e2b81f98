"""K13's one-launch kernel (``csrc/tpfa_flow.cu``: each cell walks its own
faces) through :class:`porepy_tpu_torch.kernels.TpfaLauncher` and the
unstructured Newton step, on the CPU where the launcher runs the plain
versions, against ``porepy_tpu``'s ``TpfaFlowKernel``.

Two grids of 5 x 4 x 3 cells: the all-Dirichlet box of
``build_cart_flow_kernel``, and the same box with its x-min and x-max
faces Neumann, their prescribed fluxes of both signs. States are made from
numpy seeds about 2e5 Pa, so that both upwind directions occur. Against
``porepy_tpu``: 1e-13 relative to the largest entry in f64 (the same terms,
summed and exponentiated in another order), 1e-5 in f32, 1e-9 for a Newton
step's new state (its BiCGStab stops at its tolerance on both sides). The
plain versions against the parent's composition and a numpy loop in the
cell-to-face CSR's order: to the bit. The tests marked ``cuda`` hold every
launch to its plain version to the bit on a card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tpfa_step.py -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

from porepy_tpu_torch import kernels
from porepy_tpu_torch.kernels import reference

torch.set_num_threads(1)

FLUID = dict(compressibility=1e-6, viscosity=1e-3, rho_ref=1000.0, p_ref=1e5)
SHAPE = (5, 4, 3)
DTYPES = {"f64": (np.float64, torch.float64), "f32": (np.float32, torch.float32)}
# Against porepy_tpu, relative to the largest entry.
REL_TOL = {"f64": 1e-13, "f32": 1e-5}
# A Newton step's new state against porepy_tpu's, relative.
STEP_TOL = 1e-9


def _bc_faces(fc):
    return 1e5 + 1e4 * (1 - fc[0])


def _rel_err(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_kernel(grid: str, dtype: str = "f64"):
    """``porepy_tpu``'s kernel of the grid, its floats in ``dtype``."""
    import jax.numpy as jnp

    from porepy_tpu.grids.structured import CartGrid
    from porepy_tpu.parallel.flow_step import build_cart_flow_kernel

    kj, _ = build_cart_flow_kernel(list(SHAPE), physdims=[1, 1, 1], dt=1.0, bc_pressure=_bc_faces, **FLUID)
    if grid == "neumann":
        g = CartGrid(list(SHAPE), physdims=[1, 1, 1])
        g.compute_geometry()
        x = g.face_centers[0]
        ends = np.flatnonzero(np.isclose(x, 0.0) | np.isclose(x, 1.0))
        rng = np.random.default_rng(3)
        is_neu = np.asarray(kj.is_neu).copy()
        bc_val = np.asarray(kj.bc_val).copy()
        is_neu[ends] = True
        bc_val[ends] = rng.choice([-1.0, 1.0], ends.size) * rng.uniform(1e2, 1e4, ends.size)
        kj = dataclasses.replace(kj, is_neu=jnp.asarray(is_neu), bc_val=jnp.asarray(bc_val))
    if dtype == "f32":
        floats = ("t", "bc_val", "pv", "rho_ref", "comp", "visc", "p_ref", "dt")
        kj = dataclasses.replace(kj, **{f: jnp.asarray(getattr(kj, f), jnp.float32) for f in floats})
    return kj


@pytest.fixture(scope="module", params=["dirichlet", "neumann"])
def grid(request):
    return request.param


@pytest.fixture(scope="module")
def kernels_of():
    """``(porepy_tpu kernel, the port's kernel)`` by grid and dtype."""
    from porepy_tpu_torch.interop import tpfa_flow_kernel_from

    cache = {}

    def get(grid, dtype="f64"):
        if (grid, dtype) not in cache:
            kj = _jax_kernel(grid, dtype)
            cache[(grid, dtype)] = (kj, tpfa_flow_kernel_from(kj, "cpu"))
        return cache[(grid, dtype)]

    return get


def _states(n, np_dtype, seed=1):
    rng = np.random.default_rng(seed)
    p = 2e5 + 1e4 * rng.standard_normal(n)
    p_prev = 2e5 + 1e4 * rng.standard_normal(n)
    return p.astype(np_dtype), p_prev.astype(np_dtype), rng.standard_normal(n).astype(np_dtype)


def test_neumann_grid_has_both_signs_and_both_upwind_directions(kernels_of):
    kj, kt = kernels_of("neumann")
    neu = np.asarray(kj.is_neu)
    bc = np.asarray(kj.bc_val)[neu]
    assert neu.sum() == 2 * SHAPE[1] * SHAPE[2] and (bc > 0).any() and (bc < 0).any()
    p, _, _ = _states(kt.num_cells, np.float64)
    q = np.asarray(kt.face_flux(torch.tensor(p)))[~neu]
    assert (q > 0).any() and (q < 0).any()


# -- against porepy_tpu ------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_residual_matches_porepy_tpu(kernels_of, grid, dtype):
    import jax.numpy as jnp

    kj, kt = kernels_of(grid, dtype)
    np_dtype, t_dtype = DTYPES[dtype]
    p, p_prev, _ = _states(kj.num_cells, np_dtype)
    got = kt.residual(torch.tensor(p), torch.tensor(p_prev))
    assert got.dtype == t_dtype
    assert _rel_err(got.numpy(), kj.residual(jnp.asarray(p), jnp.asarray(p_prev))) <= REL_TOL[dtype]


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_jvp_matches_jax_linearize(kernels_of, grid, dtype):
    import jax
    import jax.numpy as jnp

    kj, kt = kernels_of(grid, dtype)
    np_dtype, _ = DTYPES[dtype]
    p, p_prev, v = _states(kj.num_cells, np_dtype, seed=2)
    _r, lin = jax.linearize(lambda q: kj.residual(q, jnp.asarray(p_prev)), jnp.asarray(p))
    got = kt.jvp(torch.tensor(p), torch.tensor(v))
    assert _rel_err(got.numpy(), lin(jnp.asarray(v))) <= REL_TOL[dtype]


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_linearized_matrix_times_v_matches_jax_linearize(kernels_of, grid, dtype):
    """The cell-cell matrix of the linearize mode, multiplied in its row
    order, against ``jax.linearize``'s tangent map."""
    import jax
    import jax.numpy as jnp

    kj, kt = kernels_of(grid, dtype)
    np_dtype, t_dtype = DTYPES[dtype]
    p, p_prev, v = _states(kj.num_cells, np_dtype, seed=3)
    cycle = kt._linearized(torch.tensor(p), t_dtype)
    row_ptr, cols, vals = cycle.op
    val, col = reference.csr_ell(row_ptr, cols, vals, kj.num_cells)
    got = reference.ell_spmv_ordered(val, col, torch.tensor(v))
    _r, lin = jax.linearize(lambda q: kj.residual(q, jnp.asarray(p_prev)), jnp.asarray(p))
    assert _rel_err(got.numpy(), lin(jnp.asarray(v))) <= REL_TOL[dtype]


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_step_operands_match_porepy_tpu(kernels_of, grid, dtype):
    """The step mode's residual, its values against the linearize mode's
    and its diagonal against ``porepy_tpu``'s ``_jacobi_diagonal``."""
    import jax.numpy as jnp

    kj, kt = kernels_of(grid, dtype)
    np_dtype, t_dtype = DTYPES[dtype]
    p, p_prev, _ = _states(kj.num_cells, np_dtype, seed=4)
    _args, launcher, cycle = kt._solver(t_dtype)
    vals, diag = torch.empty_like(cycle.op[-1]), torch.empty_like(cycle.diag)
    r = launcher.step(torch.tensor(p), torch.tensor(p_prev), vals, diag)
    assert _rel_err(r.numpy(), kj.residual(jnp.asarray(p), jnp.asarray(p_prev))) <= REL_TOL[dtype]
    assert _rel_err(diag.numpy(), kj._jacobi_diagonal(jnp.asarray(p), jnp.asarray(p_prev))) <= REL_TOL[dtype]
    lin = torch.empty_like(vals)
    launcher.linearize(torch.tensor(p), lin)
    assert torch.equal(vals, lin)


def test_newton_step_matches_jitted_newton_step(kernels_of, grid):
    """Two Newton steps from p = 2e5 (the first from a uniform state, where
    no face carries an interior flux) against ``jitted_newton_step``."""
    import jax.numpy as jnp

    from porepy_tpu.parallel.flow_step import jitted_newton_step

    kj, kt = kernels_of(grid)
    p0 = np.full(kj.num_cells, 2e5)
    pj, pt = jnp.asarray(p0), torch.tensor(p0)
    for _ in range(2):
        pj, rj = jitted_newton_step(kj, pj, jnp.asarray(p0))
        pt, rt = kt.newton_step(pt, torch.tensor(p0))
        assert abs(float(rt) - float(rj)) <= 1e-13 * float(rj)
        assert _rel_err(pt.numpy(), np.asarray(pj)) <= STEP_TOL


# -- the plain versions to the bit --------------------------------------------------


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_plain_step_is_the_parent_composition(kernels_of, grid, dtype):
    """``reference.tpfa_step`` and the CPU launcher's step: the parent
    route's three pieces (the residual, the linearization, the parent's
    torch diagonal, f64; ``_jacobi_diagonal`` too) to the bit."""
    _kj, kt = kernels_of(grid)
    np_dtype, t_dtype = DTYPES[dtype]
    args, launcher, cycle = kt._solver(t_dtype)
    arrays, slot, diag_slot = args[:9], args[9], args[10]
    nnz = cycle.op[-1].shape[0]
    p, p_prev, _ = (torch.tensor(a) for a in _states(kt.num_cells, np_dtype, seed=5))
    r, vals, diag = reference.tpfa_step(p, p_prev, *arrays, launcher.t_sum, slot, diag_slot, nnz)
    assert torch.equal(r, reference.tpfa_residual(p, p_prev, *arrays))
    assert torch.equal(r, kernels.tpfa_residual(p, p_prev, *arrays))
    assert torch.equal(vals, reference.tpfa_linearize(p, *arrays, slot, diag_slot, nnz))
    from porepy_tpu_torch.applications.benchmarking import tpfa_step_check as tsc

    want_diag = tsc.parent_diagonal(kt, p) if dtype == "f64" else reference.tpfa_jacobi_diagonal(
        p, launcher.t_sum, arrays[5], arrays[8])
    assert torch.equal(diag, want_diag)
    if dtype == "f64":
        assert torch.equal(kt._jacobi_diagonal(p), want_diag)
    l_vals, l_diag = torch.empty_like(vals), torch.empty_like(diag)
    assert torch.equal(launcher.step(p, p_prev, l_vals, l_diag), r)
    assert torch.equal(l_vals, vals) and torch.equal(l_diag, diag)


def _csr_loop(kt, face_value, start):
    """Per cell, ``start[c]`` plus ``+v[f]`` where the cell is ``lo[f]`` and
    ``-v[f]`` where it is ``hi[f]``, added one at a time in the CSR's
    order, in numpy; ``face_value`` ``(nf,)``."""
    ptr, codes = kt.cell_ptr.numpy(), kt.cell_faces.numpy()
    out = np.array(start, copy=True)
    for c in range(kt.num_cells):
        acc = out[c]
        for e in range(ptr[c], ptr[c + 1]):
            v = codes[e]
            acc = acc + (face_value[v] if v >= 0 else -face_value[-v - 1])
        out[c] = acc
    return out


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_ordered_sums_equal_a_numpy_loop(kernels_of, grid, dtype):
    """The residual's divergence, the jvp's and the linearization's values
    and diagonal against a numpy loop over the CSR, to the bit."""
    _kj, kt = kernels_of(grid)
    np_dtype, t_dtype = DTYPES[dtype]
    args, _launcher, cycle = kt._solver(t_dtype)
    lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef, slot, diag_slot = args
    p, p_prev, v = (torch.tensor(a) for a in _states(kt.num_cells, np_dtype, seed=6))
    m = reference._tpfa_mass_flux(p, lo, hi, t, is_neu, bc_val, coef).numpy()
    zero = np.zeros(kt.num_cells, dtype=np_dtype)
    div = reference._tpfa_divergence(torch.tensor(m), cell_ptr, cell_faces).numpy()
    assert np.array_equal(div.view(np.uint8), _csr_loop(kt, m, zero).view(np.uint8))
    # The linearization: the diagonal from its centre, and each neighbour's
    # value (one face a pair of cells on this grid) a_hi or -a_lo from 0.
    p_lo, p_hi = reference._tpfa_face_values(p, lo, hi, bc_val)
    a_lo, a_hi = (a.numpy() for a in reference._tpfa_face_coefficients(t, p_lo, p_hi, coef))
    live_lo, live_hi = np.where(is_neu.numpy(), 0, a_lo), np.where(is_neu.numpy(), 0, -a_hi)
    centre = (pv * (coef[1] * reference._density(p, coef)) / coef[4]).numpy()
    vals = reference.tpfa_linearize(p, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef, slot, diag_slot,
                                    cycle.op[-1].shape[0]).numpy()
    # A Neumann face adds nothing: skip it (adding 0 would keep the bits
    # of a nonzero diagonal too).
    ptr, codes = cell_ptr.numpy(), cell_faces.numpy()
    want_diag, want_vals = centre.copy(), np.zeros_like(vals)
    for c in range(kt.num_cells):
        for e in range(ptr[c], ptr[c + 1]):
            code = codes[e]
            f = code if code >= 0 else -code - 1
            if is_neu[f]:
                continue
            want_diag[c] = want_diag[c] + (live_lo[f] if code >= 0 else live_hi[f])
            k = slot[e]
            if k >= 0:
                want_vals[k] = want_vals[k] + (a_hi[f] if code >= 0 else -a_lo[f])
    want_vals[diag_slot.numpy()] = want_diag
    assert np.array_equal(vals.view(np.uint8), want_vals.view(np.uint8))


def test_tpfa_rows_is_the_csr():
    """``reference.tpfa_rows``: each row's faces, sides and validity in the
    CSR's order, padded to the longest row."""
    ptr = torch.tensor([0, 2, 2, 5], dtype=torch.int32)
    codes = torch.tensor([3, -1, 0, -3, -5], dtype=torch.int32)
    face, own, valid = reference.tpfa_rows(ptr, codes)
    assert valid.tolist() == [[True, True, False], [False, False, False], [True, True, True]]
    assert face[valid].tolist() == [3, 0, 0, 2, 4]
    assert own[valid].tolist() == [True, False, True, False, False]


def test_neumann_ghost_density_does_not_leak(kernels_of):
    """A Neumann face's bc_val is a flux, and its "density" may be inf: the
    residual, the values and the diagonal stay finite, and the residual
    keeps the prescribed flux."""
    _kj, kt = kernels_of("neumann")
    args, launcher, cycle = kt._solver(torch.float64)
    arrays = list(args[:9])
    neu = arrays[3]
    arrays[4] = torch.where(neu, torch.full_like(arrays[4], 1e12), arrays[4])
    big = kernels.TpfaLauncher(*arrays, launcher.t_sum, args[9], args[10], cycle.op[-1].shape[0])
    p, p_prev, _ = (torch.tensor(a) for a in _states(kt.num_cells, np.float64, seed=7))
    vals, diag = torch.empty_like(cycle.op[-1]), torch.empty_like(cycle.diag)
    r = big.step(p, p_prev, vals, diag)
    assert torch.isfinite(r).all() and torch.isfinite(vals).all() and torch.isfinite(diag).all()
    assert float(r.abs().max()) >= 1e11


# -- the launcher's checks -----------------------------------------------------------


def test_launcher_raises_on_wrong_fields(kernels_of):
    _kj, kt = kernels_of("dirichlet")
    args, launcher, cycle = kt._solver(torch.float64)
    n, nnz = kt.num_cells, cycle.op[-1].shape[0]
    p = torch.full((n,), 2e5, dtype=torch.float64)
    vals, diag = torch.empty(nnz, dtype=torch.float64), torch.empty(n, dtype=torch.float64)
    with pytest.raises(ValueError, match="fields"):
        launcher.residual(p.to(torch.float32), p.to(torch.float32))
    with pytest.raises(ValueError, match="fields"):
        launcher.jvp(p, p[:-1])
    with pytest.raises(ValueError, match="fields"):
        launcher.residual(p, torch.empty(n, dtype=torch.float64, device="meta"))
    with pytest.raises(ValueError, match="fields"):
        launcher.step(p, p, vals, diag[:-1])
    with pytest.raises(ValueError, match="vals"):
        launcher.linearize(p, vals[:-1])
    with pytest.raises(ValueError, match="vals"):
        launcher.step(p, p, vals.to(torch.float32), diag)
    arrays, slot, diag_slot = args[:9], args[9], args[10]
    with pytest.raises(TypeError, match="one dtype"):
        kernels.TpfaLauncher(*arrays[:2], arrays[2].to(torch.float32), *arrays[3:])
    with pytest.raises(TypeError, match="int32"):
        kernels.TpfaLauncher(arrays[0].long(), *arrays[1:])
    with pytest.raises(ValueError, match="shapes"):
        kernels.TpfaLauncher(*arrays[:5], arrays[5][:-1], *arrays[6:])
    with pytest.raises(TypeError, match="int32"):
        kernels.TpfaLauncher(*arrays, launcher.t_sum, slot.long(), diag_slot, nnz)
    with pytest.raises(ValueError, match="no t_sum"):
        kernels.TpfaLauncher(*arrays, None, slot, diag_slot, nnz).step(p, p, vals, diag)
    with pytest.raises(ValueError, match="no Jacobian pattern"):
        kernels.TpfaLauncher(*arrays).linearize(p, vals)


def test_newton_step_makes_one_step_launch_and_keeps_its_buffers(kernels_of):
    """``newton_step`` writes the FlowCycle's own buffers through one step
    call (the counters count launches on a card only: none here) and keeps
    its dtype's solver."""
    _kj, kt = kernels_of("neumann")
    p0 = torch.full((kt.num_cells,), 2e5, dtype=torch.float64)
    kernels.reset_launches()
    kt.newton_step(p0, p0)
    _args, launcher, cycle = kt._solvers[torch.float64]
    vals, diag = cycle.op[-1].clone(), cycle.diag.clone()
    r = launcher.step(p0, p0, torch.empty_like(vals), torch.empty_like(diag))
    assert torch.isfinite(r).all()
    kt.newton_step(p0, p0)
    assert torch.equal(cycle.op[-1], vals) and torch.equal(cycle.diag, diag)
    assert kt._solvers[torch.float64][-1] is cycle
    assert sum(kernels.LAUNCHES.values()) == 0


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K13 kernel has no CPU mode")
    return torch.device("cuda")


def _card_kernel(grid, dev):
    """The port's kernel of the grid on ``dev``, built without jax: the
    Neumann ends as :func:`_jax_kernel` makes them."""
    from porepy_tpu_torch.grids.structured import CartGrid
    from porepy_tpu_torch.parallel.flow_step import TpfaFlowKernel, build_cart_flow_kernel

    kt, _ = build_cart_flow_kernel(list(SHAPE), physdims=[1, 1, 1], dt=1.0, bc_pressure=_bc_faces, device="cpu",
                                   **FLUID)
    is_neu, bc_val = kt.is_neu.numpy().copy(), kt.bc_val.numpy().copy()
    if grid == "neumann":
        g = CartGrid(list(SHAPE), physdims=[1, 1, 1])
        g.compute_geometry()
        x = g.face_centers[0]
        ends = np.flatnonzero(np.isclose(x, 0.0) | np.isclose(x, 1.0))
        rng = np.random.default_rng(3)
        is_neu[ends] = True
        bc_val[ends] = rng.choice([-1.0, 1.0], ends.size) * rng.uniform(1e2, 1e4, ends.size)
    scal = {k: float(getattr(kt, k)) for k in ("rho_ref", "comp", "visc", "p_ref", "dt")}
    return TpfaFlowKernel.from_numpy(kt.lo.numpy(), kt.hi.numpy(), kt.t.numpy(), is_neu, bc_val, kt.pv.numpy(),
                                     device=dev, **scal)


def _long_row_kernel(dev):
    """The Neumann grid with 10 more faces at cell 0: to cells 2-9 and two
    more to cell 1 (three faces between one pair of cells), so that cell
    0's row (16 entries) is longer than a walk's batch and its neighbour
    values sum several faces."""
    from porepy_tpu_torch.parallel.flow_step import TpfaFlowKernel

    kt = _card_kernel("neumann", "cpu")
    extra = np.array([2, 3, 4, 5, 6, 7, 8, 9, 1, 1], dtype=np.int32)
    rng = np.random.default_rng(4)
    lo = np.concatenate([kt.lo.numpy(), np.zeros(extra.size, dtype=np.int32)])
    hi = np.concatenate([kt.hi.numpy(), extra])
    t = np.concatenate([kt.t.numpy(), rng.uniform(0.05, 0.2, extra.size)])
    is_neu = np.concatenate([kt.is_neu.numpy(), np.zeros(extra.size, dtype=bool)])
    bc_val = np.concatenate([kt.bc_val.numpy(), np.zeros(extra.size)])
    scal = {k: float(getattr(kt, k)) for k in ("rho_ref", "comp", "visc", "p_ref", "dt")}
    return TpfaFlowKernel.from_numpy(lo, hi, t, is_neu, bc_val, kt.pv.numpy(), device=dev, **scal)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_plain_versions_on_a_long_row_and_repeated_pairs(dtype):
    """Cell 0 of :func:`_long_row_kernel`: 16 entries, three faces to cell
    1. The linearization's values (each pair's faces summed from 0 in the
    row's order) and the divergence against a numpy CSR loop, to the bit;
    the matrix times v against the jvp."""
    np_dtype, t_dtype = DTYPES[dtype]
    kt = _long_row_kernel("cpu")
    ptr = kt.cell_ptr.numpy()
    assert ptr[1] - ptr[0] == 16
    args, _launcher, cycle = kt._solver(t_dtype)
    lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef, slot, diag_slot = args
    p, p_prev, v = (torch.tensor(a) for a in _states(kt.num_cells, np_dtype, seed=9))
    m = reference._tpfa_mass_flux(p, lo, hi, t, is_neu, bc_val, coef).numpy()
    div = reference._tpfa_divergence(torch.tensor(m), cell_ptr, cell_faces).numpy()
    assert np.array_equal(div.view(np.uint8), _csr_loop(kt, m, np.zeros(kt.num_cells, dtype=np_dtype)).view(np.uint8))
    p_lo, p_hi = reference._tpfa_face_values(p, lo, hi, bc_val)
    a_lo, a_hi = (a.numpy() for a in reference._tpfa_face_coefficients(t, p_lo, p_hi, coef))
    vals = reference.tpfa_linearize(p, *args[:9], slot, diag_slot, cycle.op[-1].shape[0]).numpy()
    want = np.zeros_like(vals)
    codes, slots = cell_faces.numpy(), slot.numpy()
    for c in range(kt.num_cells):
        for e in range(ptr[c], ptr[c + 1]):
            code = codes[e]
            f = code if code >= 0 else -code - 1
            if slots[e] >= 0 and not is_neu[f]:
                want[slots[e]] = want[slots[e]] + (a_hi[f] if code >= 0 else -a_lo[f])
    off = np.ones(vals.size, dtype=bool)
    off[diag_slot.numpy()] = False
    assert np.array_equal(vals[off].view(np.uint8), want[off].view(np.uint8))
    row_ptr, cols, _vals = cycle.op
    val, col = reference.csr_ell(row_ptr, cols, torch.tensor(vals), kt.num_cells)
    got = reference.ell_spmv_ordered(val, col, v)
    assert _rel_err(got.numpy(), reference.tpfa_jvp(p, v, *args[:9]).numpy()) <= REL_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("card_grid", ["dirichlet", "neumann", "long_row"])
def test_cuda_modes_match_plain_to_the_bit(cuda, card_grid, dtype):
    """Every mode on the card against its plain version on the same
    inputs, to the bit, one launch each counted; at a uniform p (no face
    flux: the accumulation's bits) too; a row longer than the walk's batch
    and three faces between one pair of cells (``long_row``)."""
    np_dtype, t_dtype = DTYPES[dtype]
    kt = _long_row_kernel(cuda) if card_grid == "long_row" else _card_kernel(card_grid, cuda)
    args, launcher, cycle = kt._solver(t_dtype)
    arrays, slot, diag_slot = args[:9], args[9], args[10]
    nnz = cycle.op[-1].shape[0]
    p, p_prev, v = (torch.tensor(a, device=cuda) for a in _states(kt.num_cells, np_dtype, seed=8))
    flat = torch.full_like(p, 2e5)
    kernels.reset_launches()
    for a, b in ((p, p_prev), (flat, p_prev), (flat, flat)):
        assert torch.equal(launcher.residual(a, b), reference.tpfa_residual(a, b, *arrays))
        assert torch.equal(kernels.tpfa_residual(a, b, *arrays), reference.tpfa_residual(a, b, *arrays))
    assert torch.equal(launcher.jvp(p, v), reference.tpfa_jvp(p, v, *arrays))
    vals = torch.empty_like(cycle.op[-1])
    launcher.linearize(p, vals)
    assert torch.equal(vals, reference.tpfa_linearize(p, *arrays, slot, diag_slot, nnz))
    s_vals, s_diag = torch.empty_like(vals), torch.empty_like(cycle.diag)
    r = launcher.step(p, p_prev, s_vals, s_diag)
    want = reference.tpfa_step(p, p_prev, *arrays, launcher.t_sum, slot, diag_slot, nnz)
    torch.cuda.synchronize()
    assert torch.equal(r, want[0]) and torch.equal(s_vals, want[1]) and torch.equal(s_diag, want[2])
    assert kernels.LAUNCHES["tpfa_residual"] == 6 and kernels.LAUNCHES["tpfa_jvp"] == 1
    assert kernels.LAUNCHES["tpfa_linearize"] == 1 and kernels.LAUNCHES["tpfa_step"] == 1


@pytest.mark.cuda
def test_cuda_newton_step_matches_the_host(cuda):
    """``newton_step`` on the card (one ``tpfa_step`` launch, two cycle
    launches) against the same step on the CPU's plain versions: the norm
    to 1e-13 relative, the new state to 1e-9 (exp may differ by an ulp
    between the two machines)."""
    card, host = _card_kernel("neumann", cuda), _card_kernel("neumann", "cpu")
    p0 = torch.full((card.num_cells,), 2e5, dtype=torch.float64)
    kernels.reset_launches()
    pc, rc = card.newton_step(p0.to(cuda), p0.to(cuda))
    ph, rh = host.newton_step(p0, p0)
    assert kernels.LAUNCHES["tpfa_step"] == 1 and kernels.LAUNCHES["bicgstab_tpfa"] == 2
    assert abs(float(rc) - float(rh)) <= 1e-13 * float(rh)
    assert _rel_err(pc.cpu().numpy(), ph.numpy()) <= STEP_TOL


@pytest.mark.parametrize("card_grid", ["dirichlet", "neumann", "long_row"])
def test_check_modes_runs_on_the_cpu(card_grid):
    """``tpfa_step_check.check_modes`` (``chip_smoke.py``'s and the check's
    bit tests) on the CPU, where the launches are the plain versions: every
    entry holds, the uniform states' included."""
    from porepy_tpu_torch.applications.benchmarking import tpfa_step_check as tsc

    kt = _long_row_kernel("cpu") if card_grid == "long_row" else _card_kernel(card_grid, "cpu")
    out = tsc.check_modes(kt, "cpu")
    assert out and all(out.values())
    assert "residual float64 at a uniform p = p_prev" in out


@pytest.mark.parametrize("name, short", [
    ("void (anonymous namespace)::tpfa_kernel<double, 3>((anonymous namespace)::Problem<double>)",
     "tpfa_kernel<double, 3>"),
    ("void (anonymous namespace)::structured_kernel<double, 1>(double const*, int)", "structured_kernel<double, 1>"),
    ("void (anonymous namespace)::bicgstab_kernel<double, CsrRows<double>, Jacobi<double, true> >(int)",
     "bicgstab_kernel<double, CsrRows<double>, Jacobi<double, true> >"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::neg_kernel_cuda(at::TensorIteratorBase&)"
     "::{lambda()#1}, std::array<char*, 2ul> >(int, float, std::array<char*, 2ul>)", "torch neg"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<double>, "
     "std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<double>, std::array<char*, 3ul>)", "torch add"),
    ("void other::kernel<float>(float*)", "other::kernel"),
    ("Memcpy DtoH (Device -> Pageable)", "Memcpy DtoH "),
])
def test_short_kernel_names(name, short):
    """The profiler names the flow checks count by (``timing.short_name``:
    the K12 refinement's launches a step are counted by them): the flow
    steps' kernels keep their template arguments, torch's are named by the
    functor they run."""
    from porepy_tpu_torch.applications.benchmarking.timing import nbytes, short_name

    assert short_name(name) == short
    assert nbytes(torch.zeros(3, dtype=torch.float64), None, torch.zeros(2, dtype=torch.int32)) == 32
