"""The batched block inverse (K11) of porepy_tpu_torch against porepy_tpu.

On the CPU ``invert_diagonal_blocks(..., device="cpu")`` runs the plain
Gauss-Jordan version of the kernel; these tests hold it against
``porepy_tpu``'s batched ``jnp.linalg.inv`` on the same seeded matrices,
and the plain version against numpy. The ``cuda``-marked test holds the
kernel against its plain version on the card and skips without one.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from porepy_tpu_torch import kernels
from porepy_tpu_torch.kernels import ops, reference
from porepy_tpu_torch.numerics.linalg import matrix_operations as mo_torch

torch.set_num_threads(1)

CPU = torch.device("cpu")
# |port - jax| <= 1e-12 max |entry|: both are f64 inverses of
# well-conditioned blocks (cond < 10), by different eliminations.
TOL = 1e-12


def _blocks(sizes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, n)) + n * np.eye(n) for n in sizes]


def _jax_inverse(mat, sizes):
    pytest.importorskip("jax")
    from porepy_tpu.numerics.linalg.matrix_operations import invert_diagonal_blocks

    return invert_diagonal_blocks(mat, sizes).toarray()


@pytest.mark.parametrize(
    "sizes",
    [
        [3, 1, 12, 5, 2, 7, 4, 9, 1, 6, 11, 8, 10, 3, 12, 2],
        [40],
        [40, 5, 40, 1],
    ],
    ids=["1-12", "40", "mixed-40"],
)
def test_batched_inverse_matches_jax(sizes):
    sizes = np.asarray(sizes)
    mat = sps.block_diag(_blocks(sizes, int(sizes.sum())), format="csr")
    want = _jax_inverse(mat, sizes)
    before = dict(kernels.LAUNCHES)
    got = mo_torch.invert_diagonal_blocks(mat, sizes, device="cpu")
    assert kernels.LAUNCHES == before, "the CPU route launched a kernel"
    assert isinstance(got, sps.csr_matrix) and got.shape == mat.shape
    assert np.abs(got.toarray() - want).max() <= TOL * np.abs(want).max()
    # The layout of _block_entry_layout: every block's n x n entries.
    assert got.nnz == int((sizes**2).sum())
    python = mo_torch.invert_diagonal_blocks(mat, sizes, method="python")
    assert np.abs(python.toarray() - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("n", [1, 2, 7, 20, 81])
def test_plain_gauss_jordan_matches_numpy(n):
    a = np.stack(_blocks([n] * 5, n))
    a[1] *= 10.0 ** np.random.default_rng(n).uniform(-3, 3, (n, 1))
    got = reference.block_inverse(torch.tensor(a)).numpy()
    want = np.linalg.inv(a)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 1e-12 * np.abs(w).max()


def test_block_needing_a_row_swap():
    """A zero leading entry: Gauss-Jordan must pivot to invert it."""
    a = np.array([[[0.0, 2.0, 1.0], [1.0, 0.0, 3.0], [4.0, 1.0, 0.0]]])
    got = reference.block_inverse(torch.tensor(a)).numpy()[0]
    np.testing.assert_allclose(got @ a[0], np.eye(3), atol=1e-14)
    mat = sps.block_diag([np.eye(2), a[0]], format="csr")
    inv = mo_torch.invert_diagonal_blocks(mat, np.array([2, 3]), device="cpu").toarray()
    np.testing.assert_allclose(inv @ mat.toarray(), np.eye(5), atol=1e-14)
    np.testing.assert_allclose(inv, _jax_inverse(mat, np.array([2, 3])), atol=1e-14)


def test_singular_block_is_non_finite_in_both_packages():
    """A singular block gives non-finite entries on both batched routes
    (the numpy loop raises); the other blocks stay exact."""
    sing = np.array([[1.0, 2.0], [2.0, 4.0]])
    mat = sps.block_diag([np.diag([2.0, 4.0]), sing], format="csr")
    sizes = np.array([2, 2])
    got = mo_torch.invert_diagonal_blocks(mat, sizes, device="cpu").toarray()
    want = _jax_inverse(mat, sizes)
    for inv in (got, want):
        assert not np.all(np.isfinite(inv[2:, 2:]))
        np.testing.assert_array_equal(inv[:2, :2], np.diag([0.5, 0.25]))
    with pytest.raises(np.linalg.LinAlgError):
        mo_torch.invert_diagonal_blocks(mat, sizes, method="python")


def test_default_device_is_the_card():
    """Without a device the batched route runs on the CUDA card: on a host
    without one it raises instead of inverting on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    mat = sps.identity(3, format="csr")
    with pytest.raises(RuntimeError, match="CUDA"):
        mo_torch.invert_diagonal_blocks(mat, np.array([1, 2]))
    with pytest.raises(ValueError, match="Unknown inverter"):
        mo_torch.invert_diagonal_blocks(mat, np.array([1, 2]), method="lapack")


def test_block_inverse_cuda_wrapper_refuses_without_falling_back():
    a = torch.eye(3, dtype=torch.float64)[None]
    with pytest.raises(TypeError, match="float64"):
        ops._block_inverse_cuda(a.float())
    with pytest.raises(ValueError, match="expected cuda"):
        ops._block_inverse_cuda(a)
    with pytest.raises(ValueError, match=r"\(B, n, n\)"):
        ops._block_inverse_cuda(a[:, :, :2])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 12, 20, 81, 160], ids=lambda n: f"n{n}")
def test_cuda_block_inverse_matches_plain(cuda, n):
    """The kernel against its plain version (the same pivots and roundings:
    1e-12 of the largest entry), with a row swap in block 0 (n > 1); n =
    160 runs from the device workspace."""
    rng = np.random.default_rng(n)
    a = rng.standard_normal((6, n, n)) + n * np.eye(n)
    if n > 1:
        a[0, 0, 0] = 0.0
    a = torch.tensor(a, device=cuda)
    got = kernels.block_inverse(a)
    torch.cuda.synchronize()
    want = reference.block_inverse(a)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    eye = torch.eye(n, dtype=a.dtype, device=cuda)
    assert float((a @ got - eye).abs().max()) <= 1e-10 * n


def _numpy_gauss_jordan(a):
    """Gauss-Jordan on ``[A | I]`` with physical row swaps, in numpy: per
    column k the first row i >= k of largest |M_ik| (``np.argmax``) is
    swapped into row k, row k is divided by its pivot and ``M_ik`` times it
    is subtracted from every row i (product and difference rounded apart).
    Returns the inverse and the original row of each step's pivot."""
    n = a.shape[0]
    M = np.hstack([a, np.eye(n)])
    rows = np.arange(n)
    pivots = []
    for k in range(n):
        p = k + int(np.argmax(np.abs(M[k:, k])))
        M[[k, p]] = M[[p, k]]
        rows[[k, p]] = rows[[p, k]]
        pivots.append(int(rows[k]))
        M[k] = M[k] / M[k, k]
        f = M[:, k].copy()
        f[k] = 0.0
        M = M - f[:, None] * M[k][None, :]
    return M[:, n:], pivots


# Step 0 takes row 2 (|2|) into position 0 and row 0 into position 2; step
# 1 then finds |-1| in row 1 (position 1) tied with |1| in row 0 (position
# 2): the swapped order takes row 1, the stored order would take row 0.
TIE_IN_SWAPPED_ORDER = np.array([[1.0, 1.0, 1.0], [1.0, -1.0, 2.0], [2.0, 0.0, 1.0]])


def _tie_batch(n, seed, count=6):
    """Small-integer blocks (many tied magnitudes at every step), the
    tie-in-the-swapped-order block in the leading corner of the first, none
    singular."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < count:
        a = rng.integers(-2, 3, (n, n)).astype(float)
        if not out and n >= 3:
            a[:3, :3] = TIE_IN_SWAPPED_ORDER
            a[:3, 3:] = 0.0
        if abs(np.linalg.det(a)) > 0.5:
            out.append(a)
    return np.stack(out)


def test_tie_block_breaks_the_tie_in_the_swapped_order():
    _, pivots = _numpy_gauss_jordan(TIE_IN_SWAPPED_ORDER)
    assert pivots[:2] == [2, 1]


@pytest.mark.parametrize("n", [3, 5, 12, 33])
def test_plain_version_keeps_the_tie_rule_of_row_swaps(n):
    """The plain Gauss-Jordan (the yardstick of K11) equals the numpy one
    with physical row swaps to the bit, on blocks full of ties."""
    a = _tie_batch(n, 100 + n)
    got = reference.block_inverse(torch.tensor(a)).numpy()
    for g, blk in zip(got, a):
        want, _ = _numpy_gauss_jordan(blk)
        assert np.array_equal(g.view(np.int64), want.view(np.int64))


def _cuda_against_plain(a, cuda):
    a = torch.tensor(a, device=cuda)
    before = kernels.LAUNCHES["block_inverse"]
    got = kernels.block_inverse(a)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["block_inverse"] == before + 1
    return got, reference.block_inverse(a)


@pytest.mark.cuda
def test_cuda_warp_route_equals_plain_at_every_small_size(cuda):
    """n = 1..32 (one warp a matrix): the kernel equals its plain version
    (the same pivots, the same roundings), with row swaps in every block."""
    for n in range(1, 33):
        rng = np.random.default_rng(n)
        a = rng.standard_normal((9, n, n)) * 10.0 ** rng.uniform(-3, 3, (9, n, 1)) + np.eye(n)
        got, want = _cuda_against_plain(a, cuda)
        assert torch.equal(got, want), n


@pytest.mark.cuda
@pytest.mark.parametrize("n", [33, 81, 120, 160, 200], ids=lambda n: f"n{n}")
def test_cuda_block_route_equals_plain(cuda, n):
    """n > 32 (a block a matrix): in shared memory up to 167, n = 200 from
    the device workspace; the kernel equals its plain version, and A X = I
    to rounding."""
    rng = np.random.default_rng(n)
    a = rng.standard_normal((5, n, n)) * 10.0 ** rng.uniform(-2, 2, (5, n, 1)) + np.eye(n)
    got, want = _cuda_against_plain(a, cuda)
    assert torch.equal(got, want)
    scaled = torch.tensor(a, device=cuda)
    eye = torch.eye(n, dtype=torch.float64, device=cuda)
    resid = (scaled @ got - eye).abs().amax(dim=(1, 2))
    norms = scaled.abs().sum(2).amax(1) * got.abs().sum(2).amax(1)
    assert float((resid / norms).max()) <= 1e-13


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 12, 20, 33, 81], ids=lambda n: f"n{n}")
def test_cuda_ties_in_the_swapped_order(cuda, n):
    """Blocks of small integers (tied magnitudes at every step, one tie that
    the swapped order breaks otherwise than the stored order): the kernel
    takes the plain version's pivots, so its result is the plain version's."""
    got, want = _cuda_against_plain(_tie_batch(n, 100 + n), cuda)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 20, 81], ids=lambda n: f"n{n}")
def test_cuda_singular_block_is_non_finite(cuda, n):
    """A block with a zero column has a zero pivot on both routes: its
    inverse is non-finite on the card as in the plain version; the other
    blocks are exact."""
    rng = np.random.default_rng(n)
    a = rng.standard_normal((3, n, n)) + n * np.eye(n)
    a[1, :, n // 2] = 0.0
    got, want = _cuda_against_plain(a, cuda)
    assert not bool(torch.isfinite(got[1]).all()) and not bool(torch.isfinite(want[1]).all())
    assert torch.equal(got[[0, 2]], want[[0, 2]])
