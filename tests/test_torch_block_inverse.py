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
