"""Entry points of porepy_tpu_torch put their tensors on the CUDA card
unless the caller names another device: the SA-AMG hierarchy and the
interop functions resolve ``device=None`` to the card, so on a host
without one they raise, and with ``"cpu"`` they run on the host."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from porepy_tpu_torch import interop
from porepy_tpu_torch.numerics.linalg import amg

torch.set_num_threads(1)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def _laplacian(n=400):
    main = 2.0 * np.ones(n)
    off = -np.ones(n - 1)
    return sps.diags([off, main, off], [-1, 0, 1], format="csr")


class _Kernel:
    """The array attributes of a flow-step kernel (any values will do)."""

    def __init__(self, fields):
        for f in fields:
            setattr(self, f, np.ones(2))
        self.shape = (2, 1, 1)


def test_build_hierarchy_defaults_to_the_card(no_card):
    with pytest.raises(RuntimeError, match="CUDA"):
        amg.build_hierarchy(_laplacian())


def test_build_hierarchy_runs_on_the_cpu():
    h = amg.build_hierarchy(_laplacian(), device="cpu")
    assert h.device == torch.device("cpu") and len(h.level_sizes) >= 2
    r = torch.ones(400, dtype=torch.float32)
    assert h.apply(h.state, r).device == torch.device("cpu")


def test_hierarchy_defaults_to_the_card(no_card):
    with pytest.raises(RuntimeError, match="CUDA"):
        amg.Hierarchy([], np.eye(2), torch.float32)


@pytest.mark.parametrize(
    "call",
    [
        lambda dev: interop.tensors_from_numpy({"a": [np.ones(2)]}, *dev),
        lambda dev: interop.structured_flow_kernel_from(_Kernel(interop._STRUCTURED_FIELDS), *dev),
        lambda dev: interop.tpfa_flow_kernel_from(_Kernel(interop._TPFA_FIELDS), *dev),
    ],
    ids=["tensors_from_numpy", "structured_flow_kernel_from", "tpfa_flow_kernel_from"],
)
def test_interop_defaults_to_the_card(no_card, call):
    with pytest.raises(RuntimeError, match="CUDA"):
        call(())


def test_tensors_from_numpy_on_the_cpu_keeps_structure_and_dtypes():
    tree = {"a": [np.ones(2, np.float32), (np.arange(3, dtype=np.int32), None)], "b": 1.5}
    out = interop.tensors_from_numpy(tree, "cpu")
    assert out["a"][0].dtype == torch.float32 and out["a"][0].device == torch.device("cpu")
    assert out["a"][1][0].dtype == torch.int32 and out["a"][1][1] is None
    assert isinstance(out["a"][1], tuple) and out["b"] == 1.5
