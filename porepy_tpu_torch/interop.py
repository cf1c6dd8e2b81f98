"""Host arrays into tensors, for handing state between packages.

:func:`tensors_from_numpy` converts a nested structure of dicts, lists and
tuples holding array-likes (numpy arrays, or anything ``np.asarray``
accepts) into the same structure of tensors on one device. Dtypes are kept:
float32 stays float32, int32 stays int32. This is how the tests feed state
computed elsewhere (a global vector, env tuples, Jacobian nonzeros, a
frozen preconditioner state) to the port, so that both sides compute from
identical inputs. The module needs numpy and torch only.
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

__all__ = ["tensors_from_numpy"]


def tensors_from_numpy(tree: Any, device: Union[str, torch.device] = "cpu") -> Any:
    """``tree`` with every array leaf (anything with ``__array__``, numpy
    scalars included) replaced by a tensor copy on ``device``. Dicts, lists
    and tuples are rebuilt with the same keys and order; other leaves
    (``None``, strings, Python numbers) pass through unchanged."""
    if isinstance(tree, dict):
        return {k: tensors_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tensors_from_numpy(v, device) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    if hasattr(tree, "__array__"):
        return torch.tensor(np.asarray(tree), device=device)
    return tree
