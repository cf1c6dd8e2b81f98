"""Data-dictionary initialization.

Parity counterpart of reference ``params/data.py:94-218`` (new signature
only — the deprecated leading-grid signature is not reproduced). The nested
structure is the framework-wide contract::

    data = {
        pp.PARAMETERS: {keyword: {...user parameters...}},
        pp.DISCRETIZATION_MATRICES: {keyword: {...filled by discretize()...}},
    }
"""

from __future__ import annotations

from typing import Optional

from porepy_tpu_torch.utils import common_constants as cc

__all__ = ["initialize_data", "add_nonpresent_dictionary"]


def add_nonpresent_dictionary(dictionary: dict, key: str) -> None:
    """Add ``key`` with an empty dict value if not already present."""
    if key not in dictionary:
        dictionary[key] = {}


def initialize_data(
    data: dict, keyword: str, specified_parameters: Optional[dict] = None
) -> dict:
    """Create/update the nested parameter + discretization-matrix structure
    for one keyword. Returns the same ``data`` object."""
    if not isinstance(data, dict) or not isinstance(keyword, str):
        raise TypeError("initialize_data(data: dict, keyword: str, params: dict)")
    add_nonpresent_dictionary(data, cc.DISCRETIZATION_MATRICES)
    add_nonpresent_dictionary(data[cc.DISCRETIZATION_MATRICES], keyword)
    add_nonpresent_dictionary(data, cc.PARAMETERS)
    add_nonpresent_dictionary(data[cc.PARAMETERS], keyword)
    data[cc.PARAMETERS][keyword].update(specified_parameters or {})
    return data
