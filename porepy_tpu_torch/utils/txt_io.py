"""Plain-text column export/import (reference ``utils/txt_io.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

__all__ = ["TxtData", "export_data_to_txt", "read_data_from_txt"]


@dataclass
class TxtData:
    header: str
    array: np.ndarray
    format: str = "%2.2e"


def export_data_to_txt(
    list_of_txt_data: list[TxtData], file_name=Path("out.txt")
) -> None:
    sizes = [np.size(d.array) for d in list_of_txt_data]
    if not all(s == sizes[0] for s in sizes):
        raise ValueError("Expected arrays of equal length.")
    header = " ".join(d.header for d in list_of_txt_data)
    table = np.column_stack([d.array for d in list_of_txt_data])
    fmt = " ".join(d.format for d in list_of_txt_data)
    np.savetxt(file_name, table, header=header, fmt=fmt)


def read_data_from_txt(file_name) -> dict[str, np.ndarray]:
    with open(file_name) as fh:
        first = fh.readline().lstrip("#").split()
    table = np.atleast_2d(np.loadtxt(file_name))
    return {name: table[:, i] for i, name in enumerate(first)}
