"""Spatial partition -> device placement for the sharded solve path.

The TPU-native counterpart of the reference's METIS partitioning for
distributed assembly (reference ``grids/partition.py:35`` feeds MPI rank
ownership): here a spatial partition of the mixed-dimensional grid
produces a DOF PERMUTATION that groups each device's dofs contiguously,
so the 1d ``NamedSharding`` over the dof axis gives every device a
spatially coherent piece of the problem — the ELL matvec's gathers of
the operand vector then hit mostly shard-local entries instead of
scattering across the interconnect.

Pure host-side preprocessing; the sharded Krylov solve itself is
unchanged (``parallel/sharded.py``), it just runs on the permuted system
(same nnz data order — only the index tables are permuted views).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "spatial_dof_permutation",
    "nnz_locality",
    "PermutedSystem",
]


def _cell_parts(mdg, n_parts: int) -> dict:
    """Partition every grid's cells spatially: the top-dimensional grid by
    the structured/METIS partitioner, every lower-dimensional subdomain
    and interface by nearest top-cell ownership (co-locating fracture and
    mortar dofs with the matrix region that surrounds them)."""
    from porepy_tpu_torch.grids.partition import (
        partition_coordinates,
        partition_metis,
    )

    sd_top = mdg.subdomains(dim=mdg.dim_max())[0]
    try:
        part_top = partition_metis(sd_top, n_parts)
    except ImportError:
        # Connectivity does not matter for PLACEMENT (a device may own
        # two patches); fractured grids routinely split coordinate blocks.
        part_top = partition_coordinates(
            sd_top, n_parts, check_connectivity=False
        )
    part_top = np.asarray(part_top, dtype=int)
    cc_top = sd_top.cell_centers

    def nearest_part(cc: np.ndarray) -> np.ndarray:
        if cc.size == 0:
            return np.zeros(0, dtype=int)
        # (3, n) x (3, N) distance argmin in chunks (demo-scale grids).
        out = np.empty(cc.shape[1], dtype=int)
        for lo in range(0, cc.shape[1], 4096):
            sl = slice(lo, lo + 4096)
            d2 = (
                (cc[:, None, sl] - cc_top[:, :, None]) ** 2
            ).sum(axis=0)
            out[sl] = part_top[np.argmin(d2, axis=0)]
        return out

    parts = {sd_top: part_top}
    for sd in mdg.subdomains():
        if sd is not sd_top:
            parts[sd] = nearest_part(sd.cell_centers)
    for intf in mdg.interfaces():
        parts[intf] = nearest_part(intf.cell_centers)
    return parts


def spatial_dof_permutation(eq_sys, mdg, n_parts: int):
    """``(perm, part_of_dof)``: a stable permutation grouping the global
    dofs by spatial partition (``x_part = x[perm]``), and each ORIGINAL
    dof's partition id. Within one partition the original variable/grid
    ordering is preserved (stable sort), so blocked preconditioners keep
    their local structure."""
    n = eq_sys.num_dofs()
    part_of_dof = np.zeros(n, dtype=int)
    parts = _cell_parts(mdg, n_parts)
    for var in eq_sys.variables:
        dofs = eq_sys.dofs_of([var])
        grid_parts = parts.get(var.domain)
        if grid_parts is None or dofs.size == 0:
            continue
        per_cell = dofs.size // max(grid_parts.size, 1)
        cells = np.arange(dofs.size) // max(per_cell, 1)
        part_of_dof[dofs] = grid_parts[np.minimum(cells, grid_parts.size - 1)]
    perm = np.argsort(part_of_dof, kind="stable")
    return perm, part_of_dof


class PermutedSystem:
    """View of a compiled system with permuted row/column indices: the nnz
    DATA order is untouched (assembly output feeds straight in); only the
    index tables the solver builds its ELL layout from are remapped."""

    def __init__(self, system, perm: np.ndarray) -> None:
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.size)
        idx = np.asarray(system.indices_np)
        self.indices_np = np.column_stack([inv[idx[:, 0]], inv[idx[:, 1]]])
        self.shape = system.shape
        self.num_rows = system.num_rows
        self.perm = perm
        self.inv = inv


def nnz_locality(system, n_shards: int, perm=None) -> float:
    """Fraction of matrix nonzeros whose row and column land on the SAME
    device under a contiguous equal split of the (optionally permuted)
    dof axis — the quantity the spatial permutation exists to raise."""
    idx = np.asarray(system.indices_np)
    rows, cols = idx[:, 0], idx[:, 1]
    if perm is not None:
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.size)
        rows, cols = inv[rows], inv[cols]
    n = system.shape[1]
    chunk = -(-n // n_shards)
    return float(np.mean(rows // chunk == cols // chunk))
