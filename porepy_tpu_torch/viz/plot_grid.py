"""Matplotlib plotting of grids and cell data (reference
``viz/plot_grid.py:29``): 0d-2d grids drawn as patches, 3d as cell-center
scatter. Intended for quick inspection, not production rendering."""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["plot_grid", "save_img"]


def plot_grid(
    grid,
    cell_value=None,
    vector_value=None,
    info: Optional[str] = None,
    **kwargs,
):
    """Plot a grid or mixed-dimensional grid, optionally colored by a
    cell-wise field (name of a stored state or explicit array)."""
    import matplotlib.pyplot as plt

    from porepy_tpu_torch.grids.md_grid import MixedDimensionalGrid

    fig = kwargs.get("fig") or plt.figure()
    ax = fig.gca()
    if isinstance(grid, MixedDimensionalGrid):
        subdomains = list(grid.subdomains())
        values = _resolve_values(grid, subdomains, cell_value)
        for sd, val in zip(subdomains, values):
            _plot_single(ax, sd, val, **kwargs)
    else:
        val = cell_value if not isinstance(cell_value, str) else None
        _plot_single(ax, grid, val, **kwargs)
    ax.set_aspect("equal", adjustable="box")
    if kwargs.get("plot", True) and not kwargs.get("if_plot", True) is False:
        return fig
    return fig


def save_img(name: str, grid, cell_value=None, **kwargs):
    fig = plot_grid(grid, cell_value, plot=False, **kwargs)
    fig.savefig(name, bbox_inches="tight")


def _resolve_values(mdg, subdomains, cell_value):
    from porepy_tpu_torch.utils.common_constants import ITERATE_SOLUTIONS

    if cell_value is None:
        return [None] * len(subdomains)
    if isinstance(cell_value, str):
        out = []
        for sd in subdomains:
            sols = mdg.subdomain_data(sd).get(ITERATE_SOLUTIONS, {})
            out.append(
                np.asarray(sols[cell_value][0])
                if cell_value in sols
                else None
            )
        return out
    # Concatenated array over all subdomains.
    out = []
    offset = 0
    for sd in subdomains:
        out.append(np.asarray(cell_value[offset : offset + sd.num_cells]))
        offset += sd.num_cells
    return out


def _plot_single(ax, g, values, **kwargs):
    import matplotlib.collections as mc
    import matplotlib.pyplot as plt

    if g.dim == 0:
        ax.plot(g.cell_centers[0], g.cell_centers[1], "o", color="k")
        return
    if g.dim == 1:
        fn = g.face_nodes.tocsc()
        cf = g.cell_faces.tocsc()
        segs = []
        for c in range(g.num_cells):
            faces = cf.indices[cf.indptr[c] : cf.indptr[c + 1]]
            nodes = [fn.indices[fn.indptr[f]] for f in faces]
            segs.append(g.nodes[:2, nodes].T)
        lc = mc.LineCollection(
            segs,
            array=values,
            linewidths=kwargs.get("linewidth", 2),
        )
        ax.add_collection(lc)
        ax.autoscale()
        return
    if g.dim == 2:
        from porepy_tpu_torch.viz.exporter import _sorted_cell_nodes_2d

        loops = _sorted_cell_nodes_2d(g)
        polys = [g.nodes[:2, loop].T for loop in loops]
        pc = mc.PolyCollection(
            polys,
            array=values,
            edgecolor=kwargs.get("color_map", "k"),
            linewidths=kwargs.get("linewidth", 0.5),
        )
        ax.add_collection(pc)
        ax.autoscale()
        if values is not None and kwargs.get("colorbar", True):
            plt.colorbar(pc, ax=ax)
        return
    # 3d: scatter the cell centers colored by value.
    sc = ax.scatter(
        g.cell_centers[0],
        g.cell_centers[1],
        c=values,
        s=kwargs.get("markersize", 8),
    )
    if values is not None and kwargs.get("colorbar", True):
        plt.colorbar(sc, ax=ax)
