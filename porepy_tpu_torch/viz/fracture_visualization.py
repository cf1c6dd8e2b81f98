"""Matplotlib visualization of fracture networks and wells (reference
``viz/fracture_visualization.py``). Import of matplotlib is deferred so
headless environments without a display only pay on use."""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["plot_fractures", "plot_wells"]


def plot_fractures(
    pts: np.ndarray,
    edges: np.ndarray,
    domain: Optional[dict] = None,
    colortag: Optional[np.ndarray] = None,
    ax=None,
    **kwargs,
):
    """Plot a 2d fracture network: points ``(2, np)``, fractures as point
    index pairs ``(2, nf)``, optional domain box and per-fracture color
    tags. Returns the matplotlib axes."""
    import matplotlib.pyplot as plt

    if hasattr(domain, "bounding_box"):
        domain = domain.bounding_box
    if ax is None:
        _fig, ax = plt.subplots()
    if domain is not None:
        ax.plot(
            [domain["xmin"], domain["xmax"], domain["xmax"], domain["xmin"],
             domain["xmin"]],
            [domain["ymin"], domain["ymin"], domain["ymax"], domain["ymax"],
             domain["ymin"]],
            "-", color="red", **kwargs,
        )
    if colortag is None:
        tag = np.zeros(edges.shape[1], dtype=int)
    else:
        tag = np.asarray(colortag)
    cmap = None
    utag, inv = np.unique(tag, return_inverse=True)
    if utag.size > 1:
        import matplotlib.cm as cm

        cmap = cm.get_cmap("tab10", utag.size)
    for i in range(edges.shape[1]):
        color = "black" if cmap is None else cmap(inv[i])
        ax.plot(
            [pts[0, edges[0, i]], pts[0, edges[1, i]]],
            [pts[1, edges[0, i]], pts[1, edges[1, i]]],
            "-", color=color, **kwargs,
        )
    if domain is not None:
        ax.set_xlim(domain["xmin"], domain["xmax"])
        ax.set_ylim(domain["ymin"], domain["ymax"])
    return ax


def plot_wells(
    domain: dict, wells: np.ndarray, colortag: Optional[np.ndarray] = None, **kwargs
):
    """Plot vertical wells as point markers in the 2d domain box: ``wells``
    is ``(2, nw)`` well-head coordinates."""
    import matplotlib.pyplot as plt

    if hasattr(domain, "bounding_box"):
        domain = domain.bounding_box
    _fig, ax = plt.subplots()
    ax.plot(
        [domain["xmin"], domain["xmax"], domain["xmax"], domain["xmin"],
         domain["xmin"]],
        [domain["ymin"], domain["ymin"], domain["ymax"], domain["ymax"],
         domain["ymin"]],
        "-", color="red", **kwargs,
    )
    tag = np.zeros(wells.shape[1], dtype=int) if colortag is None else colortag
    for i in range(wells.shape[1]):
        ax.plot(wells[0, i], wells[1, i], "o", color=f"C{int(tag[i]) % 10}")
    ax.set_xlim(domain["xmin"], domain["xmax"])
    ax.set_ylim(domain["ymin"], domain["ymax"])
    return ax
