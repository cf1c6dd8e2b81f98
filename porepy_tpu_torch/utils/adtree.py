"""Alternating digital tree (ADT) for box-intersection search.

Parity counterpart of reference ``utils/adtree.py:69,124``: nodes carry
bounding boxes scaled to the unit cube; insertion follows the alternating
coordinate-bisection rule. The candidate search tests scaled boxes for
overlap (same result set as the reference's pruned traversal).
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

__all__ = ["ADTNode", "ADTree"]


class ADTNode:
    def __init__(self, key: Any, box: np.ndarray) -> None:
        self.key = key
        self.box = np.atleast_1d(np.asarray(box, dtype=float))
        self.child: List[int] = [-1, -1]
        self.parent: int = -1

    def __str__(self) -> str:
        return (
            f"Node with key: {self.key}\nChild nodes: {self.child}\n"
            f"Parent node: {self.parent}\nBounding box: {self.box}"
        )

    def __repr__(self) -> str:
        return (
            f"key {self.key} children {self.child} parent {self.parent} "
            f"box {self.box}"
        )


class ADTree:
    LEFT = 0
    RIGHT = 1

    def __init__(self, tree_dim: int, phys_dim: int) -> None:
        self.tree_dim = tree_dim
        self.phys_dim = phys_dim
        self.nodes: List[ADTNode] = []
        self.region_min = 0.0
        self.delta = 1.0

    def add_node(self, node: ADTNode) -> None:
        """Insert by the alternating bisection rule: at tree level l, halve
        coordinate ``l % tree_dim`` and descend left/right."""
        if not self.nodes:
            self.nodes.append(node)
            return
        level = 0
        next_id = 0
        box = node.box.copy()
        while next_id != -1:
            current = next_id
            d = level % self.tree_dim
            box[d] *= 2.0
            if box[d] < 1.0:
                edge = self.LEFT
            else:
                edge = self.RIGHT
                box[d] -= 1.0
            next_id = self.nodes[current].child[edge]
            level += 1
        self.nodes[current].child[edge] = len(self.nodes)
        node.parent = current
        self.nodes.append(node)

    def search(self, node: ADTNode, tol: float = 2.0e-6) -> np.ndarray:
        """Ids of stored nodes whose boxes may intersect the query box."""
        box = node.box.copy()
        box[: self.phys_dim] = self._scale(box[: self.phys_dim]) - tol
        box[self.phys_dim :] = self._scale(box[self.phys_dim :]) + tol
        found = [
            i
            for i, n in enumerate(self.nodes)
            if self._box_intersect(box, n.box)
        ]
        return np.sort(found) if found else np.empty(0)

    def from_grid(self, g, only_cells: Optional[np.ndarray] = None) -> None:
        """Populate with grid cell bounding boxes (scaled to [0, 1])."""
        self.g = g
        cn = g.cell_nodes().tocsc()
        nodes_of = lambda c: cn.indices[cn.indptr[c] : cn.indptr[c + 1]]
        if only_cells is not None:
            which_cells = np.asarray(only_cells)
            which_nodes = np.unique(
                np.concatenate([nodes_of(c) for c in which_cells])
            )
        else:
            which_cells = np.arange(g.num_cells)
            which_nodes = np.arange(g.num_nodes)
        pts = g.nodes[: self.phys_dim, which_nodes]
        self.region_min = pts.min(axis=1)
        self.delta = 1.0 / (pts.max(axis=1) - self.region_min)
        for c in which_cells:
            c_nodes = g.nodes[: self.phys_dim, nodes_of(c)]
            c_min = self._scale(c_nodes.min(axis=1))
            c_max = self._scale(c_nodes.max(axis=1))
            self.add_node(ADTNode(int(c), np.hstack((c_min, c_max))))

    def _scale(self, x: np.ndarray) -> np.ndarray:
        return self.delta * (x - self.region_min)

    def _box_intersect(self, box1: np.ndarray, box2: np.ndarray) -> bool:
        return bool(
            np.all(box1[: self.phys_dim] <= box2[self.phys_dim :])
            and np.all(box2[: self.phys_dim] <= box1[self.phys_dim :])
        )

    def __str__(self) -> str:
        return (
            f"Tree search dimension: {self.tree_dim}\nPhysical dimension: "
            f"{self.phys_dim}\nNumber of nodes: {len(self.nodes)}"
        )

    def __repr__(self) -> str:
        return self.__str__()
