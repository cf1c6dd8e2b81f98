"""Standard grid tag helpers (reference ``utils/tags.py``)."""

from __future__ import annotations

import numpy as np

__all__ = [
    "standard_face_tags",
    "standard_node_tags",
    "all_face_tags",
    "all_node_tags",
    "add_node_tags_from_face_tags",
]


def standard_face_tags() -> list[str]:
    return ["fracture_faces", "tip_faces", "domain_boundary_faces"]


def standard_node_tags() -> list[str]:
    return ["fracture_nodes", "tip_nodes", "domain_boundary_nodes"]


def _any_tag(tags: dict, keys: list[str]) -> np.ndarray:
    out = np.array(tags[keys[0]], dtype=bool)
    for k in keys[1:]:
        out = out | tags[k]
    return out


def all_face_tags(tags: dict) -> np.ndarray:
    return _any_tag(tags, standard_face_tags())


def all_node_tags(tags: dict) -> np.ndarray:
    return _any_tag(tags, standard_node_tags())


def add_node_tags_from_face_tags(mdg, tag_base: str) -> None:
    """Tag every node touching a ``<tag_base>_faces``-tagged face with
    ``<tag_base>_nodes``, on all subdomains (reference ``utils/tags.py:102``)."""
    for sd in mdg.subdomains():
        nodes = sd.face_nodes[:, sd.tags[tag_base + "_faces"]].nonzero()[0]
        t = np.zeros(sd.num_nodes, dtype=bool)
        t[np.unique(nodes)] = True
        sd.tags[tag_base + "_nodes"] = t
