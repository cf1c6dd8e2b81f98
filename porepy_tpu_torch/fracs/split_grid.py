"""Splitting a grid along fractures: the topological heart of
mixed-dimensionality.

Parity counterpart of reference ``fracs/split_grid.py``: faces coinciding
with lower-dimensional cells are duplicated (new faces appended at the end,
sharing the original nodes); cell connectivity is rewired so cells on the
two sides of a fracture connect to different copies; nodes on fractures are
duplicated per connected cell-cluster around them (2 copies across a single
fracture, 3 at a T-intersection, 4 at an X-intersection).

Conventions that downstream code relies on (same as the reference):
- duplicated faces are appended after all existing faces, in the order the
  fractures are processed; ``sd.frac_pairs`` holds (original, duplicate)
  columns.
- the duplicate face keeps the original's geometry (normal NOT flipped);
  the cell on the "left" of the fracture plane (``(c - x0)
  . n <= 0``) is attached to the duplicate.
- duplicated nodes are inserted right after their original in the node
  ordering.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps
from scipy.sparse import csgraph

from porepy_tpu_torch.geometry.half_space import point_inside_half_space_intersection
from porepy_tpu_torch.utils import tags as tag_utils
from porepy_tpu_torch.utils.array_operations import expand_index_pointers, ismember_columns

__all__ = [
    "split_fractures",
    "split_faces",
    "split_nodes",
    "duplicate_faces",
    "duplicate_nodes",
    "update_cell_connectivity",
    "remove_faces",
]


def split_fractures(mdg, sd_pairs: dict, **kwargs):
    """Split faces/nodes of every grid in ``mdg`` along its
    lower-dimensional neighbors. Modifies grids in place; returns the mdg
    and the updated face-cell maps."""
    for sd_primary in mdg.subdomains():
        sd_primary.frac_pairs = np.zeros((2, 0), dtype=int)
        if sd_primary.dim < 1:
            continue

        low_dim_neigh = []
        matrix_list = []
        for sd_pair, matrix in sd_pairs.items():
            if sd_primary in sd_pair:
                other = sd_pair[1] if sd_pair[0] is sd_primary else sd_pair[0]
                if other.dim >= sd_primary.dim:
                    continue
                matrix_list.append(matrix)
                low_dim_neigh.append(other)
        if not low_dim_neigh:
            continue

        face_cells_modified = split_faces(sd_primary, matrix_list)
        for sd_secondary, matrix in zip(low_dim_neigh, face_cells_modified):
            sd_pairs[(sd_primary, sd_secondary)] = matrix

        secondary_to_primary_nodes = []
        for sd in low_dim_neigh:
            source = np.atleast_2d(sd.global_point_ind).astype(np.int64)
            target = np.atleast_2d(sd_primary.global_point_ind).astype(np.int64)
            _, mapping = ismember_columns(source, target)
            secondary_to_primary_nodes.append(mapping)

        split_nodes(sd_primary, low_dim_neigh, secondary_to_primary_nodes)

    for sd in mdg.subdomains():
        sd.cell_faces.eliminate_zeros()
        sd.update_boundary_node_tag()
    return mdg, sd_pairs


def split_faces(sd, face_cells: list[sps.spmatrix]) -> list[sps.spmatrix]:
    """Duplicate the fracture faces of each face-cell map and rewire cell
    connectivity; returns updated face-cell maps."""
    sd.frac_pairs = np.zeros((2, 0), dtype=int)
    for i in range(len(face_cells)):
        face_id = duplicate_faces(sd, face_cells[i])
        face_cells = _update_face_cells(face_cells, face_id, i)
        if face_id.size == 0:
            continue
        n = sd.face_normals[:, face_id[0]].reshape((3, 1))
        n = n / np.linalg.norm(n)
        x0 = sd.face_centers[:, face_id[0]].reshape((3, 1))
        flag = update_cell_connectivity(sd, face_id, n, x0)
        if flag == 0:
            left = face_id
            right = np.arange(sd.num_faces - face_id.size, sd.num_faces)
            sd.frac_pairs = np.hstack(
                (sd.frac_pairs, np.vstack((left, right)))
            )
    return face_cells


def duplicate_faces(sd, face_cells: sps.spmatrix) -> np.ndarray:
    """Duplicate all faces connected to a lower-dimensional cell; returns
    the indices of the duplicated (original) faces."""
    frac_id = np.unique(face_cells.nonzero()[1])
    return _duplicate_specific_faces(sd, frac_id)


def _duplicate_specific_faces(sd, frac_id: np.ndarray) -> np.ndarray:
    # Faces that already carry a standard tag (fracture/tip/boundary) are
    # not split again; they are marked as fracture faces.
    already = tag_utils.all_face_tags(sd.tags)[frac_id]
    sd.tags["fracture_faces"][frac_id[already]] = True
    sd.tags["tip_faces"][frac_id] = False
    frac_id = frac_id[~already]
    if frac_id.size == 0:
        return frac_id

    fn = sd.face_nodes
    node_start = fn.indptr[frac_id]
    node_end = fn.indptr[frac_id + 1]
    nodes = fn.indices[expand_index_pointers(node_start, node_end)]

    added_pos = np.cumsum(node_end - node_start) + fn.indptr[-1]
    fn.indices = np.hstack((fn.indices, nodes))
    fn.indptr = np.hstack((fn.indptr, added_pos))
    fn.data = np.hstack((fn.data, np.ones(nodes.size, dtype=bool)))
    fn._shape = (sd.num_nodes, fn.shape[1] + frac_id.size)

    sd.num_faces += frac_id.size
    sd.face_normals = np.hstack((sd.face_normals, sd.face_normals[:, frac_id]))
    sd.face_areas = np.append(sd.face_areas, sd.face_areas[frac_id])
    sd.face_centers = np.hstack((sd.face_centers, sd.face_centers[:, frac_id]))

    sd.tags["fracture_faces"][frac_id] = True
    sd.tags["tip_faces"][frac_id] = False
    # Face tags are copied to the duplicates.
    for key in list(sd.tags.keys()):
        if key.endswith("_faces"):
            sd.tags[key] = np.append(sd.tags[key], sd.tags[key][frac_id])
    return frac_id


def _update_face_cells(
    face_cells: list[sps.spmatrix], face_id: np.ndarray, i: int
) -> list[sps.spmatrix]:
    """Extend every face-cell map with columns for the duplicated faces; the
    target map ``i`` gets the same cell connections for the duplicates."""
    if face_id.size == 0:
        return face_cells
    out = []
    for j, f_c in enumerate(face_cells):
        f_c = f_c.tocsc()
        if j == i:
            sliced = f_c[:, face_id].tocsc()
            new_indptr = sliced.indptr[1:] + f_c.indptr[-1]
            f_c = sps.csc_matrix(
                (
                    np.hstack((f_c.data, sliced.data)),
                    np.hstack((f_c.indices, sliced.indices)),
                    np.hstack((f_c.indptr, new_indptr)),
                ),
                shape=(f_c.shape[0], f_c.shape[1] + face_id.size),
            )
        else:
            pad = np.full(face_id.size, f_c.indptr[-1], dtype=f_c.indptr.dtype)
            f_c = sps.csc_matrix(
                (f_c.data, f_c.indices, np.hstack((f_c.indptr, pad))),
                shape=(f_c.shape[0], f_c.shape[1] + face_id.size),
            )
        out.append(f_c)
    return out


def update_cell_connectivity(sd, face_id: np.ndarray, normal, x0) -> int:
    """Attach left-side cells to the duplicated faces, keep right-side cells
    on the originals. Returns 0 on split, -1 if the faces were on the
    domain boundary (duplicates removed)."""
    cf = sd.cell_faces.tocsr()
    sub = cf[face_id, :]
    rows, cols = sub.nonzero()

    left_cell = point_inside_half_space_intersection(
        normal, x0, sd.cell_centers[:, cols]
    )

    if np.all(left_cell) or not np.any(left_cell):
        # Fracture on the domain boundary: undo the duplication.
        rem = np.arange(cf.shape[0], sd.num_faces)
        sd.cell_faces = cf
        remove_faces(sd, rem, rem_cell_faces=False)
        sd.cell_faces = sd.cell_faces.tocsc()
        return -1

    if left_cell.sum() * 2 != left_cell.size:
        raise ValueError(
            "Fractures must be on the boundary or completely inside the domain"
        )

    data_all = np.asarray(sub[rows, cols]).ravel()

    # Left cells move to the duplicate faces (appended rows).
    lr, lc = rows[left_cell], cols[left_cell]
    cell_frac_left = sps.csr_matrix(
        (data_all[left_cell], (lr, lc)), shape=(face_id.size, cf.shape[1])
    )
    # Right cells stay on the original faces.
    rr, rc = rows[~left_cell], cols[~left_cell]
    cell_frac_right = sps.csr_matrix(
        (data_all[~left_cell], (rr, rc)), shape=(face_id.size, cf.shape[1])
    )

    cf = cf.tolil()
    for k, f in enumerate(face_id):
        cf.rows[f] = cell_frac_right.indices[
            cell_frac_right.indptr[k] : cell_frac_right.indptr[k + 1]
        ].tolist()
        cf.data[f] = cell_frac_right.data[
            cell_frac_right.indptr[k] : cell_frac_right.indptr[k + 1]
        ].tolist()
    cf = sps.vstack((cf.tocsr(), cell_frac_left)).tocsc()
    sd.cell_faces = cf
    return 0


def remove_faces(sd, face_id: np.ndarray, rem_cell_faces: bool = True) -> None:
    keep = np.ones(sd.num_faces, dtype=bool)
    keep[face_id] = False
    sd.face_nodes = sd.face_nodes[:, keep]
    sd.num_faces -= face_id.size
    sd.face_normals = sd.face_normals[:, keep]
    sd.face_areas = sd.face_areas[keep]
    sd.face_centers = sd.face_centers[:, keep]
    for key in tag_utils.standard_face_tags():
        sd.tags[key] = sd.tags[key][keep]
    if rem_cell_faces:
        sd.cell_faces = sd.cell_faces[keep, :]


def split_nodes(
    sd_primary, sd_secondary: list, primary_nodes_of_secondary: list[np.ndarray]
) -> None:
    """Split the primary-grid nodes underlying the secondary grids according
    to the cell topology around each node."""
    nodes = np.unique(
        np.concatenate(
            [m for m in primary_nodes_of_secondary] or [np.zeros(0, dtype=int)]
        )
    ).astype(int)
    node_count = duplicate_nodes(sd_primary, nodes)
    sd_primary.num_nodes = sd_primary.num_nodes + node_count


def duplicate_nodes(sd, nodes: np.ndarray) -> int:
    """Duplicate fracture nodes, one copy per connected cluster of cells
    around the node (clusters computed on the already-split cell-face
    connectivity). Returns the number of added nodes."""
    if nodes.size == 0:
        return 0
    cell_node = sd.cell_nodes().tocsr()
    face_node = sd.face_nodes.tocsc()
    cell_face = sd.cell_faces

    # Cells around each node.
    cn_csc = cell_node.T.tocsc()  # (cells x nodes) -> column n = cells of node
    cell_clusters = [
        np.unique(cn_csc.indices[cn_csc.indptr[n] : cn_csc.indptr[n + 1]])
        for n in nodes
    ]
    sz = [c.size for c in cell_clusters]
    tot = int(np.sum(sz))
    block_start = np.hstack((0, np.cumsum(sz)))

    # Build the cell-connection graph per cluster: cells connect if they
    # share a face (post face-splitting, fracture sides are disconnected).
    rows_cell_map = (
        np.hstack(cell_clusters) if tot else np.zeros(0, dtype=int)
    )
    cell_map = sps.coo_matrix(
        (np.ones(tot), (rows_cell_map, np.arange(tot))),
        shape=(sd.num_cells, tot),
    ).tocsc()
    cf_loc = cell_face @ cell_map
    c2c = (cf_loc.T @ cf_loc).tocoo()
    # Keep only in-block connections.
    blk_of = np.repeat(np.arange(len(sz)), sz)
    keep = (blk_of[c2c.row] == blk_of[c2c.col]) & (c2c.data != 0)
    adj = sps.coo_matrix(
        (np.ones(int(keep.sum())), (c2c.row[keep], c2c.col[keep])),
        shape=c2c.shape,
    )
    n_comp, labels = csgraph.connected_components(adj, directed=False)

    # Map each component to its node (clusters are contiguous blocks, so the
    # block of any member identifies the node). Order components by their
    # first member to obtain a deterministic duplicate ordering.
    comp_first = np.full(n_comp, tot, dtype=int)
    for idx in range(tot - 1, -1, -1):
        comp_first[labels[idx]] = idx
    comp_order = np.argsort(comp_first, kind="stable")
    comp_rank = np.empty(n_comp, dtype=int)
    comp_rank[comp_order] = np.arange(n_comp)

    # Per node: number of components and the local copy index of each
    # component (0 for the first encountered, 1 for the next, ...).
    node_of_comp = blk_of[comp_first]  # node-block index per component
    copy_index = np.zeros(n_comp, dtype=int)
    counts = np.zeros(len(sz), dtype=int)
    for c in comp_order:
        b = node_of_comp[c]
        copy_index[c] = counts[b]
        counts[b] += 1

    old_node_ind = face_node.indices.copy()
    new_node_ind = face_node.indices.copy()

    # For every component with copy_index > 0, bump the node index on the
    # faces of its cells.
    cf_csc = cell_face.tocsc()
    for c in comp_order:
        if copy_index[c] == 0:
            continue
        members = np.where(labels == c)[0]
        loc_cells = rows_cell_map[members]
        loc_faces = np.unique(
            np.concatenate(
                [
                    cf_csc.indices[cf_csc.indptr[cc] : cf_csc.indptr[cc + 1]]
                    for cc in loc_cells
                ]
            )
        )
        ni = nodes[node_of_comp[c]]
        for f in loc_faces:
            s, e = face_node.indptr[f], face_node.indptr[f + 1]
            sel = np.where(old_node_ind[s:e] == ni)[0]
            new_node_ind[s + sel] += copy_index[c]

    repetitions = np.ones(sd.num_nodes, dtype=int)
    repetitions[nodes] = counts
    added = repetitions - 1
    num_added = int(added.sum())
    increment = np.cumsum(np.hstack((0, added)))

    face_node.indices = (new_node_ind + increment[old_node_ind]).astype(
        face_node.indices.dtype
    )
    face_node._shape = (sd.num_nodes + num_added, sd.num_faces)
    sd.face_nodes = face_node

    new_2_old = np.repeat(np.arange(repetitions.size), repetitions)
    sd.nodes = sd.nodes[:, new_2_old]
    sd.global_point_ind = sd.global_point_ind[new_2_old]
    for key in ("node_is_fracture_tip", "node_is_tip_of_some_fracture"):
        if key in sd.tags:
            sd.tags[key] = sd.tags[key][new_2_old].astype(bool)
    # Node tags of standard kind also expand.
    for key in tag_utils.standard_node_tags():
        if key in sd.tags:
            sd.tags[key] = sd.tags[key][new_2_old].astype(bool)
    return num_added
