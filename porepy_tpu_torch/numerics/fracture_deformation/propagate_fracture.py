"""Fracture propagation: in-place topological extension of a fracture
through prescribed host-grid faces.

Counterpart of reference
``numerics/fracture_deformation/propagate_fracture.py:25``
(``propagate_fractures``), which carries the same single-fracture-per-call,
conforming-extension assumptions and the same in-place contract: the host
grid is split along the new faces, the fracture grid gains cells, the
interface mortar grid gains cells, and ``new_cells``/``new_faces``/
``split_faces`` tags are left in the data dictionaries for partial
rediscretization. Stored solution-ring vectors are remapped to the grown
grids (old entries keep their values, new entries are zero).

Design note (TPU-first): topology changes invalidate the static shapes the
compiled kernels rely on, so propagation sits at the re-setup boundary —
after a call, models must rebuild dofs/equations (``equation_system``
recompiles lazily). The topological surgery itself reuses the same
face/node splitting machinery as initial meshing (``fracs/split_grid.py``),
rather than a separate update path.

Current scope: 2d host grids (1d fractures) with conforming, coplanar
extension faces; the reference flags its own implementation as
experimental with similar assumptions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sps

from porepy_tpu_torch.fracs import split_grid
from porepy_tpu_torch.grids.mortar_grid import MortarGrid, MortarSides
from porepy_tpu_torch.utils import common_constants as cc

__all__ = ["propagate_fractures"]


def propagate_fractures(mdg, faces: dict) -> None:
    """Extend fractures through the host faces listed per fracture grid.

    Parameters:
        mdg: Mixed-dimensional grid, modified in place.
        faces: ``{fracture_grid: array of host face indices to split}``.
    """
    sd_h = mdg.subdomains(dim=mdg.dim_max())[0]
    if sd_h.dim not in (2, 3):
        raise NotImplementedError(
            "Fracture propagation needs a 2d or 3d host grid"
        )
    data_h = mdg.subdomain_data(sd_h)
    data_h["new_cells"] = np.empty(0, dtype=int)
    data_h["new_faces"] = np.empty(0, dtype=int)
    data_h["split_faces"] = np.empty(0, dtype=int)
    data_h["partial_update"] = True

    for sd_l, faces_h in faces.items():
        faces_h = np.unique(np.asarray(faces_h, dtype=int))
        data_l = mdg.subdomain_data(sd_l)
        data_l.setdefault("new_cells", np.empty(0, dtype=int))
        data_l["partial_update"] = True
        if faces_h.size == 0:
            continue

        n_frac_cells_old = sd_l.num_cells
        n_faces_old = sd_h.num_faces

        # 1. Grow the fracture grid along the (pre-split) host faces.
        if sd_h.dim == 2:
            _extend_fracture_grid_1d(sd_h, sd_l, faces_h)
        else:
            _extend_fracture_grid_2d(sd_h, sd_l, faces_h)
        new_cells_l = np.arange(n_frac_cells_old, sd_l.num_cells)
        data_l["new_cells"] = np.concatenate(
            [data_l["new_cells"], new_cells_l]
        )

        # 2. Split the host faces (duplicate + rewire cell connectivity).
        shared_nodes = _nodes_shared_with_old_fracture(sd_h, faces_h)
        face_id = split_grid._duplicate_specific_faces(sd_h, faces_h)
        if face_id.size:
            n = sd_h.face_normals[:, face_id[0]].reshape((3, 1))
            n = n / np.linalg.norm(n)
            x0 = sd_h.face_centers[:, face_id[0]].reshape((3, 1))
            flag = split_grid.update_cell_connectivity(sd_h, face_id, n, x0)
            if flag == 0:
                left = face_id
                right = np.arange(
                    sd_h.num_faces - face_id.size, sd_h.num_faces
                )
                sd_h.frac_pairs = np.hstack(
                    (sd_h.frac_pairs, np.vstack((left, right)))
                )
        # 3. Duplicate host nodes that became interior to the fracture
        #    (the former tips the extension grew through).
        if shared_nodes.size:
            added = split_grid.duplicate_nodes(sd_h, shared_nodes)
            sd_h.num_nodes += added
        sd_h.cell_faces.eliminate_zeros()
        sd_h.update_boundary_node_tag()

        new_faces_h = np.arange(n_faces_old, sd_h.num_faces)
        data_h["split_faces"] = np.concatenate(
            [data_h["split_faces"], faces_h]
        )
        data_h["new_faces"] = np.concatenate(
            [data_h["new_faces"], new_faces_h]
        )

        # 4. Rebuild the interface from the extended face-cell map,
        #    preserving the mortar object's identity.
        intf = _interface_of(mdg, sd_h, sd_l)
        face_cells = _extended_face_cells(
            mdg, intf, sd_h, sd_l, faces_h, new_faces_h, new_cells_l
        )
        n_mortar_old = intf.num_cells
        old_sides = intf.num_sides()
        _rebuild_interface_in_place(mdg, intf, sd_h, sd_l, face_cells)

        # 5. Remap solution rings on the fracture and the mortar.
        _pad_state_rings(data_l, n_frac_cells_old, sd_l.num_cells)
        _remap_mortar_rings(
            mdg.interface_data(intf),
            n_mortar_old,
            intf.num_cells,
            old_sides,
            intf.num_sides(),
        )


# -- fracture-grid growth ----------------------------------------------------------


def _extend_fracture_grid_1d(sd_h, sd_l, faces_h: np.ndarray) -> None:
    """Append one 1d cell per host face, chaining off the existing tips."""
    tol = 1e-10
    fn_h = sd_h.face_nodes.tocsc()
    for f in faces_h:
        nodes_f = fn_h.indices[fn_h.indptr[f] : fn_h.indptr[f + 1]]
        coords = sd_h.nodes[:, nodes_f]
        # Which endpoint is already a fracture node?
        dist = np.linalg.norm(
            coords[:, :, None] - sd_l.nodes[:, None, :], axis=0
        )
        attached = dist.min(axis=1) < tol
        if attached.sum() == 0:
            raise ValueError(
                f"Face {f} does not touch the fracture; extension must be "
                "conforming and contiguous"
            )
        shared_local = int(np.flatnonzero(attached)[0])
        tip_node_l = int(dist[shared_local].argmin())
        if attached.all():
            raise NotImplementedError(
                "Gap-closing extensions (both face endpoints on the "
                "fracture) are not supported"
            )
        new_local = 1 - shared_local

        # Faces of the 1d grid sit on nodes: face index == node index for
        # grids built by the meshing machinery; find the tip face on the
        # shared node.
        fn_l = sd_l.face_nodes.tocsc()
        tip_face = None
        for fc in range(sd_l.num_faces):
            idx = fn_l.indices[fn_l.indptr[fc] : fn_l.indptr[fc + 1]]
            if idx.size and idx[0] == tip_node_l:
                tip_face = fc
                break
        if tip_face is None:
            raise ValueError("No 1d face found on the shared node")

        # Append node, face, cell.
        new_node = sd_l.num_nodes
        sd_l.nodes = np.hstack(
            (sd_l.nodes, coords[:, new_local].reshape(3, 1))
        )
        sd_l.num_nodes += 1
        if hasattr(sd_l, "global_point_ind"):
            gpi = np.asarray(sd_l.global_point_ind)
            sd_l.global_point_ind = np.append(
                gpi, sd_h.global_point_ind[nodes_f[new_local]]
            )

        new_face = sd_l.num_faces
        fn = sd_l.face_nodes.tocoo()
        sd_l.face_nodes = sps.coo_matrix(
            (
                np.concatenate([fn.data, [True]]),
                (
                    np.concatenate([fn.row, [new_node]]),
                    np.concatenate([fn.col, [new_face]]),
                ),
            ),
            shape=(sd_l.num_nodes, new_face + 1),
        ).tocsc()
        sd_l.num_faces += 1

        cf = sd_l.cell_faces.tocoo()
        tip_entries = cf.row == tip_face
        s_old = cf.data[tip_entries][0] if tip_entries.any() else 1.0
        new_cell = sd_l.num_cells
        sd_l.cell_faces = sps.coo_matrix(
            (
                np.concatenate([cf.data, [-s_old, s_old]]),
                (
                    np.concatenate([cf.row, [tip_face, new_face]]),
                    np.concatenate([cf.col, [new_cell, new_cell]]),
                ),
            ),
            shape=(sd_l.num_faces, new_cell + 1),
        ).tocsc()
        sd_l.num_cells += 1

        # Tags: the old tip face is now interior; the new face is the tip.
        for key in ("tip_faces", "fracture_faces", "domain_boundary_faces"):
            sd_l.tags[key] = np.append(sd_l.tags[key], False)
        sd_l.tags["tip_faces"][tip_face] = False
        sd_l.tags["tip_faces"][new_face] = True
        for key in ("tip_nodes", "fracture_nodes", "domain_boundary_nodes"):
            if key in sd_l.tags:
                sd_l.tags[key] = np.append(sd_l.tags[key], False)
    sd_l.compute_geometry()


def _extend_fracture_grid_2d(sd_h, sd_l, faces_h: np.ndarray) -> None:
    """Append one 2d (polygon) cell per 3d host face to the fracture grid.

    Each host face's nodes arrive in circular order (``Grid.face_nodes``
    column contract); node positions are matched against existing fracture
    nodes, edges against existing fracture faces — reused edges were tip
    faces and become interior, fresh edges become the new tip front.
    """
    tol = 1e-10
    fn_h = sd_h.face_nodes.tocsc()

    def edge_key(a: int, b: int) -> tuple[int, int]:
        return (a, b) if a < b else (b, a)

    # Existing fracture edges: (node, node) -> face index, and each face's
    # stored (start, end) orientation.
    fn_l = sd_l.face_nodes.tocsc()
    edge_of: dict[tuple[int, int], int] = {}
    orient: dict[int, tuple[int, int]] = {}
    for fc in range(sd_l.num_faces):
        idx = fn_l.indices[fn_l.indptr[fc] : fn_l.indptr[fc + 1]]
        if idx.size == 2:
            edge_of[edge_key(idx[0], idx[1])] = fc
            orient[fc] = (int(idx[0]), int(idx[1]))

    fn_rows: list[np.ndarray] = []  # new face -> its two nodes (ordered)
    cf_entries: list[tuple[int, int, float]] = []  # (face, cell, sign)

    for f in faces_h:
        nodes_f = fn_h.indices[fn_h.indptr[f] : fn_h.indptr[f + 1]]
        coords = sd_h.nodes[:, nodes_f]
        # Host node -> fracture node (existing within tol, else appended).
        node_l = np.empty(nodes_f.size, dtype=int)
        for i in range(nodes_f.size):
            d = np.linalg.norm(sd_l.nodes - coords[:, i : i + 1], axis=0)
            hit = int(d.argmin()) if d.size else -1
            if hit >= 0 and d[hit] < tol:
                node_l[i] = hit
            else:
                node_l[i] = sd_l.num_nodes
                sd_l.nodes = np.hstack(
                    (sd_l.nodes, coords[:, i : i + 1])
                )
                sd_l.num_nodes += 1
                if hasattr(sd_l, "global_point_ind"):
                    sd_l.global_point_ind = np.append(
                        np.asarray(sd_l.global_point_ind),
                        sd_h.global_point_ind[nodes_f[i]],
                    )
                for key in (
                    "tip_nodes",
                    "fracture_nodes",
                    "domain_boundary_nodes",
                ):
                    if key in sd_l.tags:
                        sd_l.tags[key] = np.append(sd_l.tags[key], False)
        if not any(
            edge_key(node_l[i], node_l[(i + 1) % node_l.size]) in edge_of
            for i in range(node_l.size)
        ):
            raise ValueError(
                f"Face {f} does not share an edge with the fracture; the "
                "extension must be conforming and contiguous"
            )

        new_cell = sd_l.num_cells
        sd_l.num_cells += 1
        for i in range(node_l.size):
            a, b = int(node_l[i]), int(node_l[(i + 1) % node_l.size])
            key = edge_key(a, b)
            fc = edge_of.get(key)
            if fc is None:
                fc = sd_l.num_faces + len(fn_rows)
                edge_of[key] = fc
                orient[fc] = (a, b)
                fn_rows.append(np.array([a, b]))
                for tag in (
                    "tip_faces",
                    "fracture_faces",
                    "domain_boundary_faces",
                ):
                    sd_l.tags[tag] = np.append(
                        sd_l.tags[tag], tag == "tip_faces"
                    )
            else:
                # Reused edge (old tip, or an edge two new cells share):
                # now interior.
                sd_l.tags["tip_faces"][fc] = False
            sign = 1.0 if orient[fc] == (a, b) else -1.0
            cf_entries.append((fc, new_cell, sign))

    n_new_faces = len(fn_rows)
    fn = sd_l.face_nodes.tocoo()
    add_rows = (
        np.concatenate(fn_rows) if fn_rows else np.zeros(0, dtype=int)
    )
    add_cols = np.repeat(
        sd_l.num_faces + np.arange(n_new_faces), 2
    )
    sd_l.num_faces += n_new_faces
    sd_l.face_nodes = sps.coo_matrix(
        (
            np.concatenate([fn.data, np.ones(add_rows.size, dtype=bool)]),
            (
                np.concatenate([fn.row, add_rows]),
                np.concatenate([fn.col, add_cols]),
            ),
        ),
        shape=(sd_l.num_nodes, sd_l.num_faces),
    ).tocsc()

    cf = sd_l.cell_faces.tocoo()
    add_f, add_c, add_s = (
        zip(*cf_entries) if cf_entries else ((), (), ())
    )
    sd_l.cell_faces = sps.coo_matrix(
        (
            np.concatenate([cf.data, np.asarray(add_s)]),
            (
                np.concatenate([cf.row, np.asarray(add_f, dtype=int)]),
                np.concatenate([cf.col, np.asarray(add_c, dtype=int)]),
            ),
        ),
        shape=(sd_l.num_faces, sd_l.num_cells),
    ).tocsc()
    sd_l.compute_geometry()


def _nodes_shared_with_old_fracture(sd_h, faces_h: np.ndarray) -> np.ndarray:
    """Host nodes where the extension meets existing fracture faces — these
    become interior fracture nodes and must be duplicated."""
    fn = sd_h.face_nodes.tocsc()

    def nodes_of(fset):
        return np.unique(
            np.concatenate(
                [fn.indices[fn.indptr[f] : fn.indptr[f + 1]] for f in fset]
            )
            if len(fset)
            else np.zeros(0, dtype=int)
        )

    old_frac = np.flatnonzero(sd_h.tags["fracture_faces"])
    old_frac = np.setdiff1d(old_frac, faces_h)
    return np.intersect1d(nodes_of(faces_h), nodes_of(old_frac))


# -- interface rebuild ----------------------------------------------------------


def _interface_of(mdg, sd_h, sd_l):
    for intf in mdg.interfaces():
        pair = mdg.interface_to_subdomain_pair(intf)
        if pair[0] is sd_h and pair[1] is sd_l:
            return intf
    raise ValueError("No interface between the host and fracture grid")


def _extended_face_cells(
    mdg, intf, sd_h, sd_l, faces_h, new_faces_h, new_cells_l
) -> sps.csr_matrix:
    data = mdg.interface_data(intf)
    old = data.get("face_cells")
    old = old.tocoo()
    rows = [old.row]
    cols = [old.col]
    # Each new fracture cell couples to the split face and its duplicate.
    # new_faces_h lists duplicates in the order of faces_h.
    for k, c in enumerate(new_cells_l):
        rows.append(np.array([c, c]))
        cols.append(np.array([faces_h[k], new_faces_h[k]]))
    return sps.csr_matrix(
        (
            np.ones(sum(r.size for r in rows), dtype=bool),
            (np.concatenate(rows), np.concatenate(cols)),
        ),
        shape=(sd_l.num_cells, sd_h.num_faces),
    )


def _rebuild_interface_in_place(mdg, intf, sd_h, sd_l, face_cells) -> None:
    num_sides = np.bincount(face_cells.tocoo().row)
    if num_sides.size and np.all(num_sides > 1):
        side_g = {
            MortarSides.LEFT_SIDE: sd_l.copy(),
            MortarSides.RIGHT_SIDE: sd_l.copy(),
        }
    else:
        side_g = {MortarSides.LEFT_SIDE: sd_l.copy()}
    fresh = MortarGrid(sd_l.dim, side_g, face_cells)
    keep_id = getattr(intf, "_id", None)
    intf.__dict__.clear()
    intf.__dict__.update(fresh.__dict__)
    if keep_id is not None:
        intf._id = keep_id
    mdg.interface_data(intf)["face_cells"] = face_cells


# -- state remapping ----------------------------------------------------------


def _pad_state_rings(data: dict, n_old: int, n_new: int) -> None:
    """Zero-extend cell-based solution rings after cell append. Handles
    vector fields stored cell-interleaved (F-order): any ring whose size is
    an integer multiple of the old cell count is padded per-cell-block."""
    for loc in (cc.TIME_STEP_SOLUTIONS, cc.ITERATE_SOLUTIONS):
        for name, ring in data.get(loc, {}).items():
            for idx, vals in ring.items():
                vals = np.asarray(vals)
                if n_old > 0 and vals.size and vals.size % n_old == 0:
                    dim = vals.size // n_old
                    out = np.zeros(n_new * dim)
                    out[: n_old * dim] = vals
                    ring[idx] = out


def _remap_mortar_rings(
    data: dict, n_old: int, n_new: int, sides_old: int, sides_new: int
) -> None:
    """Remap side-major mortar cell vectors after the mortar grew."""
    if sides_old != sides_new:
        # Topological change of sides: no meaningful mapping; reset.
        for loc in (cc.TIME_STEP_SOLUTIONS, cc.ITERATE_SOLUTIONS):
            for name, ring in data.get(loc, {}).items():
                for idx, vals in ring.items():
                    vals = np.asarray(vals)
                    if n_old and vals.size and vals.size % n_old == 0:
                        ring[idx] = np.zeros(n_new * (vals.size // n_old))
        return
    per_old = n_old // sides_old
    per_new = n_new // sides_new
    for loc in (cc.TIME_STEP_SOLUTIONS, cc.ITERATE_SOLUTIONS):
        for name, ring in data.get(loc, {}).items():
            for idx, vals in ring.items():
                vals = np.asarray(vals)
                if n_old == 0 or not vals.size or vals.size % n_old:
                    continue
                dim = vals.size // n_old
                out = np.zeros(n_new * dim)
                for s in range(sides_old):
                    out[
                        s * per_new * dim : s * per_new * dim
                        + per_old * dim
                    ] = vals[s * per_old * dim : (s + 1) * per_old * dim]
                ring[idx] = out
