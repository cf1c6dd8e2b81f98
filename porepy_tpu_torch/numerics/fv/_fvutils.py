"""Small shared helpers for the FV discretizations.

The interaction-region machinery lives in ``regions.py``/``local_solves.py``
(the reference's ``SubcellTopology``/``ExcludeBoundaries`` equivalents are
organized per region there).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "determine_eta",
    "subface_numbering",
    "boundary_to_sub_boundary",
    "map_subface_to_face",
    "active_entities_for_partial_update",
    "partial_update_discretization",
]


def active_entities_for_partial_update(sd, cells=None, faces=None):
    """Stencil closure of a modification set for the multi-point methods.

    Given modified cells and/or faces, returns
    ``(nodes_needed, active_faces, active_cells)``:

    - ``active_faces``: every face whose discretization row may have
      changed — any face sharing a node (interaction region) with a
      modified cell or face;
    - ``active_cells``: every cell whose divergence row (Biot) may have
      changed — any cell sharing a node with the modification set;
    - ``nodes_needed``: the nodes whose interaction regions must be
      re-assembled to recompute those rows in full (all nodes of all
      active faces and active cells).

    Counterpart of the reference's ``cell_ind_for_partial_update``
    (reference ``numerics/fv/_fvutils.py:1260``), stated in the region
    framework's node terms.
    """
    from porepy_tpu_torch.utils.array_operations import expand_index_pointers

    fn = sd.face_nodes.tocsc()
    cn = sd.cell_nodes().tocsc()
    nnpf = np.diff(fn.indptr)
    face_of_entry = np.repeat(np.arange(sd.num_faces), nnpf)
    cell_of_entry = np.repeat(np.arange(sd.num_cells), np.diff(cn.indptr))
    node_mask = np.zeros(sd.num_nodes, dtype=bool)
    if cells is not None and np.asarray(cells).size:
        lo, hi = cn.indptr[np.asarray(cells)], cn.indptr[np.asarray(cells) + 1]
        node_mask[cn.indices[expand_index_pointers(lo, hi)]] = True
    if faces is not None and np.asarray(faces).size:
        lo, hi = fn.indptr[np.asarray(faces)], fn.indptr[np.asarray(faces) + 1]
        node_mask[fn.indices[expand_index_pointers(lo, hi)]] = True
    active_faces = np.flatnonzero(
        np.bincount(
            face_of_entry, node_mask[fn.indices], minlength=sd.num_faces
        )
        > 0
    )
    active_cells = np.flatnonzero(
        np.bincount(
            cell_of_entry, node_mask[cn.indices], minlength=sd.num_cells
        )
        > 0
    )
    needed = np.zeros(sd.num_nodes, dtype=bool)
    needed[fn.indices[np.isin(face_of_entry, active_faces)]] = True
    needed[cn.indices[np.isin(cell_of_entry, active_cells)]] = True
    return np.flatnonzero(needed), active_faces, active_cells


def restriction_from_params(sd, param):
    """``(nodes_needed, active_faces)`` when the parameters carry a
    partial-update request (``specified_cells`` / ``specified_faces``),
    else None."""
    spec_c = param.get("specified_cells", None)
    spec_f = param.get("specified_faces", None)
    if spec_c is None and spec_f is None:
        return None
    return active_entities_for_partial_update(sd, cells=spec_c, faces=spec_f)


def partial_update_discretization(
    sd,
    data,
    keyword: str,
    discretize,
    dim=None,
    scalar_cell_right=(),
    vector_cell_right=(),
    scalar_face_right=(),
    vector_face_right=(),
    scalar_face_left=(),
    vector_face_left=(),
    scalar_cell_left=(),
):
    """Update stored discretization matrices after a local modification.

    Reads ``data['update_discretization']`` with optional keys
    ``modified_cells``, ``modified_faces`` (index arrays) and
    ``map_cells``, ``map_faces`` (sparse new-from-old index maps for
    changed grids). Old matrices are mapped to the new numbering, rows of
    faces (or, for ``scalar_cell_left`` divergence matrices, cells) whose
    stencil changed are zeroed, and the fresh partial discretization
    (``discretize`` honouring ``specified_cells`` / ``specified_faces`` in
    the parameters) is added. The left/right keyword lists classify each
    matrix's row/column spaces exactly as in the reference
    (``_fvutils.partial_update_discretization:1090``); dict-valued
    entries (Biot's per-coupling-key matrices) are mapped per sub-matrix.
    """
    import scipy.sparse as sps

    from porepy_tpu_torch.utils.common_constants import (
        DISCRETIZATION_MATRICES,
        PARAMETERS,
    )

    if dim is None:
        dim = sd.dim
    info = data["update_discretization"]
    mod_cells = np.asarray(info.get("modified_cells", np.zeros(0, int)))
    mod_faces = np.asarray(info.get("modified_faces", np.zeros(0, int)))
    cell_map = info.get("map_cells", sps.identity(sd.num_cells))
    face_map = info.get("map_faces", sps.identity(sd.num_faces))

    _nodes, active_faces, active_cells = active_entities_for_partial_update(
        sd, cells=mod_cells, faces=mod_faces
    )

    def mapped(key, mat):
        if isinstance(mat, dict):
            return {k: mapped(key, v) for k, v in mat.items()}
        if key in scalar_cell_right:
            mat = mat @ cell_map.T
        elif key in vector_cell_right:
            mat = mat @ sps.kron(cell_map.T, sps.eye(dim))
        elif key in scalar_face_right:
            mat = mat @ face_map.T
        elif key in vector_face_right:
            mat = mat @ sps.kron(face_map.T, sps.eye(dim))
        if key in scalar_face_left:
            mat = (face_map @ mat).tocsr()
            rows = active_faces
            bs = 1
        elif key in vector_face_left:
            mat = (sps.kron(face_map, sps.eye(dim)) @ mat).tocsr()
            rows = active_faces
            bs = dim
        elif key in scalar_cell_left:
            mat = (cell_map @ mat).tocsr()
            rows = active_cells
            bs = 1
        else:
            return mat
        from porepy_tpu_torch.numerics.linalg.matrix_operations import zero_rows

        zero_rows(
            mat,
            (rows[:, None] * bs + np.arange(bs)[None]).ravel(),
        )
        return mat

    old = {
        key: mapped(key, val)
        for key, val in data[DISCRETIZATION_MATRICES][keyword].items()
    }

    if not (mod_cells.size or mod_faces.size):
        # Pure renumbering: the mapped matrices ARE the update.
        data[DISCRETIZATION_MATRICES][keyword].update(old)
        return

    param = data[PARAMETERS][keyword]
    if mod_cells.size:
        param["specified_cells"] = mod_cells
    if mod_faces.size:
        param["specified_faces"] = mod_faces
    try:
        discretize(sd, data)
    finally:
        param.pop("specified_cells", None)
        param.pop("specified_faces", None)

    new = data[DISCRETIZATION_MATRICES][keyword]
    for key in new:
        if key not in old:
            continue
        if isinstance(new[key], dict):
            new[key] = {
                k: (old[key][k] + v).tocsr() for k, v in new[key].items()
            }
        else:
            new[key] = (old[key] + new[key]).tocsr()


def subface_numbering(sd):
    """Canonical unique-subface numbering: subface ``j`` is the ``j``-th
    entry of ``sd.face_nodes`` in CSC (face-major) order, i.e. the (face,
    node) pair at position ``j`` of ``face_nodes.indices``. Identical to
    the reference's ``SubcellTopology.subfno_unique`` ids for non-periodic
    grids (reference ``numerics/fv/_fvutils.py:21-172``), so per-subface
    boundary conditions transfer one-to-one between the frameworks.

    Returns ``(fno, nno)``: face and node of each unique subface.
    """
    fn = sd.face_nodes.tocsc()
    fno = np.repeat(np.arange(sd.num_faces), np.diff(fn.indptr))
    return fno, fn.indices.copy()


def boundary_to_sub_boundary(bound, sd):
    """Expand a face-wise boundary condition to the unique subfaces of
    ``sd`` (reference ``_fvutils.boundary_to_sub_boundary:1465``). All
    per-face arrays are replicated onto the face's subfaces in the
    :func:`subface_numbering` order; the result can be edited per subface
    and passed to MPSA/MPFA for a subface-resolved discretization."""
    fno, _ = subface_numbering(sd)
    bound = bound.copy()
    bound.is_dir = np.atleast_2d(bound.is_dir)[:, fno].squeeze()
    bound.is_neu = np.atleast_2d(bound.is_neu)[:, fno].squeeze()
    bound.is_rob = np.atleast_2d(bound.is_rob)[:, fno].squeeze()
    bound.is_per = np.atleast_2d(bound.is_per)[:, fno].squeeze()
    if hasattr(bound, "is_internal"):
        bound.is_internal = np.atleast_2d(bound.is_internal)[:, fno].squeeze()
    if bound.robin_weight.ndim == 3:
        bound.robin_weight = bound.robin_weight[:, :, fno]
        bound.basis = bound.basis[:, :, fno]
    else:
        bound.robin_weight = bound.robin_weight[fno]
        bound.basis = bound.basis[fno]
    bound.num_faces = fno.size
    if hasattr(bound, "bf"):
        bound.bf = np.where(np.isin(fno, bound.bf))[0]
    return bound


def map_subface_to_face(sd, nd: int = 1):
    """Sparse ``(num_faces * nd, num_subfaces * nd)`` summation map from
    unique subfaces to faces (reference ``_fvutils.map_hf_2_f``)."""
    import scipy.sparse as sps

    fno, _ = subface_numbering(sd)
    if nd == 1:
        rows, cols = fno, np.arange(fno.size)
    else:
        rows = (fno[None] * nd + np.arange(nd)[:, None]).ravel()
        cols = (
            np.arange(fno.size)[None] * nd + np.arange(nd)[:, None]
        ).ravel()
    return sps.coo_matrix(
        (np.ones(rows.size), (rows, cols)),
        shape=(sd.num_faces * nd, fno.size * nd),
    ).tocsr()


def determine_eta(sd) -> float:
    """Default continuity-point parameter for MPFA/MPSA: 1/3 on simplex
    grids, 0 otherwise (reference ``_fvutils.determine_eta:280``)."""
    simplex_names = ("TriangleGrid", "TetrahedralGrid")
    name = type(sd).__name__
    history = " ".join(str(h) for h in getattr(sd, "history", []))
    if any(s in name or s in history for s in simplex_names):
        return 1.0 / 3.0
    return 0.0
