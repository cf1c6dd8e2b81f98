"""Multi-point flux approximation (MPFA-O), batched per interaction region.

Capability counterpart of reference ``numerics/fv/mpfa.py:16`` with a
different construction: instead of assembling one global block-diagonal
sparse system over subcell gradients (reference ``mpfa.py:592`` +
``_fvutils.py``'s exclusion operators), every grid vertex's interaction
region is built directly as a small dense linear system

    A_r g_r = B_r p_r + C_r u_r + E_r s_r

for the subcell pressure gradients ``g_r`` (``d`` unknowns per cell of the
region), given cell-centre pressures ``p_r``, boundary values ``u_r`` and
cell-wise vector sources ``s_r``. Rows are, per subface of the region:

* interior subface: flux continuity  ``sum_c sgn_cf (n~.K_c) g_c = ...``
  and pressure continuity at the continuity point
  ``x~ = fc + eta (x_v - fc)`` (``eta = 0`` on boundary faces);
* Neumann: ``sgn (n~.K) g = -u/nn + sgn (n~.K) s`` (``u`` is the total
  outward face flux, split evenly over the ``nn`` subfaces);
* Dirichlet: ``dist . g = u - p_c``;
* Robin: ``q_out + w (area/nn) p_trace = u/nn`` with weight ``w``.

The systems are solved sorted-and-padded in dense (B, n, n) batches on
device (``local_solves.solve_and_contract``), and the flux / pressure-trace
stencils are contracted on device in the same pass:

* subface flux (stored-normal direction): ``-(n~.K_c*) g_c*`` from one
  designated side (flux continuity makes the choice immaterial);
* subface pressure trace: mean over adjacent subcells of
  ``p_c + dist_c . g_c``.

Matrix contract (identical to the reference): ``flux``, ``bound_flux``,
``bound_pressure_cell``, ``bound_pressure_face``, ``vector_source``,
``bound_pressure_vector_source``; parity-tested to 1e-10 against the
reference on Cartesian/simplex/split grids with mixed BCs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sps

from porepy_tpu_torch.geometry import map_geometry
from porepy_tpu_torch.numerics.fv.local_solves import RegionBatches, solve_and_contract
from porepy_tpu_torch.numerics.fv.regions import build_regions, continuity_geometry
from porepy_tpu_torch.numerics.fv.fv_elliptic import FVElliptic
from porepy_tpu_torch.utils import common_constants as cc

__all__ = ["Mpfa"]


class Mpfa(FVElliptic):
    def __init__(self, keyword: str) -> None:
        self.keyword = keyword
        self.flux_matrix_key = "flux"
        self.bound_flux_matrix_key = "bound_flux"
        self.bound_pressure_cell_matrix_key = "bound_pressure_cell"
        self.bound_pressure_face_matrix_key = "bound_pressure_face"
        self.vector_source_matrix_key = "vector_source"
        self.bound_pressure_vector_source_matrix_key = "bound_pressure_vector_source"

    def ndof(self, sd) -> int:
        return sd.num_cells

    def discretize(self, sd, data: dict) -> None:
        param = data[cc.PARAMETERS][self.keyword]
        matrices = data[cc.DISCRETIZATION_MATRICES][self.keyword]
        k = param.get("second_order_tensor", None)
        bnd = param.get("bc", None)
        eta = param.get("mpfa_eta", None)
        vs_dim: int = param.get("ambient_dimension", sd.dim)

        if sd.dim == 0:
            matrices[self.flux_matrix_key] = sps.csr_matrix((0, sd.num_cells))
            matrices[self.bound_flux_matrix_key] = sps.csr_matrix((0, 0))
            matrices[self.bound_pressure_cell_matrix_key] = sps.csr_matrix(
                (0, sd.num_cells)
            )
            matrices[self.bound_pressure_face_matrix_key] = sps.csr_matrix((0, 0))
            matrices[self.vector_source_matrix_key] = sps.csr_matrix(
                (0, sd.num_cells * max(vs_dim, 1))
            )
            matrices[self.bound_pressure_vector_source_matrix_key] = sps.csr_matrix(
                (0, sd.num_cells * max(vs_dim, 1))
            )
            return

        from porepy_tpu_torch.numerics.fv._fvutils import restriction_from_params

        out = self._flux_discretization(
            sd,
            k,
            bnd,
            ambient_dimension=vs_dim,
            eta=eta,
            restrict=restriction_from_params(sd, param),
        )
        for key, mat in zip(
            (
                self.flux_matrix_key,
                self.bound_flux_matrix_key,
                self.bound_pressure_cell_matrix_key,
                self.bound_pressure_face_matrix_key,
                self.vector_source_matrix_key,
                self.bound_pressure_vector_source_matrix_key,
            ),
            out,
        ):
            matrices[key] = mat

    # -- core -----------------------------------------------------------------

    def update_discretization(self, sd, data: dict) -> None:
        """Partial update after a local modification (reference
        ``numerics/fv/mpfa.py:510``): only interaction regions whose
        contributions changed are re-assembled; unchanged rows are mapped
        through ``data['update_discretization']``'s index maps."""
        from porepy_tpu_torch.numerics.fv._fvutils import (
            partial_update_discretization,
        )

        vs_dim = data[cc.PARAMETERS][self.keyword].get(
            "ambient_dimension", sd.dim
        )
        partial_update_discretization(
            sd,
            data,
            self.keyword,
            self.discretize,
            dim=vs_dim,
            scalar_cell_right=(
                self.flux_matrix_key,
                self.bound_pressure_cell_matrix_key,
            ),
            vector_cell_right=(
                self.vector_source_matrix_key,
                self.bound_pressure_vector_source_matrix_key,
            ),
            scalar_face_right=(
                self.bound_flux_matrix_key,
                self.bound_pressure_face_matrix_key,
            ),
            scalar_face_left=(
                self.flux_matrix_key,
                self.bound_flux_matrix_key,
                self.vector_source_matrix_key,
                self.bound_pressure_vector_source_matrix_key,
                self.bound_pressure_cell_matrix_key,
                self.bound_pressure_face_matrix_key,
            ),
        )

    def _flux_discretization(
        self,
        sd,
        k,
        bnd,
        ambient_dimension: Optional[int] = None,
        eta: Optional[float] = None,
        restrict=None,
    ):
        if ambient_dimension is None:
            ambient_dimension = sd.dim

        if sd.dim == 1:
            # One-dimensional MPFA coincides with TPFA.
            from porepy_tpu_torch.numerics.fv.tpfa import Tpfa
            from porepy_tpu_torch.params.data import initialize_data

            d: dict = {}
            initialize_data(
                d,
                self.keyword,
                {
                    "bc": bnd,
                    "second_order_tensor": k,
                    "ambient_dimension": ambient_dimension,
                },
            )
            Tpfa(self.keyword).discretize(sd, d)
            md = d[cc.DISCRETIZATION_MATRICES][self.keyword]
            out = (
                md["flux"],
                md["bound_flux"],
                md["bound_pressure_cell"],
                md["bound_pressure_face"],
                md["vector_source"],
                md["bound_pressure_vector_source"],
            )
            if restrict is not None:
                # TPFA is cheap enough to recompute in full; the partial
                # contract still wants zero rows off the active faces.
                from porepy_tpu_torch.numerics.linalg.matrix_operations import (
                    zero_rows,
                )

                _nodes, active_faces, _cells = restrict
                keep = np.zeros(sd.num_faces, dtype=bool)
                keep[active_faces] = True
                drop = np.flatnonzero(~keep)
                out = tuple(m.tocsr() for m in out)
                for m in out:
                    zero_rows(m, drop)
                    m.eliminate_zeros()
            return out

        d = sd.dim
        rot = None
        if d == 2:
            # Work in the plane of the grid; rotate permeability along.
            sd = sd.copy()
            cc_r, fn_r, fc_r, rot, dims, nodes_r = map_geometry.map_grid(sd)
            sd.cell_centers = cc_r
            sd.face_normals = fn_r
            sd.face_centers = fc_r
            sd.nodes = nodes_r
            kv = np.tensordot(rot.T, np.tensordot(rot, k.values, (1, 0)), (0, 1))
            kv = kv[:2][:, :2]
        else:
            kv = k.values
            dims = None

        if eta is None:
            from porepy_tpu_torch.numerics.fv._fvutils import determine_eta

            eta = determine_eta(sd)

        mats = _assemble_mpfa(sd, kv, bnd, float(eta), d, restrict=restrict)
        (flux, bound_flux, bp_cell, bp_face, vs_loc, bp_vs_loc) = mats

        # Map the vector-source columns from the grid-local frame to the
        # ambient frame (2d grids embedded in 3d, or true-2d domains).
        if d == 2:
            glob_R = _rotation_expansion(rot, dims, sd.num_cells, ambient_dimension)
            vs = vs_loc @ glob_R
            bp_vs = bp_vs_loc @ glob_R
        else:
            vs = vs_loc
            bp_vs = bp_vs_loc

        return (
            flux.tocsr(),
            bound_flux.tocsr(),
            bp_cell.tocsr(),
            bp_face.tocsr(),
            vs.tocsr(),
            bp_vs.tocsr(),
        )


def _rotation_expansion(rot, dims, num_cells, ambient_dimension):
    """Block-diagonal per-cell map from ambient vector-source components to
    the grid-local (in-plane) components used by the local systems."""
    r_sel = rot[np.flatnonzero(dims)]  # (d_local, 3)
    if ambient_dimension == r_sel.shape[0]:
        r_sel = r_sel[:, np.flatnonzero(dims)]
    else:
        r_sel = r_sel[:, :ambient_dimension]
    d_loc, d_amb = r_sel.shape
    li, aj = np.meshgrid(np.arange(d_loc), np.arange(d_amb), indexing="ij")
    cells = np.arange(num_cells)
    rows = (cells[:, None, None] * d_loc + li).ravel()
    cols = (cells[:, None, None] * d_amb + aj).ravel()
    vals = np.broadcast_to(r_sel, (num_cells, d_loc, d_amb)).ravel()
    return sps.coo_matrix(
        (vals, (rows, cols)), shape=(num_cells * d_loc, num_cells * d_amb)
    ).tocsr()


def _assemble_mpfa(sd, kv, bnd, eta, d, restrict=None):
    """Build, solve and scatter all interaction regions.

    ``kv``: (d, d, nc) permeability in the grid-local frame.
    ``restrict``: optional ``(nodes_needed, active_faces)`` partial-update
    closure — only those regions are assembled and only active-face rows
    are produced. Returns the six matrices with vector-source columns in
    the local frame.
    """
    nc, nf = sd.num_cells, sd.num_faces
    # Subface-resolved boundary conditions: a BC sized to the unique
    # subfaces (``_fvutils.subface_numbering`` order) switches types,
    # values and output granularity to subfaces — mirrors MPSA's subface
    # mode (reference ``numerics/fv/mpfa.py:767``, ``subface_rhs``).
    n_subf = int(sd.face_nodes.nnz)
    subface_mode = bnd.num_faces == n_subf and n_subf != nf
    if subface_mode and restrict is not None:
        raise NotImplementedError(
            "Partial rediscretization with subface-resolved boundary "
            "conditions is not supported"
        )
    if subface_mode:
        rt = build_regions(
            sd,
            is_neu=np.ones(nf, dtype=bool),  # overridden per subface below
            is_dir=np.zeros(nf, dtype=bool),
            is_rob=np.zeros(nf, dtype=bool),
        )
    else:
        rt = build_regions(
            sd,
            is_neu=bnd.is_neu | bnd.is_internal,
            is_dir=bnd.is_dir & ~bnd.is_internal,
            is_rob=bnd.is_rob & ~bnd.is_internal,
        )
    if restrict is not None:
        from porepy_tpu_torch.numerics.fv.regions import subset_regions

        nodes_needed, active_faces, _active_cells = restrict
        rt = subset_regions(
            rt, np.flatnonzero(np.isin(rt.r_node, nodes_needed))
        )
    if subface_mode:
        from porepy_tpu_torch.numerics.fv._fvutils import subface_numbering

        fno_u, nno_u = subface_numbering(sd)
        ref_code = nno_u.astype(np.int64) * nf + fno_u
        ref_order = np.argsort(ref_code)
        sf_ent = ref_order[
            np.searchsorted(
                ref_code[ref_order],
                rt.sf_v.astype(np.int64) * nf + rt.sf_f,
            )
        ]
        # All BC arrays (incl. is_internal) are subface-sized here.
        is_int = np.asarray(bnd.is_internal)[sf_ent]
        bnd_sub = ~rt.sf_interior
        rt.sf_neu[:] = bnd_sub & (np.asarray(bnd.is_neu)[sf_ent] | is_int)
        rt.sf_dir[:] = bnd_sub & np.asarray(bnd.is_dir)[sf_ent] & ~is_int
        rt.sf_rob[:] = bnd_sub & np.asarray(bnd.is_rob)[sf_ent] & ~is_int
        if not np.all(
            rt.sf_interior | rt.sf_neu | rt.sf_dir | rt.sf_rob
        ):
            raise ValueError(
                "Boundary subfaces must be Dirichlet, Neumann or Robin"
            )
    else:
        sf_ent = rt.sf_f
    (t_c, t_f, t_sgn, t_r, t_sf, t_loc_cell, t_row, first_inc) = (
        rt.t_c, rt.t_f, rt.t_sgn, rt.t_r, rt.t_sf, rt.t_loc_cell, rt.t_row,
        rt.first_inc,
    )
    (sf_f, sf_cnt, sf_start, sf_prow, sf_bcol) = (
        rt.sf_f, rt.sf_cnt, rt.sf_start, rt.sf_prow, rt.sf_bcol,
    )
    (R, nc_r, nsf_r, nint_r, nb_r, nnpf) = (
        rt.R, rt.nc_r, rt.nsf_r, rt.nint_r, rt.nb_r, rt.nnpf,
    )
    sc_c, sc_start, bnd_idx, b_start = rt.sc_c, rt.sc_start, rt.bnd_idx, rt.b_start

    n_r = d * nc_r  # unknowns per region
    if not np.all(nsf_r + nint_r == n_r):
        raise ValueError("MPFA local systems are not square on this grid")
    m_r = nc_r + nb_r + d * nc_r  # RHS cols: cells | bc | vector source
    q_r = 2 * nsf_r  # out rows: flux stencils | trace stencils

    # -- per-incidence geometry/algebra --------------------------------------
    w, n_tilde, dist = continuity_geometry(sd, rt, eta, d)
    nk = np.einsum("it,ijt->jt", n_tilde, kv[:, :, t_c])  # (d, T) n~.K_c

    t_gcols = d * t_loc_cell[None, :] + np.arange(d)[:, None]  # (d, T)
    t_type_int = rt.sf_interior[t_sf]
    t_type_neu = rt.sf_neu[t_sf]
    t_type_dir = rt.sf_dir[t_sf]
    t_type_rob = rt.sf_rob[t_sf]

    # Robin weight indexed per BC entity (face, or canonical subface id in
    # subface mode — ``sf_ent[t_sf] == t_f`` in face mode).
    rob_w = bnd.robin_weight[sf_ent[t_sf]] * sd.face_areas[t_f] * w
    # Neumann/Robin RHS coefficient: face-integrated values split over the
    # subfaces (w) in face mode; subface-integrated values as-is otherwise.
    bc_w = np.ones_like(w) if subface_mode else w

    a_reg, a_row, a_col, a_val = [], [], [], []
    r_reg, r_row, r_col, r_val = [], [], [], []

    def add_a(mask, rows, cols, vals):
        a_reg.append(np.broadcast_to(t_r[mask], cols[:, mask].shape).ravel())
        a_row.append(np.broadcast_to(rows[mask], cols[:, mask].shape).ravel())
        a_col.append(cols[:, mask].ravel())
        a_val.append(vals[:, mask].ravel())

    def add_rhs(mask, rows, cols, vals):
        r_reg.append(t_r[mask])
        r_row.append(rows[mask])
        r_col.append(cols[mask])
        r_val.append(vals[mask])

    # Flux-type rows: interior continuity + Neumann + Robin flux part.
    fluxish = t_type_int | t_type_neu | t_type_rob
    add_a(fluxish, t_row, t_gcols, t_sgn * nk)
    # Robin adds -w_A * dist to the gradient coefficients.
    add_a(t_type_rob, t_row, t_gcols, -rob_w * dist)
    # Dirichlet rows: dist . g.
    add_a(t_type_dir, t_row, t_gcols, dist)
    # Pressure-continuity rows (interior incidences only).
    t_prow = sf_prow[t_sf]
    add_a(t_type_int, t_prow, t_gcols, t_sgn * dist)

    # RHS, cell-pressure columns.
    add_rhs(t_type_int, t_prow, t_loc_cell, -t_sgn)
    add_rhs(t_type_dir, t_row, t_loc_cell, -np.ones(t_f.size))
    add_rhs(t_type_rob, t_row, t_loc_cell, rob_w)
    # RHS, boundary-value columns (per-region offset nc_r).
    t_bcol = nc_r[t_r] + sf_bcol[t_sf]
    add_rhs(t_type_dir, t_row, t_bcol, np.ones(t_f.size))
    add_rhs(t_type_neu | t_type_rob, t_row, t_bcol, -bc_w)
    # RHS, vector-source columns (cell-major, d per local cell).
    vs_cols = nc_r[t_r] + nb_r[t_r] + t_gcols  # (d, T)
    vsel = fluxish
    r_reg.append(np.broadcast_to(t_r[vsel], vs_cols[:, vsel].shape).ravel())
    r_row.append(np.broadcast_to(t_row[vsel], vs_cols[:, vsel].shape).ravel())
    r_col.append(vs_cols[:, vsel].ravel())
    r_val.append((t_sgn * nk)[:, vsel].ravel())

    # -- output contractions ---------------------------------------------------
    # Designated incidence per subface = first in (v, f, c) order.
    first_inc = np.zeros(t_f.size, dtype=bool)
    first_inc[np.unique(t_sf, return_index=True)[1]] = True

    w_reg, w_row, w_col, w_val = [], [], [], []
    # Flux stencil rows: -(n~.K) g from the designated side.
    w_reg.append(np.broadcast_to(t_r[first_inc], (d, int(first_inc.sum()))).ravel())
    w_row.append(np.broadcast_to(t_row[first_inc], (d, int(first_inc.sum()))).ravel())
    w_col.append(t_gcols[:, first_inc].ravel())
    w_val.append(-nk[:, first_inc].ravel())
    # Trace stencil rows: mean over incidences of dist . g.
    trace_row = nsf_r[t_r] + t_row
    inv_cnt = 1.0 / sf_cnt[t_sf]
    w_reg.append(np.broadcast_to(t_r, (d, t_f.size)).ravel())
    w_row.append(np.broadcast_to(trace_row, (d, t_f.size)).ravel())
    w_col.append(t_gcols.ravel())
    w_val.append((inv_cnt * dist).ravel())

    rb = RegionBatches(
        n=n_r,
        m=m_r,
        q=q_r,
        a_region=np.concatenate(a_reg),
        a_row=np.concatenate(a_row),
        a_col=np.concatenate(a_col),
        a_val=np.concatenate(a_val),
        rhs_region=np.concatenate(r_reg),
        rhs_row=np.concatenate(r_row),
        rhs_col=np.concatenate(r_col),
        rhs_val=np.concatenate(r_val),
        w_region=np.concatenate(w_reg),
        w_row=np.concatenate(w_row),
        w_col=np.concatenate(w_col),
        w_val=np.concatenate(w_val),
    )
    o_reg, o_row, o_col, o_val = solve_and_contract(rb)

    # -- globalize --------------------------------------------------------------
    # Row decode: flux stencil vs trace stencil, and the subface's face.
    is_trace = o_row >= nsf_r[o_reg]
    sf_of_out = sf_start[o_reg] + np.where(is_trace, o_row - nsf_r[o_reg], o_row)
    face_of_out = sf_f[sf_of_out]
    ent_of_out = sf_ent[sf_of_out]  # == face_of_out in face mode
    # Column decode: cell | boundary face | vector source.
    col_cell = o_col < nc_r[o_reg]
    col_bc = ~col_cell & (o_col < nc_r[o_reg] + nb_r[o_reg])
    col_vs = ~col_cell & ~col_bc

    cell_table = sc_c  # indexed by sc_start[region] + local cell
    bc_faces = sf_ent[bnd_idx]  # indexed by b_start[region] + local bc col
    n_rent = n_subf if subface_mode else nf  # flux-row / bound-col entities

    # Weights: flux rows sum over subfaces; trace rows average (1/nn).
    row_w = np.where(is_trace, 1.0 / nnpf[face_of_out], 1.0)

    def build(sel, ncols, cols, rows, nrows):
        return sps.coo_matrix(
            (o_val[sel] * row_w[sel], (rows[sel], cols)),
            shape=(nrows, ncols),
        )

    sel = ~is_trace & col_cell
    flux = build(
        sel, nc, cell_table[sc_start[o_reg[sel]] + o_col[sel]],
        ent_of_out, n_rent,
    )
    sel = ~is_trace & col_bc
    bound_flux = build(
        sel, n_rent,
        bc_faces[b_start[o_reg[sel]] + o_col[sel] - nc_r[o_reg[sel]]],
        ent_of_out, n_rent,
    )
    sel = ~is_trace & col_vs
    k_loc = o_col[sel] - nc_r[o_reg[sel]] - nb_r[o_reg[sel]]
    vs_gcol = cell_table[sc_start[o_reg[sel]] + k_loc // d] * d + k_loc % d
    vector_source = build(sel, nc * d, vs_gcol, ent_of_out, n_rent)

    sel = is_trace & col_cell
    bp_cell = build(
        sel, nc, cell_table[sc_start[o_reg[sel]] + o_col[sel]],
        face_of_out, nf,
    )
    sel = is_trace & col_bc
    bp_face = build(
        sel, n_rent,
        bc_faces[b_start[o_reg[sel]] + o_col[sel] - nc_r[o_reg[sel]]],
        face_of_out, nf,
    )
    sel = is_trace & col_vs
    k_loc = o_col[sel] - nc_r[o_reg[sel]] - nb_r[o_reg[sel]]
    vs_gcol = cell_table[sc_start[o_reg[sel]] + k_loc // d] * d + k_loc % d
    bp_vs = build(sel, nc * d, vs_gcol, face_of_out, nf)

    # Direct terms outside the local solves.
    # Flux from the vector source on the designated side: +(n~.K) s.
    fi = np.flatnonzero(first_inc)
    t_ent = sf_ent[t_sf]
    direct_vs = sps.coo_matrix(
        (
            nk[:, fi].ravel(),
            (
                np.broadcast_to(t_ent[fi], (d, fi.size)).ravel(),
                (d * t_c[fi][None, :] + np.arange(d)[:, None]).ravel(),
            ),
        ),
        shape=(n_rent, nc * d),
    )
    vector_source = vector_source + direct_vs
    # Trace: the cell-pressure part of p_c + dist.g, averaged as the stencil.
    direct_pc = sps.coo_matrix(
        (inv_cnt / nnpf[t_f], (t_f, t_c)), shape=(nf, nc)
    )
    bp_cell = bp_cell + direct_pc

    out = (flux, bound_flux, bp_cell, bp_face, vector_source, bp_vs)
    if restrict is not None:
        # Rim faces of the assembled region set have partial rows; the
        # update contract is full rows exactly on the active faces.
        from porepy_tpu_torch.numerics.linalg.matrix_operations import zero_rows

        keep = np.zeros(nf, dtype=bool)
        keep[active_faces] = True
        drop = np.flatnonzero(~keep)
        out = tuple(m.tocsr() for m in out)
        for m in out:
            zero_rows(m, drop)
            m.eliminate_zeros()
    return out
