"""Interaction-region topology shared by the multi-point FV kernels.

Builds, from a grid's incidence matrices, the flat index arrays describing
every vertex-centred interaction region: its subcells (cell, node) and
subfaces (face, node), local numberings, and boundary classification. Pure
integer numpy, computed once per grid; consumed by the batched MPFA/MPSA
assemblers (capability counterpart of the reference's ``SubcellTopology`` /
``ExcludeBoundaries`` pair in ``numerics/fv/_fvutils.py:21,765``, organised
per region instead of per global exclusion operator).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from porepy_tpu_torch.utils.array_operations import expand_index_pointers

__all__ = [
    "RegionTopology",
    "build_regions",
    "slice_regions",
    "subset_regions",
    "region_blocks",
]


@dataclass
class RegionTopology:
    # Incidence triples (one per (cell, face, node)), sorted by (v, f, c).
    t_c: np.ndarray  # cell
    t_f: np.ndarray  # face
    t_v: np.ndarray  # node
    t_sgn: np.ndarray  # cell_faces sign of (f, c)
    t_r: np.ndarray  # region id
    t_sc: np.ndarray  # subcell id
    t_sf: np.ndarray  # subface id
    t_loc_cell: np.ndarray  # local cell index within region
    t_row: np.ndarray  # local (scalar) primary-equation row = subface index
    first_inc: np.ndarray  # bool: designated incidence of its subface

    # Subcells, sorted by region.
    sc_c: np.ndarray
    sc_start: np.ndarray  # region -> offset into sc arrays

    # Subfaces, sorted by region.
    sf_f: np.ndarray
    sf_v: np.ndarray  # node of the subface
    sf_r: np.ndarray
    sf_cnt: np.ndarray  # 1 or 2 incidences
    sf_start: np.ndarray
    sf_loc: np.ndarray
    sf_interior: np.ndarray
    sf_neu: np.ndarray
    sf_dir: np.ndarray
    sf_rob: np.ndarray
    sf_prow: np.ndarray  # continuity-row index (interior only, else -1)
    sf_bcol: np.ndarray  # boundary-column index (boundary only, else -1)
    bnd_idx: np.ndarray  # indices of boundary subfaces
    b_start: np.ndarray

    # Per-region counts.
    R: int
    nc_r: np.ndarray
    nsf_r: np.ndarray
    nint_r: np.ndarray
    nb_r: np.ndarray

    # Grid-level helpers.
    nnpf: np.ndarray  # nodes per face
    r_node: np.ndarray = None  # grid node id of each region


def build_regions(sd, is_neu, is_dir, is_rob) -> RegionTopology:
    """Region topology with scalar per-face boundary classification.

    ``is_neu/is_dir/is_rob``: per-face masks (internal faces already folded
    into Neumann by the caller). For vector problems the caller refines the
    per-component classification afterwards.
    """
    nc, nf = sd.num_cells, sd.num_faces
    fn = sd.face_nodes.tocsc()
    cf = sd.cell_faces.tocsc()
    nnpf = np.diff(fn.indptr)

    cf_f = cf.indices
    cf_c = np.repeat(np.arange(nc), np.diff(cf.indptr))
    cf_sgn = np.asarray(cf.data, dtype=float)
    rep = nnpf[cf_f]
    t_c = np.repeat(cf_c, rep)
    t_f = np.repeat(cf_f, rep)
    t_sgn = np.repeat(cf_sgn, rep)
    t_v = fn.indices[expand_index_pointers(fn.indptr[cf_f], fn.indptr[cf_f + 1])]

    order = np.lexsort((t_c, t_f, t_v))
    t_c, t_f, t_sgn, t_v = t_c[order], t_f[order], t_sgn[order], t_v[order]

    sc_code = t_v.astype(np.int64) * nc + t_c
    sc_codes, t_sc = np.unique(sc_code, return_inverse=True)
    sc_v, sc_c = sc_codes // nc, sc_codes % nc
    sf_code = t_v.astype(np.int64) * nf + t_f
    sf_codes, t_sf = np.unique(sf_code, return_inverse=True)
    sf_v, sf_f = sf_codes // nf, sf_codes % nf
    n_sf_tot = sf_codes.size

    nodes, sc_r = np.unique(sc_v, return_inverse=True)
    R = nodes.size
    sf_r = np.searchsorted(nodes, sf_v)
    t_r = np.searchsorted(nodes, t_v)

    nc_r = np.bincount(sc_r, minlength=R)
    sc_start = np.concatenate([[0], np.cumsum(nc_r)])
    sc_loc = np.arange(sc_codes.size) - sc_start[sc_r]

    nsf_r = np.bincount(sf_r, minlength=R)
    sf_start = np.concatenate([[0], np.cumsum(nsf_r)])
    sf_loc = np.arange(n_sf_tot) - sf_start[sf_r]
    sf_cnt = np.bincount(t_sf, minlength=n_sf_tot)

    sf_interior = sf_cnt == 2
    sf_neu = ~sf_interior & is_neu[sf_f]
    sf_dir = ~sf_interior & is_dir[sf_f]
    sf_rob = ~sf_interior & is_rob[sf_f]
    if not np.all(sf_interior | sf_neu | sf_dir | sf_rob):
        raise ValueError("Boundary subfaces must be Dirichlet, Neumann or Robin")

    int_idx = np.flatnonzero(sf_interior)
    nint_r = np.bincount(sf_r[int_idx], minlength=R)
    int_start = np.concatenate([[0], np.cumsum(nint_r)])
    int_loc = np.arange(int_idx.size) - int_start[sf_r[int_idx]]
    sf_prow = np.full(n_sf_tot, -1, dtype=np.int64)
    sf_prow[int_idx] = nsf_r[sf_r[int_idx]] + int_loc

    bnd_idx = np.flatnonzero(~sf_interior)
    nb_r = np.bincount(sf_r[bnd_idx], minlength=R)
    b_start = np.concatenate([[0], np.cumsum(nb_r)])
    sf_bcol = np.full(n_sf_tot, -1, dtype=np.int64)
    sf_bcol[bnd_idx] = np.arange(bnd_idx.size) - b_start[sf_r[bnd_idx]]

    first_inc = np.zeros(t_f.size, dtype=bool)
    first_inc[np.unique(t_sf, return_index=True)[1]] = True

    return RegionTopology(
        t_c=t_c,
        t_f=t_f,
        t_v=t_v,
        t_sgn=t_sgn,
        t_r=t_r,
        t_sc=t_sc,
        t_sf=t_sf,
        t_loc_cell=sc_loc[t_sc],
        t_row=sf_loc[t_sf],
        first_inc=first_inc,
        sc_c=sc_c,
        sc_start=sc_start,
        sf_f=sf_f,
        sf_v=sf_v,
        sf_r=sf_r,
        sf_cnt=sf_cnt,
        sf_start=sf_start,
        sf_loc=sf_loc,
        sf_interior=sf_interior,
        sf_neu=sf_neu,
        sf_dir=sf_dir,
        sf_rob=sf_rob,
        sf_prow=sf_prow,
        sf_bcol=sf_bcol,
        bnd_idx=bnd_idx,
        b_start=b_start,
        R=R,
        nc_r=nc_r,
        nsf_r=nsf_r,
        nint_r=nint_r,
        nb_r=nb_r,
        nnpf=nnpf,
        r_node=nodes,
    )


def region_blocks(rt: RegionTopology, max_incidences: int) -> list:
    """Split the region range into ``[r0, r1)`` blocks of at most
    ``max_incidences`` incidence triples each (at least one region per
    block). Incidences are region-sorted, so blocks slice contiguously."""
    blocks = []
    r0 = 0
    t_per_r = np.bincount(rt.t_r, minlength=rt.R)
    csum = np.concatenate([[0], np.cumsum(t_per_r)])
    while r0 < rt.R:
        r1 = int(np.searchsorted(csum, csum[r0] + max_incidences, "right")) - 1
        r1 = max(r1, r0 + 1)
        blocks.append((r0, min(r1, rt.R)))
        r0 = min(r1, rt.R)
    return blocks


def slice_regions(rt: RegionTopology, r0: int, r1: int) -> RegionTopology:
    """Restrict the topology to regions ``[r0, r1)`` with region ids
    renumbered to ``0..r1-r0``. Entity-valued fields (``t_c``, ``sf_f``,
    ``sc_c``, ``sf_v``, ``nnpf``) keep their GLOBAL ids so block outputs
    globalize directly; region-local index fields need no change. Used to
    bound host memory: MPSA/MPFA assemble, solve and globalize one block
    at a time (the reference's memory-bounded subproblem partitioning,
    reference ``numerics/fv/mpfa.py:150-300``)."""
    if r0 == 0 and r1 >= rt.R:
        return rt
    t0, t1 = np.searchsorted(rt.t_r, [r0, r1])
    s0, s1 = rt.sc_start[r0], rt.sc_start[r1]
    f0, f1 = rt.sf_start[r0], rt.sf_start[r1]
    b0, b1 = rt.b_start[r0], rt.b_start[r1]
    bnd_idx = rt.bnd_idx[b0:b1] - f0
    sf_prow = rt.sf_prow[f0:f1]
    sf_bcol = rt.sf_bcol[f0:f1]
    return RegionTopology(
        t_c=rt.t_c[t0:t1],
        t_f=rt.t_f[t0:t1],
        t_v=rt.t_v[t0:t1],
        t_sgn=rt.t_sgn[t0:t1],
        t_r=rt.t_r[t0:t1] - r0,
        t_sc=rt.t_sc[t0:t1] - s0,
        t_sf=rt.t_sf[t0:t1] - f0,
        t_loc_cell=rt.t_loc_cell[t0:t1],
        t_row=rt.t_row[t0:t1],
        first_inc=rt.first_inc[t0:t1],
        sc_c=rt.sc_c[s0:s1],
        sc_start=rt.sc_start[r0 : r1 + 1] - s0,
        sf_f=rt.sf_f[f0:f1],
        sf_v=rt.sf_v[f0:f1],
        sf_r=rt.sf_r[f0:f1] - r0,
        sf_cnt=rt.sf_cnt[f0:f1],
        sf_start=rt.sf_start[r0 : r1 + 1] - f0,
        sf_loc=rt.sf_loc[f0:f1],
        sf_interior=rt.sf_interior[f0:f1],
        sf_neu=rt.sf_neu[f0:f1],
        sf_dir=rt.sf_dir[f0:f1],
        sf_rob=rt.sf_rob[f0:f1],
        sf_prow=sf_prow,
        sf_bcol=sf_bcol,
        bnd_idx=bnd_idx,
        b_start=rt.b_start[r0 : r1 + 1] - b0,
        R=int(r1 - r0),
        nc_r=rt.nc_r[r0:r1],
        nsf_r=rt.nsf_r[r0:r1],
        nint_r=rt.nint_r[r0:r1],
        nb_r=rt.nb_r[r0:r1],
        nnpf=rt.nnpf,
        r_node=rt.r_node[r0:r1] if rt.r_node is not None else None,
    )


def subset_regions(rt: RegionTopology, sel: np.ndarray) -> RegionTopology:
    """Restrict the topology to an arbitrary sorted array of region ids,
    renumbered to ``0..len(sel)``. Entity-valued fields keep global ids
    (like :func:`slice_regions`). Basis of partial rediscretization: only
    the regions whose stencil contributions changed are re-assembled
    (reference ``_fvutils.partial_update_discretization:1090``)."""
    sel = np.asarray(sel, dtype=np.int64)
    if sel.size == rt.R:
        return rt
    t_start = np.searchsorted(rt.t_r, np.arange(rt.R + 1))
    t_idx = expand_index_pointers(t_start[sel], t_start[sel + 1])
    sf_idx = expand_index_pointers(rt.sf_start[sel], rt.sf_start[sel + 1])
    sc_idx = expand_index_pointers(rt.sc_start[sel], rt.sc_start[sel + 1])
    b_idx = expand_index_pointers(rt.b_start[sel], rt.b_start[sel + 1])
    sf_map = np.full(rt.sf_f.size, -1, dtype=np.int64)
    sf_map[sf_idx] = np.arange(sf_idx.size)
    sc_map = np.full(rt.sc_c.size, -1, dtype=np.int64)
    sc_map[sc_idx] = np.arange(sc_idx.size)
    nc_r = rt.nc_r[sel]
    nsf_r = rt.nsf_r[sel]
    nb_r = rt.nb_r[sel]
    return RegionTopology(
        t_c=rt.t_c[t_idx],
        t_f=rt.t_f[t_idx],
        t_v=rt.t_v[t_idx],
        t_sgn=rt.t_sgn[t_idx],
        t_r=np.searchsorted(sel, rt.t_r[t_idx]),
        t_sc=sc_map[rt.t_sc[t_idx]],
        t_sf=sf_map[rt.t_sf[t_idx]],
        t_loc_cell=rt.t_loc_cell[t_idx],
        t_row=rt.t_row[t_idx],
        first_inc=rt.first_inc[t_idx],
        sc_c=rt.sc_c[sc_idx],
        sc_start=np.concatenate([[0], np.cumsum(nc_r)]),
        sf_f=rt.sf_f[sf_idx],
        sf_v=rt.sf_v[sf_idx],
        sf_r=np.searchsorted(sel, rt.sf_r[sf_idx]),
        sf_cnt=rt.sf_cnt[sf_idx],
        sf_start=np.concatenate([[0], np.cumsum(nsf_r)]),
        sf_loc=rt.sf_loc[sf_idx],
        sf_interior=rt.sf_interior[sf_idx],
        sf_neu=rt.sf_neu[sf_idx],
        sf_dir=rt.sf_dir[sf_idx],
        sf_rob=rt.sf_rob[sf_idx],
        sf_prow=rt.sf_prow[sf_idx],
        sf_bcol=rt.sf_bcol[sf_idx],
        bnd_idx=sf_map[rt.bnd_idx[b_idx]],
        b_start=np.concatenate([[0], np.cumsum(nb_r)]),
        R=int(sel.size),
        nc_r=nc_r,
        nsf_r=nsf_r,
        nint_r=rt.nint_r[sel],
        nb_r=nb_r,
        nnpf=rt.nnpf,
        r_node=rt.r_node[sel] if rt.r_node is not None else None,
    )


def continuity_geometry(sd, rt: RegionTopology, eta: float, d: int):
    """Per-incidence subface normal share, continuity-point distance and
    subface weight. ``eta`` is forced to zero on boundary faces (reference
    ``_fvutils.compute_dist_face_cell:230``)."""
    w = 1.0 / rt.nnpf[rt.t_f]
    n_tilde = sd.face_normals[:d, rt.t_f] * w
    eta_vec = np.full(rt.t_f.size, float(eta))
    eta_vec[np.isin(rt.t_f, sd.get_all_boundary_faces())] = 0.0
    x_cont = sd.face_centers[:d, rt.t_f] + eta_vec * (
        sd.nodes[:d, rt.t_v] - sd.face_centers[:d, rt.t_f]
    )
    dist = x_cont - sd.cell_centers[:d, rt.t_c]
    return w, n_tilde, dist
