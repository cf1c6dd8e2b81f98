"""Multi-point stress approximation (MPSA-W), batched per interaction region.

Capability counterpart of reference ``numerics/fv/mpsa.py:30`` (the weakly
symmetric method of Keilegavlen 2017), built like this package's MPFA: every
grid vertex's interaction region is a small dense system assembled directly
from per-incidence coefficients and solved sorted-and-padded on device
(``local_solves``), instead of the reference's global block-diagonal sparse
construction with exclusion operators.

Unknowns per region: one displacement gradient ``G_c`` (d x d) per subcell,
plus one *auxiliary averaged gradient* ``Gbar`` carrying the weak-symmetry
volume average ``Gbar = sum_s w_s G_s`` (``w_s = V_s / sum V``). The
reference realizes the same average by dense row couplings
(``mpsa.py:1620``); the auxiliary unknown keeps the local systems sparse and
is mathematically identical.

Rows per subface and displacement component ``i``:

* interior: traction continuity ``sum_c sgn (n~.Csym_c : G_c)_i = 0``
  (asymmetric parts cancel in the pairing by construction) and displacement
  continuity at the continuity point;
* Neumann: ``sgn (n~.(Csym:G_c + Casym:Gbar))_i = w u_i`` (value = total
  face traction as seen from outside, split over the ``nn`` subfaces);
* Dirichlet: ``(u_c + G_c . dist)_i = u_i``;
* Robin: traction + ``(area w) [W (u_c + G.dist)]_i = w u_i``;
* the ``Gbar`` defining rows.

Per-component boundary types and per-face basis transforms of the vectorial
boundary condition are honoured by left-applying the basis to the condition
rows. The asymmetric (averaged) contribution is dropped on subfaces of
nodes where Neumann/Robin component counts exceed the gradient count (the
reference's ``_eliminate_ncasym`` invertibility guard).

Subface-resolved boundary conditions: a ``BoundaryConditionVectorial``
sized to the unique subfaces (``_fvutils.subface_numbering`` order; build
one with ``_fvutils.boundary_to_sub_boundary``) switches types, values and
output granularity to subfaces — ``stress``/``bound_stress`` rows and
boundary columns are per subface, Neumann values are subface-integrated
tractions. Capability counterpart of the reference's ``subface_rhs``
branch (reference ``numerics/fv/mpsa.py:715-754``), which in v1.11 crashes
for any Dirichlet subface and silently degrades to face output for
all-Neumann input; correctness here is established by face-mode
consistency and analytic patch tests instead
(``tests/numerics/fv/test_mpsa.py``).

Memory bound: regions are assembled, solved and globalized in BLOCKS of
bounded incidence count, and the scattered outputs are folded into CSR
accumulators under a fixed pending budget — the host high-water mark is
final-stencil-sized plus one block, independent of grid size (the
reference's memory-bounded subproblem partitioning, reference
``numerics/fv/mpfa.py:150-300``).

Outputs: ``stress``/``bound_stress`` stencils from the designated side of
each subface (summed to faces) and the displacement-trace reconstruction
``bound_displacement_cell``/``bound_displacement_face`` (averaged over
subfaces). The Biot subclass extends the same pass with pressure columns
and divergence rows (see ``biot.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sps

from porepy_tpu_torch.geometry import map_geometry
from porepy_tpu_torch.numerics.fv.local_solves import (
    RegionBatches,
    iter_solve_and_contract,
)
from porepy_tpu_torch.numerics.fv.regions import (
    build_regions,
    continuity_geometry,
    region_blocks,
    slice_regions,
    subset_regions,
)
from porepy_tpu_torch.utils import common_constants as cc

__all__ = ["Mpsa"]


class Mpsa:
    def __init__(self, keyword: str) -> None:
        self.keyword = keyword
        self.stress_matrix_key = "stress"
        self.bound_stress_matrix_key = "bound_stress"
        self.bound_displacement_cell_matrix_key = "bound_displacement_cell"
        self.bound_displacement_face_matrix_key = "bound_displacement_face"

    def ndof(self, sd) -> int:
        return sd.num_cells * sd.dim

    def discretize(self, sd, data: dict) -> None:
        param = data[cc.PARAMETERS][self.keyword]
        matrices = data[cc.DISCRETIZATION_MATRICES][self.keyword]
        constit = param["fourth_order_tensor"]
        bound = param["bc"]
        eta = param.get("mpsa_eta", None)
        hf_eta = param.get("reconstruction_eta", None)

        if sd.dim == 0:
            for key in (
                self.stress_matrix_key,
                self.bound_stress_matrix_key,
                self.bound_displacement_cell_matrix_key,
                self.bound_displacement_face_matrix_key,
            ):
                matrices[key] = sps.csr_matrix((0, 0))
            return

        from porepy_tpu_torch.numerics.fv._fvutils import restriction_from_params

        restrict = restriction_from_params(sd, param)
        stress, bound_stress, hf_cell, hf_bound = self._stress_discretization(
            sd, constit, bound, eta=eta, hf_eta=hf_eta, restrict=restrict
        )
        matrices[self.stress_matrix_key] = stress
        matrices[self.bound_stress_matrix_key] = bound_stress
        matrices[self.bound_displacement_cell_matrix_key] = hf_cell
        matrices[self.bound_displacement_face_matrix_key] = hf_bound

    # -- core -----------------------------------------------------------------

    def update_discretization(self, sd, data: dict) -> None:
        """Partial update after a local modification (reference
        ``numerics/fv/mpsa.py:update_discretization``): only interaction
        regions whose contributions changed are re-assembled; unchanged
        rows are mapped through ``data['update_discretization']``'s index
        maps."""
        from porepy_tpu_torch.numerics.fv._fvutils import (
            partial_update_discretization,
        )

        partial_update_discretization(
            sd,
            data,
            self.keyword,
            self.discretize,
            dim=sd.dim,
            vector_cell_right=(
                self.stress_matrix_key,
                self.bound_displacement_cell_matrix_key,
            ),
            vector_face_right=(
                self.bound_stress_matrix_key,
                self.bound_displacement_face_matrix_key,
            ),
            vector_face_left=(
                self.stress_matrix_key,
                self.bound_stress_matrix_key,
                self.bound_displacement_cell_matrix_key,
                self.bound_displacement_face_matrix_key,
            ),
        )

    def _stress_discretization(
        self,
        sd,
        constit,
        bound,
        eta: Optional[float] = None,
        hf_eta: Optional[float] = None,
        restrict=None,
    ):
        out = _assemble_mpsa_w(
            sd, constit, bound, eta, hf_eta, alphas=None, restrict=restrict
        )
        return out[:4]

    @staticmethod
    def _reduce_grid_constit_2d(sd, constit):
        """Rotate a 2d grid into its plane and reduce the stiffness to the
        in-plane 4x4 block (flat indices [0, 1, 3, 4] of the 9x9)."""
        sd = sd.copy()
        cc_r, fn_r, fc_r, rot, _dims, nodes_r = map_geometry.map_grid(sd)
        sd.cell_centers = cc_r
        sd.face_normals = fn_r
        sd.face_centers = fc_r
        sd.nodes = nodes_r
        keep = np.array([0, 1, 3, 4])
        cv = constit.values[np.ix_(keep, keep)]
        return sd, cv


def _split_stiffness(cv: np.ndarray, d: int) -> tuple[np.ndarray, np.ndarray]:
    """Split the flattened stiffness into the part evaluated with the local
    gradient (``sym``: diagonal plus couplings among the diagonal-of-G
    components) and the remainder (``asym``), which the W-method evaluates
    with the node-averaged gradient (reference ``mpsa.py:1461``)."""
    diag_idx = np.arange(d) * d + np.arange(d)  # flat indices of G_ii
    sym = np.zeros_like(cv)
    m = np.arange(d * d)
    sym[m, m] = cv[m, m]
    ii, jj = np.meshgrid(diag_idx, diag_idx, indexing="ij")
    sym[ii, jj] = cv[ii, jj]
    return sym, cv - sym


def _assemble_mpsa_w(
    sd,
    constit,
    bnd,
    eta,
    hf_eta,
    alphas=None,
    max_block_incidences: int = 600_000,
    restrict=None,
):
    """Shared MPSA/Biot assembly, region-blocked for bounded host memory.

    ``alphas``: optional dict ``{key: (3, 3, nc) coupling tensor values}``
    adding, per key, pressure RHS columns and divergence output rows.
    Returns ``(stress, bound_stress, hf_cell, hf_bound, scalar_gradient,
    displacement_divergence, bound_displacement_divergence, consistency,
    disp_pressure)`` with the last five as per-key dicts (empty if no
    alphas).
    """
    if bnd.bc_type != "vectorial":
        raise AttributeError("MPSA needs a vectorial boundary condition")
    # A boundary condition sized to the unique subfaces (canonical
    # ``_fvutils.subface_numbering`` order, = the reference's
    # ``SubcellTopology.subfno_unique``) selects the subface-resolved mode:
    # BC types/values vary per subface and the stress/bound_stress output
    # stays at subface rows and boundary columns (reference
    # ``numerics/fv/mpsa.py:715-754``, ``subface_rhs``).
    n_subf = int(sd.face_nodes.nnz)
    subface_mode = bnd.num_faces == n_subf and n_subf != sd.num_faces
    if not subface_mode and bnd.num_faces != sd.num_faces:
        raise ValueError(
            "Boundary condition must be sized to faces or unique subfaces"
        )
    if subface_mode and alphas:
        raise NotImplementedError(
            "Subface-resolved boundary conditions are not supported for "
            "the Biot coupling (reference biot.py:757 also discretizes "
            "with face-wise conditions)"
        )
    if sd.dim == 2:
        sd, cv = Mpsa._reduce_grid_constit_2d(sd, constit)
    else:
        cv = constit.values
    d = sd.dim
    if eta is None:
        from porepy_tpu_torch.numerics.fv._fvutils import determine_eta

        eta = determine_eta(sd)
    if hf_eta is None:
        hf_eta = eta
    alphas = alphas or {}
    keys = list(alphas)

    nc, nf = sd.num_cells, sd.num_faces
    rt_full = build_regions(
        sd,
        is_neu=np.ones(nf, dtype=bool),  # per-component types handled below
        is_dir=np.zeros(nf, dtype=bool),
        is_rob=np.zeros(nf, dtype=bool),
    )
    if restrict is not None:
        if subface_mode:
            raise NotImplementedError(
                "Partial rediscretization with subface-resolved boundary "
                "conditions is not supported"
            )
        nodes_needed, active_faces, active_cells = restrict
        rt_full = subset_regions(
            rt_full, np.flatnonzero(np.isin(rt_full.r_node, nodes_needed))
        )
    d2 = d * d

    # Per-component boundary classification (raw vectorial flags).
    is_neu = np.asarray(bnd.is_neu[:d], dtype=bool)
    is_dir = np.asarray(bnd.is_dir[:d], dtype=bool)
    is_rob = np.asarray(bnd.is_rob[:d], dtype=bool)
    # ``sf_ent``: per region-subface, the entity indexing the BC arrays and
    # the boundary dof numbering — the face in face mode, the canonical
    # unique-subface id in subface mode.
    if subface_mode:
        from porepy_tpu_torch.numerics.fv._fvutils import subface_numbering

        fno_u, nno_u = subface_numbering(sd)
        ref_code = nno_u.astype(np.int64) * nf + fno_u
        ref_order = np.argsort(ref_code)
        sf_ent_full = ref_order[
            np.searchsorted(
                ref_code[ref_order],
                rt_full.sf_v.astype(np.int64) * nf + rt_full.sf_f,
            )
        ]
    else:
        sf_ent_full = rt_full.sf_f
    if not np.all(
        (is_neu | is_dir | is_rob)[:, sf_ent_full[rt_full.bnd_idx]]
    ):
        raise ValueError("Boundary subfaces need a condition per component")

    basis = np.asarray(bnd.basis[:d, :d], dtype=float)
    identity_basis = bool(
        np.allclose(basis, np.eye(d)[:, :, None], atol=0, rtol=0)
    )
    rob_w = np.asarray(bnd.robin_weight[:d, :d], dtype=float)
    sym, asym = _split_stiffness(cv, d)
    num_cell_nodes = sd.num_cell_nodes()
    m_idx = np.arange(d2)

    # -- output accumulation ----------------------------------------------------
    # Scattered triplets are folded into CSR accumulators (which sum
    # duplicates) under a fixed pending budget, so the host high-water mark
    # is final-stencil-sized, not total-triplet-sized.
    n_bent = n_subf if subface_mode else nf  # stress-row / bound-col entities
    _shapes = {
        "stress": (n_bent * d, nc * d),
        "bound_stress": (n_bent * d, n_bent * d),
        "hf_cell": (nf * d, nc * d),
        "hf_bound": (nf * d, n_bent * d),
    }
    for k in keys:
        _shapes[("sg", k)] = (nf * d, nc)
        _shapes[("dp", k)] = (nf * d, nc)
        _shapes[("dd", k)] = (nc, nc * d)
        _shapes[("bdd", k)] = (nc, nf * d)
        _shapes[("cons", k)] = (nc, nc)
    _parts: dict = {}
    _acc: dict = {}
    _pending = [0]
    _FOLD_AT = 50_000_000  # pending triplets (~0.8 GB at 16 B each)

    def _accumulate(tag, sel, rows, cols, vals, weight=None):
        v = vals[sel]
        if weight is not None:
            v = v * weight[sel]
        _parts.setdefault(tag, ([], [], []))
        _parts[tag][0].append(rows[sel].astype(np.int32, copy=False))
        _parts[tag][1].append(cols[sel].astype(np.int32, copy=False))
        _parts[tag][2].append(v)
        _pending[0] += v.size

    def _fold():
        for tag, (rl, cl, vl) in _parts.items():
            m = sps.csr_matrix(
                (np.concatenate(vl), (np.concatenate(rl), np.concatenate(cl))),
                shape=_shapes[tag],
            )
            _acc[tag] = (_acc[tag] + m) if tag in _acc else m
        _parts.clear()
        _pending[0] = 0

    for r0b, r1b in region_blocks(rt_full, max_block_incidences):
        _assemble_mpsa_block(
            sd,
            slice_regions(rt_full, r0b, r1b),
            sf_ent_full[rt_full.sf_start[r0b] : rt_full.sf_start[r1b]],
            d,
            eta,
            hf_eta,
            keys,
            alphas,
            is_neu,
            is_dir,
            is_rob,
            basis,
            identity_basis,
            rob_w,
            sym,
            asym,
            num_cell_nodes,
            subface_mode,
            _accumulate,
            _fold,
            _pending,
            _FOLD_AT,
        )
    _fold()

    def build_from_parts(tag):
        return _acc.pop(tag, sps.csr_matrix(_shapes[tag]))

    stress = build_from_parts("stress")
    bound_stress = build_from_parts("bound_stress")
    hf_cell = build_from_parts("hf_cell")
    hf_bound = build_from_parts("hf_bound")

    if restrict is not None:
        # Faces on the rim of the assembled region set have only partial
        # rows (some of their regions were not assembled); the update
        # contract is: full rows exactly on the active faces, zero rows
        # elsewhere.
        from porepy_tpu_torch.numerics.linalg.matrix_operations import zero_rows

        keep = np.zeros(nf, dtype=bool)
        keep[active_faces] = True
        drop = (
            np.flatnonzero(~keep)[:, None] * d + np.arange(d)[None]
        ).ravel()
        for m in (stress, bound_stress, hf_cell, hf_bound):  # csr by build
            zero_rows(m, drop)
            m.eliminate_zeros()

    scalar_gradient = {}
    displacement_divergence = {}
    bound_displacement_divergence = {}
    consistency = {}
    disp_pressure = {}
    for k in keys:
        scalar_gradient[k] = build_from_parts(("sg", k))
        disp_pressure[k] = build_from_parts(("dp", k))
        displacement_divergence[k] = build_from_parts(("dd", k))
        bound_displacement_divergence[k] = build_from_parts(("bdd", k))
        consistency[k] = build_from_parts(("cons", k))
        if restrict is not None:
            from porepy_tpu_torch.numerics.linalg.matrix_operations import (
                zero_rows,
            )

            keep_c = np.zeros(nc, dtype=bool)
            keep_c[active_cells] = True
            drop_c = np.flatnonzero(~keep_c)
            for m in (scalar_gradient[k], disp_pressure[k]):
                zero_rows(m, drop)  # face rows (nf * d)
                m.eliminate_zeros()
            for m in (
                displacement_divergence[k],
                bound_displacement_divergence[k],
                consistency[k],
            ):
                zero_rows(m, drop_c)  # cell rows
                m.eliminate_zeros()

    return (
        stress.tocsr(),
        bound_stress.tocsr(),
        hf_cell.tocsr(),
        hf_bound.tocsr(),
        scalar_gradient,
        displacement_divergence,
        bound_displacement_divergence,
        consistency,
        disp_pressure,
    )


def _assemble_mpsa_block(
    sd,
    rt,
    sf_ent,
    d,
    eta,
    hf_eta,
    keys,
    alphas,
    is_neu,
    is_dir,
    is_rob,
    basis,
    identity_basis,
    rob_w,
    sym,
    asym,
    num_cell_nodes,
    subface_mode,
    _accumulate,
    _fold,
    _pending,
    _FOLD_AT,
):
    """Assemble, solve and globalize one region block into the caller's
    accumulators. ``rt`` is the block-restricted topology (region ids
    local, entity ids global); ``sf_ent`` its BC-entity per subface."""
    d2 = d * d
    T = rt.t_f.size
    t_bc = sf_ent[rt.t_sf]  # BC-array column per incidence
    bnd_inc = ~rt.sf_interior[rt.t_sf]  # boundary incidence mask
    int_inc = ~bnd_inc
    m_idx = np.arange(d2)

    n_r = d2 * (rt.nc_r + 1)  # gradients + auxiliary average
    m_r = d * rt.nc_r + d * rt.nb_r + len(keys) * rt.nc_r
    q_r = 2 * d * rt.nsf_r + len(keys) * rt.nc_r
    if not np.all(d * (rt.nsf_r + rt.nint_r) + d2 == n_r):
        raise ValueError("MPSA local systems are not square on this grid")

    # -- geometry / constitutive coefficients per incidence --------------------
    w, n_tilde, dist = continuity_geometry(sd, rt, eta, d)
    area_w = sd.face_areas[rt.t_f] * w
    # Neumann/Robin RHS coefficient: in face mode the face-integrated value
    # is split over the subfaces (weight w); in subface mode the value IS
    # the subface-integrated traction (reference ``mpsa.py:1128-1139``).
    bc_w = np.ones_like(w) if subface_mode else w

    # n~ . Csym : traction coefficients (d, d2) per incidence. The asym part
    # enters through the auxiliary averaged-stress unknown Hbar (see below),
    # so its usage coefficient is just the subface normal.
    nc_sym = np.einsum(
        "jt,ijmt->imt", n_tilde, sym.reshape(d, d, d2, -1)[:, :, :, rt.t_c]
    )

    # Invertibility guard: drop the averaged (asym) contribution at nodes
    # where Neumann or Robin component counts exceed the gradient count.
    elim = _asym_elimination_mask(rt, is_neu, is_rob, d, sf_ent)
    keep_asym = ~elim[:, rt.t_sf]  # (d, T)

    # Local index helpers.
    g_col = d2 * rt.t_loc_cell  # first gradient col of the incidence's cell
    aux_col = d2 * rt.nc_r[rt.t_r]  # first auxiliary col of the region
    u_col = d * rt.t_loc_cell  # first cell-displacement RHS col
    b_col0 = d * rt.nc_r[rt.t_r] + d * rt.sf_bcol[rt.t_sf]  # bc RHS col
    p_col0 = d * (rt.nc_r + rt.nb_r)[rt.t_r]  # first pressure RHS col

    a = _Trip()
    rhs = _Trip()
    wout = _Trip()

    # Pressure-coupling coefficients n~ . alpha per key: (d, T).
    n_alpha = {
        k: np.einsum("jt,ijt->it", n_tilde, np.asarray(v)[:d, :d][:, :, rt.t_c])
        for k, v in alphas.items()
    }

    for i in range(d):
        row = (rt.t_row * d + i).astype(np.int64)
        prow_all = rt.sf_prow[rt.t_sf] * d + i

        # Interior traction continuity: sgn (n~.Csym)_i (sym only).
        a.add(
            rt.t_r, row, g_col[None] + m_idx[:, None],
            rt.t_sgn * nc_sym[i], mask=int_inc,
        )
        # Interior displacement continuity: sgn (u_i + (G.dist)_i).
        a.add(
            rt.t_r, prow_all, g_col + i * d + np.arange(d)[:, None],
            rt.t_sgn * dist, mask=int_inc,
        )
        rhs.add(rt.t_r, prow_all, u_col + i, -rt.t_sgn, mask=int_inc)
        # Interior pressure columns: +sgn (n~.alpha)_i p_c.
        for ki, k in enumerate(keys):
            rhs.add(
                rt.t_r, row, p_col0 + ki * rt.nc_r[rt.t_r] + rt.t_loc_cell,
                rt.t_sgn * n_alpha[k][i], mask=int_inc,
            )

        # Boundary rows, with the (possibly non-identity) basis applied.
        neu_m = bnd_inc & is_neu[i, t_bc]
        dir_m = bnd_inc & is_dir[i, t_bc]
        rob_m = bnd_inc & is_rob[i, t_bc]

        # Asym usage: n~_j on the aux dofs (m*d + j), per raw component m.
        # The elimination guard zeroes the raw component before any basis.
        aux_use_col = aux_col + i * d + np.arange(d)[:, None]  # identity case
        if identity_basis:
            tr_sym = nc_sym[i]
            tr_asym_val = n_tilde * keep_asym[i]  # (d, T) at aux_use_col
            bw = None
        else:
            bvals = basis[i][:, t_bc]  # (d, T): B[i, m]
            tr_sym = np.einsum("mt,mkt->kt", bvals, nc_sym)
            bw = bvals

        for sel, robin in ((neu_m, False), (rob_m, True)):
            if not sel.any():
                continue
            a.add(rt.t_r, row, g_col[None] + m_idx[:, None],
                  rt.t_sgn * tr_sym, mask=sel)
            if identity_basis:
                a.add(rt.t_r, row, aux_use_col,
                      rt.t_sgn * tr_asym_val, mask=sel)
            else:
                for mm in range(d):
                    a.add(
                        rt.t_r, row, aux_col + mm * d + np.arange(d)[:, None],
                        rt.t_sgn * bw[mm] * keep_asym[mm] * n_tilde,
                        mask=sel,
                    )
            rhs.add(rt.t_r, row, b_col0 + i, bc_w, mask=sel)
            for ki, k in enumerate(keys):
                if identity_basis:
                    na_i = n_alpha[k][i]
                else:
                    na_i = np.einsum("mt,mt->t", bw, n_alpha[k])
                rhs.add(
                    rt.t_r, row, p_col0 + ki * rt.nc_r[rt.t_r] + rt.t_loc_cell,
                    rt.t_sgn * na_i, mask=sel,
                )
            if robin:
                # + (area w) [B W (u + G.dist)]_i
                eff = rob_w[i][:, t_bc] if identity_basis else np.einsum(
                    "mt,mkt->kt", bw, rob_w[:, :, t_bc]
                )  # (d, T): (B W)[i, m]
                for mm in range(d):
                    a.add(
                        rt.t_r, row, g_col + mm * d + np.arange(d)[:, None],
                        area_w * eff[mm] * dist, mask=sel,
                    )
                    rhs.add(rt.t_r, row, u_col + mm,
                            -area_w * eff[mm], mask=sel)

        if dir_m.any():
            if identity_basis:
                a.add(rt.t_r, row, g_col + i * d + np.arange(d)[:, None],
                      dist, mask=dir_m)
                rhs.add(rt.t_r, row, u_col + i, -np.ones(T), mask=dir_m)
            else:
                for mm in range(d):
                    a.add(
                        rt.t_r, row, g_col + mm * d + np.arange(d)[:, None],
                        bw[mm] * dist, mask=dir_m,
                    )
                    rhs.add(rt.t_r, row, u_col + mm, -bw[mm], mask=dir_m)
            rhs.add(rt.t_r, row, b_col0 + i, np.ones(T), mask=dir_m)

        # Output stress stencils (designated side, no sgn): sym + asym.
        orow = rt.t_row * d + i
        wout.add(rt.t_r, orow, g_col[None] + m_idx[:, None],
                 nc_sym[i], mask=rt.first_inc)
        wout.add(rt.t_r, orow, aux_col + i * d + np.arange(d)[:, None],
                 n_tilde * keep_asym[i], mask=rt.first_inc)

    # Displacement-trace output rows (hf_eta continuity points).
    _, _, dist_rec = continuity_geometry(sd, rt, hf_eta, d)
    inv_cnt = 1.0 / rt.sf_cnt[rt.t_sf]
    for i in range(d):
        orow = (rt.nsf_r[rt.t_r] + rt.t_row) * d + i
        wout.add(rt.t_r, orow, g_col + i * d + np.arange(d)[:, None],
                 inv_cnt * dist_rec)

    # Auxiliary defining rows: Hbar = sum_s w_s (Casym_s : G_s), the
    # volume-averaged asymmetric stress of the region (the reference's
    # ``average`` operator, mpsa.py:1620 — averaging the *product*, which
    # differs from Casym : Gbar for heterogeneous stiffness).
    sc_r = np.repeat(np.arange(rt.R), rt.nc_r)
    sc_loc = np.arange(rt.sc_c.size) - rt.sc_start[sc_r]
    vol_sc = sd.cell_volumes[rt.sc_c] / num_cell_nodes[rt.sc_c]
    vol_node = np.zeros(rt.R)
    np.add.at(vol_node, sc_r, vol_sc)
    w_vol = vol_sc / vol_node[sc_r]
    aux_row0 = d * (rt.nsf_r + rt.nint_r)
    all_r = np.arange(rt.R)
    asym_sc = asym.reshape(d2, d2, -1)[:, :, rt.sc_c]  # (d2, d2, S)
    for m in range(d2):
        a.add(all_r, aux_row0 + m, d2 * rt.nc_r + m, np.ones(rt.R))
        a.add(
            sc_r, aux_row0[sc_r] + m,
            d2 * sc_loc + np.arange(d2)[:, None],
            -w_vol * asym_sc[m],
        )

    # Biot divergence output rows: per subcell, V_s (alpha : G_s).
    div_row0 = 2 * d * rt.nsf_r
    for ki, k in enumerate(keys):
        al = np.asarray(alphas[k])[:d, :d][:, :, rt.sc_c]  # (d, d, S)
        for i in range(d):
            wout.add(
                sc_r, div_row0[sc_r] + ki * rt.nc_r[sc_r] + sc_loc,
                d2 * sc_loc + i * d + np.arange(d)[:, None],
                vol_sc * al[i],
            )

    rb = RegionBatches(
        n=n_r, m=m_r, q=q_r,
        a_region=a.reg(), a_row=a.row(), a_col=a.col(), a_val=a.val(),
        rhs_region=rhs.reg(), rhs_row=rhs.row(), rhs_col=rhs.col(),
        rhs_val=rhs.val(),
        w_region=wout.reg(), w_row=wout.row(), w_col=wout.col(),
        w_val=wout.val(),
    )
    del a, rhs, wout

    # -- globalize (streamed) ----------------------------------------------------
    # Device chunks are consumed as they arrive (iter_solve_and_contract)
    # and decoded in bounded slices: the row/column decode needs ~20 full-
    # length work arrays, and the block's triplet array itself would
    # dominate peak memory if materialized at once.
    # int32 per-region lookup tables: the decode below touches ~20
    # slice-length temporaries; 4-byte arithmetic halves the memory
    # traffic of the single host core doing it (block-local ids all fit).
    _nsf_r32 = rt.nsf_r.astype(np.int32, copy=False)
    _nc_r32 = np.maximum(rt.nc_r, 1).astype(np.int32, copy=False)
    _ncu32 = (d * rt.nc_r).astype(np.int32, copy=False)
    _ncb32 = (d * rt.nb_r).astype(np.int32, copy=False)
    _sf_start32 = rt.sf_start.astype(np.int32, copy=False)
    _sc_start32 = rt.sc_start.astype(np.int32, copy=False)

    def _globalize_slice(o_reg, o_row, o_col, o_val):
        nsf_o = d * _nsf_r32[o_reg]
        kind_stress = o_row < nsf_o
        kind_trace = ~kind_stress & (o_row < 2 * nsf_o)
        has_div = bool(keys)

        # Row decode.
        sf_local_scalar = np.where(kind_trace, o_row - nsf_o, o_row) // d
        if has_div:
            kind_div = ~kind_stress & ~kind_trace
            comp = np.where(kind_div, 0, o_row % d)
        else:
            comp = o_row % d
        sf_of_out = np.minimum(_sf_start32[o_reg] + sf_local_scalar,
                               rt.sf_f.size - 1)
        face_of_out = rt.sf_f[sf_of_out]
        ent_of_out = sf_ent[sf_of_out]  # == face_of_out in face mode
        if has_div:
            nc_o = _nc_r32[o_reg]
            div_local = o_row - 2 * nsf_o
            div_key = np.where(kind_div, div_local // nc_o, 0)
            div_cell_loc = np.where(kind_div, div_local % nc_o, 0)
            div_cell = rt.sc_c[_sc_start32[o_reg] + div_cell_loc]

        # Column decode.
        ncol_u = _ncu32[o_reg]
        ncol_b = _ncb32[o_reg]
        col_u = o_col < ncol_u
        col_b = ~col_u & (o_col < ncol_u + ncol_b)
        u_cell = rt.sc_c[_sc_start32[o_reg] + np.where(col_u, o_col, 0) // d]
        u_gcol = u_cell * d + o_col % d
        b_loc = np.where(col_b, o_col - ncol_u, 0)
        if rt.bnd_idx.size:
            idx = np.minimum(
                rt.b_start[o_reg] + b_loc // d, rt.bnd_idx.size - 1
            )
            b_face = sf_ent[rt.bnd_idx[idx]]
        else:
            b_face = np.zeros(o_col.size, dtype=int)
        b_gcol = b_face * d + b_loc % d
        if has_div:
            col_p = ~col_u & ~col_b
            p_loc = np.where(col_p, o_col - ncol_u - ncol_b, 0)
            p_key = p_loc // _nc_r32[o_reg]
            p_cell = rt.sc_c[_sc_start32[o_reg] + p_loc % _nc_r32[o_reg]]

        trace_w = 1.0 / rt.nnpf[face_of_out]
        srow = ent_of_out * d + comp  # stress rows: subface-level in subface mode
        trow = face_of_out * d + comp  # trace rows: always averaged to faces

        _accumulate("stress", kind_stress & col_u, srow, u_gcol, o_val)
        _accumulate("bound_stress", kind_stress & col_b, srow, b_gcol, o_val)
        _accumulate("hf_cell", kind_trace & col_u, trow, u_gcol, o_val, trace_w)
        _accumulate(
            "hf_bound", kind_trace & col_b, trow, b_gcol, o_val, trace_w
        )
        for ki, k in enumerate(keys):
            psel = col_p & (p_key == ki)
            _accumulate(("sg", k), kind_stress & psel, srow, p_cell, o_val)
            _accumulate(
                ("dp", k), kind_trace & psel, trow, p_cell, o_val, trace_w
            )
            dsel = kind_div & (div_key == ki)
            _accumulate(("dd", k), dsel & col_u, div_cell, u_gcol, o_val)
            _accumulate(("bdd", k), dsel & col_b, div_cell, b_gcol, o_val)
            _accumulate(("cons", k), dsel & psel, div_cell, p_cell, o_val)

    _slice_len = 4_000_000
    for o_reg_c, o_row_c, o_col_c, o_val_c in iter_solve_and_contract(rb):
        for lo in range(0, o_val_c.size, _slice_len):
            sl = slice(lo, lo + _slice_len)
            _globalize_slice(
                o_reg_c[sl], o_row_c[sl], o_col_c[sl], o_val_c[sl]
            )
            if _pending[0] > _FOLD_AT:
                _fold()
        del o_reg_c, o_row_c, o_col_c, o_val_c

    # -- block direct terms -------------------------------------------------------
    # Direct cell term of the displacement trace: (1/cnt/nnpf) u_c per
    # incidence, and the designated-side pressure term of the stress.
    ones = np.ones(T, dtype=bool)
    du_val = inv_cnt / rt.nnpf[rt.t_f]
    for i in range(d):
        _accumulate("hf_cell", ones, rt.t_f * d + i, rt.t_c * d + i, du_val)
    for k in keys:
        fi_m = rt.first_inc
        for i in range(d):
            _accumulate(
                ("sg", k), fi_m, rt.t_f * d + i, rt.t_c, -n_alpha[k][i]
            )
    if _pending[0] > _FOLD_AT:
        _fold()


def _asym_elimination_mask(rt, is_neu, is_rob, d, sf_ent) -> np.ndarray:
    """(d, n_subfaces) mask: True where the averaged-gradient term must be
    dropped (more Neumann — or Robin — component conditions at the node than
    gradients; reference ``mpsa.py:1932``). ``sf_ent`` indexes the BC
    arrays per subface (face or canonical-subface id)."""
    elim = np.zeros((d, rt.sf_f.size), dtype=bool)
    bnd_sf = rt.bnd_idx
    for i in range(d):
        for flags in (is_neu, is_rob):
            cnt = np.zeros(rt.R, dtype=np.int64)
            this_type = np.zeros(rt.sf_f.size, dtype=bool)
            this_type[bnd_sf] = flags[i, sf_ent[bnd_sf]]
            np.add.at(cnt, rt.sf_r[this_type], 1)
            bad_region = cnt > rt.nc_r
            # Only the condition's own (component, subface) rows are zeroed.
            elim[i] |= bad_region[rt.sf_r] & this_type
    return elim


class _Trip:
    """Triplet accumulator with broadcasting and masking."""

    def __init__(self) -> None:
        self._reg = []
        self._row = []
        self._col = []
        self._val = []

    def add(self, reg, row, col, val, mask=None):
        reg = np.asarray(reg)
        row = np.asarray(row)
        col = np.atleast_2d(np.asarray(col))
        val = np.atleast_2d(np.asarray(val))
        k = max(col.shape[0], val.shape[0])
        n = reg.shape[0]
        if mask is None:
            mask = np.ones(n, dtype=bool)
        col = np.broadcast_to(col, (k, n))[:, mask]
        val = np.broadcast_to(val, (k, n))[:, mask]
        reg = np.broadcast_to(reg, (k, n))[:, mask] if reg.ndim == 1 else reg
        row = np.broadcast_to(row, (k, n))[:, mask]
        # int32 triplet indices: region/row/col are block-local (each far
        # below 2^31); the downstream device path narrows to int32 anyway,
        # and the 8->4 byte cut matters at the memory high-water mark.
        self._reg.append(reg.ravel().astype(np.int32, copy=False))
        self._row.append(row.ravel().astype(np.int32, copy=False))
        self._col.append(col.ravel().astype(np.int32, copy=False))
        self._val.append(val.ravel())

    def reg(self):
        return np.concatenate(self._reg) if self._reg else np.zeros(0, int)

    def row(self):
        return np.concatenate(self._row) if self._row else np.zeros(0, int)

    def col(self):
        return np.concatenate(self._col) if self._col else np.zeros(0, int)

    def val(self):
        return np.concatenate(self._val) if self._val else np.zeros(0)
