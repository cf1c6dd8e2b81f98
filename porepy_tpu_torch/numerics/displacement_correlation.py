"""Stress-intensity-factor estimation by displacement correlation
(reference ``numerics/displacement_correlation.py:20`` — same public API:
:func:`faces_to_open`, :func:`sif_from_delta_u`, :func:`determine_onset`,
:func:`estimate_rm`; method of Nejati et al., Eng. Fract. Mech. 144,
2015).

The model-mixin route (``fracture_deformation.conforming_propagation``)
embeds the same physics in the propagation loop; this module is the
standalone, model-free surface: given a mixed-dimensional grid and a
displacement state, estimate per-tip SIFs and decide which host faces a
fracture should open.

The jump evaluation differs from the reference implementation: instead of
sampling displacements on cells flanking the fracture walls of the
HIGHER-dimensional grid (reference ``identify_correlation_points``), the
relative displacement at each tip is read from the mortar displacement
jump of the fracture's interface — the discrete quantity the contact
mechanics formulation actually solves for. Both evaluate the same
continuum object (the displacement jump at distance ``rm`` behind the
tip); the mortar route needs no nearest-point search and is exact on
conforming md grids.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = [
    "faces_to_open",
    "sif_from_delta_u",
    "determine_onset",
    "estimate_rm",
    "tip_sifs",
]


def estimate_rm(sd, **kw) -> np.ndarray:
    """Correlation-point distance per tip face: the distance from the tip
    face to its neighboring cell center (the natural discrete offset on a
    conforming grid; reference ``displacement_correlation.py:372`` uses a
    mesh-size heuristic)."""
    tip_faces = np.flatnonzero(sd.tags["tip_faces"])
    _signs, tip_cells = sd.signs_and_cells_of_boundary_faces(tip_faces)
    return np.linalg.norm(
        sd.face_centers[:, tip_faces] - sd.cell_centers[:, tip_cells], axis=0
    )


def sif_from_delta_u(d_u: np.ndarray, rm: np.ndarray, mu: float, kappa: float):
    """SIFs from relative displacements at distance ``rm`` behind the tip
    (Nejati et al. eq. 19; reference ``displacement_correlation.py:168``).

    ``d_u`` is ``(dim, n)`` in the tip frame with row 0 the in-plane
    sliding component, row 1 the opening (plane-normal) component and row
    2 (3d) the along-tip component. Returns ``(dim, n)`` with rows
    ``K_I, K_II[, K_III]``.
    """
    d_u = np.atleast_2d(d_u)
    dim, _n = d_u.shape
    rm = np.asarray(rm, dtype=float)
    sifs = np.zeros(d_u.shape)
    scale = np.sqrt(2.0 * np.pi / rm)
    sifs[0] = scale * mu / (kappa + 1.0) * d_u[1]
    sifs[1] = scale * mu / (kappa + 1.0) * d_u[0]
    if dim == 3:
        sifs[2] = scale * mu / 4.0 * d_u[2]
    return sifs


def determine_onset(sifs: np.ndarray, critical_values: np.ndarray):
    """Boolean per tip: does the equivalent SIF exceed the critical value?
    (reference ``displacement_correlation.py:150``: mode-wise comparison
    reduced by any)."""
    sifs = np.atleast_2d(sifs)
    critical_values = np.asarray(critical_values, dtype=float)
    return np.any(np.abs(sifs) > critical_values[:, None], axis=0)


def tip_sifs(mdg, u: Optional[np.ndarray] = None, mu=1.0, kappa=2.0):
    """Per-fracture tip SIF estimates: ``{sd_l: (sifs, tip_faces)}``.

    ``u`` is the mortar displacement vector per interface (stacked like
    the md variable); when None, the jump is read from the stored
    iterate solution of each interface's ``u_interface`` variable.
    """
    from porepy_tpu_torch.utils import common_constants as cc

    out = {}
    nd = mdg.dim_max()
    for intf in mdg.interfaces():
        sd_h, sd_l = mdg.interface_to_subdomain_pair(intf)
        if sd_h.dim != nd or sd_l.dim != nd - 1:
            continue
        tip_faces = np.flatnonzero(sd_l.tags["tip_faces"])
        if tip_faces.size == 0:
            out[sd_l] = (np.zeros((nd, 0)), tip_faces)
            continue
        signs, tip_cells = sd_l.signs_and_cells_of_boundary_faces(tip_faces)
        if u is None:
            d = mdg.interface_data(intf)
            u_j = d[cc.ITERATE_SOLUTIONS]["u_interface"][0]
        else:
            u_j = np.asarray(u)
        jump = (
            intf.mortar_to_secondary_avg(nd=nd)
            @ intf.sign_of_mortar_sides(nd=nd)
            @ u_j
        ).reshape((nd, sd_l.num_cells), order="F")[:, tip_cells]

        # Tip frame: e_perp = outward tip direction in the fracture plane,
        # e_n = fracture plane normal.
        e0 = (
            sd_l.face_normals[:, tip_faces]
            / sd_l.face_areas[tip_faces]
            * signs
        )
        d_u = np.zeros((nd, tip_faces.size))
        if sd_l.dim == 1:
            for i, c in enumerate(tip_cells):
                faces_c = sd_l.cell_faces[:, c].nonzero()[0]
                t = (
                    sd_l.face_centers[:, faces_c[-1]]
                    - sd_l.face_centers[:, faces_c[0]]
                )
                t /= max(np.linalg.norm(t), 1e-300)
                n = np.array([-t[1], t[0], 0.0])
                d_u[0, i] = jump[:, i] @ e0[:nd, i]
                d_u[1, i] = jump[:, i] @ n[:nd]
        else:
            from porepy_tpu_torch.geometry import map_geometry

            cn = sd_l.cell_nodes()
            for i, c in enumerate(tip_cells):
                nodes = cn[:, c].nonzero()[0]
                n = map_geometry.compute_normal(sd_l.nodes[:, nodes])
                e_par = np.cross(e0[:, i], n)
                d_u[0, i] = jump[:, i] @ e0[:, i]
                d_u[1, i] = jump[:, i] @ n
                d_u[2, i] = jump[:, i] @ e_par

        rm = np.linalg.norm(
            sd_l.face_centers[:, tip_faces] - sd_l.cell_centers[:, tip_cells],
            axis=0,
        )
        out[sd_l] = (sif_from_delta_u(d_u, rm, mu, kappa), tip_faces)
    return out


def faces_to_open(
    mdg,
    u: Optional[np.ndarray],
    critical_sifs: np.ndarray,
    mu: float = 1.0,
    kappa: float = 2.0,
    **kw,
):
    """Which host-grid faces should open, per fracture (reference
    ``displacement_correlation.py:20``): estimate tip SIFs, apply the
    onset criterion, and pick for each propagating tip the host face
    continuing the fracture path.

    Returns ``(faces, sifs)``: ``faces`` is ``{sd_l: array of host face
    indices}``, ``sifs`` the per-fracture ``(sifs, tip_faces)`` map.
    """
    from porepy_tpu_torch.numerics.fracture_deformation.conforming_propagation import (
        ConformingFracturePropagation,
    )

    sifs = tip_sifs(mdg, u, mu, kappa)
    nd = mdg.dim_max()
    sd_h = mdg.subdomains(dim=nd)[0]

    # Borrow the host-face selection geometry from the propagation mixin
    # through a minimal shim (it only touches mdg/nd/params there).
    shim = ConformingFracturePropagation.__new__(ConformingFracturePropagation)
    shim.mdg = mdg
    shim.nd = nd
    shim.params = dict(kw)

    faces = {}
    for sd_l, (s, tip_faces) in sifs.items():
        if tip_faces.size == 0:
            faces[sd_l] = np.empty(0, dtype=int)
            continue
        onset = determine_onset(s, np.asarray(critical_sifs))
        grow = tip_faces[onset]
        if grow.size == 0:
            faces[sd_l] = np.empty(0, dtype=int)
            continue
        signs, tip_cells = sd_l.signs_and_cells_of_boundary_faces(tip_faces)
        bases = shim._tip_bases(sd_l, tip_faces, signs, tip_cells)
        angles = np.zeros(int(onset.sum()))  # straight growth (mode I)
        faces[sd_l] = np.unique(
            shim._select_host_faces(
                sd_h, sd_l, grow, bases[:, :, onset], angles
            )
        )
    return faces, sifs
