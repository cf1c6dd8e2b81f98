"""SIF-driven fracture propagation along existing host-grid faces.

Parity counterpart of reference
``numerics/fracture_deformation/conforming_propagation.py:49``
(``ConformingFracturePropagation``): stress intensity factors are
estimated from the mortar displacement jump by the displacement
correlation method (Nejati et al., EFM 144, 2015), propagation onset and
kink angle follow the equivalent-SIF criteria of Richard et al. /
Thomas et al., and growth happens by splitting the host face best
aligned with the predicted propagation direction.

Differences from the reference: SIFs are computed directly from the
fracture-local tip bases built here (the reference reads a stored
``TangentialNormalProjection``), and the per-tip loop works on the
model's AD solution state rather than raw parameter dictionaries.
"""

from __future__ import annotations

import numpy as np

from porepy_tpu_torch.geometry import map_geometry
from porepy_tpu_torch.numerics.fracture_deformation.propagation_model import (
    FracturePropagation,
)

__all__ = ["ConformingFracturePropagation"]

# Kink-angle fit constants of Richard et al. (eq. 8/23).
_ANGLE_A = np.radians(140.0)
_ANGLE_B = np.radians(-70.0)


class ConformingFracturePropagation(FracturePropagation):
    """Mix into a (poro)mechanical model above the solution strategy.

    Parameters read from ``self.params``:

    - ``"critical_sifs"``: per-mode critical stress intensity factors
      (sequence of length nd; defaults to ones).
    - ``"propagation_is_tensile"``: if True (default), only mode I is
      considered (matching the reference's tensile shortcut,
      ``conforming_propagation.py:76``).
    """

    def propagation_faces(self) -> dict:
        faces = {
            sd: np.empty(0, dtype=int)
            for sd in self.mdg.subdomains(dim=self.nd - 1)
        }
        for intf in self.mdg.interfaces():
            sd_h, sd_l = self.mdg.interface_to_subdomain_pair(intf)
            if sd_h.dim != self.nd or sd_l.dim != self.nd - 1:
                continue
            sifs, tip_faces, bases = self._displacement_correlation(sd_l, intf)
            if tip_faces.size == 0:
                continue
            onset, angles = self._onset_and_angles(sifs)
            self._store_sifs(sd_l, sifs, tip_faces, onset)
            grow = tip_faces[onset]
            if grow.size == 0:
                continue
            host = self._select_host_faces(
                sd_h, sd_l, grow, bases[:, :, onset], angles[onset]
            )
            faces[sd_l] = np.unique(host)
        return faces

    # -- SIF estimation -----------------------------------------------------

    def _elastic_moduli(self) -> tuple[float, float]:
        """(shear modulus, Kolosov kappa) from the solid constants."""
        mu = float(self.solid.shear_modulus)
        lam = float(self.solid.lame_lambda)
        poisson = lam / (2.0 * (lam + mu))
        return mu, 3.0 - 4.0 * poisson

    def _displacement_correlation(self, sd_l, intf):
        """Per-tip SIFs of one fracture from the interface displacement jump
        (reference ``conforming_propagation.py:164-255``)."""
        nd = self.nd
        tip_faces = np.flatnonzero(sd_l.tags["tip_faces"])
        if tip_faces.size == 0:
            return (
                np.zeros((nd, 0)),
                tip_faces,
                np.zeros((nd, 3, 0)),
            )
        signs, tip_cells = sd_l.signs_and_cells_of_boundary_faces(tip_faces)

        u_j = np.asarray(
            self.equation_system.evaluate(
                self.equation_system.md_variable(
                    self.interface_displacement_variable, [intf]
                )
            )
        )
        jump = (
            intf.mortar_to_secondary_avg(nd=nd)
            @ intf.sign_of_mortar_sides(nd=nd)
            @ u_j
        ).reshape((nd, sd_l.num_cells), order="F")[:, tip_cells]

        bases = self._tip_bases(sd_l, tip_faces, signs, tip_cells)
        # Components of the jump in the tip frame: [perp-to-tip (in plane),
        # fracture normal, along-tip].
        d_u = np.zeros((nd, tip_faces.size))
        for k in range(nd):
            d_u[k] = np.einsum("ij,ij->j", jump, bases[k, :nd, :])

        rm = np.linalg.norm(
            sd_l.face_centers[:, tip_faces] - sd_l.cell_centers[:, tip_cells],
            axis=0,
        )
        mu, kappa = self._elastic_moduli()
        sifs = np.zeros((nd, tip_faces.size))
        scale = np.sqrt(2.0 * np.pi / rm)
        # Mode I from the normal jump component; II/III from the in-plane
        # components (Nejati et al. eq. 19).
        sifs[0] = scale * mu / (kappa + 1.0) * d_u[1]
        if not self.params.get("propagation_is_tensile", True):
            sifs[1] = scale * mu / (kappa + 1.0) * d_u[0]
            if nd == 3:
                sifs[2] = scale * mu / 4.0 * d_u[2]
        return sifs, tip_faces, bases

    def _tip_bases(self, sd_l, tip_faces, signs, tip_cells) -> np.ndarray:
        """(nd, 3, n_tips): rows are [e_perp (outward tip direction in the
        fracture plane), e_n (fracture plane normal), e_par (along the tip,
        3d only)]."""
        nd = self.nd
        n_tips = tip_faces.size
        bases = np.zeros((nd, 3, n_tips))
        e0 = (
            sd_l.face_normals[:, tip_faces]
            / sd_l.face_areas[tip_faces]
            * signs
        )
        bases[0] = e0
        if sd_l.dim == 1:
            # 1d fracture in a 2d host: the plane normal is the in-plane
            # perpendicular of the cell tangent.
            for i, c in enumerate(tip_cells):
                faces_c = sd_l.cell_faces[:, c].nonzero()[0]
                t = (
                    sd_l.face_centers[:, faces_c[-1]]
                    - sd_l.face_centers[:, faces_c[0]]
                )
                t = t / max(np.linalg.norm(t), 1e-300)
                n = np.array([-t[1], t[0], 0.0])
                bases[1, :, i] = n
        else:
            # 2d fracture in a 3d host: plane normal from the tip cell's
            # node cloud.
            cn = sd_l.cell_nodes()
            for i, c in enumerate(tip_cells):
                nodes = cn[:, c].nonzero()[0]
                n = map_geometry.compute_normal(sd_l.nodes[:, nodes])
                bases[1, :, i] = n
            bases[2] = np.cross(bases[0], bases[1], axis=0)
        return bases

    # -- propagation criteria ----------------------------------------------

    def _critical_sifs(self) -> np.ndarray:
        vals = np.atleast_1d(
            np.asarray(
                self.params.get("critical_sifs", np.ones(self.nd)), float
            )
        )
        if vals.size < self.nd:
            vals = np.concatenate([vals, np.ones(self.nd - vals.size)])
        return vals

    def _onset_and_angles(self, sifs) -> tuple[np.ndarray, np.ndarray]:
        """Equivalent-SIF onset (Richard et al. eq. 7/25) and kink angle
        (eq. 8/23) per tip."""
        k_crit = self._critical_sifs()
        shear = 4.0 * (k_crit[0] / k_crit[1] * sifs[1]) ** 2
        if self.nd == 3:
            shear = shear + 4.0 * (k_crit[0] / k_crit[2] * sifs[2]) ** 2
        k_eq = 0.5 * (sifs[0] + np.sqrt(sifs[0] ** 2 + shear))
        onset = k_eq >= k_crit[0]

        angles = np.zeros(sifs.shape[1])
        active = np.any(sifs != 0, axis=0)
        if np.any(active):
            abs_k2 = np.abs(sifs[1, active])
            denom = sifs[0, active] + abs_k2
            if self.nd == 3:
                denom = denom + np.abs(sifs[2, active])
            denom = np.where(np.abs(denom) > 1e-300, denom, 1.0)
            ratio = abs_k2 / denom
            angles[active] = -np.sign(sifs[1, active]) * (
                _ANGLE_A * ratio + _ANGLE_B * ratio**2
            )
        return onset, angles

    def _store_sifs(self, sd_l, sifs, tip_faces, onset) -> None:
        """Expose per-face SIFs for inspection/tests."""
        data = self.mdg.subdomain_data(sd_l)
        full = np.zeros((self.nd, sd_l.num_faces))
        full[:, tip_faces] = sifs
        data["SIFs"] = full
        grow = np.zeros(sd_l.num_faces, dtype=bool)
        grow[tip_faces[onset]] = True
        data["propagate_faces"] = grow

    # -- host face selection -------------------------------------------------

    def _select_host_faces(self, sd_h, sd_l, grow_faces, bases, angles):
        """For each propagating tip, the host face sharing the tip edge whose
        direction best matches the rotated propagation vector (reference
        ``conforming_propagation.py:437-583``)."""
        nd = self.nd
        chosen = []
        for i, f in enumerate(grow_faces):
            nodes_l = sd_l.face_nodes[:, f].nonzero()[0]
            gids = sd_l.global_point_ind[nodes_l]
            nodes_h = np.flatnonzero(np.isin(sd_h.global_point_ind, gids))
            cand = self._candidate_faces(sd_h, nodes_h)
            if cand.size == 0:
                continue
            # Propagation direction: rotate the outward tip vector by the
            # kink angle about the tip axis.
            e0 = bases[0, :, i]
            if nd == 2:
                b0, b1 = bases[0, :, i], bases[1, :, i]
                axis = np.array([0.0, 0.0, b0[0] * b1[1] - b0[1] * b1[0]])
            else:
                axis = bases[2, :, i]
            R = map_geometry.axis_angle_rotation(float(angles[i]), axis)
            direction = R @ e0
            vecs = sd_h.face_centers[:, cand] - sd_l.face_centers[
                :, f
            ].reshape(3, 1)
            vecs = vecs / np.maximum(
                np.linalg.norm(vecs, axis=0), 1e-300
            )
            align = direction @ vecs
            chosen.append(cand[int(np.argmax(align))])
        return np.asarray(chosen, dtype=int)

    def _candidate_faces(self, sd_h, edge_nodes_h) -> np.ndarray:
        """Host faces sharing the full tip edge, excluding existing fracture
        faces and faces whose splitting would self-intersect an existing
        fracture (non-tip fracture edge check, reference
        ``conforming_propagation.py:629-743`` simplified)."""
        if edge_nodes_h.size == 0:
            return np.empty(0, dtype=int)
        fn = sd_h.face_nodes.tocsc()
        masks = [
            np.asarray(fn[n].todense()).ravel().astype(bool)
            for n in edge_nodes_h
        ]
        shared = masks[0]
        for m in masks[1:]:
            shared = shared & m
        cand = np.flatnonzero(shared)
        cand = cand[~sd_h.tags["fracture_faces"][cand]]
        keep = []
        frac_nodes = sd_h.tags.get(
            "fracture_nodes", np.zeros(sd_h.num_nodes, dtype=bool)
        )
        for f in cand:
            nodes = sd_h.face_nodes[:, f].nonzero()[0]
            others = np.setdiff1d(nodes, edge_nodes_h)
            # A face whose remaining nodes all lie on a fracture would merge
            # two fracture surfaces on splitting; skip it.
            if others.size and np.all(frac_nodes[others]):
                continue
            keep.append(f)
        return np.asarray(keep, dtype=int)
