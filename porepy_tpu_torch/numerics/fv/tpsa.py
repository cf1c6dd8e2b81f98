"""Two-point stress approximation (TPSA) for linearized elasticity.

Parity counterpart of reference ``numerics/fv/tpsa.py:136``, implementing
the scheme of Nordbotten & Keilegavlen (arXiv:2405.10390): a three-field
(displacement, rotation, total pressure) two-point discretization. All
fourteen discretization matrices of the reference are produced, stored in
``data[DISCRETIZATION_MATRICES][keyword]``.

Host-side scipy assembly, like the other FV discretizers: the matrices
become compile-time constants of the jitted residual kernels.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps

from porepy_tpu_torch.utils.array_operations import expand_indices_nd
from porepy_tpu_torch.utils.common_constants import (
    DISCRETIZATION_MATRICES,
    PARAMETERS,
)

__all__ = ["Tpsa"]


class Tpsa:
    def __init__(self, keyword: str) -> None:
        self.keyword = keyword
        self.stress_displacement_matrix_key = "stress"
        self.stress_rotation_matrix_key = "stress_rotation"
        self.stress_total_pressure_matrix_key = "stress_total_pressure"
        self.rotation_displacement_matrix_key = "rotation_displacement"
        self.rotation_rotation_matrix_key = "rotation_rotation"
        self.mass_total_pressure_matrix_key = "solid_mass_total_pressure"
        self.mass_displacement_matrix_key = "solid_mass_displacement"
        self.bound_stress_matrix_key = "bound_stress"
        self.bound_rotation_displacement_matrix_key = (
            "bound_rotation_displacement"
        )
        self.bound_mass_displacement_matrix_key = "bound_mass_displacement"
        self.bound_displacement_cell_matrix_key = "bound_displacement_cell"
        self.bound_displacement_face_matrix_key = "bound_displacement_face"
        self.bound_displacement_rotation_cell_matrix_key = (
            "bound_displacement_rotation_cell"
        )
        self.bound_displacement_solid_pressure_cell_matrix_key = (
            "bound_displacement_solid_pressure_cell"
        )

    def ndof(self, sd) -> int:
        return sd.num_cells * sd.dim

    def discretize(self, sd, data: dict) -> None:
        params = data[PARAMETERS][self.keyword]
        matrices = data[DISCRETIZATION_MATRICES].setdefault(self.keyword, {})
        nc, nf, nd = sd.num_cells, sd.num_faces, sd.dim

        stiffness = params["fourth_order_tensor"]
        bnd = params["bc"]

        # Bookkeeping: half-face arrays and sign conventions.
        cf = sps.coo_matrix(sd.cell_faces)
        order = np.argsort(cf.col, kind="stable")  # csc-like ordering
        fi, ci, sgn = cf.row[order], cf.col[order], cf.data[order]
        fi_nd = expand_indices_nd(fi, nd)
        ci_nd = expand_indices_nd(ci, nd)
        sgn_nd = np.repeat(sgn, nd)
        bf = sd.get_all_boundary_faces()
        sgn_bf_arr, _ = sd.signs_and_cells_of_boundary_faces(bf)
        sgn_bf = np.zeros(nf, dtype=int)
        sgn_bf[bf] = sgn_bf_arr

        mu = stiffness.mu[ci]

        # The supported BC envelope deliberately matches the reference's:
        # TPSA there raises NotImplementedError for exactly the same three
        # cases (non-trivial basis, non-diagonal Robin weight, Robin mixed
        # with Dirichlet/Neumann on one face) — reference
        # ``numerics/fv/tpsa.py:572-616``.
        if not np.all(bnd.basis[np.eye(nd, dtype=bool)] == 1) or np.any(
            bnd.basis[~np.eye(nd, dtype=bool)] > 0
        ):
            raise NotImplementedError(
                "Tpsa requires a trivial boundary-condition basis "
                "(as in the reference, tpsa.py:572-589)"
            )
        if np.any(bnd.robin_weight[~np.eye(nd, dtype=bool)] > 0):
            raise NotImplementedError(
                "Non-diagonal Robin weights are not implemented "
                "(as in the reference, tpsa.py:595-605)"
            )
        mixed_rob = np.any(bnd.is_rob, axis=0) & ~np.all(bnd.is_rob, axis=0)
        if np.any(mixed_rob):
            raise NotImplementedError(
                "Mixing Robin with Dirichlet/Neumann on one face is not "
                "implemented (as in the reference, tpsa.py:607-618)"
            )

        # -- boundary filters (displacement variable) -------------------------
        is_dir = bnd.is_dir.ravel("F")
        is_neu = bnd.is_neu.ravel("F")
        is_rob = bnd.is_rob.ravel("F")
        is_internal = ~(is_dir | is_neu | is_rob)

        def diag_nd(mask):
            return sps.dia_matrix(
                (mask.astype(int), 0), shape=(nf * nd, nf * nd)
            )

        dir_pass_nd = diag_nd(is_dir)
        dir_notpass_nd = diag_nd(is_neu | is_rob | is_internal)
        neu_pass_nd = diag_nd(is_neu)
        neu_notpass_nd = diag_nd(is_dir | is_rob | is_internal)
        neu_rob_pass_nd = diag_nd(is_neu | is_rob)
        rob_pass_nd = diag_nd(is_rob)
        max_ind = np.argmax(np.abs(sd.face_normals), axis=0)
        dir_scalar = bnd.is_dir[max_ind, np.arange(nf)]
        dir_notpass = sps.dia_matrix(
            ((~dir_scalar).astype(int), 0), shape=(nf, nf)
        )

        # -- distances and Robin coefficients ---------------------------------
        n_fi = sd.face_normals[:, fi] * sgn
        fc_cc = (
            n_fi
            * (sd.face_centers[:, fi] - sd.cell_centers[:, ci])
            / sd.face_areas[fi]
        )
        dist_fc_cc = np.abs(np.sum(fc_cc, axis=0))
        mu_by_d = mu / dist_fc_cc
        mu_by_d_nd = np.repeat(mu_by_d, nd)

        rob_weight = np.vstack(
            [bnd.robin_weight[k, k] for k in range(nd)]
        )
        rob_weight_projected = np.sum(
            rob_weight * (sd.face_normals[:nd] / sd.face_areas) ** 2, axis=0
        )
        rob_faces = np.where(bnd.is_rob[0])[0]
        arithmetic_avg_mu = np.bincount(
            np.hstack((fi, rob_faces)),
            np.hstack((2 * mu_by_d, rob_weight_projected[rob_faces])),
            minlength=nf,
        )
        all_face_dofs = expand_indices_nd(np.arange(nf), nd).reshape(
            (nd, nf), order="F"
        )
        rob_dofs = all_face_dofs[bnd.is_rob]
        rob_w_flat = rob_weight[bnd.is_rob]
        mu_by_d_nd_rob = np.bincount(
            np.hstack((fi_nd, rob_dofs)),
            weights=np.hstack((2 * mu_by_d_nd, rob_w_flat)),
            minlength=nf * nd,
        )
        inv_mu_by_dist = sps.dia_matrix(
            (1.0 / mu_by_d_nd_rob, 0), shape=(nf * nd, nf * nd)
        )
        t_shear_rob = np.bincount(
            rob_dofs, weights=1.0 / rob_w_flat, minlength=nd * nf
        ) if rob_dofs.size else np.zeros(nd * nf)

        # -- cell-to-face average maps ----------------------------------------
        cell_to_face = sps.coo_matrix(
            (2 * mu_by_d, (fi, ci)), shape=(nf, nc)
        ).tocsr()
        c2f = (
            inv_mu_by_dist @ sps.kron(cell_to_face, sps.eye(nd), format="csr")
        ).tocsc()
        dir_nd_dofs = np.where(dir_notpass_nd.diagonal() == 0)[0]
        c2f.data[np.isin(c2f.indices, dir_nd_dofs)] = 0
        c2f = c2f.tocsr()
        c2f_compl = sps.csr_matrix(
            (1 - c2f.data, c2f.indices, c2f.indptr), shape=c2f.shape
        )
        b2f_rob = (
            rob_pass_nd
            @ inv_mu_by_dist
            @ sps.dia_matrix(
                (rob_weight.ravel("F"), 0), shape=(nf * nd, nf * nd)
            )
        )
        b2f_rob_compl = 1 - b2f_rob.diagonal()
        c2f_scalar_2_nd = (
            inv_mu_by_dist
            @ sps.kron(
                cell_to_face, sps.csr_matrix(np.ones((nd, 1))), format="csr"
            )
        ).tocsr()
        # Zero the rows of Dirichlet displacement dofs.
        row_of_entry = np.repeat(
            np.arange(c2f_scalar_2_nd.shape[0]),
            np.diff(c2f_scalar_2_nd.indptr),
        )
        c2f_scalar_2_nd.data[
            np.isin(row_of_entry, np.where(is_dir)[0])
        ] = 0
        c2f_compl_scalar_2_nd = sps.csr_matrix(
            (
                1 - c2f_scalar_2_nd.data,
                c2f_scalar_2_nd.indices,
                c2f_scalar_2_nd.indptr,
            ),
            shape=c2f_scalar_2_nd.shape,
        )

        # -- shear transmissibilities (vector Laplacian) ------------------------
        t_shear_nd = (
            2.0
            * np.repeat(sd.face_areas, nd)
            / (
                np.bincount(
                    fi_nd, weights=1.0 / mu_by_d_nd, minlength=nf * nd
                )
                + t_shear_rob
            )
        ).reshape((nd, nf), order="F")

        trm_nd = t_shear_nd
        trm_bnd = np.zeros((nd, nf))
        trm_bnd[bnd.is_dir] = trm_nd[bnd.is_dir]
        trm_nd[bnd.is_neu] = 0
        trm_bnd[bnd.is_neu] = 1
        trm_bnd[bnd.is_rob] = (
            b2f_rob_compl.reshape((nd, nf), order="F")[bnd.is_rob]
            + trm_nd[bnd.is_rob]
        )
        stress = -sps.coo_matrix(
            (trm_nd.ravel("F")[fi_nd] * sgn_nd, (fi_nd, ci_nd)),
            shape=(nf * nd, nc * nd),
        ).tocsr()
        bound_stress = sps.coo_matrix(
            (trm_bnd.ravel("F")[fi_nd] * sgn_nd, (fi_nd, fi_nd)),
            shape=(nf * nd, nf * nd),
        ).tocsr()

        n = sd.face_normals
        normal_vector_diag = sps.dia_matrix(
            (n[:nd].ravel("F"), 0), shape=(nf * nd, nf * nd)
        )
        stress_total_pressure = (
            neu_notpass_nd @ normal_vector_diag @ c2f_compl_scalar_2_nd
        )
        normal_vector_nd = sps.csr_matrix(
            (n[:nd].ravel("F"), np.arange(nf * nd), np.arange(0, nf * nd + 1, nd)),
            shape=(nf, nf * nd),
        )
        mass_displacement = normal_vector_nd @ c2f
        mass_total_pressure = -dir_notpass @ (
            sps.dia_matrix(
                (sd.face_areas / arithmetic_avg_mu, 0), shape=(nf, nf)
            )
            @ sd.cell_faces
        )
        inv_mu_face = sps.dia_matrix(
            (1.0 / mu_by_d_nd_rob, 0), shape=(nf * nd, nf * nd)
        )

        if nd == 3:
            z = np.zeros(nf)
            # Block-diagonal with one 3x3 block per face:
            #   R^n = [[0, -n2, n1], [n2, 0, -n0], [-n1, n0, 0]]
            # (face-area-scaled normal cross-product matrix).
            block = np.array(
                [[z, -n[2], n[1]], [n[2], z, -n[0]], [-n[1], n[0], z]]
            )  # block[i][j] = entry (i, j) per face
            rows_b = np.repeat(np.arange(nf) * 3, 9) + np.tile(
                np.repeat(np.arange(3), 3), nf
            )
            cols_b = np.repeat(np.arange(nf) * 3, 9) + np.tile(
                np.tile(np.arange(3), 3), nf
            )
            vals = np.transpose(block, (2, 0, 1)).ravel()
            Rn_hat = sps.coo_matrix(
                (vals, (rows_b, cols_b)), shape=(nf * 3, nf * 3)
            ).tocsr()
            Rn_bar = Rn_hat
            stress_rotation = -neu_notpass_nd @ Rn_hat @ c2f_compl
            rotation_rotation = (
                -neu_rob_pass_nd
                @ sps.dia_matrix(
                    (1.0 / np.repeat(arithmetic_avg_mu * sd.face_areas, nd), 0),
                    shape=(nf * nd, nf * nd),
                )
                @ Rn_hat
                @ Rn_hat
                @ sps.kron(sd.cell_faces, sps.eye(nd), format="csr")
            )
        else:
            normal_vector_data = np.array([n[1], -n[0]])
            Rn_bar = sps.csr_matrix(
                (
                    -normal_vector_data.ravel("F"),
                    np.arange(nf * nd),
                    np.arange(0, nd * nf + 1, nd),
                ),
                shape=(nf, nf * nd),
            )
            Rn_hat = sps.dia_matrix(
                (normal_vector_data.ravel("F"), 0), shape=(nf * nd, nf * nd)
            )
            stress_rotation = -neu_notpass_nd @ Rn_hat @ c2f_compl_scalar_2_nd
            rotation_rotation = -(
                Rn_bar
                @ neu_rob_pass_nd
                @ sps.dia_matrix(
                    (1.0 / np.repeat(arithmetic_avg_mu * sd.face_areas, nd), 0),
                    shape=(nf * nd, nf * nd),
                )
                @ Rn_hat
                @ sps.kron(sd.cell_faces, sps.csr_matrix([[1], [1]]), format="csr")
            )

        rotation_displacement = -Rn_bar @ c2f

        inv_area_scaling = sps.dia_matrix(
            (1 / np.repeat(sd.face_areas, nd), 0), shape=(nd * nf, nd * nf)
        )
        bound_rotation_displacement = Rn_bar @ (
            -inv_area_scaling @ neu_rob_pass_nd @ inv_mu_face
            - dir_pass_nd
            - b2f_rob
        )
        bound_mass_displacement = normal_vector_nd @ (
            inv_area_scaling @ neu_rob_pass_nd @ inv_mu_face
            + dir_pass_nd
            + b2f_rob
        )

        sgn_area_scaling = sps.dia_matrix(
            (np.repeat(sgn_bf / sd.face_areas, nd), 0),
            shape=(nd * nf, nd * nf),
        )
        bound_displacement_cell = neu_rob_pass_nd @ c2f
        bound_displacement_face = dir_pass_nd + sgn_area_scaling @ inv_mu_face @ (
            neu_pass_nd + rob_pass_nd @ b2f_rob
        )
        face_rotation = c2f_scalar_2_nd if nd == 2 else c2f
        bound_displacement_rotation_cell = (
            sgn_area_scaling
            @ inv_mu_face
            @ (
                rob_pass_nd @ stress_rotation
                - neu_pass_nd @ Rn_hat @ face_rotation
            )
        )
        bound_displacement_solid_pressure_cell = (
            sgn_area_scaling
            @ inv_mu_face
            @ (
                rob_pass_nd @ stress_total_pressure
                + neu_pass_nd @ normal_vector_diag @ c2f_scalar_2_nd
            )
        )

        matrices[self.stress_displacement_matrix_key] = stress
        matrices[self.stress_rotation_matrix_key] = stress_rotation
        matrices[self.stress_total_pressure_matrix_key] = stress_total_pressure
        matrices[self.rotation_displacement_matrix_key] = rotation_displacement
        matrices[self.mass_total_pressure_matrix_key] = mass_total_pressure
        matrices[self.mass_displacement_matrix_key] = mass_displacement
        matrices[self.rotation_rotation_matrix_key] = rotation_rotation
        matrices[self.bound_stress_matrix_key] = bound_stress
        matrices[self.bound_mass_displacement_matrix_key] = (
            bound_mass_displacement
        )
        matrices[self.bound_rotation_displacement_matrix_key] = (
            bound_rotation_displacement
        )
        matrices[self.bound_displacement_cell_matrix_key] = (
            bound_displacement_cell
        )
        matrices[self.bound_displacement_face_matrix_key] = (
            bound_displacement_face
        )
        matrices[self.bound_displacement_rotation_cell_matrix_key] = (
            bound_displacement_rotation_cell
        )
        matrices[self.bound_displacement_solid_pressure_cell_matrix_key] = (
            bound_displacement_solid_pressure_cell
        )
