"""Model mixin wiring fracture propagation into the simulation loop.

Counterpart of reference
``numerics/fracture_deformation/propagation_model.py:32``
(``FracturePropagation``): after each converged time step the model
evaluates its propagation criterion, extends the fractures through the
selected host faces, and rebuilds the compiled machinery.

TPU-first note: topology growth is a re-setup event — the equation system's
dof layout is rebuilt from the grown grids (the propagation surgery already
remapped stored solution rings), every compiled kernel is dropped, the
model's equations are re-created, and geometry-derived caches are cleared.
The first Newton iteration after propagation therefore recompiles; all
subsequent iterations run at full compiled speed on the new static shapes.
"""

from __future__ import annotations

import numpy as np

from porepy_tpu_torch.numerics.fracture_deformation.propagate_fracture import (
    propagate_fractures,
)

__all__ = ["FracturePropagation"]


class FracturePropagation:
    """Mix into a model above the solution strategy. Override
    :meth:`propagation_faces` with the propagation criterion."""

    def propagation_faces(self) -> dict:
        """``{fracture_grid: host face indices to split}`` based on the
        current solution; empty arrays mean no growth. The default returns
        no propagation — override with a criterion (stress intensity,
        user-prescribed schedule, ...)."""
        return {
            sd: np.empty(0, dtype=int)
            for sd in self.mdg.subdomains(dim=self.nd - 1)
        }

    def has_propagated(self) -> bool:
        return bool(getattr(self, "_propagated_last_step", False))

    def evaluate_propagation(self) -> None:
        """Evaluate the criterion and, if any fracture grows, perform the
        topological update and rebuild the model machinery."""
        faces = self.propagation_faces()
        total = sum(np.asarray(f).size for f in faces.values())
        self._propagated_last_step = total > 0
        if total == 0:
            return
        propagate_fractures(self.mdg, faces)
        self.mdg.compute_geometry()
        self._rebuild_after_propagation()

    def after_nonlinear_convergence(self) -> None:
        super().after_nonlinear_convergence()
        self.evaluate_propagation()

    def _rebuild_after_propagation(self) -> None:
        """Re-setup on the new topology: dof layout, equations, compiled
        kernels, discretizations and geometry caches."""
        from porepy_tpu_torch.utils.tangential_normal_projection import (
            set_local_coordinate_projections,
        )

        # Fracture grids changed size: refresh the stored local frames.
        set_local_coordinate_projections(self.mdg)
        eq = self.equation_system
        eq._rebuild_dofs()
        eq.clear_compiled()
        # Equation DAGs hold projections/discretizations of the old
        # topology; rebuild them all.
        eq._equations.clear()
        for cache_name in ("_upwind_geom_cache", "_adtpfa_cache"):
            if hasattr(self, cache_name):
                getattr(self, cache_name).clear()
        if hasattr(self, "_device_solvers"):
            self._device_solvers = {}
        self.set_equations()
        self.update_discretization_parameters()
        # Partial rediscretization of the host grid: faces appended by the
        # split keep all pre-existing indices, so the stored matrices map
        # through an injection and only the regions around the split/new
        # faces are re-assembled (``update_discretization``; disable with
        # params['partial_rediscretization'] = False).
        import scipy.sparse as sps

        tagged = []
        if self.params.get("partial_rediscretization", True):
            for sd, data in self.mdg.subdomains(return_data=True):
                if not data.pop("partial_update", False):
                    continue
                new_faces = np.asarray(
                    data.get("new_faces", np.zeros(0, int))
                )
                split_faces = np.asarray(
                    data.get("split_faces", np.zeros(0, int))
                )
                new_cells = np.asarray(
                    data.get("new_cells", np.zeros(0, int))
                )
                if new_cells.size or sd.dim != self.nd:
                    # Grids that gained cells (the fractures) rediscretize
                    # in full — TPFA there is O(nnz) anyway.
                    continue
                n_old_f = sd.num_faces - new_faces.size
                face_map = sps.coo_matrix(
                    (
                        np.ones(n_old_f),
                        (np.arange(n_old_f), np.arange(n_old_f)),
                    ),
                    shape=(sd.num_faces, n_old_f),
                ).tocsr()
                data["update_discretization"] = {
                    "modified_faces": np.unique(
                        np.concatenate([new_faces, split_faces])
                    ),
                    "map_faces": face_map,
                }
                tagged.append(data)
        try:
            self.discretize()
        finally:
            for data in tagged:
                data.pop("update_discretization", None)
        self.update_time_dependent_ad_arrays()
        self.update_derived_quantities()
