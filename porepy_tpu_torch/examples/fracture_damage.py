"""Fracture damage example: contact mechanics with history-dependent
friction and dilation (reference ``examples/fracture_damage.py``).

A sheared fracture accumulates damage history (integrated plastic slip);
the friction bound and dilation gap decay exponentially with the
history, following J. White (2014).
"""

from __future__ import annotations

import numpy as np

import porepy_tpu_torch as pt
from porepy_tpu_torch.models import constitutive_laws
from porepy_tpu_torch.models import fracture_damage as damage


class DamageBase(
    constitutive_laws.FrictionDamage,
    constitutive_laws.DilationDamage,
    damage.DamageHistoryVariable,
    damage.AnisotropicHistoryEquation,
):
    """Damage machinery bundle; swap the history equation for
    :class:`~porepy_tpu.models.fracture_damage.IsotropicHistoryEquation`
    to accumulate damage irrespective of slip direction."""


class FractureDamageModel(DamageBase, pt.MomentumBalance):
    """Single horizontal fracture, sheared from the north boundary under
    normal compression."""

    def set_fractures(self):
        self._fractures = [
            pt.LineFracture(np.array([[0.25, 0.75], [0.5, 0.5]]))
        ]

    def bc_type_mechanics(self, sd):
        sides = self.domain_boundary_sides(sd)
        bc = pt.BoundaryConditionVectorial(
            sd, sides.north | sides.south, "dir"
        )
        bc.internal_to_dirichlet(sd)
        return bc

    def bc_values_displacement(self, bg):
        sides = self.domain_boundary_sides(bg)
        vals = np.zeros((self.nd, bg.num_cells))
        t = self.time_manager.time
        vals[0, sides.north] = 0.05 * t
        vals[1, sides.north] = -0.01
        return vals.ravel("F")


def run(n_steps: int = 3) -> FractureDamageModel:
    params = {
        "grid_type": "cartesian",
        "meshing_arguments": {"cell_size": 0.25},
        "times_to_export": [],
        "time_manager": pt.TimeManager(
            [0, float(n_steps)], 1.0, constant_dt=True
        ),
        "material_constants": {
            "solid": pt.SolidConstants(
                shear_modulus=1.0,
                lame_lambda=1.0,
                friction_coefficient=0.3,
                residual_aperture=1e-3,
                initial_friction_damage=0.5,
                friction_damage_decay=5.0,
                initial_dilation_damage=0.5,
                dilation_damage_decay=5.0,
            ),
        },
    }
    model = FractureDamageModel(params)
    pt.run_time_dependent_model(model, params)
    return model


if __name__ == "__main__":
    m = run()
    h = m.equation_system.get_variable_values(
        ["damage_history"], time_step_index=0
    )
    print("damage history:", h)
