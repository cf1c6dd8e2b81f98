"""The fused time block of porepy_tpu_torch (K9 as host loops over device
tensors) keeps porepy_tpu's protocol: the tests of
tests/models/test_fused_time_block.py, run through the port on the CPU.

- agreement with the per-step path on an md flow problem,
- statistics/time bookkeeping replayed per committed step,
- roll-back to the per-step path when equation inputs are time-dependent
  (a ramped BC),
- partial blocks (fewer steps left than the chunk length),
- Krylov counts surfaced into ``DeviceLinearSolver.last_stats``,
- a periodic forcing that the rollback check lets through, committed as
  ``porepy_tpu`` commits it.
"""

import numpy as np
import pytest
import torch

import porepy_tpu_torch as pt

torch.set_num_threads(1)

FRACS = [
    np.array([[0.2, 0.8], [0.5, 0.5]]),
    np.array([[0.5, 0.5], [0.2, 0.8]]),
]


def _make_model(extra_params=None, time_bc=False, pkg=pt, forcing=None):
    class Model(pkg.SinglePhaseFlow):
        def set_fractures(self):
            self._fractures = [pkg.LineFracture(f) for f in FRACS]

        def bc_values_pressure(self, bg):
            base = 1.0 - bg.cell_centers[1]
            if time_bc:
                base = base * (1.0 + 0.3 * self.time_manager.time)
            if forcing is not None:
                base = base * forcing(self.time_manager.time)
            return base

        def initialize_data_saving(self):
            pass

        def save_data_time_step(self):
            self.saved_times = getattr(self, "saved_times", [])
            self.saved_times.append(round(self.time_manager.time, 12))
            self.saved_pressures = getattr(self, "saved_pressures", [])
            self.saved_pressures.append(np.array(_final_pressure(self)))

    params = {
        "grid_type": "cartesian",
        "meshing_arguments": {"cell_size": 1.0 / 16},
        "material_constants": {
            "solid": pkg.SolidConstants(
                permeability=1.0,
                porosity=0.1,
                residual_aperture=0.01,
                normal_permeability=1.0,
            ),
            "fluid": pkg.FluidComponent(
                compressibility=1e-4, viscosity=1e-3, density=1000.0
            ),
        },
        "time_manager": pkg.TimeManager([0, 6.0], 1.0, constant_dt=True),
        "linear_solver": "device_gmres",
    }
    if pkg is pt:
        params["device"] = "cpu"
    params.update(extra_params or {})
    return Model(params), params


def _final_pressure(m):
    return m.equation_system.get_variable_values(["pressure"], time_step_index=0)


def _rel(a, b):
    return float(np.linalg.norm(a - b)) / max(float(np.linalg.norm(a)), 1e-30)


def test_block_matches_per_step():
    m_ref, p_ref = _make_model()
    pt.run_time_dependent_model(m_ref, p_ref)
    m_blk, p_blk = _make_model({"fused_time_steps": 8})
    pt.run_time_dependent_model(m_blk, p_blk)

    assert _rel(_final_pressure(m_ref), _final_pressure(m_blk)) < 1e-10
    assert m_blk.saved_times == m_ref.saved_times
    assert np.isclose(m_blk.time_manager.time, 6.0)
    assert m_blk.time_manager.time_index == m_ref.time_manager.time_index
    assert getattr(m_blk, "_ftb_blocks_committed", 0) >= 1
    assert getattr(m_ref, "_ftb_blocks_committed", 0) == 0


def test_block_surfaces_krylov_stats():
    m, p = _make_model({"fused_time_steps": 8})
    pt.run_time_dependent_model(m, p)
    (solver,) = m._device_solvers.values()
    stats = solver.last_stats
    assert stats["fused"] is True and stats["block"] is True
    assert stats["krylov_iters"] >= 1
    assert all(k >= 0 for k in stats["krylov_iters_per_newton"])


def test_time_dependent_bc_rolls_back():
    m_ref, p_ref = _make_model(time_bc=True)
    pt.run_time_dependent_model(m_ref, p_ref)
    m_blk, p_blk = _make_model({"fused_time_steps": 8}, time_bc=True)
    pt.run_time_dependent_model(m_blk, p_blk)

    assert _rel(_final_pressure(m_ref), _final_pressure(m_blk)) < 1e-12
    assert getattr(m_blk, "_ftb_blocks_committed", 0) == 0


def test_partial_block():
    """7 steps with chunk 4: steps 1-2 per-step, a block of 4, then a
    block of the 1 step left is not tried (fewer than 2) and runs
    per-step."""
    tm = {"time_manager": pt.TimeManager([0, 7.0], 1.0, constant_dt=True)}
    m_a, p_a = _make_model(tm)
    pt.run_time_dependent_model(m_a, p_a)
    tm = {"time_manager": pt.TimeManager([0, 7.0], 1.0, constant_dt=True)}
    m_b, p_b = _make_model({"fused_time_steps": 4, **tm})
    pt.run_time_dependent_model(m_b, p_b)

    assert _rel(_final_pressure(m_a), _final_pressure(m_b)) < 1e-10
    assert np.isclose(m_b.time_manager.time, 7.0)
    assert m_b._ftb_blocks_committed == 1 and m_b._ftb_last["steps"] == 4


def _periodic(t):
    """A forcing of period 4 in exact values: 1.0 at the times 1, 2, 5, 6
    and 1.3 at 3 and 4. Steps 1 and 2 run per step and see no change, so a
    block of ``fused_time_steps`` 4 runs steps 3-6 on the boundary values
    of step 2's assembly (1.0), and its last step's values (1.0 again)
    equal them."""
    return 1.0 + 0.3 * (round(t) % 4 in (0, 3))


def test_periodic_forcing_block_matches_porepy_tpu():
    """A time-dependent BC whose block ends where it started.

    The fused block's rollback check (``porepy_tpu``'s
    ``models/solution_strategy.py:848-856``, kept by the port) compares the
    equation inputs only at the block's last time with the constants the
    block ran on, so this forcing passes it: the block commits, though its
    steps 3 and 4 ran on 1.0 where the forcing is 1.3. Both packages
    share that fault. The port does not repair it, because a repair would
    make it differ from the reference; this test holds the port's fused
    run to ``porepy_tpu``'s on the same inputs, whatever that run commits:
    the same blocks committed and the pressure of every saved step within
    1e-10 of ``porepy_tpu``'s largest. That the committed step 3 differs
    from the per-step path's shows the fault is there to be held."""
    import porepy_tpu as pt_jax

    tm = pt.TimeManager([0, 6.0], 1.0, constant_dt=True)
    m_blk, p_blk = _make_model({"fused_time_steps": 4, "time_manager": tm}, forcing=_periodic)
    pt.run_time_dependent_model(m_blk, p_blk)
    tm_jax = pt_jax.TimeManager([0, 6.0], 1.0, constant_dt=True)
    m_jax, p_jax = _make_model({"fused_time_steps": 4, "time_manager": tm_jax}, pkg=pt_jax, forcing=_periodic)
    pt_jax.run_time_dependent_model(m_jax, p_jax)
    m_ref, p_ref = _make_model(forcing=_periodic)
    pt.run_time_dependent_model(m_ref, p_ref)

    committed = getattr(m_jax, "_ftb_blocks_committed", 0)
    assert getattr(m_blk, "_ftb_blocks_committed", 0) == committed == 1
    assert m_blk.saved_times == m_jax.saved_times
    for p_port, p_ref_jax in zip(m_blk.saved_pressures, m_jax.saved_pressures):
        assert np.abs(p_port - p_ref_jax).max() <= 1e-10 * np.abs(p_ref_jax).max()
    step3 = m_ref.saved_times.index(3.0)
    assert _rel(m_ref.saved_pressures[step3], m_blk.saved_pressures[step3]) > 1e-3


def test_missing_card_is_an_error_not_a_fallback():
    """``device="cuda"`` without a card raises at model construction."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        _make_model({"device": "cuda"})
