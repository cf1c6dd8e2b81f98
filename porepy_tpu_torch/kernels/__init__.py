"""Hand-written CUDA kernels of the port, with their plain versions.

========  =============================  =====================================================
id        operator                       replaces (porepy_tpu)
========  =============================  =====================================================
K1        :class:`EllOperator`,          ``numerics/linalg/amg.py:59`` ell_matvec (and the
          :func:`ell_spmv`               ``r - A y``, ``y + P z`` after it)
K2        :class:`JacobiSweeps`,         ``numerics/linalg/device_solver.py:256`` (a Jacobi
          :func:`ell_jacobi_sweep`       block's sweeps, one cooperative kernel)
K3        :class:`VCycleOperator`        ``numerics/linalg/amg.py:327-341`` (the V-cycle, one
                                         cooperative kernel)
K4        :class:`FgmresArnoldi`         ``numerics/linalg/device_solver.py:179-212`` (an FGMRES
                                         Arnoldi step: matvec, CGS2, Givens step and flag, one
                                         cooperative kernel)
K6        :func:`dense_block_scatter`    ``numerics/linalg/device_solver.py:141-146``
K6        :func:`gj_pivot_inverse`       ``numerics/linalg/device_solver.py:104`` (pivot inverse)
K6        :func:`dense_block_apply`      ``numerics/linalg/device_solver.py:702-706``
K12       :func:`structured_residual`    ``parallel/structured_flow.py:69-100``
K12       :func:`structured_jvp`         ``parallel/structured_flow.py:116,124`` (linearize)
K12       :class:`StructuredLauncher`    ``parallel/structured_flow.py:116,140-143`` (the Newton
                                         step's residual with its densities, and a refinement
                                         round's ``-r - J dx``, one launch each)
K12       :func:`structured_linearize`,  ``parallel/structured_flow.py:104-148`` (the Newton
          :class:`FlowCycle`             step's jax BiCGStab on the linearized residual: a
                                         solve, two cooperative launches)
K13       :func:`tpfa_residual`          ``parallel/flow_step.py:64-97``
K13       :func:`tpfa_jvp`               ``parallel/flow_step.py:104`` (linearize)
K13       :class:`TpfaLauncher`          ``parallel/flow_step.py:104-105,119-137`` (the Newton
                                         step's residual, Jacobian values and Jacobi diagonal
                                         at ``p``, one launch; each mode one launch a call)
K13       :func:`tpfa_linearize`,        ``parallel/flow_step.py:101-118`` (as for K12, on the
          :class:`FlowCycle`             cell-cell matrix)
K10       :func:`region_solve`           ``numerics/fv/local_solves.py:168-187``
K18a      :func:`bicgstab_cycle`         ``numerics/linalg/krylov.py:42-61`` (jax BiCGStab: a
                                         solve, one cooperative kernel)
K18b      :func:`gmres_cycle`            ``numerics/linalg/krylov.py:42-61`` (jax GMRES: one
                                         restart, one cooperative kernel)
K17       :func:`rachford_rice`          ``compositional/flash.py:80-122``
K16       :class:`InterpLauncher`        ``numerics/ad/operator_functions.py:117-134`` (the
          (:func:`interp_launcher`,      lookup and its tangents: a dual rule's value and every
          :func:`interp_lookup`,         tangent in one launch, on a corner-block table)
          :func:`interp_tangent`)
K11       :func:`block_inverse`          ``numerics/linalg/matrix_operations.py:105-142``
K19       :class:`HaloOperator`          ``numerics/linalg/device_solver.py:947-953`` (the
          (``halo_interior``,            matvec under ``parallel/sharded.py``'s dof sharding)
          ``halo_boundary``)
K15       :class:`UpwindLauncher`        ``numerics/fv/upwind.py:76-99`` (the upstream
          (:func:`upwind_dual`,          selection and the advective face flux around it) and
          :func:`upwind_flux`,           ``models/constitutive_laws.py:585-619`` (the interface
          :func:`upwind_flux_tangent`,   selection and its product): one kernel, the value and
          :func:`upwind_select`,         every tangent of a rule in one launch
          :func:`upwind_select_pair`)
K14       :class:`TpfaAdLauncher`        ``models/darcys_law_ad.py:71-147`` (the differentiable
          (:func:`tpfa_ad_dual`,         TPFA flux and trace, value and tangents in one launch)
          :func:`tpfa_ad_flux`,          and ``numerics/fv/fv_mesh.py:129-145`` (the segment
          :func:`tpfa_ad_trace`),        sums of ``numerics/fv/tpfa.py``)
          :func:`segment_sum_sorted`
K8        :class:`DualEwLauncher`,       ``numerics/ad/equation_system.py:132-135`` (the colored
          :class:`DualGatherVar`,        JVPs of one residual and the gather of the compressed
          :class:`DualGatherCopy`,       block into nonzero order), driven by the dual-number
          :class:`RootScatter`           pass of ``numerics/ad/forward.py``; each equation's
                                         root writes its nonzeros and right-hand side rows
                                         (``DualEwLauncher.scatter``); the functional
                                         :func:`dual_ew`, :func:`dual_gather_var`,
                                         :func:`dual_gather_copy`
========  =============================  =====================================================

The CUDA sources live in ``csrc/`` and are built at first use (see
:mod:`porepy_tpu_torch.kernels.build`); the plain versions are in
:mod:`porepy_tpu_torch.kernels.reference`.
"""

from porepy_tpu_torch.kernels.ops import (  # noqa: F401
    K18A,
    K18B,
    LAUNCHES,
    bicgstab_cycle,
    bicgstab_cycle_grid,
    block_inverse,
    EllOperator,
    EllOperators,
    FlowCycle,
    gmres_cycle,
    gmres_cycle_grid,
    HaloOperator,
    interp_launcher,
    interp_lookup,
    interp_tangent,
    InterpLauncher,
    JacobiSweeps,
    rachford_rice,
    RootScatter,
    DualProgram,
    DualEwLauncher,
    dense_block_apply,
    dense_block_scatter,
    ell_jacobi_sweep,
    ell_spmv,
    dual_ew,
    DualGatherCopy,
    DualGatherVar,
    dual_gather_copy,
    dual_gather_var,
    FgmresArnoldi,
    gj_pivot_inverse,
    region_solve,
    region_solve_route,
    reset_launches,
    structured_jvp,
    structured_linearize,
    structured_residual,
    StructuredLauncher,
    tpfa_jvp,
    tpfa_linearize,
    tpfa_residual,
    TpfaAdGeometry,
    TpfaLauncher,
    TpfaAdLauncher,
    segment_sum_sorted,
    tpfa_ad_dual,
    tpfa_ad_flux,
    tpfa_ad_flux_tangent,
    tpfa_ad_trace,
    tpfa_ad_trace_tangent,
    UpwindLauncher,
    upwind_dual,
    upwind_flux,
    upwind_flux_tangent,
    upwind_pair_launcher,
    upwind_select,
    upwind_select_pair,
    VCycleOperator,
)
