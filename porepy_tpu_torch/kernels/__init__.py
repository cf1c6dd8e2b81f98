"""Hand-written CUDA kernels of the port, with their plain versions.

========  =============================  =====================================================
id        operator                       replaces (porepy_tpu)
========  =============================  =====================================================
K1        :class:`EllOperator`,          ``numerics/linalg/amg.py:59`` ell_matvec (and the
          :func:`ell_spmv`               ``r - A y``, ``y + P z`` after it)
K2        :func:`ell_jacobi_sweep`       ``numerics/linalg/amg.py:334-340``
K4g       :func:`fgmres_givens`          ``numerics/linalg/device_solver.py:198``
K6        :func:`dense_block_scatter`    ``numerics/linalg/device_solver.py:141-146``
K6        :func:`gj_pivot_inverse`       ``numerics/linalg/device_solver.py:104`` (pivot inverse)
K6        :func:`dense_block_apply`      ``numerics/linalg/device_solver.py:702-706``
K12       :func:`structured_residual`    ``parallel/structured_flow.py:69-100``
K12       :func:`structured_jvp`         ``parallel/structured_flow.py:116,124`` (linearize)
K13       :func:`tpfa_residual`          ``parallel/flow_step.py:64-97``
K13       :func:`tpfa_jvp`               ``parallel/flow_step.py:104`` (linearize)
K10       :func:`region_solve`           ``numerics/fv/local_solves.py:168-187``
K18a      :func:`bicgstab_cycle`         ``numerics/linalg/krylov.py:42-61`` (jax BiCGStab: a
                                         solve, one cooperative kernel)
K18b      :func:`gmres_cycle`            ``numerics/linalg/krylov.py:42-61`` (jax GMRES: one
                                         restart, one cooperative kernel)
K17       :func:`rachford_rice`          ``compositional/flash.py:80-122``
K16       :func:`interp_lookup`,         ``numerics/ad/operator_functions.py:117-134``
          :func:`interp_tangent`
K11       :func:`block_inverse`          ``numerics/linalg/matrix_operations.py:105-142``
K19       :class:`HaloOperator`          ``numerics/linalg/device_solver.py:947-953`` (the
          (``halo_interior``,            matvec under ``parallel/sharded.py``'s dof sharding)
          ``halo_boundary``)
K15       :func:`upwind_flux`,           ``numerics/fv/upwind.py:76-99`` (the upstream
          :func:`upwind_flux_tangent`,   selection and the advective face flux around it)
          :func:`upwind_select`,
          :func:`upwind_select_pair`
K14       :func:`tpfa_ad_flux`,          ``models/darcys_law_ad.py:71-147`` (the differentiable
          :func:`tpfa_ad_trace`,         TPFA flux and trace) and ``numerics/fv/fv_mesh.py:129-145``
          :func:`segment_sum_sorted`     (the segment sums of ``numerics/fv/tpfa.py``)
K8        :func:`dual_ew`,               ``numerics/ad/equation_system.py:132-135`` (the colored
          :class:`DualGatherVar`,        JVPs of one residual and the gather of the compressed
          :class:`DualGatherCopy`,       block into nonzero order), driven by the dual-number
          :func:`jac_gather`             pass of ``numerics/ad/forward.py``; the functional
                                         :func:`dual_gather_var`, :func:`dual_gather_copy`
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
    gmres_cycle,
    gmres_cycle_grid,
    HaloOperator,
    interp_lookup,
    interp_tangent,
    rachford_rice,
    DualProgram,
    dense_block_apply,
    dense_block_scatter,
    ell_jacobi_sweep,
    ell_spmv,
    dual_ew,
    DualGatherCopy,
    DualGatherVar,
    dual_gather_copy,
    dual_gather_var,
    fgmres_givens,
    gj_pivot_inverse,
    jac_gather,
    region_solve,
    reset_launches,
    structured_jvp,
    structured_residual,
    tpfa_jvp,
    tpfa_residual,
    TpfaAdGeometry,
    segment_sum_sorted,
    tpfa_ad_flux,
    tpfa_ad_flux_tangent,
    tpfa_ad_trace,
    tpfa_ad_trace_tangent,
    upwind_flux,
    upwind_flux_tangent,
    upwind_select,
    upwind_select_pair,
)
