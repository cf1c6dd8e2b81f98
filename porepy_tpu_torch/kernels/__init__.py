"""Hand-written CUDA kernels of the port, with their plain versions.

========  =============================  =====================================================
id        operator                       replaces (porepy_tpu)
========  =============================  =====================================================
K1        :func:`ell_spmv`               ``numerics/linalg/amg.py:59`` ell_matvec
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
K18a      :func:`bicgstab_p`,            ``numerics/linalg/krylov.py:42-61`` (jax BiCGStab)
          :func:`krylov_dots`,
          :func:`bicgstab_s`,
          :func:`bicgstab_xr`,
          :func:`bicgstab_scalars`
K18b      :func:`cgs_project`,           ``numerics/linalg/krylov.py:42-61`` (jax GMRES)
          :func:`cgs_update`,
          :func:`cgs_normalize`,
          :func:`gmres_lstsq`,
          :func:`gmres_correct`,
          :func:`gmres_residual`,
          :func:`gmres_restart`
K17       :func:`rachford_rice`          ``compositional/flash.py:80-122``
K16       :func:`interp_lookup`,         ``numerics/ad/operator_functions.py:117-134``
          :func:`interp_tangent`
K11       :func:`block_inverse`          ``numerics/linalg/matrix_operations.py:105-142``
K19       :func:`halo_pack`,             ``numerics/linalg/device_solver.py:947-953`` (the
          :func:`ell_spmv_split`         matvec under ``parallel/sharded.py``'s dof sharding)
========  =============================  =====================================================

The CUDA sources live in ``csrc/`` and are built at first use (see
:mod:`porepy_tpu_torch.kernels.build`); the plain versions are in
:mod:`porepy_tpu_torch.kernels.reference`.
"""

from porepy_tpu_torch.kernels.ops import (  # noqa: F401
    K18A,
    K18B,
    LAUNCHES,
    bicgstab_p,
    bicgstab_s,
    bicgstab_scalars,
    bicgstab_xr,
    block_inverse,
    cgs_normalize,
    cgs_project,
    cgs_update,
    gmres_correct,
    gmres_lstsq,
    gmres_residual,
    gmres_restart,
    halo_pack,
    interp_lookup,
    interp_tangent,
    krylov_dots,
    rachford_rice,
    dense_block_apply,
    dense_block_scatter,
    ell_jacobi_sweep,
    ell_spmv,
    ell_spmv_split,
    fgmres_givens,
    gj_pivot_inverse,
    region_solve,
    reset_launches,
    structured_jvp,
    structured_residual,
    tpfa_jvp,
    tpfa_residual,
)
