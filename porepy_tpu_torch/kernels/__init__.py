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
========  =============================  =====================================================

The CUDA sources live in ``csrc/`` and are built at first use (see
:mod:`porepy_tpu_torch.kernels.build`); the plain versions are in
:mod:`porepy_tpu_torch.kernels.reference`.
"""

from porepy_tpu_torch.kernels.ops import (  # noqa: F401
    LAUNCHES,
    dense_block_apply,
    dense_block_scatter,
    ell_jacobi_sweep,
    ell_spmv,
    fgmres_givens,
    gj_pivot_inverse,
    reset_launches,
    structured_jvp,
    structured_residual,
    tpfa_jvp,
    tpfa_residual,
)
