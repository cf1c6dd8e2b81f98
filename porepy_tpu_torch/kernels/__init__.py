"""Hand-written CUDA kernels of the md flow path, with their plain versions.

========  ==========================  ========================================
id        operator                    replaces (porepy_tpu)
========  ==========================  ========================================
K1        :func:`ell_spmv`            ``numerics/linalg/amg.py:59`` ell_matvec
K2        :func:`ell_jacobi_sweep`    ``numerics/linalg/amg.py:334-340``
K4g       :func:`fgmres_givens`       ``numerics/linalg/device_solver.py:198``
========  ==========================  ========================================

The CUDA sources live in ``csrc/`` and are built at first use (see
:mod:`porepy_tpu_torch.kernels.build`); the plain versions are in
:mod:`porepy_tpu_torch.kernels.reference`.
"""

from porepy_tpu_torch.kernels.ops import (  # noqa: F401
    LAUNCHES,
    ell_jacobi_sweep,
    ell_spmv,
    fgmres_givens,
    reset_launches,
)
