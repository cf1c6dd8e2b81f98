"""Plain PyTorch versions of the hand-written kernels.

Each function computes exactly what its CUDA kernel in ``csrc/`` computes,
with ordinary tensor operations. The kernel wrappers in
:mod:`porepy_tpu_torch.kernels.ops` call these for tensors on the CPU; the
tests and ``chip_smoke.py`` hold each kernel against its plain version.
"""

from __future__ import annotations

import torch

__all__ = ["ell_spmv", "ell_jacobi_sweep", "fgmres_givens"]


def ell_spmv(val: torch.Tensor, col: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y = A x`` for A in padded-row (ELL) form: ``val``/``col`` of shape
    ``(n_rows, K)``, padding columns equal to ``x.shape[-1]`` read zero.
    ``x`` is ``(n_cols,)`` or ``(B, n_cols)``."""
    pad = x.new_zeros(x.shape[:-1] + (1,))
    x_p = torch.cat([x, pad], dim=-1)
    return (val * x_p[..., col]).sum(dim=-1)


def ell_jacobi_sweep(
    val: torch.Tensor,
    col: torch.Tensor,
    sinv: torch.Tensor,
    r: torch.Tensor,
    y: torch.Tensor,
) -> torch.Tensor:
    """One smoother sweep ``y + sinv * (r - A y)`` for square ELL ``A``."""
    return y + sinv * (r - ell_spmv(val, col, y))


def fgmres_givens(
    hcol: torch.Tensor,
    cs: torch.Tensor,
    sn: torch.Tensor,
    g: torch.Tensor,
    j: torch.Tensor,
    atol: torch.Tensor,
    flag: torch.Tensor,
) -> None:
    """In place: rotate the new Hessenberg column ``hcol`` by the ``j``
    previous Givens rotations, form rotation ``j``, update ``g``, set
    ``flag = (j + 1 < restart) & (|g[j + 1]| > atol)`` and advance ``j``.
    ``restart = hcol.numel() - 1``; ``j``/``flag`` are int32 scalars. A
    ``j`` outside ``[0, restart)`` only clears the flag."""
    jj = int(j)
    restart = hcol.shape[0] - 1
    if jj < 0 or jj >= restart:
        flag.fill_(0)
        return
    h = hcol
    for i in range(jj):
        hi = h[i].clone()
        hn = h[i + 1].clone()
        h[i] = cs[i] * hi + sn[i] * hn
        h[i + 1] = -sn[i] * hi + cs[i] * hn
    denom = torch.sqrt(h[jj] * h[jj] + h[jj + 1] * h[jj + 1])
    safe = torch.clamp(denom, min=1e-30)
    c = h[jj] / safe
    s = h[jj + 1] / safe
    cs[jj] = c
    sn[jj] = s
    h[jj] = denom
    h[jj + 1] = 0.0
    gj = g[jj].clone()
    g[jj + 1] = -s * gj
    g[jj] = c * gj
    flag.fill_(int(jj + 1 < restart and bool(torch.abs(g[jj + 1]) > atol)))
    j.fill_(jj + 1)
