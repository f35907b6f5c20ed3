"""Plain PyTorch versions of the ported kernels (counterpart of
``repro/kernels/ref.py``).

Each kernel wrapper in ``kernels/ops.py`` takes these for CPU tensors; the
CUDA kernels are held against them on the card.  The accumulation-dtype rule
is the reference's: partial sums accumulate in the input dtype, in float32
for bfloat16.
"""

from __future__ import annotations

import torch

from repro_torch.core.operators import Stencil


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float32 if t.dtype == torch.bfloat16 else t.dtype


def stencil_spmv_ref(xp: torch.Tensor, *, stencil: Stencil) -> torch.Tensor:
    return stencil.matvec_padded(xp)


def stencil_spmv_dot_ref(xp: torch.Tensor, *, stencil: Stencil):
    y = stencil.matvec_padded(xp)
    x = xp[1:-1, 1:-1, 1:-1]
    acc = _acc_dtype(xp)
    return y, torch.sum(y.to(acc) * x.to(acc))


def stencil_spmv_dots_ref(xp: torch.Tensor, *, stencil: Stencil):
    """SpMV + BOTH merged-CG partials: ``(A x, (A x)·x, x·x)``."""
    y = stencil.matvec_padded(xp)
    x = xp[1:-1, 1:-1, 1:-1]
    acc = _acc_dtype(xp)
    ya = y.to(acc)
    xa = x.to(acc)
    return y, torch.sum(ya * xa), torch.sum(xa * xa)


def fused_cg_body_ref(alpha, beta, x, r, p, s, w):
    """Merged-CG vector updates: p' = r+βp, s' = w+βs, x' = x+αp', r' = r−αs'."""
    p_new = r + beta * p
    s_new = w + beta * s
    return x + alpha * p_new, r - alpha * s_new, p_new, s_new
