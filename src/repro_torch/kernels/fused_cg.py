"""Merged-reduction CG driven entirely by the fused kernels.

Counterpart of ``repro/kernels/fused_cg.py``.  The fused iteration is the
``cg_merged`` ``MethodDef``'s fused body run by the generic driver over a
:class:`KernelOp`:

    x, r, p, s = A.cg_body(α, β, x, r, p, s, w)        # 1 memory pass
    w, δ, γ    = A.spmv_dots(r)                        # 1 memory pass
"""

from __future__ import annotations

import torch

from repro_torch.core.methods import Ops, SolveResult, get_method, run_method
from repro_torch.core.operators import Stencil
from repro_torch.core.solvers import LocalOp
from repro_torch.kernels import autotune, ops
from repro_torch.kernels.kernel_op import KernelOp


def cg_merged_fused(stencil: Stencil, b: torch.Tensor, x0: torch.Tensor, *,
                    tol: float = 1e-6, maxiter: int = 500,
                    norm_ref: float | None = None) -> SolveResult:
    """Single-device merged CG, two fused memory passes per iteration (the
    initial residual's matvec runs the SpMV kernel too), in the tuned run."""
    run = autotune.resolve(stencil.name, b.shape, b.dtype, b.device).run
    A = KernelOp(LocalOp(stencil, matvec_padded=ops.make_matvec_padded(stencil)), run=run)
    ops_ = Ops(A, b, norm_ref=norm_ref)
    return run_method(get_method("cg_merged"), ops_, x0, tol=tol,
                      maxiter=maxiter, fused=True)
