"""``KernelOp``: the LocalOp-protocol operator backed by the CUDA kernels.

Counterpart of ``repro/kernels/pallas_op.py::PallasOp``.  It wraps an operator
satisfying the ``LocalOp`` protocol and supplies

  * the protocol surface (``pad_exchange``/``matvec``/``matvec_local``/
    ``diag``/``dot``/``dotn``/``sum_partials``/``base``/``stencil``) with the
    stencil apply running on the SpMV kernel, and
  * the fused-iteration hooks merged CG's ``fused_step`` is written against:
    ``spmv_dots`` and ``cg_body``.

Halo exchange and the global reduction of the kernels' partials come from
the wrapped operator (zero pad and identity locally).  Tiles are fixed in the
kernels: there is no autotuning in this slice (ROADMAP queue 1 item 9).  The
reference's other fused hooks arrive with their kernels (ROADMAP queue 2).
"""

from __future__ import annotations

import torch

from repro_torch.core.methods import _default_dot
from repro_torch.core.operators import pad1
from repro_torch.kernels import ops


class KernelOp:
    """CUDA-kernel execution of a wrapped LocalOp-protocol operator; on CPU
    tensors every hook runs the kernels' plain versions."""

    def __init__(self, base):
        self.base = base
        self.stencil = base.stencil

    @property
    def diag(self) -> float:
        return self.base.diag

    # --- protocol surface (halos/reductions delegate to the wrapped op) ------
    def pad_exchange(self, x: torch.Tensor) -> torch.Tensor:
        return self.base.pad_exchange(x)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return ops.spmv(self.pad_exchange(x), self.stencil)

    def matvec_local(self, x: torch.Tensor) -> torch.Tensor:
        return ops.spmv(pad1(x), self.stencil)

    @property
    def dot(self):
        d = getattr(self.base, "dot", None)
        return d if d is not None else _default_dot

    def dotn(self, *pairs) -> tuple:
        return self.base.dotn(*pairs)

    def sum_partials(self, *vals) -> tuple:
        return self.base.sum_partials(*vals)

    # --- fused-iteration hooks (what MethodDef.fused_step is written against)
    def spmv_dots(self, x: torch.Tensor) -> tuple:
        """``(A·x, (A·x)·x, x·x)`` in one pass; the partials are made global
        through the wrapped operator."""
        w, delta, gamma = ops.spmv_dots(self.pad_exchange(x), self.stencil)
        delta, gamma = self.sum_partials(delta, gamma)
        return w, delta, gamma

    def cg_body(self, alpha, beta, x, r, p, s, w) -> tuple:
        """Merged-CG's four vector updates in one pass (shard-local)."""
        return ops.cg_body(alpha, beta, x, r, p, s, w)
