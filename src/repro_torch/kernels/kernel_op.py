"""``KernelOp``: the LocalOp-protocol operator backed by the CUDA kernels.

Counterpart of ``repro/kernels/pallas_op.py::PallasOp``.  It wraps an operator
satisfying the ``LocalOp`` protocol and supplies

  * the protocol surface (``pad_exchange``/``matvec``/``matvec_local``/
    ``diag``/``dot``/``dotn``/``sum_partials``/``base``/``stencil``) with the
    stencil apply running on the SpMV kernel, and
  * the fused-iteration hooks the ``fused_step`` bodies are written against:
    ``spmv_dots``/``cg_body`` (merged CG), ``spmv_dots3``/``pcg_body``
    (merged PCG), ``spmv_dots3``/``pipe_body`` (pipelined CG),
    ``fused_dots``/``ppipe_body`` (pipelined PCG) and
    ``bicgstab_spmv_dots``/``bicgstab_update1``/``bicgstab_spmv_update``
    (single-reduction BiCGStab, both forms).

Halo exchange and the global reduction of the kernels' partials come from
the wrapped operator (zero pad and identity locally).  Tiles are fixed in the
kernels: there is no autotuning yet (ROADMAP queue 1 item 9).  The
preconditioners bind against a ``KernelOp`` like any other operator, so their
own kernels (``use_kernels``) compose inside the fused bodies.
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

    def spmv_dots3(self, x: torch.Tensor, r: torch.Tensor) -> tuple:
        """``(A·x, (A·x)·x, r·x, r·r)`` in one pass: merged PCG's reduction
        triple (``x = u``) and pipelined CG's (``x = w``, first partial
        unused); the partials are made global through the wrapped
        operator."""
        y, yx, rx, rr = ops.spmv_dots3(self.pad_exchange(x), r, self.stencil)
        yx, rx, rr = self.sum_partials(yx, rx, rr)
        return y, yx, rx, rr

    def fused_dots(self, r, u, w) -> tuple:
        """``(r·u, w·u, r·r)`` in one read pass (pipelined PCG's triple on
        carried state); the partials are made global through the wrapped
        operator."""
        return self.sum_partials(*ops.fused_dots(r, u, w))

    def pcg_body(self, alpha, beta, x, r, u, p, s, w) -> tuple:
        """Merged PCG's four vector updates in one pass (shard-local)."""
        return ops.pcg_body(alpha, beta, x, r, u, p, s, w)

    def pipe_body(self, alpha, beta, x, r, w, p, s, z, n) -> tuple:
        """Pipelined CG's six vector recurrences in one pass (shard-local)."""
        return ops.pipe_body(alpha, beta, x, r, w, p, s, z, n)

    def ppipe_body(self, alpha, beta, x, r, u, w, p, s, q, z, m, n) -> tuple:
        """Pipelined PCG's eight vector recurrences in one pass (shard-local)."""
        return ops.ppipe_body(alpha, beta, x, r, u, w, p, s, q, z, m, n)

    def bicgstab_spmv_dots(self, zi, z, r, w, s, rhat, t, alpha) -> tuple:
        """BiCGStab pass 1: ``v = A·z̃`` (``z̃ = zi`` padded; ``M(z)`` when
        preconditioned, while ``z`` streams beside it), ``q``, ``y`` and all
        nine partials, made global through the wrapped operator in one
        stacked reduction."""
        v, q, y, parts = ops.bicgstab_spmv_dots(
            self.pad_exchange(zi), z, r, w, s, rhat, t, alpha, self.stencil)
        return v, q, y, self.sum_partials(*parts)

    def bicgstab_update1(self, alpha, omega, y, p, q, yv, t, v) -> tuple:
        """BiCGStab's ω-half y/r/w updates in one pass (shard-local)."""
        return ops.bicgstab_update1(alpha, omega, y, p, q, yv, t, v)

    def bicgstab_spmv_update(self, wi, w, r, p, s, z, v, omega, beta) -> tuple:
        """BiCGStab pass 3: ``t' = A·w̃`` (``w̃ = wi`` padded) and the three
        direction recurrences."""
        return ops.bicgstab_spmv_update(self.pad_exchange(wi), w, r, p, s, z, v,
                                        omega, beta, self.stencil)
