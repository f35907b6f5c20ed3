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
the wrapped operator (zero pad and identity locally); ``dotn_start``,
``sum_partials_start`` and ``fused_dots_start`` start that reduction and
return the wrapped operator's handle, so a fused body issues the work that
does not depend on it before its ``wait()``.  Where the halo is the
zero pad (``matvec_local``; ``matvec``, ``spmv_dots`` and ``spmv_dots3`` on
a base whose ``pad_exchange`` is ``LocalOp``'s), the kernel takes ``x``
unpadded and makes the halo itself, so no pad pass runs (a strided ``x``, as
the Gauss-Seidel sweeps make, is copied contiguous first, as the pad did); a
base with a real halo still pads.  ``run``, the ring pass's x-planes a
block under ``matvec``, ``matvec_local``, ``spmv_dots`` and ``spmv_dots3``,
is fixed when the operator is built: its caller reads it from
``kernels.autotune.resolve`` (``SolverSession`` does, once a session), so
the eager loop reads no file per launch and a captured graph keeps the run
it was captured with, whatever the cache file says later (the counterpart
of ``PallasOp._tiles``).  The preconditioners bind
against a ``KernelOp`` like any other operator, so their own kernels
(``use_kernels``) compose inside the fused bodies.

A batch of lanes, ``(B, nx, ny, nz)`` (the batched solve), goes through the
protocol surface: ``matvec`` and ``matvec_local`` take it to the SpMV's
lane-batched form, and ``dot``/``dotn`` reduce each lane on its own.  The
fused hooks take one grid only and raise on a batch: the batched solve runs
the unfused body, as in the reference; a batch's SpMV marches the default
run.  Over a lane-batched ``core.distributed.DistributedOp`` (the batched
solve on a mesh) ``matvec`` runs the lane-batched SpMV on the lanes padded
with the halos the neighbours sent (``pad_exchange``), the Chebyshev step
takes the same exchanged padded lanes, the block-Jacobi sweep the lanes'
zero-faced blocks (``matvec_local``'s halo), and each reduction is the mesh's
one collective over every lane's partials.
"""

from __future__ import annotations

import torch

from repro_torch.core.methods import _default_dot
from repro_torch.core.solvers import LocalOp
from repro_torch.kernels import autotune, ops


class KernelOp:
    """CUDA-kernel execution of a wrapped LocalOp-protocol operator; on CPU
    tensors every hook runs the kernels' plain versions.

    ``run`` is the ring pass's run on one grid (checked by the kernel
    wrappers; ``autotune.resolve`` gives the tuned one).
    """

    def __init__(self, base, *, run: int = autotune.DEFAULT_RUN):
        self.base = base
        self.stencil = base.stencil
        self.run = run

    def _run(self, x: torch.Tensor) -> int:
        """The ring pass's run for ``x``; a batch of lanes marches the
        default."""
        return self.run if x.dim() == 3 else autotune.DEFAULT_RUN

    @property
    def zero_halo(self) -> bool:
        """Whether the base's halo is the zero pad (``LocalOp``'s
        ``pad_exchange``), which the kernels can make themselves."""
        return getattr(type(self.base), "pad_exchange", None) is LocalOp.pad_exchange

    @property
    def diag(self) -> float:
        return self.base.diag

    @staticmethod
    def _one_grid(hook: str, x: torch.Tensor) -> None:
        if x.dim() != 3:
            raise ValueError(f"KernelOp.{hook}: the fused hooks take one (nx, ny, nz) "
                             f"grid, got shape {tuple(x.shape)} (a batch of lanes runs "
                             f"the unfused body)")

    # --- protocol surface (halos/reductions delegate to the wrapped op) ------
    def pad_exchange(self, x: torch.Tensor) -> torch.Tensor:
        return self.base.pad_exchange(x)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        if self.zero_halo:
            return ops.spmv(x.contiguous(), self.stencil, zero_halo=True, run=self._run(x))
        return ops.spmv(self.pad_exchange(x), self.stencil, run=self._run(x))

    def matvec_local(self, x: torch.Tensor) -> torch.Tensor:
        return ops.spmv(x.contiguous(), self.stencil, zero_halo=True, run=self._run(x))

    @property
    def dot(self):
        d = getattr(self.base, "dot", None)
        return d if d is not None else _default_dot

    def dotn(self, *pairs) -> tuple:
        return self.base.dotn(*pairs)

    def dotn_start(self, *pairs):
        return self.base.dotn_start(*pairs)

    def sum_partials(self, *vals) -> tuple:
        return self.base.sum_partials(*vals)

    def sum_partials_start(self, *vals):
        return self.base.sum_partials_start(*vals)

    # --- fused-iteration hooks (what MethodDef.fused_step is written against)
    def spmv_dots(self, x: torch.Tensor) -> tuple:
        """``(A·x, (A·x)·x, x·x)`` in one pass; the partials are made global
        through the wrapped operator."""
        self._one_grid("spmv_dots", x)
        run = self._run(x)
        if self.zero_halo:
            w, delta, gamma = ops.spmv_dots(x.contiguous(), self.stencil, zero_halo=True,
                                            run=run)
        else:
            w, delta, gamma = ops.spmv_dots(self.pad_exchange(x), self.stencil, run=run)
        delta, gamma = self.sum_partials(delta, gamma)
        return w, delta, gamma

    def cg_body(self, alpha, beta, x, r, p, s, w) -> tuple:
        """Merged-CG's four vector updates in one pass (shard-local)."""
        self._one_grid("cg_body", x)
        return ops.cg_body(alpha, beta, x, r, p, s, w)

    def spmv_dots3(self, x: torch.Tensor, r: torch.Tensor) -> tuple:
        """``(A·x, (A·x)·x, r·x, r·r)`` in one pass: merged PCG's reduction
        triple (``x = u``) and pipelined CG's (``x = w``, first partial
        unused); the partials are made global through the wrapped
        operator."""
        self._one_grid("spmv_dots3", x)
        run = self._run(x)
        if self.zero_halo:
            y, yx, rx, rr = ops.spmv_dots3(x.contiguous(), r, self.stencil,
                                           zero_halo=True, run=run)
        else:
            y, yx, rx, rr = ops.spmv_dots3(self.pad_exchange(x), r, self.stencil, run=run)
        yx, rx, rr = self.sum_partials(yx, rx, rr)
        return y, yx, rx, rr

    def fused_dots(self, r, u, w) -> tuple:
        """``(r·u, w·u, r·r)`` in one read pass (pipelined PCG's triple on
        carried state); the partials are made global through the wrapped
        operator."""
        return self.fused_dots_start(r, u, w).wait()

    def fused_dots_start(self, r, u, w):
        """:meth:`fused_dots` with the global reduction started, not
        waited: the handle's ``wait()`` gives the triple."""
        self._one_grid("fused_dots", r)
        return self.sum_partials_start(*ops.fused_dots(r, u, w))

    def pcg_body(self, alpha, beta, x, r, u, p, s, w) -> tuple:
        """Merged PCG's four vector updates in one pass (shard-local)."""
        self._one_grid("pcg_body", x)
        return ops.pcg_body(alpha, beta, x, r, u, p, s, w)

    def pipe_body(self, alpha, beta, x, r, w, p, s, z, n) -> tuple:
        """Pipelined CG's six vector recurrences in one pass (shard-local)."""
        self._one_grid("pipe_body", x)
        return ops.pipe_body(alpha, beta, x, r, w, p, s, z, n)

    def ppipe_body(self, alpha, beta, x, r, u, w, p, s, q, z, m, n) -> tuple:
        """Pipelined PCG's eight vector recurrences in one pass (shard-local)."""
        self._one_grid("ppipe_body", x)
        return ops.ppipe_body(alpha, beta, x, r, u, w, p, s, q, z, m, n)

    def bicgstab_spmv_dots(self, zi, z, r, w, s, rhat, t, alpha) -> tuple:
        """BiCGStab pass 1: ``v = A·z̃`` (``z̃ = zi`` padded; ``M(z)`` when
        preconditioned, while ``z`` streams beside it), ``q``, ``y`` and all
        nine partials, made global through the wrapped operator in one
        stacked reduction."""
        self._one_grid("bicgstab_spmv_dots", z)
        v, q, y, parts = ops.bicgstab_spmv_dots(
            self.pad_exchange(zi), z, r, w, s, rhat, t, alpha, self.stencil)
        return v, q, y, self.sum_partials(*parts)

    def bicgstab_update1(self, alpha, omega, y, p, q, yv, t, v) -> tuple:
        """BiCGStab's ω-half y/r/w updates in one pass (shard-local)."""
        self._one_grid("bicgstab_update1", y)
        return ops.bicgstab_update1(alpha, omega, y, p, q, yv, t, v)

    def bicgstab_spmv_update(self, wi, w, r, p, s, z, v, omega, beta) -> tuple:
        """BiCGStab pass 3: ``t' = A·w̃`` (``w̃ = wi`` padded) and the three
        direction recurrences."""
        self._one_grid("bicgstab_spmv_update", w)
        return ops.bicgstab_spmv_update(self.pad_exchange(wi), w, r, p, s, z, v,
                                        omega, beta, self.stencil)
