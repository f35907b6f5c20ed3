"""Symmetric SOR preconditioner via the red-black colouring (counterpart of
``repro/precond/ssor.py``, whose docstring gives the design).

One apply runs, per sweep, the relaxed half-sweeps red, black | black, red
(forward then backward SOR) on ``A z = r`` from ``z = 0``; the palindromic
sequence keeps ``M`` symmetric, so ``pcg`` applies for ``0 < ω < 2``.  The
half-sweep is ``Stencil.offdiag_apply_padded`` over the operator's
``pad_exchange`` (the machinery of ``gauss_seidel_rb``); it has no kernel of
its own.  Zero reductions.
"""

from __future__ import annotations

import torch

from repro_torch.core.methods import _colour_mask
from repro_torch.precond.base import Preconditioner, register_preconditioner


@register_preconditioner
class SSOR(Preconditioner):
    """Red-black symmetric SOR: forward (red, black) + backward (black, red)."""

    name = "ssor"
    spd_preserving = True
    halo_hide = "none"                  # half-sweeps read halos immediately

    def __init__(self, omega: float = 1.0, sweeps: int = 1):
        if not 0.0 < omega < 2.0:
            raise ValueError(f"SSOR needs 0 < omega < 2, got {omega}")
        if sweeps < 1:
            raise ValueError(f"sweeps must be >= 1, got {sweeps}")
        self.omega = omega
        self.sweeps = sweeps

    def _half_sweep(self, A, r, z, mask) -> torch.Tensor:
        off = A.stencil.offdiag_apply_padded(A.pad_exchange(z))
        relaxed = (1.0 - self.omega) * z + self.omega * (r - off) / A.diag
        return torch.where(mask, relaxed, z)

    def apply(self, state, A, r: torch.Tensor) -> torch.Tensor:
        shape = tuple(r.shape[-3:])       # the grid; lanes lead, if any
        red = _colour_mask(shape, 0, r.device)
        black = _colour_mask(shape, 1, r.device)
        # the first half-sweep acts on z = 0, so its exchange and off-diagonal
        # apply are all-zeros work: fold it into the initial guess
        z = torch.where(red, self.omega * r / A.diag, torch.zeros_like(r))
        masks = [red, black, black, red] * self.sweeps
        for mask in masks[1:]:
            z = self._half_sweep(A, r, z, mask)
        return z

    @property
    def matvecs_per_apply(self) -> int:
        # 4 half-sweeps per sweep, minus the folded-away first one
        return 4 * self.sweeps - 1

    @property
    def halo_matvecs_per_apply(self) -> int:
        return 4 * self.sweeps - 1

    def touched_elements_per_apply(self, nbar: int) -> int:
        # init (read r, write z) + per half-sweep: off-diagonal apply
        # (nbar+1) + read r,z / write z
        return 2 + (4 * self.sweeps - 1) * (nbar + 1 + 3)

    def describe(self) -> str:
        return f"ssor(omega={self.omega}, sweeps={self.sweeps})"
