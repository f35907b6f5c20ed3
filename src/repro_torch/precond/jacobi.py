"""Point-Jacobi and block-Jacobi preconditioners (counterpart of
``repro/precond/jacobi.py``, whose docstring gives the design).

``PointJacobi`` runs ``m`` Jacobi sweeps on ``A z = r`` from ``z = D⁻¹ r``;
on the constant HPCG diagonal one sweep only rescales, so the default is two.
Each extra sweep costs one full matvec.  ``BlockJacobi`` is the
two-stage-multisplitting preconditioner: damped Jacobi sweeps on the local
block with zero halos (``matvec_local``), no communication.  With
``use_kernels=True`` each sweep is one ``block_jacobi_sweep`` kernel pass
(``kernels.ops.jacobi_sweep``) from the zero-padded ``z``.
"""

from __future__ import annotations

import torch

from repro_torch.core.operators import pad1
from repro_torch.precond.base import Preconditioner, register_preconditioner


@register_preconditioner
class PointJacobi(Preconditioner):
    """``m``-sweep Jacobi: ``z_{k+1} = z_k + D⁻¹(r − A z_k)``, ``z_1 = D⁻¹ r``."""

    name = "jacobi"
    spd_preserving = True

    def __init__(self, sweeps: int = 2):
        if sweeps < 1:
            raise ValueError(f"sweeps must be >= 1, got {sweeps}")
        self.sweeps = sweeps

    def apply(self, state, A, r: torch.Tensor) -> torch.Tensor:
        z = r / A.diag
        for _ in range(self.sweeps - 1):
            z = z + (r - A.matvec(z)) / A.diag
        return z

    @property
    def matvecs_per_apply(self) -> int:
        return self.sweeps - 1

    @property
    def halo_matvecs_per_apply(self) -> int:
        return self.sweeps - 1          # every sweep's matvec is global

    def touched_elements_per_apply(self, nbar: int) -> int:
        # first sweep: read r, write z (2); each further sweep: one stencil
        # apply (nbar+2) + read r,z / write z (3)
        return 2 + (self.sweeps - 1) * (nbar + 2 + 3)

    def describe(self) -> str:
        return f"jacobi(sweeps={self.sweeps})"


@register_preconditioner
class BlockJacobi(Preconditioner):
    """Per-shard incomplete solve: damped Jacobi sweeps with zero halos."""

    name = "block_jacobi"
    spd_preserving = True

    def __init__(self, sweeps: int = 3, omega: float = 1.0,
                 use_kernels: bool = False):
        if sweeps < 1:
            raise ValueError(f"sweeps must be >= 1, got {sweeps}")
        if not 0.0 < omega <= 1.0:
            raise ValueError(f"omega must be in (0, 1], got {omega}")
        self.sweeps = sweeps
        self.omega = omega
        self.use_kernels = use_kernels

    def apply(self, state, A, r: torch.Tensor) -> torch.Tensor:
        z = self.omega * r / A.diag
        for _ in range(self.sweeps - 1):
            if self.use_kernels:
                from repro_torch.kernels import ops
                z = ops.jacobi_sweep(pad1(z), r, A.stencil, omega=self.omega)
            else:
                z = z + self.omega * (r - A.matvec_local(z)) / A.diag
        return z

    @property
    def matvecs_per_apply(self) -> int:
        return self.sweeps - 1

    @property
    def halo_matvecs_per_apply(self) -> int:
        return 0                        # shard-local by construction

    def touched_elements_per_apply(self, nbar: int) -> int:
        return 2 + (self.sweeps - 1) * (nbar + 2 + 3)

    def describe(self) -> str:
        return f"block_jacobi(sweeps={self.sweeps}, omega={self.omega})"
