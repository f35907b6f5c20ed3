"""Chebyshev polynomial preconditioner (counterpart of
``repro/precond/chebyshev.py``, whose docstring gives the design).

``z = p_{k-1}(A) r`` with ``p`` the degree-``k-1`` Chebyshev polynomial for
the eigenvalue interval ``[lmin, lmax]``: ``k-1`` SpMVs and no inner
products.  The bounds default to the stencil's Gershgorin interval
``diag ± Σ|off|``.  The scalar recurrence involves only these static bounds,
so ``setup`` computes the whole coefficient schedule in Python floats, in the
reference's order; the apply is SpMVs and axpys with constant coefficients.
With ``use_kernels=True`` each step is one ``cheb_fused_step`` kernel pass
(``kernels.ops.cheb_step``): the stencil apply and both updates.

SPD: ``p`` is positive on ``[lmin, lmax] ⊃ spec(A)`` (``lmin > 0``), so
``M⁻¹ = p(A)`` is SPD and ``pcg`` applies.
"""

from __future__ import annotations

import torch

from repro_torch.precond.base import Preconditioner, register_preconditioner


def gershgorin_bounds(stencil) -> tuple[float, float]:
    """Spectral interval ``diag ± Σ|off_coeff|`` of the stencil operator."""
    s = sum(abs(stencil.off_coeff) for _ in stencil.offsets)
    return stencil.diag - s, stencil.diag + s


@register_preconditioner
class Chebyshev(Preconditioner):
    """Degree-``degree-1`` Chebyshev polynomial apply (``degree-1`` SpMVs)."""

    name = "chebyshev"
    spd_preserving = True

    def __init__(self, degree: int = 4,
                 bounds: tuple[float, float] | None = None,
                 use_kernels: bool = False):
        if degree < 1:
            raise ValueError(f"degree must be >= 1, got {degree}")
        self.degree = degree
        self.bounds = bounds
        self.use_kernels = use_kernels

    def setup(self, A) -> tuple:
        lmin, lmax = self.bounds or gershgorin_bounds(A.stencil)
        if not 0.0 < lmin < lmax:
            raise ValueError(
                f"Chebyshev needs 0 < lmin < lmax, got [{lmin}, {lmax}]; "
                f"pass explicit bounds= for indefinite/near-singular operators")
        theta = (lmax + lmin) / 2.0
        delta = (lmax - lmin) / 2.0
        sigma = theta / delta
        rho = 1.0 / sigma
        coefs = []                       # static Python floats, per step
        for _ in range(self.degree - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            coefs.append((rho_new * rho, 2.0 * rho_new / delta))
            rho = rho_new
        return (theta, tuple(coefs))

    def apply(self, state, A, r: torch.Tensor) -> torch.Tensor:
        theta, coefs = state
        z = r / theta
        d = z
        for a, c in coefs:               # d = a*d + c*(r - A z); z += d
            if self.use_kernels:
                from repro_torch.kernels import ops
                z, d = ops.cheb_step(A.pad_exchange(z), r, d, A.stencil,
                                     a=a, c=c)
            else:
                d = a * d + c * (r - A.matvec(z))
                z = z + d
        return z

    @property
    def matvecs_per_apply(self) -> int:
        return self.degree - 1

    @property
    def halo_matvecs_per_apply(self) -> int:
        return self.degree - 1

    def touched_elements_per_apply(self, nbar: int) -> int:
        # z_1 = r/theta (2) + per step: SpMV (nbar+2) + r,d,z reads/writes (5)
        return 2 + (self.degree - 1) * (nbar + 2 + 5)

    def describe(self) -> str:
        return f"chebyshev(degree={self.degree})"
