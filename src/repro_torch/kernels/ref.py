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


def stencil_spmv_dots3_ref(xp: torch.Tensor, r: torch.Tensor, *, stencil: Stencil):
    """SpMV + the reduction triple: ``(A x, (A x)·x, r·x, r·r)``."""
    y = stencil.matvec_padded(xp)
    x = xp[1:-1, 1:-1, 1:-1]
    acc = _acc_dtype(xp)
    ya = y.to(acc)
    xa = x.to(acc)
    ra = r.to(acc)
    return y, torch.sum(ya * xa), torch.sum(ra * xa), torch.sum(ra * ra)


def fused_cg_body_ref(alpha, beta, x, r, p, s, w):
    """Merged-CG vector updates: p' = r+βp, s' = w+βs, x' = x+αp', r' = r−αs'."""
    p_new = r + beta * p
    s_new = w + beta * s
    return x + alpha * p_new, r - alpha * s_new, p_new, s_new


def fused_dots_ref(a, b, c):
    """Stacked partial dots ``(a·b, c·b, a·a)`` (pipelined PCG's triple)."""
    acc = _acc_dtype(a)
    aa = a.to(acc)
    ba = b.to(acc)
    ca = c.to(acc)
    return torch.sum(aa * ba), torch.sum(ca * ba), torch.sum(aa * aa)


def fused_pipe_body_ref(alpha, beta, x, r, w, p, s, z, n):
    """Pipelined CG's six recurrences (Ghysels–Vanroose ordering)."""
    z_new = n + beta * z
    s_new = w + beta * s
    p_new = r + beta * p
    return (x + alpha * p_new, r - alpha * s_new, w - alpha * z_new,
            p_new, s_new, z_new)


def fused_pcg_body_ref(alpha, beta, x, r, u, p, s, w):
    """Merged PCG's updates: p' = u+βp, s' = w+βs, x' = x+αp', r' = r−αs'."""
    p_new = u + beta * p
    s_new = w + beta * s
    return x + alpha * p_new, r - alpha * s_new, p_new, s_new


def fused_ppipe_body_ref(alpha, beta, x, r, u, w, p, s, q, z, m, n):
    """Pipelined PCG's eight recurrences."""
    z_new = n + beta * z
    q_new = m + beta * q
    s_new = w + beta * s
    p_new = u + beta * p
    return (x + alpha * p_new, r - alpha * s_new, u - alpha * q_new,
            w - alpha * z_new, p_new, s_new, q_new, z_new)


def bicgstab_spmv_dots_ref(zp, z, r, w, s, rhat, t, alpha, *, stencil: Stencil):
    """First BiCGStab sweep: ``v = A·z̃``, ``q = r − αs``, ``y = w − αz`` and
    the nine partials ``(q·y, y·y, q·q, r̂·q, r̂·y, r̂·t, r̂·v, r̂·z, r̂·s)``."""
    v = stencil.matvec_padded(zp)
    q = r - alpha * s
    y = w - alpha * z
    acc = _acc_dtype(zp)

    def d(a, b):
        return torch.sum(a.to(acc) * b.to(acc))

    parts = (d(q, y), d(y, y), d(q, q), d(rhat, q), d(rhat, y),
             d(rhat, t), d(rhat, v), d(rhat, z), d(rhat, s))
    return v, q, y, parts


def bicgstab_update1_ref(alpha, omega, y, p, q, yv, t, v):
    """BiCGStab ω-half: y' = y+αp+ωq, r' = q−ω·yv, w' = yv−ω(t−αv)."""
    return (y + alpha * p + omega * q,
            q - omega * yv,
            yv - omega * (t - alpha * v))


def bicgstab_spmv_update_ref(wp, w, r, p, s, z, v, omega, beta, *,
                             stencil: Stencil):
    """Second BiCGStab sweep: ``t' = A·w̃`` and the direction recurrences
    p' = r+β(p−ωs), s' = w+β(s−ωz), z' = t'+β(z−ωv)."""
    t_new = stencil.matvec_padded(wp)
    return (t_new,
            r + beta * (p - omega * s),
            w + beta * (s - omega * z),
            t_new + beta * (z - omega * v))


def cheb_fused_step_ref(zp: torch.Tensor, r: torch.Tensor, d: torch.Tensor, *,
                        stencil: Stencil, a: float, c: float):
    """One Chebyshev step: ``(z + d', d')`` with ``d' = a·d + c·(r − A z)``."""
    az = stencil.matvec_padded(zp)
    d_new = a * d + c * (r - az)
    return zp[1:-1, 1:-1, 1:-1] + d_new, d_new


def block_jacobi_sweep_ref(zp: torch.Tensor, r: torch.Tensor, *, stencil: Stencil,
                           omega: float = 1.0) -> torch.Tensor:
    """One damped Jacobi sweep ``z + ω·(r − A z)/diag`` from the zero-padded
    ``zp`` (on CUDA eager PyTorch divides by the Python number ``diag`` as a
    multiply by its reciprocal, on the CPU it divides)."""
    az = stencil.matvec_padded(zp)
    return zp[1:-1, 1:-1, 1:-1] + omega * (r - az) / stencil.diag
