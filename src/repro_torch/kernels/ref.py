"""Plain PyTorch versions of the ported kernels (counterpart of
``repro/kernels/ref.py``).

Each kernel wrapper in ``kernels/ops.py`` takes these for CPU tensors; the
CUDA kernels are held against them on the card.  The accumulation-dtype rule
is the reference's: partial sums accumulate in the input dtype, in float32
for bfloat16.  Every scalar argument is rounded to the operands' dtype first
(:func:`scalars_like`), as the reference rounds its coefficients; without it
PyTorch would multiply a bfloat16 tensor by a float32 scalar.  In float32
and float64 the rounding changes no bit.
"""

from __future__ import annotations

import torch

from repro_torch.core.methods import _colour_mask
from repro_torch.core.operators import Stencil


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float32 if t.dtype == torch.bfloat16 else t.dtype


def scalars_like(t: torch.Tensor, *cs) -> tuple:
    """The scalars ``cs`` rounded to ``t``'s dtype: a tensor cast to it, a
    number rounded and kept a Python number (the reference's ``astype`` of
    its coefficients, and JAX's weak typing of a Python float)."""
    return tuple(c.to(t.dtype) if isinstance(c, torch.Tensor)
                 else float(torch.tensor(float(c), dtype=t.dtype)) for c in cs)


def stencil_spmv_ref(xp: torch.Tensor, *, stencil: Stencil) -> torch.Tensor:
    return stencil.matvec_padded(xp)


def stencil_spmv_dot_ref(xp: torch.Tensor, *, stencil: Stencil):
    y = stencil.matvec_padded(xp)
    x = xp[..., 1:-1, 1:-1, 1:-1]
    acc = _acc_dtype(xp)
    return y, torch.sum(y.to(acc) * x.to(acc))


def stencil_spmv_dots_ref(xp: torch.Tensor, *, stencil: Stencil):
    """SpMV + BOTH merged-CG partials: ``(A x, (A x)·x, x·x)``."""
    y = stencil.matvec_padded(xp)
    x = xp[..., 1:-1, 1:-1, 1:-1]
    acc = _acc_dtype(xp)
    ya = y.to(acc)
    xa = x.to(acc)
    return y, torch.sum(ya * xa), torch.sum(xa * xa)


def stencil_spmv_dots3_ref(xp: torch.Tensor, r: torch.Tensor, *, stencil: Stencil):
    """SpMV + the reduction triple: ``(A x, (A x)·x, r·x, r·r)``."""
    y = stencil.matvec_padded(xp)
    x = xp[..., 1:-1, 1:-1, 1:-1]
    acc = _acc_dtype(xp)
    ya = y.to(acc)
    xa = x.to(acc)
    ra = r.to(acc)
    return y, torch.sum(ya * xa), torch.sum(ra * xa), torch.sum(ra * ra)


def fused_cg_body_ref(alpha, beta, x, r, p, s, w):
    """Merged-CG vector updates: p' = r+βp, s' = w+βs, x' = x+αp', r' = r−αs'."""
    alpha, beta = scalars_like(x, alpha, beta)
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
    alpha, beta = scalars_like(x, alpha, beta)
    z_new = n + beta * z
    s_new = w + beta * s
    p_new = r + beta * p
    return (x + alpha * p_new, r - alpha * s_new, w - alpha * z_new,
            p_new, s_new, z_new)


def fused_pcg_body_ref(alpha, beta, x, r, u, p, s, w):
    """Merged PCG's updates: p' = u+βp, s' = w+βs, x' = x+αp', r' = r−αs'."""
    alpha, beta = scalars_like(x, alpha, beta)
    p_new = u + beta * p
    s_new = w + beta * s
    return x + alpha * p_new, r - alpha * s_new, p_new, s_new


def fused_ppipe_body_ref(alpha, beta, x, r, u, w, p, s, q, z, m, n):
    """Pipelined PCG's eight recurrences."""
    alpha, beta = scalars_like(x, alpha, beta)
    z_new = n + beta * z
    q_new = m + beta * q
    s_new = w + beta * s
    p_new = u + beta * p
    return (x + alpha * p_new, r - alpha * s_new, u - alpha * q_new,
            w - alpha * z_new, p_new, s_new, q_new, z_new)


def bicgstab_spmv_dots_ref(zp, z, r, w, s, rhat, t, alpha, *, stencil: Stencil):
    """First BiCGStab sweep: ``v = A·z̃``, ``q = r − αs``, ``y = w − αz`` and
    the nine partials ``(q·y, y·y, q·q, r̂·q, r̂·y, r̂·t, r̂·v, r̂·z, r̂·s)``."""
    (alpha,) = scalars_like(z, alpha)
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
    alpha, omega = scalars_like(y, alpha, omega)
    return (y + alpha * p + omega * q,
            q - omega * yv,
            yv - omega * (t - alpha * v))


def bicgstab_spmv_update_ref(wp, w, r, p, s, z, v, omega, beta, *,
                             stencil: Stencil):
    """Second BiCGStab sweep: ``t' = A·w̃`` and the direction recurrences
    p' = r+β(p−ωs), s' = w+β(s−ωz), z' = t'+β(z−ωv)."""
    omega, beta = scalars_like(w, omega, beta)
    t_new = stencil.matvec_padded(wp)
    return (t_new,
            r + beta * (p - omega * s),
            w + beta * (s - omega * z),
            t_new + beta * (z - omega * v))


def cheb_fused_step_ref(zp: torch.Tensor, r: torch.Tensor, d: torch.Tensor, *,
                        stencil: Stencil, a: float, c: float):
    """One Chebyshev step: ``(z + d', d')`` with ``d' = a·d + c·(r − A z)``."""
    a, c = scalars_like(zp, a, c)
    az = stencil.matvec_padded(zp)
    d_new = a * d + c * (r - az)
    return zp[..., 1:-1, 1:-1, 1:-1] + d_new, d_new


def block_jacobi_sweep_ref(zp: torch.Tensor, r: torch.Tensor, *, stencil: Stencil,
                           omega: float = 1.0) -> torch.Tensor:
    """One damped Jacobi sweep ``z + ω·(r − A z)/diag`` from the zero-padded
    ``zp`` (on CUDA eager PyTorch divides by the Python number ``diag`` as a
    multiply by its reciprocal, formed in float32 for bfloat16; on the CPU it
    divides)."""
    (omega,) = scalars_like(zp, omega)
    az = stencil.matvec_padded(zp)
    return zp[..., 1:-1, 1:-1, 1:-1] + omega * (r - az) / stencil.diag


def fused_axpby_ref(a, x, b, y, c, z):
    """The paper's ad hoc update ``a·x + b·y + c·z``."""
    a, b, c = scalars_like(x, a, b, c)
    return a * x + b * y + c * z


def fused_axpby_dot_ref(a, x, b, y, c, z, w):
    """``(out, Σ out·w)`` with ``out = a·x + b·y + c·z``."""
    a, b, c = scalars_like(x, a, b, c)
    out = a * x + b * y + c * z
    acc = _acc_dtype(x)
    return out, torch.sum(out.to(acc) * w.to(acc))


def cg_fused_update_ref(beta, r, ar, p, ap):
    """CG-NB's Alg. 1 lines 6–8: ``(p', Ap', Σ Ap'·p')`` with ``p' = r + β·p``
    and ``Ap' = Ar + β·Ap``."""
    (beta,) = scalars_like(r, beta)
    p_new = r + beta * p
    ap_new = ar + beta * ap
    acc = _acc_dtype(r)
    return p_new, ap_new, torch.sum(ap_new.to(acc) * p_new.to(acc))


def rb_gs_half_sweep_ref(xp: torch.Tensor, b: torch.Tensor, *, stencil: Stencil,
                         colour: int) -> torch.Tensor:
    """One red-black Gauss-Seidel half-sweep from the padded old iterate:
    ``(b − (A − D) x)/diag`` where ``(i + j + k) % 2 == colour``, ``x``
    elsewhere (``core.methods._rb_half_sweep``'s arithmetic)."""
    off = stencil.offdiag_apply_padded(xp)
    mask = _colour_mask(tuple(b.shape[-3:]), colour, b.device)
    return torch.where(mask, (b - off) / stencil.diag, xp[..., 1:-1, 1:-1, 1:-1])


#: the finite value a masked attention logit takes (the reference's NEG_INF)
NEG_INF = -2.3819763e38


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        window: int = 0) -> torch.Tensor:
    """Causal softmax attention, full-matrix form (q/k/v: (B, S, H, hd), KV
    already repeated to H): the logits in the inputs' dtype, then f32 and
    scaled by hd^-½; key j kept for query i when j ≤ i and, with a window,
    j > i − window; the weights cast to ``v``'s dtype after the softmax."""
    B, S, H, hd = q.shape
    logits = torch.einsum("bshn,bthn->bhst", q, k).to(torch.float32)
    logits = logits * hd ** -0.5
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(S, device=q.device)[None, :]
    mask = kp <= qp
    if window:
        mask &= kp > (qp - window)
    logits = torch.where(mask[None, None], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthn->bshn", w, v)


def attention_bf16_error(out: torch.Tensor, o32: torch.Tensor,
                         plain: torch.Tensor) -> dict:
    """How far a bf16 attention output ``out`` lies from ``o32``, the plain
    version in f32 on the same bf16 inputs, beside the plain bf16 version
    ``plain``'s own distance from it.  ``ratio`` is the largest
    |out − o32| / (2·|plain − o32| + 2⁻⁷·|o32| + 2⁻⁶·rms), element by
    element, where rms is o32's over the hd outputs of each (query, head):
    2⁻⁷·|o32| covers rounding the output to bf16, and the rms term the
    rounding of p to bf16, whose error does not shrink where an output
    crosses zero.  ``frob`` and ``plain_frob`` are ‖out − o32‖ and
    ‖plain − o32‖.  The bf16 kernel passes with ``ratio <= 1`` and
    ``frob <= 2·plain_frob``."""
    o32 = o32.float()
    err = (out.float() - o32).abs()
    plain_err = (plain.float() - o32).abs()
    rms = o32.pow(2).mean(-1, keepdim=True).sqrt()
    limit = 2 * plain_err + 2.0 ** -7 * o32.abs() + 2.0 ** -6 * rms
    return dict(max_abs_err=float(err.max()), ratio=float((err / limit).max()),
                frob=float(err.norm()), plain_frob=float(plain_err.norm()))
