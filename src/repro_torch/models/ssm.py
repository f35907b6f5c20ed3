"""Mamba-2 SSD (state-space duality) blocks.  Counterpart of
``repro/models/ssm.py`` on one device.

The chunked algorithm turns the linear recurrence into per-chunk products:
within a chunk of Q positions an attention-like (Q, Q) matrix, across chunks
a state h (B, nH, P, N) carried by a loop over the S/Q chunks (the
reference's ``lax.scan``).  Where S is not a multiple of ``cfg.ssm_chunk``,
Q falls back to the largest divisor of S below it, as in the reference.

The projections are the reference's separate weights (``w_z``, ``w_x``,
``w_B``, ``w_C``, ``w_dt``), in its (in, out) layout; its sharding hints
reduce to nothing on one device.  Every SSD internal runs in f32 whatever
the model's dtype, f64 included: ``A_log``, ``D`` and ``dt_bias`` are f32
parameters, the conv outputs and dt are cast to f32 before the scan, and
decode's K-window conv runs in f32 (the forward's runs in the model's dtype,
so a bf16 decode and a bf16 forward differ by the reference's own design).

Within a chunk ``cum_i - cum_j`` is positive above the diagonal and reaches
hundreds at full width (A down to -nH, Q steps of dt): ``exp`` of it is inf
in f32 and f64.  The exponent is masked to -inf there before ``exp``, so
every exponent taken is <= 0, the contract the reference states
(``repro/models/ssm.py``'s docstring).  The reference masks after ``exp``
instead: its forward is the same (``where`` picks 0 either way) but its
backward multiplies a zero cotangent by inf, and its gradients of dt, B and
C are NaN at full width; the port's stay finite and equal the reference's
wherever those are finite.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import constant, rms_norm, weight

#: dt's log-uniform range at init (the reference's)
DT_MIN, DT_MAX = 1e-3, 0.1


class SSM(nn.Module):
    """``w_z``, ``w_x`` (d, di); ``w_B``, ``w_C`` (d, N); ``w_dt`` (d, nH);
    ``conv_x`` (K, di), ``conv_B``, ``conv_C`` (K, N) and their biases;
    ``norm`` (di); ``out_proj`` (di, d); ``A_log``, ``D``, ``dt_bias`` (nH),
    always f32.

    With a ``generator`` the weights are drawn from it with the reference's
    distributions (normal, scaled by d^-½, K^-½ and di^-½; dt log-uniform on
    [1e-3, 0.1] and ``dt_bias`` its inverse softplus); without one they are
    zeros, for ``models.convert`` to fill.  ``A_log = log(1..nH)``, ``D = 1``
    and the norm's ones either way."""

    def __init__(self, cfg: ArchConfig, *, dtype, device,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        d, di, N, nH, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.conv_kernel
        kw = dict(dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.w_z = weight(generator, (d, di), d ** -0.5, **kw)
        self.w_x = weight(generator, (d, di), d ** -0.5, **kw)
        self.w_B = weight(generator, (d, N), d ** -0.5, **kw)
        self.w_C = weight(generator, (d, N), d ** -0.5, **kw)
        self.w_dt = weight(generator, (d, nH), d ** -0.5, **kw)
        self.conv_x = weight(generator, (K, di), K ** -0.5, **kw)
        self.conv_B = weight(generator, (K, N), K ** -0.5, **kw)
        self.conv_C = weight(generator, (K, N), K ** -0.5, **kw)
        self.conv_bx = constant((di,), 0.0, **kw)
        self.conv_bB = constant((N,), 0.0, **kw)
        self.conv_bC = constant((N,), 0.0, **kw)
        self.A_log = nn.Parameter(torch.log(torch.arange(1, nH + 1, **f32)))
        self.D = constant((nH,), 1.0, **f32)
        self.dt_bias = constant((nH,), 0.0, **f32)
        if generator is not None:
            u = torch.rand((nH,), generator=generator, **f32)
            dt = torch.exp(u * (math.log(DT_MAX) - math.log(DT_MIN)) + math.log(DT_MIN))
            with torch.no_grad():
                self.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
        self.norm = constant((di,), 1.0, **kw)
        self.out_proj = weight(generator, (di, d), di ** -0.5, **kw)

    def forward(self, x: torch.Tensor, *, return_cache: bool = False):
        return ssm_forward(self, self.cfg, x, return_cache=return_cache)


def init_ssm_params(cfg: ArchConfig, generator: torch.Generator, dtype) -> SSM:
    """An SSD block of ``cfg`` on the generator's device, drawn from it."""
    return SSM(cfg, dtype=dtype, device=generator.device, generator=generator)


def init_ssm_cache(cfg: ArchConfig, batch: int, dtype, device) -> dict:
    """``conv`` (B, K-1, di + 2N): the last K-1 raw (pre-conv) x, B and C
    rows, in the model's dtype; ``state`` (B, nH, P, N) in f32."""
    di, N, nH, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.conv_kernel
    return {
        "conv": torch.zeros((batch, K - 1, di + 2 * N), dtype=dtype, device=device),
        "state": torch.zeros((batch, nH, cfg.ssm_head_dim, N), dtype=torch.float32,
                             device=device),
    }


def chunk_size(cfg: ArchConfig, S: int) -> int:
    """``cfg.ssm_chunk``, or the largest divisor of S below it where S is
    not a multiple of it (the reference's fallback: no padding)."""
    Q = cfg.ssm_chunk
    if S % Q:
        Q = next(q for q in range(min(Q, S), 0, -1) if S % q == 0)
    return Q


def _causal_conv(u, w, b):
    """Depthwise causal conv of kernel K over (B, S, C): the K shifted adds
    in the reference's order, then SiLU, in u's dtype."""
    K, S = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, K - 1, 0))
    y = sum(pad[:, k: k + S] * w[k] for k in range(K))
    return F.silu(y + b)


def _projections(p: SSM, x):
    return x @ p.w_z, x @ p.w_x, x @ p.w_B, x @ p.w_C, x @ p.w_dt


def _chunk_step(h, xck, Bck, Cck, dtc, A, tri):
    """One chunk: (B, Q, nH, P) x, (B, Q, N) B and C, (B, Q, nH) dt, all f32,
    and the carried h → (h after the chunk, y (B, Q, nH, P))."""
    a = dtc * A                                             # (B,Q,nH) <= 0
    cum = torch.cumsum(a, dim=1)
    CB = torch.einsum("bin,bjn->bij", Cck, Bck)             # (B,Q,Q)
    # masked before exp: above the diagonal the exponent is positive and may
    # overflow, and exp(-inf) = 0 keeps inf out of the backward too
    mask = tri[None, :, :, None]
    decay = torch.exp(torch.where(mask, cum[:, :, None, :] - cum[:, None, :, :],
                                  -torch.inf))                   # (B,Q,Q,nH)
    M = torch.where(mask, CB[..., None] * decay * dtc[:, None, :, :], 0.0)
    y = torch.einsum("bijh,bjhp->bihp", M, xck)
    y = y + torch.einsum("bin,bhpn->bihp", Cck, h) * torch.exp(cum)[..., None]
    a_sum = cum[:, -1]                                      # (B,nH)
    carry_decay = torch.exp(a_sum[:, None, :] - cum)        # (B,Q,nH)
    h_new = (torch.exp(a_sum)[:, :, None, None] * h
             + torch.einsum("bjh,bjn,bjhp->bhpn", carry_decay * dtc, Bck, xck))
    return h_new, y


def ssm_forward(p: SSM, cfg: ArchConfig, x, *, return_cache: bool = False):
    """Chunked SSD over the full sequence.  x: (B, S, d) → out (B, S, d) in
    x's dtype; with ``return_cache`` also the decode cache after position
    S-1: ``conv`` the raw tail of the last K-1 positions (zero rows first
    where S < K-1), ``state`` h's final value."""
    B, S, _ = x.shape
    di, N, nH, P_ = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    Q = chunk_size(cfg, S)
    z, xr, Br, Cr, dt = _projections(p, x)
    xc = _causal_conv(xr, p.conv_x, p.conv_bx)
    Bc = _causal_conv(Br, p.conv_B, p.conv_bB)
    Cc = _causal_conv(Cr, p.conv_C, p.conv_bC)
    xs = xc.reshape(B, S, nH, P_).float()
    Bm, Cm = Bc.float(), Cc.float()                         # (B,S,N): one group
    dt = F.softplus(dt.float() + p.dt_bias)                 # (B,S,nH)
    A = -torch.exp(p.A_log)                                 # (nH,)

    nc = S // Q
    xs_c = xs.reshape(B, nc, Q, nH, P_)
    B_c, C_c = Bm.reshape(B, nc, Q, N), Cm.reshape(B, nc, Q, N)
    dt_c = dt.reshape(B, nc, Q, nH)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    h = torch.zeros((B, nH, P_, N), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        h, y_c = _chunk_step(h, xs_c[:, c], B_c[:, c], C_c[:, c], dt_c[:, c], A, tri)
        ys.append(y_c)
    y = torch.cat(ys, dim=1)                                # (B,S,nH,P)
    y = y + p.D[:, None] * xs
    y = y.reshape(B, S, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p.norm, cfg.norm_eps)
    out = y @ p.out_proj
    if return_cache:
        K = cfg.conv_kernel
        raw = torch.cat([xr, Br, Cr], dim=-1)
        tail = F.pad(raw, (0, 0, K - 1, 0))[:, S: S + K - 1]
        return out, {"conv": tail.to(x.dtype), "state": h}
    return out


def ssm_decode(p: SSM, cfg: ArchConfig, x, cache: dict):
    """One-token SSD step.  x: (B, 1, d) → (out (B, 1, d), cache).

    The cache is written in place, as ``attn_decode`` writes its slot:
    ``conv`` shifted by one row with this token's raw x, B and C last,
    ``state`` the updated h; the same dict is returned."""
    B = x.shape[0]
    di, N, nH, P_ = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xr, Br, Cr, dt = _projections(p, x)
    raw = torch.cat([xr[:, 0], Br[:, 0], Cr[:, 0]], dim=-1)          # (B, ch)
    full = torch.cat([cache["conv"], raw[:, None, :]], dim=1)             # (B,K,ch)

    def conv1(w, b, lo, hi):
        seg = full[:, :, lo:hi].float()
        return F.silu(torch.einsum("bkc,kc->bc", seg, w.float()) + b.float())

    xc = conv1(p.conv_x, p.conv_bx, 0, di)
    Bm = conv1(p.conv_B, p.conv_bB, di, di + N)
    Cm = conv1(p.conv_C, p.conv_bC, di + N, di + 2 * N)
    xs = xc.reshape(B, nH, P_)
    dtv = F.softplus(dt[:, 0].float() + p.dt_bias)                   # (B,nH)
    A = -torch.exp(p.A_log)
    decay = torch.exp(dtv * A)                                       # (B,nH)
    h = (decay[:, :, None, None] * cache["state"]
         + torch.einsum("bh,bn,bhp->bhpn", dtv, Bm, xs))
    y = torch.einsum("bn,bhpn->bhp", Cm, h) + p.D[:, None] * xs
    y = y.reshape(B, di).to(x.dtype)
    y = rms_norm(y * F.silu(z[:, 0]), p.norm, cfg.norm_eps)
    out = (y @ p.out_proj)[:, None, :]
    cache["conv"].copy_(full[:, 1:])
    cache["state"].copy_(h)
    return out, cache
