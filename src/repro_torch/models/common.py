"""Shared model components: norms, RoPE/M-RoPE, initialisers, masks.

Counterpart of ``repro/models/common.py``.  The initialisers draw from an
explicit ``torch.Generator`` on the device the tensor is made on.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             offset: float = 0.0) -> torch.Tensor:
    """RMSNorm: variance in f32, application in the input dtype (the
    reference's rule: ``rsqrt`` is cast back to x's dtype before the
    products, whatever x's dtype is, f64 included)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    r = torch.rsqrt(var + eps).to(x.dtype)
    return x * r * (offset + scale.float()).to(x.dtype)


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if not cap:
        return logits
    return cap * torch.tanh(logits / cap)


# -----------------------------------------------------------------------------
# Rotary embeddings
# -----------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, dtype=torch.float32,
               device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=dtype, device=device) / half))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Half-split rotation (not interleaved) of x (B, S, H, D) by the f32
    angles ang (B, S, D/2)."""
    half = x.shape[-1] // 2
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) integer."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.

    ``positions``: (3, B, S) — temporal/height/width position ids; the rotary
    half-dim is split into ``sections`` (e.g. (16, 24, 24) for head_dim 128),
    each section rotated by its own position stream.  For pure text the three
    streams are identical and M-RoPE reduces to RoPE.
    """
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    sec_id = torch.repeat_interleave(
        torch.arange(len(sections), device=x.device),
        torch.tensor(sections, device=x.device))          # (half,)
    pos = positions[sec_id].movedim(0, -1)                # (B, S, half)
    return _rotate(x, pos.float() * freqs)


# -----------------------------------------------------------------------------
# Masks
# -----------------------------------------------------------------------------

NEG_INF = -2.3819763e38  # as used by flax/maxtext for bf16-safe masking


def causal_mask(q_len: int, kv_len: int, *, q_offset: int = 0, window: int = 0,
                device=None) -> torch.Tensor:
    """(q_len, kv_len) boolean mask; True = attend.

    ``q_offset`` is the absolute position of query 0 (decode: cache length).
    ``window`` > 0 restricts to a sliding window of that many positions.
    """
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    m = k_pos <= q_pos
    if window:
        m &= k_pos > (q_pos - window)
    return m


# -----------------------------------------------------------------------------
# Initialisation (f32 draws cast to ``dtype``, as the reference draws them)
# -----------------------------------------------------------------------------

def dense_init(generator: torch.Generator, shape, in_axis_size: int, dtype) -> torch.Tensor:
    u = torch.empty(shape, dtype=torch.float32, device=generator.device)
    u.uniform_(-1.0, 1.0, generator=generator)
    return (u * in_axis_size ** -0.5).to(dtype)


def normal_init(generator: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    """``N(0, std²)``: the reference's inline draws of the attention and MLP
    weights (``jax.random.normal(...) * std``)."""
    n = torch.randn(shape, dtype=torch.float32, device=generator.device,
                    generator=generator)
    return (n * std).to(dtype)


def embed_init(generator: torch.Generator, shape, dtype) -> torch.Tensor:
    return normal_init(generator, shape, 0.02, dtype)


def weight(generator: torch.Generator | None, shape, std: float, *, dtype,
           device) -> torch.nn.Parameter:
    """A weight drawn ``N(0, std²)`` from ``generator``; zeros where there is
    none (a model that ``models.convert`` fills from the reference's)."""
    if generator is None:
        return torch.nn.Parameter(torch.zeros(shape, dtype=dtype, device=device))
    return torch.nn.Parameter(normal_init(generator, shape, std, dtype).to(device))


def constant(shape, value: float, *, dtype, device) -> torch.nn.Parameter:
    """A norm scale (ones) or a bias (zeros), as the reference initialises them."""
    return torch.nn.Parameter(torch.full(shape, value, dtype=dtype, device=device))
