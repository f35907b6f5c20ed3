"""GQA attention: RoPE/M-RoPE, QKV bias, QK-norm, softcap, sliding window,
unified full/rolling KV cache for prefill+decode.

Counterpart of ``repro/models/attention.py``: causal self-attention, the
enc-dec encoder's bidirectional self-attention (:func:`encoder_attn`) and the
decoder's cross-attention over the encoder's output (:func:`cross_kv`,
:func:`cross_forward`; no RoPE and no QK-norm on the cross q or k).

Cache layout (per layer): ``k``/``v``: (B, C, KV, hd), ``pos``: (C,) int64 —
the absolute position held in each slot (-1 = empty).  ``C`` equals the max
sequence length for full attention or the sliding window for local layers;
decode writes slot ``pos % C``, which makes the same code path serve both.
RoPE is applied *before* caching, so rolling slots stay correct.  Decode
writes its slot in place: the reference's where-mask over the whole cache
writes the same values (it is a GSPMD workaround, not a semantic).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.collectives import param
from repro_torch.models.common import (NEG_INF, apply_mrope, apply_rope, causal_mask,
                                       constant, rms_norm, softcap, weight)


class Attention(nn.Module):
    """The projections in the reference's (in, out) layout: ``wq`` (d, H·hd),
    ``wk``/``wv`` (d, KV·hd), ``wo`` (H·hd, d); biases and QK-norm scales
    where the config has them."""

    def __init__(self, cfg: ArchConfig, *, dtype, device,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        kw = dict(dtype=dtype, device=device)
        self.wq = weight(generator, (d, H * hd), d ** -0.5, **kw)
        self.wk = weight(generator, (d, KV * hd), d ** -0.5, **kw)
        self.wv = weight(generator, (d, KV * hd), d ** -0.5, **kw)
        self.wo = weight(generator, (H * hd, d), (H * hd) ** -0.5, **kw)
        if cfg.qkv_bias:
            self.bq = constant((H * hd,), 0.0, **kw)
            self.bk = constant((KV * hd,), 0.0, **kw)
            self.bv = constant((KV * hd,), 0.0, **kw)
        if cfg.qk_norm:
            self.q_norm = constant((hd,), 1.0, **kw)
            self.k_norm = constant((hd,), 1.0, **kw)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *, window: int = 0):
        return attn_forward(self, self.cfg, x, positions, window=window)


def init_attn_cache(cfg: ArchConfig, batch: int, cache_len: int, window: int,
                    dtype, device) -> dict:
    C = min(cache_len, window) if window else cache_len
    KV, hd = cfg.n_kv_heads, cfg.hd
    return {
        "k": torch.zeros((batch, C, KV, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, C, KV, hd), dtype=dtype, device=device),
        "pos": torch.full((C,), -1, dtype=torch.int64, device=device),
    }


def _heads(par, cfg: ArchConfig):
    """This rank's query heads on a mesh, (first, count), or None where
    every head is computed here (off a mesh, one ``model`` rank, or H does
    not split over it: the attention then runs replicated)."""
    return None if par is None else par.split(cfg.n_heads)


def _project_qkv(p: Attention, cfg: ArchConfig, x, positions, par=None):
    """q (B,S,H,hd) and k, v (B,S,KV,hd), RoPE'd.

    On a mesh whose ``model`` axis splits the heads, q holds this rank's
    H/tp heads (``wq`` and ``bq`` column-parallel on ``x`` passed through
    ``copy_tp``); GQA keeps K/V replicated over ``model`` (every rank
    computes every KV head from ``x`` itself, the reference's repeat form),
    MHA splits them like q."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    heads = _heads(par, cfg)
    if heads is None:
        xq = xk = x
        q_cols = kv_cols = None
    else:
        def q_cols(r):
            first, count = par.part(cfg.n_heads, r)
            return [(first * hd, count * hd)]
        xq = par.copy_tp(x)
        mha = KV == H
        xk, kv_cols = (xq, q_cols) if mha else (x, None)
        H, KV = heads[1], (heads[1] if mha else KV)

    def w(t, cols):
        return param(par, t, dim=t.dim() - 1, ranges=cols) if cols else param(par, t)

    q = xq @ w(p.wq, q_cols)
    k = xk @ w(p.wk, kv_cols)
    v = xk @ w(p.wv, kv_cols)
    if cfg.qkv_bias:
        q, k, v = q + w(p.bq, q_cols), k + w(p.bk, kv_cols), v + w(p.bv, kv_cols)
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, param(par, p.q_norm, partitioned=heads is not None), cfg.norm_eps)
        k = rms_norm(k, param(par, p.k_norm, partitioned=kv_cols is not None), cfg.norm_eps)
    if cfg.mrope:
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _own_kv(par, cfg: ArchConfig, k, v):
    """GQA on a mesh: the KV heads this rank's query heads read (query head
    h reads KV head h // (H/KV)), one per query head, from K/V computed
    replicated (their gradient summed over ``model`` by ``copy_tp``)."""
    heads = _heads(par, cfg)
    if heads is None or cfg.n_kv_heads == cfg.n_heads:
        return k, v
    group = cfg.n_heads // cfg.n_kv_heads
    idx = torch.arange(heads[0], heads[0] + heads[1], device=k.device) // group
    return par.copy_tp(k)[:, :, idx], par.copy_tp(v)[:, :, idx]


def _repeat_kv(k, v, H: int):
    """GQA as the reference computes it: each KV head repeated H/KV times in
    place (``jnp.repeat(..., axis=2)``: head h reads KV head h // (H/KV))."""
    KV = k.shape[2]
    if KV == H:
        return k, v
    return k.repeat_interleave(H // KV, dim=2), v.repeat_interleave(H // KV, dim=2)


def _sdpa(cfg: ArchConfig, q, k, v, mask):
    """q: (B,S,H,hd), k/v: (B,T,KV,hd), mask: broadcastable to (B,H,S,T), or
    None where every entry attends (the reference's all-true mask, whose
    ``where`` changes nothing).

    The logits are the product in the model's dtype, cast to f32 after it;
    masked entries take ``NEG_INF``; the softmax weights return to v's dtype.
    """
    B, S, H, hd = q.shape
    k, v = _repeat_kv(k, v, H)
    logits = torch.einsum("bshn,bthn->bhst", q, k).float()
    logits = logits * hd ** -0.5
    if cfg.attn_softcap:
        logits = softcap(logits, cfg.attn_softcap)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhst,bthn->bshn", w, v)
    return out.reshape(B, S, H * hd)


#: sequences longer than this use the chunked online-softmax path
CHUNKED_ATTN_THRESHOLD = 2048


def _chunked_sdpa(cfg: ArchConfig, q, k, v, *, window: int,
                  n_q_chunks: int = 8, kv_chunk: int = 1024):
    """Flash-style causal attention: online softmax over KV blocks.

    Never materialises the (S, S) logits.  Queries go in ``S / n_q_chunks``
    chunks (rounded down to a divisor of S), each over the KV blocks from its
    window's first to its last causal one, with running (max, denom, acc) in
    f32: the reference's blocking and arithmetic order, one block a step.
    """
    B, S, H, hd = q.shape
    k, v = _repeat_kv(k, v, H)
    q_chunk = S // n_q_chunks
    while S % q_chunk:
        q_chunk -= 1
    kv_chunk = min(kv_chunk, S)
    while S % kv_chunk:
        kv_chunk -= 1
    scale = hd ** -0.5
    dev = q.device
    outs = []
    for qi in range(S // q_chunk):
        q0 = qi * q_chunk
        q_i = q[:, q0: q0 + q_chunk]                       # (B,bq,H,hd)
        hi = (q0 + q_chunk - 1) // kv_chunk                # last causal block
        lo = 0 if not window else max(0, (q0 - window + 1) // kv_chunk)
        q_idx = q0 + torch.arange(q_chunk, device=dev)
        m = torch.full((B, H, q_chunk), -torch.inf, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, q_chunk), dtype=torch.float32, device=dev)  # noqa: E741
        acc = torch.zeros((B, H, q_chunk, hd), dtype=torch.float32, device=dev)
        for kj in range(lo, hi + 1):
            k_b = k[:, kj * kv_chunk: (kj + 1) * kv_chunk]
            v_b = v[:, kj * kv_chunk: (kj + 1) * kv_chunk]
            s = torch.einsum("bqhn,bkhn->bhqk", q_i, k_b).float()
            s = s * scale
            if cfg.attn_softcap:
                s = softcap(s, cfg.attn_softcap)
            k_idx = kj * kv_chunk + torch.arange(kv_chunk, device=dev)
            msk = k_idx[None, :] <= q_idx[:, None]
            if window:
                msk &= k_idx[None, :] > (q_idx[:, None] - window)
            s = torch.where(msk[None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p_ = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p_.sum(dim=-1)  # noqa: E741
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhn->bhqn", p_.to(v_b.dtype), v_b).float()
            m = m_new
        o = (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)
        outs.append(o.transpose(1, 2))                     # (B,bq,H,hd)
    out = torch.cat(outs, dim=1)
    return out.reshape(B, S, H * hd)


def attn_forward(p: Attention, cfg: ArchConfig, x, positions, *, window: int = 0, par=None):
    """Full-sequence causal attention (prefill).  Returns (out, (k, v)).

    On a mesh (``par``) whose ``model`` axis splits the heads, this rank
    attends with its heads and ``wo`` is row-parallel: the partial outputs
    are summed over ``model`` once; the (k, v) returned are the ones the
    rank computed (every KV head under GQA, its own under MHA)."""
    q, k, v = _project_qkv(p, cfg, x, positions, par)
    kq, vq = _own_kv(par, cfg, k, v)
    S = x.shape[1]
    if S > CHUNKED_ATTN_THRESHOLD:
        out = _chunked_sdpa(cfg, q, kq, vq, window=window)
    else:
        mask = causal_mask(S, S, window=window, device=x.device)
        out = _sdpa(cfg, q, kq, vq, mask[None, None])
    if _heads(par, cfg) is None:
        return out @ param(par, p.wo), (k, v)

    def rows(r):
        first, count = par.part(cfg.n_heads, r)
        return [(first * cfg.hd, count * cfg.hd)]
    return par.sum_tp(out @ par.param(p.wo, dim=0, ranges=rows)), (k, v)


def prefill_cache(cfg: ArchConfig, k, v, *, cache_len: int, window: int, dtype) -> dict:
    """Build the decode cache from prefill k/v (the last C positions, each
    at slot ``pos % C``)."""
    B, S = k.shape[0], k.shape[1]
    C = min(cache_len, window) if window else cache_len
    take = min(S, C)
    cache = init_attn_cache(cfg, B, cache_len, window, dtype, k.device)
    pos_abs = torch.arange(S - take, S, device=k.device)
    slots = pos_abs % C
    cache["k"][:, slots] = k[:, S - take:].to(dtype)
    cache["v"][:, slots] = v[:, S - take:].to(dtype)
    cache["pos"][slots] = pos_abs
    return cache


def attn_decode(p: Attention, cfg: ArchConfig, x, cur_pos: int, cache: dict, *,
                window: int = 0):
    """One-token decode. x: (B, 1, d); cur_pos: the token's absolute position.
    Writes the token's k/v into slot ``cur_pos % C`` of ``cache`` in place;
    returns (out, cache)."""
    B = x.shape[0]
    positions = torch.full((B, 1), cur_pos, dtype=torch.int64, device=x.device)
    if cfg.mrope:
        positions = positions[None].expand(3, B, 1)
    q, k, v = _project_qkv(p, cfg, x, positions)
    slot = cur_pos % cache["k"].shape[1]
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    cache["pos"][slot] = cur_pos
    pos_arr = cache["pos"]
    valid = (pos_arr >= 0) & (pos_arr <= cur_pos)
    if window:
        valid &= pos_arr > (cur_pos - window)
    mask = valid[None, None, None, :]  # (1,1,1,C) -> broadcast (B,H,1,C)
    out = _sdpa(cfg, q, cache["k"], cache["v"], mask)
    return out @ p.wo, cache


def encoder_attn(p: Attention, cfg: ArchConfig, x, positions):
    """Bidirectional self-attention of the enc-dec encoder: RoPE at
    ``positions``, then ``_sdpa`` with every frame attending to every frame,
    at any length (never the causal ``_chunked_sdpa``)."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    return _sdpa(cfg, q, k, v, None) @ p.wo


# --- cross attention (enc-dec) -----------------------------------------------

def cross_forward(p: Attention, cfg: ArchConfig, x, enc_kv):
    """x: (B,S,d); enc_kv: (k, v) each (B,T,KV,hd), precomputed from the
    encoder's output (:func:`cross_kv`).  Every query attends to every frame.
    ``p`` holds the self-attention's parameter set (the reference's
    ``init_cross_params``); its k and v projections serve :func:`cross_kv`."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    q = x @ p.wq
    if cfg.qkv_bias:
        q = q + p.bq
    q = q.reshape(B, S, H, hd)
    k, v = enc_kv
    return _sdpa(cfg, q, k, v, None) @ p.wo


def cross_kv(p: Attention, cfg: ArchConfig, enc_out):
    """The cross-attention's (k, v), each (B,T,KV,hd), from the encoder's
    output (B,T,d)."""
    B, T, _ = enc_out.shape
    KV, hd = cfg.n_kv_heads, cfg.hd
    k = enc_out @ p.wk
    v = enc_out @ p.wv
    if cfg.qkv_bias:
        k, v = k + p.bk, v + p.bv
    return k.reshape(B, T, KV, hd), v.reshape(B, T, KV, hd)
