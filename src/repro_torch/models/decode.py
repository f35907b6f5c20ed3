"""Autoregressive decode: per-layer KV and SSM caches, one-token steps.

Counterpart of ``repro/models/decode.py`` for every family.  The caches are a
list with one dict per layer, in execution order: ``{"k", "v", "pos"}`` for
an attention layer; ``{"ssm": {"conv", "state"}}`` for an SSM layer (the
reference's stacked ``{"ssm": ...}`` tree, split by layer); for a hybrid
layer its attention cache plus ``"ssm"`` (the reference's ``{"attn",
"ssm"}`` trees).  Under gemma2's local/global pairing the even positions are
the reference's ``"even"`` caches (window C) and the odd ones its ``"odd"``
caches (full length); under llama4's superlayers the even positions are its
``"dense"`` caches and the odd ones its ``"moe"`` caches.  An enc-dec model's
caches are its decoder layers' self-attention caches (window 0); each of its
decode steps also takes the cross kvs, one (k, v) of the encoder's output a
decoder layer, that :func:`caches_from_prefill` hands back beside the caches
(the reference's stacked cross kvs, split by layer), and never recomputes
them.  An MoE layer's decode step takes the gather path while
B·k ≤ min(64, E − 1) (``models.moe``), which never drops an assignment.  A
decode step writes every cache in place.
"""

from __future__ import annotations

from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import rms_norm
from repro_torch.models.transformer import (ModelCtx, Transformer, _ffn, _fuse, _maybe_post,
                                            _window_flags, embed_tokens, layer_kind,
                                            logits_from_h)


def init_caches(ctx: ModelCtx, batch: int, cache_len: int) -> list[dict]:
    cfg = ctx.cfg
    kind = layer_kind(cfg)
    if kind == "ssm":
        return [{"ssm": ssm_mod.init_ssm_cache(cfg, batch, ctx.dtype, ctx.device)}
                for _ in range(cfg.n_layers)]
    caches = [attn_mod.init_attn_cache(cfg, batch, cache_len, w, ctx.dtype, ctx.device)
              for w in _window_flags(cfg)]
    if kind == "hybrid":
        for c in caches:
            c["ssm"] = ssm_mod.init_ssm_cache(cfg, batch, ctx.dtype, ctx.device)
    return caches


def _decode_layer(cfg, p, h, cur_pos: int, cache: dict, *, window: int, cross_kv=None):
    x = rms_norm(h, p.norm_attn, cfg.norm_eps)
    if p.kind == "ssm":
        y, _ = ssm_mod.ssm_decode(p.ssm, cfg, x, cache["ssm"])
        return h + cfg.residual_scale * y, cache
    a, new_cache = attn_mod.attn_decode(p.attn, cfg, x, cur_pos, cache, window=window)
    if p.kind == "hybrid":
        s, _ = ssm_mod.ssm_decode(p.ssm, cfg, x, cache["ssm"])
        a = _fuse(cfg, p, a, s)
    h = h + cfg.residual_scale * _maybe_post(cfg, p, "post_norm_attn", a)
    if cross_kv is not None:
        c = attn_mod.cross_forward(p.cross, cfg, rms_norm(h, p.norm_cross, cfg.norm_eps),
                                   cross_kv)
        h = h + cfg.residual_scale * c
    x = rms_norm(h, p.norm_mlp, cfg.norm_eps)
    m, _ = _ffn(cfg, p, x)
    h = h + cfg.residual_scale * _maybe_post(cfg, p, "post_norm_mlp", m)
    return h, new_cache


def decode_step(ctx: ModelCtx, params: Transformer, tokens, cur_pos: int,
                caches: list[dict], cross_kvs=None):
    """tokens: (B, 1); cur_pos: their absolute position; ``cross_kvs``: an
    enc-dec model's per-layer (k, v) of the encoder's output (from
    :func:`caches_from_prefill`), required for it and refused for any other.
    Returns (logits, caches), each layer's cache written in place (an
    attention cache at slot ``cur_pos % C``)."""
    cfg = ctx.cfg
    if (cross_kvs is None) == cfg.enc_dec:
        raise ValueError(f"{cfg.name}: an enc-dec model's decode step takes the prefill's "
                         f"cross kvs, any other model's none (got "
                         f"{'none' if cross_kvs is None else 'some'})")
    h = embed_tokens(ctx, params, tokens)
    new_caches = []
    for i, (layer, cache) in enumerate(zip(params.layers, caches, strict=True)):
        h, c = _decode_layer(cfg, layer, h, cur_pos, cache, window=layer.window,
                             cross_kv=None if cross_kvs is None else cross_kvs[i])
        new_caches.append(c)
    return logits_from_h(ctx, params, h), new_caches


def caches_from_prefill(ctx: ModelCtx, kvs, cache_len: int):
    """Turn ``forward(collect_kv=True)``'s per-layer (k, v) into decode
    caches.  For an enc-dec model ``kvs`` is (self kvs, cross kvs) and the
    result (caches, cross kvs): the cross kvs pass through as the prefill
    built them, for every decode step to read.  The ssm and hybrid families
    have no such path (the reference's gets no SSM state from a prefill):
    their caches come from replaying the prompt through decode steps from
    :func:`init_caches` (``launch.serve.lm_generate``)."""
    cfg = ctx.cfg
    if layer_kind(cfg) in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name} (family {cfg.family!r}): a prefill carries no SSM state; "
            f"build its caches by replaying the prompt through decode steps from "
            f"init_caches (launch.serve.lm_generate)")
    if cfg.enc_dec:
        kvs, cross_kvs = kvs
    caches = [attn_mod.prefill_cache(cfg, k, v, cache_len=cache_len, window=w,
                                     dtype=ctx.dtype)
              for (k, v), w in zip(kvs, _window_flags(cfg), strict=True)]
    return (caches, cross_kvs) if cfg.enc_dec else caches
