"""Model assembly for all ten configs: the dense, VLM, MoE, SSM, hybrid and
enc-dec families.

Counterpart of ``repro/models/transformer.py``: the dense GQA transformers
(internlm2, gemma2, minicpm, qwen2.5), the VLM backbone (qwen2-vl: M-RoPE
and precomputed ``"embeds"`` inputs from the vision stub), the MoE
transformers (qwen3-moe: an MoE layer every layer; llama4: dense and MoE
layers in turn, a shared expert), the attention-free SSD stack (mamba2: an
SSD block a layer, no MLP), the hybrid (hymba: sliding-window attention
and an SSD block on the same normed input, their normed outputs averaged,
then the MLP) and the encoder-decoder (seamless-m4t: precomputed
``"src_embeds"`` frames from the audio stub through a bidirectional encoder
stack and its final norm; each decoder layer a dense layer with a
cross-attention sublayer over the encoder's output between its
self-attention and its MLP).

The reference scans stacked ``(L, ...)`` parameters; here each layer is a
module of its own, in the order the reference runs them.  For gemma2's
local/global alternation the reference pairs stacked layer ``j`` with
stacked layer ``L/2 + j`` (``reshape(2, L//2).swapaxes(0, 1)``), so its
execution order is 0, L/2, 1, L/2 + 1, ... with even positions local.
llama4's superlayers (``moe_every = 2``) stack the dense layers and the MoE
layers apart and run dense j, then MoE j: even positions dense, odd ones MoE
(:func:`execution_order`, :func:`layer_kinds`; ``models.convert`` maps the
stacked arrays).  An enc-dec model's encoder layers are ``encoder.layers``
(the reference's stacked ``encoder.layers``), its decoder layers ``layers``.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (Attention, attn_forward, cross_forward, cross_kv,
                                          encoder_attn)
from repro_torch.models.common import constant, embed_init, rms_norm, softcap
from repro_torch.models.mlp import GatedMLP, mlp_forward

#: the layer kind of each family (the reference's ``layer_kind``)
_KINDS = {"ssm": "ssm", "hybrid": "hybrid", "moe": "moe"}


@dataclasses.dataclass(frozen=True)
class ModelCtx:
    """Everything the plain functions need besides the parameters, for one
    device (the mesh and sharding hints wait for ``distributed/sharding.py``).

    ``remat`` (the reference's default, True): where autograd records,
    :func:`forward_hidden` runs each layer (llama4's dense + MoE pair as
    one, an enc-dec decoder layer with its cross kvs) under
    ``torch.utils.checkpoint``, so the backward keeps one hidden state a
    layer and recomputes the rest; under ``torch.inference_mode`` or
    ``no_grad`` it changes nothing."""
    cfg: ArchConfig
    dtype: torch.dtype = torch.bfloat16
    device: torch.device | str = "cuda"
    remat: bool = True


def layer_kind(cfg: ArchConfig) -> str:
    """``"moe"``, ``"ssm"`` or ``"hybrid"`` for those families, ``"dense"``
    for the others (the reference's; an enc-dec model's decoder layers are
    dense layers with a cross sublayer, ``"decoder_x"`` in
    :func:`layer_kinds`)."""
    return _KINDS.get(cfg.family, "dense")


def _superlayers(cfg: ArchConfig) -> bool:
    """llama4's dense + MoE pairs (the reference's ``_scan_superlayers``)."""
    return cfg.family == "moe" and cfg.moe_every == 2


def layer_kinds(cfg: ArchConfig) -> list[str]:
    """The kind of the (decoder) layer at each execution position."""
    if cfg.enc_dec:
        return ["decoder_x"] * cfg.n_layers
    kind = layer_kind(cfg)
    if _superlayers(cfg):
        if cfg.n_layers % 2:
            raise ValueError(f"{cfg.name}: dense + MoE superlayers need an even "
                             f"n_layers, not {cfg.n_layers}")
        return ["dense", "moe"] * (cfg.n_layers // 2)
    return [kind] * cfg.n_layers


def _window_flags(cfg: ArchConfig) -> list[int]:
    """Static per-layer sliding windows, by execution position (gemma2
    alternation: even positions local; none in an SSM stack)."""
    if cfg.family == "ssm":
        return [0] * cfg.n_layers
    if cfg.local_global:
        return [cfg.sliding_window if (i % 2 == 0) else 0
                for i in range(cfg.n_layers)]
    return [cfg.sliding_window] * cfg.n_layers


def execution_order(cfg: ArchConfig) -> list[int]:
    """The reference's stacked layer index at each execution position (under
    superlayers, the index in the stack of the position's kind)."""
    L = cfg.n_layers
    if cfg.local_global:
        return [i // 2 + (i % 2) * (L // 2) for i in range(L)]
    if _superlayers(cfg):
        return [i // 2 for i in range(L)]
    return list(range(L))


def stacked_sources(cfg: ArchConfig) -> list[tuple[str, int]]:
    """Where the reference's tree keeps each execution position's layer: the
    stack's name prefix (``"layers."``; ``"layers.dense."`` or
    ``"layers.moe."`` under superlayers) and the index in it."""
    order = execution_order(cfg)
    if _superlayers(cfg):
        return [(f"layers.{kind}.", j) for kind, j in zip(layer_kinds(cfg), order,
                                                           strict=True)]
    return [("layers.", j) for j in order]


# =============================================================================
# Modules
# =============================================================================

class DecoderLayer(nn.Module):
    """Pre-norm attention and a gated MLP (``kind`` "dense") or MoE layer
    (``kind`` "moe"), with gemma2's post-norms where the config has them;
    ``window`` is this layer's sliding window (0 = full).  An ``"ssm"``
    layer holds ``norm_attn`` (and ``post_norm_attn`` where the config has
    post-norms) and ``ssm`` only; a ``"hybrid"`` layer a dense layer's
    modules plus ``ssm``, ``fuse_norm_attn`` and ``fuse_norm_ssm``; a
    ``"decoder_x"`` layer a dense layer's modules plus ``cross`` and
    ``norm_cross``; an ``"encoder"`` layer a dense layer's modules, its
    attention bidirectional (the reference's ``_init_layer``)."""

    def __init__(self, cfg: ArchConfig, *, window: int, kind: str, dtype, device,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg, self.window, self.kind = cfg, window, kind
        kw = dict(dtype=dtype, device=device)
        self.norm_attn = constant((cfg.d_model,), 1.0, **kw)
        if cfg.post_norm:
            self.post_norm_attn = constant((cfg.d_model,), 1.0, **kw)
        if kind == "ssm":
            self.ssm = ssm_mod.SSM(cfg, generator=generator, **kw)
            return
        self.attn = Attention(cfg, generator=generator, **kw)
        if kind == "hybrid":
            self.ssm = ssm_mod.SSM(cfg, generator=generator, **kw)
            self.fuse_norm_attn = constant((cfg.d_model,), 1.0, **kw)
            self.fuse_norm_ssm = constant((cfg.d_model,), 1.0, **kw)
        self.norm_mlp = constant((cfg.d_model,), 1.0, **kw)
        if cfg.post_norm:
            self.post_norm_mlp = constant((cfg.d_model,), 1.0, **kw)
        if kind == "moe":
            self.moe = moe_mod.MoE(cfg, generator=generator, **kw)
        else:
            self.mlp = GatedMLP(cfg, cfg.d_model, cfg.dense_ff or cfg.d_ff,
                                generator=generator, **kw)
        if kind == "decoder_x":
            self.cross = Attention(cfg, generator=generator, **kw)
            self.norm_cross = constant((cfg.d_model,), 1.0, **kw)


class Encoder(nn.Module):
    """The enc-dec encoder: ``layers`` (``n_enc_layers`` bidirectional dense
    layers, window 0) and ``final_norm``."""

    def __init__(self, cfg: ArchConfig, *, dtype, device,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, window=0, kind="encoder", generator=generator, **kw)
            for _ in range(cfg.n_enc_layers))
        self.final_norm = constant((cfg.d_model,), 1.0, **kw)


class Transformer(nn.Module):
    """The whole model: ``embed`` (V, d), ``layers`` in execution order,
    ``final_norm`` and, unless the embeddings are tied, ``lm_head`` (V, d);
    an enc-dec model also ``encoder`` (:class:`Encoder`).

    With a ``generator`` the weights are drawn from it (the reference's
    distributions); without one they are zeros, for ``models.convert`` to
    fill.  Norm scales are ones and biases zeros either way."""

    def __init__(self, cfg: ArchConfig, *, dtype=torch.float32, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.ctx = ModelCtx(cfg=cfg, dtype=dtype, device=device)
        shape = (cfg.vocab_size, cfg.d_model)
        kw = dict(dtype=dtype, device=device)

        def table():
            if generator is None:
                return constant(shape, 0.0, **kw)
            return nn.Parameter(embed_init(generator, shape, dtype).to(device))

        self.embed = table()
        self.final_norm = constant((cfg.d_model,), 1.0, **kw)
        if not cfg.tie_embeddings:
            self.lm_head = table()
        if cfg.enc_dec:
            self.encoder = Encoder(cfg, generator=generator, **kw)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, window=w, kind=kind, generator=generator, **kw)
            for w, kind in zip(_window_flags(cfg), layer_kinds(cfg), strict=True))

    def forward(self, batch: dict, *, collect_kv: bool = False):
        return forward(self.ctx, self, batch, collect_kv=collect_kv)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.bfloat16) -> Transformer:
    """A model of ``cfg`` on the generator's device, its weights drawn from
    ``generator`` in f32 and cast to ``dtype`` (the reference's rule)."""
    return Transformer(cfg, dtype=dtype, device=generator.device, generator=generator)


# =============================================================================
# Layer bodies (full-sequence mode)
# =============================================================================

def _maybe_post(cfg: ArchConfig, p, name: str, y):
    return rms_norm(y, getattr(p, name), cfg.norm_eps) if cfg.post_norm else y


def _ffn(cfg: ArchConfig, p: DecoderLayer, x):
    """The layer's MLP or MoE: (out, aux), aux None for an MLP."""
    if p.kind == "moe":
        return moe_mod.moe_forward(p.moe, cfg, x)
    return mlp_forward(p.mlp, cfg, x), None


def _fuse(cfg: ArchConfig, p: DecoderLayer, a, s):
    """A hybrid layer's attention and SSD outputs, each normed, averaged."""
    return 0.5 * (rms_norm(a, p.fuse_norm_attn, cfg.norm_eps)
                  + rms_norm(s, p.fuse_norm_ssm, cfg.norm_eps))


def _layer_forward(cfg: ArchConfig, p: DecoderLayer, h, positions, *, window: int,
                   enc_kv=None):
    """One layer, full sequence.  Returns (new h, (k, v) or None for an SSM
    or encoder layer, aux).  A ``"decoder_x"`` layer attends to ``enc_kv``
    (:func:`attention.cross_kv` of the encoder's output) after its
    self-attention."""
    x = rms_norm(h, p.norm_attn, cfg.norm_eps)
    if p.kind == "ssm":
        return h + cfg.residual_scale * ssm_mod.ssm_forward(p.ssm, cfg, x), None, None
    if p.kind == "encoder":
        a, kv = encoder_attn(p.attn, cfg, x, positions), None
    else:
        a, kv = attn_forward(p.attn, cfg, x, positions, window=window)
    if p.kind == "hybrid":
        a = _fuse(cfg, p, a, ssm_mod.ssm_forward(p.ssm, cfg, x))
    h = h + cfg.residual_scale * _maybe_post(cfg, p, "post_norm_attn", a)
    if p.kind == "decoder_x":
        c = cross_forward(p.cross, cfg, rms_norm(h, p.norm_cross, cfg.norm_eps), enc_kv)
        h = h + cfg.residual_scale * c
    x = rms_norm(h, p.norm_mlp, cfg.norm_eps)
    m, aux = _ffn(cfg, p, x)
    h = h + cfg.residual_scale * _maybe_post(cfg, p, "post_norm_mlp", m)
    return h, kv, aux


# =============================================================================
# Full-model forward (prefill / eval)
# =============================================================================

def embed_tokens(ctx: ModelCtx, params: Transformer, tokens):
    h = params.embed[tokens]
    return (h * ctx.cfg.embed_scale).to(ctx.dtype)


def logits_from_h(ctx: ModelCtx, params: Transformer, h):
    cfg = ctx.cfg
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    table = params.embed if cfg.tie_embeddings else params.lm_head
    logits = (h @ table.T) * cfg.logit_scale
    return softcap(logits.float(), cfg.final_softcap)


def encode(ctx: ModelCtx, params: Transformer, src_embeds, src_positions):
    """The enc-dec encoder: ``src_embeds`` (B,T,d) scaled by ``embed_scale``
    and cast to the model dtype, the bidirectional layers at
    ``src_positions`` (B,T), then the encoder's final norm."""
    cfg = ctx.cfg
    h = (src_embeds * cfg.embed_scale).to(ctx.dtype)

    def run(layer, h):
        return _layer_forward(cfg, layer, h, src_positions, window=0)[0]

    for layer in params.encoder.layers:
        h = _maybe_remat(ctx, run, layer, h)
    return rms_norm(h, params.encoder.final_norm, cfg.norm_eps)


def _remat_contexts():
    """``checkpoint``'s ``context_fn``: nothing around the forward, the MoE
    layers' recompute flag around the recompute (so a ``stats`` side
    channel records each layer once)."""
    return contextlib.nullcontext(), moe_mod.recomputing()


def _maybe_remat(ctx: ModelCtx, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` where ``ctx.remat``
    is set and autograd records."""
    if ctx.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, context_fn=_remat_contexts,
                          preserve_rng_state=False)      # the layers draw nothing
    return fn(*args)


def forward_hidden(ctx: ModelCtx, params: Transformer, batch: dict, *,
                   collect_kv: bool = False):
    """Full-sequence forward up to the final hidden states (pre-norm).

    batch: ``tokens`` (B,S) or ``embeds`` (B,S,d), and ``positions`` (B,S),
    or (3,B,S) under M-RoPE; an enc-dec model also ``src_embeds`` (B,T,d)
    and ``src_positions`` (B,T).  Returns (h, extras); with ``collect_kv``,
    ``extras["kvs"]`` holds each layer's (k, v), in execution order (None
    for an SSM layer), and for an enc-dec model it is (self kvs, cross kvs),
    each a list of one (k, v) a decoder layer; ``extras["aux"]`` is the MoE
    layers' load-balance losses summed (0.0 for a model without them); an
    enc-dec model's ``extras["enc_out"]`` is the encoder's output.
    """
    cfg = ctx.cfg
    if "embeds" in batch:
        h = (batch["embeds"] * cfg.embed_scale).to(ctx.dtype)
    else:
        h = embed_tokens(ctx, params, batch["tokens"])
    enc_out = None
    if cfg.enc_dec:
        enc_out = encode(ctx, params, batch["src_embeds"], batch["src_positions"])
    positions = batch["positions"]

    def run(layers, h):
        """The layers in turn (one, or a superlayer's pair): (h, kvs,
        cross kvs, auxes)."""
        kvs_, cross_, auxes = [], [], []
        for layer in layers:
            enc_kv = cross_kv(layer.cross, cfg, enc_out) if enc_out is not None else None
            h, kv, aux = _layer_forward(cfg, layer, h, positions, window=layer.window,
                                        enc_kv=enc_kv)
            kvs_.append(kv)
            cross_.append(enc_kv)
            auxes.append(aux)
        return h, kvs_, cross_, auxes

    group = 2 if _superlayers(cfg) else 1
    kvs, cross_kvs, aux_total = [], [], 0.0
    for i in range(0, len(params.layers), group):
        h, kv, ckv, auxes = _maybe_remat(ctx, run, params.layers[i:i + group], h)
        if collect_kv:
            kvs.extend(kv)
            cross_kvs.extend(ckv)
        for aux in auxes:
            if aux is not None:
                aux_total = aux_total + aux
    extras = {"kvs": (kvs, cross_kvs) if cfg.enc_dec else kvs, "aux": aux_total}
    if cfg.enc_dec:
        extras["enc_out"] = enc_out
    return h, extras


def forward(ctx: ModelCtx, params: Transformer, batch: dict, *, collect_kv: bool = False):
    """Full-sequence forward to logits (prefill / eval path)."""
    h, extras = forward_hidden(ctx, params, batch, collect_kv=collect_kv)
    return logits_from_h(ctx, params, h), extras
