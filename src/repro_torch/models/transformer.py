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
import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.collectives import Parallel, param, rows_to_columns
from repro_torch.distributed.sharding import BlockDraw, axes_of, on_mesh, spec_of
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (Attention, attn_forward, cross_forward, cross_kv,
                                          encoder_attn)
from repro_torch.models.common import constant, embed_init, rms_norm, softcap
from repro_torch.models.mlp import GatedMLP, mlp_forward

#: the layer kind of each family (the reference's ``layer_kind``)
_KINDS = {"ssm": "ssm", "hybrid": "hybrid", "moe": "moe"}


#: the families whose training step runs on a mesh; the others refuse one
MESH_FAMILIES = ("dense", "vlm", "moe")
#: the refusal of a mesh for the other families (here, in
#: ``runtime/elastic.py::reshard_state`` and in ``launch/train.py``)
MESH_NOT_PORTED = (
    "the ssm, hybrid and enc-dec families on a (data, model) mesh are not ported "
    "(ROADMAP.md queue 1 item 14d's remainder); they run on one device")


@dataclasses.dataclass(frozen=True)
class ModelCtx:
    """Everything the plain functions need besides the parameters.

    ``mesh`` (a ``launch.mesh.Mesh`` with ``data`` and ``model`` axes, the
    reference's ``ModelCtx.mesh``): the parameters are this rank's blocks
    (:func:`init_params` with the mesh, or ``distributed.sharding.install``
    of ``runtime.elastic.reshard_state``'s blocks), the batch is this rank's dp
    rows, and the layers run tensor parallel over ``tp_axis`` and FSDP over
    ``dp_axes`` (:attr:`par`).  Its default is no mesh: one device, the
    arithmetic of the one-device step bit for bit.  The dense, vlm and moe
    families run on a mesh (:data:`MESH_FAMILIES`).

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
    mesh: object = None
    dp_axes: tuple[str, ...] = ()
    tp_axis: str = "model"

    @functools.cached_property
    def par(self) -> Parallel | None:
        """The mesh as the layers use it (None off a mesh); made at its
        first use, which makes the mesh's axis groups (collective: every
        rank reaches it at the same point)."""
        if self.mesh is None:
            return None
        if self.cfg.family not in MESH_FAMILIES or self.cfg.enc_dec:
            raise NotImplementedError(f"{self.cfg.name}: {MESH_NOT_PORTED}")
        return Parallel(self.mesh, self.dp_axes, self.tp_axis)


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
    attention bidirectional (the reference's ``_init_layer``).  ``blocks``
    (``distributed.sharding.BlockDraw``) draws an MoE layer's expert stacks
    as this rank's blocks."""

    def __init__(self, cfg: ArchConfig, *, window: int, kind: str, dtype, device,
                 generator: torch.Generator | None = None, blocks=None):
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
            self.moe = moe_mod.MoE(cfg, generator=generator, blocks=blocks, **kw)
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
    fill.  Norm scales are ones and biases zeros either way.

    With a ``mesh`` the model holds this rank's blocks (the specs of
    ``distributed.sharding.param_specs`` with ``cfg``) and its ``ctx`` the
    mesh.  The draws are one device's, in its order, and each top-level
    weight and each layer is cut to its blocks as soon as it is drawn (an
    MoE layer's experts one at a time), so besides its blocks a rank holds
    at most one whole weight or layer at a time; the blocks are bitwise those
    ``runtime.elastic.reshard_state`` cuts from the one-device model."""

    def __init__(self, cfg: ArchConfig, *, dtype=torch.float32, device="cuda",
                 generator: torch.Generator | None = None, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.ctx = ModelCtx(cfg=cfg, dtype=dtype, device=device)
        shape = (cfg.vocab_size, cfg.d_model)
        kw = dict(dtype=dtype, device=device)
        blocks = None
        if mesh is not None:
            if cfg.family not in MESH_FAMILIES or cfg.enc_dec:
                raise NotImplementedError(f"{cfg.name}: {MESH_NOT_PORTED}")
            blocks = BlockDraw(mesh, cfg)

        def placed(module: nn.Module, prefix: str = "") -> nn.Module:
            if blocks is not None:
                blocks.cut(module, prefix)
            return module

        def table():
            if generator is None:
                return constant(shape, 0.0, **kw)
            return nn.Parameter(embed_init(generator, shape, dtype).to(device))

        self.embed = table()
        placed(self)
        self.final_norm = constant((cfg.d_model,), 1.0, **kw)
        if not cfg.tie_embeddings:
            self.lm_head = table()
        placed(self)
        if cfg.enc_dec:
            self.encoder = Encoder(cfg, generator=generator, **kw)
        self.layers = nn.ModuleList(
            placed(DecoderLayer(cfg, window=w, kind=kind, generator=generator, blocks=blocks,
                                **kw), f"layers.{i}.")
            for i, (w, kind) in enumerate(zip(_window_flags(cfg), layer_kinds(cfg),
                                              strict=True)))
        if mesh is not None:
            self.ctx = on_mesh(self.ctx, mesh)

    def forward(self, batch: dict, *, collect_kv: bool = False):
        return forward(self.ctx, self, batch, collect_kv=collect_kv)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.bfloat16, mesh=None) -> Transformer:
    """A model of ``cfg`` on the generator's device, its weights drawn from
    ``generator`` in f32 and cast to ``dtype`` (the reference's rule); on
    ``mesh``, this rank's blocks of them (:class:`Transformer`)."""
    return Transformer(cfg, dtype=dtype, device=generator.device, generator=generator,
                       mesh=mesh)


# =============================================================================
# Layer bodies (full-sequence mode)
# =============================================================================

def _maybe_post(cfg: ArchConfig, p, name: str, y):
    return rms_norm(y, getattr(p, name), cfg.norm_eps) if cfg.post_norm else y


def _ffn(cfg: ArchConfig, p: DecoderLayer, x, par=None):
    """The layer's MLP or MoE: (out, aux), aux None for an MLP."""
    if p.kind == "moe":
        return moe_mod.moe_forward(p.moe, cfg, x, par=par)
    return mlp_forward(p.mlp, cfg, x, par=par), None


def _fuse(cfg: ArchConfig, p: DecoderLayer, a, s):
    """A hybrid layer's attention and SSD outputs, each normed, averaged."""
    return 0.5 * (rms_norm(a, p.fuse_norm_attn, cfg.norm_eps)
                  + rms_norm(s, p.fuse_norm_ssm, cfg.norm_eps))


def _layer_forward(cfg: ArchConfig, p: DecoderLayer, h, positions, *, window: int,
                   enc_kv=None, par=None):
    """One layer, full sequence.  Returns (new h, (k, v) or None for an SSM
    or encoder layer, aux).  A ``"decoder_x"`` layer attends to ``enc_kv``
    (:func:`attention.cross_kv` of the encoder's output) after its
    self-attention.  On a mesh (``par``) the norms are replicated and the
    attention and the MLP or MoE run tensor parallel, each summing its
    partials over ``model`` once."""
    x = rms_norm(h, p.norm_attn, cfg.norm_eps)
    if p.kind == "ssm":
        return h + cfg.residual_scale * ssm_mod.ssm_forward(p.ssm, cfg, x), None, None
    if p.kind == "encoder":
        a, kv = encoder_attn(p.attn, cfg, x, positions), None
    else:
        a, kv = attn_forward(p.attn, cfg, x, positions, window=window, par=par)
    if p.kind == "hybrid":
        a = _fuse(cfg, p, a, ssm_mod.ssm_forward(p.ssm, cfg, x))
    h = h + cfg.residual_scale * _maybe_post(cfg, p, "post_norm_attn", a)
    if p.kind == "decoder_x":
        c = cross_forward(p.cross, cfg, rms_norm(h, p.norm_cross, cfg.norm_eps), enc_kv)
        h = h + cfg.residual_scale * c
    x = rms_norm(h, p.norm_mlp, cfg.norm_eps)
    m, aux = _ffn(cfg, p, x, par)
    h = h + cfg.residual_scale * _maybe_post(cfg, p, "post_norm_mlp", m)
    return h, kv, aux


# =============================================================================
# Full-model forward (prefill / eval)
# =============================================================================

def embed_tokens(ctx: ModelCtx, params: Transformer, tokens):
    """The token embeddings, scaled and cast.  On a mesh the table is
    vocab-parallel: each ``model`` rank looks up the tokens of its rows
    (zeros for the others) and the rows are summed over ``model``.  Where
    the table's d columns are split over the dp ranks, it is not gathered:
    every dp rank's tokens are looked up in this rank's columns and the
    rows go back to their dp ranks (``collectives.rows_to_columns``, an
    activation's bytes instead of the table's), and the table's gradient
    is this rank's block whole, with no reduce-scatter."""
    par = ctx.par
    if par is None:
        return (params.embed[tokens] * ctx.cfg.embed_scale).to(ctx.dtype)
    V = ctx.cfg.vocab_size
    vocab = par.split(V)
    cols = par.dp.size > 1 and any(a in par.dp_axes
                                   for a in axes_of((spec_of(params.embed) + (None,))[1]))
    table = params.embed if cols else param(par, params.embed)
    if vocab is not None and not cols:
        table = par.param(params.embed, dim=0, ranges=lambda r: [par.part(V, r)])
    if cols:
        tokens = par.dp.all_gather(tokens, dim=0)
    if vocab is None:
        h = table[tokens]
    else:
        loc = tokens - vocab[0]
        mine = (loc >= 0) & (loc < vocab[1])
        h = torch.where(mine[..., None], table[loc.clamp(0, vocab[1] - 1)], 0.0)
    if cols:
        h = rows_to_columns(h, par.dp)
    if vocab is not None:
        h = par.sum_tp(h)
    return (h * ctx.cfg.embed_scale).to(ctx.dtype)


def logits_from_h(ctx: ModelCtx, params: Transformer, h):
    """f32 logits of the final norm of ``h``: (..., V), or on a mesh whose
    ``model`` axis splits the vocab this rank's (..., V/tp) block
    (``models.steps.lm_loss`` reduces over it)."""
    cfg, par = ctx.cfg, ctx.par
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    table = params.embed if cfg.tie_embeddings else params.lm_head
    vocab = par.split(cfg.vocab_size) if par is not None else None
    if vocab is None:
        table = param(par, table)
    else:
        table = par.param(table, dim=0, ranges=lambda r: [par.part(cfg.vocab_size, r)])
        h = par.copy_tp(h)
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
    cfg, par = ctx.cfg, ctx.par
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
                                        enc_kv=enc_kv, par=par)
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
