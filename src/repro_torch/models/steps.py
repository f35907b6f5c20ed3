"""Step factories (train / forward / prefill / decode) + per-shape input specs.

Counterpart of ``repro/models/steps.py``.  ``lm_loss`` is the vocab-parallel,
sequence-chunked cross entropy and ``make_train_step`` the training step
(gradients, optional accumulation over microbatches and a gradient
transform, then AdamW), which updates the model's parameters in place, on
one device or, where the model's ``ModelCtx`` has a mesh, on this rank's
blocks of them (``transformer.init_params`` with the mesh, or
``distributed.sharding.install``): the global batch in,
this rank's dp rows of it computed, the same step as one device's.
``input_specs(cfg, shape_name)`` gives the inputs of the step that a train,
prefill or decode shape cell runs as tensors on the ``meta`` device (the
reference's ``ShapeDtypeStruct``s: shapes and dtypes, no storage);
``synthetic_batch`` realises them.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.core.problems import resolve_device
from repro_torch.distributed.sharding import sharded_axes, spec_of
from repro_torch.models import decode as decode_mod
from repro_torch.models.transformer import ModelCtx, forward, forward_hidden, logits_from_h
from repro_torch.optim import adamw as adamw_mod
from repro_torch.optim.adamw import AdamW

AUX_WEIGHT = 0.01          # MoE load-balance loss weight
SRC_FRACTION = 4           # enc-dec: source frames = seq_len / 4 (audio stub)


# =============================================================================
# Loss
# =============================================================================

def _ce_chunk_size(S: int, target: int = 512) -> int:
    c = min(target, S)
    while S % c:
        c -= 1
    return c


def _ce_chunk(ctx: ModelCtx, params, h_i, tgt_i, mask_i):
    """Σ (logsumexp − label logit)·mask over one sequence chunk: (B, C, V)
    f32 logits, the max detached (the reference's ``stop_gradient``).

    Vocab-parallel on a mesh whose ``model`` axis splits the vocab: the
    logits are this rank's (B, C, V/tp) block; the max is reduced over
    ``model`` (detached), the sum of exps summed over it, and the label
    logit selected from the local block (zero where the label is another
    rank's) and summed over it."""
    logits = logits_from_h(ctx, params, h_i)
    par = ctx.par
    vocab = par.split(ctx.cfg.vocab_size) if par is not None else None
    m = torch.amax(logits, dim=-1).detach()
    if vocab is None:
        lse = m + torch.log(torch.sum(torch.exp(logits - m[..., None]), dim=-1))
        ll = torch.gather(logits, -1, tgt_i[..., None])[..., 0]
        return torch.sum((lse - ll) * mask_i)
    m = par.tp.max(m)
    lse = m + torch.log(par.sum_tp(torch.sum(torch.exp(logits - m[..., None]), dim=-1)))
    loc = tgt_i - vocab[0]
    mine = (loc >= 0) & (loc < vocab[1])
    ll = torch.gather(logits, -1, loc.clamp(0, vocab[1] - 1)[..., None])[..., 0]
    ll = par.sum_tp(torch.where(mine, ll, 0.0))
    return torch.sum((lse - ll) * mask_i)


def lm_loss(ctx: ModelCtx, params, batch: dict):
    """Sequence-chunked cross entropy: ``(loss, {"ce", "aux"})``.

    The head is applied one chunk of C ≤ 512 positions at a time
    (:func:`_ce_chunk_size`), each chunk under ``torch.utils.checkpoint``
    where autograd records, so only (B, C, V) logits are live and the
    backward recomputes them chunk by chunk.  ``batch["loss_mask"]`` (B, S)
    weighs each position (ones where absent); ``ce`` is the masked sum over
    ``max(Σ mask, 1)`` and ``loss = ce + AUX_WEIGHT · aux``, ``aux`` the MoE
    layers' load-balance loss (0 without them).  On a mesh the batch is
    this rank's dp rows and ``ce`` the global batch's: both sums reduced
    over the dp axes (the numerator summed forward with an identity
    backward), so every rank holds the same loss."""
    h, extras = forward_hidden(ctx, params, batch)
    tgt = batch["targets"].long()
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(tgt.shape, dtype=torch.float32, device=tgt.device)
    B, S, _ = h.shape
    C = _ce_chunk_size(S)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, S, C):
        args = (ctx, params, h[:, c:c + C], tgt[:, c:c + C], mask[:, c:c + C])
        if torch.is_grad_enabled():
            part = checkpoint(_ce_chunk, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            part = _ce_chunk(*args)
        total = total + part
    count = torch.sum(mask)
    if ctx.par is not None:
        total, count = ctx.par.sum_dp(total), ctx.par.dp.sum(count)
    ce = total / torch.clamp(count, min=1.0)
    aux = torch.as_tensor(extras["aux"], dtype=torch.float32, device=h.device)
    loss = ce + AUX_WEIGHT * aux
    return loss, {"ce": ce, "aux": aux}


def _split_microbatches(batch: dict, accum: int) -> list[dict]:
    """``accum`` microbatches: every leaf cut into ``accum`` equal row blocks
    on its batch dim (dim 1 for M-RoPE positions (3, B, S), dim 0
    otherwise), microbatch i the i-th block (the reference's reshape to
    (accum, B/accum, ...))."""
    out = [{} for _ in range(accum)]
    for name, x in batch.items():
        axis = 1 if ("positions" in name and x.ndim == 3) else 0
        b = x.shape[axis]
        if b % accum:
            raise ValueError(f"{name}: batch {b} is not a multiple of accum={accum}")
        for i, part in enumerate(torch.chunk(x, accum, dim=axis)):
            out[i][name] = part
    return out


def _div(x: torch.Tensor, n: int) -> torch.Tensor:
    """x / n as a true division (PyTorch's CUDA divide by a Python number
    multiplies by its reciprocal)."""
    return x / torch.full((), n, dtype=x.dtype, device=x.device)


def _local_rows(par, batch: dict) -> dict:
    """This rank's dp rows of every batch leaf (dim 1 of M-RoPE positions)."""
    return {name: par.rows(x, 1 if ("positions" in name and x.ndim == 3) else 0)
            for name, x in batch.items()}


def make_train_step(ctx: ModelCtx, opt: AdamW, grad_transform=None, accum: int = 1):
    """Returns ``step(model, opt_state, extra_state, batch) -> (opt_state,
    extra_state, metrics)``; the model's parameters are updated in place.

    The gradients are ``torch.autograd.grad`` of :func:`lm_loss` over
    ``model.named_parameters()`` (zeros for a parameter the loss does not
    reach, as ``jax.grad`` gives).  ``accum > 1`` splits the batch into
    microbatches (:func:`_split_microbatches`), sums their gradients in f32
    and divides by ``accum`` before one optimizer update; its metrics are
    the reference's (``ce`` the mean microbatch loss, ``aux`` 0).
    ``grad_transform`` (the int8 error-feedback hook) maps ``(grads,
    extra_state)`` to new ones before the update.  ``metrics``: ``loss``,
    ``ce``, ``aux``, ``grad_norm`` and ``lr``, 0-d tensors.

    On a mesh (``ctx.mesh``; the model's parameters this rank's blocks) the
    step takes the global batch, cuts it into microbatches first, as one
    device does, and computes this rank's dp rows of each (so MoE capacity
    and the aux loss are the global batch's).  A parameter replicated over
    the dp axes gets its gradient summed over them after the backward (one
    sharded over them got it from its gather's reduce-scatter), so every
    rank holds one device's gradient of its block; the clipping norm counts
    each block once (``optim.adamw.sharded_norm``)."""
    par = ctx.par

    def grads_of(model, names, params, batch):
        loss, metrics = lm_loss(ctx, model, batch)
        gs = torch.autograd.grad(loss, params, materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, dict(zip(names, gs))

    def step(model, opt_state, extra_state, batch):
        names, params = zip(*model.named_parameters())
        if accum == 1:
            mb = batch if par is None else _local_rows(par, batch)
            loss, metrics, grads = grads_of(model, names, params, mb)
        else:
            gsum = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for k, p in zip(names, params)}
            lsum = torch.zeros((), dtype=torch.float32, device=params[0].device)
            for mb in _split_microbatches(batch, accum):
                if par is not None:
                    mb = _local_rows(par, mb)
                l_mb, _, g = grads_of(model, names, params, mb)
                gsum = {k: a + g[k].float() for k, a in gsum.items()}
                lsum = lsum + l_mb
                del g
            grads = {k: _div(a, accum) for k, a in gsum.items()}
            del gsum
            loss = _div(lsum, accum)
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
        norm = None
        if par is not None:
            grads = _sum_replicated(par, params, names, grads)
            norm = functools.partial(adamw_mod.sharded_norm, mesh=par.mesh,
                                     axes={k: sharded_axes(spec_of(p))
                                           for k, p in zip(names, params)})
        if grad_transform is not None:
            grads, extra_state = grad_transform(grads, extra_state)
        new_params, opt_state, om = opt.update(grads, opt_state, dict(zip(names, params)),
                                               norm=norm)
        del grads
        with torch.no_grad():
            for k, p in zip(names, params):
                p.copy_(new_params[k])
        return opt_state, extra_state, dict(metrics, loss=loss, **om)

    return step


def _sum_replicated(par, params, names, grads: dict) -> dict:
    """The gradients of the parameters replicated over the dp axes summed
    over them (in rank order: the same bits on every dp rank)."""
    if par.dp.size == 1:
        return grads
    out = dict(grads)
    for k, p in zip(names, params):
        if not set(sharded_axes(spec_of(p))) & set(par.dp_axes):
            out[k] = par.dp.sum(grads[k])
    return out


def make_forward(ctx: ModelCtx):
    def fwd(params, batch):
        logits, _ = forward(ctx, params, batch)
        return logits

    return fwd


def make_prefill(ctx: ModelCtx):
    """Prefill: last-position logits + the per-layer k/v needed for decode.

    Full-sequence logits would cost (B, S, V) f32 for one useful row —
    prefill serves sampling, so only position S-1 reaches the head.
    """

    def fwd(params, batch):
        h, extras = forward_hidden(ctx, params, batch, collect_kv=True)
        logits = logits_from_h(ctx, params, h[:, -1:])
        return logits, extras["kvs"]

    return fwd


def make_decode_step(ctx: ModelCtx):
    """``step(params, tokens, cur_pos, caches)``; an enc-dec model's also
    takes the prefill's ``cross_kvs`` last."""
    if ctx.cfg.enc_dec:
        def step_x(params, tokens, cur_pos, caches, cross_kvs):
            return decode_mod.decode_step(ctx, params, tokens, cur_pos, caches,
                                          cross_kvs=cross_kvs)
        return step_x

    def step(params, tokens, cur_pos, caches):
        return decode_mod.decode_step(ctx, params, tokens, cur_pos, caches)

    return step


# =============================================================================
# Input specs and synthetic batches (tests, smoke runs)
# =============================================================================

def _batch_shapes(cfg: ArchConfig, shape_name: str,
                  override: tuple[int, int] | None = None,
                  dtype=torch.bfloat16) -> dict:
    """Meta tensors standing for the inputs of this shape cell's step.

    ``override=(S, B)`` shrinks the cell.  Token ids and positions are
    int64; ``cur_pos`` is a 0-d int64 (a host int in a real batch).  A
    train cell's inputs are its prefill's plus ``targets`` (B,S).  A
    decode cell's ``caches`` are ``decode.init_caches``' per-layer dicts
    (an SSM layer's ``{"ssm": {"conv", "state"}}`` nested in them).  An
    enc-dec cell has T = S // ``SRC_FRACTION`` source frames: its prefill
    takes ``tokens``, ``positions``, ``src_embeds`` (B,T,d) and
    ``src_positions`` (B,T), its decode step also ``cross_kvs``, one
    (k, v) each (B,T,KV,hd) a decoder layer.
    """
    S, B, kind = SHAPES[shape_name]
    if override is not None:
        S, B = override

    def spec(shape, dt=torch.int64):
        return torch.empty(shape, dtype=dt, device="meta")

    T = S // SRC_FRACTION
    if kind in ("train", "prefill"):
        if cfg.enc_dec:          # the audio frontend feeds the encoder, tokens the decoder
            batch = {"tokens": spec((B, S)), "positions": spec((B, S)),
                     "src_embeds": spec((B, T, cfg.d_model), dtype),
                     "src_positions": spec((B, T))}
        else:
            batch = {}
            if cfg.frontend == "none":
                batch["tokens"] = spec((B, S))
            else:
                batch["embeds"] = spec((B, S, cfg.d_model), dtype)
            batch["positions"] = spec((3, B, S) if cfg.mrope else (B, S))
        if kind == "train":
            batch["targets"] = spec((B, S))
        return batch

    # decode: one new token against a cache of S positions
    ctx = ModelCtx(cfg=cfg, dtype=dtype, device="meta")
    batch = {"tokens": spec((B, 1)), "cur_pos": spec(()),
             "caches": decode_mod.init_caches(ctx, B, S)}
    if cfg.enc_dec:
        kv = (B, T, cfg.n_kv_heads, cfg.hd)
        batch["cross_kvs"] = [(spec(kv, dtype), spec(kv, dtype)) for _ in range(cfg.n_layers)]
    return batch


def input_specs(cfg: ArchConfig, shape_name: str,
                override: tuple[int, int] | None = None, dtype=torch.bfloat16) -> dict:
    return _batch_shapes(cfg, shape_name, override, dtype)


def synthetic_batch(cfg: ArchConfig, shape_name: str,
                    generator: torch.Generator | None = None,
                    override: tuple[int, int] | None = None, dtype=torch.bfloat16,
                    device="cuda") -> dict:
    """Concrete random inputs with the spec's structure, on ``device`` (the
    generator's, where one is given): token ids uniform over the vocab, float
    leaves ``N(0, 0.02²)`` (an SSM cache's ``conv`` and ``state`` and an
    enc-dec model's source frames and cross kvs too), positions ``0..S-1``
    (source positions ``0..T-1``), each attention cache full (slot i holds position
    i) and ``cur_pos`` the next position after it."""
    if generator is None:
        generator = torch.Generator(resolve_device(device)).manual_seed(0)
    dev = generator.device
    spec = _batch_shapes(cfg, shape_name, override, dtype)
    S = override[0] if override else SHAPES[shape_name][0]

    def realise(name: str, s: torch.Tensor):
        if name == "pos":                  # cache slot positions: full cache
            return torch.arange(s.shape[-1], device=dev)
        if name in ("positions", "src_positions"):
            return torch.arange(s.shape[-1], device=dev).expand(s.shape).contiguous()
        if name == "cur_pos":
            return S
        if not s.dtype.is_floating_point:
            return torch.randint(0, cfg.vocab_size, s.shape, generator=generator,
                                 device=dev)
        return (torch.randn(s.shape, generator=generator, device=dev) * 0.02).to(s.dtype)

    def tree(c: dict) -> dict:
        return {k: tree(v) if isinstance(v, dict) else realise(k, v) for k, v in c.items()}

    out = {k: realise(k, v) for k, v in spec.items() if k not in ("caches", "cross_kvs")}
    if "caches" in spec:
        out["caches"] = [tree(c) for c in spec["caches"]]
    if "cross_kvs" in spec:
        out["cross_kvs"] = [(realise("k", k), realise("v", v)) for k, v in spec["cross_kvs"]]
    return out
