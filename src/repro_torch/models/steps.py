"""Step factories (forward / prefill / decode) + per-shape input specs.

Counterpart of ``repro/models/steps.py``, serving half: ``lm_loss`` and
``make_train_step`` wait for the training half (ROADMAP.md queue 1 item 14).
``input_specs(cfg, shape_name)`` gives the inputs of the step that a prefill
or decode shape cell runs as tensors on the ``meta`` device (the reference's
``ShapeDtypeStruct``s: shapes and dtypes, no storage); ``synthetic_batch``
realises them.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.core.problems import resolve_device
from repro_torch.models import decode as decode_mod
from repro_torch.models.transformer import ModelCtx, forward, forward_hidden, logits_from_h

SRC_FRACTION = 4           # enc-dec: source frames = seq_len / 4 (audio stub)


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
    if kind == "train":
        raise NotImplementedError(
            f"{shape_name}: the train step waits for the LM side's training half "
            f"(ROADMAP.md queue 1 item 14)")

    def spec(shape, dt=torch.int64):
        return torch.empty(shape, dtype=dt, device="meta")

    T = S // SRC_FRACTION
    if kind == "prefill":
        if cfg.enc_dec:          # the audio frontend feeds the encoder, tokens the decoder
            return {"tokens": spec((B, S)), "positions": spec((B, S)),
                    "src_embeds": spec((B, T, cfg.d_model), dtype),
                    "src_positions": spec((B, T))}
        batch = {}
        if cfg.frontend == "none":
            batch["tokens"] = spec((B, S))
        else:
            batch["embeds"] = spec((B, S, cfg.d_model), dtype)
        batch["positions"] = spec((3, B, S) if cfg.mrope else (B, S))
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
