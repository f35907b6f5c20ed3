"""The port's LM serving path: ``launch/serve.py --mode lm`` and the greedy
prefill-then-decode loop (``launch.serve.lm_generate``), on the CPU.

The greedy continuation is held token for token to the reference's
(``repro/launch/serve.py::_lm_main``'s loop) in f64, on the same prompt and
the reference's weights carried over by ``models.convert``.  The rest is
port-internal: the CLI's tokens against a greedy loop of full ``forward``
passes, decode against forward (rtol = atol = 2e-3, the reference's test),
sliding windows (atol 1e-5, the reference's test) and the input specs.
The enc-dec model (seamless-m4t-large-v2) carries its source frames
(``src_embeds``, ``src_positions``) beside the tokens: its prefill runs the
encoder and hands each decode step the cross kvs.  The SSM and hybrid models (mamba2-780m,
hymba-1.5b) have no prefill state: their prompt is replayed through decode
steps from ``init_caches`` on both sides, as the reference's server does.

An MoE model's decode step never drops an assignment, while a full forward
at the default capacity does (``test_moe_forward_drops_where_decode_does_not``),
so the MoE models are held to a forward at the no-drop capacity
``capacity_factor = E / k`` (C ≥ T: no expert can overflow).
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_harness import ref_module, to_np
from test_torch_harness import x64  # noqa: F401  (fixture)
from test_torch_models import ENC_DEC, MOE_ARCHS, SERVED, SSM_ARCHS, Pair, _paired, jx, tt
from test_torch_models import one_thread  # noqa: F401  (fixture)

from repro_torch.configs import base as port_base
from repro_torch.configs.base import get_config
from repro_torch.launch import serve
from repro_torch.models import decode, moe, steps
from repro_torch.models.transformer import forward, init_params

ref_decode = ref_module("models.decode")
ref_steps = ref_module("models.steps")

#: every (arch, decode or prefill shape) pair the port serves; long_500k only
#: where the config is subquadratic (the reference's ``shapes()``)
SPEC_CASES = [(arch, shape) for arch in SERVED + MOE_ARCHS + SSM_ARCHS
              for shape in ("prefill_32k", "decode_32k", "long_500k")
              if shape in get_config(arch).shapes()]


def _no_drop(cfg) -> dict:
    """The capacity factor at which no expert can overflow (C ≥ T), for an
    MoE config; nothing for the others."""
    return dict(capacity_factor=cfg.n_experts / cfg.top_k) if cfg.family == "moe" else {}


def _model(arch: str, seed: int = 0, **replace):
    cfg = dataclasses.replace(get_config(arch).reduced(), **replace)
    return init_params(cfg, torch.Generator().manual_seed(seed), torch.float32)


def _text_batch(cfg, tokens: torch.Tensor, src: torch.Tensor | None = None) -> dict:
    """tokens at positions 0..S-1; an enc-dec config's source frames ``src``
    (B, T, d) at 0..T-1 beside them."""
    B, S = tokens.shape
    pos = torch.arange(S).expand(B, S)
    batch = {"tokens": tokens, "positions": pos[None].expand(3, B, S) if cfg.mrope else pos}
    if cfg.enc_dec:
        batch["src_embeds"] = src
        batch["src_positions"] = torch.arange(src.shape[1]).expand(B, src.shape[1])
    return batch


def test_serve_cli_lm_tokens_equal_a_greedy_forward_loop(capsys):
    """``--mode lm --device cpu --arch internlm2-1.8b --reduced --json``
    (B = 4, prompt 64, gen 32): its tokens equal a greedy loop that reruns
    the port's full ``forward`` over the growing sequence (no cache)."""
    out = serve.main(["--mode", "lm", "--device", "cpu", "--arch", "internlm2-1.8b",
                      "--reduced", "--json"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["mode"] == "lm" and line["device"] == "cpu" and line["finite"]
    assert line["prefill_s"] > 0 and line["tokens_per_s"] > 0
    assert line["tokens"] == out["tokens"].tolist()
    cfg = get_config("internlm2-1.8b").reduced()
    model = init_params(cfg, torch.Generator("cpu").manual_seed(0), torch.float32)
    seq = torch.randint(0, cfg.vocab_size, (4, 64),
                        generator=torch.Generator("cpu").manual_seed(1))
    want = []
    with torch.inference_mode():
        for _ in range(33):
            logits, _ = forward(model.ctx, model, _text_batch(cfg, seq))
            tok = logits[:, -1].argmax(dim=-1)[:, None]
            want.append(tok)
            seq = torch.cat([seq, tok], dim=1)
    assert torch.equal(out["tokens"], torch.cat(want, dim=1))
    assert out["tokens"].shape == (4, 33)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_cli_lm_moe_tokens_equal_a_greedy_forward_loop(arch, capsys, monkeypatch):
    """``--mode lm --device cpu --arch <moe> --reduced --json`` (B = 4,
    prompt 64, gen 32), its config at the no-drop capacity: its tokens, all
    inside the vocabulary, equal a greedy loop of full ``forward`` passes
    over the growing sequence (no cache)."""
    get = port_base.get_config

    def no_drop(name: str):
        return dataclasses.replace(get(name), **_no_drop(get(name).reduced()))

    monkeypatch.setattr(port_base, "get_config", no_drop)
    out = serve.main(["--mode", "lm", "--device", "cpu", "--arch", arch, "--reduced", "--json"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["arch"] == f"{arch}-smoke" and line["finite"]
    assert line["tokens"] == out["tokens"].tolist()
    cfg = port_base.get_config(arch).reduced()
    assert cfg.capacity_factor == cfg.n_experts / cfg.top_k
    model = init_params(cfg, torch.Generator("cpu").manual_seed(0), torch.float32)
    seq = torch.randint(0, cfg.vocab_size, (4, 64),
                        generator=torch.Generator("cpu").manual_seed(1))
    want = []
    with torch.inference_mode():
        for _ in range(33):
            logits, _ = forward(model.ctx, model, _text_batch(cfg, seq))
            tok = logits[:, -1].argmax(dim=-1)[:, None]
            want.append(tok)
            seq = torch.cat([seq, tok], dim=1)
    assert torch.equal(out["tokens"], torch.cat(want, dim=1))
    assert int(out["tokens"].min()) >= 0 and int(out["tokens"].max()) < cfg.vocab_size


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_serve_cli_lm_ssm_tokens_equal_a_greedy_forward_loop(arch, capsys):
    """``--mode lm --device cpu --arch <ssm or hybrid> --reduced --json``
    (B = 4, prompt 64 replayed through decode steps, gen 32): its tokens,
    all inside the vocabulary, equal a greedy loop of full ``forward``
    passes over the growing sequence (the chunked scan, chunks falling back
    to each length's largest divisor below 16; no cache)."""
    out = serve.main(["--mode", "lm", "--device", "cpu", "--arch", arch, "--reduced", "--json"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["arch"] == f"{arch}-smoke" and line["finite"] and line["prefill_s"] > 0
    assert line["tokens"] == out["tokens"].tolist()
    assert out["prefill_logits"].shape == (4, get_config(arch).reduced().vocab_size)
    assert torch.equal(out["prefill_logits"].argmax(dim=-1), out["tokens"][:, 0])
    cfg = get_config(arch).reduced()
    model = init_params(cfg, torch.Generator("cpu").manual_seed(0), torch.float32)
    seq = torch.randint(0, cfg.vocab_size, (4, 64),
                        generator=torch.Generator("cpu").manual_seed(1))
    want = []
    with torch.inference_mode():
        for _ in range(33):
            logits, _ = forward(model.ctx, model, _text_batch(cfg, seq))
            tok = logits[:, -1].argmax(dim=-1)[:, None]
            want.append(tok)
            seq = torch.cat([seq, tok], dim=1)
    assert torch.equal(out["tokens"], torch.cat(want, dim=1))
    assert int(out["tokens"].min()) >= 0 and int(out["tokens"].max()) < cfg.vocab_size


def test_serve_cli_lm_encdec_tokens_equal_a_greedy_forward_loop(capsys):
    """``--mode lm --device cpu --arch seamless-m4t-large-v2 --reduced
    --json`` (B = 4, prompt 64, 16 source frames drawn after the prompt from
    its generator, gen 32): its tokens, all inside the vocabulary, equal a
    greedy loop of full ``forward`` passes over the growing sequence on the
    same source (no cache, the encoder rerun each pass)."""
    out = serve.main(["--mode", "lm", "--device", "cpu", "--arch", ENC_DEC, "--reduced",
                      "--json"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["arch"] == f"{ENC_DEC}-smoke" and line["finite"] and line["prefill_s"] > 0
    assert line["tokens"] == out["tokens"].tolist()
    cfg = get_config(ENC_DEC).reduced()
    assert out["prefill_logits"].shape == (4, cfg.vocab_size)
    model = init_params(cfg, torch.Generator("cpu").manual_seed(0), torch.float32)
    g = torch.Generator("cpu").manual_seed(1)
    seq = torch.randint(0, cfg.vocab_size, (4, 64), generator=g)
    src = torch.randn((4, 64 // steps.SRC_FRACTION, cfg.d_model), generator=g)
    want = []
    with torch.inference_mode():
        for _ in range(33):
            logits, _ = forward(model.ctx, model, _text_batch(cfg, seq, src))
            tok = logits[:, -1].argmax(dim=-1)[:, None]
            want.append(tok)
            seq = torch.cat([seq, tok], dim=1)
    assert torch.equal(out["tokens"], torch.cat(want, dim=1))
    assert int(out["tokens"].min()) >= 0 and int(out["tokens"].max()) < cfg.vocab_size


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_drops_where_decode_does_not(arch, monkeypatch):
    """Why the MoE comparisons of decode with a full forward take the
    no-drop capacity: at the default 1.25 the CLI's prefill (4 × 64 tokens,
    dispatch path) drops assignments, while a decode step (B = 4: C ≥ 8 ≥
    B, or the gather path) drops none; at E / k the prefill drops none."""
    drops = []
    run = moe.moe_forward

    def counted(p, cfg, x, stats=None, par=None):
        st = {}
        out = run(p, cfg, x, stats=st, par=par)
        drops.append((x.shape[1], int(st["dropped"].sum())))
        return out

    monkeypatch.setattr(moe, "moe_forward", counted)
    for capacity_factor, dropping in ((1.25, True), (None, False)):
        model = _model(arch)
        cfg = dataclasses.replace(model.cfg, **(_no_drop(model.cfg) if capacity_factor is None
                                               else dict(capacity_factor=capacity_factor)))
        seq = torch.randint(0, cfg.vocab_size, (4, 65),
                            generator=torch.Generator("cpu").manual_seed(1))
        ctx = dataclasses.replace(model.ctx, cfg=cfg)
        drops.clear()
        with torch.inference_mode():
            _, kvs = steps.make_prefill(ctx)(model, _text_batch(cfg, seq[:, :64]))
            prefill = [n for S, n in drops if S == 64]
            caches = decode.caches_from_prefill(ctx, kvs, 72)
            steps.make_decode_step(ctx)(model, seq[:, 64:], 64, caches)
        decoded = [n for S, n in drops if S == 1]
        assert len(prefill) == len(decoded) == cfg.n_layers // cfg.moe_every
        assert (sum(prefill) > 0) == dropping and sum(decoded) == 0


def test_serve_cli_lm_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    """With no card and no ``--device cpu`` the lm mode fails; it never
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        serve.main(["--mode", "lm", "--arch", "internlm2-1.8b", "--reduced", "--gen", "1"])
    with pytest.raises(SystemExit):
        serve.main(["--mode", "lm"])                      # --arch is required
    with pytest.raises(ValueError, match="floating dtype"):
        serve.main(["--mode", "lm", "--arch", "internlm2-1.8b", "--reduced",
                    "--device", "cpu", "--dtype", "int32"])


@pytest.mark.parametrize("arch", SERVED + MOE_ARCHS + SSM_ARCHS + [ENC_DEC])
def test_decode_matches_forward_next_token(arch):
    """Prefill caches + one decode step == full forward at position S (the
    reference's ``test_decode_matches_forward_next_token``, rtol = atol =
    2e-3; gemma2's local layers roll their 8-slot caches; the MoE models at
    the no-drop capacity; the enc-dec model's step reads the prefill's
    cross kvs of 6 source frames, which the forward encodes again).  The SSM
    and hybrid models replay the S prompt tokens through decode steps from
    ``init_caches`` instead of a prefill (hymba's 8-slot windows wrap),
    against the chunked forward over S + 1 (25: chunks of 5)."""
    model = _model(arch, **_no_drop(get_config(arch).reduced()))
    cfg, ctx = model.cfg, model.ctx
    B, S = 2, 24
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g)
    src = torch.randn((B, S // steps.SRC_FRACTION, cfg.d_model), generator=g)
    dstep = steps.make_decode_step(ctx)
    cross = ()
    with torch.inference_mode():
        full, _ = model(_text_batch(cfg, toks, src))
        if arch in SSM_ARCHS:
            caches = decode.init_caches(ctx, B, S + 8)
            for i in range(S):
                _, caches = dstep(model, toks[:, i:i + 1], i, caches)
        else:
            _, kvs = steps.make_prefill(ctx)(model, _text_batch(cfg, toks[:, :S], src))
            caches = decode.caches_from_prefill(ctx, kvs, cache_len=S + 8)
            if cfg.enc_dec:
                caches, cross_kvs = caches
                cross = (cross_kvs,)
        logits, _ = dstep(model, toks[:, S:S + 1], S, caches, *cross)
    np.testing.assert_allclose(to_np(logits[:, 0]), to_np(full[:, -1]), rtol=2e-3, atol=2e-3)


def test_sliding_window_ignores_distant_tokens():
    """Perturbing a token outside every window must not change the last
    logits (the reference's test, on a dense windowed config: internlm2
    reduced with an 8-token window on both layers)."""
    model = _model("internlm2-1.8b", sliding_window=8)
    cfg = model.cfg
    S = 64
    assert cfg.n_layers * cfg.sliding_window < S
    toks = torch.randint(0, cfg.vocab_size, (1, S), generator=torch.Generator().manual_seed(1))
    toks2 = toks.clone()
    toks2[:, 5] = (toks2[:, 5] + 1) % cfg.vocab_size
    with torch.inference_mode():
        base, _ = forward(model.ctx, model, _text_batch(cfg, toks))
        pert, _ = forward(model.ctx, model, _text_batch(cfg, toks2))
    np.testing.assert_allclose(to_np(base[:, -1]), to_np(pert[:, -1]), atol=1e-5)
    assert not torch.equal(base[:, 8], pert[:, 8])        # inside the window it does


def _ref_leaves(tree) -> list:
    return [(".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path), x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _cache_leaves(cache: dict, prefix: str = "") -> dict:
    """One layer's cache leaves by dotted name (``"k"``, ``"ssm.state"``)."""
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out.update(_cache_leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("arch, shape", SPEC_CASES)
def test_input_specs_and_synthetic_batch(arch, shape):
    """``input_specs`` has the reference's shapes (its cache leaves split by
    layer in execution order; an SSM layer's ``{"ssm": {"conv", "state"}}``,
    a hybrid layer's attention cache beside it), float leaves in the
    requested dtype, integer ids and positions; ``synthetic_batch`` realises
    them and the step runs on it to finite logits (long_500k, the
    subquadratic configs' cell, under the same override)."""
    cfg = get_config(arch).reduced()
    S, B = 16, 2
    spec = steps.input_specs(cfg, shape, override=(S, B), dtype=torch.float32)
    ref = ref_steps.input_specs(ref_module("configs.base").get_config(arch).reduced(),
                                shape, override=(S, B), dtype=jnp.float32)
    ref_shapes = {name: (tuple(s.shape), jnp.issubdtype(s.dtype, jnp.floating))
                  for name, s in _ref_leaves(ref)}
    got_shapes = {}
    groups = _paired(cfg)
    for k, v in spec.items():
        if k == "caches":
            parts = (((groups[0], v[0::2]), (groups[1], v[1::2])) if groups
                     else ((None, v),))
            for group, part in parts:
                for name in _cache_leaves(part[0]):
                    t = torch.stack([_cache_leaves(c)[name] for c in part])
                    where = group or ("ssm" if name.startswith("ssm.") else "attn")
                    got_shapes[f"caches.{where}.{name.removeprefix('ssm.')}"] = (
                        tuple(t.shape), t.dtype.is_floating_point)
        else:
            got_shapes[k] = (tuple(v.shape), v.dtype.is_floating_point)
    assert got_shapes == ref_shapes
    leaves = [t for t in spec.values() if isinstance(t, torch.Tensor)]
    leaves += [t for c in spec.get("caches", []) for t in _cache_leaves(c).values()]
    assert all(t.device.type == "meta" for t in leaves)
    assert {t.dtype for t in leaves} <= {torch.float32, torch.int64}

    batch = steps.synthetic_batch(cfg, shape, torch.Generator().manual_seed(0),
                                  override=(S, B), dtype=torch.float32)
    model = _model(arch)
    with torch.inference_mode():
        if shape == "prefill_32k":
            assert (("embeds" in batch) == (cfg.frontend == "vision"))
            torch.testing.assert_close(batch["positions"][..., -1],
                                       torch.full(batch["positions"].shape[:-1], S - 1))
            logits, kvs = steps.make_prefill(model.ctx)(model, batch)
            assert len(kvs) == cfg.n_layers
        else:
            assert batch["cur_pos"] == S
            assert all(torch.equal(c["pos"], torch.arange(c["k"].shape[1]))
                       for c in batch["caches"] if "pos" in c)
            assert all(bool(c["ssm"]["state"].any()) for c in batch["caches"] if "ssm" in c)
            logits, _ = steps.make_decode_step(model.ctx)(
                model, batch["tokens"], batch["cur_pos"], batch["caches"])
    assert logits.shape == (B, 1, cfg.vocab_size) and bool(torch.isfinite(logits).all())


def test_train_shape_waits_for_the_training_half():
    """The train cells' inputs now exist (the training half's first slice):
    the reference's names and shapes, ``targets`` among them."""
    for arch in sorted(port_base.all_configs()):
        cfg = get_config(arch).reduced()
        spec = steps.input_specs(cfg, "train_4k", override=(8, 2))
        ref = ref_steps.input_specs(ref_module("configs.base").get_config(arch).reduced(),
                                    "train_4k", override=(8, 2))
        assert {k: tuple(v.shape) for k, v in spec.items()} == {
            k: tuple(v.shape) for k, v in ref.items()}
        assert tuple(spec["targets"].shape) == (2, 8) and spec["targets"].dtype == torch.int64


# =============================================================================
# f64, token for token against the reference (last: x64 stays on for the rest
# of the module once taken)
# =============================================================================

@pytest.mark.parametrize("arch", SERVED + MOE_ARCHS + SSM_ARCHS + [ENC_DEC])
def test_greedy_continuation_equals_the_reference_f64(arch, x64):
    """``lm_generate`` (prefill, then 8 greedy decode steps) against the
    reference's ``_lm_main`` loop in f64, the same prompt and carried
    weights: every token equal (the MoE models at the default capacity,
    their router f32 on both sides; the SSM and hybrid models through the
    replayed prefill, their SSD internals f32 on both sides; the enc-dec
    model on 3 source frames, each decode step reading the prefill's cross
    kvs)."""
    p = Pair(arch, jnp.float64, torch.float64)
    B, P, gen = 2, 12, 8
    b = p.batch(B, P, 5)
    cross = ()
    if arch in SSM_ARCHS:
        caches = ref_decode.init_caches(p.ctx_r, B, P + gen)
        for i in range(P):
            lw, caches = p.decode_r(p.tree, jx(b["tokens"][:, i:i + 1]),
                                    jnp.array(i, jnp.int32), caches)
    else:
        lw, kvw = p.prefill_r(p.tree, {k: jx(v) for k, v in b.items()})
        caches = ref_decode.caches_from_prefill(p.ctx_r, kvw, P + gen)
        if p.cfg.enc_dec:
            caches, cross_kvs = caches
            cross = (cross_kvs,)
    tok = jnp.argmax(lw[:, -1], axis=-1).astype(jnp.int32)[:, None]
    want = [tok]
    for i in range(gen):
        lw, caches = p.decode_r(p.tree, tok, jnp.array(P + i, jnp.int32), caches, *cross)
        tok = jnp.argmax(lw[:, -1], axis=-1).astype(jnp.int32)[:, None]
        want.append(tok)
    want = np.concatenate([np.asarray(t) for t in want], axis=1)
    out = serve.lm_generate(p.ctx, p.model, {k: tt(v).long() if v.dtype.kind == "i" else tt(v)
                                             for k, v in b.items()}, gen)
    assert out["finite"] and out["tokens"].shape == (B, gen + 1)
    np.testing.assert_array_equal(to_np(out["tokens"]), want)
