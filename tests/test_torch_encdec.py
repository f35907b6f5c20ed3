"""The enc-dec family (seamless-m4t-large-v2) against the JAX reference on
the CPU: cross-attention (``models/attention.py``), the bidirectional
encoder stack and its final norm, each decoder layer's cross sublayer
(``models/transformer.py``), the cross kvs handed to decode
(``models/decode.py``), the enc-dec input specs (``models/steps.py``) and
the encoder tree's carry-over (``models/convert.py``).

The reduced config: 2 encoder and 2 decoder layers, d_model 64, 4 heads of
16 over 2 KV heads (so the GQA repeat runs in the encoder, the decoder's
self-attention and its cross-attention).  Inputs are made with numpy from a
seed and fed to both packages; the reference's weights (its norm scales
and biases replaced by seeded values) reach the port through
``models.convert``.  Tolerance: f32, 1e-5 of the largest magnitude of the
reference's array (``test_torch_models.assert_rel``), as for the other
families; the f64 greedy tokens are in ``tests/test_torch_lm_serve.py``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_harness import ref_module, seeded, to_np
from test_torch_models import ENC_DEC, F32_RTOL, Pair, assert_cache, assert_rel, jx, tt
from test_torch_models import one_thread  # noqa: F401  (fixture)

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.models import attention as port_attn
from repro_torch.models import convert
from repro_torch.models import decode as port_decode
from repro_torch.models import steps as port_steps
from repro_torch.models import transformer as port_tf

ref_base = ref_module("configs.base")
ref_attn = ref_module("models.attention")
ref_tf = ref_module("models.transformer")
ref_decode = ref_module("models.decode")
ref_steps = ref_module("models.steps")

B, S = 2, 12                    # T = 3 source frames


@pytest.fixture(scope="module")
def pair() -> Pair:
    return Pair(ENC_DEC)


def _np_batch(p: Pair, seed: int, S: int = S) -> dict:
    return p.batch(B, S, seed)


def _ref(b: dict) -> dict:
    return {k: jx(v) for k, v in b.items()}


def _port(b: dict) -> dict:
    return {k: tt(v).long() if v.dtype.kind == "i" else tt(v) for k, v in b.items()}


def test_reduced_config_has_the_encoder_and_gqa(pair):
    cfg = pair.cfg
    assert cfg.enc_dec and (cfg.n_enc_layers, cfg.n_layers) == (2, 2)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd) == (64, 4, 2, 16)
    assert port_tf.layer_kind(cfg) == ref_tf.layer_kind(pair.cfg_r) == "dense"
    assert port_tf.layer_kinds(cfg) == ["decoder_x", "decoder_x"]
    assert [layer.kind for layer in pair.model.encoder.layers] == ["encoder", "encoder"]
    assert all(layer.window == 0 for layer in pair.model.encoder.layers)


@pytest.mark.parametrize("qkv_bias", [False, True], ids=["plain", "bias"])
def test_cross_kv_and_cross_forward_match_reference(qkv_bias):
    """``cross_kv`` over the encoder's output (B, T, d) and ``cross_forward``
    of the decoder's (B, S, d) over it: no RoPE, no mask, GQA 4 over 2; with
    ``qkv_bias`` the q, k and v biases are added (seeded, not zeros)."""
    cfg_p = dataclasses.replace(get_config(ENC_DEC).reduced(), qkv_bias=qkv_bias)
    cfg_r = dataclasses.replace(ref_base.get_config(ENC_DEC).reduced(), qkv_bias=qkv_bias)
    d, H, KV, hd = cfg_p.d_model, cfg_p.n_heads, cfg_p.n_kv_heads, cfg_p.hd
    w = {"wq": seeded((d, H * hd), 1, np.float32) * d ** -0.5,
         "wk": seeded((d, KV * hd), 2, np.float32) * d ** -0.5,
         "wv": seeded((d, KV * hd), 3, np.float32) * d ** -0.5,
         "wo": seeded((H * hd, d), 4, np.float32) * (H * hd) ** -0.5}
    if qkv_bias:
        w.update(bq=0.1 * seeded((H * hd,), 5, np.float32),
                 bk=0.1 * seeded((KV * hd,), 6, np.float32),
                 bv=0.1 * seeded((KV * hd,), 7, np.float32))
    p = port_attn.Attention(cfg_p, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for name, arr in w.items():
            getattr(p, name).copy_(tt(arr))
    enc_out = seeded((B, 5, d), 8, np.float32)
    x = seeded((B, 7, d), 9, np.float32)
    kv_r = ref_attn.cross_kv({k: jx(v) for k, v in w.items()}, cfg_r, jx(enc_out))
    with torch.inference_mode():
        kv_p = port_attn.cross_kv(p, cfg_p, tt(enc_out))
        out_p = port_attn.cross_forward(p, cfg_p, tt(x), kv_p)
    assert kv_p[0].shape == kv_p[1].shape == (B, 5, KV, hd)
    assert_rel(kv_p[0], kv_r[0], F32_RTOL)
    assert_rel(kv_p[1], kv_r[1], F32_RTOL)
    out_r = ref_attn.cross_forward({k: jx(v) for k, v in w.items()}, cfg_r, jx(x), kv_r)
    assert out_p.shape == (B, 7, d)
    assert_rel(out_p, out_r, F32_RTOL)


def test_encoder_output_matches_reference_and_is_bidirectional(pair):
    """``extras["enc_out"]`` (the encoder's layers, then its final norm)
    equals the reference's; moving the last source frame moves position 0's
    encoder output in both packages (a causal encoder would not)."""
    b = _np_batch(pair, 1)
    b2 = dict(b, src_embeds=b["src_embeds"].copy())
    b2["src_embeds"][:, -1] += 1.0
    fwd = jax.jit(lambda t, x: ref_tf.forward_hidden(pair.ctx_r, t, x)[1]["enc_out"])
    want, want2 = fwd(pair.tree, _ref(b)), fwd(pair.tree, _ref(b2))
    with torch.inference_mode():
        _, ex = port_tf.forward_hidden(pair.ctx, pair.model, _port(b))
        _, ex2 = port_tf.forward_hidden(pair.ctx, pair.model, _port(b2))
        alone = port_tf.encode(pair.ctx, pair.model, tt(b["src_embeds"]),
                               tt(b["src_positions"]).long())
    assert ex["enc_out"].shape == (B, 3, pair.cfg.d_model)
    assert_rel(ex["enc_out"], want, F32_RTOL)
    assert_rel(ex2["enc_out"], want2, F32_RTOL)
    assert torch.equal(alone, ex["enc_out"])
    assert float(np.abs(np.asarray(want2)[:, 0] - np.asarray(want)[:, 0]).max()) > 1e-3
    assert float((ex2["enc_out"][:, 0] - ex["enc_out"][:, 0]).abs().max()) > 1e-3


def test_encoder_stays_bidirectional_above_the_chunked_threshold(pair, monkeypatch):
    """At T above ``CHUNKED_ATTN_THRESHOLD`` the encoder still attends to
    every frame with ``_sdpa`` (the causal ``_chunked_sdpa`` is never taken):
    frame 0's output moves with the last frame."""
    T = port_attn.CHUNKED_ATTN_THRESHOLD + 8
    taken = []
    real = port_attn._chunked_sdpa
    monkeypatch.setattr(port_attn, "_chunked_sdpa",
                        lambda *a, **k: taken.append(1) or real(*a, **k))
    src = tt(seeded((1, T, pair.cfg.d_model), 10, np.float32))
    src2 = src.clone()
    src2[:, -1] += 1.0
    pos = torch.arange(T)[None]
    with torch.inference_mode():
        out = port_tf.encode(pair.ctx, pair.model, src, pos)
        out2 = port_tf.encode(pair.ctx, pair.model, src2, pos)
    assert not taken
    assert float((out2[:, 0] - out[:, 0]).abs().max()) > 0.0


def test_forward_logits_match_reference(pair):
    b = _np_batch(pair, 2)
    want, _ = jax.jit(lambda t, x: ref_tf.forward(pair.ctx_r, t, x))(pair.tree, _ref(b))
    with torch.inference_mode():
        got, extras = port_tf.forward(pair.ctx, pair.model, _port(b))
        again = port_steps.make_forward(pair.ctx)(pair.model, _port(b))
    assert got.shape == (B, S, pair.cfg.vocab_size) and got.dtype == torch.float32
    assert_rel(got, want, F32_RTOL)
    assert torch.equal(again, got)
    assert extras["kvs"] == ([], []) and extras["aux"] == 0.0


def test_prefill_self_and_cross_kvs_match_reference(pair):
    """``make_prefill``'s last-position logits and its kvs, (self kvs, cross
    kvs) with one (k, v) a decoder layer, against the reference's stacked
    pair; ``caches_from_prefill``'s caches (k, v, pos) and the cross kvs it
    hands back, the prefill's own tensors."""
    b = _np_batch(pair, 3)
    cache_len = 20
    lw, kvw = pair.prefill_r(pair.tree, _ref(b))
    cw, crossw = ref_decode.caches_from_prefill(pair.ctx_r, kvw, cache_len)
    with torch.inference_mode():
        lg, kvg = port_steps.make_prefill(pair.ctx)(pair.model, _port(b))
        cg, crossg = port_decode.caches_from_prefill(pair.ctx, kvg, cache_len)
    assert lg.shape == (B, 1, pair.cfg.vocab_size)
    assert_rel(lg, lw, F32_RTOL)
    self_kvs, cross_kvs = kvg
    assert len(self_kvs) == len(cross_kvs) == len(cg) == len(crossg) == pair.cfg.n_layers
    for i in range(pair.cfg.n_layers):
        for j in (0, 1):
            assert self_kvs[i][j].shape == (B, S, 2, 16)
            assert cross_kvs[i][j].shape == (B, 3, 2, 16)
            assert_rel(self_kvs[i][j], kvw[0][j][i], F32_RTOL)
            assert_rel(cross_kvs[i][j], kvw[1][j][i], F32_RTOL)
            assert_rel(crossg[i][j], crossw[j][i], F32_RTOL)
            assert crossg[i][j] is cross_kvs[i][j]
        assert_cache(cg[i], {k: v[i] for k, v in cw["attn"].items()})


def test_decode_steps_with_cross_kvs_match_reference(pair):
    """Three greedy ``decode_step``s from the prefill's caches and cross
    kvs: each step's logits and every layer's cache after it; both sides are
    fed the reference's argmax."""
    b = _np_batch(pair, 4)
    cache_len = 16
    lw, kvw = pair.prefill_r(pair.tree, _ref(b))
    cw, crossw = ref_decode.caches_from_prefill(pair.ctx_r, kvw, cache_len)
    dstep = port_steps.make_decode_step(pair.ctx)
    with torch.inference_mode():
        _, kvg = port_steps.make_prefill(pair.ctx)(pair.model, _port(b))
        cg, crossg = port_decode.caches_from_prefill(pair.ctx, kvg, cache_len)
        tok = np.asarray(jnp.argmax(lw[:, -1], axis=-1)).astype(np.int32)[:, None]
        for step in range(3):
            lw, cw = pair.decode_r(pair.tree, jx(tok), jnp.array(S + step, jnp.int32), cw,
                                   crossw)
            lg, cg = dstep(pair.model, tt(tok).long(), S + step, cg, crossg)
            assert lg.shape == (B, 1, pair.cfg.vocab_size)
            assert_rel(lg, lw, F32_RTOL)
            for i in range(pair.cfg.n_layers):
                assert_cache(cg[i], {k: v[i] for k, v in cw["attn"].items()})
            tok = np.asarray(jnp.argmax(lw[:, -1], axis=-1)).astype(np.int32)[:, None]


def test_decode_reads_the_prefill_cross_kvs_and_never_recomputes_them(pair, monkeypatch):
    """A decode step calls no ``cross_kv`` (it has no encoder output): it
    reads the cross kvs it is given, so other cross kvs give other logits;
    without them, or with them for a model that has none, it raises."""
    b = _np_batch(pair, 5)
    with torch.inference_mode():
        _, kvs = port_steps.make_prefill(pair.ctx)(pair.model, _port(b))
        caches, cross = port_decode.caches_from_prefill(pair.ctx, kvs, 16)
        tok = torch.zeros((B, 1), dtype=torch.long)

        def refused(*a, **k):
            raise AssertionError("a decode step recomputed the cross kvs")

        monkeypatch.setattr(port_tf, "cross_kv", refused)
        monkeypatch.setattr(port_attn, "cross_kv", refused)
        base, _ = port_decode.decode_step(pair.ctx, pair.model, tok, S,
                                          [dict(c, k=c["k"].clone(), v=c["v"].clone(),
                                                pos=c["pos"].clone()) for c in caches],
                                          cross_kvs=cross)
        other = [(k, -v) for k, v in cross]
        moved, _ = port_decode.decode_step(pair.ctx, pair.model, tok, S, caches,
                                           cross_kvs=other)
        assert float((moved - base).abs().max()) > 1e-4
        with pytest.raises(ValueError, match="cross kvs"):
            port_decode.decode_step(pair.ctx, pair.model, tok, S + 1, caches)
    dense = port_tf.init_params(get_config("internlm2-1.8b").reduced(),
                                torch.Generator().manual_seed(0), torch.float32)
    with torch.inference_mode(), pytest.raises(ValueError, match="cross kvs"):
        port_decode.decode_step(dense.ctx, dense, tok, 0,
                                port_decode.init_caches(dense.ctx, B, 4), cross_kvs=cross)


def test_convert_maps_the_encoder_tree_bitwise(pair):
    """Every parameter is the reference's array, bitwise: ``encoder.layers.i.*``
    stacked i of ``encoder.layers.*``, ``encoder.final_norm``, each decoder
    layer's ``cross.*`` and ``norm_cross``; every array of the tree used; an
    encoder stack of the wrong depth or a missing cross array raises."""
    flat = {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(pair.tree)[0]}
    seen = set()
    for name, t in pair.model.named_parameters():
        if name.startswith("encoder.layers."):
            _, _, i, rest = name.split(".", 3)
            src, want = f"encoder.layers.{rest}", flat[f"encoder.layers.{rest}"][int(i)]
        elif name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            src, want = f"layers.{rest}", flat[f"layers.{rest}"][int(i)]
        else:
            src, want = name, flat[name]
        seen.add(src)
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(to_np(t), want)
    assert seen == set(flat)
    assert {"encoder.final_norm", "encoder.layers.attn.wq", "encoder.layers.mlp.w_in",
            "layers.cross.wq", "layers.cross.wo", "layers.norm_cross"} <= seen
    tree = jax.tree.map(np.asarray, pair.tree)
    deep = dict(tree, encoder=dict(tree["encoder"], layers=jax.tree.map(
        lambda x: np.concatenate([x, x[:1]]), tree["encoder"]["layers"])))
    with pytest.raises(ValueError, match="3 stacked layers, the config has 2"):
        convert.params_from_reference(pair.cfg, deep)
    layers = dict(tree["layers"])
    del layers["norm_cross"]
    with pytest.raises(ValueError, match="has no 'layers.norm_cross'"):
        convert.params_from_reference(pair.cfg, dict(tree, layers=layers))


def _leaves(spec: dict) -> dict:
    """The port's spec leaves under the reference's leaf names: the cache
    and cross kv lists stacked by layer (``caches.attn.k``, ``cross_kvs.0``)."""
    out = {}
    for k, v in spec.items():
        if k == "caches":
            for name in v[0]:
                out[f"caches.attn.{name}"] = torch.stack([c[name] for c in v])
        elif k == "cross_kvs":
            for j in (0, 1):
                out[f"cross_kvs.{j}"] = torch.stack([kv[j] for kv in v])
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("override", [None, (16, 2)], ids=["full", "cut"])
def test_input_specs_match_reference(shape, override):
    """``input_specs`` of the full and the reduced config: the reference's
    shapes (T = S / 4 source frames), float leaves in the requested dtype,
    integer ids and positions, all on the meta device."""
    for cfg_p, cfg_r in ((get_config(ENC_DEC), ref_base.get_config(ENC_DEC)),
                         (get_config(ENC_DEC).reduced(), ref_base.get_config(ENC_DEC).reduced())):
        spec = port_steps.input_specs(cfg_p, shape, override=override, dtype=torch.float32)
        ref = ref_steps.input_specs(cfg_r, shape, override=override, dtype=jnp.float32)
        want = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
                (tuple(s.shape), jnp.issubdtype(s.dtype, jnp.floating))
                for path, s in jax.tree_util.tree_flatten_with_path(ref)[0]}
        got = {k: (tuple(t.shape), t.dtype.is_floating_point) for k, t in _leaves(spec).items()}
        assert got == want
        assert all(t.device.type == "meta" for t in _leaves(spec).values())
        assert {t.dtype for t in _leaves(spec).values()} <= {torch.float32, torch.int64}
        S_, B_ = override or SHAPES[shape][:2]
        key = "src_embeds" if shape == "prefill_32k" else "cross_kvs.0"
        assert got[key][0][1 if shape == "prefill_32k" else 2] == S_ // port_steps.SRC_FRACTION


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_synthetic_batch_runs_the_step(shape, pair):
    """``synthetic_batch`` realises the reduced cell at (S, B) = (16, 2): 4
    source frames at positions 0..3, cross kvs of 4 frames a layer; the
    prefill or decode step runs on it to finite logits."""
    cfg, model = pair.cfg, pair.model
    batch = port_steps.synthetic_batch(cfg, shape, torch.Generator().manual_seed(0),
                                       override=(16, 2), dtype=torch.float32)
    with torch.inference_mode():
        if shape == "prefill_32k":
            assert batch["src_embeds"].shape == (2, 4, cfg.d_model)
            assert torch.equal(batch["src_positions"], torch.arange(4).expand(2, 4))
            assert 0.01 < float(batch["src_embeds"].std()) < 0.03
            logits, (self_kvs, cross_kvs) = port_steps.make_prefill(model.ctx)(model, batch)
            assert len(self_kvs) == len(cross_kvs) == cfg.n_layers
            assert cross_kvs[0][0].shape == (2, 4, cfg.n_kv_heads, cfg.hd)
        else:
            assert batch["cur_pos"] == 16 and len(batch["cross_kvs"]) == cfg.n_layers
            assert all(k.shape == v.shape == (2, 4, cfg.n_kv_heads, cfg.hd)
                       for k, v in batch["cross_kvs"])
            assert all(torch.equal(c["pos"], torch.arange(16)) for c in batch["caches"])
            logits, _ = port_steps.make_decode_step(model.ctx)(
                model, batch["tokens"], batch["cur_pos"], batch["caches"], batch["cross_kvs"])
    assert logits.shape == (2, 1, cfg.vocab_size) and bool(torch.isfinite(logits).all())
