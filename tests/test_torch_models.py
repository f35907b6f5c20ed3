"""The port's LM modules (``repro_torch.configs``, ``repro_torch.models``)
against the JAX reference on the CPU.

Inputs are made with numpy from a seed and fed to both packages; the
reference's weights reach the port through ``models.convert``.  Tolerances,
relative to the largest magnitude of the reference's array
(:func:`assert_rel`): 1e-10 where the reference computes in f64 end to end
(the gated MLP, softcap); 1e-5 in f32 (norms, rotary embeddings, attention,
whole models).  The reference itself computes in f32 inside an f64 model
(``rms_norm``'s variance and ``rsqrt``, the rotary angles and their
cos/sin, the attention logits and softmax), and XLA's and PyTorch's f32
``cos``, ``sin``, ``rsqrt``, ``exp`` and ``tanh`` differ in the last bit on
some inputs, so those pieces and the whole models are held in f32; the f64
models are held token for token (``tests/test_torch_lm_serve.py``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_harness import ref_module, seeded, to_np
from test_torch_harness import x64  # noqa: F401  (fixture)

from repro_torch.configs import base as port_base
from repro_torch.models import attention as port_attn
from repro_torch.models import common as port_common
from repro_torch.models import convert
from repro_torch.models import decode as port_decode
from repro_torch.models import mlp as port_mlp
from repro_torch.models import steps as port_steps
from repro_torch.models import transformer as port_tf

ref_base = ref_module("configs.base")
ref_common = ref_module("models.common")
ref_attn = ref_module("models.attention")
ref_mlp = ref_module("models.mlp")
ref_tf = ref_module("models.transformer")
ref_decode = ref_module("models.decode")
ref_steps = ref_module("models.steps")

ARCHS = sorted(ref_base.all_configs())
#: the dense and vlm configs the port serves
SERVED = ["gemma2-2b", "internlm2-1.8b", "minicpm-2b", "qwen2-vl-7b", "qwen2.5-32b"]
#: the moe configs the port serves (``tests/test_torch_moe.py``)
MOE_ARCHS = ["llama4-maverick-400b-a17b", "qwen3-moe-235b-a22b"]
#: the ssm and hybrid configs the port serves (``tests/test_torch_ssm.py``)
SSM_ARCHS = ["hymba-1.5b", "mamba2-780m"]
#: the enc-dec config (``tests/test_torch_encdec.py``)
ENC_DEC = "seamless-m4t-large-v2"

F32_RTOL = 1e-5
F64_RTOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's tiny widths: more only contend
    with the other test workers' threads (the suite runs several workers)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def assert_rel(got, want, rtol: float) -> None:
    """max |got - want| <= rtol · max |want| (same shape)."""
    a, b = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err, scale = np.abs(a - b).max(), np.abs(b).max()
    assert err <= rtol * scale, f"max abs err {err:.3e} > {rtol:g} × {scale:.3e}"


def jx(a: np.ndarray):
    return jnp.asarray(a)


def tt(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# =============================================================================
# Configs
# =============================================================================

def test_registry_is_the_references():
    assert sorted(port_base.all_configs()) == ARCHS and len(ARCHS) == 10
    assert port_base.SHAPES == ref_base.SHAPES
    with pytest.raises(KeyError, match="unknown arch"):
        port_base.get_config("gpt-17")


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    """Every field, derived property, ``reduced()``, ``shapes()`` and
    parameter count equals the reference's, full and reduced."""
    full_p, full_r = port_base.get_config(arch), ref_base.get_config(arch)
    for p, r in ((full_p, full_r), (full_p.reduced(), full_r.reduced())):
        assert dataclasses.asdict(p) == dataclasses.asdict(r)
        assert (p.hd, p.has_attn, p.has_ssm, p.d_inner, p.ssm_heads) == (
            r.hd, r.has_attn, r.has_ssm, r.d_inner, r.ssm_heads)
        assert p.shapes() == r.shapes()
        assert p.param_count() == r.param_count()
        assert p.active_param_count() == r.active_param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_full_config_exact(arch):
    """The full configs carry the assigned numbers exactly (the reference's
    ``tests/test_models.py`` table)."""
    cfg = port_base.get_config(arch)
    table = {
        "mamba2-780m": (48, 1536, 0, 0, 0, 50280),
        "qwen3-moe-235b-a22b": (94, 4096, 64, 4, 1536, 151936),
        "llama4-maverick-400b-a17b": (48, 5120, 40, 8, 8192, 202048),
        "qwen2-vl-7b": (28, 3584, 28, 4, 18944, 152064),
        "minicpm-2b": (40, 2304, 36, 36, 5760, 122753),
        "internlm2-1.8b": (24, 2048, 16, 8, 8192, 92544),
        "gemma2-2b": (26, 2304, 8, 4, 9216, 256000),
        "qwen2.5-32b": (64, 5120, 40, 8, 27648, 152064),
        "hymba-1.5b": (32, 1600, 25, 5, 5504, 32001),
        "seamless-m4t-large-v2": (24, 1024, 16, 16, 8192, 256206),
    }
    L, d, H, KV, ff, V = table[arch]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab_size) == (L, d, H, KV, ff, V)
    if arch == "qwen3-moe-235b-a22b":
        assert (cfg.n_experts, cfg.top_k) == (128, 8)
    if arch == "llama4-maverick-400b-a17b":
        assert (cfg.n_experts, cfg.top_k) == (128, 1)
    if arch == "mamba2-780m":
        assert cfg.ssm_state == 128
    if arch == "hymba-1.5b":
        assert cfg.ssm_state == 16


def test_internlm2_full_width_is_1_89b_parameters():
    cfg = port_base.get_config("internlm2-1.8b")
    assert cfg.hd == 128 and cfg.param_count() == 1_889_107_968


@pytest.mark.parametrize("arch", SERVED + [ENC_DEC])
def test_model_holds_the_analytic_parameter_count(arch):
    """The port's model holds ``param_count()`` parameters, plus the final
    norm (an enc-dec model's encoder's too) and gemma2's post-norms, which
    the analytic count leaves out."""
    cfg = port_base.get_config(arch).reduced()
    model = port_tf.Transformer(cfg, device="cpu")
    extra = cfg.d_model * (1 + cfg.enc_dec + (2 * cfg.n_layers if cfg.post_norm else 0))
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count() + extra


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", SERVED + SSM_ARCHS)
def test_window_flags_and_execution_order(arch, reduced):
    """Per-layer windows equal the reference's ``_window_flags``; the
    execution order pairs stacked layer j with L/2 + j under gemma2's
    local/global alternation, as the reference's scan does."""
    p, r = port_base.get_config(arch), ref_base.get_config(arch)
    if reduced:
        p, r = p.reduced(), r.reduced()
    assert port_tf._window_flags(p) == ref_tf._window_flags(r)
    order = port_tf.execution_order(p)
    L = p.n_layers
    if p.local_global:
        stacked = np.arange(L).reshape(2, L // 2).swapaxes(0, 1).reshape(-1)
        assert order == stacked.tolist()
    else:
        assert order == list(range(L))


def test_gemma2_local_global_alternation():
    flags = port_tf._window_flags(port_base.get_config("gemma2-2b"))
    assert flags[0] == 4096 and flags[1] == 0 and len(flags) == 26
    assert all(f == 4096 for f in flags[::2])
    assert all(f == 0 for f in flags[1::2])
    assert port_tf.execution_order(port_base.get_config("gemma2-2b"))[:4] == [0, 13, 1, 14]


# =============================================================================
# Common pieces
# =============================================================================

@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm_matches_reference(offset):
    x = seeded((2, 5, 64), 0, np.float32) * 3
    s = seeded((64,), 1, np.float32)
    want = ref_common.rms_norm(jx(x), jx(s), 1e-6, offset)
    got = port_common.rms_norm(tt(x), tt(s), 1e-6, offset)
    assert got.dtype == torch.float32
    assert_rel(got, want, F32_RTOL)


def test_rms_norm_stays_in_bf16():
    """bf16 x: the ``rsqrt`` and the scale are cast to bf16 before the
    products, so the output is bf16 (within one bf16 rounding, 2⁻⁸ of the
    largest, of the reference's)."""
    x = seeded((2, 5, 64), 12, np.float32) * 3
    s = seeded((64,), 13, np.float32)
    want = ref_common.rms_norm(jx(x).astype(jnp.bfloat16), jx(s).astype(jnp.bfloat16))
    got = port_common.rms_norm(tt(x).bfloat16(), tt(s).bfloat16())
    assert got.dtype == torch.bfloat16
    assert_rel(got.float(), np.asarray(want).astype(np.float32), 2.0 ** -8)


def test_rms_norm_takes_the_variance_in_f32_for_f64():
    """The reference's rule: f64 x, variance and ``rsqrt`` in f32, cast back
    before the products; the scale too passes through f32."""
    x = tt(seeded((3, 64), 2))
    s = tt(seeded((64,), 3))
    r = torch.rsqrt((x.float() ** 2).mean(-1, keepdim=True) + 1e-6).double()
    assert torch.equal(port_common.rms_norm(x, s), x * r * s.float().double())


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_reference(theta):
    x = seeded((2, 16, 4, 16), 4, np.float32)
    pos = np.broadcast_to(np.arange(16) * 7, (2, 16)).astype(np.int32)
    assert_rel(port_common.rope_freqs(16, theta), ref_common.rope_freqs(16, theta), 0.0)
    assert_rel(port_common.apply_rope(tt(x), tt(pos), theta),
               ref_common.apply_rope(jx(x), jx(pos), theta), F32_RTOL)


def test_apply_mrope_matches_reference():
    """Three distinct position streams (temporal/height/width)."""
    x = seeded((2, 16, 4, 16), 5, np.float32)
    pos3 = np.random.default_rng(6).integers(0, 64, (3, 2, 16)).astype(np.int32)
    assert_rel(port_common.apply_mrope(tt(x), tt(pos3), 1e6, (2, 3, 3)),
               ref_common.apply_mrope(jx(x), jx(pos3), 1e6, (2, 3, 3)), F32_RTOL)


def test_mrope_reduces_to_rope_for_text():
    x = tt(seeded((2, 16, 4, 16), 7, np.float32))
    pos = torch.arange(16).expand(2, 16)
    r1 = port_common.apply_rope(x, pos, 1e4)
    r2 = port_common.apply_mrope(x, pos[None].expand(3, 2, 16), 1e4, (2, 3, 3))
    assert torch.equal(r1, r2)


@pytest.mark.parametrize("q_len, kv_len, q_offset, window",
                         [(8, 8, 0, 0), (8, 8, 0, 3), (1, 20, 19, 0), (4, 24, 20, 6)])
def test_causal_mask_matches_reference(q_len, kv_len, q_offset, window):
    got = port_common.causal_mask(q_len, kv_len, q_offset=q_offset, window=window)
    want = ref_common.causal_mask(q_len, kv_len, q_offset=q_offset, window=window)
    np.testing.assert_array_equal(to_np(got), to_np(want))


def test_initialisers_draw_from_the_generator():
    g = torch.Generator().manual_seed(3)
    e = port_common.embed_init(g, (4000,), torch.float64)
    d = port_common.dense_init(g, (4000,), 16, torch.float32)
    assert e.dtype == torch.float64 and abs(float(e.std()) - 0.02) < 2e-3
    assert d.dtype == torch.float32 and float(d.abs().max()) <= 0.25
    g2 = torch.Generator().manual_seed(3)
    assert torch.equal(port_common.embed_init(g2, (4000,), torch.float64), e)


# =============================================================================
# MLP and attention
# =============================================================================

def _attn_cfgs(kv: int, softcap: float):
    base_p = port_base.get_config("internlm2-1.8b").reduced()
    base_r = ref_base.get_config("internlm2-1.8b").reduced()
    kw = dict(n_kv_heads=kv, attn_softcap=softcap)
    return dataclasses.replace(base_p, **kw), dataclasses.replace(base_r, **kw)


def _qkv(S: int, H: int, KV: int, hd: int, seed: int):
    return (seeded((2, S, H, hd), seed, np.float32), seeded((2, S, KV, hd), seed + 1, np.float32),
            seeded((2, S, KV, hd), seed + 2, np.float32))


ATTN_CASES = [(4, 0.0, 0), (2, 0.0, 32), (1, 50.0, 0), (2, 50.0, 32)]
ATTN_IDS = ["mha", "gqa2-w32", "mqa-softcap", "gqa2-softcap-w32"]


@pytest.mark.parametrize("kv, cap, window", ATTN_CASES, ids=ATTN_IDS)
def test_sdpa_matches_reference(kv, cap, window):
    cfg_p, cfg_r = _attn_cfgs(kv, cap)
    S = 96
    q, k, v = _qkv(S, 4, kv, 16, 11)
    mask = ref_common.causal_mask(S, S, window=window)[None, None]
    want = ref_attn._sdpa(cfg_r, jx(q), jx(k), jx(v), mask)
    got = port_attn._sdpa(cfg_p, tt(q), tt(k), tt(v),
                          port_common.causal_mask(S, S, window=window)[None, None])
    assert_rel(got, want, F32_RTOL)


@pytest.mark.parametrize("S, n_q, kv_chunk", [(128, 4, 32), (120, 8, 32)],
                         ids=["even", "rounded"])
@pytest.mark.parametrize("kv, cap, window", ATTN_CASES, ids=ATTN_IDS)
def test_chunked_sdpa_matches_reference(kv, cap, window, S, n_q, kv_chunk):
    """The same q/kv chunk rounding (S = 120: q chunks of 15, KV blocks of
    30) and block ranges; also within 2e-5 of the port's ``_sdpa``, as the
    reference's ``test_chunked_attention_matches_full`` holds its own."""
    cfg_p, cfg_r = _attn_cfgs(kv, cap)
    q, k, v = _qkv(S, 4, kv, 16, 12)
    want = jax.jit(lambda q, k, v: ref_attn._chunked_sdpa(      # one compile, not one a chunk
        cfg_r, q, k, v, window=window, n_q_chunks=n_q, kv_chunk=kv_chunk))(jx(q), jx(k), jx(v))
    got = port_attn._chunked_sdpa(cfg_p, tt(q), tt(k), tt(v), window=window,
                                  n_q_chunks=n_q, kv_chunk=kv_chunk)
    assert_rel(got, want, F32_RTOL)
    full = port_attn._sdpa(cfg_p, tt(q), tt(k), tt(v),
                           port_common.causal_mask(S, S, window=window)[None, None])
    np.testing.assert_allclose(to_np(got), to_np(full), rtol=2e-5, atol=2e-5)


def test_attn_forward_takes_the_chunked_path_above_the_threshold(monkeypatch):
    cfg = port_base.get_config("internlm2-1.8b").reduced()
    attn = port_attn.Attention(cfg, dtype=torch.float32, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    taken = []
    real = port_attn._chunked_sdpa
    monkeypatch.setattr(port_attn, "_chunked_sdpa",
                        lambda *a, **k: taken.append(1) or real(*a, **k))
    for S in (port_attn.CHUNKED_ATTN_THRESHOLD, port_attn.CHUNKED_ATTN_THRESHOLD + 8):
        x = torch.randn(1, S, cfg.d_model, generator=torch.Generator().manual_seed(1)) * 0.1
        with torch.inference_mode():
            attn(x, torch.arange(S)[None])
    assert taken == [1]


# =============================================================================
# Whole models through models.convert
# =============================================================================

def _ref_tree(cfg, dtype, seed: int = 0):
    """The reference's ``init_params`` with every norm scale and bias
    replaced by seeded values (its own init makes them ones and zeros, which
    would hide a misplaced one)."""
    tree = ref_tf.init_params(cfg, jax.random.PRNGKey(seed), dtype)
    rng = np.random.default_rng(100 + seed)

    def vary(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        x = np.asarray(x)
        if "norm" in name:
            return (1.0 + 0.2 * rng.standard_normal(x.shape)).astype(x.dtype)
        if name in ("bq", "bk", "bv"):
            return (0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(vary, tree)


def ref_mesh_ctx() -> dict:
    """The mesh the reference's server builds on one device (1 × 1 over
    ``("data", "model")``, ``repro/launch/serve.py``), and its data axes: its
    ``moe_forward`` runs inside a ``shard_map`` and needs one."""
    mesh = ref_module("launch.mesh").make_mesh_for_devices(1)
    return dict(mesh=mesh, dp_axes=ref_module("distributed.sharding").dp_axes_of(mesh))


class Pair:
    """One reduced config's reference and port, the same weights (the
    reference on its one-device mesh for the moe family)."""

    def __init__(self, arch: str, jdtype=jnp.float32, tdtype=torch.float32, **replace):
        self.cfg_r = dataclasses.replace(ref_base.get_config(arch).reduced(), **replace)
        self.cfg = dataclasses.replace(port_base.get_config(arch).reduced(), **replace)
        self.tree = _ref_tree(self.cfg_r, jdtype)
        mesh = ref_mesh_ctx() if self.cfg.family == "moe" else {}
        self.ctx_r = ref_tf.ModelCtx(cfg=self.cfg_r, dtype=jdtype, remat=False, **mesh)
        self.ctx = port_tf.ModelCtx(cfg=self.cfg, dtype=tdtype, device="cpu")
        self.model = convert.params_from_reference(
            self.cfg, jax.tree.map(np.asarray, self.tree))
        self.prefill_r = jax.jit(ref_steps.make_prefill(self.ctx_r))
        self.decode_r = jax.jit(ref_steps.make_decode_step(self.ctx_r))

    def batch(self, B: int, S: int, seed: int, embeds: bool = False):
        """numpy batch: tokens or embeds, positions (3 distinct streams under
        M-RoPE when ``embeds``, else the text positions); an enc-dec config's
        also T = max(S // 4, 1) standard normal ``src_embeds`` (f32) at
        ``src_positions`` 0..T-1 (the reference server's source)."""
        rng = np.random.default_rng(seed)
        out = {}
        if embeds:
            out["embeds"] = (0.5 * rng.standard_normal((B, S, self.cfg.d_model))).astype(
                np.float32)
        else:
            out["tokens"] = rng.integers(0, self.cfg.vocab_size, (B, S)).astype(np.int32)
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        if self.cfg.mrope:
            pos = (np.stack([pos, pos // 2, pos % 5]) if embeds
                   else np.broadcast_to(pos[None], (3, B, S)))
        out["positions"] = np.ascontiguousarray(pos)
        if self.cfg.enc_dec:
            T = max(S // port_steps.SRC_FRACTION, 1)
            out["src_embeds"] = rng.standard_normal((B, T, self.cfg.d_model)).astype(np.float32)
            out["src_positions"] = np.ascontiguousarray(
                np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)))
        return out


_PAIRS: dict[str, Pair] = {}


@pytest.fixture
def pair():
    def get(arch: str) -> Pair:
        if arch not in _PAIRS:
            _PAIRS[arch] = Pair(arch)
        return _PAIRS[arch]
    return get


def _paired(cfg) -> tuple[str, str] | None:
    """The reference's two cache groups where it runs layers in pairs
    (gemma2's local/global, llama4's dense + MoE superlayers)."""
    if cfg.local_global:
        return "even", "odd"
    if cfg.family == "moe" and cfg.moe_every == 2:
        return "dense", "moe"
    return None


def ref_layer_cache(ref_caches, cfg, i: int) -> dict:
    """The reference's cache of the layer at execution position i."""
    groups = _paired(cfg)
    if groups:
        group = ref_caches[groups[i % 2]]
        return {k: v[i // 2] for k, v in group.items()}
    return {k: v[i] for k, v in ref_caches["attn"].items()}


def ref_layer_kv(ref_kvs, cfg, i: int):
    if _paired(cfg):
        k, v = ref_kvs[i % 2]
        return k[i // 2], v[i // 2]
    return ref_kvs[0][i], ref_kvs[1][i]


def assert_cache(got: dict, want: dict) -> None:
    assert_rel(got["k"], want["k"], F32_RTOL)
    assert_rel(got["v"], want["v"], F32_RTOL)
    np.testing.assert_array_equal(to_np(got["pos"]), to_np(want["pos"]))


def test_convert_is_bitwise_and_maps_execution_order(pair):
    """Every parameter of the port is the reference's array, bitwise, the
    stacked layer of its execution position (gemma2: 0, 1 → stacked 0, 1
    at L = 2); a missing or extra array raises."""
    p = pair("gemma2-2b")
    flat = {}
    for path, x in jax.tree_util.tree_flatten_with_path(p.tree)[0]:
        flat[".".join(str(getattr(k, "key", k)) for k in path)] = np.asarray(x)
    order = port_tf.execution_order(p.cfg)
    names = dict(p.model.named_parameters())
    assert {n.split(".", 2)[2] if n.startswith("layers.") else n for n in names} == {
        n.split(".", 1)[1] if n.startswith("layers.") else n for n in flat}
    for name, t in names.items():
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            want = flat[f"layers.{rest}"][order[int(i)]]
        else:
            want = flat[name]
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(to_np(t), want)
    tree = jax.tree.map(np.asarray, p.tree)
    with pytest.raises(ValueError, match="no place"):
        convert.params_from_reference(p.cfg, dict(tree, extra=np.zeros(3, np.float32)))
    with pytest.raises(ValueError, match="has no 'lm_head'"):
        cfg = dataclasses.replace(p.cfg, tie_embeddings=False)
        convert.params_from_reference(cfg, tree)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_convert_maps_the_ssd_blocks_bitwise(arch, pair):
    """An SSM or hybrid model through ``models.convert``: every parameter is
    the reference's array of its stacked layer, bitwise (``layers.ssm.*``,
    hymba's ``layers.fuse_norm_attn`` and ``layers.fuse_norm_ssm``), every
    array of the tree used; an ``A_log`` in another dtype raises."""
    p = pair(arch)
    flat = {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(p.tree)[0]}
    seen = set()
    for name, t in p.model.named_parameters():
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            src, want = f"layers.{rest}", flat[f"layers.{rest}"][int(i)]
        else:
            src, want = name, flat[name]
        seen.add(src)
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(to_np(t), want)
    assert seen == set(flat)
    assert any(n.startswith("layers.ssm.") for n in seen)
    assert ("layers.fuse_norm_ssm" in seen) == (arch == "hymba-1.5b")
    tree = jax.tree.map(np.asarray, p.tree)
    tree["layers"]["ssm"]["A_log"] = tree["layers"]["ssm"]["A_log"].astype(np.float64)
    with pytest.raises(ValueError, match="ssm.A_log"):
        convert.params_from_reference(p.cfg, tree)


@pytest.mark.parametrize("arch", SERVED + SSM_ARCHS)
def test_forward_logits_match_reference(arch, pair):
    p = pair(arch)
    b = p.batch(2, 12, 1)
    want, _ = ref_tf.forward(p.ctx_r, p.tree, {k: jx(v) for k, v in b.items()})
    with torch.inference_mode():
        got, _ = port_tf.forward(p.ctx, p.model, {k: tt(v) for k, v in b.items()})
        again = port_steps.make_forward(p.ctx)(p.model, {k: tt(v) for k, v in b.items()})
    assert got.shape == (2, 12, p.cfg.vocab_size) and got.dtype == torch.float32
    assert_rel(got, want, F32_RTOL)
    assert torch.equal(again, got)


def test_vlm_embeds_and_mrope_positions_match_reference(pair):
    """qwen2-vl's vision stub: ``"embeds"`` inputs and three distinct M-RoPE
    position streams, through ``forward`` and ``make_prefill``."""
    p = pair("qwen2-vl-7b")
    b = p.batch(2, 10, 2, embeds=True)
    assert b["positions"].shape == (3, 2, 10) and (b["positions"][0] != b["positions"][2]).any()
    want, _ = ref_tf.forward(p.ctx_r, p.tree, {k: jx(v) for k, v in b.items()})
    lw, kvw = p.prefill_r(p.tree, {k: jx(v) for k, v in b.items()})
    with torch.inference_mode():
        got, _ = port_tf.forward(p.ctx, p.model, {k: tt(v) for k, v in b.items()})
        lg, kvg = port_steps.make_prefill(p.ctx)(p.model, {k: tt(v) for k, v in b.items()})
    assert_rel(got, want, F32_RTOL)
    assert_rel(lg, lw, F32_RTOL)
    for i, (k, v) in enumerate(kvg):
        kr, vr = ref_layer_kv(kvw, p.cfg, i)
        assert_rel(k, kr, F32_RTOL)
        assert_rel(v, vr, F32_RTOL)


def test_gemma2_four_layers_run_in_the_reference_order():
    """At L = 4 the reference's local/global scan runs stacked layers 0, 2,
    1, 3 (at the reduced L = 2 that order is the plain one): the prefill's
    logits, and each layer's k/v and cache against the reference's even/odd
    caches."""
    p = Pair("gemma2-2b", n_layers=4)
    assert port_tf.execution_order(p.cfg) == [0, 2, 1, 3]
    b = p.batch(2, 12, 6)
    lw, kvw = p.prefill_r(p.tree, {k: jx(v) for k, v in b.items()})
    cw = ref_decode.caches_from_prefill(p.ctx_r, kvw, 16)
    with torch.inference_mode():
        lg, kvg = port_steps.make_prefill(p.ctx)(p.model, {k: tt(v) for k, v in b.items()})
        cg = port_decode.caches_from_prefill(p.ctx, kvg, 16)
    assert_rel(lg, lw, F32_RTOL)
    for i in range(4):
        kr, vr = ref_layer_kv(kvw, p.cfg, i)
        assert_rel(kvg[i][0], kr, F32_RTOL)
        assert_rel(kvg[i][1], vr, F32_RTOL)
        assert_cache(cg[i], ref_layer_cache(cw, p.cfg, i))


@pytest.mark.parametrize("arch", SERVED)
def test_prefill_kv_and_caches_match_reference(arch, pair):
    """``make_prefill``'s last-position logits and per-layer k/v, and
    ``caches_from_prefill``'s caches (k, v, pos); gemma2's local layers keep
    the last 8 of 12 positions in rolled slots."""
    p = pair(arch)
    b = p.batch(2, 12, 3)
    cache_len = 20
    lw, kvw = p.prefill_r(p.tree, {k: jx(v) for k, v in b.items()})
    cw = ref_decode.caches_from_prefill(p.ctx_r, kvw, cache_len)
    with torch.inference_mode():
        lg, kvg = port_steps.make_prefill(p.ctx)(p.model, {k: tt(v) for k, v in b.items()})
        cg = port_decode.caches_from_prefill(p.ctx, kvg, cache_len)
    assert lg.shape == (2, 1, p.cfg.vocab_size)
    assert_rel(lg, lw, F32_RTOL)
    assert len(kvg) == len(cg) == p.cfg.n_layers
    for i in range(p.cfg.n_layers):
        kr, vr = ref_layer_kv(kvw, p.cfg, i)
        assert_rel(kvg[i][0], kr, F32_RTOL)
        assert_rel(kvg[i][1], vr, F32_RTOL)
        assert_cache(cg[i], ref_layer_cache(cw, p.cfg, i))
    if p.cfg.local_global:
        assert cg[0]["k"].shape[1] == 8 and cg[1]["k"].shape[1] == cache_len


@pytest.mark.parametrize("arch", SERVED)
def test_decode_steps_match_reference(arch, pair):
    """Four greedy ``decode_step``s from the prefill caches: each step's
    logits and every layer's cache (k, v, pos) after it.  Both sides are fed
    the reference's argmax, so they decode the same tokens."""
    p = pair(arch)
    B, S, cache_len = 2, 12, 16
    b = p.batch(B, S, 4)
    lw, kvw = p.prefill_r(p.tree, {k: jx(v) for k, v in b.items()})
    cw = ref_decode.caches_from_prefill(p.ctx_r, kvw, cache_len)
    dstep = port_steps.make_decode_step(p.ctx)
    with torch.inference_mode():
        _, kvg = port_steps.make_prefill(p.ctx)(p.model, {k: tt(v) for k, v in b.items()})
        cg = port_decode.caches_from_prefill(p.ctx, kvg, cache_len)
        tok = np.asarray(jnp.argmax(lw[:, -1], axis=-1)).astype(np.int32)[:, None]
        for step in range(4):
            lw, cw = p.decode_r(p.tree, jx(tok), jnp.array(S + step, jnp.int32), cw)
            lg, cg = dstep(p.model, tt(tok).long(), S + step, cg)
            assert lg.shape == (B, 1, p.cfg.vocab_size)
            assert_rel(lg, lw, F32_RTOL)
            for i in range(p.cfg.n_layers):
                assert_cache(cg[i], ref_layer_cache(cw, p.cfg, i))
            tok = np.asarray(jnp.argmax(lw[:, -1], axis=-1)).astype(np.int32)[:, None]


# =============================================================================
# Pieces the reference computes in f64 end to end (last: the module-scoped
# x64 fixture stays on for the rest of the module once taken)
# =============================================================================

def test_softcap_matches_reference_f64(x64):
    x = np.linspace(-1000, 1000, 101)
    y = port_common.softcap(tt(x), 50.0)
    assert float(y.abs().max()) <= 50.0
    assert_rel(y, ref_common.softcap(jx(x), 50.0), F64_RTOL)
    assert torch.equal(port_common.softcap(tt(x), 0.0), tt(x))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_reference_f64(act, x64):
    """SwiGLU and GeGLU (``jax.nn.gelu``'s tanh approximation) in f64."""
    cfg_p = dataclasses.replace(port_base.get_config("internlm2-1.8b").reduced(), act=act)
    cfg_r = dataclasses.replace(ref_base.get_config("internlm2-1.8b").reduced(), act=act)
    d, ff = 64, 128
    w_in, w_out = seeded((d, 2 * ff), 8) * d ** -0.5, seeded((ff, d), 9) * ff ** -0.5
    x = seeded((2, 5, d), 10)
    mlp = port_mlp.GatedMLP(cfg_p, d, ff, dtype=torch.float64, device="cpu")
    with torch.no_grad():
        mlp.w_in.copy_(tt(w_in))
        mlp.w_out.copy_(tt(w_out))
        got = mlp(tt(x))
    want = ref_mlp.mlp_forward({"w_in": jx(w_in), "w_out": jx(w_out)}, cfg_r, jx(x))
    assert_rel(got, want, F64_RTOL)
    if act == "gelu":       # torch's default (exact) gelu would not be the reference's
        exact = (torch.nn.functional.gelu(tt(x) @ tt(w_in)[:, :ff]) * (tt(x) @ tt(w_in)[:, ff:])
                 ) @ tt(w_out)
        assert float((exact - got).abs().max()) > 1e3 * F64_RTOL * float(got.abs().max())
