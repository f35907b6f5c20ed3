"""The port's SSD blocks (``repro_torch.models.ssm``) and the two models
that hold them (mamba2-780m, an SSD block a layer and nothing else;
hymba-1.5b, sliding-window attention and an SSD block on the same normed
input, then the MLP) against the JAX reference on the CPU.

Inputs are made with numpy from a seed; the reference's weights reach the
port copied array by array (a lone block) or through ``models.convert`` (a
whole model), with the conv biases, ``D`` and the norm scales drawn from a
seed (the reference's init makes them zeros and ones, which would hide a
misplaced one).  Tolerances, relative to the largest magnitude of the
reference's array: 1e-5 (``F32_RTOL``) for f32 blocks and models, and for
f64 blocks too: every SSD internal is f32 on both sides whatever the model's
dtype, and XLA's and PyTorch's f32 ``exp`` and ``softplus`` differ in the
last bit on some inputs.  The f64 models are held token for token
(``tests/test_torch_lm_serve.py``).
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
from test_torch_models import F32_RTOL, SSM_ARCHS, assert_rel, jx, tt
from test_torch_models import one_thread, pair  # noqa: F401  (fixtures)

from repro_torch.configs.base import get_config
from repro_torch.models import decode as port_decode
from repro_torch.models import ssm
from repro_torch.models import steps as port_steps
from repro_torch.models import transformer as port_tf

ref_base = ref_module("configs.base")
ref_ssm = ref_module("models.ssm")
ref_tf = ref_module("models.transformer")
ref_decode = ref_module("models.decode")

HYMBA, MAMBA2 = SSM_ARCHS


def _cfgs(arch: str = MAMBA2):
    return get_config(arch).reduced(), ref_base.get_config(arch).reduced()


def _ref_params(cfg_r, dtype=jnp.float32, seed: int = 0) -> dict[str, np.ndarray]:
    """The reference's ``init_ssm_params`` with the conv biases, ``D`` and
    the norm scale drawn from a seed."""
    p = {k: np.asarray(v) for k, v in
         ref_ssm.init_ssm_params(jax.random.PRNGKey(seed), cfg_r, dtype).items()}
    rng = np.random.default_rng(200 + seed)
    for name in ("conv_bx", "conv_bB", "conv_bC"):
        p[name] = (0.1 * rng.standard_normal(p[name].shape)).astype(p[name].dtype)
    for name in ("D", "norm"):
        p[name] = (1.0 + 0.2 * rng.standard_normal(p[name].shape)).astype(p[name].dtype)
    return p


def _port(cfg, params: dict[str, np.ndarray], dtype=torch.float32) -> ssm.SSM:
    """The port's block holding ``params``, every array copied bitwise."""
    block = ssm.SSM(cfg, dtype=dtype, device="cpu")
    names = dict(block.named_parameters())
    assert set(names) == set(params)
    with torch.no_grad():
        for name, t in names.items():
            src = tt(params[name])
            assert src.dtype == t.dtype and src.shape == t.shape, name
            t.copy_(src)
    return block


def _ref_forward(cfg_r, params, x, return_cache: bool):
    fn = jax.jit(lambda q, y: ref_ssm.ssm_forward(q, cfg_r, y, return_cache=return_cache))
    return fn({k: jx(v) for k, v in params.items()}, jx(x))


def _seeded_cache(cfg, B: int, seed: int, dtype=np.float32) -> dict[str, np.ndarray]:
    di, N, nH, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.conv_kernel
    return {"conv": seeded((B, K - 1, di + 2 * N), seed, dtype),
            "state": 0.5 * seeded((B, nH, cfg.ssm_head_dim, N), seed + 1, np.float32)}


def _copy(cache: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Fresh tensors: the port's decode writes its cache in place."""
    return {k: tt(v.copy()) for k, v in cache.items()}


# =============================================================================
# The block
# =============================================================================

@pytest.mark.parametrize("return_cache", [False, True], ids=["out", "cache"])
@pytest.mark.parametrize("S, Q", [(48, 16), (24, 12), (2, 2)],
                         ids=["three-chunks", "fallback", "short"])
def test_ssm_forward_matches_reference(S, Q, return_cache):
    """S = 48: three chunks of 16 with the carry between them; S = 24: the
    chunk falls back to 12 (no padding); S = 2 < K - 1: the cache's conv
    tail starts with a zero row.  With ``return_cache``, the raw conv tail
    and the final state too."""
    cfg, cfg_r = _cfgs()
    assert ssm.chunk_size(cfg, S) == Q
    params = _ref_params(cfg_r)
    x = 0.5 * seeded((2, S, cfg.d_model), 3, np.float32)
    want = _ref_forward(cfg_r, params, x, return_cache)
    with torch.inference_mode():
        got = ssm.ssm_forward(_port(cfg, params), cfg, tt(x), return_cache=return_cache)
    if not return_cache:
        assert got.shape == x.shape and got.dtype == torch.float32
        assert_rel(got, want, F32_RTOL)
        return
    (out, cache), (out_r, cache_r) = got, want
    assert_rel(out, out_r, F32_RTOL)
    assert cache["conv"].shape == (2, cfg.conv_kernel - 1, cfg.d_inner + 2 * cfg.ssm_state)
    assert cache["state"].dtype == torch.float32
    assert_rel(cache["conv"], cache_r["conv"], F32_RTOL)
    assert_rel(cache["state"], cache_r["state"], F32_RTOL)
    if S < cfg.conv_kernel - 1:
        assert not cache["conv"][:, : cfg.conv_kernel - 1 - S].any()


def test_ssm_forward_discards_the_overflowing_upper_triangle():
    """At the reference's init A reaches -nH, and a chunk of 128 steps with
    dt near its 0.1 ceiling spans cum differences past f32's exp range
    above the diagonal; the output stays finite (the exponent is masked
    there before ``exp``, and the product after it by ``torch.where``: a
    0/1 mask would make inf · 0 = NaN)."""
    cfg = dataclasses.replace(get_config(MAMBA2).reduced(), ssm_chunk=128)
    block = ssm.init_ssm_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    with torch.no_grad():
        block.dt_bias.fill_(2.0)                       # softplus(2 + dt) ~ 2: big steps
    x = torch.from_numpy(seeded((1, 128, cfg.d_model), 4, np.float32))
    with torch.inference_mode():
        dt = torch.nn.functional.softplus((x @ block.w_dt).float() + block.dt_bias)
        cum = torch.cumsum(dt * -torch.exp(block.A_log), dim=1)
        assert float((cum[0, 0] - cum[0, -1]).max()) > 89.0   # exp overflows f32 past 88.7
        out, cache = ssm.ssm_forward(block, cfg, x, return_cache=True)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(cache["state"]).all())


@pytest.mark.parametrize("B", [1, 3])
def test_ssm_decode_matches_reference(B):
    """Three steps from a seeded cache: each step's output, and the conv
    window and state after it; the port writes the cache in place and
    returns the same dict."""
    cfg, cfg_r = _cfgs()
    params = _ref_params(cfg_r, seed=1)
    block = _port(cfg, params)
    cache_np = _seeded_cache(cfg, B, 5)
    got_cache = _copy(cache_np)
    want_cache = {k: jx(v) for k, v in cache_np.items()}
    dec = jax.jit(lambda q, y, c: ref_ssm.ssm_decode(q, cfg_r, y, c))
    pj = {k: jx(v) for k, v in params.items()}
    for step in range(3):
        x = 0.5 * seeded((B, 1, cfg.d_model), 10 + step, np.float32)
        want, want_cache = dec(pj, jx(x), want_cache)
        with torch.inference_mode():
            got, returned = ssm.ssm_decode(block, cfg, tt(x), got_cache)
        assert returned is got_cache and got.shape == (B, 1, cfg.d_model)
        assert_rel(got, want, F32_RTOL)
        assert_rel(got_cache["conv"], want_cache["conv"], F32_RTOL)
        assert_rel(got_cache["state"], want_cache["state"], F32_RTOL)


@pytest.mark.parametrize("S", [48, 24, 2])
def test_replayed_state_equals_return_cache(S):
    """S tokens one by one through ``ssm_decode`` from ``init_ssm_cache``:
    each step's output is the chunked forward's at that position, and the
    cache after the last is ``return_cache``'s (the port's and the
    reference's): the chunked scan held against the recurrence."""
    cfg, cfg_r = _cfgs()
    params = _ref_params(cfg_r, seed=2)
    block = _port(cfg, params)
    x = 0.5 * seeded((2, S, cfg.d_model), 6, np.float32)
    _, cache_r = _ref_forward(cfg_r, params, x, True)
    cache = ssm.init_ssm_cache(cfg, 2, torch.float32, "cpu")
    with torch.inference_mode():
        full, cache_f = ssm.ssm_forward(block, cfg, tt(x), return_cache=True)
        outs = [ssm.ssm_decode(block, cfg, tt(x[:, i:i + 1]), cache)[0] for i in range(S)]
    assert_rel(torch.cat(outs, dim=1), full, F32_RTOL)
    for name in ("conv", "state"):
        assert_rel(cache[name], cache_f[name], F32_RTOL)
        assert_rel(cache[name], cache_r[name], F32_RTOL)


def test_init_ssm_params_draws_the_reference_distributions():
    """``A_log = log(1..nH)`` and ``D = 1`` exactly, f32 in a bf16 block;
    softplus(``dt_bias``) inside [1e-3, 0.1] (its inverse), log-uniform;
    the weights ``N(0, 1/d)``, ``N(0, 1/K)`` and ``N(0, 1/di)``, cast to
    the block's dtype (sample moments within five standard errors); the
    same seed draws the same block, and one without a generator is zeros."""
    cfg = dataclasses.replace(get_config(MAMBA2).reduced(), d_model=256, ssm_head_dim=8)
    d, di, nH, K = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.conv_kernel
    a = ssm.init_ssm_params(cfg, torch.Generator().manual_seed(5), torch.bfloat16)
    b = ssm.init_ssm_params(cfg, torch.Generator().manual_seed(5), torch.bfloat16)
    for (name, t), u in zip(a.named_parameters(), b.parameters(), strict=True):
        assert torch.equal(t, u), name
        assert t.dtype == (torch.float32 if name in ("A_log", "D", "dt_bias")
                           else torch.bfloat16), name
    assert torch.equal(a.A_log, torch.log(torch.arange(1, nH + 1, dtype=torch.float32)))
    assert torch.equal(a.D, torch.ones(nH))
    dt = torch.nn.functional.softplus(a.dt_bias)
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 0.1 * (1 + 1e-5)
    assert abs(float(torch.log(dt).mean()) - np.log(1e-2)) < 5 * np.log(100) / np.sqrt(12 * nH)
    for name, std in (("w_z", d ** -0.5), ("w_x", d ** -0.5), ("w_B", d ** -0.5),
                      ("w_dt", d ** -0.5), ("conv_x", K ** -0.5), ("out_proj", di ** -0.5)):
        w = getattr(a, name).double()
        n = w.numel()
        assert abs(float(w.mean())) < 5 * std / np.sqrt(n), name
        assert abs(float(w.std()) / std - 1) < 5 / np.sqrt(2 * n) + 2.0 ** -8, name
    assert not a.conv_bx.any() and torch.equal(a.norm, torch.ones(di, dtype=torch.bfloat16))
    zeros = ssm.SSM(cfg, dtype=torch.float32, device="cpu")
    assert not zeros.w_x.any() and not zeros.dt_bias.any()
    assert torch.equal(zeros.A_log, a.A_log)


# =============================================================================
# The layers and the models
# =============================================================================

def _ref_leaves(cfg_r, dtype) -> dict[str, tuple[tuple[int, ...], str]]:
    tree = jax.eval_shape(lambda: ref_tf.init_params(cfg_r, jax.random.PRNGKey(0), dtype))
    return {".".join(str(getattr(k, "key", k)) for k in path): (tuple(x.shape), x.dtype.name)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("width", ["reduced", "full"])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_layer_parameters_are_the_references(arch, width):
    """Every layer's parameter names, shapes and dtypes against the
    reference's stacked tree (f32 reduced; bf16 at full width on the meta
    device, where mamba2 has no attention heads at all): an SSM layer holds
    ``norm_attn`` and ``ssm`` and nothing else, a hybrid layer a dense
    layer's modules plus ``ssm`` and the two fusion norms; ``A_log``, ``D``
    and ``dt_bias`` are f32 in a bf16 model."""
    full = width == "full"
    cfg, cfg_r = get_config(arch), ref_base.get_config(arch)
    if not full:
        cfg, cfg_r = cfg.reduced(), cfg_r.reduced()
    dtype, jdtype = (torch.bfloat16, jnp.bfloat16) if full else (torch.float32, jnp.float32)
    assert port_tf.layer_kind(cfg) == ref_tf.layer_kind(cfg_r) == cfg.family
    want = _ref_leaves(cfg_r, jdtype)
    model = port_tf.Transformer(cfg, dtype=dtype, device="meta" if full else "cpu")
    L = cfg.n_layers
    got = {}
    for name, t in model.named_parameters():
        dt = str(t.dtype).removeprefix("torch.")
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            got.setdefault(f"layers.{rest}", []).append((int(i), tuple(t.shape), dt))
        else:
            got[name] = (tuple(t.shape), dt)
    for name, rows in list(got.items()):
        if name.startswith("layers."):
            assert [i for i, _, _ in rows] == list(range(L)), name
            assert len({(s, d) for _, s, d in rows}) == 1, name
            got[name] = ((L, *rows[0][1]), rows[0][2])
    assert got == want
    layer = {n.split(".", 1)[0] for n, _ in model.layers[0].named_parameters()}
    if arch == MAMBA2:
        assert layer == {"norm_attn", "ssm"} and cfg.n_heads == (4 if not full else 0)
    else:
        assert layer == {"norm_attn", "attn", "ssm", "fuse_norm_attn", "fuse_norm_ssm",
                         "norm_mlp", "mlp"}
    for n in ("A_log", "D", "dt_bias"):
        assert want[f"layers.ssm.{n}"][1] == "float32"


def _ref_layer_ssm(ref_caches, i: int) -> dict:
    return {k: v[i] for k, v in ref_caches["ssm"].items()}


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_decode_steps_from_init_caches_match_reference(arch, pair):
    """The reference server's replay: 12 prompt tokens, then 4 greedy
    tokens, each a ``decode_step`` from ``init_caches`` (cache length 16,
    so hymba's 8-slot windows wrap): every step's logits, and after the
    last every layer's SSM cache (conv, state) and hybrid attention cache
    (k, v, pos).  Both sides are fed the reference's tokens."""
    p = pair(arch)
    B, P, cache_len = 2, 12, 16
    toks = p.batch(B, P, 7)["tokens"]
    cw = ref_decode.init_caches(p.ctx_r, B, cache_len)
    cg = port_decode.init_caches(p.ctx, B, cache_len)
    assert len(cg) == p.cfg.n_layers
    dstep = port_steps.make_decode_step(p.ctx)
    tok = toks[:, :1]
    with torch.inference_mode():
        for pos in range(P + 4):
            if pos < P:
                tok = toks[:, pos:pos + 1]
            lw, cw = p.decode_r(p.tree, jx(tok), jnp.array(pos, jnp.int32), cw)
            lg, cg = dstep(p.model, tt(tok).long(), pos, cg)
            assert lg.shape == (B, 1, p.cfg.vocab_size)
            assert_rel(lg, lw, F32_RTOL)
            tok = np.asarray(jnp.argmax(lw[:, -1], axis=-1)).astype(np.int32)[:, None]
    for i, c in enumerate(cg):
        want = _ref_layer_ssm(cw, i)
        assert_rel(c["ssm"]["conv"], want["conv"], F32_RTOL)
        assert_rel(c["ssm"]["state"], want["state"], F32_RTOL)
        if arch == HYMBA:
            assert c["k"].shape[1] == p.cfg.sliding_window == 8
            assert_rel(c["k"], cw["attn"]["k"][i], F32_RTOL)
            assert_rel(c["v"], cw["attn"]["v"][i], F32_RTOL)
            np.testing.assert_array_equal(to_np(c["pos"]), to_np(cw["attn"]["pos"][i]))
        else:
            assert set(c) == {"ssm"}


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_prefill_has_no_cache_path(arch, pair):
    """``make_prefill`` runs (its logits the reference's; an SSM layer's k/v
    are None) but ``caches_from_prefill`` raises, naming the replay."""
    p = pair(arch)
    b = p.batch(2, 12, 8)
    lw, _ = p.prefill_r(p.tree, {k: jx(v) for k, v in b.items()})
    with torch.inference_mode():
        lg, kvs = port_steps.make_prefill(p.ctx)(p.model, {k: tt(v) for k, v in b.items()})
    assert_rel(lg, lw, F32_RTOL)
    assert len(kvs) == p.cfg.n_layers
    assert all((kv is None) == (arch == MAMBA2) for kv in kvs)
    with pytest.raises(NotImplementedError, match="replaying the prompt"):
        port_decode.caches_from_prefill(p.ctx, kvs, 16)


# =============================================================================
# f64 blocks (last: x64 stays on for the rest of the module once taken)
# =============================================================================

def test_ssm_forward_f64_matches_reference(x64):
    """An f64 block: the projections, conv and norm in f64, the SSD
    internals in f32 on both sides, the output cast back to f64; with the
    chunk fallback (S = 24) and ``return_cache``."""
    cfg, cfg_r = _cfgs()
    params = _ref_params(cfg_r, jnp.float64, seed=3)
    assert params["A_log"].dtype == np.float32 and params["w_x"].dtype == np.float64
    x = 0.5 * seeded((2, 24, cfg.d_model), 9)
    out_r, cache_r = _ref_forward(cfg_r, params, x, True)
    with torch.inference_mode():
        out, cache = ssm.ssm_forward(_port(cfg, params, torch.float64), cfg, tt(x),
                                     return_cache=True)
    assert out.dtype == torch.float64 and cache["conv"].dtype == torch.float64
    assert cache["state"].dtype == torch.float32
    assert_rel(out, out_r, F32_RTOL)
    assert_rel(cache["conv"], cache_r["conv"], F32_RTOL)
    assert_rel(cache["state"], cache_r["state"], F32_RTOL)


def test_ssm_decode_f64_matches_reference(x64):
    """An f64 step from a seeded cache: decode's K-window conv in f32 on
    both sides, the state f32, the output f64."""
    cfg, cfg_r = _cfgs()
    params = _ref_params(cfg_r, jnp.float64, seed=4)
    cache_np = _seeded_cache(cfg, 2, 11, np.float64)
    x = 0.5 * seeded((2, 1, cfg.d_model), 12)
    want, want_cache = ref_ssm.ssm_decode({k: jx(v) for k, v in params.items()}, cfg_r, jx(x),
                                          {k: jx(v) for k, v in cache_np.items()})
    cache = _copy(cache_np)
    with torch.inference_mode():
        got, _ = ssm.ssm_decode(_port(cfg, params, torch.float64), cfg, tt(x), cache)
    assert got.dtype == torch.float64 and cache["state"].dtype == torch.float32
    assert_rel(got, want, F32_RTOL)
    assert_rel(cache["conv"], want_cache["conv"], F32_RTOL)
    assert_rel(cache["state"], want_cache["state"], F32_RTOL)
