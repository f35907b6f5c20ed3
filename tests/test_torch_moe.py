"""The port's MoE layers (``repro_torch.models.moe``) and the two MoE models
(qwen3-moe-235b-a22b, an MoE layer every layer; llama4-maverick-400b-a17b,
dense and MoE superlayers with a shared expert) against the JAX reference on
the CPU.

The reference's ``moe_forward`` runs in a ``shard_map`` and gets the mesh its
own server builds on one device (1 × 1 over ``("data", "model")``); the
port's runs on one device with no mesh.  Inputs are made with numpy from a
seed, the weights reach the port through ``models.convert``.  Tolerances,
relative to the largest magnitude of the reference's array: 1e-5 in f32
(``F32_RTOL``); in an f64 model the router, its softmax and the routing
weights stay f32 on both sides (XLA's and PyTorch's f32 ``exp`` differ in the
last bit on some inputs), so the f64 layer is held within 1e-10 given the
same routing and the f64 models token for token
(``tests/test_torch_lm_serve.py``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_harness import ref_module, to_np
from test_torch_harness import x64  # noqa: F401  (fixture)
from test_torch_models import (F32_RTOL, F64_RTOL, MOE_ARCHS, Pair, assert_cache, assert_rel,
                               jx, ref_layer_cache, ref_layer_kv, ref_mesh_ctx, tt)
from test_torch_models import one_thread, pair  # noqa: F401  (fixtures)

from repro_torch.configs.base import get_config
from repro_torch.models import convert, moe
from repro_torch.models import decode as port_decode
from repro_torch.models import steps as port_steps
from repro_torch.models import transformer as port_tf

ref_base = ref_module("configs.base")
ref_moe = ref_module("models.moe")
ref_tf = ref_module("models.transformer")
ref_decode = ref_module("models.decode")

LLAMA4, QWEN3 = MOE_ARCHS


def _flat(tree) -> dict[str, np.ndarray]:
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _moe_layer(p: Pair, i: int):
    """The reference's MoE parameters of execution position i, and the
    port's MoE module there."""
    assert p.model.layers[i].kind == "moe"
    prefix, j = port_tf.stacked_sources(p.cfg)[i]
    stack = p.tree["layers"]["moe"] if prefix == "layers.moe." else p.tree["layers"]
    return jax.tree.map(lambda a: a[j], stack["moe"]), p.model.layers[i].moe


def _ref_moe(cfg_r, params, x):
    m = ref_mesh_ctx()
    fn = jax.jit(lambda q, y: ref_moe.moe_forward(q, cfg_r, y, m["mesh"], m["dp_axes"], "model"))
    return fn(params, jx(x))


def _x(T: int, d: int, seed: int, dtype=np.float32) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((1, T, d)).astype(dtype)


def _numpy_dropped(idx: np.ndarray, C: int) -> np.ndarray:
    """(T, k): an assignment is dropped where C earlier assignments, in the
    flat token-major order, went to its expert."""
    flat = idx.reshape(-1)
    before = np.array([np.sum(flat[:i] == e) for i, e in enumerate(flat)])
    return (before >= C).reshape(idx.shape)


# =============================================================================
# Layer kinds, execution order, parameters
# =============================================================================

@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_layer_kinds_follow_the_reference_schedule(arch, reduced):
    """Both MoE configs are ``"moe"``; qwen3 runs an MoE layer at every
    position, llama4 dense j then MoE j (the reference's
    ``_scan_superlayers``), each stack indexed by j."""
    cfg = get_config(arch).reduced() if reduced else get_config(arch)
    L = cfg.n_layers
    assert port_tf.layer_kind(cfg) == ref_tf.layer_kind(cfg) == "moe"
    kinds, sources = port_tf.layer_kinds(cfg), port_tf.stacked_sources(cfg)
    if arch == LLAMA4:
        assert kinds == ["dense", "moe"] * (L // 2)
        assert sources == [(f"layers.{k}.", i // 2) for i, k in enumerate(kinds)]
        with pytest.raises(ValueError, match="even n_layers"):
            port_tf.layer_kinds(dataclasses.replace(cfg, n_layers=3))
    else:
        assert kinds == ["moe"] * L and sources == [("layers.", i) for i in range(L)]
    assert port_tf._window_flags(cfg) == [0] * L


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_model_holds_the_analytic_parameter_count(arch):
    """``param_count()`` plus the final norm and qwen3's q/k norms, which
    the analytic count leaves out; the router is f32 in a bf16 model."""
    cfg = get_config(arch).reduced()
    model = port_tf.Transformer(cfg, dtype=torch.bfloat16, device="cpu")
    extra = cfg.d_model + (2 * cfg.hd * cfg.n_layers if cfg.qk_norm else 0)
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count() + extra
    for name, p in model.named_parameters():
        assert p.dtype == (torch.float32 if name.endswith("moe.router") else torch.bfloat16)


def test_init_moe_params_draws_the_reference_distributions():
    """The router ``N(0, 1/d)`` in f32, each expert's ``w_in`` ``N(0, 1/d)``
    and ``w_out`` ``N(0, 1/f)`` drawn apart, cast to the model's dtype; the
    same seed draws the same weights (sample moments within five standard
    errors)."""
    cfg = dataclasses.replace(get_config(LLAMA4).reduced(), d_model=256, d_ff=512)
    a = moe.init_moe_params(cfg, torch.Generator().manual_seed(5), torch.bfloat16)
    b = moe.init_moe_params(cfg, torch.Generator().manual_seed(5), torch.bfloat16)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters(), strict=True))
    assert a.router.dtype == torch.float32 and a.w_in.dtype == torch.bfloat16
    assert a.w_in.shape == (8, 256, 1024) and a.w_out.shape == (8, 512, 256)
    for t, std in ((a.router, 256 ** -0.5), (a.w_in, 256 ** -0.5), (a.w_out, 512 ** -0.5),
                   (a.shared_in, 256 ** -0.5), (a.shared_out, 512 ** -0.5)):
        n, t = t.numel(), t.detach().float()     # five standard errors
        assert abs(float(t.std()) / std - 1) < 5 / (2 * n) ** 0.5
        assert abs(float(t.mean())) < 5 * std / n ** 0.5
    assert not torch.equal(a.w_in[0], a.w_in[1])


# =============================================================================
# moe_forward against the reference's
# =============================================================================

#: T·k one below, at and one above the switch min(64, E - 1) = 7 (reduced E = 8)
SWITCH_CASES = [(QWEN3, 3, "gather"), (QWEN3, 4, "dispatch"), (LLAMA4, 6, "gather"),
                (LLAMA4, 7, "gather"), (LLAMA4, 8, "dispatch")]


@pytest.mark.parametrize("arch,T,path", SWITCH_CASES)
def test_moe_forward_matches_reference_at_the_switch(arch, T, path, pair):
    """Out and ``aux`` within 1e-5 on each side of the gather/dispatch
    switch (qwen3 k = 2; llama4 k = 1 with its shared expert)."""
    p = pair(arch)
    i = port_tf.layer_kinds(p.cfg).index("moe")
    params, layer = _moe_layer(p, i)
    x = _x(T, p.cfg.d_model, T)
    want, aux_w = _ref_moe(p.cfg_r, params, x)
    stats = {}
    with torch.inference_mode():
        got, aux = moe.moe_forward(layer, p.cfg, tt(x), stats=stats)
    assert stats["path"] == path and moe.takes_gather_path(T, p.cfg) == (path == "gather")
    assert not bool(stats["dropped"].any())
    assert got.shape == (1, T, p.cfg.d_model) and got.dtype == torch.float32
    assert_rel(got, want, F32_RTOL)
    assert aux.dtype == torch.float32 and aux.dim() == 0
    assert_rel(aux, aux_w, F32_RTOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_drops_as_the_reference_does(arch, pair):
    """``capacity_factor`` cut to 0.25: C = 8 for 64 tokens, so experts
    overflow and assignments are dropped (more than none), the later ones in
    flat order; the output with those drops is the reference's."""
    base = pair(arch)
    cfg_p = dataclasses.replace(base.cfg, capacity_factor=0.25)
    cfg_r = dataclasses.replace(base.cfg_r, capacity_factor=0.25)
    i = port_tf.layer_kinds(base.cfg).index("moe")
    params, layer = _moe_layer(base, i)
    T = 64
    x = _x(T, cfg_p.d_model, 11)
    want, aux_w = _ref_moe(cfg_r, params, x)
    stats = {}
    with torch.inference_mode():
        got, aux = moe.moe_forward(layer, cfg_p, tt(x), stats=stats)
        _, _, idx = moe.route(layer, cfg_p, tt(x[0]))
    C = moe.capacity(T, cfg_p)
    assert stats["path"] == "dispatch" and stats["capacity"] == C == 8
    dropped = to_np(stats["dropped"])
    assert dropped.sum() > 0
    np.testing.assert_array_equal(dropped, _numpy_dropped(to_np(idx), C))
    assert_rel(got, want, F32_RTOL)
    assert_rel(aux, aux_w, F32_RTOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_repeats_bitwise(arch, pair):
    """Both paths combine a token's contributions in a fixed order: a second
    call repeats the first bit for bit."""
    p = pair(arch)
    _, layer = _moe_layer(p, port_tf.layer_kinds(p.cfg).index("moe"))
    for T in (3, 40):
        x = tt(_x(T, p.cfg.d_model, 20 + T))
        with torch.inference_mode():
            a, aux_a = moe.moe_forward(layer, p.cfg, x)
            b, aux_b = moe.moe_forward(layer, p.cfg, x)
        assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


# =============================================================================
# Whole models through models.convert
# =============================================================================

def test_convert_maps_llama4_superlayers_bitwise():
    """At L = 4 the reference stacks two dense and two MoE layers apart:
    position 2j is ``layers.dense.*[j]``, 2j + 1 ``layers.moe.*[j]``, every
    array bitwise, the router f32; a stack of the wrong depth or a router in
    another dtype raises."""
    p = Pair(LLAMA4, n_layers=4)
    flat = _flat(p.tree)
    names = dict(p.model.named_parameters())
    seen = set()
    for name, t in names.items():
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            group = "dense" if int(i) % 2 == 0 else "moe"
            src = f"layers.{group}.{rest}"
            want = flat[src][int(i) // 2]
        else:
            src, want = name, flat[name]
        seen.add(src)
        np.testing.assert_array_equal(to_np(t), want)
        assert t.dtype == torch.float32
    assert seen == set(flat)
    assert [type(getattr(p.model.layers[i], "moe", None)).__name__ for i in range(4)] == [
        "NoneType", "MoE", "NoneType", "MoE"]
    tree = jax.tree.map(np.asarray, p.tree)
    with pytest.raises(ValueError, match="2 stacked layers, the config has 3"):
        convert.params_from_reference(dataclasses.replace(p.cfg, n_layers=6), tree)
    bad = jax.tree.map(lambda a: a, tree)
    bad["layers"]["moe"]["moe"]["router"] = bad["layers"]["moe"]["moe"]["router"].astype(
        np.float64)
    with pytest.raises(ValueError, match="moe.router"):
        convert.params_from_reference(p.cfg, bad)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_logits_and_aux_match_reference(arch, pair):
    """The full forward's logits and ``extras["aux"]`` (the MoE layers'
    losses summed); the prefill of 24 tokens takes the dispatch path."""
    p = pair(arch)
    b = p.batch(2, 12, 1)
    want, ex_w = ref_tf.forward(p.ctx_r, p.tree, {k: jx(v) for k, v in b.items()})
    with torch.inference_mode():
        got, ex = port_tf.forward(p.ctx, p.model, {k: tt(v) for k, v in b.items()})
    assert got.shape == (2, 12, p.cfg.vocab_size) and got.dtype == torch.float32
    assert not moe.takes_gather_path(24, p.cfg)
    assert_rel(got, want, F32_RTOL)
    assert_rel(ex["aux"], ex_w["aux"], F32_RTOL)


def test_dense_models_carry_a_zero_aux(pair):
    p = pair("internlm2-1.8b")
    with torch.inference_mode():
        _, ex = port_tf.forward(p.ctx, p.model, {k: tt(v) for k, v in p.batch(1, 4, 0).items()})
    assert ex["aux"] == 0.0


def test_llama4_four_layers_run_in_the_reference_order():
    """Two superlayers: the prefill's logits, each position's k/v against
    the reference's dense/moe stacks and its caches."""
    p = Pair(LLAMA4, n_layers=4)
    assert port_tf.layer_kinds(p.cfg) == ["dense", "moe", "dense", "moe"]
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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_kv_and_caches_match_reference(arch, pair):
    """``make_prefill``'s last-position logits and per-layer k/v, and
    ``caches_from_prefill``'s caches (k, v, pos), llama4's from the
    reference's ``"dense"``/``"moe"`` stacks."""
    p = pair(arch)
    b = p.batch(2, 12, 3)
    lw, kvw = p.prefill_r(p.tree, {k: jx(v) for k, v in b.items()})
    cw = ref_decode.caches_from_prefill(p.ctx_r, kvw, 20)
    if arch == LLAMA4:
        assert set(cw) == {"dense", "moe"}
    with torch.inference_mode():
        lg, kvg = port_steps.make_prefill(p.ctx)(p.model, {k: tt(v) for k, v in b.items()})
        cg = port_decode.caches_from_prefill(p.ctx, kvg, 20)
    assert lg.shape == (2, 1, p.cfg.vocab_size)
    assert_rel(lg, lw, F32_RTOL)
    assert len(kvg) == len(cg) == p.cfg.n_layers
    for i in range(p.cfg.n_layers):
        kr, vr = ref_layer_kv(kvw, p.cfg, i)
        assert_rel(kvg[i][0], kr, F32_RTOL)
        assert_rel(kvg[i][1], vr, F32_RTOL)
        assert_cache(cg[i], ref_layer_cache(cw, p.cfg, i))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_steps_match_reference(arch, pair):
    """Four greedy ``decode_step``s from the prefill caches (B = 2: the
    gather path), each step's logits and every layer's cache after it; both
    sides are fed the reference's argmax."""
    p = pair(arch)
    B, S, cache_len = 2, 12, 16
    assert moe.takes_gather_path(B, p.cfg)
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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_reference_configs_are_the_ports(arch):
    """The MoE fields the layers read equal the reference's, full and
    reduced (E = 8, k ≤ 2 reduced)."""
    for p, r in ((get_config(arch), ref_base.get_config(arch)),
                 (get_config(arch).reduced(), ref_base.get_config(arch).reduced())):
        fields = ("n_experts", "top_k", "shared_expert", "capacity_factor", "moe_every",
                  "dense_ff", "d_ff", "act", "qk_norm")
        assert {f: getattr(p, f) for f in fields} == {f: getattr(r, f) for f in fields}
        assert moe.capacity(256, p) == ref_moe.capacity(256, r)


# =============================================================================
# f64 (last: the module-scoped x64 fixture stays on for the rest of the
# module once taken)
# =============================================================================

@pytest.mark.parametrize("T", [3, 40], ids=["gather", "dispatch"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_f64_matches_reference(arch, T, x64):
    """An f64 layer (its router f32, as the reference keeps it): the
    routing (experts and f32 weights) equal, and given the same routing the
    f64 output within 1e-10; ``aux`` (f32) within 1e-5."""
    p = Pair(arch, jnp.float64, torch.float64)
    params, layer = _moe_layer(p, port_tf.layer_kinds(p.cfg).index("moe"))
    assert params["router"].dtype == jnp.float32 and layer.router.dtype == torch.float32
    x = _x(T, p.cfg.d_model, 30 + T, np.float64)
    want, aux_w = _ref_moe(p.cfg_r, params, x)
    # the reference's routing, step for step (moe.py: f32 logits, softmax, top_k)
    probs = jax.nn.softmax(jx(x[0]).astype(jnp.float32) @ params["router"], axis=-1)
    w_r, idx_r = jax.lax.top_k(probs, p.cfg.top_k)
    w_r = w_r / jnp.sum(w_r, axis=-1, keepdims=True)
    with torch.inference_mode():
        _, w, idx = moe.route(layer, p.cfg, tt(x[0]))
        np.testing.assert_array_equal(to_np(idx), np.asarray(idx_r))
        assert_rel(w, w_r, F32_RTOL)
        got, aux = moe.moe_forward(layer, p.cfg, tt(x))
        route = moe.route
        try:      # the reference's f32 routing weights in place of the port's
            moe.route = lambda *a: (route(*a)[0], tt(np.asarray(w_r)), idx)
            same_routing, _ = moe.moe_forward(layer, p.cfg, tt(x))
        finally:
            moe.route = route
    assert got.dtype == torch.float64
    assert_rel(got, want, F32_RTOL)
    assert_rel(same_routing, want, F64_RTOL)
    assert_rel(aux, aux_w, F32_RTOL)
