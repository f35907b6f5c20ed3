"""The port's sharding rules (``repro_torch.distributed.sharding``) against the
reference's ``param_specs`` / ``batch_specs`` / ``opt_state_specs``.

The reference's specs are computed on ``jax.sharding.AbstractMesh((d, m),
("data", "model"))`` (no devices needed) for its stacked tree; the port's
on the same axis sizes for its per-layer parameters, and each must equal
the reference leaf's (``models.convert.reference_name``) with the stack
entry dropped.  All ten reduced configs on five mesh shapes; (1, 3) makes
``_divisible`` replicate the 4 heads, d 64 and the vocab 256.  Every
reduced config has 4 heads over 2 KV heads, so an MHA variant
(``n_kv_heads = n_heads``) of each attention-bearing config takes the MHA
rule.  The batch leaves of a train step (and internlm2's decode caches,
per layer in the port) under the default dp axes and the recommended
ones; AdamW's moments; and this rank's block of a tensor for every
coordinate of a mesh, reassembled, is the tensor bit for bit.
"""

from __future__ import annotations

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec
from test_torch_harness import ref_module

from repro_torch.configs.base import get_config
from repro_torch.distributed import sharding
from repro_torch.models import convert
from repro_torch.models import steps as port_steps
from repro_torch.models.transformer import Transformer
from repro_torch.optim import adamw as port_adamw

ref_sharding = ref_module("distributed.sharding")
ref_tf = ref_module("models.transformer")
ref_steps = ref_module("models.steps")
ref_base = ref_module("configs.base")
ref_adamw = ref_module("optim.adamw")

ARCHS = sorted(ref_base.all_configs())
SHAPES = [(1, 1), (2, 2), (2, 4), (4, 1), (1, 3)]
AXES = ("data", "model")


def _port_mesh(shape):
    return types.SimpleNamespace(shape=dict(zip(AXES, shape)), axis_names=AXES)


def _flat_specs(tree) -> dict:
    """Dotted path → spec tuple of a reference spec tree."""
    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(s)
            for path, s in leaves}


def _stacked(name: str) -> bool:
    return name.startswith("layers.") or name.startswith("encoder.layers.")


def _configs(arch: str):
    """(reference cfg, port cfg) pairs: the reduced config and, where it has
    attention, its MHA variant."""
    cfg_r, cfg_p = ref_base.get_config(arch).reduced(), get_config(arch).reduced()
    out = [(cfg_r, cfg_p)]
    if cfg_p.family != "ssm":
        mha = dict(n_kv_heads=cfg_p.n_heads)
        out.append((dataclasses.replace(cfg_r, **mha), dataclasses.replace(cfg_p, **mha)))
    return out


def _port_shapes(cfg) -> dict:
    model = Transformer(cfg, dtype=torch.float32, device="meta")
    return {k: tuple(p.shape) for k, p in model.named_parameters()}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_state_specs_match_reference(arch):
    for cfg_r, cfg_p in _configs(arch):
        tree = jax.eval_shape(lambda c=cfg_r: ref_tf.init_params(c, jax.random.PRNGKey(0),
                                                                 jnp.float32))
        shapes = _port_shapes(cfg_p)
        for shape in SHAPES:
            mesh_r = AbstractMesh(shape, AXES)
            for cfg_arg in (cfg_r, None):
                want = _flat_specs(ref_sharding.param_specs(tree, mesh_r, cfg_arg))
                got = sharding.param_specs(shapes, _port_mesh(shape),
                                           cfg_p if cfg_arg is not None else None)
                assert sorted(got) == sorted(shapes)
                for name, spec in got.items():
                    ref = want[convert.reference_name(cfg_p, name)]
                    if _stacked(name) and ref:
                        ref = ref[1:]
                    assert spec == ref, (cfg_p.name, shape, name, spec, ref)
                state_r = ref_sharding.opt_state_specs(None, ref_sharding.param_specs(
                    tree, mesh_r, cfg_arg))
                state_p = sharding.opt_state_specs(None, got)
                assert tuple(state_r.step) == state_p.step == ()
                assert isinstance(state_p, port_adamw.AdamWState)
                assert _flat_specs(state_r.m) == _flat_specs(state_r.v) == want
                assert state_p.m is got and state_p.v is got


def test_divisible_replicates_what_does_not_split():
    """(1, 3): the heads (64 columns), d 64 and the vocab 256 stay whole;
    an MoE's 8 experts too; (2, 4) splits them all."""
    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    shapes = _port_shapes(cfg)
    odd = sharding.param_specs(shapes, _port_mesh((1, 3)), cfg)
    assert odd["layers.0.attn.wq"] == ("data", None)
    assert odd["embed"] == (None, "data") and odd["layers.0.moe.w_in"] == (None, "data", None)
    even = sharding.param_specs(shapes, _port_mesh((2, 4)), cfg)
    assert even["layers.0.attn.wq"] == ("data", "model")
    assert even["layers.0.moe.w_in"] == ("model", "data", None)
    assert even["layers.0.moe.router"] == ("data", None)
    assert even["layers.0.norm_attn"] == () and even["layers.0.attn.q_norm"] == (None,)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_match_reference(arch):
    cfg_r, cfg_p = ref_base.get_config(arch).reduced(), get_config(arch).reduced()
    for B in (4, 6, 8):
        b_r = ref_steps.input_specs(cfg_r, "train_4k", override=(32, B), dtype=jnp.float32)
        b_p = port_steps.input_specs(cfg_p, "train_4k", override=(32, B), dtype=torch.float32)
        assert sorted(b_r) == sorted(b_p)
        for shape in SHAPES:
            mesh_r, mesh_p = AbstractMesh(shape, AXES), _port_mesh(shape)
            for dp in (None, ref_sharding.recommended_dp_axes(cfg_r, mesh_r)):
                assert dp is None or dp == sharding.recommended_dp_axes(cfg_p, mesh_p)
                want = _flat_specs(ref_sharding.batch_specs(b_r, mesh_r, dp))
                got = sharding.batch_specs(b_p, mesh_p, dp)
                assert {k: tuple(v) for k, v in got.items()} == want, (shape, dp, B)


def test_decode_cache_specs_match_reference_per_layer():
    """internlm2's decode batch: the reference's stacked (L, B, C, KV, hd)
    caches against the port's per-layer ones, the stack entry dropped."""
    cfg_r = ref_base.get_config("internlm2-1.8b").reduced()
    cfg_p = get_config("internlm2-1.8b").reduced()
    b_r = ref_steps.input_specs(cfg_r, "decode_32k", override=(64, 4), dtype=jnp.float32)
    b_p = port_steps.input_specs(cfg_p, "decode_32k", override=(64, 4), dtype=torch.float32)
    for shape in SHAPES:
        mesh_r, mesh_p = AbstractMesh(shape, AXES), _port_mesh(shape)
        want = ref_sharding.batch_specs(b_r, mesh_r)
        got = sharding.batch_specs(b_p, mesh_p)
        assert tuple(got["tokens"]) == tuple(want["tokens"]) and got["cur_pos"] == ()
        for layer in got["caches"]:
            for leaf in ("k", "v", "pos"):
                ref = tuple(want["caches"]["attn"][leaf])
                assert layer[leaf] == (ref[1:] if ref else ()), (shape, leaf)


def test_dp_axes():
    mesh = _port_mesh((2, 4))
    assert sharding.dp_axes_of(mesh) == ("data",)
    assert sharding.recommended_dp_axes(get_config("internlm2-1.8b"), mesh) == ("data", "model")
    assert sharding.recommended_dp_axes(get_config("qwen2.5-32b"), mesh) == ("data",)
    assert sharding.recommended_dp_axes(get_config("qwen3-moe-235b-a22b"), mesh) == ("data",)


@pytest.mark.parametrize("shape", SHAPES)
def test_blocks_reassemble_bitwise(shape):
    """``block_of`` at every coordinate of the mesh, concatenated back in
    row-major order along each split dim, is the tensor bit for bit; the
    block's shape times the axis sizes is the global shape."""
    rng = np.random.default_rng(3)
    t = torch.from_numpy(rng.standard_normal((8, 12, 6)))
    for spec in [("data", "model", None), ("model", None, "data"), (None, None, None), ()]:
        spec_d = sharding._divisible(spec, t.shape, dict(zip(AXES, shape))) if spec else ()
        blocks = {}
        for d in range(shape[0]):
            for m in range(shape[1]):
                mesh = types.SimpleNamespace(shape=dict(zip(AXES, shape)), axis_names=AXES,
                                             coords=(d, m))
                blocks[d, m] = sharding.block_of(t, spec_d, mesh)
                assert sharding.global_shape(blocks[d, m].shape, spec_d,
                                             mesh.shape) == tuple(t.shape)
        axis_dim = {a: spec_d.index(a) for a in AXES if a in spec_d}
        rows = []
        for d in range(shape[0]):
            row = [blocks[d, m] for m in range(shape[1])]
            rows.append(torch.cat(row, dim=axis_dim["model"]) if "model" in axis_dim else row[0])
        whole = torch.cat(rows, dim=axis_dim["data"]) if "data" in axis_dim else rows[0]
        assert torch.equal(whole, t), (shape, spec_d)
