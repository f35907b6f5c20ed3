"""Sharding rules: parameters (tensor × FSDP), batches, optimizer state
(counterpart of ``repro/distributed/sharding.py``), and the placement of a
model's parameters as this rank's blocks.

Scheme: tensor parallelism over ``model`` (heads, the ffn dim, the expert
dim, the vocab), FSDP over ``data`` (the other weight dim).  A spec is a
tuple of one entry a dim, each ``None`` (replicated), an axis name or a
tuple of axis names (the dim split over their product, row-major), as
``jax.sharding.PartitionSpec`` holds them; ``()`` is the reference's
``P()`` (replicated whole).

The reference stacks a layer's arrays ``(L, ...)`` and pads its rules with
``None`` for the stack; the port holds one module a layer, so a port
parameter's spec is the reference's with the leading stack entry dropped.
No weight is transposed (``models.convert`` copies arrays as they are).
Rules are keyed on the leaf's name and, for an MoE layer's ``w_in`` and
``w_out``, its parent's: the last two keys of a port name
(``layers.3.moe.w_in``) are those of the reference leaf it is one slice of
(``models.convert.reference_name``: ``layers.moe.w_in``, or
``layers.moe.moe.w_in`` under llama4's superlayers).

The reference's ``make_hint`` (activation sharding constraints for GSPMD)
has no counterpart: the port's layout is explicit.  Each weight is used
through ``distributed.collectives.Parallel.param`` (the FSDP all-gather over
``data``, and over ``model`` the view the layer's tensor-parallel compute
takes), and the activations are replicated over ``model`` between layers
(no sequence parallelism; ROADMAP queue 1).

:func:`shard_params` gives this rank's block of every leaf of a tree of
global tensors, :func:`gather_params` is its inverse onto the host,
:func:`install` makes blocks, each carrying its spec (:func:`spec_of`), a
model's parameters, and :class:`BlockDraw` cuts a model to its blocks as
it is drawn (``models.transformer.init_params`` with a mesh).
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn

# leaf name -> spec of the LAST len(spec) dims (the reference's table)
_RULES: dict[str, tuple] = {
    # embeddings / head
    "embed": ("model", "data"),
    "lm_head": ("model", "data"),
    # attention: K/V projections replicated over model (GQA)
    "wq": ("data", "model"),
    "wk": ("data", None),
    "wv": ("data", None),
    "wo": ("model", "data"),
    "bq": ("model",),
    "bk": (None,),
    "bv": (None,),
    "q_norm": (None,),
    "k_norm": (None,),
    # mlp
    "w_in": ("data", "model"),
    "w_out": ("model", "data"),
    # moe (leading E dim sharded over model = expert parallelism)
    "router": ("data", None),
    "moe_w_in": ("model", "data", None),
    "moe_w_out": ("model", None, "data"),
    "shared_in": ("data", "model"),
    "shared_out": ("model", "data"),
    # ssm (split projections; z/x head-sharded over model, B/C/dt replicated)
    "w_z": ("data", "model"),
    "w_x": ("data", "model"),
    "w_B": ("data", None),
    "w_C": ("data", None),
    "w_dt": ("data", None),
    "out_proj": ("model", "data"),
    "conv_x": (None, "model"),
    "conv_B": (None, None),
    "conv_C": (None, None),
    "conv_bx": ("model",),
    "conv_bB": (None,),
    "conv_bC": (None,),
    "A_log": (None,),
    "D": (None,),
    "dt_bias": (None,),
}

#: the attribute of a placed parameter that holds its spec
_SPEC_ATTR = "mesh_spec"


def _leaf_rule(name: str) -> tuple | None:
    """The rule of a dotted name: by its leaf, an MoE expert stack's by its
    parent too; any other name holding ``norm`` is replicated (``()``)."""
    keys = name.split(".")
    leaf = keys[-1]
    # moe expert weights share names with mlp weights; disambiguate via parent
    if len(keys) >= 2 and keys[-2] == "moe" and leaf in ("w_in", "w_out"):
        return _RULES["moe_" + leaf]
    if leaf in _RULES:
        return _RULES[leaf]
    if "norm" in leaf:
        return ()
    return None


def axes_of(entry) -> tuple[str, ...]:
    """A spec entry's axes (``()`` for None)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _size(entry, shape: dict) -> int:
    return math.prod(shape[a] for a in axes_of(entry))


def _divisible(spec_tuple, shape, mesh_shape: dict) -> tuple:
    """Drop (replicate) any axis that does not divide its dim (e.g. hymba's
    vocab 32001 over model, llama4's 40 heads at tp = 16)."""
    return tuple(None if a is None or dim % _size(a, mesh_shape) else a
                 for dim, a in zip(shape, spec_tuple))


def _shape(leaf) -> tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def param_spec(name: str, shape, mesh_shape: dict, mha: bool = False) -> tuple:
    """One parameter's spec (see :func:`param_specs`)."""
    rule = _leaf_rule(name)
    leaf = name.rsplit(".", 1)[-1]
    if mha and leaf in ("wk", "wv"):
        rule = ("data", "model")
    if mha and leaf in ("bk", "bv"):
        rule = ("model",)
    if rule is None or rule == ():
        return ()
    shape = _shape(shape)
    full = (None,) * (len(shape) - len(rule)) + tuple(rule)
    return _divisible(full, shape, mesh_shape)


def param_specs(params: dict, mesh, cfg=None) -> dict:
    """The spec of every parameter of ``params`` (a port name → tensor or
    shape map, global shapes) on ``mesh`` (anything with a ``shape`` dict of
    axis sizes).

    ``cfg`` enables the arch-dependent rule: MHA (``n_kv_heads ==
    n_heads``) shards the K/V projections over the tensor axis like Q; GQA
    keeps them replicated.  Without ``cfg`` (the reference's
    ``reshard_state`` calls it so) the GQA rule holds for every model."""
    return {k: param_spec(k, v, mesh.shape, _mha(cfg)) for k, v in params.items()}


def _mha(cfg) -> bool:
    return cfg is not None and getattr(cfg, "n_kv_heads", 0) == getattr(cfg, "n_heads", -1)


def dp_axes_of(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def recommended_dp_axes(cfg, mesh) -> tuple[str, ...]:
    """The reference's per-arch parallelism profile: small-d dense, ssm and
    hybrid models shard the batch over every axis (pure FSDP); MoE models
    and dense models above d 2304 keep the tensor axis.  The port's training
    step runs the first profile only (``tp_axis`` not among the dp axes)."""
    if cfg.family == "moe" or cfg.d_model > 2304:
        return dp_axes_of(mesh)
    return tuple(a for a in ("pod", "data", "model") if a in mesh.axis_names)


def _longest_divisible(axes: tuple[str, ...], dim: int, mesh_shape: dict):
    """Longest prefix of ``axes`` whose product divides ``dim``."""
    out = []
    size = 1
    for a in axes:
        if dim % (size * mesh_shape[a]) == 0:
            out.append(a)
            size *= mesh_shape[a]
        else:
            break
    if not out:
        return None
    return tuple(out) if len(out) > 1 else out[0]


def _batch_leaf_spec(keys: list, shape: tuple, mesh_shape: dict, dp: tuple) -> tuple:
    """The reference's batch rule for one leaf, with the stack entry of a
    layer's cache dropped: the port's caches are per layer, ``k``/``v``
    (B, C, KV, hd), ``state`` (B, nH, P, N), ``conv`` (B, K-1, ch), and an
    enc-dec model's ``cross_kvs`` one (B, T, KV, hd) pair a layer."""
    name = str(keys[-1])
    if name in ("cur_pos", "pos") or len(shape) == 0:
        return ()
    in_cache = "caches" in keys or "cross_kvs" in keys
    bdim = shape[1] if (name == "positions" and len(shape) == 3) else shape[0]
    bspec = _longest_divisible(dp, bdim, mesh_shape) if dp else None
    cache_tp = None if "model" in dp else "model"
    raw = None
    if in_cache:
        if "cross_kvs" in keys or name in ("k", "v", "state"):
            raw = (bspec, cache_tp, None, None)
        elif name == "conv":
            raw = (bspec, None, None)
    if raw is None and name == "positions" and len(shape) == 3:
        raw = (None, bspec, None)                    # mrope (3, B, S)
    if raw is None and len(shape) == 3:
        raw = (bspec, None, None)                    # embeds (B, S, d)
    if raw is None and len(shape) == 2:
        raw = (bspec, None)                          # tokens/targets
    if raw is None:
        return ()
    return _divisible(raw, shape, mesh_shape)


def batch_specs(batch: Any, mesh, dp_axes: tuple[str, ...] | None = None) -> Any:
    """Input specs: batch dims over the longest divisible prefix of the dp
    axes; cache heads over ``model`` unless it is a dp axis.  ``batch`` is
    a tree of dicts, lists and tuples (a decode batch's per-layer caches)
    whose leaves are tensors, arrays or shapes; the result has its
    structure."""
    dp = tuple(dp_axes) if dp_axes is not None else dp_axes_of(mesh)

    def walk(node, keys):
        if isinstance(node, dict):
            return {k: walk(v, keys + [k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)) and not isinstance(node, torch.Size) and (
                node and not isinstance(node[0], int)):
            return type(node)(walk(v, keys + [i]) for i, v in enumerate(node))
        if isinstance(node, int):          # a host scalar (cur_pos)
            return ()
        return _batch_leaf_spec(keys, _shape(node), mesh.shape, dp)

    return walk(batch, [])


def opt_state_specs(opt_state, params_spec: dict):
    """AdamWState(step, m, v): the moments shard like the params."""
    from repro_torch.optim.adamw import AdamWState
    return AdamWState(step=(), m=params_spec, v=params_spec)


# =============================================================================
# Blocks
# =============================================================================

def axis_index(mesh, axes) -> int:
    """This rank's index along ``axes`` (row-major over them)."""
    idx = 0
    for a in axes_of(axes):
        idx = idx * mesh.shape[a] + mesh.coords[mesh.axis_names.index(a)]
    return idx


def block_of(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of the global ``t`` (a view)."""
    for dim, entry in enumerate(spec):
        n = _size(entry, mesh.shape)
        if n > 1:
            step = t.shape[dim] // n
            t = t.narrow(dim, axis_index(mesh, entry) * step, step)
    return t


def global_shape(block_shape, spec: tuple, mesh_shape: dict) -> tuple[int, ...]:
    """The global shape a block of ``spec`` comes from."""
    spec = tuple(spec) + (None,) * (len(block_shape) - len(spec))
    return tuple(n * _size(e, mesh_shape) for n, e in zip(block_shape, spec))


def gather_block(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The global tensor of this rank's block ``t``, on ``t``'s device
    (collective over the ranks that share the spec's axes; every rank
    calls it)."""
    for dim, entry in enumerate(spec):
        if _size(entry, mesh.shape) > 1:
            t = mesh.axis_comm(axes_of(entry)).all_gather(t, dim=dim)
    return t.detach()


def shard_params(tree: dict, specs: dict, mesh) -> dict:
    """This rank's block of every leaf of ``tree`` (name → global tensor),
    contiguous copies (never a view that keeps the global tensor alive)."""
    return {k: block_of(v, specs[k], mesh).clone(memory_format=torch.contiguous_format)
            for k, v in tree.items()}


def gather_params(tree: dict, specs: dict, mesh) -> dict:
    """The inverse of :func:`shard_params`, onto the host: every rank calls
    it (one all-gather a sharded dim of each leaf, in the dict's order) and
    every rank gets the global tensors."""
    return {k: gather_block(v, specs[k], mesh).cpu() for k, v in tree.items()}


def spec_of(t: torch.Tensor) -> tuple:
    """A placed parameter's spec (``()`` for one never placed).  The spec is
    an attribute of the tensor object :func:`set_spec` was given (a
    model's ``nn.Parameter``): a view or a ``detach()`` of it has none."""
    return getattr(t, _SPEC_ATTR, ())


def set_spec(t: torch.Tensor, spec: tuple) -> torch.Tensor:
    setattr(t, _SPEC_ATTR, tuple(spec))
    return t


def sharded_axes(spec: tuple) -> tuple[str, ...]:
    """Every axis a spec splits some dim over."""
    return tuple(a for e in spec for a in axes_of(e))


def install(model: nn.Module, blocks: dict, mesh) -> None:
    """Make ``blocks`` (name → this rank's block, each carrying its spec)
    ``model``'s parameters, in place (a new ``nn.Parameter`` each, the old
    global one dropped), and give ``model.ctx`` the mesh (:func:`on_mesh`)."""
    for name, block in blocks.items():
        *path, leaf = name.split(".")
        owner = model.get_submodule(".".join(path)) if path else model
        old = getattr(owner, leaf)
        new = nn.Parameter(block.detach(), requires_grad=old.requires_grad)
        setattr(owner, leaf, set_spec(new, spec_of(block)))
    model.ctx = on_mesh(model.ctx, mesh)


def on_mesh(ctx, mesh):
    """``ctx`` (a ``models.transformer.ModelCtx``) on ``mesh``: FSDP over
    its dp axes, tensor parallel over ``model``."""
    import dataclasses
    return dataclasses.replace(ctx, mesh=mesh, dp_axes=dp_axes_of(mesh), tp_axis="model")


class BlockDraw:
    """Cuts a model's parameters to this rank's blocks while the model is
    drawn, so that a rank never holds more of the whole model than the
    module being drawn: the spec of each is :func:`param_spec` of its name
    and global shape (the MHA rule on for an MHA ``cfg``), its block a
    contiguous copy carrying the spec.  A parameter that already carries a
    spec is a block already (an MoE expert stack drawn expert by expert,
    :meth:`experts`)."""

    def __init__(self, mesh, cfg):
        self.mesh = mesh
        self.mha = _mha(cfg)

    def spec(self, name: str, shape) -> tuple:
        return param_spec(name, shape, self.mesh.shape, self.mha)

    def cut(self, module: nn.Module, prefix: str = "") -> None:
        """Every parameter of ``module`` (named ``prefix`` + its name) as
        its block, in place."""
        for name, p in list(module.named_parameters()):
            if hasattr(p, _SPEC_ATTR):
                continue
            spec = self.spec(prefix + name, p.shape)
            block = block_of(p.detach(), spec, self.mesh).clone(
                memory_format=torch.contiguous_format)
            *path, leaf = name.split(".")
            owner = module.get_submodule(".".join(path)) if path else module
            setattr(owner, leaf, set_spec(nn.Parameter(block, requires_grad=p.requires_grad),
                                          spec))

    def experts(self, name: str, shape) -> tuple:
        """For an expert stack ``name`` of global ``shape`` (E, ...):
        (its spec, this rank's experts (a range), the cut of one expert's
        weight to its block)."""
        spec = self.spec(name, shape)
        per = shape[0] // _size(spec[0], self.mesh.shape)
        first = axis_index(self.mesh, spec[0]) * per
        return spec, range(first, first + per), lambda t: block_of(t, spec[1:], self.mesh)
