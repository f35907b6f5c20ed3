"""The carry-over of weights from the reference's parameter tree.

``repro.models.transformer.init_params`` returns a tree whose layer arrays
are stacked ``(L, ...)`` in the reference's scan order; the port holds one
module a layer in execution order (``transformer.execution_order``: for
gemma2's local/global pairing 0, L/2, 1, L/2 + 1, ...).  llama4's
superlayers stack their dense and MoE layers apart, ``layers.dense.*`` and
``layers.moe.*``, each ``(L/2, ...)``: stacked j of the first is position
2j, of the second 2j + 1 (``transformer.stacked_sources``).  An SSM or
hybrid layer's SSD block is ``layers.ssm.*`` and a hybrid layer's fusion
norms ``layers.fuse_norm_attn`` and ``layers.fuse_norm_ssm``; an SSM layer
has no attention or MLP arrays.  An enc-dec tree stacks its encoder layers
as ``encoder.layers.*`` (``(n_enc_layers, ...)``, stacked i is the port's
``encoder.layers.i``) beside ``encoder.final_norm``, and each decoder
layer's ``layers.cross.*`` and ``layers.norm_cross``.  This module takes
that tree as numpy arrays and returns the port's model holding exactly the
same values (bitwise: the arrays are copied, never cast; an MoE router and
an SSD block's ``A_log``, ``D`` and ``dt_bias`` are f32 in a model of any
dtype, on both sides).  A bf16 array (numpy's ``ml_dtypes`` bfloat16,
which ``torch.from_numpy`` does not take) is carried as its 16-bit
patterns: viewed as uint16, then as ``torch.bfloat16``.

:func:`reference_tree` is the inverse carry: any name → tensor map in the
port's names (the parameters, their gradients, AdamW's moments) back to
numpy arrays in the reference tree's nested, stacked layout, bitwise (a
bf16 tensor becomes an ``ml_dtypes`` bfloat16 array of the same bits).

On a mesh of ranks (``distributed.sharding``) :func:`blocks_from_reference`
carries the global tree into this rank's blocks and
:func:`reference_tree_of_blocks` gathers blocks back into the reference's
global tree (a collective: every rank calls it).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding
from repro_torch.models.transformer import Transformer, stacked_sources


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.array(v)
    return out


def to_tensor(arr: np.ndarray) -> torch.Tensor:
    """A tensor holding ``arr``'s bits, bf16 included (see the module's
    docstring)."""
    arr = np.ascontiguousarray(arr).reshape(np.shape(arr))    # 0-d stays 0-d
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _source(cfg: ArchConfig, name: str, sources) -> tuple[str, int | None, int]:
    """The reference tree's name of the port's parameter ``name``, its index
    in the stack (None for an unstacked array) and the stack's depth."""
    if name.startswith("encoder.layers."):
        _, _, i, rest = name.split(".", 3)
        return f"encoder.layers.{rest}", int(i), cfg.n_enc_layers
    if name.startswith("layers."):
        _, i, rest = name.split(".", 2)
        prefix, j = sources[int(i)]
        return f"{prefix}{rest}", j, sum(1 for q, _ in sources if q == prefix)
    return name, None, 0


def reference_name(cfg: ArchConfig, name: str) -> str:
    """The reference tree's (dotted) name of the port's parameter ``name``:
    the stacked leaf a layer's parameter is one slice of."""
    return _source(cfg, name, stacked_sources(cfg))[0]


def params_from_reference(cfg: ArchConfig, tree: dict, *, device="cpu") -> Transformer:
    """The port's model of ``cfg`` holding the reference tree's values.

    Every parameter of the port must come from the tree with the tree's
    shape and dtype, and every array of the tree must be used: a mismatch
    raises ``ValueError``."""
    flat = _flatten(tree)
    dtype = to_tensor(flat["embed"]).dtype
    model = Transformer(cfg, dtype=dtype, device=device)
    sources = stacked_sources(cfg)
    used = set()
    with torch.no_grad():
        for name, p in model.named_parameters():
            src_name, j, depth = _source(cfg, name, sources)
            if src_name not in flat:
                raise ValueError(f"the reference tree has no {src_name!r}")
            arr = flat[src_name]
            if j is not None:
                if arr.shape[0] != depth:
                    raise ValueError(f"{src_name}: {arr.shape[0]} stacked layers, "
                                     f"the config has {depth}")
                arr = arr[j]
            src = to_tensor(arr)
            if src.shape != p.shape or src.dtype != p.dtype:
                raise ValueError(f"{name}: the reference's {tuple(src.shape)} {src.dtype}, "
                                 f"the port's {tuple(p.shape)} {p.dtype}")
            p.copy_(src)
            used.add(src_name)
    unused = sorted(set(flat) - used)
    if unused:
        raise ValueError(f"arrays of the reference tree the port has no place for: {unused}")
    return model


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """``t``'s bits as a numpy array on the host (bf16 as ``ml_dtypes``'
    bfloat16, the dtype the reference's arrays have)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def reference_tree(cfg: ArchConfig, named: dict) -> dict:
    """The reference tree of ``named`` (the port's parameter names → tensors
    of their shapes): nested dicts of numpy arrays, each layer stack
    ``(depth, ...)`` in the reference's stacked order
    (:func:`transformer.stacked_sources`), bitwise.  Every stack must be
    whole: a missing layer raises ``ValueError``."""
    sources = stacked_sources(cfg)
    stacks: dict[str, list] = {}
    flat: dict[str, np.ndarray] = {}
    for name, t in named.items():
        src_name, j, depth = _source(cfg, name, sources)
        arr = _to_numpy(t)
        if j is None:
            flat[src_name] = arr
        else:
            stacks.setdefault(src_name, [None] * depth)[j] = arr
    for src_name, layers in stacks.items():
        if any(a is None for a in layers):
            raise ValueError(f"{src_name}: layers {[i for i, a in enumerate(layers) if a is None]}"
                             f" missing")
        flat[src_name] = np.stack(layers)
    tree: dict = {}
    for src_name, arr in flat.items():
        *path, leaf = src_name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = arr
    return tree


def blocks_from_reference(cfg: ArchConfig, tree: dict, mesh, *, device="cpu") -> Transformer:
    """:func:`params_from_reference`, then this rank's blocks of it on
    ``mesh``: the trainer's placement (``runtime.elastic.reshard_state``
    with ``cfg``, then ``sharding.install``)."""
    from repro_torch.runtime.elastic import reshard_state
    model = params_from_reference(cfg, tree, device=device)
    blocks, _ = reshard_state({k: p.detach() for k, p in model.named_parameters()}, None,
                              mesh, cfg)
    sharding.install(model, blocks, mesh)
    return model


def reference_tree_of_blocks(cfg: ArchConfig, named: dict, specs: dict, mesh) -> dict:
    """:func:`reference_tree` of the blocks ``named`` (their ``specs`` on
    ``mesh``) gathered into the global tensors (``sharding.gather_params``)."""
    return reference_tree(cfg, sharding.gather_params(named, specs, mesh))
