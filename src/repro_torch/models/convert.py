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
has no attention or MLP arrays.  This module takes that tree as numpy
arrays and returns the port's model holding exactly the same values
(bitwise: the arrays are copied, never cast; an MoE router and an SSD
block's ``A_log``, ``D`` and ``dt_bias`` are f32 in a model of any dtype,
on both sides).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import Transformer, stacked_sources


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.array(v)
    return out


def params_from_reference(cfg: ArchConfig, tree: dict, *, device="cpu") -> Transformer:
    """The port's model of ``cfg`` holding the reference tree's values.

    Every parameter of the port must come from the tree with the tree's
    shape and dtype, and every array of the tree must be used: a mismatch
    raises ``ValueError``."""
    flat = _flatten(tree)
    dtype = torch.from_numpy(flat["embed"]).dtype
    model = Transformer(cfg, dtype=dtype, device=device)
    sources = stacked_sources(cfg)
    depth = {prefix: sum(1 for q, _ in sources if q == prefix) for prefix, _ in sources}
    used = set()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("layers."):
                _, i, rest = name.split(".", 2)
                prefix, j = sources[int(i)]
                src_name = f"{prefix}{rest}"
                if src_name not in flat:
                    raise ValueError(f"the reference tree has no {src_name!r}")
                stacked = flat[src_name]
                if stacked.shape[0] != depth[prefix]:
                    raise ValueError(f"{src_name}: {stacked.shape[0]} stacked layers, "
                                     f"the config has {depth[prefix]}")
                arr = stacked[j]
            else:
                src_name = name
                if src_name not in flat:
                    raise ValueError(f"the reference tree has no {src_name!r}")
                arr = flat[src_name]
            src = torch.from_numpy(np.ascontiguousarray(arr))
            if src.shape != p.shape or src.dtype != p.dtype:
                raise ValueError(f"{name}: the reference's {tuple(src.shape)} {src.dtype}, "
                                 f"the port's {tuple(p.shape)} {p.dtype}")
            p.copy_(src)
            used.add(src_name)
    unused = sorted(set(flat) - used)
    if unused:
        raise ValueError(f"arrays of the reference tree the port has no place for: {unused}")
    return model
