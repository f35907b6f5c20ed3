"""Gated MLP (SwiGLU / GeGLU).  Counterpart of ``repro/models/mlp.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import weight


def _act(name: str):
    # jax.nn.gelu is the tanh approximation by default; torch's default is exact
    if name == "silu":
        return F.silu
    return lambda x: F.gelu(x, approximate="tanh")


class GatedMLP(nn.Module):
    """``w_in`` (d, 2·ff) holds the gate and up projections side by side,
    ``w_out`` (ff, d): the reference's (in, out) layout."""

    def __init__(self, cfg: ArchConfig, d: int, ff: int, *, dtype, device,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.w_in = weight(generator, (d, 2 * ff), d ** -0.5, dtype=dtype, device=device)
        self.w_out = weight(generator, (ff, d), ff ** -0.5, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_forward(self, self.cfg, x)


def mlp_forward(p: GatedMLP, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    ff = p.w_out.shape[-2]
    h = x @ p.w_in
    gate, up = h[..., :ff], h[..., ff:]
    return (_act(cfg.act)(gate) * up) @ p.w_out
