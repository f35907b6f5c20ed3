"""Gated MLP (SwiGLU / GeGLU).  Counterpart of ``repro/models/mlp.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.collectives import param
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


def glu_ranges(par, ff: int):
    """``model`` rank → the columns of a (d, 2·ff) gate-and-up weight that
    hold the gate and up projections of its share of the ffn rows, and rank
    → that share (the rows of the (ff, d) weight after it)."""
    def cols(r):
        first, count = par.part(ff, r)
        return [(first, count), (ff + first, count)]
    return cols, lambda r: [par.part(ff, r)]


def mlp_forward(p: GatedMLP, cfg: ArchConfig, x: torch.Tensor, par=None) -> torch.Tensor:
    """The gated MLP.  On a mesh (``par``) whose ``model`` axis splits the
    ffn dim, ``w_in`` is column-parallel (this rank's gate and up columns)
    and ``w_out`` row-parallel, the partials summed over ``model`` once; a
    ffn dim that does not split runs replicated."""
    ff = p.w_out.shape[-2] if par is None else par.full_shape(p.w_out)[-2]
    part = None if par is None else par.split(ff)
    if part is None:
        return glu(cfg, x, param(par, p.w_in), param(par, p.w_out))
    cols, rows = glu_ranges(par, ff)
    w_in = par.param(p.w_in, dim=1, ranges=cols)
    w_out = par.param(p.w_out, dim=0, ranges=rows)
    return par.sum_tp(glu(cfg, par.copy_tp(x), w_in, w_out))


def glu(cfg: ArchConfig, x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor):
    """act(gate) · up, then ``w_out``: the gate and up halves side by side
    in ``w_in``'s columns."""
    f = w_out.shape[-2]
    h = x @ w_in
    return (_act(cfg.act)(h[..., :f]) * h[..., f:]) @ w_out
