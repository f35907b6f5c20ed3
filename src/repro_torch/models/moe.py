"""Mixture-of-Experts layers.  Counterpart of ``repro/models/moe.py`` on one
device.

The reference runs its MoE inside a ``shard_map`` over a (data, model) mesh:
each model-axis shard owns E/tp experts, one ``psum`` combines their
partials, and the load-balance statistics are ``pmean``-ed over the data
axes.  On one device (tp = dp = 1) the psum and the pmeans are identities and
the dp rank offsets vanish; the arithmetic that is left is ported here, with
the switch between the reference's two paths exactly as it makes it:

* the *gather* path (T·k ≤ min(64, E − 1) token-expert assignments): each
  assignment runs its expert's slices of ``w_in`` and ``w_out`` in place (a
  view of the stack, no gathered copy of the weights); it never drops;
* the *dispatch* path: a stable sort of the assignments by expert, the rank
  of each within its expert, a drop where the rank reaches the capacity C,
  the kept tokens gathered into (E, C, d), two batched products with the
  activation between them, the routing weight, and each kept row returned to
  its token.

Both paths combine a token's k contributions in a fixed order, its k slots
one add after another (the reference's flat order, token-major, k-minor),
never with atomics, so a run repeats bitwise on the card.  The router, its
logits and probabilities are f32 whatever the model's dtype, as in the
reference.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import normal_init, weight
from repro_torch.models.mlp import _act

#: at or below this many token-expert assignments (and below E) the gather
#: path is taken: dispatch reads every expert's weights whatever the routing,
#: gathering reads one expert's slices an assignment (the reference's rule)
GATHER_MAX_ASSIGNMENTS = 64


#: set while ``torch.utils.checkpoint`` recomputes a layer for the backward
_RECOMPUTING = contextvars.ContextVar("moe_recomputing", default=False)


@contextlib.contextmanager
def recomputing():
    """Marks a remat recompute (``transformer.forward_hidden``): a layer run
    again for the backward records no ``stats``, so each forward is recorded
    once."""
    token = _RECOMPUTING.set(True)
    try:
        yield
    finally:
        _RECOMPUTING.reset(token)


def _expert_weights(generator: torch.Generator | None, E: int, shape, std: float, *,
                    dtype, device) -> nn.Parameter:
    """An (E, *shape) stack drawn ``N(0, std²)`` in f32 and cast to ``dtype``
    one expert at a time (a whole-stack f32 draw would need a temporary twice
    the size of a bf16 stack); zeros where there is no generator."""
    w = torch.zeros((E, *shape), dtype=dtype, device=device)
    if generator is not None:
        with torch.no_grad():
            for e in range(E):
                w[e] = normal_init(generator, shape, std, dtype)
    return nn.Parameter(w)


class MoE(nn.Module):
    """``router`` (d, E), always f32; ``w_in`` (E, d, 2f), each expert's gate
    and up projections side by side; ``w_out`` (E, f, d); with a shared
    expert also ``shared_in`` (d, 2f) and ``shared_out`` (f, d)."""

    def __init__(self, cfg: ArchConfig, *, dtype, device,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        kw = dict(dtype=dtype, device=device)
        self.router = weight(generator, (d, E), d ** -0.5, dtype=torch.float32,
                             device=device)
        self.w_in = _expert_weights(generator, E, (d, 2 * f), d ** -0.5, **kw)
        self.w_out = _expert_weights(generator, E, (f, d), f ** -0.5, **kw)
        if cfg.shared_expert:
            self.shared_in = weight(generator, (d, 2 * f), d ** -0.5, **kw)
            self.shared_out = weight(generator, (f, d), f ** -0.5, **kw)

    def forward(self, x: torch.Tensor):
        return moe_forward(self, self.cfg, x)


def init_moe_params(cfg: ArchConfig, generator: torch.Generator, dtype) -> MoE:
    """An MoE layer of ``cfg`` on the generator's device, drawn from it with
    the reference's distributions (the router in f32)."""
    return MoE(cfg, dtype=dtype, device=generator.device, generator=generator)


def capacity(T: int, cfg: ArchConfig) -> int:
    c = int(math.ceil(T * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
    return max(8, -(-c // 8) * 8)  # >=8, rounded up to a multiple of 8


def takes_gather_path(T: int, cfg: ArchConfig) -> bool:
    return T * cfg.top_k <= min(GATHER_MAX_ASSIGNMENTS, cfg.n_experts - 1)


def route(p: MoE, cfg: ArchConfig, xt: torch.Tensor):
    """xt (T, d) → (probs (T, E), weights (T, k), experts (T, k)): f32 logits
    and softmax, the top k in descending order (the order decides which of a
    token's assignments a full expert drops), the weights renormalised."""
    probs = torch.softmax(xt.float() @ p.router, dim=-1)
    w, idx = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    return probs, w / w.sum(dim=-1, keepdim=True), idx


def _combine(buf: torch.Tensor) -> torch.Tensor:
    """(T, k, d) contributions → (T, d), slot 0 first, then one add a slot."""
    out = buf[:, 0]
    for j in range(1, buf.shape[1]):
        out = out + buf[:, j]
    return out


def _gather(p: MoE, cfg: ArchConfig, xt, w, idx) -> torch.Tensor:
    T, d = xt.shape
    f, act = cfg.d_ff, _act(cfg.act)
    experts = idx.tolist()          # the slices are chosen on the host
    buf = xt.new_empty((T, cfg.top_k, d))
    for t, row in enumerate(experts):
        for j, e in enumerate(row):
            h = xt[t:t + 1] @ p.w_in[e]
            torch.matmul(act(h[:, :f]) * h[:, f:], p.w_out[e], out=buf[t, j:j + 1])
    return _combine(buf * w.to(xt.dtype)[..., None])


def _dispatch(p: MoE, cfg: ArchConfig, xt, w, idx):
    """The dispatch path's output (T, d) and its dropped assignments (T, k)."""
    T, d = xt.shape
    E, k, f, act = cfg.n_experts, cfg.top_k, cfg.d_ff, _act(cfg.act)
    dev = xt.device
    C = capacity(T, cfg)
    Cs = min(C, T * k)               # rank < T·k always: no slot past it fills
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    starts = torch.searchsorted(se, torch.arange(E, device=dev))
    rank = torch.arange(T * k, device=dev) - starts[se]
    keep = rank < C
    # a dropped assignment writes the dump slot E·Cs, which nothing reads
    slot = torch.where(keep, se * Cs + rank, E * Cs)
    table = torch.full((E * Cs + 1,), T, dtype=torch.int64, device=dev)
    table[slot] = order // k
    wtab = torch.zeros(E * Cs + 1, dtype=w.dtype, device=dev)
    wtab[slot] = w.reshape(-1)[order]
    x_pad = torch.cat([xt, xt.new_zeros((1, d))])
    xg = x_pad[table[:-1]].view(E, Cs, d)
    h = torch.bmm(xg, p.w_in)
    y = torch.bmm(act(h[..., :f]) * h[..., f:], p.w_out)
    y = y * wtab[:-1].view(E, Cs, 1).to(y.dtype)
    y_pad = torch.cat([y.view(E * Cs, d), y.new_zeros((1, d))])
    src = torch.empty(T * k, dtype=torch.int64, device=dev)
    src[order] = slot               # each assignment's row, in flat (t, j) order
    dropped = torch.empty(T * k, dtype=torch.bool, device=dev)
    dropped[order] = ~keep
    return _combine(y_pad[src].view(T, k, d)), dropped.view(T, k)


def moe_forward(p: MoE, cfg: ArchConfig, x: torch.Tensor, *, stats: dict | None = None):
    """x: (B, S, d) → (out (B, S, d) in x's dtype, aux: the Switch-style
    load-balance loss E·Σ_e me_e·ce_e, f32 0-d).

    With a ``stats`` dict, records ``path`` ("gather" or "dispatch"),
    ``capacity`` (None on the gather path) and ``dropped`` (T, k), True
    where an assignment was dropped; not during a remat recompute
    (:func:`recomputing`)."""
    B, S, d = x.shape
    T, E, k = B * S, cfg.n_experts, cfg.top_k
    xt = x.reshape(T, d)
    probs, w, idx = route(p, cfg, xt)
    gather = takes_gather_path(T, cfg)
    if gather:
        out = _gather(p, cfg, xt, w, idx)
        dropped = torch.zeros((T, k), dtype=torch.bool, device=x.device)
    else:
        out, dropped = _dispatch(p, cfg, xt, w, idx)
    if cfg.shared_expert:
        f_sh = p.shared_out.shape[0]
        hs = xt @ p.shared_in
        out = out + (_act(cfg.act)(hs[:, :f_sh]) * hs[:, f_sh:]) @ p.shared_out
    me = probs.mean(dim=0)
    ce = torch.bincount(idx.reshape(-1), minlength=E).float() / (T * k)
    aux = E * torch.sum(me * ce)
    if stats is not None and not _RECOMPUTING.get():
        stats.update(path="gather" if gather else "dispatch",
                     capacity=None if gather else capacity(T, cfg), dropped=dropped)
    return out.reshape(B, S, d).to(x.dtype), aux
