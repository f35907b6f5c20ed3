"""Mixture-of-Experts layers.  Counterpart of ``repro/models/moe.py``.

The reference runs its MoE inside a ``shard_map`` over a (data, model) mesh:
each model-axis shard owns E/tp experts, one ``psum`` combines their
partials and the shared expert's, and the load-balance statistics are
``pmean``-ed over the data axes.  Here the same runs on one device
(``par`` None: tp = dp = 1, the psum and pmeans the identity) or on a mesh
of ranks (``par``: ``distributed.collectives.Parallel``), with the switch
between the reference's two paths exactly as it makes it:

* the *gather* path (T·dp·k ≤ min(64, E/tp − 1) token-expert assignments,
  counted over the global batch; it depends on tp, so a mesh may take the
  other path than one device, as the reference's does): each assignment to
  one of this rank's experts runs its expert's slices of ``w_in`` and
  ``w_out`` in place (a view of the stack, no gathered copy of the
  weights); it never drops;
* the *dispatch* path: a stable sort of the assignments by expert, the rank
  of each within its expert, offset by the same expert's assignments on
  the dp ranks that hold earlier tokens (an all-gather of per-expert
  counts), a drop where that global rank reaches the capacity C of the
  global token count, so the drops are one device's; this rank's experts'
  kept tokens gathered into (E/tp, C', d), two batched products with the
  activation between them, the routing weight, and each kept row returned
  to its token.

Both paths combine a token's k contributions in a fixed order, its k slots
one add after another (the reference's flat order, token-major, k-minor),
never with atomics, so a run repeats bitwise on the card.  The router, its
logits and probabilities are f32 whatever the model's dtype, as in the
reference; routing runs replicated over ``model``.  The shared expert is a
column- then row-parallel MLP; the experts' and the shared expert's
partials are summed over ``model`` once.  The aux statistics are averaged
over the dp ranks before their product.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.collectives import param
from repro_torch.distributed.sharding import BlockDraw, set_spec
from repro_torch.models.common import normal_init, weight
from repro_torch.models.mlp import _act, glu, glu_ranges

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
                    dtype, device, blocks: BlockDraw | None = None,
                    name: str = "") -> nn.Parameter:
    """An (E, *shape) stack drawn ``N(0, std²)`` in f32 and cast to ``dtype``
    one expert at a time (a whole-stack f32 draw would need a temporary twice
    the size of a bf16 stack); zeros where there is no generator.  With
    ``blocks`` the stack is this rank's block of the stack ``name``,
    carrying its spec: every expert is still drawn, in order, and only this
    rank's experts are kept, each cut to its block as it is drawn."""
    if generator is not None and blocks is not None:
        spec, mine, cut = blocks.experts(name, (E, *shape))
        w = None
        with torch.no_grad():
            for e in range(E):
                t = normal_init(generator, shape, std, dtype)
                if e in mine:
                    b = cut(t)
                    if w is None:
                        w = torch.empty((len(mine), *b.shape), dtype=dtype, device=device)
                    w[e - mine.start] = b
        return set_spec(nn.Parameter(w), spec)
    w = torch.zeros((E, *shape), dtype=dtype, device=device)
    if generator is not None:
        with torch.no_grad():
            for e in range(E):
                w[e] = normal_init(generator, shape, std, dtype)
    return nn.Parameter(w)


class MoE(nn.Module):
    """``router`` (d, E), always f32; ``w_in`` (E, d, 2f), each expert's gate
    and up projections side by side; ``w_out`` (E, f, d); with a shared
    expert also ``shared_in`` (d, 2f) and ``shared_out`` (f, d).  With
    ``blocks`` (``distributed.sharding.BlockDraw``) each is this rank's
    block, the expert stacks kept expert by expert as they are drawn."""

    def __init__(self, cfg: ArchConfig, *, dtype, device,
                 generator: torch.Generator | None = None, blocks: BlockDraw | None = None):
        super().__init__()
        self.cfg = cfg
        d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        kw = dict(dtype=dtype, device=device, blocks=blocks)
        self.router = weight(generator, (d, E), d ** -0.5, dtype=torch.float32,
                             device=device)
        self.w_in = _expert_weights(generator, E, (d, 2 * f), d ** -0.5, name="moe.w_in", **kw)
        self.w_out = _expert_weights(generator, E, (f, d), f ** -0.5, name="moe.w_out", **kw)
        if cfg.shared_expert:
            self.shared_in = weight(generator, (d, 2 * f), d ** -0.5, dtype=dtype, device=device)
            self.shared_out = weight(generator, (f, d), f ** -0.5, dtype=dtype, device=device)
        if blocks is not None:
            blocks.cut(self, "moe.")

    def forward(self, x: torch.Tensor):
        return moe_forward(self, self.cfg, x)


def init_moe_params(cfg: ArchConfig, generator: torch.Generator, dtype, mesh=None) -> MoE:
    """An MoE layer of ``cfg`` on the generator's device, drawn from it with
    the reference's distributions (the router in f32); on ``mesh``, this
    rank's blocks of it (``distributed.sharding.BlockDraw``), never the
    whole layer."""
    blocks = None if mesh is None else BlockDraw(mesh, cfg)
    return MoE(cfg, dtype=dtype, device=generator.device, generator=generator, blocks=blocks)


def capacity(T: int, cfg: ArchConfig) -> int:
    c = int(math.ceil(T * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
    return max(8, -(-c // 8) * 8)  # >=8, rounded up to a multiple of 8


def takes_gather_path(T: int, cfg: ArchConfig, tp: int = 1) -> bool:
    """The reference's switch: ``T`` tokens (the global batch's) with k
    assignments each against the E/tp experts of one ``model`` rank."""
    return T * cfg.top_k <= min(GATHER_MAX_ASSIGNMENTS, cfg.n_experts // tp - 1)


def route(p: MoE, cfg: ArchConfig, xt: torch.Tensor, router: torch.Tensor | None = None):
    """xt (T, d) → (probs (T, E), weights (T, k), experts (T, k)): f32 logits
    and softmax, the top k in descending order (the order decides which of a
    token's assignments a full expert drops), the weights renormalised.
    ``router`` is the (d, E) weight to use (``p.router`` by default)."""
    probs = torch.softmax(xt.float() @ (p.router if router is None else router), dim=-1)
    w, idx = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    return probs, w / w.sum(dim=-1, keepdim=True), idx


def _combine(buf: torch.Tensor) -> torch.Tensor:
    """(T, k, d) contributions → (T, d), slot 0 first, then one add a slot."""
    out = buf[:, 0]
    for j in range(1, buf.shape[1]):
        out = out + buf[:, j]
    return out


def _gather(w_in, w_out, cfg: ArchConfig, xt, w, idx, e0: int = 0) -> torch.Tensor:
    """The gather path over the experts ``e0 .. e0 + len(w_in)`` (the stacks
    given); the other experts' assignments contribute zeros."""
    T, d = xt.shape
    f, act, n_e = cfg.d_ff, _act(cfg.act), w_in.shape[0]
    experts = idx.tolist()          # the slices are chosen on the host
    whole = n_e == cfg.n_experts
    buf = xt.new_empty((T, cfg.top_k, d)) if whole else xt.new_zeros((T, cfg.top_k, d))
    for t, row in enumerate(experts):
        for j, e in enumerate(row):
            if not 0 <= e - e0 < n_e:
                continue
            h = xt[t:t + 1] @ w_in[e - e0]
            torch.matmul(act(h[:, :f]) * h[:, f:], w_out[e - e0], out=buf[t, j:j + 1])
    return _combine(buf * w.to(xt.dtype)[..., None])


def _dispatch(w_in, w_out, cfg: ArchConfig, xt, w, idx, *, e0: int = 0, C: int | None = None,
              offset: torch.Tensor | None = None):
    """The dispatch path's output (T, d) over the experts ``e0 .. e0 +
    len(w_in)`` and the dropped assignments (T, k) over all experts.  ``C``
    is the capacity (of the global batch; ``capacity(T)`` by default) and
    ``offset`` (E,) each expert's assignments on the dp ranks before this
    one, added to the ranks within an expert before the drop."""
    T, d = xt.shape
    E, k, f, act = cfg.n_experts, cfg.top_k, cfg.d_ff, _act(cfg.act)
    n_e = w_in.shape[0]
    dev = xt.device
    C = capacity(T, cfg) if C is None else C
    Cs = min(C, T * k)               # rank < T·k always: no slot past it fills
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    starts = torch.searchsorted(se, torch.arange(E, device=dev))
    rank = torch.arange(T * k, device=dev) - starts[se]
    keep = (rank if offset is None else rank + offset[se]) < C
    # a dropped assignment, or one to another rank's expert, writes the dump
    # slot n_e·Cs, which nothing reads
    mine = keep if n_e == E else keep & (se >= e0) & (se < e0 + n_e)
    slot = torch.where(mine, (se - e0) * Cs + rank, n_e * Cs)
    table = torch.full((n_e * Cs + 1,), T, dtype=torch.int64, device=dev)
    table[slot] = order // k
    wtab = torch.zeros(n_e * Cs + 1, dtype=w.dtype, device=dev)
    wtab[slot] = w.reshape(-1)[order]
    x_pad = torch.cat([xt, xt.new_zeros((1, d))])
    xg = x_pad[table[:-1]].view(n_e, Cs, d)
    h = torch.bmm(xg, w_in)
    y = torch.bmm(act(h[..., :f]) * h[..., f:], w_out)
    y = y * wtab[:-1].view(n_e, Cs, 1).to(y.dtype)
    y_pad = torch.cat([y.view(n_e * Cs, d), y.new_zeros((1, d))])
    src = torch.empty(T * k, dtype=torch.int64, device=dev)
    src[order] = slot               # each assignment's row, in flat (t, j) order
    dropped = torch.empty(T * k, dtype=torch.bool, device=dev)
    dropped[order] = ~keep
    return _combine(y_pad[src].view(T, k, d)), dropped.view(T, k)


def _dp_offset(par, idx: torch.Tensor, E: int) -> torch.Tensor | None:
    """Each expert's assignments on the dp ranks holding earlier tokens (the
    batch's rows lie in dp rank order), from an all-gather of the counts."""
    if par is None or par.dp.size == 1:
        return None
    counts = torch.bincount(idx.reshape(-1), minlength=E)
    every = par.dp.all_gather(counts[None], dim=0)            # (dp, E)
    return every[:par.dp.index].sum(dim=0)


def moe_forward(p: MoE, cfg: ArchConfig, x: torch.Tensor, *, stats: dict | None = None,
                par=None):
    """x: (B, S, d) → (out (B, S, d) in x's dtype, aux: the Switch-style
    load-balance loss E·Σ_e me_e·ce_e, f32 0-d).

    On a mesh (``par``) x is this rank's dp rows, replicated over ``model``;
    each ``model`` rank runs its E/tp experts (and its columns of the shared
    expert), the partials summed over ``model`` once; ``me`` and ``ce`` are
    averaged over the dp ranks before their product (the global batch's
    aux).

    With a ``stats`` dict, records ``path`` ("gather" or "dispatch"),
    ``capacity`` (None on the gather path) and ``dropped`` (T, k) over this
    rank's tokens, True where an assignment was dropped; not during a remat
    recompute (:func:`recomputing`)."""
    B, S, d = x.shape
    T, E, k = B * S, cfg.n_experts, cfg.top_k
    tp = 1 if par is None else par.tp.size
    dp = 1 if par is None else par.dp.size
    if E % tp:
        raise ValueError(f"{cfg.name}: {E} experts do not split over {tp} model ranks")
    xt = x.reshape(T, d)
    probs, w, idx = route(p, cfg, xt, param(par, p.router))
    experts = par.split(E) if par is not None else None
    e0, w_in, w_out, xe, we = 0, p.w_in, p.w_out, xt, w
    if par is not None:
        ranges = None if experts is None else (lambda r: [par.part(E, r)])
        w_in = par.param(p.w_in, dim=0, ranges=ranges)
        w_out = par.param(p.w_out, dim=0, ranges=ranges)
        if experts is not None:
            e0, xe, we = experts[0], par.copy_tp(xt), par.copy_tp(w)
    gather = takes_gather_path(T * dp, cfg, tp)
    C = None if gather else capacity(T * dp, cfg)
    if gather:
        out = _gather(w_in, w_out, cfg, xe, we, idx, e0)
        dropped = torch.zeros((T, k), dtype=torch.bool, device=x.device)
    else:
        out, dropped = _dispatch(w_in, w_out, cfg, xe, we, idx, e0=e0, C=C,
                                 offset=_dp_offset(par, idx, E))
    shared = _shared(p, cfg, xt, xe, par, experts is not None) if cfg.shared_expert else None
    if shared is not None and shared[0] is not None:
        out = out + shared[0]
    if experts is not None:
        out = par.sum_tp(out)
    if shared is not None and shared[1] is not None:
        out = out + shared[1]
    me = probs.mean(dim=0)
    ce = torch.bincount(idx.reshape(-1), minlength=E).float() / (T * k)
    if dp > 1:
        n = torch.full((), dp, dtype=torch.float32, device=x.device)
        me, ce = par.sum_dp(me) / n, par.dp.sum(ce) / n
    aux = E * torch.sum(me * ce)
    if stats is not None and not _RECOMPUTING.get():
        stats.update(path="gather" if gather else "dispatch", capacity=C, dropped=dropped)
    return out.reshape(B, S, d).to(x.dtype), aux


def _shared(p: MoE, cfg: ArchConfig, xt, xe, par, partial: bool):
    """The shared expert's output as (partial, whole), one of them None:
    off a mesh, or where its ffn dim does not split over ``model`` (or the
    experts do not), whole and replicated, added after the experts' sum;
    else this rank's column/row-parallel partial, summed with theirs."""
    f_sh = p.shared_out.shape[0] if par is None else par.full_shape(p.shared_out)[0]
    part = par.split(f_sh) if partial else None
    if part is None:
        return None, glu(cfg, xt, param(par, p.shared_in), param(par, p.shared_out))
    cols, rows = glu_ranges(par, f_sh)
    w_in = par.param(p.shared_in, dim=1, ranges=cols)
    w_out = par.param(p.shared_out, dim=0, ranges=rows)
    return glu(cfg, xe, w_in, w_out), None
