"""The collectives of the sharded training step, with their gradients, and
the view of a placed parameter that a layer computes with.

The whole mesh computes one scalar loss, the same bits on every rank.
Where the forward passes from work every ``model`` rank does alike
(replicated) to work each does a part of (partitioned), the tensor goes
through :func:`copy_to` (identity forward, its gradient summed over the
axis); where partials of a partitioned computation meet, through
:func:`reduce_from` (summed forward, identity backward): Megatron's f and
g.  A weight sharded over ``data`` (FSDP) is all-gathered where it is used
(:func:`gather`, whose backward reduce-scatters the gradient to this rank's
block); one replicated over ``data`` gets its gradient summed over the dp
axes once a step (``models.steps.make_train_step``).  Every sum adds the
ranks' tensors in rank order (``launch.mesh.AxisComm``), so a replicated
value keeps the same bits on every rank.

:class:`Parallel` holds a model's mesh, its dp and tp communicators and the
layer plans: heads, the ffn dim, experts and the vocab are split over
``model`` where they divide (a module whose split does not divide runs
replicated there, as the reference's ``_divisible`` leaves its weights).
"""

from __future__ import annotations

import torch

from repro_torch.distributed.sharding import axes_of, global_shape, spec_of


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.sum(g), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm.sum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim, summed):
        ctx.comm, ctx.dim, ctx.summed, ctx.n = comm, dim, summed, x.shape[dim]
        return comm.all_gather(x, dim=dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            return ctx.comm.reduce_scatter(g, dim=ctx.dim), None, None, None
        block = g.narrow(ctx.dim, ctx.comm.index * ctx.n, ctx.n).contiguous()
        return block, None, None, None


def _overlaps(ranges, lo: int, hi: int):
    """(offset in the concatenation of ``ranges``, start, length) of each
    part of ``ranges`` inside [lo, hi), in order."""
    out, off = [], 0
    for a, n in ranges:
        s, e = max(a, lo), min(a + n, hi)
        if s < e:
            out.append((off + s - a, s, e - s))
        off += n
    return out


class _Permute(torch.autograd.Function):
    """Each rank's ``want`` (a list a rank of (start, length) ranges of the
    global dim) assembled from the ranks' contiguous blocks along ``dim``:
    one ``all_to_all`` forward, its reverse backward."""

    @staticmethod
    def forward(ctx, x, comm, dim, want):
        n, r = x.shape[dim], comm.index
        ctx.comm, ctx.dim, ctx.want, ctx.n = comm, dim, want, n
        xt = x.movedim(dim, 0)
        sends = [[(s, m) for _, s, m in _overlaps(want[q], r * n, (r + 1) * n)]
                 for q in range(comm.size)]
        buf = torch.cat([xt[s - r * n: s - r * n + m] for q in sends for s, m in q] or [xt[:0]])
        got = comm.all_to_all(buf, [sum(m for _, m in q) for q in sends],
                              [sum(m for _, _, m in _overlaps(want[r], p * n, (p + 1) * n))
                               for p in range(comm.size)])
        out = xt.new_empty((sum(m for _, m in want[r]), *xt.shape[1:]))
        row = 0
        for p in range(comm.size):
            for off, _, m in _overlaps(want[r], p * n, (p + 1) * n):
                out[off: off + m] = got[row: row + m]
                row += m
        return out.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        comm, dim, want, n = ctx.comm, ctx.dim, ctx.want, ctx.n
        r = comm.index
        gt = g.movedim(dim, 0)
        parts = [_overlaps(want[r], p * n, (p + 1) * n) for p in range(comm.size)]
        buf = torch.cat([gt[off: off + m] for q in parts for off, _, m in q] or [gt[:0]])
        sends = [[(s, m) for _, s, m in _overlaps(want[q], r * n, (r + 1) * n)]
                 for q in range(comm.size)]
        got = comm.all_to_all(buf, [sum(m for _, _, m in q) for q in parts],
                              [sum(m for _, m in q) for q in sends])
        grad = gt.new_zeros((n, *gt.shape[1:]))
        row = 0
        for q in sends:
            for s, m in q:
                grad[s - r * n: s - r * n + m] += got[row: row + m]
                row += m
        return grad.movedim(0, dim).contiguous(), None, None, None


class _RowsToColumns(torch.autograd.Function):
    """(B, ..., c) rows of every rank's batch, this rank's c columns → (B/P,
    ..., P·c) this rank's rows, every rank's columns in rank order: one
    ``all_to_all`` forward, its reverse backward."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        P, b = comm.size, x.shape[0] // comm.size
        got = comm.all_to_all(x, [b] * P, [b] * P).unflatten(0, (P, b))   # (P, b, ..., c)
        return got.movedim(0, -2).flatten(-2)

    @staticmethod
    def backward(ctx, g):
        comm = ctx.comm
        P = comm.size
        parts = g.unflatten(-1, (P, -1)).movedim(-2, 0).contiguous()       # (P, b, ..., c)
        b = parts.shape[1]
        got = comm.all_to_all(parts.flatten(0, 1), [b] * P, [b] * P)
        return got, None


def rows_to_columns(x: torch.Tensor, comm) -> torch.Tensor:
    """``_RowsToColumns``: the lookup of every rank's rows in this rank's
    columns of a table, turned into this rank's rows in every column."""
    return x if comm.size == 1 else _RowsToColumns.apply(x, comm)


def copy_to(x: torch.Tensor, comm) -> torch.Tensor:
    """f: the identity, its gradient summed over ``comm``'s ranks."""
    return x if comm.size == 1 else _CopyTo.apply(x, comm)


def reduce_from(x: torch.Tensor, comm) -> torch.Tensor:
    """g: ``x`` summed over ``comm``'s ranks, its gradient passed on as it is."""
    return x if comm.size == 1 else _ReduceFrom.apply(x, comm)


def gather(x: torch.Tensor, comm, dim: int, *, summed: bool = True) -> torch.Tensor:
    """The blocks of ``comm``'s ranks concatenated along ``dim``.  Its
    backward gives this rank's block of the gradient: summed over the ranks
    (``summed``: each used the whole for a different part of the work, the
    FSDP gather) or its own (each computed the same thing with it)."""
    return x if comm.size == 1 else _Gather.apply(x, comm, dim, summed)


class Parallel:
    """A model's mesh as the layers use it: ``dp``/``tp`` the communicators
    over the dp axes and the tensor axis, ``tp_rank`` this rank's place on
    the latter.  Every method is the identity where its axis has one rank,
    so a (1, 1) mesh computes the one-device step's bits."""

    def __init__(self, mesh, dp_axes: tuple[str, ...], tp_axis: str):
        if tp_axis in dp_axes:
            raise NotImplementedError(
                f"the tensor axis {tp_axis!r} among the dp axes {dp_axes} (the reference's "
                f"pure-FSDP profile) is not ported: pass dp_axes without it")
        self.mesh, self.dp_axes, self.tp_axis = mesh, tuple(dp_axes), tp_axis
        self.dp = mesh.axis_comm(self.dp_axes)
        self.tp = mesh.axis_comm(tp_axis)
        self.tp_rank = self.tp.index

    # -- activations ------------------------------------------------------------

    def copy_tp(self, x):
        return copy_to(x, self.tp)

    def sum_tp(self, x):
        return reduce_from(x, self.tp)

    def sum_dp(self, x):
        return reduce_from(x, self.dp)

    def split(self, n: int) -> tuple[int, int] | None:
        """(first, count) of this rank's share of ``n`` things split over
        the tensor axis, or None where they stay whole (one rank, or ``n``
        does not divide)."""
        tp = self.tp.size
        if tp == 1 or n % tp:
            return None
        return self.tp_rank * (n // tp), n // tp

    def rows(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's dp block of ``x``'s rows along ``dim``."""
        n = self.dp.size
        if n == 1:
            return x
        b = x.shape[dim]
        if b % n:
            raise ValueError(f"a batch of {b} rows does not split over {n} dp ranks")
        return x.narrow(dim, self.dp.index * (b // n), b // n)

    # -- parameters ------------------------------------------------------------

    def full_shape(self, p: torch.Tensor) -> tuple[int, ...]:
        return global_shape(p.shape, spec_of(p), self.mesh.shape)

    def param(self, p: torch.Tensor, *, dim: int | None = None, ranges=None,
              partitioned: bool = False) -> torch.Tensor:
        """The tensor the layer computes with from the placed parameter
        ``p``: gathered over the dp axes where it is sharded there (FSDP),
        then over ``model`` the whole tensor (``ranges`` None) or the
        concatenation of ``ranges(r)`` for this rank r, each (start, length)
        along ``dim`` in global indices (``ranges`` a function of the
        ``model`` rank: where ``p`` is split along ``dim`` and a rank wants
        more than its own block, the blocks move by one ``all_to_all``).
        ``partitioned``: the computation that uses the view is a different
        part of the work on each ``model`` rank, so its gradient is summed
        over them (a part taken by ``ranges`` always is); otherwise each
        rank's gradient is the whole one."""
        x, sm = p, None
        for d, entry in enumerate(spec_of(p)):
            axes = axes_of(entry)
            if self.tp_axis in axes:
                sm = d
            dp_here = tuple(a for a in axes if a in self.dp_axes)
            if dp_here:
                x = gather(x, self.mesh.axis_comm(dp_here), d)
        if ranges is None:
            if sm is not None:
                return gather(x, self.tp, sm, summed=partitioned)
            return copy_to(x, self.tp) if partitioned else x
        mine = ranges(self.tp_rank)
        if sm is None:
            x = copy_to(x, self.tp)
        elif sm == dim:
            n = x.shape[sm]
            if mine == [(self.tp_rank * n, n)]:
                return x                                 # this rank's own block
            if self.tp.size > 1:
                return _Permute.apply(x, self.tp, dim, [ranges(r) for r in range(self.tp.size)])
        else:
            x = gather(x, self.tp, sm)
        parts = [x.narrow(dim, a, n) for a, n in mine]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)

    def part(self, n: int, rank: int) -> tuple[int, int]:
        """(first, count) of ``model`` rank ``rank``'s share of ``n``."""
        share = n // self.tp.size
        return rank * share, share


def param(par: Parallel | None, p: torch.Tensor, **kw) -> torch.Tensor:
    """``par.param(p, **kw)``, or ``p`` itself off a mesh."""
    return p if par is None else par.param(p, **kw)
