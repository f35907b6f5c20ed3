"""The mesh of ranks the distributed solve runs on (counterpart of
``repro/launch/mesh.py``).

A *rank* is one process of a ``torch.distributed`` process group and holds
one local block of the grid; the reference's device of a ``jax.sharding.Mesh``
becomes a rank.  :class:`Mesh` is the port's own small mesh: the axis names
and shape, the process group, and this rank's coordinates in row-major rank
order.  It is not ``torch.distributed.device_mesh.DeviceMesh``, which
assumes one device a rank: under ``gloo`` several ranks may share one card.

A mesh of one rank needs no process group: its collectives are the identity
(:class:`LocalComm`), so ``layout="1d"`` in a single process is the
reference's mesh of one device.  A mesh of more ranks runs on a group
(:class:`GroupComm`): ``nccl`` on CUDA, ``gloo`` on the CPU or, with several
ranks on one card, on CUDA tensors staged through pinned host buffers (gloo's
point-to-point calls take CPU tensors only).  The staging is explicit and
counted (``GroupComm.staged``); NCCL never stages.  Nothing switches
backends by itself.

``make_solver_mesh``, ``make_mesh_for_devices`` and ``make_production_mesh``
are the reference's builders, with "devices" read as "ranks of the default
group".  :class:`RecordingComm` counts a mesh's collectives and halo
exchanges and logs every start and wait in issue order (``Mesh.record()``).

Every collective can be in flight: ``all_gather_start`` and ``exchange``
return a handle whose ``wait()`` finishes it, so a solver step issues the
work that does not depend on a reduction between its start and its wait
(the paper's nonblocking ``MPI_Iallreduce``).  ``all_gather`` is the start
waited at once.  A start that fails raises; nothing falls back to the
blocking form.
"""

from __future__ import annotations

import contextlib
import itertools
import math
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.core.methods import Ready

#: the backends a mesh's process group may run
BACKENDS = ("nccl", "gloo")


def default_backend(device) -> str:
    """``nccl`` on CUDA, ``gloo`` on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_backend(backend: str, world: int) -> None:
    """Refuse an NCCL group with more ranks than this host has cards: NCCL
    takes one card a rank (several ranks on one card need ``gloo``)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; options: {BACKENDS}")
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if world > cards:
            raise RuntimeError(
                f"backend 'nccl' takes one card a rank, but the group has {world} "
                f"ranks and this host {cards} card(s); run several ranks on one "
                f"card under backend='gloo'")


class LocalComm:
    """The collectives of a one-rank mesh: the identity."""

    backend = None
    staged = {"calls": 0, "bytes": 0}

    def all_gather_start(self, t: torch.Tensor) -> Ready:
        return Ready(t.unsqueeze(0))

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return t.unsqueeze(0)

    def exchange(self, sends, recvs):
        raise RuntimeError("a mesh of one rank has no neighbour to exchange with")

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        return t

    def barrier(self) -> None:
        pass


class _Pending:
    """Started point-to-point transfers; :meth:`wait` finishes them (and
    copies staged receives onto the card)."""

    def __init__(self, works, copies):
        self.works, self.copies = works, copies

    def wait(self) -> None:
        for w in self.works:
            w.wait()
        for dst, src in self.copies:
            dst.copy_(src)


class _Gather:
    """A started ``all_gather``; :meth:`wait` finishes it and gives the
    ``(P, k)`` stack on the input's device (copied back onto the card when
    it was staged).  ``out`` is the list of gathered tensors or, under
    NCCL, the ``(P, k)`` tensor gathered into.  The input and the output
    buffers stay referenced until then: the collective reads and writes
    them while it is in flight."""

    def __init__(self, work, out, src, device):
        self.work, self.out, self.src, self.device = work, out, src, device
        self.value = None

    def wait(self) -> torch.Tensor:
        if self.value is None:
            self.work.wait()
            out = torch.stack(self.out) if isinstance(self.out, list) else self.out
            self.value = out.to(self.device)
            self.work = self.out = self.src = None
        return self.value


class GroupComm:
    """The collectives of a mesh on a ``torch.distributed`` process group.

    ``all_gather_start`` starts the stacking of every rank's 1-D tensor into
    ``(P, k)`` (one collective, ``async_op=True``) and returns the handle to
    ``wait()`` on; ``exchange`` starts one ``batch_isend_irecv`` of the given
    sends and receives (``(peer, tensor)`` pairs, ``peer`` a group rank) and
    returns a handle to ``wait()`` on.  Under ``gloo`` CUDA tensors travel
    through pinned host buffers, counted in ``staged``.  Under ``nccl`` the
    gather lands in one ``(P, k)`` tensor (``all_gather_into_tensor``),
    which a CUDA graph can capture: allocated on the capturing stream, it
    comes from the graph's pool, and the handle's ``wait()`` joins NCCL's
    stream back into the capture.
    """

    def __init__(self, group=None):
        self.group = group
        self.backend = dist.get_backend(group)
        self.staged = {"calls": 0, "bytes": 0}

    def _stage(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self.staged["calls"] += 1
        self.staged["bytes"] += t.numel() * t.element_size()
        return buf

    def _peer(self, rank: int) -> int:
        return rank if self.group is None else dist.get_global_rank(self.group, rank)

    def all_gather_start(self, t: torch.Tensor) -> _Gather:
        src = self._host(t).copy_(t) if self._stage(t) else t
        world = dist.get_world_size(self.group)
        if self.backend == "nccl":
            src = src.contiguous()
            out = src.new_empty((world, *src.shape))
            work = dist.all_gather_into_tensor(out, src, group=self.group, async_op=True)
            return _Gather(work, out, src, t.device)
        out = [torch.empty_like(src) for _ in range(world)]
        work = dist.all_gather(out, src, group=self.group, async_op=True)
        return _Gather(work, out, src, t.device)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return self.all_gather_start(t).wait()

    def exchange(self, sends: Sequence, recvs: Sequence) -> _Pending:
        p2p, copies = [], []
        for peer, t in sends:
            src = self._host(t).copy_(t) if self._stage(t) else t
            p2p.append(dist.P2POp(dist.isend, src, self._peer(peer), group=self.group))
        for peer, t in recvs:
            dst = t
            if self._stage(t):
                dst = self._host(t)
                copies.append((t, dst))
            p2p.append(dist.P2POp(dist.irecv, dst, self._peer(peer), group=self.group))
        works = dist.batch_isend_irecv(p2p) if p2p else []
        return _Pending(works, copies)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        buf = self._host(t).copy_(t) if self._stage(t) else t
        dist.broadcast(buf, self._peer(src), group=self.group)
        if buf is not t:
            t.copy_(buf)
        return t

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Recorded:
    """A recorded collective's handle: its wait is logged (once) before the
    inner handle's, so the work the inner wait does (the staged copy back,
    the stack) falls after it in the log."""

    def __init__(self, log: list, op: str, ident: int, handle):
        self.log, self.op, self.ident, self.handle = log, op, ident, handle
        self.waited = False

    def wait(self):
        if not self.waited:
            self.waited = True
            self.log.append({"event": "wait", "op": self.op, "id": self.ident})
        return self.handle.wait()


class RecordingComm:
    """A mesh's comm that counts its calls by name (``all_gather``: one
    global reduction; ``exchange``: one split dim's halo swap), delegates
    them, and logs each start and each wait in issue order into ``events``
    (a list it may share with ``analysis.oplog.OpLog``): the building block
    of the collective audit.  A start is logged after the inner start
    returns and a wait before the inner wait runs, so the staging the comm
    does itself lies outside every window.  A start's entry carries the
    payload bytes this rank sends (``bytes``) and, for a halo swap, the
    bytes of one boundary plane (``plane``)."""

    def __init__(self, inner, events: list | None = None):
        self.inner = inner
        self.counts = {"all_gather": 0, "exchange": 0, "broadcast": 0}
        self.events = [] if events is None else events
        self._ids = itertools.count()

    def _started(self, op: str, handle, nbytes: int, plane: int = 0) -> _Recorded:
        self.counts[op] += 1
        ident = next(self._ids)
        self.events.append({"event": "start", "op": op, "id": ident, "bytes": nbytes,
                            "plane": plane})
        return _Recorded(self.events, op, ident, handle)

    @property
    def backend(self):
        return self.inner.backend

    @property
    def staged(self):
        return self.inner.staged

    def all_gather_start(self, t) -> _Recorded:
        return self._started("all_gather", self.inner.all_gather_start(t), _nbytes(t))

    def all_gather(self, t):
        return self.all_gather_start(t).wait()

    def exchange(self, sends, recvs) -> _Recorded:
        sizes = [_nbytes(t) for _, t in sends]
        return self._started("exchange", self.inner.exchange(sends, recvs), sum(sizes),
                             max(sizes, default=0))

    def broadcast(self, t, src: int = 0):
        out = self.inner.broadcast(t, src)
        self._started("broadcast", Ready(out), _nbytes(t)).wait()
        return out

    def barrier(self) -> None:
        self.inner.barrier()


class LocalAxisComm:
    """The collectives over an axis of one rank: the identity."""

    size, index, backend = 1, 0, None
    staged = {"calls": 0, "bytes": 0}

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return t

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def reduce_scatter(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return t


#: under gloo a CUDA tensor larger than this crosses the host in pieces of
#: about this size (bytes), so the pinned buffers and the device's
#: temporaries stay small whatever the tensor (an expert stack is GBs)
STAGE_CHUNK = 1 << 26


def _pieces(t: torch.Tensor, dim: int, chunk: int):
    """(axis, start, length) pieces of ``t`` along its outermost axis other
    than ``dim`` (``dim`` itself for a 1-D tensor), each about ``chunk``
    bytes or one slice of that axis; None where ``t`` is one piece."""
    nbytes = t.numel() * t.element_size()
    if nbytes <= chunk or t.dim() < 2:
        return None
    c = next(i for i in range(t.dim()) if i != dim)
    step = max(1, chunk // max(nbytes // t.shape[c], 1))
    return [(c, a, min(step, t.shape[c] - a)) for a in range(0, t.shape[c], step)]


class AxisComm:
    """The collectives over one axis (or several) of a mesh: the group of
    the ranks that share every other coordinate, in row-major order of the
    axes (``index`` is this rank's place in it).

    ``all_gather`` concatenates every rank's tensor along ``dim`` in that
    order; ``sum`` adds the ranks' tensors in that order, one add after
    another (the solver's convention: the same bits on every rank and in
    every run, no atomics); ``max`` takes the elementwise largest;
    ``reduce_scatter`` cuts ``dim`` into ``size`` blocks and gives this rank
    its block summed over the ranks in that order (one ``all_to_all``);
    ``all_to_all`` moves rows between the ranks.  Under ``gloo`` a CUDA tensor travels through pinned host buffers,
    counted in ``staged``, in pieces of about ``STAGE_CHUNK`` bytes (the
    arithmetic is elementwise, so the pieces give the same bits); under
    ``nccl`` nothing is staged.  Nothing falls back from one backend to the
    other."""

    def __init__(self, group, ranks: list[int], index: int):
        self.group, self.ranks, self.index = group, ranks, index
        self.size = len(ranks)
        self.backend = dist.get_backend(group)
        self.staged = {"calls": 0, "bytes": 0}

    def _host(self, shape, dtype) -> torch.Tensor:
        buf = torch.empty(shape, dtype=dtype, pin_memory=True)
        self.staged["calls"] += 1
        self.staged["bytes"] += buf.numel() * buf.element_size()
        return buf

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def _split(self, t: torch.Tensor, dim: int):
        return _pieces(t, dim, STAGE_CHUNK) if self._staged(t) else None

    def _parts(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t``, in rank order (host buffers when staged)."""
        src = t.contiguous()
        if self._staged(t):
            src = self._host(t.shape, t.dtype).copy_(src)
        if self.backend == "nccl":
            out = src.new_empty((self.size, *src.shape))
            dist.all_gather_into_tensor(out, src, group=self.group)
            return list(out.unbind(0))
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return parts

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        n = t.shape[dim]
        shape = list(t.shape)
        shape[dim] = n * self.size
        out = t.new_empty(shape)
        pieces = self._split(t, dim)
        if pieces is None:
            for i, part in enumerate(self._parts(t)):
                out.narrow(dim, i * n, n).copy_(part)
            return out
        for c, a, m in pieces:                     # c is never dim
            for i, part in enumerate(self._parts(t.narrow(c, a, m))):
                out.narrow(c, a, m).narrow(dim, i * n, n).copy_(part)
        return out

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        """``op`` over the ranks' tensors in rank order, elementwise."""
        flat = t.contiguous().view(-1)
        step = max(1, STAGE_CHUNK // t.element_size()) if self._staged(t) else flat.numel()
        out = torch.empty_like(flat)
        for a in range(0, flat.numel(), step):
            parts = self._parts(flat[a:a + step])
            acc = parts[0].to(t.device)
            for i in range(1, self.size):
                acc = op(acc, parts[i].to(t.device))
            out[a:a + step].copy_(acc)
        return out.view(t.shape)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        if t.numel() == 0:
            return t.clone()
        return self._reduce(t, torch.add)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        if t.numel() == 0:
            return t.clone()
        return self._reduce(t, torch.maximum)

    def reduce_scatter(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        if t.shape[dim] % self.size:
            raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} does not split "
                             f"over {self.size} ranks")
        pieces = self._split(t, dim)
        if pieces is None:
            return self._reduce_scatter(t, dim)
        block = list(t.shape)
        block[dim] = t.shape[dim] // self.size
        out = t.new_empty(block)
        for c, a, m in pieces:                     # c is never dim
            out.narrow(c, a, m).copy_(self._reduce_scatter(t.narrow(c, a, m), dim))
        return out

    def all_to_all(self, t: torch.Tensor, send: list[int], recv: list[int]) -> torch.Tensor:
        """Rows of ``t`` to the ranks: the first ``send[0]`` rows to rank 0,
        the next ``send[1]`` to rank 1, ...; returns the rows received,
        ``recv[i]`` from rank i, in rank order (one ``all_to_all``)."""
        src = t.contiguous()
        if self._staged(t):
            src = self._host(t.shape, t.dtype).copy_(src)
        out = src.new_empty((sum(recv), *t.shape[1:]))
        dist.all_to_all_single(out, src, output_split_sizes=list(recv),
                               input_split_sizes=list(send), group=self.group)
        return out.to(t.device)

    def _reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        n = t.shape[dim] // self.size
        block = list(t.shape)
        block[dim] = n
        # the send buffer: the block for rank i at i (on the host when staged)
        if self._staged(t):
            src = self._host((self.size, *block), t.dtype)
        else:
            src = t.new_empty((self.size, *block))
        for i in range(self.size):
            src[i].copy_(t.narrow(dim, i * n, n))
        recv = torch.empty_like(src)
        dist.all_to_all_single(recv, src, group=self.group)
        acc = recv[0].to(t.device)
        for i in range(1, self.size):
            acc = acc + recv[i].to(t.device)       # the sum in rank order
        return acc


class Mesh:
    """A row-major mesh of the ranks of a process group.

    ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh.shape``
    does; ``coords`` are this rank's coordinates.  ``group`` is the process
    group (``None``: the default group, required once the mesh has more than
    one rank); a one-rank mesh built with ``group=None`` and no default
    group has no process group at all and collectives that are the identity.
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *, group=None):
        shape = tuple(int(n) for n in shape)
        self.axis_names = tuple(axis_names)
        if len(shape) != len(self.axis_names) or min(shape, default=0) < 1:
            raise ValueError(f"mesh shape {shape} does not fit axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, shape))
        self.size = math.prod(shape)
        self.group = group
        grouped = group is not None or (dist.is_available() and dist.is_initialized())
        if not grouped:
            if self.size != 1:
                raise RuntimeError(
                    f"a mesh of {self.size} ranks runs on a torch.distributed process "
                    f"group: call torch.distributed.init_process_group first")
            self.rank, self.comm = 0, LocalComm()
        else:
            world = dist.get_world_size(group)
            if world != self.size:
                raise ValueError(f"mesh {self.shape} has {self.size} ranks but its "
                                 f"process group {world}")
            check_backend(dist.get_backend(group), world)
            self.rank, self.comm = dist.get_rank(group), GroupComm(group)
        self.coords = _unravel(self.rank, shape)
        self._axis_comms: dict = {}

    @classmethod
    def from_default_group(cls, shape: Sequence[int] | None = None,
                           axis_names: Sequence[str] = ("cells",)) -> "Mesh":
        """A mesh over the default group (``shape`` defaults to every rank
        on one axis)."""
        n = dist.get_world_size()
        return cls(tuple(shape) if shape is not None else (n,), axis_names)

    @classmethod
    def one_rank(cls, axis_names: Sequence[str] = ("cells",)) -> "Mesh":
        """The mesh of this process alone, on no process group."""
        mesh = cls.__new__(cls)
        mesh.axis_names = tuple(axis_names)
        mesh.shape = dict.fromkeys(mesh.axis_names, 1)
        mesh.size, mesh.group, mesh.rank = 1, None, 0
        mesh.comm = LocalComm()
        mesh.coords = (0,) * len(mesh.axis_names)
        mesh._axis_comms = {}
        return mesh

    @property
    def backend(self) -> str | None:
        """The group's backend (None: no group)."""
        return self.comm.backend

    def coords_of(self, rank: int) -> tuple[int, ...]:
        """The mesh coordinates of group rank ``rank`` (row-major)."""
        return _unravel(rank, tuple(self.shape.values()))

    def neighbour(self, axis: str, step: int) -> int | None:
        """The group rank ``step`` along ``axis`` from this one (None off the
        mesh's end: the ends of a split dim have one neighbour)."""
        i = self.axis_names.index(axis)
        c = list(self.coords)
        c[i] += step
        if not 0 <= c[i] < self.shape[axis]:
            return None
        return _ravel(c, tuple(self.shape.values()))

    def peers(self, axes: Sequence[str]) -> list[int]:
        """The ranks, in rank order, that differ from this one only along
        ``axes``: the ranks a reduction over ``axes`` sums."""
        keep = [i for i, a in enumerate(self.axis_names) if a not in axes]
        return [r for r in range(self.size)
                if all(self.coords_of(r)[i] == self.coords[i] for i in keep)]

    def axis_comm(self, axes) -> "AxisComm | LocalAxisComm":
        """The collectives over ``axes`` (an axis name or a tuple of them):
        the group of the ranks that differ from this one only along them.

        The first call for a set of axes makes a ``dist.new_group`` for
        every such group of the mesh, in row-major order of the other
        coordinates: ``new_group`` is collective over the default group, so
        every rank makes every group, in the same order (every rank calls
        ``axis_comm`` at the same point of the program).  A one-rank axis
        needs no group."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.axis_names]
        if unknown:
            raise ValueError(f"axes {unknown} are not axes of the mesh {self.axis_names}")
        if axes not in self._axis_comms:
            if math.prod(self.shape[a] for a in axes) == 1:
                self._axis_comms[axes] = LocalAxisComm()
            else:
                self._axis_comms[axes] = self._new_axis_groups(axes)
        return self._axis_comms[axes]

    def _new_axis_groups(self, axes: tuple[str, ...]) -> AxisComm:
        shape = tuple(self.shape.values())
        inner = [self.axis_names.index(a) for a in axes]
        outer = [i for i in range(len(shape)) if i not in inner]
        mine = None
        for fixed in itertools.product(*(range(shape[i]) for i in outer)):
            ranks = []
            for free in itertools.product(*(range(shape[i]) for i in inner)):
                c = [0] * len(shape)
                for i, v in zip(outer, fixed):
                    c[i] = v
                for i, v in zip(inner, free):
                    c[i] = v
                ranks.append(_ravel(c, shape))
            glob = [r if self.group is None else dist.get_global_rank(self.group, r)
                    for r in ranks]
            group = dist.new_group(glob)
            if self.rank in ranks:
                mine = AxisComm(group, ranks, ranks.index(self.rank))
        return mine

    def staged_bytes(self) -> int:
        """Bytes this rank has staged through host buffers, over the mesh's
        comm and its axis comms."""
        return self.comm.staged["bytes"] + sum(c.staged["bytes"]
                                               for c in self._axis_comms.values())

    @contextlib.contextmanager
    def record(self, events: list | None = None):
        """Count and log this mesh's collectives inside the block: yields
        the :class:`RecordingComm` (its ``counts`` and ``events``; pass
        ``events`` to log into a list shared with an op log).  The mesh's
        comm is restored on exit, whatever the block set it to."""
        inner = self.comm
        self.comm = RecordingComm(inner, events)
        try:
            yield self.comm
        finally:
            self.comm = inner

    def describe(self) -> str:
        return ",".join(f"{a}={n}" for a, n in self.shape.items())

    def __repr__(self) -> str:
        return (f"Mesh({self.describe()}, rank={self.rank}, coords={self.coords}, "
                f"backend={self.backend})")


def _unravel(rank: int, shape: tuple[int, ...]) -> tuple[int, ...]:
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def _ravel(coords: Sequence[int], shape: tuple[int, ...]) -> int:
    r = 0
    for c, n in zip(coords, shape):
        r = r * n + c
    return r


def _world(n: int | None) -> int:
    if n is not None:
        return n
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _make(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    if math.prod(shape) == 1 and not (dist.is_available() and dist.is_initialized()):
        return Mesh.one_rank(axes)
    return Mesh.from_default_group(shape, axes)


def make_production_mesh(*, multi_pod: bool = False) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """The reference's production mesh as (shape, axis names) only: 16×16
    ``data``×``model`` (or 2×16×16 with a ``pod`` axis); a mesh of that many
    ranks is built with :class:`Mesh` on a group that size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def make_mesh_for_devices(n: int | None = None, *, model: int | None = None) -> Mesh:
    """``data``×``model`` over the default group's ``n`` ranks, the model
    axis the largest of 16, 8, 4, 2, 1 that divides ``n``."""
    n = _world(n)
    model = model or next(m for m in (16, 8, 4, 2, 1) if n % m == 0)
    return _make((n // model, model), ("data", "model"))


def make_solver_mesh(n: int | None = None) -> Mesh:
    """The 1-D ``cells`` mesh of the paper-faithful HPCCG layout (z split)
    over the default group's ``n`` ranks."""
    return _make((_world(n),), ("cells",))
