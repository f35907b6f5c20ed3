"""The distributed solve: the paper's MPI decomposition on a
``torch.distributed`` process group (counterpart of
``repro/core/distributed.py``).

The paper decomposes the 3-D grid across MPI ranks (HPCCG splits only the
last dimension), swaps boundary planes point to point
(``exchange_externals``) and reduces with ``MPI_Allreduce``.  Here a rank is
one process of a process group holding one local block; a
:class:`GridLayout` maps the grid dims to the axes of a
:class:`repro_torch.launch.mesh.Mesh`; halos travel by
``batch_isend_irecv`` (one per split dim, up to the next rank and down to the
previous one); every global reduction is ONE collective, an ``all_gather`` of
the stacked local partials summed in rank order, so each rank holds bitwise
the same scalar and every rank stops on the same iteration.  A reduction can
be in flight (``dotn_start``/``sum_partials_start``: the paper's
``MPI_Iallreduce``), so a method step issues its independent work between
the start and the ``wait()``.  The solve is the
method's ``MethodDef`` run by ``run_method`` over a :class:`DistributedOp`,
the definition the local path runs.

Faithful mode: the 1-D z split over the ``cells`` axis (the paper's HPCCG
layout).  Beyond it: the ``data``×``model`` and ``pod``×``data``×``model``
layouts.  In the ``(nx, ny, nz)`` row-major layout z is the contiguous axis,
so a z face is ``nx·ny`` elements at stride ``nz``: it is packed contiguous
before its send and the received buffer lands in the halo slot.

Dimension-ordered exchange: each dim's slabs span the padded extent of the
dims before it, so later exchanges forward earlier halos and the 27-point
stencil's edge and corner neighbours arrive with one exchange per split dim
and direction.

A batch of lanes (the batched solve: ``(B, *block)``, the grid the last
three axes) goes through the same operator: each split dim's swap carries
the ``(B, …)`` plane slab of every lane in one message (the single step's
swaps, B× the bytes), and a reduction stacks the ``(k, B)`` partials into
one ``all_gather`` summed in rank order lane by lane, each lane's partial
its own ``torch.dot``, so every lane's scalars are bitwise those of its
single mesh solve and every rank masks and stops its lanes alike.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.methods import Ops, SolveResult, _default_dot, get_method, run_method
from repro_torch.core.operators import Stencil, interior_matvec, pad1, shell_assemble
from repro_torch.core.problems import HPCGProblem
from repro_torch.launch.mesh import Mesh

#: halo-exchange strategies of the distributed operator ("auto" resolves to
#: "concat" here; repro_torch.api.backend upgrades it to "overlap" where safe)
HALO_MODES = ("auto", "scatter", "concat", "overlap")


@dataclasses.dataclass(frozen=True)
class GridLayout:
    """Maps grid dims (x, y, z) to mesh axis names (or None = not split)."""

    mesh: Mesh
    dim_axes: tuple[str | None, str | None, str | None]

    def __post_init__(self):
        for a in self.dim_axes:
            if a is not None and a not in self.mesh.axis_names:
                raise ValueError(f"axis {a!r} not in mesh {self.mesh.axis_names}")

    @property
    def reduce_axes(self) -> tuple[str, ...]:
        return tuple(a for a in self.dim_axes if a is not None)

    def axis_size(self, d: int) -> int:
        a = self.dim_axes[d]
        return 1 if a is None else self.mesh.shape[a]

    @property
    def split_dims(self) -> tuple[int, ...]:
        """Grid dims actually decomposed (mapped to a mesh axis of size > 1)."""
        return tuple(d for d in range(3) if self.axis_size(d) > 1)

    def local_shape(self, global_shape: tuple[int, int, int]) -> tuple[int, int, int]:
        out = []
        for d, g in enumerate(global_shape):
            n = self.axis_size(d)
            if g % n:
                raise ValueError(f"grid dim {d} ({g}) not divisible by mesh axis ({n})")
            out.append(g // n)
        return tuple(out)

    def slices(self, global_shape: tuple[int, int, int],
               coords: tuple[int, ...] | None = None) -> tuple[slice, ...]:
        """The block of a global array held by the rank at mesh ``coords``
        (default: this rank)."""
        coords = self.mesh.coords if coords is None else coords
        local = self.local_shape(global_shape)
        out = []
        for d, n in enumerate(local):
            a = self.dim_axes[d]
            c = 0 if a is None else coords[self.mesh.axis_names.index(a)]
            out.append(slice(c * n, (c + 1) * n))
        return tuple(out)

    def block(self, x: torch.Tensor, global_shape: tuple[int, int, int]) -> torch.Tensor:
        """This rank's block of ``x``, contiguous: ``x`` is the global array
        (every rank passes it, as the reference's callers pass a global
        ``jax.Array``) or already this rank's block; a leading lane axis
        (``(B, *grid)``, a batch) passes through."""
        lanes, shape = tuple(x.shape[:-3]), tuple(x.shape[-3:])
        if x.dim() in (3, 4) and shape == self.local_shape(global_shape):
            return x.contiguous()
        if x.dim() in (3, 4) and shape == tuple(global_shape):
            return x[(Ellipsis, *self.slices(tuple(global_shape)))].contiguous()
        raise ValueError(f"array shape {tuple(x.shape)} is neither the global grid "
                         f"{tuple(global_shape)} nor this rank's block "
                         f"{self.local_shape(global_shape)}"
                         f"{' (after the lane axis)' if lanes else ''}")


class DistributedOp:
    """Stencil operator on a rank's local block, on the mesh's process group.

    Protocol-compatible with ``solvers.LocalOp``: the solver code is the
    same in both worlds.  ``pad_exchange`` makes the halo from the
    neighbours' planes (``scatter``: pad, then copy the received planes into
    the halo; ``concat``: the received or zero planes concatenated dim by
    dim); ``matvec`` under ``overlap`` issues the first split dim's sends and
    receives, applies the stencil to the interior while they are in flight,
    waits, then finishes the boundary shell (the task-based split of the
    paper's Fig. 1).  All three modes give bitwise the same result.
    ``dot``/``dotn``/``dot2``/``sum_partials`` are each one collective,
    started and waited at once; ``dotn_start``/``sum_partials_start`` return
    it in flight.  A 4-D operand is a batch of lanes ``(B, *block)``: the
    halos and the stencil act on the last three axes, and a dot is each
    lane's own, ``(B, 1, 1, 1)``.
    """

    def __init__(self, stencil: Stencil, layout: GridLayout,
                 matvec_padded: Callable | None = None,
                 halo_mode: str = "auto"):
        self.stencil = stencil
        self.layout = layout
        self.mesh = layout.mesh
        # the slice-add form for both stencils: the port has no convolution
        # form (the reference's 27pt choice), and conv3d is a library call
        self._mv_padded = matvec_padded or stencil.matvec_padded
        if halo_mode not in HALO_MODES:
            raise ValueError(
                f"unknown halo_mode {halo_mode!r}; options: {HALO_MODES}")
        if halo_mode == "auto":
            halo_mode = "concat"
        self.halo_mode = halo_mode
        self._peers = self.mesh.peers(layout.reduce_axes)

    @property
    def diag(self) -> float:
        return self.stencil.diag

    @property
    def split_dims(self) -> tuple[int, ...]:
        return self.layout.split_dims

    # --- halo exchange (the paper's exchange_externals) ----------------------
    def _start(self, xp: torch.Tensor, d: int, lo_at: int, hi_at: int):
        """Start dim ``d``'s swap: my plane ``hi_at`` up to the next rank
        (its lower halo) and my plane ``lo_at`` down to the previous one (its
        upper halo).  Returns the receive buffers (zeros where a side has no
        neighbour) and the pending transfers.  Grid dim ``d`` is tensor dim
        ``d - 3``, so a batch's planes carry every lane."""
        axis = self.layout.dim_axes[d]
        down, up = self.mesh.neighbour(axis, -1), self.mesh.neighbour(axis, +1)
        shape = list(xp.shape)
        shape[d - 3] = 1
        sends, recvs, bufs = [], [], []
        for peer, plane in ((up, hi_at), (down, lo_at)):
            if peer is not None:
                sends.append((peer, xp.narrow(d - 3, plane, 1).contiguous()))
        for peer in (down, up):
            if peer is None:
                bufs.append(xp.new_zeros(shape))
            else:
                bufs.append(xp.new_empty(shape))
                recvs.append((peer, bufs[-1]))
        return bufs, self.mesh.comm.exchange(sends, recvs)

    def pad_exchange(self, x: torch.Tensor) -> torch.Tensor:
        if self.halo_mode == "scatter":
            return self._pad_exchange_scatter(x)
        return self._pad_exchange_concat(x)

    def _pad_exchange_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """Zero-pad, then copy the received planes into the halos."""
        xp = pad1(x)
        for d in self.split_dims:
            n = xp.shape[d - 3]
            (lo, hi), pending = self._start(xp, d, 1, n - 2)
            pending.wait()
            xp.narrow(d - 3, 0, 1).copy_(lo)
            xp.narrow(d - 3, n - 1, 1).copy_(hi)
        return xp

    def _pad_exchange_concat(self, x: torch.Tensor, during: Callable | None = None):
        """The padded array by per-dim concatenation of the received (or
        zero) planes.  Later dims' slabs span the already-extended extents,
        so 27-pt corner neighbours arrive as in the scatter form.  With
        ``during``, it runs while the first split dim's planes are in flight
        and ``(xp, during())`` is returned."""
        split = self.split_dims
        xp, out = x, None
        for d in range(3):
            if d not in split:
                shape = list(xp.shape)
                shape[d - 3] = 1
                zero = xp.new_zeros(shape)
                xp = torch.cat([zero, xp, zero], dim=d - 3)
                continue
            (lo, hi), pending = self._start(xp, d, 0, xp.shape[d - 3] - 1)
            if during is not None and d == split[0]:
                out = during()
            pending.wait()
            xp = torch.cat([lo, xp, hi], dim=d - 3)
        return xp if during is None else (xp, out)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        if self.halo_mode == "overlap":
            return self._matvec_overlap(x)
        return self._mv_padded(self.pad_exchange(x))

    def matvec_local(self, x: torch.Tensor) -> torch.Tensor:
        """Zero-halo apply on the local block only, with no communication:
        the block-diagonal operator of the block-Jacobi preconditioner
        (decomposed faces treated as physical boundary)."""
        return self._mv_padded(pad1(x))

    def _matvec_overlap(self, x: torch.Tensor) -> torch.Tensor:
        """The overlapped SpMV: the interior (every output cell at distance
        ≥ 1 from a decomposed face) depends only on ``x``, so it runs while
        the first split dim's planes are in flight; only the boundary shell
        reads the received planes.  Bitwise the concat/scatter modes."""
        split = self.split_dims
        if not split or min(x.shape[d - 3] for d in split) < 2:
            # nothing decomposed (or one-plane blocks: no interior)
            return self._mv_padded(self._pad_exchange_concat(x))
        xp, y_int = self._pad_exchange_concat(
            x, during=lambda: interior_matvec(self._mv_padded, x, split))
        return shell_assemble(self._mv_padded, xp, y_int, split)

    # --- global reductions (the paper's MPI_Allreduce) -----------------------
    def sum_partials_start(self, *vals) -> "_PartialSums":
        """Start the global reduction of local partial scalars in ONE
        collective: the stacked partials of every rank gathered into
        ``(P, k)``; the handle's ``wait()`` sums them in rank order over the
        ranks the layout reduces across, so every rank gets the same bits,
        run after run (with one rank: the partials themselves).  The
        kernels' dot partials ride this.  A batch's partials, ``(B, 1, 1,
        1)`` each, are gathered as one ``(k·B,)`` stack and summed lane by
        lane; the handle hands back ``(B, 1, 1, 1)`` values."""
        lanes = vals[0].shape if vals[0].dim() == 4 else None
        if lanes is None:
            stacked = torch.stack([v.reshape(()) for v in vals])
        else:
            stacked = torch.stack([v.reshape(-1) for v in vals]).reshape(-1)
        g = self.mesh.comm.all_gather_start(stacked)
        return _PartialSums(g, self._peers, len(vals), lanes)

    def sum_partials(self, *vals) -> tuple:
        """:meth:`sum_partials_start`, waited at once."""
        return self.sum_partials_start(*vals).wait()

    def dotn_start(self, *pairs) -> "_PartialSums":
        """Start any number of dot products in ONE collective: the local
        dots stacked and gathered (:meth:`sum_partials_start`); a batch's
        dots are each lane's own (``core.methods._default_dot``)."""
        return self.sum_partials_start(*(_default_dot(a, b) for a, b in pairs))

    def dotn(self, *pairs) -> tuple:
        """:meth:`dotn_start`, waited at once."""
        return self.dotn_start(*pairs).wait()

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.dotn((a, b))[0]

    def dot2(self, a, b, c, d):
        """Two dot products in ONE collective."""
        return self.dotn((a, b), (c, d))


class _PartialSums:
    """A started global reduction: :meth:`wait` finishes the gather and
    sums the partials in rank order (once; later waits give the same
    tuple).  ``lanes`` (a batch's ``(B, 1, 1, 1)``) shapes each value; a
    lane's sum is elementwise, so it is its single reduction's bits."""

    def __init__(self, gather, peers: list[int], k: int, lanes=None):
        self.gather, self.peers, self.k, self.lanes = gather, peers, k, lanes
        self.value = None

    def wait(self) -> tuple:
        if self.value is None:
            g = self.gather.wait()
            acc = g[self.peers[0]]
            for r in self.peers[1:]:
                acc = acc + g[r]
            if self.lanes is None:
                self.value = tuple(acc[i] for i in range(self.k))
            else:
                self.value = tuple(acc.view(self.k, -1)[i].view(self.lanes)
                                   for i in range(self.k))
        return self.value


def make_layout(mesh: Mesh, dims_map: dict[str, str | None] | None = None) -> GridLayout:
    """Default layouts per mesh:

    * ('data','model')        -> x: model, y: data, z: unsplit
    * ('pod','data','model')  -> x: model, y: data, z: pod
    * 1-D mesh ('cells',)     -> z: cells (the paper-faithful HPCCG layout)
    """
    names = mesh.axis_names
    if dims_map is not None:
        da = (dims_map.get("x"), dims_map.get("y"), dims_map.get("z"))
        return GridLayout(mesh=mesh, dim_axes=da)
    if names == ("cells",):
        return GridLayout(mesh=mesh, dim_axes=(None, None, "cells"))
    if names == ("data", "model"):
        return GridLayout(mesh=mesh, dim_axes=("model", "data", None))
    if names == ("pod", "data", "model"):
        return GridLayout(mesh=mesh, dim_axes=("model", "data", "pod"))
    raise ValueError(f"no default layout for mesh axes {names}")


def tuned_decision(mesh: Mesh, stencil: Stencil, local_shape, dtype, device):
    """The autotune decision (``kernels.autotune.TuneDecision``: the route
    and the ring pass's run) for this mesh's blocks, resolved as rank 0
    reads the tune cache (``autotune.resolve`` writes nothing) and
    broadcast, so every rank routes and launches alike.  A collective."""
    from repro_torch.kernels import autotune
    dec = autotune.resolve(stencil.name, tuple(local_shape), dtype, device)
    t = torch.tensor([int(dec.use_kernels), dec.run], dtype=torch.int64, device=device)
    mesh.comm.broadcast(t, 0)
    return autotune.TuneDecision(use_kernels=bool(t[0]), run=int(t[1]), source=dec.source)


def _fused_run(problem: HPCGProblem, layout: GridLayout, kernels_fused: bool,
               run: int | None) -> int | None:
    """The fused body's ring run, resolved once when the solver is built
    (a collective: every rank builds it) unless the caller gives one."""
    if not kernels_fused or run is not None:
        return run
    return tuned_decision(layout.mesh, problem.stencil, layout.local_shape(problem.shape),
                          problem.dtype, problem.device).run


def _local_ops(stencil, layout, b_loc, *, matvec_padded, halo_mode,
               precond, norm_ref, kernels_fused, run):
    """The DistributedOp (wrapped in ``KernelOp`` for the fused body) and
    the Ops context of one rank: shared by solve_shardmap and
    solve_step_shardmap.  The preconditioner binds here, to the local block
    and its real halos."""
    op = DistributedOp(stencil, layout, matvec_padded=matvec_padded,
                       halo_mode=halo_mode)
    if kernels_fused:
        from repro_torch.kernels.kernel_op import KernelOp
        op = KernelOp(op, run=run)
    M = precond.bind(op) if precond is not None else None
    return Ops(op, b_loc, M=M, norm_ref=norm_ref)


def _check_method(method: str, precond, kernels_fused: bool,
                  matvec_padded=None):
    """Resolve and validate a method name for the distributed drivers: an
    unregistered name raises a ``ValueError`` listing the known methods, and
    precond or fused requests the definition does not support are refused."""
    from repro_torch.core.methods import METHODS
    mdef = get_method(method)          # ValueError w/ known-method list
    if precond is not None and not mdef.accepts_precond:
        raise ValueError(
            f"method {method!r} takes no preconditioner; use one of "
            f"{sorted(n for n, m in METHODS.items() if m.accepts_precond)}")
    if kernels_fused and not mdef.has_fused_body:
        raise ValueError(
            f"method {method!r} declares no fused kernels; fused methods: "
            f"{sorted(n for n, m in METHODS.items() if m.has_fused_body)}")
    if kernels_fused and matvec_padded is not None:
        # the fused body's SpMVs run the built-in stencil kernel: a custom
        # matvec_padded would apply only to the (unfused) initial residual
        raise ValueError(
            "kernels_fused=True is incompatible with a custom matvec_padded "
            "(the fused kernels implement the built-in stencil apply)")
    return mdef


def solve_shardmap(
    problem: HPCGProblem,
    method: str,
    mesh: Mesh,
    *,
    dims_map: dict[str, str | None] | None = None,
    tol: float = 1e-6,
    maxiter: int = 600,
    norm_ref: float | None = 1.0,   # paper: absolute ||r|| < eps (HPCCG criterion)
    matvec_padded: Callable | None = None,
    halo_mode: str = "auto",
    precond=None,
    kernels_fused: bool = False,
    telemetry: int = 0,
    guard_spec=None,
    refresh_every: int = 0,
    run: int | None = None,
):
    """The distributed solver of one rank of ``mesh``'s process group;
    returns ``(fn, layout)``.

    ``fn(b, x0) -> SolveResult``: ``b`` and ``x0`` are the global arrays (as
    the reference's callers pass them) or this rank's blocks; ``x`` of the
    result is this rank's block, every scalar (``iters``, ``res_norm``,
    ``history``, ``status``, ``telemetry``) the same on every rank.  The
    solve is the method's ``MethodDef`` run by ``run_method`` over a
    :class:`DistributedOp`; ``precond`` binds to it on the rank, so its
    applies see the local block and the real halos.  ``kernels_fused=True``
    (the reference's ``pallas_fused``) wraps the operator in ``KernelOp``
    and runs the method's fused body, halos and reductions included, in the
    ring pass's ``run`` (None: resolved on rank 0 and broadcast here, so
    every rank must build the solver).
    ``telemetry``, ``guard_spec`` and ``refresh_every`` go to the driver;
    its scalars are post-reduction, so every rank leaves the loop on the
    same iteration with no extra collective.  Every rank must call ``fn``.
    """
    mdef = _check_method(method, precond, kernels_fused, matvec_padded)
    layout = make_layout(mesh, dims_map)
    stencil = problem.stencil
    run = _fused_run(problem, layout, kernels_fused, run)

    def local_solve(b: torch.Tensor, x0: torch.Tensor) -> SolveResult:
        b_loc = layout.block(b, problem.shape)
        x0_loc = layout.block(x0, problem.shape)
        ops = _local_ops(stencil, layout, b_loc, matvec_padded=matvec_padded,
                         halo_mode=halo_mode, precond=precond,
                         norm_ref=norm_ref, kernels_fused=kernels_fused, run=run)
        return run_method(mdef, ops, x0_loc, tol=tol, maxiter=maxiter,
                          fused=kernels_fused, telemetry=telemetry,
                          guard_spec=guard_spec, refresh_every=refresh_every)

    return local_solve, layout


def step_state_layout(method: str) -> tuple[tuple[str, ...], tuple[str, ...]]:
    """(vector slot names, scalar slot names) of a method's step state,
    from its ``MethodDef``."""
    mdef = get_method(method)
    return mdef.vectors, mdef.scalars


def init_step_state(method: str, A, b, x0, M=None) -> tuple:
    """The argument tuple ``(b, *vectors, *scalars)`` of one
    ``solve_step_shardmap`` iteration, the solver's loop state at iteration
    0 (so one step is one iteration of the loop).  ``A`` is any
    LocalOp-protocol operator; ``M`` the bound preconditioner apply."""
    mdef = get_method(method)
    ops = Ops(A, b, M=M, norm_ref=1.0)
    return (b, *mdef.init(ops, x0))


def solve_step_shardmap(
    problem: HPCGProblem,
    method: str,
    mesh: Mesh,
    *,
    dims_map: dict[str, str | None] | None = None,
    matvec_padded: Callable | None = None,
    halo_mode: str = "auto",
    precond=None,
    kernels_fused: bool = False,
    run: int | None = None,
):
    """One iteration of the solver on one rank of ``mesh``'s process group;
    returns ``(fn, layout)``.

    ``fn(b, *vectors, *scalars)`` is the method's ``MethodDef.step`` (its
    ``fused_step`` under ``kernels_fused``), the state laid out as
    :func:`step_state_layout` says and :func:`init_step_state` builds it;
    ``b`` and the vectors are global arrays or this rank's blocks, and the
    vectors come back as this rank's blocks.  An unknown method raises a
    ``ValueError`` listing the registry.  Every rank must call ``fn``.
    """
    mdef = _check_method(method, precond, kernels_fused, matvec_padded)
    layout = make_layout(mesh, dims_map)
    stencil = problem.stencil
    run = _fused_run(problem, layout, kernels_fused, run)
    step = mdef.fused_step if kernels_fused else mdef.step
    nvec = len(mdef.vectors)

    def local_step(b, *state):
        b_loc = layout.block(b, problem.shape)
        vecs = tuple(layout.block(v, problem.shape) for v in state[:nvec])
        ops = _local_ops(stencil, layout, b_loc, matvec_padded=matvec_padded,
                         halo_mode=halo_mode, precond=precond, norm_ref=1.0,
                         kernels_fused=kernels_fused, run=run)
        return tuple(step(ops, vecs + tuple(state[nvec:])))

    return local_step, layout
