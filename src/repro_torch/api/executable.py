"""The session's compiled solve: one shape's iteration as captured CUDA graphs.

Counterpart of the executable that ``repro/api/session.py::_executable``
lowers and compiles once per shape.  A :class:`SolveExecutable` holds, for
one session and one shape,

  * static buffers: two state sets A and B (the method's ``vectors`` then
    ``scalars``), the right-hand side ``b`` that its ``Ops`` is built over,
    ``norm_ref`` when it is taken from ``b`` (``norm_ref=None``), the loop's
    threshold ``(tol·norm_ref)²`` in the state's dtype, and one block's
    per-step loop conditions and residual norms;
  * on the card, one ``torch.cuda.CUDAGraph`` for each rung ``k`` of the
    block ladder and each direction (A→B, B→A): ``k`` steps from one set,
    the last step's state copied into the other.  The graphs share one
    memory pool; a step's temporaries are dead when its graph ends, so any
    replay order is safe.

Under guards, residual replacement or telemetry (``core.methods.Watch``)
the executable also holds ``rr0`` and ``div2`` (the watch's, filled by each
solve), ``x0`` for the refresh hook, and a block's telemetry rows; the
stagnation counters ride at the end of each state set.  With residual
replacement each (rung, direction) has a second graph whose last step
refreshes, keyed ``(n, src, True)``: a block never crosses a multiple of
``refresh_every`` but at its last step, so no graph needs to know the
iteration it starts at.

A solve copies in ``b`` (and the norm), runs ``init`` eagerly and hands the
state to ``core.methods.run_method_blocks``, which replays the graphs and
reads each block's conditions once.  The iterate leaves in a fresh copy of
the static state, or (``donate``) in the caller's ``x0``: the torch
counterpart of XLA's input/output alias.  Donation changes where the result
is copied out, never a captured pointer.  The first solve that takes a step
allocates the state sets from its ``init`` state and captures the graphs
(``compile_s`` counts it), so no solve runs ``init`` twice.  On CPU tensors
the same steps run eagerly on the same buffers (the CPU was asked for;
nothing falls back).  A capture that fails raises.

Capture needs every lazy set-up done first: the kernels' build and
``ctypes`` load, cuBLAS's handle and workspace behind ``torch.dot`` and the
allocator's blocks.  One eager block of one step on the capture stream does
that before the first capture.

Python's cyclic garbage collector is held off while the graphs are captured
(:func:`collector_held`).  A collection can free a dead session that sits in
a reference cycle, and destroying its graphs while another graph is being
captured invalidates that capture (``cudaErrorStreamCaptureInvalidated``).

On a mesh (the operator a ``core.distributed.DistributedOp``) the steps'
halo swaps and started gathers are captured with them; that takes NCCL (a
gloo mesh runs the eager loop).  The warm eager block then runs a step's
collectives too, so NCCL's communicator exists before the capture, and the
``init`` that ran before it already made every rank agree.  Each block's
conditions come from the globally reduced scalars, so every rank reads the
same flags and replays the same blocks.  ``capture_mode`` is
``torch.cuda.graph``'s ``capture_error_mode``: ``"thread_local"`` on a mesh
with a process group, whose watchdog thread queries CUDA events while a
capture runs.

:class:`BatchedSolveExecutable` is the same for a batch of ``B`` right-hand
sides, the shape ``(B, *grid)`` (the reference's vmapped executable): its
steps are ``core.methods.batched_step``, which leaves a stopped lane as it
is, so a block that runs past the last lane's stop changes nothing and
needs no rollback.  It holds one state set, updated in place at the end of
each block, each lane's iteration count and its history on the device, and
one graph per rung.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Callable, Iterator

import torch

from repro_torch.core.methods import (GuardSpec, MethodDef, Ops, SolveResult, Watch,
                                      batched_block, batched_start, block_ladder,
                                      pick_block, run_batched_blocks, run_method_blocks,
                                      step_block)

#: the largest block the ladder takes by default (``chip_smoke.py``'s K sweep)
MAX_BLOCK = 16

_collector_lock = threading.Lock()
_collector_holds = 0          # captures in progress, on any thread
_collector_was_enabled = False


@contextlib.contextmanager
def collector_held() -> Iterator[None]:
    """No automatic cyclic garbage collection inside the block, on any
    thread: the collector's state is restored when the last of the
    overlapping holders leaves."""
    global _collector_holds, _collector_was_enabled
    with _collector_lock:
        if _collector_holds == 0:
            _collector_was_enabled = gc.isenabled()
            gc.disable()
        _collector_holds += 1
    try:
        yield
    finally:
        with _collector_lock:
            _collector_holds -= 1
            if _collector_holds == 0 and _collector_was_enabled:
                gc.enable()


class SolveExecutable:
    """One shape's solve on static buffers; its steps as CUDA graphs on the
    card.  The runner of :func:`~repro_torch.core.methods.run_method_blocks`
    (``ladder``, ``watch``, ``start``, ``run``, ``accept``, ``state``);
    ``pick`` is its block-size rule (``core.methods.pick_block``).

    ``A`` and ``M`` are the session's operator and bound preconditioner,
    ``dot`` its reduction override; ``shape``, ``dtype`` and ``device`` are
    the right-hand side's; ``telemetry``, ``guard_spec`` and
    ``refresh_every`` arm the executable's :class:`~repro_torch.core.
    methods.Watch`.  ``blocks``
    lists the block sizes the last solve ran (a rolled-back block and its
    redo included), so ``sum(blocks) - iters`` steps were run and dropped;
    ``compile_s`` is the wall time of building the buffers and, once a solve
    has taken a step, the state sets and the captures.
    """

    def __init__(self, mdef: MethodDef, A, M, *, fused: bool, tol: float,
                 maxiter: int, norm_ref: float | None, shape: tuple,
                 dtype: torch.dtype, device: torch.device,
                 max_block: int = MAX_BLOCK, dot: Callable | None = None,
                 telemetry: int = 0, guard_spec: GuardSpec | None = None,
                 refresh_every: int = 0, capture_mode: str = "global"):
        t0 = time.perf_counter()
        self.mdef, self.fused, self.tol, self.maxiter = mdef, fused, tol, maxiter
        self.capture_mode = capture_mode
        self.step: Callable = mdef.fused_step if fused else mdef.step
        self.ridx = mdef.res_index
        self.ladder = block_ladder(max_block)
        self.pick: Callable = pick_block
        self.blocks: list[int] = []
        like = dict(dtype=dtype, device=device)
        self.b = torch.empty(shape, **like)
        self._norm_from_b = norm_ref is None
        if self._norm_from_b:
            norm_ref = torch.empty((), **like)
        self.ops = Ops(A, self.b, M=M, dot=dot, norm_ref=norm_ref)
        self.x0 = torch.empty(shape, **like) if refresh_every else None
        self.watch = Watch(mdef, self.ops, self.x0, telemetry=telemetry,
                           guard_spec=guard_spec, refresh_every=refresh_every,
                           maxiter=maxiter)
        self.thresh2 = torch.empty((), **like)
        self.flags = torch.empty(max_block, dtype=torch.bool, device=device)
        self.norms = torch.empty(max_block, **like)
        self.rows = (torch.empty((max_block, len(mdef.scalars)), **like)
                     if self.watch.cap else None)
        self._sets: tuple | None = None
        self._cur = 0
        self._graphs: dict[tuple[int, int, bool], torch.cuda.CUDAGraph] = {}
        self.compile_s = time.perf_counter() - t0

    # -- the runner protocol ---------------------------------------------------
    @property
    def state(self) -> tuple:
        return self._sets[self._cur]

    def start(self, state: tuple, thresh2) -> None:
        """Copy ``init``'s state into the current set and the threshold into
        its static slot (a Python float rounds to the state's dtype, as the
        loop's comparison rounds it); the first call builds the sets and, on
        the card, captures the graphs."""
        self.thresh2.fill_(thresh2)
        self.blocks = []
        t0, fresh = time.perf_counter(), self._sets is None
        if fresh:
            self._sets = tuple(tuple(torch.empty(s.shape, dtype=s.dtype, device=s.device)
                                     for s in state) for _ in range(2))
        for dst, src in zip(self.state, state):
            dst.copy_(src)
        if fresh and self.b.device.type == "cuda":
            try:
                self._capture()
            except BaseException:      # a later solve captures (and raises) again
                self._sets, self._graphs = None, {}
                raise
        if fresh:
            self.compile_s += time.perf_counter() - t0

    def run(self, n: int, refresh: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """``n`` steps from the current set into the other (``refresh``: the
        last one refreshes); the block's conditions and norms (its
        telemetry rows in ``rows``)."""
        if self.b.device.type == "cuda":
            self._graphs[(n, self._cur, refresh)].replay()
        else:
            self._block(n, self._cur, refresh)
        self.blocks.append(n)
        return self.flags[:n], self.norms[:n]

    def accept(self) -> None:
        self._cur = 1 - self._cur

    # -- one solve -------------------------------------------------------------
    def solve(self, b: torch.Tensor, x0: torch.Tensor,
              out: torch.Tensor | None = None) -> SolveResult:
        """One solve; ``out`` (the caller's donated ``x0``) takes the iterate
        in place of a fresh copy of the static state."""
        x0 = self._load_inputs(b, x0)
        return run_method_blocks(self.mdef, self.ops, x0, tol=self.tol,
                                 maxiter=self.maxiter, fused=self.fused,
                                 runner=self, pick=self.pick, out=out)

    def _load_inputs(self, b: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
        """Copy ``b`` (and its norm) in; ``x0`` too when the refresh hook
        reads it, which then returns the static copy."""
        self.b.copy_(b)
        if self._norm_from_b:      # as ``Ops`` takes it for norm_ref=None
            self.ops.norm_ref.copy_(torch.sqrt(self.ops.dot(self.b, self.b)))
        if self.x0 is None:
            return x0
        self.x0.copy_(x0)
        return self.x0

    # -- the steps and their graphs ---------------------------------------------
    def _block(self, n: int, src: int, refresh: bool = False) -> None:
        out = step_block(self.step, self.ops, self._sets[src], n, self.thresh2,
                         self.ridx, self.flags, self.norms, self.watch, self.rows,
                         refresh)
        torch._foreach_copy_(self._sets[1 - src], out)

    def _variants(self) -> tuple[bool, ...]:
        """The ``refresh`` forms each block size is captured in."""
        return (False, True) if self.watch.refresh_every else (False,)

    def _capture(self) -> None:
        """Warm up with one eager step of each form on the capture stream,
        then capture every (rung, direction, form) into the shared pool."""
        stream = torch.cuda.Stream(self.b.device)
        stream.wait_stream(torch.cuda.current_stream(self.b.device))
        with torch.cuda.stream(stream):
            for refresh in self._variants():
                self._block(1, self._cur, refresh)
        torch.cuda.current_stream(self.b.device).wait_stream(stream)
        pool = torch.cuda.graph_pool_handle()
        with collector_held():
            for n in self.ladder:
                for src in (0, 1):
                    for refresh in self._variants():
                        graph = torch.cuda.CUDAGraph()
                        with torch.cuda.graph(graph, pool=pool, stream=stream,
                                              capture_error_mode=self.capture_mode):
                            self._block(n, src, refresh)
                        self._graphs[(n, src, refresh)] = graph


class BatchedSolveExecutable:
    """One ``(B, *grid)`` shape's batched solve on static buffers; its
    blocks as CUDA graphs on the card.  The runner of
    :func:`~repro_torch.core.methods.run_batched_blocks` (``ladder``,
    ``watch``, ``start``, ``run``, ``state``, ``k``, ``hist``, ``tele``).

    Static buffers: the lanes' right-hand sides ``b`` that its ``Ops`` is
    built over, ``norm_ref`` per lane when it is taken from ``b``, one state
    set (the method's vectors ``(B, *grid)`` and scalars ``(B, 1, 1, 1)``),
    each lane's iteration count ``k``, threshold ``thresh2`` and history
    ``hist`` ``(B, maxiter + 2)``, and the block's record ``(max_block, B)``
    (each lane's residual norm after each step, -1 once it has stopped);
    with the guards its watch's ``rr0``/``div2`` per lane, with residual
    replacement ``x0`` for the refresh hook, and with telemetry the buffer
    ``tele`` ``(B, rows + 1, n_scalars)``.  On
    the card one graph per rung of the ladder (and, with residual
    replacement, a second whose last step refreshes, keyed ``(n, True)``)
    runs that many steps from the state set and copies the last step's
    state, count and nothing else back into it (the history and telemetry
    are written in place as they go).  ``blocks`` lists
    the block sizes the last solve ran; ``compile_s`` is the wall time of
    building the buffers and, once a solve (or :meth:`compile`) has started,
    the state set and the captures.
    """

    def __init__(self, mdef: MethodDef, A, M, *, tol: float, maxiter: int,
                 norm_ref: float | None, shape: tuple, dtype: torch.dtype,
                 device: torch.device, max_block: int = MAX_BLOCK,
                 dot: Callable | None = None, telemetry: int = 0,
                 guard_spec: GuardSpec | None = None, refresh_every: int = 0,
                 capture_mode: str = "global"):
        t0 = time.perf_counter()
        self.mdef, self.tol, self.maxiter = mdef, tol, maxiter
        self.capture_mode = capture_mode
        self.ridx = mdef.res_index
        self.ladder = block_ladder(max_block)
        self.pick: Callable = pick_block
        self.blocks: list[int] = []
        like = dict(dtype=dtype, device=device)
        lanes = shape[0]
        self.b = torch.empty(shape, **like)
        self._norm_from_b = norm_ref is None
        if self._norm_from_b:
            norm_ref = torch.empty((lanes, 1, 1, 1), **like)
        self.ops = Ops(A, self.b, M=M, dot=dot, norm_ref=norm_ref)
        self.x0 = torch.empty(shape, **like) if refresh_every else None
        self.watch = Watch(mdef, self.ops, self.x0, telemetry=telemetry,
                           guard_spec=guard_spec, refresh_every=refresh_every,
                           maxiter=maxiter)
        self.thresh2 = torch.empty((lanes, 1, 1, 1), **like)
        self.k = torch.empty((lanes, 1, 1, 1), dtype=torch.int64, device=device)
        self.hist = torch.empty((lanes, maxiter + 2), **like)
        self.tele = (torch.empty((lanes, self.watch.cap + 1, len(mdef.scalars)), **like)
                     if self.watch.cap else None)
        self.rec = torch.empty((max_block, lanes), **like)
        self._state: tuple | None = None
        self._graphs: dict[tuple[int, bool], torch.cuda.CUDAGraph] = {}
        self.compile_s = time.perf_counter() - t0

    # -- the runner protocol ---------------------------------------------------
    @property
    def state(self) -> tuple:
        return self._state

    def start(self, state: tuple, k: torch.Tensor, thresh2: torch.Tensor,
              hist: torch.Tensor, tele: torch.Tensor | None = None) -> None:
        """Copy ``batched_start``'s state, counts, thresholds, history and
        telemetry into the static buffers; the first call builds the state
        set and, on the card, captures the graphs."""
        self.blocks = []
        t0, fresh = time.perf_counter(), self._state is None
        if fresh:
            self._state = tuple(torch.empty(s.shape, dtype=s.dtype, device=s.device)
                                for s in state)
        dst = [*self._state, self.k, self.thresh2, self.hist]
        src = [*state, k, thresh2, hist]
        if tele is not None:
            dst.append(self.tele)
            src.append(tele)
        torch._foreach_copy_(dst, src)
        if fresh and self.b.device.type == "cuda":
            try:
                self._capture()
            except BaseException:      # a later solve captures (and raises) again
                self._state, self._graphs = None, {}
                raise
            # the warm-up steps moved the buffers on: load them again
            torch._foreach_copy_(dst, src)
        if fresh:
            self.compile_s += time.perf_counter() - t0

    def run(self, n: int, refresh: bool = False) -> torch.Tensor:
        """``n`` steps in place (``refresh``: the last one refreshes); their
        ``(n, B)`` record."""
        if self.b.device.type == "cuda":
            self._graphs[(n, refresh)].replay()
        else:
            self._block(n, refresh)
        self.blocks.append(n)
        return self.rec[:n]

    # -- one solve -------------------------------------------------------------
    def solve(self, b: torch.Tensor, x0: torch.Tensor,
              out: torch.Tensor | None = None) -> SolveResult:
        """One batched solve; ``out`` as :meth:`SolveExecutable.solve`'s."""
        x0 = self._load_inputs(b, x0)
        return run_batched_blocks(self.mdef, self.ops, x0, tol=self.tol,
                                  maxiter=self.maxiter, runner=self, pick=self.pick,
                                  out=out)

    def compile(self, b: torch.Tensor, x0: torch.Tensor) -> None:
        """Build the state set and capture the graphs ahead of any solve,
        from ``init`` on the placeholder lanes ``b`` (a later solve copies its
        own inputs over them)."""
        x0 = self._load_inputs(b, x0)
        self.start(*batched_start(self.mdef, self.ops, x0, tol=self.tol,
                                  maxiter=self.maxiter, watch=self.watch))

    _load_inputs = SolveExecutable._load_inputs     # b, per lane norm_ref, x0
    _variants = SolveExecutable._variants

    # -- the steps and their graphs ---------------------------------------------
    def _block(self, n: int, refresh: bool = False) -> None:
        state, k = batched_block(self.mdef.step, self.ops, self._state, self.k, n,
                                 self.thresh2, self.maxiter, self.ridx, self.hist,
                                 self.rec, self.watch, refresh, self.tele)
        torch._foreach_copy_([*self._state, self.k], [*state, k])

    def _capture(self) -> None:
        """Warm up with one eager step of each form on the capture stream
        (they move the buffers on; :meth:`start` loads them again), then
        capture every (rung, form) into one pool."""
        stream = torch.cuda.Stream(self.b.device)
        stream.wait_stream(torch.cuda.current_stream(self.b.device))
        with torch.cuda.stream(stream):
            for refresh in self._variants():
                self._block(1, refresh)
        torch.cuda.current_stream(self.b.device).wait_stream(stream)
        pool = torch.cuda.graph_pool_handle()
        with collector_held():
            for n in self.ladder:
                for refresh in self._variants():
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph, pool=pool, stream=stream,
                                          capture_error_mode=self.capture_mode):
                        self._block(n, refresh)
                    self._graphs[(n, refresh)] = graph
