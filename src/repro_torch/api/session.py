"""The solver facade (counterpart of ``repro/api/session.py``).

``SolverSession`` binds (problem, method, options) to a resolved backend on
one device; ``solve()`` is the one-shot convenience:

    from repro_torch.api import solve, SolverOptions
    res = solve(method="cg_merged", grid=(128, 128, 128), stencil="27pt",
                options=SolverOptions(kernels=True))          # on the card

The reference compiles the whole solve once per shape (``jit(...).lower()
.compile()``) and caches the executable.  Here the cache holds one
``api.executable.SolveExecutable`` per shape: on the card the iteration
captured as CUDA graphs and replayed in blocks of steps, one host read per
block, with the iterations, iterate, history and status of the eager loop.
``cache_stats()`` reports ``{(shape, method, precond): {hits, misses,
compile_s}}`` as the reference does; a miss builds the executable, its
captures included.

The batched multi-RHS solve (the serving workload) is the reference's too:
``solve_batched(bs)`` solves the ``B`` right-hand sides of ``bs`` (``(B, nx,
ny, nz)``) in one loop of batched steps, each lane masked as it stops, with
the per-lane results of ``B`` single solves (bit for bit those of the
session's unfused single solve of each lane).  It runs the unfused body, as
the reference's vmapped solve does, on the lane-batched kernels under
``kernels=True``, through the cache under the key ``(B, *grid)``
(``api.executable.BatchedSolveExecutable``); ``compile_batched(B)`` builds
that executable, its captures included, before any solve.

Resilience and telemetry are the reference's too: ``SolverOptions.guards``,
``residual_replacement`` and ``telemetry`` run on every driver (the eager
loop, the cached blocks, both batched loops; ``core.methods.Watch``), and
``solve`` applies ``on_breakdown`` to a guarded solve that ends in
breakdown, diverged or stagnated: raise :class:`SolveBreakdown`, return the
status, restart from the last finite iterate, or walk the fallback ladder
(kernels, ``dot`` and ``matvec_padded`` rolled back, then each
``variant_of`` down to the classical method).  ``solve_batched`` returns
each lane's status and applies no policy.  The lifecycle is traced as
``repro.obs/v1`` spans (``repro_torch.obs``): ``resolve``,
``precond.setup``, ``compile`` (an executable built), ``solve``,
``execute`` (which waits for the card only while tracing is on) and
``resilience.attempt``.

On a mesh (``mesh=``, or ``layout`` "1d"/"2d"/"3d" over the default
process group; ``core/distributed.py``) every rank builds the same session
and passes the global ``b`` and ``x0`` (batched: the global ``bs`` ``(B,
nx, ny, nz)``), as the reference's callers do, or this rank's block; the
session takes the rank's block, and the result's ``x`` is the rank's block
(batched: ``(B, *block)``); :meth:`SolverSession.gather` (a collective)
returns the global array, lanes included, as the reference's result is a
global ``jax.Array``.  The batched solve on a mesh is the single batched
loop over a lane-batched ``DistributedOp`` (under ``kernels=True`` wrapped
in ``KernelOp``, whose lane-batched kernels take the exchanged padded
lanes), each lane bitwise its single mesh solve.  On a mesh whose group
runs NCCL (or a one-rank mesh with no group) ``solve`` and
``solve_batched`` go through the executable cache as on one device, the
halo swaps and the started gathers captured in the graphs; under gloo the
mesh runs the eager loop (one read an iteration or step, the same on every
rank): gloo's collectives run on the host, and a CUDA graph cannot capture
them.

``SolverOptions(kernels=None)`` is resolved at construction through
``kernels.autotune.resolve`` (the persisted tune cache, else its default
table), as the reference resolves ``pallas=None``; the ``resolve`` span
carries ``tune_source``.  With the kernels on, the session's ``KernelOp``
takes the tuned run read at the same time, so a cache file
rewritten later changes no session built before it, nor its graphs.

Under ``donate`` (the default, as in the reference) a cached solve writes its
iterate into the caller's ``x0`` (``x0s``) and returns that tensor as
``result.x``; see ``SolverOptions.donate`` for what is never donated.
"""

from __future__ import annotations

import time
import warnings
from typing import Any

import torch

from repro_torch.api.backend import (Backend, resolve_backend, resolve_halo_mode,
                                     resolve_matvec, resolve_precond)
from repro_torch.api.executable import (MAX_BLOCK, BatchedSolveExecutable,
                                        SolveExecutable)
from repro_torch.api.options import SolverOptions
from repro_torch.api.registry import REGISTRY, SolverSpec, fallback_chain, get_solver
from repro_torch.api.timing import timed_result
from repro_torch.core.distributed import solve_shardmap, solve_step_shardmap, tuned_decision
from repro_torch.core.methods import (STATUS_BREAKDOWN, STATUS_DIVERGED,
                                      STATUS_STAGNATED, Ops, SolveBreakdown,
                                      SolveResult, run_method, run_method_batched,
                                      status_name)
from repro_torch.core.problems import HPCGProblem, make_problem
from repro_torch.core.solvers import LocalOp
from repro_torch.kernels import autotune
from repro_torch.obs import trace as obs

#: guarded exit statuses the recovery policies act on
_RECOVERABLE = (STATUS_BREAKDOWN, STATUS_DIVERGED, STATUS_STAGNATED)


def _route(opts: SolverOptions) -> dict:
    """The route a solve runs on, as trace attributes: the kernels, and a
    custom ``dot`` and ``matvec_padded``, each on or off."""
    return dict(kernels=bool(opts.kernels), dot=opts.dot is not None,
                matvec_padded=opts.matvec_padded is not None)


def _shares(a: torch.Tensor, b: torch.Tensor | None) -> bool:
    """Whether ``a`` and ``b`` lie in one storage."""
    return (b is not None and a.device == b.device
            and a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr())


def _per_lane(fn, *, scalar: bool):
    """``fn``, written for one grid, applied lane by lane to a batch
    (4-D operands), as the reference's vmap applies it: a ``dot`` stacks
    the lanes' scalars to ``(B, 1, 1, 1)``, a ``matvec_padded`` the lanes'
    grids."""
    if fn is None:
        return None
    if scalar:
        def lanes(a, b):
            if a.dim() != 4:
                return fn(a, b)
            return torch.stack([fn(ai, bi) for ai, bi in zip(a, b)]).view(-1, 1, 1, 1)
    else:
        def lanes(xp):
            return fn(xp) if xp.dim() != 4 else torch.stack([fn(x) for x in xp])
    return lanes


class SolverSession:
    """A problem + method + options bound to one device, or to this rank's
    device on a mesh of ranks (``mesh``, or the layout the options ask for).

    ``device`` defaults to the problem's device when a problem is given,
    else to ``"cuda"``; asking for CUDA without a card raises.  On a mesh
    the problem is the global one and every rank must build the session.
    """

    #: the largest block of steps an executable replays between two reads
    _max_block = MAX_BLOCK

    def __init__(self, problem: HPCGProblem | None = None, *,
                 method: str = "cg_nb",
                 grid: tuple[int, int, int] | None = None,
                 stencil: str = "27pt",
                 options: SolverOptions | None = None,
                 device=None, mesh=None):
        self.options = options or SolverOptions()
        dtype = torch.float64 if self.options.f64 else torch.float32
        if problem is None:
            if grid is None:
                raise ValueError("need either a problem or a grid")
            problem = make_problem(tuple(grid), stencil, dtype=dtype,
                                   device=device or "cuda")
        else:
            if problem.dtype != dtype:
                raise ValueError(
                    f"SolverOptions.f64={self.options.f64} conflicts with the "
                    f"pre-built problem's dtype {problem.dtype}; pass "
                    f"f64={problem.dtype == torch.float64} or rebuild the "
                    f"problem.")
            if device is not None and torch.device(device) != problem.device:
                raise ValueError(
                    f"device {device!r} conflicts with the problem's device "
                    f"{problem.device}")
        self.problem = problem
        self.backend: Backend = resolve_backend(self.options, mesh=mesh,
                                                device=problem.device)
        # the tuned run (and, for kernels=None, the routing bit:
        # downstream code only ever sees a bool), read once for the session
        self._tune: autotune.TuneDecision | None = None
        tuned = {}
        if self.options.kernels is not False:
            self._tune = self._resolve_tune()
            if self.options.kernels is None:
                self.options = self.options.replace(kernels=self._tune.use_kernels)
                tuned = dict(tune_source=self._tune.source)
        with obs.span("resolve", method=method, layout=self.options.layout,
                      grid=list(problem.shape), **tuned):
            self.spec: SolverSpec = get_solver(method)
            self._matvec = resolve_matvec(problem.stencil, self.options)
            self.halo_mode = resolve_halo_mode(self.options)
        if (self.mesh is not None and self.options.kernels and self.halo_mode == "overlap"
                and self.layout.split_dims):
            local = self.layout.local_shape(problem.shape)
            split = self.layout.split_dims
            raise ValueError(
                f"halo_mode='overlap' under kernels=True: the overlap split applies "
                f"the stencil to the interior {_interior(local, split)} and to "
                f"boundary-shell slabs of 3 planes (padded operands like "
                f"{_slab(local, split)}), which the stencil kernels do not "
                f"take; use halo_mode='concat' (what 'auto' resolves to under the "
                f"kernels)")
        with obs.span("precond.setup", precond=self.options.precond):
            self.precond = resolve_precond(self.options)
        if self.precond is not None and not self.spec.accepts_precond:
            takers = sorted(n for n, s in REGISTRY.items() if s.accepts_precond)
            raise ValueError(
                f"method {self.method!r} takes no preconditioner; use one "
                f"of {takers} with precond={self.options.precond!r}, or "
                f"precond='none'")
        if (self.precond is not None and self.spec.spd_required
                and not self.precond.spd_preserving):
            raise ValueError(
                f"method {self.method!r} requires an SPD-preserving "
                f"preconditioner, but {self.precond.describe()} declares "
                f"spd_preserving=False; use pbicgstab or an SPD-preserving "
                f"M (CG's short recurrence silently breaks down otherwise)")
        if (self.options.residual_replacement
                and not self.spec.method_def.has_refresh):
            raise ValueError(
                f"residual_replacement={self.options.residual_replacement} "
                f"but method {self.method!r} declares no refresh hook; "
                f"residual replacement targets the merged/pipelined variants "
                f"(MethodDef.refresh) — the classical recurrences already "
                f"compute the true residual")
        self._fallbacks: list[tuple[str, SolverSession]] | None = None
        self._executables: dict[tuple, SolveExecutable | BatchedSolveExecutable] = {}
        self._compile_stats: dict[tuple, dict] = {}

    # -- introspection --------------------------------------------------------
    @property
    def method(self) -> str:
        return self.spec.name

    @property
    def device(self) -> torch.device:
        return self.backend.device

    @property
    def mesh(self):
        """The mesh of ranks the session solves on (None: one device)."""
        return self.backend.mesh

    @property
    def layout(self):
        return self.backend.layout

    def _resolve_tune(self) -> autotune.TuneDecision:
        """The autotune decision for the grid the kernels see: on a mesh the
        rank's block, as rank 0 resolves it (``tuned_decision``)."""
        prob = self.problem
        if self.mesh is None:
            return autotune.resolve(prob.stencil.name, prob.shape, prob.dtype, prob.device)
        return tuned_decision(self.mesh, prob.stencil, self.layout.local_shape(prob.shape),
                              prob.dtype, prob.device)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global array from every rank's block ``x`` (a result's
        ``x``; a leading lane axis passes through): a collective every rank
        of the mesh calls; without a mesh, ``x`` itself."""
        if self.mesh is None:
            return x
        shape = self.problem.shape
        lanes = tuple(x.shape[:-3])
        local = lanes + self.layout.local_shape(shape)
        g = self.mesh.comm.all_gather(x.contiguous().reshape(-1))
        out = torch.empty(lanes + shape, dtype=x.dtype, device=x.device)
        for r in range(self.mesh.size):
            at = (Ellipsis, *self.layout.slices(shape, self.mesh.coords_of(r)))
            out[at] = g[r].view(local)
        return out

    @property
    def _graphed(self) -> bool:
        """Whether solves go through the executable cache: on one device,
        and on a mesh whose collectives a CUDA graph can capture (NCCL, or
        no group at all); gloo's run on the host, so a gloo mesh runs the
        eager loop."""
        return self.mesh is None or self.mesh.backend != "gloo"

    def _block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of a global array or of a block (lanes pass
        through); without a mesh, ``x``."""
        if self.mesh is None:
            return x
        return self.layout.block(x, self.problem.shape)

    def _block_shape(self, shape: tuple) -> tuple:
        """The buffers' shape of an executable keyed ``shape`` (the grid or
        ``(B, *grid)``): on a mesh, this rank's block of it."""
        if self.mesh is None:
            return tuple(shape)
        return (*shape[:-3], *self.layout.local_shape(self.problem.shape))

    def _shardmap_fn(self, fused: bool):
        """This rank's :func:`solve_shardmap` solve under the session's
        options (the fused body on ``KernelOp`` in the session's run)."""
        opts = self.options
        fn, _ = solve_shardmap(
            self.problem, self.method, self.mesh, dims_map=opts.dims_map,
            tol=opts.tol, maxiter=opts.maxiter, norm_ref=opts.norm_ref,
            matvec_padded=None if fused else self._matvec, halo_mode=self.halo_mode,
            precond=self.precond, kernels_fused=fused,
            run=self._tune.run if fused else None, **self._watch_kwargs())
        return fn

    def step_fn(self):
        """One solver iteration on this rank (``core.distributed.
        solve_step_shardmap``).  Mesh backends only."""
        if self.mesh is None:
            raise ValueError("step_fn needs a mesh backend")
        return solve_step_shardmap(
            self.problem, self.method, self.mesh, dims_map=self.options.dims_map,
            matvec_padded=self._matvec, halo_mode=self.halo_mode, precond=self.precond)

    def describe(self) -> str:
        pre = (f" precond={self.precond.describe()}"
               if self.precond is not None else "")
        return (f"{self.method}/{self.problem.stencil.name} "
                f"grid={self.problem.shape} on {self.backend.describe()}"
                f"{' [kernels]' if self.options.kernels else ''}{pre}")

    def _solver_kwargs(self, A) -> dict:
        """tol/maxiter/norm_ref plus, for the methods that take one, the
        preconditioner apply bound against ``A``, and the driver's telemetry
        rows, guard spec and refresh interval."""
        kw = self.options.solver_kwargs() | self._watch_kwargs()
        if self.spec.accepts_precond:
            kw["M"] = None if self.precond is None else self.precond.bind(A)
        return kw

    def _watch_kwargs(self) -> dict:
        """The driver's ``telemetry``, ``guard_spec`` and ``refresh_every``."""
        opts = self.options
        return dict(telemetry=opts.telemetry_rows(), guard_spec=opts.guard_spec(),
                    refresh_every=opts.residual_replacement)

    def _use_fused_body(self) -> bool:
        """Route ``kernels=True`` solves of any method whose ``MethodDef``
        declares a fused kernel body (the registry's ``has_fused_body``
        capability) to the fused iteration: for merged CG/PCG the vector
        updates in one pass and the SpMV with the dot partials in another,
        for the pipelined CGs the reduction partials first and all vector
        recurrences in one pass, for the merged BiCGStabs three passes (two
        SpMVs, one with all nine partials).  Preconditioned methods stay on
        the fused route: the bound preconditioner apply composes inside the
        fused body (on its own kernels under ``use_kernels``).  A custom
        ``matvec_padded`` or ``dot`` keeps the solve off the fused body, as
        in the reference: the fused kernels would replace it."""
        return (bool(self.options.kernels) and self.spec.has_fused_body
                and (self.precond is None or self.spec.accepts_precond)
                and self.options.matvec_padded is None
                and self.options.dot is None)

    def _operator(self, batched: bool = False):
        """``LocalOp``; under ``kernels=True`` the ``KernelOp`` around it, whose
        SpMV makes the zero halo in the kernel (no pad pass), in the
        session's tuned run.  The wrapped
        ``LocalOp`` keeps the padded kernel SpMV for its own ``matvec``
        (merged CG's initial residual, as in the reference).  A custom
        ``matvec_padded`` gets a plain ``LocalOp`` around it (a ``KernelOp``
        would replace it with the stencil kernel), lane by lane for a
        ``batched`` solve.  On a mesh, :meth:`_mesh_operator`."""
        if self.mesh is not None:
            return self._mesh_operator(batched)
        mv = self.options.matvec_padded
        if mv is not None:
            return LocalOp(self.problem.stencil,
                           matvec_padded=_per_lane(mv, scalar=False) if batched else mv)
        A = LocalOp(self.problem.stencil, matvec_padded=self._matvec)
        if self.options.kernels:
            from repro_torch.kernels.kernel_op import KernelOp
            return KernelOp(A, run=self._tune.run)
        return A

    def _mesh_operator(self, batched: bool):
        """This rank's ``DistributedOp``, as ``solve_shardmap`` builds it: on
        the fused body (and for a ``batched`` solve under ``kernels=True``)
        the ``KernelOp`` around it, whose kernels take the exchanged padded
        operands (a batch's, its lanes at once); otherwise the session's
        ``matvec_padded`` (the padded SpMV kernel under ``kernels=True``, a
        custom one lane by lane for a ``batched`` solve)."""
        from repro_torch.core.distributed import DistributedOp
        kernel_op = (bool(self.options.kernels) and self.options.matvec_padded is None
                     and (batched or self._use_fused_body()))
        mv = None if kernel_op else self._matvec
        if batched and mv is not None:
            mv = _per_lane(mv, scalar=False)
        op = DistributedOp(self.problem.stencil, self.layout, matvec_padded=mv,
                           halo_mode=self.halo_mode)
        if kernel_op:
            from repro_torch.kernels.kernel_op import KernelOp
            op = KernelOp(op, run=self._tune.run)
        return op

    def _dot(self, batched: bool = False):
        """The ``dot`` override (None: the operator's own), lane by lane for
        a ``batched`` solve; a mesh reduces through its operator, as in the
        reference."""
        if self.mesh is not None:
            return None
        return _per_lane(self.options.dot, scalar=True) if batched else self.options.dot

    def _solve_eager(self, b: Any = None, x0: Any = None) -> SolveResult:
        """The eager loop (``run_method``, one host read per iteration): the
        yardstick of the cached solve, and the route on which each wrapper's
        launch count is each launch (a graph replay passes no wrapper)."""
        b, x0 = self._inputs(b, x0)
        opts = self.options
        if self.mesh is not None:
            return self._shardmap_fn(self._use_fused_body())(b, x0)
        if self._use_fused_body():
            A = self._operator()
            M = None if self.precond is None else self.precond.bind(A)
            ops = Ops(A, b, M=M, norm_ref=opts.norm_ref)
            return run_method(self.spec.method_def, ops, x0, tol=opts.tol,
                              maxiter=opts.maxiter, fused=True, **self._watch_kwargs())
        return self._solve_unfused(b, x0)

    def _solve_unfused(self, b: Any = None, x0: Any = None) -> SolveResult:
        """The eager loop of the unfused body (the registry's solver on the
        session's operator), whatever ``_use_fused_body`` says: the single
        solve that each lane of a batched solve is bit for bit."""
        b, x0 = self._inputs(b, x0)
        if self.mesh is not None:
            return self._shardmap_fn(False)(b, x0)
        A = self._operator()
        return self.spec.fn(A, b, x0, dot=self.options.dot, **self._solver_kwargs(A))

    def _inputs(self, b, x0) -> tuple[torch.Tensor, torch.Tensor]:
        """``b`` and ``x0`` placed (the problem's by default); on a mesh the
        global arrays or this rank's blocks."""
        shapes = {self.problem.shape}
        if self.mesh is not None:
            shapes.add(self.layout.local_shape(self.problem.shape))

        def put(v, default):
            if v is None:
                return default()
            v = torch.as_tensor(v, dtype=self.problem.dtype, device=self.device)
            if tuple(v.shape) not in shapes:
                raise ValueError(f"array shape {tuple(v.shape)} != problem "
                                 f"grid {self.problem.shape}")
            return v.contiguous()
        return put(b, self.problem.b), put(x0, self.problem.x0)

    def _donated(self, given: Any, placed: torch.Tensor, b: torch.Tensor, *,
                 stacklevel: int) -> torch.Tensor | None:
        """The tensor a donating solve writes its iterate into: the caller's
        ``x0`` (``given``) when ``options.donate`` and it can take the result
        as it is (``placed``, its placed form, is ``given`` itself: the
        problem's dtype, device and shape, contiguous; on a mesh the shape
        of this rank's block) and it shares no storage with ``b`` or with
        the problem's own data; else None.  A tensor that cannot be donated
        is copied, with a warning, as XLA does; an ``x0`` the caller did not
        pass is never written."""
        if not self.options.donate or not isinstance(given, torch.Tensor):
            return None
        block = None if self.mesh is None else self.layout.local_shape(self.problem.shape)
        if placed is given and block in (None, tuple(given.shape[-3:])) and not any(
                _shares(given, t) for t in (b, self.problem.b_data, self.problem.x0_data)):
            return given
        what = "" if block is None else f" of this rank's block shape {block}"
        warnings.warn(f"{self.method}: x0 of shape {tuple(given.shape)}, "
                      f"{given.dtype} on {given.device} was not donated (it must be "
                      f"a contiguous {self.problem.dtype} tensor{what} on {self.device} "
                      f"sharing no storage with b or the problem's data); the result "
                      f"is a copy", stacklevel=stacklevel + 1)
        return None

    # -- the executable cache --------------------------------------------------
    def _executable(self, shape: tuple | None = None):
        """The executable for ``shape``, built on first use (its state and
        graphs by its first solve, right after ``init``, or by
        ``compile_batched``): the problem's grid (the default) holds a
        :class:`SolveExecutable`, ``(B, *grid)`` a
        :class:`BatchedSolveExecutable`; on a mesh the key is the global
        shape and the buffers this rank's block of it.  On an NCCL mesh
        the captures run in thread-local mode, so the process group's
        watchdog thread, which queries its events, cannot spoil them."""
        shape = shape or self.problem.shape
        ent = self._executables.get(shape)
        st = self._stats(shape)
        if ent is None:
            with obs.span("compile", method=self.method, shape=list(shape),
                          backend=self.backend.kind):
                opts = self.options
                batched = len(shape) == 4
                A = self._operator(batched)
                M = None if self.precond is None else self.precond.bind(A)
                kw = dict(tol=opts.tol, maxiter=opts.maxiter, norm_ref=opts.norm_ref,
                          shape=self._block_shape(shape), dtype=self.problem.dtype,
                          device=self.device, max_block=self._max_block,
                          dot=self._dot(batched), **self._watch_kwargs())
                if self.mesh is not None and self.mesh.backend is not None:
                    kw["capture_mode"] = "thread_local"
                if batched:
                    ent = BatchedSolveExecutable(self.spec.method_def, A, M, **kw)
                else:
                    ent = SolveExecutable(self.spec.method_def, A, M,
                                          fused=self._use_fused_body(), **kw)
                st["misses"] += 1
                self._executables[shape] = ent
        else:
            st["hits"] += 1
        return ent

    def _stats(self, shape: tuple | None = None) -> dict:
        return self._compile_stats.setdefault(
            (shape or self.problem.shape, self.method, self.options.precond),
            {"hits": 0, "misses": 0, "compile_s": 0.0})

    def cache_stats(self) -> dict[tuple, dict]:
        """Executable-cache observability: ``{(shape, method, precond):
        {"hits", "misses", "compile_s"}}``.  ``shape`` is the problem grid
        for single-RHS solves and ``(batch, *grid)`` for batched ones; a
        miss is one executable built (its static buffers; on the card also
        one eager warm-up step and a CUDA graph captured for each block size
        (and, single-RHS, each direction), made by the first solve that
        takes a step or by ``compile_batched``) and ``compile_s`` its
        measured wall-clock cost."""
        return {k: dict(v) for k, v in self._compile_stats.items()}

    def _solve_cached(self, b: torch.Tensor, x0: torch.Tensor,
                      out: torch.Tensor | None = None) -> SolveResult:
        exe = self._executable()
        res = exe.solve(self._block(b), self._block(x0), out)
        self._stats()["compile_s"] = exe.compile_s
        return res

    def _sync_if_tracing(self, sp) -> None:
        """An ``execute`` span times the solve, not its launches: wait for
        the card, only while tracing is on."""
        if sp is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _solve_once(self, b: Any = None, x0: Any = None) -> SolveResult:
        """One solve through the executable cache, no recovery policy (the
        attempts of the restart and fallback policies re-enter here)."""
        with obs.span("solve", method=self.method, grid=list(self.problem.shape),
                      backend=self.backend.kind):
            given = x0
            b, x0 = self._inputs(b, x0)
            b, x0 = self._block(b), self._block(x0)
            out = self._donated(given, x0, b, stacklevel=3)   # the caller of solve
            with obs.span("execute") as sp:
                if self._graphed:
                    res = self._solve_cached(b, x0, out)
                else:
                    # a gloo mesh runs the eager loop (no graphs); a donated
                    # x0, this rank's block, takes its iterate
                    res = self._solve_eager(b, x0)
                    if out is not None:
                        res = res._replace(x=out.copy_(res.x))
                self._sync_if_tracing(sp)
        return res

    def solve(self, b: Any = None, x0: Any = None) -> SolveResult:
        """Solve one system (``b``/``x0`` default to the problem's) through
        the executable cache, applying ``options.on_breakdown`` when the
        guards are armed and the solve ends in breakdown, diverged or
        stagnated:

        * ``"raise"``    — raise :class:`SolveBreakdown` (result attached);
        * ``"none"``     — return the result, status untouched;
        * ``"restart"``  — solve again from the last finite iterate (zeros
          if it is poisoned), up to ``max_restarts`` attempts;
        * ``"fallback"`` — walk the ladder (:meth:`_fallback_ladder`).

        With the guards off (the default) this is the cached solve, with no
        look at its status.  Under ``options.donate`` a caller's ``x0`` takes
        the iterate and is returned as ``result.x``.  Each attempt is traced as a
        ``resilience.attempt`` span with its route (:func:`_route`), and the
        fallback rung whose answer is returned as a
        ``resilience.fallback_rung`` event, so a kernel fault answered by the
        plain route shows in the trace."""
        res = self._solve_once(b, x0)
        opts = self.options
        if opts.guard_spec() is None or opts.on_breakdown == "none":
            return res
        if int(res.status) not in _RECOVERABLE:
            return res
        return self._recover(res, b)

    def _recover(self, res: SolveResult, b: Any) -> SolveResult:
        """Apply the armed ``on_breakdown`` policy to an abnormal exit."""
        opts = self.options
        if opts.on_breakdown == "raise":
            raise SolveBreakdown(self.method, res)
        b = self.problem.b() if b is None else b
        if opts.on_breakdown == "restart":
            for attempt in range(1, opts.max_restarts + 1):
                x_start = res.x.clone()
                if not self._all_ranks(torch.isfinite(x_start).all()):
                    x_start = torch.zeros_like(x_start)
                with obs.span("resilience.attempt", policy="restart",
                              method=self.method, attempt=attempt,
                              from_status=status_name(res.status), **_route(opts)):
                    res = self._solve_once(b, x_start)
                if int(res.status) not in _RECOVERABLE:
                    break
            return res
        answered = None
        for attempt, (name, sess) in enumerate(self._fallback_ladder(), 1):
            if attempt > max(1, opts.max_restarts):
                break
            with obs.span("resilience.attempt", policy="fallback",
                          method=name, attempt=attempt,
                          from_status=status_name(res.status), **_route(sess.options)):
                res = sess._solve_once(b, None)
            answered = (attempt, name, sess.options)
            if int(res.status) not in _RECOVERABLE:
                break
        if answered is not None:
            attempt, name, o = answered
            obs.event("resilience.fallback_rung", rung=attempt, method=name,
                      status=status_name(res.status), **_route(o))
        return res

    def _fallback_ladder(self) -> list[tuple[str, "SolverSession"]]:
        """Sessions the ``"fallback"`` policy walks, built on first use and
        kept: the same method with ``kernels``, ``matvec_padded`` and
        ``dot`` rolled back to the plain operator when any was on, then
        each ``variant_of`` ancestor down to the classical method (the
        preconditioner dropped for a rung that takes none, residual
        replacement for a rung with no refresh hook).  Every rung runs with
        the guards armed and ``on_breakdown="none"``: its status gates the
        walk without recursing into recovery."""
        if self._fallbacks is not None:
            return self._fallbacks
        opts = self.options
        base = opts.replace(on_breakdown="none", guards=True, kernels=False,
                            matvec_padded=None, dot=None)
        plan: list[tuple[str, SolverOptions]] = []
        if opts.kernels or opts.matvec_padded is not None or opts.dot is not None:
            plan.append((self.method, base))
        for name in fallback_chain(self.method)[1:]:
            spec = get_solver(name)
            o = base
            if not spec.accepts_precond and o.precond != "none":
                o = o.replace(precond="none", precond_params=None)
            if o.residual_replacement and not spec.method_def.has_refresh:
                o = o.replace(residual_replacement=0)
            plan.append((name, o))
        self._fallbacks = [(name, SolverSession(self.problem, method=name, options=o,
                                                mesh=self.mesh))
                           for name, o in plan]
        return self._fallbacks

    def timed_solve(self, b: Any = None, x0: Any = None, *,
                    repeats: int = 10,
                    warmup: int = 1) -> tuple[SolveResult, dict[str, float]]:
        """Solve with wall-clock stats; warm-up calls run outside the timed
        region (the first builds the kernels and the executable) and every
        call ends in a device synchronise.  No recovery policy applies.  On
        a gloo mesh the eager loop is timed, on every rank."""
        with obs.span("solve", method=self.method, grid=list(self.problem.shape),
                      backend=self.backend.kind, timed=True, repeats=repeats):
            b, x0 = self._inputs(b, x0)
            b, x0 = self._block(b), self._block(x0)
            fn = self._solve_cached if self._graphed else self._solve_eager
            with obs.span("execute"):
                return timed_result(fn, b, x0, repeats=repeats, warmup=warmup)

    def _all_ranks(self, flag: torch.Tensor) -> bool:
        """Whether ``flag`` holds on every rank of the mesh (on one device:
        whether it holds)."""
        if self.mesh is None:
            return bool(flag)
        return bool(self.mesh.comm.all_gather(flag.reshape(1).to(torch.int64)).min())

    # -- batched multi-RHS path (the serving workload) ---------------------------
    def _prep_batched(self, bs: Any, x0s: Any) -> tuple[torch.Tensor, torch.Tensor]:
        """Validate and place a batch; returns ``(bs, x0s)`` (``x0s``
        defaults to zeros), on a mesh this rank's blocks ``(B, *block)``
        of the global lanes (or of blocks already)."""
        grids = {self.problem.shape}
        if self.mesh is not None:
            grids.add(self.layout.local_shape(self.problem.shape))
        bs = torch.as_tensor(bs, dtype=self.problem.dtype, device=self.device)
        if bs.dim() != 4:
            raise ValueError(f"bs must be (batch, nx, ny, nz), got {tuple(bs.shape)}")
        if tuple(bs.shape[1:]) not in grids:
            raise ValueError(f"RHS grid {tuple(bs.shape[1:])} != problem grid "
                             f"{self.problem.shape}")
        bs = self._block(bs).contiguous()
        if x0s is None:
            return bs, torch.zeros_like(bs)
        x0s = torch.as_tensor(x0s, dtype=self.problem.dtype, device=self.device)
        if x0s.dim() != 4 or x0s.shape[0] != bs.shape[0] or tuple(x0s.shape[1:]) not in grids:
            raise ValueError(f"x0s shape {tuple(x0s.shape)} does not fit bs "
                             f"(batch {bs.shape[0]}, grid {self.problem.shape})")
        return bs, self._block(x0s).contiguous()

    def _solve_batched_eager(self, bs: Any, x0s: Any = None) -> SolveResult:
        """The batched solve's eager loop (``run_method_batched``, one host
        read per step): the yardstick of the cached batched solve, and the
        route on which each wrapper's launch count is each launch.  On a
        mesh every rank runs it on its blocks of the lanes."""
        bs, x0s = self._prep_batched(bs, x0s)
        opts = self.options
        A = self._operator(batched=True)
        M = None if self.precond is None else self.precond.bind(A)
        ops = Ops(A, bs, M=M, dot=self._dot(batched=True), norm_ref=opts.norm_ref)
        return run_method_batched(self.spec.method_def, ops, x0s, tol=opts.tol,
                                  maxiter=opts.maxiter, **self._watch_kwargs())

    def compile_batched(self, batch: int) -> float:
        """Build the ``batch``-RHS executable ahead of time, its state set
        and (on the card) its graphs included, and return the seconds it
        took; a later :meth:`solve_batched` at this batch size is a cache
        hit.  The captures run on a placeholder (the problem's ``b`` in
        every lane), which the first solve overwrites: no solve runs.  On a
        gloo mesh the batched solve runs the eager loop, so nothing is
        built (no cache entry) and the seconds are those of nothing."""
        shape = (int(batch), *self.problem.shape)
        t0 = time.perf_counter()
        if not self._graphed:
            return time.perf_counter() - t0
        exe = self._executable(shape)
        if exe.state is None:
            block = self._block_shape(shape)
            b = self._block(self.problem.b()).expand(block)
            exe.compile(b, torch.zeros(block, dtype=self.problem.dtype, device=self.device))
            self._stats(shape)["compile_s"] = exe.compile_s
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def _solve_batched_cached(self, bs: torch.Tensor, x0s: torch.Tensor,
                              out: torch.Tensor | None = None) -> SolveResult:
        shape = (bs.shape[0], *self.problem.shape)
        exe = self._executable(shape)
        res = exe.solve(bs, x0s, out)
        self._stats(shape)["compile_s"] = exe.compile_s
        return res

    def solve_batched(self, bs: Any, x0s: Any = None) -> SolveResult:
        """Solve the ``bs.shape[0]`` right-hand sides of ``bs`` (``(batch,
        nx, ny, nz)``; ``x0s`` alike, zeros by default) through the
        executable cache.  The result's leaves carry the lane axis: ``x``
        ``(B, nx, ny, nz)``, ``iters`` and ``status`` int32 ``(B,)``,
        ``res_norm`` ``(B,)``, ``history`` ``(B, maxiter + 1)`` and, with
        telemetry, ``telemetry`` ``(B, rows, n_scalars)``.  No
        ``on_breakdown`` policy applies: one poisoned lane neither raises nor
        re-solves the batch, its ``status`` says so.  Under ``donate`` a
        caller's ``x0s`` takes ``x``, as :meth:`solve`'s ``x0``.  On a
        mesh ``bs`` is the global lanes or this rank's blocks of them,
        and ``x`` this rank's blocks (:meth:`gather` gives the global
        lanes); every rank calls it."""
        given = x0s
        bs, x0s = self._prep_batched(bs, x0s)
        out = self._donated(given, x0s, bs, stacklevel=2)
        with obs.span("solve", method=self.method, grid=list(self.problem.shape),
                      backend=self.backend.kind, batch=int(bs.shape[0])):
            with obs.span("execute") as sp:
                if self._graphed:
                    res = self._solve_batched_cached(bs, x0s, out)
                else:
                    res = self._solve_batched_eager(bs, x0s)
                    if out is not None:
                        res = res._replace(x=out.copy_(res.x))
                self._sync_if_tracing(sp)
        return res

    def timed_solve_batched(self, bs: Any, x0s: Any = None, *, repeats: int = 10,
                            warmup: int = 1) -> tuple[SolveResult, dict[str, float]]:
        """:meth:`solve_batched` with wall-clock stats, as :meth:`timed_solve`
        (on a gloo mesh the eager loop, on every rank)."""
        bs, x0s = self._prep_batched(bs, x0s)
        fn = self._solve_batched_cached if self._graphed else self._solve_batched_eager
        return timed_result(fn, bs, x0s, repeats=repeats, warmup=warmup)


def _interior(local, split) -> tuple[int, ...]:
    """The padded operand of the overlap split's interior apply."""
    return tuple(n if d in split else n + 2 for d, n in enumerate(local))


def _slab(local, split) -> tuple[int, ...]:
    """The padded operand of the outermost split dim's shell slab."""
    d = max(split)
    return tuple(3 if e == d else n if e in split else n + 2 for e, n in enumerate(local))


# -- one-shot facade ----------------------------------------------------------

def solve(problem: HPCGProblem | None = None, *, method: str = "cg_nb",
          grid: tuple[int, int, int] | None = None, stencil: str = "27pt",
          options: SolverOptions | None = None, device=None, mesh=None,
          b: Any = None, x0: Any = None, **overrides) -> SolveResult:
    """Solve one system.  ``**overrides`` are ``SolverOptions`` fields
    (``tol=``, ``maxiter=``, ``kernels=``, ...) applied on top of ``options``.
    On a mesh (``mesh=`` or a mesh ``layout``) every rank calls it and gets
    its block of ``x``."""
    options = options or SolverOptions()
    if overrides:
        options = options.replace(**overrides)
    sess = SolverSession(problem, method=method, grid=grid, stencil=stencil,
                         options=options, device=device, mesh=mesh)
    return sess.solve(b=b, x0=x0)


def solve_batched(bs: Any, problem: HPCGProblem | None = None, *,
                  method: str = "cg_nb", grid: tuple[int, int, int] | None = None,
                  stencil: str = "27pt", options: SolverOptions | None = None,
                  device=None, mesh=None, x0s: Any = None, **overrides) -> SolveResult:
    """Solve a batch of right-hand sides ``bs`` (``(batch, nx, ny, nz)``) in
    one batched solve; the grid is ``bs.shape[1:]`` unless a problem or a
    grid is given.  ``**overrides`` are ``SolverOptions`` fields, as in
    :func:`solve`.  On a mesh every rank calls it with the global lanes
    (give ``grid`` when ``bs`` holds this rank's blocks) and gets its
    blocks of ``x``."""
    shape = tuple(bs.shape)
    if len(shape) != 4:
        raise ValueError(f"bs must be (batch, nx, ny, nz), got {shape}")
    if grid is None and problem is None:
        grid = shape[1:]
    options = options or SolverOptions()
    if overrides:
        options = options.replace(**overrides)
    sess = SolverSession(problem, method=method, grid=grid, stencil=stencil,
                         options=options, device=device, mesh=mesh)
    return sess.solve_batched(bs, x0s=x0s)
