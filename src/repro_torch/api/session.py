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
captures included.  Batched solves are not ported (ROADMAP queue 1 item 5).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.api.backend import (Backend, resolve_backend, resolve_matvec,
                                     resolve_precond)
from repro_torch.api.executable import MAX_BLOCK, SolveExecutable
from repro_torch.api.options import SolverOptions
from repro_torch.api.registry import REGISTRY, SolverSpec, get_solver
from repro_torch.api.timing import timed_result
from repro_torch.core.methods import Ops, SolveResult, run_method
from repro_torch.core.problems import HPCGProblem, make_problem
from repro_torch.core.solvers import LocalOp


class SolverSession:
    """A problem + method + options bound to one device.

    ``device`` defaults to the problem's device when a problem is given,
    else to ``"cuda"``; asking for CUDA without a card raises.
    """

    #: the largest block of steps an executable replays between two reads
    _max_block = MAX_BLOCK

    def __init__(self, problem: HPCGProblem | None = None, *,
                 method: str = "cg_nb",
                 grid: tuple[int, int, int] | None = None,
                 stencil: str = "27pt",
                 options: SolverOptions | None = None,
                 device=None):
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
        self.spec: SolverSpec = get_solver(method)
        self.backend: Backend = resolve_backend(device=problem.device)
        self._matvec = resolve_matvec(problem.stencil, self.options)
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
        self._executables: dict[tuple, SolveExecutable] = {}
        self._compile_stats: dict[tuple, dict] = {}

    # -- introspection --------------------------------------------------------
    @property
    def method(self) -> str:
        return self.spec.name

    @property
    def device(self) -> torch.device:
        return self.backend.device

    def describe(self) -> str:
        pre = (f" precond={self.precond.describe()}"
               if self.precond is not None else "")
        return (f"{self.method}/{self.problem.stencil.name} "
                f"grid={self.problem.shape} on {self.backend.describe()}"
                f"{' [kernels]' if self.options.kernels else ''}{pre}")

    def _solver_kwargs(self, A) -> dict:
        """tol/maxiter/norm_ref plus, for the methods that take one, the
        preconditioner apply bound against ``A``."""
        kw = self.options.solver_kwargs()
        if self.spec.accepts_precond:
            kw["M"] = None if self.precond is None else self.precond.bind(A)
        return kw

    def _use_fused_body(self) -> bool:
        """Route ``kernels=True`` solves of any method whose ``MethodDef``
        declares a fused kernel body (the registry's ``has_fused_body``
        capability) to the fused iteration: for merged CG/PCG the vector
        updates in one pass and the SpMV with the dot partials in another,
        for the pipelined CGs the reduction partials first and all vector
        recurrences in one pass, for the merged BiCGStabs three passes (two
        SpMVs, one with all nine partials).  Preconditioned methods stay on
        the fused route: the bound preconditioner apply composes inside the
        fused body (on its own kernels under ``use_kernels``).  (The reference's
        conditions on custom ``matvec_padded``/``dot`` overrides have no
        unported counterpart.)"""
        return (bool(self.options.kernels) and self.spec.has_fused_body
                and (self.precond is None or self.spec.accepts_precond))

    def _operator(self):
        """``LocalOp``; under ``kernels=True`` the ``KernelOp`` around it, whose
        SpMV makes the zero halo in the kernel (no pad pass).  The wrapped
        ``LocalOp`` keeps the padded kernel SpMV for its own ``matvec``
        (merged CG's initial residual, as in the reference)."""
        A = LocalOp(self.problem.stencil, matvec_padded=self._matvec)
        if self.options.kernels:
            from repro_torch.kernels.kernel_op import KernelOp
            return KernelOp(A)
        return A

    def _solve_eager(self, b: Any = None, x0: Any = None) -> SolveResult:
        """The eager loop (``run_method``, one host read per iteration): the
        yardstick of the cached solve, and the route on which each wrapper's
        launch count is each launch (a graph replay passes no wrapper)."""
        b, x0 = self._inputs(b, x0)
        opts = self.options
        if self._use_fused_body():
            A = self._operator()
            M = None if self.precond is None else self.precond.bind(A)
            ops = Ops(A, b, M=M, norm_ref=opts.norm_ref)
            return run_method(self.spec.method_def, ops, x0, tol=opts.tol,
                              maxiter=opts.maxiter, fused=True)
        A = self._operator()
        return self.spec.fn(A, b, x0, **self._solver_kwargs(A))

    def _inputs(self, b, x0) -> tuple[torch.Tensor, torch.Tensor]:
        def put(v, default):
            if v is None:
                return default()
            v = torch.as_tensor(v, dtype=self.problem.dtype, device=self.device)
            if tuple(v.shape) != self.problem.shape:
                raise ValueError(f"array shape {tuple(v.shape)} != problem "
                                 f"grid {self.problem.shape}")
            return v.contiguous()
        return put(b, self.problem.b), put(x0, self.problem.x0)

    # -- the executable cache --------------------------------------------------
    def _executable(self) -> SolveExecutable:
        """The executable for the problem's shape, built on first use (its
        state sets and graphs by its first solve, right after ``init``)."""
        shape = self.problem.shape
        ent = self._executables.get(shape)
        st = self._stats()
        if ent is None:
            opts = self.options
            A = self._operator()
            M = None if self.precond is None else self.precond.bind(A)
            ent = SolveExecutable(self.spec.method_def, A, M,
                                  fused=self._use_fused_body(), tol=opts.tol,
                                  maxiter=opts.maxiter, norm_ref=opts.norm_ref,
                                  shape=self.problem.shape, dtype=self.problem.dtype,
                                  device=self.device, max_block=self._max_block)
            st["misses"] += 1
            self._executables[shape] = ent
        else:
            st["hits"] += 1
        return ent

    def _stats(self) -> dict:
        return self._compile_stats.setdefault(
            (self.problem.shape, self.method, self.options.precond),
            {"hits": 0, "misses": 0, "compile_s": 0.0})

    def cache_stats(self) -> dict[tuple, dict]:
        """Executable-cache observability: ``{(shape, method, precond):
        {"hits", "misses", "compile_s"}}``.  ``shape`` is the problem grid;
        a miss is one executable built (its static buffers; on the card also
        one eager warm-up step and a CUDA graph captured for each block size
        and direction, made by the first solve that takes a step) and
        ``compile_s`` its measured wall-clock cost."""
        return {k: dict(v) for k, v in self._compile_stats.items()}

    def _solve_cached(self, b: torch.Tensor, x0: torch.Tensor) -> SolveResult:
        exe = self._executable()
        res = exe.solve(b, x0)
        self._stats()["compile_s"] = exe.compile_s
        return res

    def solve(self, b: Any = None, x0: Any = None) -> SolveResult:
        """Solve one system (``b``/``x0`` default to the problem's) through
        the executable cache."""
        return self._solve_cached(*self._inputs(b, x0))

    def timed_solve(self, b: Any = None, x0: Any = None, *,
                    repeats: int = 10,
                    warmup: int = 1) -> tuple[SolveResult, dict[str, float]]:
        """Solve with wall-clock stats; warm-up calls run outside the timed
        region (the first builds the kernels and the executable) and every
        call ends in a device synchronise."""
        b, x0 = self._inputs(b, x0)
        return timed_result(self._solve_cached, b, x0, repeats=repeats,
                            warmup=warmup)

    def solve_batched(self, bs, x0s=None) -> SolveResult:
        raise NotImplementedError(
            "batched solves are not ported yet (see ROADMAP.md queue 1 item 5)")


# -- one-shot facade ----------------------------------------------------------

def solve(problem: HPCGProblem | None = None, *, method: str = "cg_nb",
          grid: tuple[int, int, int] | None = None, stencil: str = "27pt",
          options: SolverOptions | None = None, device=None,
          b: Any = None, x0: Any = None, **overrides) -> SolveResult:
    """Solve one system.  ``**overrides`` are ``SolverOptions`` fields
    (``tol=``, ``maxiter=``, ``kernels=``, ...) applied on top of ``options``."""
    options = options or SolverOptions()
    if overrides:
        options = options.replace(**overrides)
    sess = SolverSession(problem, method=method, grid=grid, stencil=stencil,
                         options=options, device=device)
    return sess.solve(b=b, x0=x0)


def solve_batched(*args, **kwargs) -> SolveResult:
    raise NotImplementedError(
        "batched solves are not ported yet (see ROADMAP.md queue 1 item 5)")
