"""Single-source method definitions: each iterative method defined ONCE.

Counterpart of ``repro/core/methods.py`` (whose docstring gives the design
and the paper's barrier structure of every method).  A :class:`MethodDef` is
``init(ops, x0) -> state``, ``step(ops, state) -> state`` and an optional
``finalize(ops, x0, state) -> x``; ``state`` is a flat tuple of the declared
``vectors`` then the declared ``scalars``; ``res_scalar`` names the slot with
the squared-residual estimate that the driver's convergence check, residual
history and ``res_norm`` read.

The JAX ``lax.while_loop`` becomes the Python loop of :func:`run_method`.
Scalars stay 0-d tensors on the device; the loop reads the convergence test
to the host once per iteration, and the reference tests convergence every
iteration too, so both stop on the same iteration.  :func:`run_method_blocks`
is the same loop read once per block of steps (the session's executable
replays a block as a CUDA graph); a block that runs past the stop is run
again from its start for exactly the steps the loop needed, so it stops on
the same iteration with the same bits.

Ported here: every method of the reference — cg, cg_nb, pcg, cg_merged,
pcg_merged, cg_pipe, pcg_pipe, bicgstab_merged and pbicgstab_merged (each
merged and pipelined method with its fused body), bicgstab, pbicgstab,
bicgstab_b1, jacobi, gauss_seidel_rb and gauss_seidel — and the resilient
driver (``repro/core/methods.py::_run_resilient``): the breakdown guards of
:class:`GuardSpec` in the loop condition, residual replacement through the
methods' ``refresh`` hooks, and the telemetry buffer of the loop-carry
scalars, on every driver (:class:`Watch`).

The paper's barrier structure is the order a step issues its statements
in.  A reduction whose registry entry declares a window (``reduction_hides``
in ``repro_torch.api.registry``: ``"vec"``, ``"spmv"``, ``"pipe"``) is
started with ``ops.dotn_start``, the work that does not depend on it is
issued, and only then is it waited for; on a mesh the collective is in
flight meanwhile (the paper's ``MPI_Iallreduce``), on one device the handle
resolved at once.  This is what the reference's ``lax.optimization_barrier``
pins in bicgstab_b1 and the pipelined CGs.  Only the issue order of
independent statements differs from the plain recurrence, so no bit does;
no handle outlives its step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

#: typed loop-exit statuses (``SolveResult.status``); the reference's codes
STATUS_CONVERGED = 0    # res_scalar dropped below (tol * norm_ref)^2
STATUS_MAXITER = 1      # iteration budget exhausted, residual still finite
STATUS_BREAKDOWN = 2    # NaN scalars or a method guard fired (rho/omega
#                         underflow, negative curvature on a non-SPD operator)
STATUS_DIVERGED = 3     # infinite residual, or past divergence_factor^2 * ||r0||^2
STATUS_STAGNATED = 4    # no relative progress for stagnation_window iters

STATUS_NAMES = ("converged", "maxiter", "breakdown", "diverged", "stagnated")


def status_name(code) -> str:
    """Human name for a ``SolveResult.status`` code."""
    return STATUS_NAMES[int(code)]


@dataclasses.dataclass(frozen=True)
class GuardSpec:
    """Breakdown-guard thresholds of the resilient driver (opt-in).

    Every check reads scalars the loop already carries, so arming the guards
    adds no reduction and leaves a healthy solve bit for bit as it was.

    ``breakdown_eps``      ρ-underflow threshold of the BiCGStab family
                           (fires when ρ² < ε²·‖r₀‖²·‖r‖²).
    ``divergence_factor``  exit with ``diverged`` once the squared residual
                           exceeds ``factor² · max(‖r₀‖², thresh²)``.
    ``stagnation_window``  0 disables; N > 0 exits with ``stagnated`` after
                           N consecutive iterations without the squared
                           residual falling below ``stagnation_rtol`` × the
                           best seen so far.
    """

    breakdown_eps: float = 1e-12
    divergence_factor: float = 1e8
    stagnation_window: int = 0
    stagnation_rtol: float = 1.0

    def __post_init__(self):
        if self.breakdown_eps < 0 or self.divergence_factor <= 1:
            raise ValueError(
                f"GuardSpec: breakdown_eps must be >= 0 and "
                f"divergence_factor > 1, got {self.breakdown_eps!r}/"
                f"{self.divergence_factor!r}")
        if self.stagnation_window < 0 or not 0 < self.stagnation_rtol <= 1:
            raise ValueError(
                f"GuardSpec: stagnation_window >= 0 and 0 < stagnation_rtol "
                f"<= 1 required, got {self.stagnation_window!r}/"
                f"{self.stagnation_rtol!r}")


class SolveBreakdown(RuntimeError):
    """A guarded solve ended abnormally under ``on_breakdown="raise"``.

    Carries the method name and the whole :class:`SolveResult` (``.method``,
    ``.result``): the typed status, the iterate and the residual history of
    the failed attempt.
    """

    def __init__(self, method: str, result: "SolveResult"):
        self.method = method
        self.result = result
        super().__init__(
            f"{method}: solve exited with status="
            f"{status_name(result.status)!r} after {int(result.iters)} "
            f"iterations (res_norm={float(result.res_norm):.3e})")


class SolveResult(NamedTuple):
    x: torch.Tensor
    iters: int                # number of completed iterations
    res_norm: torch.Tensor    # final ||r||_2 (method's own residual estimate)
    history: torch.Tensor     # (maxiter+1,) residual-norm history, NaN-padded
    #: opt-in per-iteration telemetry: a ``(rows, len(mdef.scalars))``
    #: NaN-padded buffer of the declared loop-carry scalars, row k the state
    #: after iteration k (row 0 the initial state; iterations past the
    #: buffer overwrite its last row); ``None`` when off
    telemetry: torch.Tensor | None = None
    status: int | None = None               # one of the STATUS_* codes


def _default_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a·b`` by ``torch.dot``.  A batch of lanes (4-D operands) gets each
    lane's own ``torch.dot``, the single solve's reduction in its order,
    stacked to shape ``(B, 1, 1, 1)`` so that it broadcasts against the
    lanes' vectors (a sum over the last three axes would sum in another
    order)."""
    if a.dim() == 4:
        return torch.stack([torch.dot(ai.reshape(-1), bi.reshape(-1))
                            for ai, bi in zip(a, b)]).view(-1, 1, 1, 1)
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _identity(v: torch.Tensor) -> torch.Tensor:
    return v


class Ready:
    """The handle of a reduction that finished when it was started (no
    collective to wait for): ``wait()`` gives its value."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value

    def wait(self):
        return self.value


def _own(A, dot, name: str):
    """The operator's own ``name`` hook when the caller passes no foreign
    ``dot`` (or passes the operator's own), else None."""
    if dot is None or getattr(dot, "__self__", None) is A:
        return getattr(A, name, None)
    return None


def _stacked_dot(A, dot):
    """``dotn(*pairs) -> tuple``: the operator's own stacked reduction when
    the caller passes no foreign ``dot``, else per-pair calls of ``dot``."""
    dn = _own(A, dot, "dotn")
    if dn is not None:
        return dn
    d = dot or _default_dot

    def dotn(*pairs):
        return tuple(d(a, b) for a, b in pairs)

    return dotn


def _stacked_dot_start(A, dot):
    """``dotn_start(*pairs) -> handle``: the operator's own started stacked
    reduction (its ``wait()`` gives the tuple) when it has one, else the
    reduction done at once (:class:`Ready`)."""
    ds = _own(A, dot, "dotn_start")
    if ds is not None:
        return ds
    dotn = _stacked_dot(A, dot)

    def dotn_start(*pairs):
        return Ready(dotn(*pairs))

    return dotn_start


#: the full surface a MethodDef body may touch on its ``ops`` context (the
#: write-once contract, stated once so the AST lint
#: ``repro_torch.analysis.lint_methods`` and the reader of this file agree):
#: a body calling anything else couples itself to one backend
OPS_PROTOCOL = frozenset({
    "A", "b", "M", "dot", "dot2", "dotn", "dotn_start", "matvec", "diag", "norm_ref",
    "params",
})

#: what a MethodDef may touch on the operator itself (``ops.A``: ``LocalOp``
#: or ``kernels.kernel_op.KernelOp``).  ``base`` unwraps a ``KernelOp`` to its
#: inner operator; everything from ``spmv_dots`` on is a fused-kernel hook a
#: ``fused_step`` body targets (``KernelOp`` supplies them, one per fused pass)
OPERATOR_PROTOCOL = frozenset({
    "matvec", "matvec_local", "pad_exchange", "diag", "stencil", "dot", "dotn",
    "dotn_start", "sum_partials", "sum_partials_start", "base", "spmv_dots", "cg_body",
    "spmv_dots3", "fused_dots", "fused_dots_start", "pipe_body", "pcg_body",
    "ppipe_body", "bicgstab_spmv_dots", "bicgstab_update1", "bicgstab_spmv_update",
})


class Ops:
    """The execution context a :class:`MethodDef` runs against.

    ``M`` is the bound preconditioner apply ``z = M⁻¹ r`` (identity when
    ``None``); ``dot`` defaults to the operator's own reduction when it has one, else
    :func:`_default_dot`; ``dotn`` stacks dot products (see
    :func:`_stacked_dot`) and ``dotn_start`` starts the same reduction and
    returns a handle whose ``wait()`` gives the tuple (on a mesh the
    collective is in flight until then; elsewhere it resolved at once).
    ``norm_ref=None`` resolves to ``||b||``; the paper's absolute HPCCG
    criterion is ``norm_ref=1.0``.
    """

    __slots__ = ("A", "b", "M", "dot", "dotn", "dotn_start", "norm_ref", "params")

    def __init__(self, A, b, *, M=None, dot=None, norm_ref=None,
                 params: dict | None = None):
        self.A = A
        self.b = b
        self.M = M if M is not None else _identity
        own = getattr(A, "dot", None)
        self.dot = dot if dot is not None else (own or _default_dot)
        self.dotn = _stacked_dot(A, dot)
        self.dotn_start = _stacked_dot_start(A, dot)
        self.params = params or {}
        if norm_ref is None:
            norm_ref = torch.sqrt(self.dot(b, b))
        self.norm_ref = norm_ref

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.A.matvec(x)

    def dot2(self, a, b, c, d) -> tuple:
        """Two dot products in one stacked reduction."""
        return self.dotn((a, b), (c, d))

    @property
    def diag(self):
        return self.A.diag


@dataclasses.dataclass(frozen=True)
class MethodDef:
    """One iterative method, defined once (see the reference's docstring).

    ``fused_init``/``fused_step`` (present iff ``fused_kernels`` is
    non-empty) are the same iteration written against the fused-kernel hooks
    of ``kernels.kernel_op.KernelOp``.  ``guard`` (``(ops, state, rr0,
    eps) -> bool``: the next step would amplify a breakdown) and ``refresh``
    (``(ops, x0, state) -> state``: the true residual and its recurrence
    images recomputed from the iterate) are the resilient driver's hooks
    (:class:`Watch`).
    """

    name: str
    vectors: tuple[str, ...]
    scalars: tuple[str, ...]
    res_scalar: str
    init: Callable
    step: Callable
    finalize: Callable | None = None
    variant_of: str | None = None
    accepts_precond: bool = False
    stationary: bool = False
    reduce_hide: str = "none"
    params: tuple[str, ...] = ()
    default_maxiter: int = 500
    fused_kernels: tuple[str, ...] = ()
    fused_init: Callable | None = None
    fused_step: Callable | None = None
    guard: Callable | None = None
    refresh: Callable | None = None
    refresh_spmvs: int = 0

    def __post_init__(self):
        if self.res_scalar not in self.scalars:
            raise ValueError(
                f"{self.name!r}: res_scalar {self.res_scalar!r} not in "
                f"declared scalars {self.scalars}")
        if bool(self.fused_kernels) != (self.fused_step is not None):
            raise ValueError(
                f"{self.name!r}: fused_kernels and fused_step must be "
                f"declared together")
        if self.fused_step is not None and self.fused_init is None:
            raise ValueError(f"{self.name!r}: fused_step without fused_init")
        if (self.refresh is None) != (self.refresh_spmvs == 0):
            raise ValueError(
                f"{self.name!r}: refresh and refresh_spmvs must be declared "
                f"together")

    @property
    def res_index(self) -> int:
        """Flat state index of the ``res_scalar`` slot."""
        return len(self.vectors) + self.scalars.index(self.res_scalar)

    @property
    def has_fused_body(self) -> bool:
        return self.fused_step is not None

    @property
    def has_refresh(self) -> bool:
        return self.refresh is not None


METHODS: dict[str, MethodDef] = {}


def register_method(mdef: MethodDef) -> MethodDef:
    if mdef.name in METHODS:
        raise ValueError(f"method {mdef.name!r} already defined")
    if mdef.variant_of is not None and mdef.variant_of not in METHODS:
        raise ValueError(
            f"{mdef.name!r}: unknown baseline {mdef.variant_of!r} "
            f"(define the classical method first)")
    METHODS[mdef.name] = mdef
    return mdef


def get_method(name: str) -> MethodDef:
    """Look up a MethodDef; unknown names raise a ValueError listing the
    known methods."""
    try:
        return METHODS[name]
    except KeyError:
        raise ValueError(
            f"unknown method {name!r}; known methods: "
            f"{sorted(METHODS)}") from None


def method_names() -> list[str]:
    return sorted(METHODS)


# =============================================================================
# The generic driver: MethodDef + Ops -> a whole solve
# =============================================================================

def _status_basic(res2: torch.Tensor, thresh2) -> int:
    """Loop-exit classification from the residual scalar alone."""
    if bool(torch.isnan(res2)):
        return STATUS_BREAKDOWN
    if bool(torch.isinf(res2)):
        return STATUS_DIVERGED
    return STATUS_CONVERGED if bool(res2 < thresh2) else STATUS_MAXITER


class Watch:
    """The resilient driver's terms around a method's step, for one solve or
    for one executable's static buffers (``repro/core/methods.py::
    _run_resilient``, which carries them in its ``lax.while_loop``).

    * **Guards** (``guard_spec``): the loop condition becomes ``res2 >=
      thresh2`` and no guard fired on that state: NaN in any loop-carry
      scalar, ``res2 > div2`` (``div2 = factor² · max(rr0, thresh2)``,
      ``rr0`` the initial ``res2``), the method's ``guard`` hook and, with
      ``stagnation_window = N > 0``, N steps in a row without ``res2``
      falling below ``stagnation_rtol`` × the best so far.  They are
      elementwise terms on one ``torch.stack`` of the scalar slots (the
      telemetry row), so they join the condition the driver already reads
      and add no read.  The stagnation counters ``best2`` and ``since``
      ride at the end of the state (:meth:`begin`), so a block that is
      rolled back restarts them from its start.
    * **Residual replacement** (``refresh_every = N > 0``): the method's
      ``refresh`` hook after every N-th step, before that step's condition,
      norm and row are taken (the reference's order).
    * **Telemetry** (``telemetry = rows > 0``): the stacked scalar slots of
      each state, row k after iteration k, clamped at the last row.

    ``rr0`` and ``div2`` are held in tensors that :meth:`begin` fills on the
    first solve and overwrites on later ones, so a captured graph reads each
    solve's own.  A batch of lanes (scalar slots ``(B, 1, 1, 1)``) gets every
    term lane by lane.  With every term off a watch runs the method's plain
    loop: :meth:`step` is the method's step, :meth:`go` the one comparison
    ``res2 >= thresh2``, and :meth:`begin` adds nothing to the state.
    """

    def __init__(self, mdef: MethodDef, ops: Ops, x0: torch.Tensor | None = None, *,
                 guard_spec: GuardSpec | None = None, refresh_every: int = 0,
                 telemetry: int = 0, maxiter: int):
        if refresh_every < 0:
            raise ValueError(f"refresh_every must be >= 0, got {refresh_every}")
        if refresh_every and mdef.refresh is None:
            raise ValueError(
                f"{mdef.name!r} declares no residual-replacement hook; "
                f"refresh_every applies only to methods with one "
                f"(the merged/pipelined variants)")
        self.mdef, self.ops, self.x0 = mdef, ops, x0
        self.spec = guard_spec
        self.window = guard_spec.stagnation_window if guard_spec is not None else 0
        self.refresh_every = int(refresh_every)
        self.cap = min(int(telemetry), maxiter + 1) if telemetry else 0
        self.nvec = len(mdef.vectors)
        self.nslots = self.nvec + len(mdef.scalars)
        self.ridx = mdef.res_index
        self.rr0: torch.Tensor | None = None
        self.div2: torch.Tensor | None = None

    @property
    def resilient(self) -> bool:
        """Guards or residual replacement: the status is classified as the
        reference's resilient driver does (:meth:`status`)."""
        return self.spec is not None or bool(self.refresh_every)

    @property
    def needs_row(self) -> bool:
        return self.spec is not None or bool(self.cap)

    def refresh_at(self, k: int) -> bool:
        """Whether the step that completes iteration ``k`` refreshes."""
        return bool(self.refresh_every) and k % self.refresh_every == 0

    def begin(self, state: tuple, thresh2) -> tuple:
        """``init``'s state with the stagnation counters appended (``best2 =
        rr0``, ``since = 0``), after ``rr0`` and ``div2`` are taken from it."""
        rr0 = state[self.ridx]
        if self.spec is not None:
            t = torch.as_tensor(thresh2, dtype=rr0.dtype, device=rr0.device)
            div2 = (self.spec.divergence_factor ** 2) * torch.maximum(rr0, t)
            if self.rr0 is None:
                self.rr0, self.div2 = rr0.clone(), div2
            else:
                self.rr0.copy_(rr0)
                self.div2.copy_(div2)
        if not self.window:
            return tuple(state)
        return tuple(state) + (rr0.clone(), torch.zeros(rr0.shape, dtype=torch.int64,
                                                          device=rr0.device))

    def step(self, step: Callable, ext: tuple, refresh: bool = False) -> tuple:
        """One step of the method on the state part of ``ext``, the refresh
        when asked, and the stagnation counters moved on."""
        state = tuple(step(self.ops, ext[:self.nslots]))
        if refresh:
            state = tuple(self.mdef.refresh(self.ops, self.x0, state))
        if not self.window:
            return state
        best2, since = ext[self.nslots:]
        res2 = state[self.ridx]
        improved = res2 < self.spec.stagnation_rtol * best2
        return state + (torch.minimum(res2, best2), torch.where(improved, 0, since + 1))

    def row(self, ext: tuple, out: torch.Tensor | None = None) -> torch.Tensor:
        """The scalar slots stacked on a last axis, in the right-hand side's
        dtype (into ``out``, a block's telemetry row, when given): the
        telemetry row, and the NaN guard's operand."""
        dt = self.ops.b.dtype
        scalars = [s.to(dt) for s in ext[self.nvec:self.nslots]]
        return torch.stack(scalars, dim=-1, out=out)

    def _bad(self, ext: tuple, row: torch.Tensor) -> torch.Tensor:
        """Whether any guard fires on ``ext``: its terms side by side on the
        row's last axis, reduced by one ``any`` (few kernels in a graph)."""
        terms = [torch.isnan(row)]
        if self.mdef.guard is not None:
            terms.append(self.mdef.guard(self.ops, ext[:self.nslots], self.rr0,
                                         self.spec.breakdown_eps).unsqueeze(-1))
        terms.append((ext[self.ridx] > self.div2).unsqueeze(-1))
        if self.window:
            terms.append((ext[-1] >= self.window).unsqueeze(-1))
        return torch.cat(terms, dim=-1).any(-1)

    def go(self, ext: tuple, thresh2, row: torch.Tensor | None,
           out: torch.Tensor | None = None) -> torch.Tensor:
        """The loop condition on ``ext`` (without the ``k < maxiter`` term):
        ``res2 >= thresh2`` and, with the guards, no guard fired (``ok >
        bad`` on booleans)."""
        res2 = ext[self.ridx]
        if self.spec is None:
            return torch.ge(res2, thresh2, out=out)
        return torch.gt(torch.ge(res2, thresh2), self._bad(ext, row), out=out)

    def status(self, ext: tuple, thresh2) -> torch.Tensor:
        """The resilient driver's exit classification, as int32 codes of the
        residual slot's shape (a lane each in a batch)."""
        res2 = ext[self.ridx]
        nan_bad = torch.isnan(self.row(ext)).any(-1)
        code = torch.full(res2.shape, STATUS_MAXITER, dtype=torch.int32, device=res2.device)
        if self.window:
            code = torch.where(ext[-1] >= self.window, STATUS_STAGNATED, code)
        diverged = torch.isinf(res2)
        broke = nan_bad
        if self.spec is not None:
            diverged = diverged | (res2 > self.div2)
            if self.mdef.guard is not None:
                broke = broke | self.mdef.guard(self.ops, ext[:self.nslots], self.rr0,
                                                self.spec.breakdown_eps)
        code = torch.where(diverged, STATUS_DIVERGED, code)
        code = torch.where(broke, STATUS_BREAKDOWN, code)
        return torch.where((res2 < thresh2) & ~nan_bad, STATUS_CONVERGED, code).to(torch.int32)

    def new_telemetry(self, row: torch.Tensor, extra_rows: int = 0) -> torch.Tensor | None:
        """The NaN telemetry buffer with ``row`` (the initial state's) as row
        0: ``(cap, n_scalars)``, or ``(B, cap + extra_rows, n_scalars)`` for a
        batch (``extra_rows``: the stopped lanes' dump row); None when off."""
        if not self.cap:
            return None
        rows0 = row.reshape(-1, row.shape[-1])          # (1 or B, n_scalars)
        tele = torch.full((rows0.shape[0], self.cap + extra_rows, rows0.shape[1]),
                          float("nan"), dtype=row.dtype, device=row.device)
        tele[:, 0] = rows0
        return tele[0] if row.dim() == 1 else tele


def _put_rows(tele: torch.Tensor | None, rows: torch.Tensor, k: int, m: int) -> None:
    """Rows ``0..m-1`` of ``rows`` (the states after iterations ``k + 1 ..
    k + m``) into the telemetry buffer at ``min(iteration, cap - 1)``, as the
    eager loop writes them one at a time (the last write to the last row
    wins)."""
    if tele is None:
        return
    cap = tele.shape[0]
    lo, hi = k + 1, k + m
    end = min(hi, cap - 2)
    if lo <= end:
        tele[lo:end + 1] = rows[:end - lo + 1]
    if hi >= cap - 1:
        tele[cap - 1] = rows[m - 1]


def run_method(mdef: MethodDef, ops: Ops, x0: torch.Tensor, *,
               tol: float = 1e-6, maxiter: int | None = None,
               fused: bool = False, telemetry: int = 0,
               guard_spec: GuardSpec | None = None,
               refresh_every: int = 0) -> SolveResult:
    """Run ``mdef`` to convergence: a Python loop around its ``step``.

    The loop condition is the reference's ``res2 >= (tol·norm_ref)² and
    k < maxiter`` (NaN exits, as there), evaluated on the device and read to
    the host once per iteration; the history is written on the device.
    ``fused=True`` selects the fused-kernel body (``ops.A`` must then be a
    ``KernelOp``).

    ``telemetry=N``, ``guard_spec`` and ``refresh_every`` are the reference's
    (:class:`Watch`): the guards join the condition the loop reads, so they
    add no read; with all three off the loop is the plain one, bit for bit.
    ``status`` is always filled: from the residual scalar alone when neither
    guards nor residual replacement are on, else as the reference's
    resilient driver classifies it.
    """
    if maxiter is None:
        maxiter = mdef.default_maxiter
    if fused and not mdef.has_fused_body:
        raise ValueError(f"{mdef.name!r} declares no fused kernels")
    watch = Watch(mdef, ops, x0, telemetry=telemetry, guard_spec=guard_spec,
                  refresh_every=refresh_every, maxiter=maxiter)
    init = mdef.fused_init if fused else mdef.init
    step = mdef.fused_step if fused else mdef.step
    thresh2 = (tol * ops.norm_ref) ** 2
    ridx = mdef.res_index
    state = tuple(init(ops, x0))
    hist = torch.full((maxiter + 1,), float("nan"), dtype=ops.b.dtype,
                      device=ops.b.device)
    hist[0] = torch.sqrt(state[ridx])
    k = 0
    ext = watch.begin(state, thresh2)
    row = watch.row(ext) if watch.needs_row else None
    tele = watch.new_telemetry(row) if watch.cap else None
    go = watch.go(ext, thresh2, row)
    while k < maxiter and bool(go):                      # the one read
        ext = watch.step(step, ext, watch.refresh_at(k + 1))
        hist[k + 1] = torch.sqrt(ext[ridx])
        row = watch.row(ext) if watch.needs_row else None
        if tele is not None:
            tele[min(k + 1, watch.cap - 1)] = row
        go = watch.go(ext, thresh2, row)
        k += 1
    return _result(mdef, ops, x0, ext, k, hist, tele, watch, thresh2, copy=False)


def _result(mdef, ops, x0, ext, k, hist, tele, watch, thresh2, *, copy: bool,
            out: torch.Tensor | None = None) -> SolveResult:
    """The :class:`SolveResult` of a single solve from its final state
    ``ext``; ``copy``: the iterate is a static buffer's, so hand out a copy,
    or write it into ``out`` (the caller's donated ``x0``) and hand that out."""
    state = ext[:watch.nslots]
    res2 = state[mdef.res_index]
    if mdef.finalize:
        x = mdef.finalize(ops, x0, state)
    else:
        x = state[0].clone() if copy and out is None else state[0]
    if out is not None:
        x = out.copy_(x)
    status = (int(watch.status(ext, thresh2)) if watch.resilient
              else _status_basic(res2, thresh2))
    return SolveResult(x=x, iters=k, res_norm=torch.sqrt(res2), history=hist,
                       telemetry=tele, status=status)


# =============================================================================
# The block driver: the same loop, read to the host once per block of steps
# =============================================================================

def block_ladder(max_block: int) -> tuple[int, ...]:
    """The block sizes ``(1, 2, 4, ..., max_block)``; ``max_block`` is a
    power of two, so every count below it is a sum of distinct rungs."""
    if max_block < 1 or max_block & (max_block - 1):
        raise ValueError(f"max_block must be a power of two, got {max_block}")
    return tuple(1 << i for i in range(max_block.bit_length()))


def step_block(step: Callable, ops: Ops, state: tuple, n: int, thresh2,
               ridx: int, flags: torch.Tensor, norms: torch.Tensor,
               watch: Watch, rows: torch.Tensor | None = None,
               refresh: bool = False) -> tuple:
    """``n`` steps of ``step`` from ``state`` (with the ``watch``'s extras),
    with no host read.  Each step is :meth:`Watch.step` (the refresh after
    the last step when ``refresh``); for step ``i``, ``flags[i]`` is the
    loop condition after it (:meth:`Watch.go`, as :func:`run_method` tests
    it: a guard that fires mid-block ends the block's run as the
    convergence stop does), ``norms[i]`` the residual norm its history takes
    and ``rows[i]`` its telemetry row, all written on the device."""
    for i in range(n):
        state = watch.step(step, state, refresh and i == n - 1)
        row = (watch.row(state, out=None if rows is None else rows[i])
               if watch.needs_row else None)
        watch.go(state, thresh2, row, out=flags[i])
        torch.sqrt(state[ridx], out=norms[i])
    return state


def predict_steps(before: float, after: float, n: int, thresh: float) -> float:
    """Steps left until the residual norm falls below ``thresh`` at the rate
    it fell from ``before`` to ``after`` over the last ``n`` steps: ``n``
    again when it did not fall, inf when nothing is below ``thresh`` = 0."""
    if thresh <= 0.0:
        return math.inf
    if not 0.0 < after < before:
        return n
    return math.log(thresh / after) / (math.log(after / before) / n)


#: the share of the predicted steps a block may take: a Krylov residual
#: falls faster near the end than over the block before, and a block that
#: runs past the stop is run again in full
PREDICT_MARGIN = 0.5
#: the prediction before the first block, whose two steps (a pipelined
#: method's first residual is its initial one) give the first decay
FIRST_PREDICTION = 4


def pick_block(ladder: tuple[int, ...], predicted: float, budget: int) -> int:
    """The largest rung that exceeds neither :data:`PREDICT_MARGIN` of the
    predicted steps left nor the iteration budget (the first rung at
    least)."""
    top = min(PREDICT_MARGIN * predicted, budget)
    return max([k for k in ladder if k <= top] or ladder[:1])


def block_budget(k: int, maxiter: int, watch: Watch) -> int:
    """The steps a block from iteration ``k`` may take: the iterations left
    and, under residual replacement, no more than reach the next multiple
    of ``refresh_every`` (so a block crosses a refresh only at its last
    step, and a graph need not know the iteration it starts at)."""
    budget = maxiter - k
    if watch.refresh_every:
        budget = min(budget, watch.refresh_every - k % watch.refresh_every)
    return budget


def run_method_blocks(mdef: MethodDef, ops: Ops, x0: torch.Tensor, *,
                      tol: float = 1e-6, maxiter: int | None = None,
                      fused: bool = False, runner,
                      pick: Callable = pick_block,
                      out: torch.Tensor | None = None) -> SolveResult:
    """:func:`run_method`'s solve, advanced in blocks of steps with one host
    read per block.

    ``init`` runs eagerly; the runner then takes ``k`` steps at a time
    (``k`` from ``runner.ladder``, chosen by ``pick`` from the steps left
    at the faster of the last block's and the whole solve's decay, never
    past ``maxiter``), each step writing its loop condition and residual
    norm on the device.  The host reads the block's conditions once: a
    block that ran past the first
    false condition is dropped and exactly the steps the loop needed are
    run again from the block's start, in rungs of the ladder with no read
    between them.  So ``iters``, ``x``, ``res_norm``, ``history`` and
    ``status`` are :func:`run_method`'s, bit for bit; ``pick`` sets only how
    many steps a read covers.

    ``runner.watch`` (built on the runner's static buffers) holds
    :func:`run_method`'s guards, residual replacement and telemetry.  Its
    stagnation counters ride in the state, so a rollback restarts them; a
    block never crosses a multiple of ``refresh_every`` but at its last step
    (:func:`block_budget`), which the runner's refreshing variant of that
    block size runs; the telemetry rows each block stages are copied into
    the buffer as its norms are into the history.

    ``runner`` holds the state between blocks and must have been built on
    ``ops`` and this route (``api.executable.SolveExecutable``): its
    ``ladder`` is the block sizes, ``start(state, thresh2)`` takes
    ``init``'s state, ``run(n, refresh)`` takes ``n`` steps from the
    accepted state to a pending one and returns their conditions and norms
    (as :func:`step_block` writes them, the telemetry rows in
    ``runner.rows``), ``accept()`` keeps the pending state and ``state`` is
    the accepted one.

    ``out`` (the caller's donated ``x0``, read by ``init`` before any step)
    takes the iterate in place of a fresh copy of the runner's static
    buffer, and is the result's ``x``.
    """
    if maxiter is None:
        maxiter = mdef.default_maxiter
    if fused and not mdef.has_fused_body:
        raise ValueError(f"{mdef.name!r} declares no fused kernels")
    watch = runner.watch
    init = mdef.fused_init if fused else mdef.init
    thresh2 = (tol * ops.norm_ref) ** 2
    state = tuple(init(ops, x0))
    hist = torch.full((maxiter + 1,), float("nan"), dtype=ops.b.dtype,
                      device=ops.b.device)
    hist[0] = torch.sqrt(state[mdef.res_index])
    state = watch.begin(state, thresh2)
    row = watch.row(state) if watch.needs_row else None
    tele = watch.new_telemetry(row) if watch.cap else None
    go = watch.go(state, thresh2, row)
    k = 0
    if k < maxiter and bool(go):
        runner.start(state, thresh2)
        thresh, first = math.sqrt(float(thresh2)), float(hist[0])
        before, predicted = first, FIRST_PREDICTION
        while k < maxiter:
            n = pick(runner.ladder, predicted, block_budget(k, maxiter, watch))
            flags, norms = runner.run(n, watch.refresh_at(k + n))
            go = flags.tolist()                          # the block's one read
            took = next((i + 1 for i, g in enumerate(go) if not g), n)
            if took < n:                 # ran past the stop: redo from its start
                left = took
                while left:
                    m = max(r for r in runner.ladder if r <= left)
                    hist[k + 1:k + 1 + m] = runner.run(m)[1]
                    _put_rows(tele, runner.rows, k, m)
                    runner.accept()
                    k, left = k + m, left - m
                break
            hist[k + 1:k + 1 + n] = norms
            _put_rows(tele, runner.rows, k, n)
            runner.accept()
            k += n
            if not go[-1]:
                break
            after = float(norms[-1])
            # the faster of the last block's and the whole solve's decay: a
            # block on a plateau alone would predict a long way to go
            predicted = min(predict_steps(before, after, n, thresh),
                            predict_steps(first, after, k, thresh))
            before = after
        state = runner.state
    return _result(mdef, ops, x0, state, k, hist, tele, watch, thresh2, copy=True, out=out)


# =============================================================================
# The batched solve: B right-hand sides in one loop, each lane masked as it
# stops (the semantics of the reference's vmapped ``lax.while_loop``)
# =============================================================================

def _lane_status(res2: torch.Tensor, thresh2: torch.Tensor) -> torch.Tensor:
    """:func:`_status_basic` per lane: int32 codes of shape ``(B,)``."""
    code = torch.where(res2 < thresh2, STATUS_CONVERGED, STATUS_MAXITER)
    code = torch.where(torch.isinf(res2), STATUS_DIVERGED, code)
    code = torch.where(torch.isnan(res2), STATUS_BREAKDOWN, code)
    return code.view(-1).to(torch.int32)


def lanes_running(state: tuple, k: torch.Tensor, thresh2: torch.Tensor,
                  maxiter: int, watch: Watch) -> torch.Tensor:
    """Each lane's loop condition, :func:`run_method`'s (:meth:`Watch.go`
    and ``k < maxiter``): a bool tensor of shape ``(B, 1, 1, 1)``."""
    row = watch.row(state) if watch.spec is not None else None
    return watch.go(state, thresh2, row) & (k < maxiter)


def batched_start(mdef: MethodDef, ops: Ops, x0: torch.Tensor, *, tol: float,
                  maxiter: int, watch: Watch) -> tuple:
    """``init`` on the lanes of ``ops.b`` (``(B, nx, ny, nz)``) ->
    ``(state, k, thresh2, hist, tele)``.

    Every scalar slot gets the shape ``(B, 1, 1, 1)`` (an ``init`` may make
    a 0-d seed, as ``_merged_seed`` does), so the state's shapes are fixed.
    ``k`` is each lane's iteration count (int64, ``(B, 1, 1, 1)``),
    ``thresh2`` each lane's ``(tol·norm_ref)²`` in the state's dtype (a
    number rounds to it as the single loop's comparison rounds it), and
    ``hist`` the ``(B, maxiter + 2)`` history, NaN past column 0; its last
    column takes the writes of the lanes that have stopped.  The state
    carries the ``watch``'s extras (:meth:`Watch.begin`) and ``tele`` is the ``(B, rows + 1, n_scalars)`` telemetry buffer, whose
    last row takes the stopped lanes' writes (None without telemetry)."""
    b = ops.b
    lane = (b.shape[0], 1, 1, 1)
    like = dict(dtype=b.dtype, device=b.device)
    nvec = len(mdef.vectors)
    state = tuple(mdef.init(ops, x0))
    state = state[:nvec] + tuple(s if s.shape == lane else s.expand(lane).clone()
                                 for s in state[nvec:])
    thresh2 = (tol * ops.norm_ref) ** 2
    if isinstance(thresh2, torch.Tensor):
        thresh2 = thresh2.expand(lane).to(**like)
    else:
        thresh2 = torch.full(lane, thresh2, **like)
    hist = torch.full((lane[0], maxiter + 2), float("nan"), **like)
    hist[:, 0] = torch.sqrt(state[mdef.res_index]).view(-1)
    k = torch.zeros(lane, dtype=torch.int64, device=b.device)
    state = watch.begin(state, thresh2)
    tele = watch.new_telemetry(watch.row(state), extra_rows=1) if watch.cap else None
    return state, k, thresh2, hist, tele


def batched_step(step: Callable, ops: Ops, state: tuple, k: torch.Tensor,
                 thresh2: torch.Tensor, maxiter: int, ridx: int,
                 hist: torch.Tensor, watch: Watch,
                 refresh: bool = False, tele: torch.Tensor | None = None) -> tuple:
    """One step of every lane whose loop condition holds; the others keep
    their state, count and history (``torch.where``, never a multiply by a
    mask: a stopped lane's discarded step may hold NaN).  A step with no
    lane running changes nothing.  Returns ``(state, k)``; the history is
    written in place at each running lane's new ``k``, with no host read.

    The step is the ``watch``'s :meth:`Watch.step` (``refresh``: the
    refresh after it, on the running lanes, which all stand at the same
    iteration), the condition its :meth:`Watch.go`, and the telemetry row of
    each running lane goes to ``tele`` at ``min(k, rows - 1)``, a stopped
    lane's to the dump row."""
    active = lanes_running(state, k, thresh2, maxiter, watch)
    new = watch.step(step, state, refresh)
    state = tuple(torch.where(active, n, o) for n, o in zip(new, state))
    k = k + active
    slot = torch.where(active, k, maxiter + 1).view(-1, 1)
    hist.scatter_(1, slot, torch.sqrt(state[ridx]).view(-1, 1))
    if tele is not None:
        lanes, rows, nscal = tele.shape
        at = torch.where(active, torch.clamp(k, max=rows - 2), rows - 1)
        tele.scatter_(1, at.view(lanes, 1, 1).expand(lanes, 1, nscal),
                      watch.row(state).view(lanes, 1, nscal))
    return state, k


def batched_result(mdef: MethodDef, ops: Ops, x0: torch.Tensor, state: tuple,
                   k: torch.Tensor, thresh2: torch.Tensor, hist: torch.Tensor,
                   maxiter: int, watch: Watch,
                   tele: torch.Tensor | None = None,
                   out: torch.Tensor | None = None) -> SolveResult:
    """The per-lane :class:`SolveResult`: ``x`` ``(B, nx, ny, nz)``,
    ``iters`` and ``status`` int32 ``(B,)``, ``res_norm`` ``(B,)``, the
    NaN-padded ``history`` ``(B, maxiter + 1)`` and, with telemetry, the
    ``(B, rows, n_scalars)`` buffer.  ``out`` (the caller's donated ``x0``)
    takes ``x`` in place of a fresh copy."""
    ext, state = state, state[:watch.nslots]
    res2 = state[mdef.res_index]
    if mdef.finalize:
        x = mdef.finalize(ops, x0, state)
    else:
        x = state[0] if out is not None else state[0].clone()
    if out is not None:
        x = out.copy_(x)
    if watch.resilient:
        status = watch.status(ext, thresh2).view(-1)
    else:
        status = _lane_status(res2, thresh2)
    return SolveResult(x=x, iters=k.view(-1).to(torch.int32),
                       res_norm=torch.sqrt(res2).view(-1),
                       history=hist[:, :maxiter + 1].clone(),
                       telemetry=None if tele is None else tele[:, :-1].clone(),
                       status=status)


def run_method_batched(mdef: MethodDef, ops: Ops, x0: torch.Tensor, *,
                       tol: float = 1e-6, maxiter: int | None = None,
                       telemetry: int = 0, guard_spec: GuardSpec | None = None,
                       refresh_every: int = 0) -> SolveResult:
    """Solve the ``B`` lanes of ``ops.b`` (``(B, nx, ny, nz)``, ``x0`` alike)
    in one loop of :func:`batched_step`, read to the host once per step,
    while any lane runs: each lane's result is :func:`run_method`'s on that
    lane alone, bit for bit, as long as every operation of the step acts on
    each lane on its own (the dots are per lane, :func:`_default_dot`).
    The unfused body only, as in the reference.  ``telemetry``,
    ``guard_spec`` and ``refresh_every`` work lane by lane (a fired guard
    ends its lane as its loop condition does); the running lanes share one
    step count, which places the refreshes."""
    if maxiter is None:
        maxiter = mdef.default_maxiter
    ridx = mdef.res_index
    watch = Watch(mdef, ops, x0, telemetry=telemetry, guard_spec=guard_spec,
                  refresh_every=refresh_every, maxiter=maxiter)
    state, k, thresh2, hist, tele = batched_start(mdef, ops, x0, tol=tol,
                                                  maxiter=maxiter, watch=watch)
    steps = 0
    while bool(lanes_running(state, k, thresh2, maxiter, watch).any()):
        state, k = batched_step(mdef.step, ops, state, k, thresh2, maxiter, ridx, hist,
                                watch, watch.refresh_at(steps + 1), tele)
        steps += 1
    return batched_result(mdef, ops, x0, state, k, thresh2, hist, maxiter, watch, tele)


def batched_block(step: Callable, ops: Ops, state: tuple, k: torch.Tensor, n: int,
                  thresh2: torch.Tensor, maxiter: int, ridx: int, hist: torch.Tensor,
                  rec: torch.Tensor, watch: Watch,
                  refresh: bool = False, tele: torch.Tensor | None = None) -> tuple:
    """``n`` :func:`batched_step` calls with no host read (``refresh``: the
    last one refreshes).  Row ``i`` of ``rec`` (``(n, B)`` at least) gets,
    after step ``i``, each lane's residual norm where its loop condition
    holds and -1 where the lane has stopped.  Returns ``(state, k)``."""
    for i in range(n):
        state, k = batched_step(step, ops, state, k, thresh2, maxiter, ridx, hist,
                                watch, refresh and i == n - 1, tele)
        running = lanes_running(state, k, thresh2, maxiter, watch)
        rec[i].copy_(torch.where(running, torch.sqrt(state[ridx]), -1.0).view(-1))
    return state, k


def run_batched_blocks(mdef: MethodDef, ops: Ops, x0: torch.Tensor, *,
                       tol: float = 1e-6, maxiter: int | None = None, runner,
                       pick: Callable = pick_block,
                       out: torch.Tensor | None = None) -> SolveResult:
    """:func:`run_method_batched`'s solve, advanced in blocks of steps with
    one host read per block.

    A step with no lane running is a no-op, so a block that runs past the
    last lane's stop needs no rollback, and the result is
    :func:`run_method_batched`'s bit for bit.  The block size comes from
    ``pick`` (:func:`pick_block`) on the steps the slowest running lane is
    predicted to need (each lane at the faster of its last block's and its
    whole solve's decay); every running lane has taken every step so far, so
    the budget is ``maxiter`` less the steps taken (and, under residual
    replacement, no more than reach the next refresh: :func:`block_budget`).

    ``runner`` (``api.executable.BatchedSolveExecutable``) holds the state:
    ``start(state, k, thresh2, hist, tele)`` takes :func:`batched_start`'s,
    ``run(n, refresh)`` takes ``n`` steps (:func:`batched_block`) and
    returns their ``(n, B)`` record, and ``state``, ``k``, ``hist`` and
    ``tele`` are the current ones; ``watch`` is its :class:`Watch`.
    ``out`` (the caller's donated ``x0``) takes ``x``, as in
    :func:`run_method_blocks`.
    """
    if maxiter is None:
        maxiter = mdef.default_maxiter
    ridx, watch = mdef.res_index, runner.watch
    state, k, thresh2, hist, tele = batched_start(mdef, ops, x0, tol=tol,
                                                  maxiter=maxiter, watch=watch)
    running = lanes_running(state, k, thresh2, maxiter, watch).view(-1)
    first, thresh = torch.stack([
        torch.where(running, torch.sqrt(state[ridx]).view(-1), -1.0),
        torch.sqrt(thresh2).view(-1)]).tolist()              # the set-up's one read
    if any(v >= 0 for v in first):
        runner.start(state, k, thresh2, hist, tele)
        before, predicted, steps = first, FIRST_PREDICTION, 0
        while steps < maxiter:
            n = pick(runner.ladder, predicted, block_budget(steps, maxiter, watch))
            after = runner.run(n, watch.refresh_at(steps + n))[n - 1].tolist()   # the block's one read
            steps += n
            lanes = [i for i, v in enumerate(after) if v >= 0]
            if not lanes:
                break
            predicted = max(min(predict_steps(before[i], after[i], n, thresh[i]),
                                predict_steps(first[i], after[i], steps, thresh[i]))
                            for i in lanes)
            before = after
        state, k, hist, tele = runner.state, runner.k, runner.hist, runner.tele
    return batched_result(mdef, ops, x0, state, k, thresh2, hist, maxiter, watch, tele,
                          out=out)


# =============================================================================
# Krylov methods — conjugate gradients
# =============================================================================

def _rho_underflow_guard(rho_idx: int, rr_idx: int):
    """BiCGStab-family breakdown guard: ρ = (r̂, r) collapsing relative to
    ‖r₀‖‖r‖ (the shadow residual has become numerically orthogonal)."""
    def guard(ops, state, rr0, eps):
        rho, rr = state[rho_idx], state[rr_idx]
        return rho * rho < (eps * eps) * rr0 * rr
    return guard


def _nonpositive_guard(idx: int):
    """CG-family negative-curvature guard: the carried inner product at
    ``idx`` must stay positive on an SPD operator."""
    def guard(ops, state, rr0, eps):
        return state[idx] <= 0.0
    return guard


def _cg_init(ops, x0):
    r = ops.b - ops.matvec(x0)
    rr = ops.dot(r, r)
    return (x0, r, r, rr)


def _cg_step(ops, state):
    """Classical CG (HPCCG reference): 2 reductions; ``p·Ap`` blocks and the
    ``x`` update runs under ``r·r``."""
    x, r, p, rr = state
    Ap = ops.matvec(p)
    pAp = ops.dot(p, Ap)
    alpha = rr / pAp
    r = r - alpha * Ap
    pending = ops.dotn_start((r, r))
    x = x + alpha * p                 # under r·r
    (rr_new,) = pending.wait()
    beta = rr_new / rr
    p = r + beta * p
    return (x, r, p, rr_new)


register_method(MethodDef(
    name="cg", vectors=("x", "r", "p"), scalars=("rr",), res_scalar="rr",
    init=_cg_init, step=_cg_step))


def _cg_nb_init(ops, x0):
    r = ops.b - ops.matvec(x0)
    Ap = ops.matvec(r)                # p_0 = r_0
    an = ops.dot(r, r)
    ad = ops.dot(Ap, r)
    return (x0, r, r, Ap, an, ad)


def _cg_nb_step(ops, state):
    """Nonblocking CG (paper Alg. 1, sign-fixed line 9 as in the reference):
    the SpMV is applied to ``r``; ``A·p`` is rebuilt as a vector update.
    The SpMV runs under ``r·r`` and the lagged ``x`` update under
    ``Ap·p``: no reduction blocks."""
    x, r, p, Ap, an, ad = state
    alpha = an / ad
    r_new = r - alpha * Ap
    pending = ops.dotn_start((r_new, r_new))
    Ar = ops.matvec(r_new)            # under r·r
    (an_new,) = pending.wait()
    beta = an_new / an
    Ap_new = Ar + beta * Ap
    p_new = r_new + beta * p
    pending = ops.dotn_start((Ap_new, p_new))
    x = x + alpha * p                 # lagged update with the OLD p, under Ap·p
    (ad_new,) = pending.wait()
    return (x, r_new, p_new, Ap_new, an_new, ad_new)


def _cg_nb_finalize(ops, x0, state):
    # the x update lags one iteration; apply the final correction term
    x, r, p, Ap, an, ad = state
    return x + (an / ad) * p


register_method(MethodDef(
    name="cg_nb", vectors=("x", "r", "p", "Ap"), scalars=("an", "ad"),
    res_scalar="an", init=_cg_nb_init, step=_cg_nb_step,
    finalize=_cg_nb_finalize, variant_of="cg",
    guard=_nonpositive_guard(5)))


def _pcg_init(ops, x0):
    r = ops.b - ops.matvec(x0)
    z = ops.M(r)
    rz = ops.dot(r, z)
    rr = ops.dot(r, r)
    return (x0, r, z, rz, rr)


def _pcg_step(ops, state):
    """Preconditioned CG; ``M`` must be SPD-preserving.  ``p·Ap`` and ``r·z``
    block (the latter pair-fused with the check-only ``r·r``, whose window
    the pair shares: the ``x`` update runs under it); the convergence check
    stays on the TRUE residual ``||r||``.  With ``M = I`` this is
    arithmetically identical to ``cg``."""
    x, r, p, rz, rr = state
    Ap = ops.matvec(p)
    pAp = ops.dot(p, Ap)
    alpha = rz / pAp
    r = r - alpha * Ap
    z = ops.M(r)
    pending = ops.dotn_start((r, z), (r, r))
    x = x + alpha * p                 # under (r·z, r·r)
    rz_new, rr_new = pending.wait()
    beta = rz_new / rz
    p = z + beta * p
    return (x, r, p, rz_new, rr_new)


register_method(MethodDef(
    name="pcg", vectors=("x", "r", "p"), scalars=("rz", "rr"),
    res_scalar="rr", init=_pcg_init, step=_pcg_step,
    variant_of="cg", accepts_precond=True,
    guard=_nonpositive_guard(3)))


def _cg_merged_scalars(gamma, delta, gamma_prev, alpha_prev):
    """β and the Saad-recurrence α of merged CG; seeding ``γ_prev = inf,
    α_prev = 1`` makes the first pass ``β = 0, α = γ/δ``."""
    beta = gamma / gamma_prev
    alpha = gamma / (delta - beta * gamma / alpha_prev)
    return alpha, beta


def _merged_seed(ref: torch.Tensor):
    inf = torch.full((), float("inf"), dtype=ref.dtype, device=ref.device)
    one = torch.ones((), dtype=ref.dtype, device=ref.device)
    return inf, one


def _cg_merged_init(ops, x0):
    r = ops.b - ops.matvec(x0)
    w = ops.matvec(r)
    gamma, delta = ops.dotn((r, r), (w, r))
    zero = torch.zeros_like(ops.b)
    inf, one = _merged_seed(gamma)
    return (x0, r, zero, zero, w, gamma, delta, inf, one)


def _cg_merged_step(ops, state):
    """Merged-reduction CG (Chronopoulos–Gear): ONE stacked reduction of
    ``γ = r·r`` and ``δ = w·r`` per iteration; ``s = A p`` by recurrence."""
    x, r, p, s, w, gamma, delta, gamma_prev, alpha_prev = state
    alpha, beta = _cg_merged_scalars(gamma, delta, gamma_prev, alpha_prev)
    p = r + beta * p
    s = w + beta * s
    x = x + alpha * p
    r = r - alpha * s
    w = ops.matvec(r)
    gamma_new, delta_new = ops.dotn((r, r), (w, r))
    return (x, r, p, s, w, gamma_new, delta_new, gamma, alpha)


def _cg_merged_fused_init(ops, x0):
    # the initial residual uses the wrapped operator's matvec; the fused
    # kernels take over from the first spmv_dots pass onward
    r = ops.b - ops.A.base.matvec(x0)
    w, delta, gamma = ops.A.spmv_dots(r)
    zero = torch.zeros_like(ops.b)
    inf, one = _merged_seed(gamma)
    return (x0, r, zero, zero, w, gamma, delta, inf, one)


def _cg_merged_fused_step(ops, state):
    """The merged-CG iteration as TWO fused memory passes (``ops.A`` is a
    ``KernelOp``): the four vector updates (``fused_cg_body``), then the
    SpMV with both dot partials (``stencil_spmv_dots``).  α and β stay on
    the device and reach the kernel by pointer."""
    x, r, p, s, w, gamma, delta, gamma_prev, alpha_prev = state
    alpha, beta = _cg_merged_scalars(gamma, delta, gamma_prev, alpha_prev)
    x, r, p, s = ops.A.cg_body(alpha, beta, x, r, p, s, w)     # pass 1
    w, delta_new, gamma_new = ops.A.spmv_dots(r)               # pass 2
    return (x, r, p, s, w, gamma_new, delta_new, gamma, alpha)


def _cg_merged_refresh(ops, x0, state):
    """Residual replacement: recompute
    the TRUE residual and every recurrence image from the iterate."""
    x, r, p, s, w, gamma, delta, gamma_prev, alpha_prev = state
    r = ops.b - ops.matvec(x)
    s = ops.matvec(p)
    w = ops.matvec(r)
    gamma, delta = ops.dotn((r, r), (w, r))
    return (x, r, p, s, w, gamma, delta, gamma_prev, alpha_prev)


register_method(MethodDef(
    name="cg_merged", vectors=("x", "r", "p", "s", "w"),
    scalars=("gamma", "delta", "gamma_prev", "alpha_prev"),
    res_scalar="gamma", init=_cg_merged_init, step=_cg_merged_step,
    variant_of="cg", reduce_hide="merged",
    fused_kernels=("cg_body", "spmv_dots"),
    fused_init=_cg_merged_fused_init, fused_step=_cg_merged_fused_step,
    guard=_nonpositive_guard(6),
    refresh=_cg_merged_refresh, refresh_spmvs=3))


def _pcg_merged_init(ops, x0):
    r = ops.b - ops.matvec(x0)
    u = ops.M(r)
    w = ops.matvec(u)
    gamma, delta, rr = ops.dotn((r, u), (w, u), (r, r))
    zero = torch.zeros_like(ops.b)
    inf, one = _merged_seed(gamma)
    return (x0, r, u, zero, zero, w, gamma, delta, rr, inf, one)


def _pcg_merged_step(ops, state):
    """Merged-reduction PCG (Chronopoulos–Gear with ``u = M⁻¹r``); the
    TRUE-residual ``r·r`` rides in the same stacked reduction (3 scalars), so
    stopping matches ``pcg``.  ``M`` must be SPD-preserving."""
    x, r, u, p, s, w, gamma, delta, rr, gamma_prev, alpha_prev = state
    alpha, beta = _cg_merged_scalars(gamma, delta, gamma_prev, alpha_prev)
    p = u + beta * p
    s = w + beta * s
    x = x + alpha * p
    r = r - alpha * s
    u = ops.M(r)
    w = ops.matvec(u)
    gamma_new, delta_new, rr_new = ops.dotn((r, u), (w, u), (r, r))
    return (x, r, u, p, s, w, gamma_new, delta_new, rr_new, gamma, alpha)


def _pcg_merged_guard(ops, state, rr0, eps):
    # gamma = r·u and delta = u·Au must both stay positive when A and M are
    # SPD
    return (state[6] <= 0.0) | (state[7] <= 0.0)


def _pcg_merged_refresh(ops, x0, state):
    """Residual replacement: true r,
    fresh ``u = M⁻¹r`` and recurrence images, all scalars from one stacked
    reduction."""
    x, r, u, p, s, w, gamma, delta, rr, gamma_prev, alpha_prev = state
    r = ops.b - ops.matvec(x)
    u = ops.M(r)
    w = ops.matvec(u)
    s = ops.matvec(p)
    gamma, delta, rr = ops.dotn((r, u), (w, u), (r, r))
    return (x, r, u, p, s, w, gamma, delta, rr, gamma_prev, alpha_prev)


def _pcg_merged_fused_step(ops, state):
    """Merged PCG as fused memory passes (``ops.A`` is a ``KernelOp``): the
    four vector updates (``fused_pcg_body``), the preconditioner apply on its
    own kernels via ``ops.M``, then the SpMV with the whole reduction triple
    ``γ = r·u``, ``δ = w·u``, true ``r·r`` (``stencil_spmv_dots3``).  Same
    recurrence as :func:`_pcg_merged_step`."""
    x, r, u, p, s, w, gamma, delta, rr, gamma_prev, alpha_prev = state
    alpha, beta = _cg_merged_scalars(gamma, delta, gamma_prev, alpha_prev)
    x, r, p, s = ops.A.pcg_body(alpha, beta, x, r, u, p, s, w)     # pass 1
    u = ops.M(r)                                     # precond (own kernels)
    w, delta_new, gamma_new, rr_new = ops.A.spmv_dots3(u, r)       # pass 2
    return (x, r, u, p, s, w, gamma_new, delta_new, rr_new, gamma, alpha)


register_method(MethodDef(
    name="pcg_merged", vectors=("x", "r", "u", "p", "s", "w"),
    scalars=("gamma", "delta", "rr", "gamma_prev", "alpha_prev"),
    res_scalar="rr", init=_pcg_merged_init, step=_pcg_merged_step,
    variant_of="pcg", reduce_hide="merged", accepts_precond=True,
    fused_kernels=("pcg_body", "spmv_dots3"),
    fused_init=_pcg_merged_init, fused_step=_pcg_merged_fused_step,
    guard=_pcg_merged_guard,
    refresh=_pcg_merged_refresh, refresh_spmvs=3))


def _cg_pipe_init(ops, x0):
    r = ops.b - ops.matvec(x0)
    w = ops.matvec(r)
    (rr0,) = ops.dotn((r, r))
    zero = torch.zeros_like(ops.b)
    inf, one = _merged_seed(rr0)
    return (x0, r, w, zero, zero, zero, inf, one, rr0)


def _cg_pipe_step(ops, state):
    """Pipelined CG (Ghysels–Vanroose): ONE stacked reduction at the top of
    the body, and the body's SpMV (``n = A w``, on carried state) does not
    depend on it.  The reduction is started, the SpMV issued, and only then
    is it waited for, so on a mesh the collective is in flight under the
    SpMV (the reference pins the same order with an
    ``optimization_barrier``).  The residual norm the check reads is the
    previous body's, so the method typically reports one more iteration
    than ``cg``; two extra recurrences (``s = A p``, ``z = A s``) pay for
    the hiding."""
    x, r, w, p, s, z, gamma_prev, alpha_prev, rr = state
    pending = ops.dotn_start((r, r), (w, r))
    n = ops.matvec(w)                 # under the stacked reduction
    gamma, delta = pending.wait()
    alpha, beta = _cg_merged_scalars(gamma, delta, gamma_prev, alpha_prev)
    z = n + beta * z                  # z = A s by recurrence
    s = w + beta * s                  # s = A p by recurrence
    p = r + beta * p
    x = x + alpha * p
    r = r - alpha * s
    w = w - alpha * z                 # w = A r by recurrence
    return (x, r, w, p, s, z, gamma, alpha, gamma)


def _cg_pipe_refresh(ops, x0, state):
    """Residual replacement: the three
    recurrence chains (``w = A r``, ``s = A p``, ``z = A s``) restart from
    the true residual, and the lagged ``rr`` is recomputed."""
    x, r, w, p, s, z, gamma_prev, alpha_prev, rr = state
    r = ops.b - ops.matvec(x)
    w = ops.matvec(r)
    s = ops.matvec(p)
    z = ops.matvec(s)
    (rr,) = ops.dotn((r, r))
    return (x, r, w, p, s, z, gamma_prev, alpha_prev, rr)


def _cg_pipe_fused_step(ops, state):
    """Pipelined CG as TWO fused memory passes (``ops.A`` is a
    ``KernelOp``): the body's SpMV ``n = A w`` with both reduction partials
    (``spmv_dots3`` with ``x = w``; its first partial ``(A w)·w`` is
    unused), then all six vector recurrences (``pipe_body``).  Same
    recurrence as :func:`_cg_pipe_step`."""
    x, r, w, p, s, z, gamma_prev, alpha_prev, rr = state
    n, _nw, delta, gamma = ops.A.spmv_dots3(w, r)                # pass 1
    alpha, beta = _cg_merged_scalars(gamma, delta, gamma_prev, alpha_prev)
    x, r, w, p, s, z = ops.A.pipe_body(
        alpha, beta, x, r, w, p, s, z, n)                        # pass 2
    return (x, r, w, p, s, z, gamma, alpha, gamma)


register_method(MethodDef(
    name="cg_pipe", vectors=("x", "r", "w", "p", "s", "z"),
    scalars=("gamma_prev", "alpha_prev", "rr"), res_scalar="rr",
    init=_cg_pipe_init, step=_cg_pipe_step,
    variant_of="cg", reduce_hide="pipelined",
    fused_kernels=("spmv_dots3", "pipe_body"),
    fused_init=_cg_pipe_init, fused_step=_cg_pipe_fused_step,
    refresh=_cg_pipe_refresh, refresh_spmvs=4))


def _pcg_pipe_init(ops, x0):
    r = ops.b - ops.matvec(x0)
    u = ops.M(r)
    w = ops.matvec(u)
    (rr0,) = ops.dotn((r, r))
    zero = torch.zeros_like(ops.b)
    inf, one = _merged_seed(rr0)
    return (x0, r, u, w, zero, zero, zero, zero, inf, one, rr0)


def _pcg_pipe_step(ops, state):
    """Pipelined PCG (Ghysels–Vanroose Alg. 3): the stacked reduction
    (``γ = r·u``, ``δ = w·u``, TRUE ``r·r``) does not feed the
    preconditioner apply ``m = M⁻¹w`` or the SpMV ``n = A m``, so both
    are issued between its start and its wait (the reference pins them
    behind it with an ``optimization_barrier``).  Four extra recurrences
    (``s, q, z, u``); stopping lags one iteration like the unpreconditioned
    pipeline."""
    x, r, u, w, p, s, q, z, gamma_prev, alpha_prev, rr = state
    pending = ops.dotn_start((r, u), (w, u), (r, r))
    m = ops.M(w)                      # under the stacked reduction
    n = ops.matvec(m)
    gamma, delta, rr_new = pending.wait()
    alpha, beta = _cg_merged_scalars(gamma, delta, gamma_prev, alpha_prev)
    z = n + beta * z                  # z = A q by recurrence
    q = m + beta * q                  # q = M⁻¹ s by recurrence
    s = w + beta * s                  # s = A p by recurrence
    p = u + beta * p
    x = x + alpha * p
    r = r - alpha * s
    u = u - alpha * q                 # u = M⁻¹ r by recurrence
    w = w - alpha * z                 # w = A u by recurrence
    return (x, r, u, w, p, s, q, z, gamma, alpha, rr_new)


def _pcg_pipe_refresh(ops, x0, state):
    """Residual replacement: true r,
    fresh preconditioned images ``u = M⁻¹r``/``q = M⁻¹s`` and the SpMV
    images rebuilt from them."""
    x, r, u, w, p, s, q, z, gamma_prev, alpha_prev, rr = state
    r = ops.b - ops.matvec(x)
    u = ops.M(r)
    w = ops.matvec(u)
    s = ops.matvec(p)
    q = ops.M(s)
    z = ops.matvec(q)
    (rr,) = ops.dotn((r, r))
    return (x, r, u, w, p, s, q, z, gamma_prev, alpha_prev, rr)


def _pcg_pipe_fused_step(ops, state):
    """Pipelined PCG as fused memory passes (``ops.A`` is a ``KernelOp``):
    the reduction triple on carried state in one read pass
    (``fused_dots``), the preconditioner apply and the SpMV on their own
    kernels under its global reduction, then all eight vector recurrences
    in one pass (``ppipe_body``).  Same recurrence as
    :func:`_pcg_pipe_step`."""
    x, r, u, w, p, s, q, z, gamma_prev, alpha_prev, rr = state
    pending = ops.A.fused_dots_start(r, u, w)                    # pass 1
    m = ops.M(w)                                     # precond (own kernels)
    n = ops.A.matvec(m)                                          # SpMV
    gamma, delta, rr_new = pending.wait()
    alpha, beta = _cg_merged_scalars(gamma, delta, gamma_prev, alpha_prev)
    x, r, u, w, p, s, q, z = ops.A.ppipe_body(
        alpha, beta, x, r, u, w, p, s, q, z, m, n)               # pass 2
    return (x, r, u, w, p, s, q, z, gamma, alpha, rr_new)


register_method(MethodDef(
    name="pcg_pipe", vectors=("x", "r", "u", "w", "p", "s", "q", "z"),
    scalars=("gamma_prev", "alpha_prev", "rr"), res_scalar="rr",
    init=_pcg_pipe_init, step=_pcg_pipe_step,
    variant_of="pcg", reduce_hide="pipelined", accepts_precond=True,
    fused_kernels=("fused_dots", "ppipe_body"),
    fused_init=_pcg_pipe_init, fused_step=_pcg_pipe_fused_step,
    refresh=_pcg_pipe_refresh, refresh_spmvs=4))


# =============================================================================
# Krylov methods — BiCGStab family
# =============================================================================

def _bicgstab_init(ops, x0):
    r = ops.b - ops.matvec(x0)
    rho = ops.dot(r, r)               # r̂ = r_0 ⇒ ρ_0 = ‖r_0‖²
    return (x0, r, r, r, rho, rho)


def _bicgstab_step(ops, state):
    """Classical BiCGStab: 3 reduction points per iteration; the first two
    block and the ``x`` update runs under the third."""
    x, r, rhat, p, rho, rr = state
    v = ops.matvec(p)
    rhat_v = ops.dot(rhat, v)
    alpha = rho / rhat_v
    s = r - alpha * v
    t = ops.matvec(s)
    ts, tt = ops.dot2(t, s, t, t)
    omega = ts / tt
    r = s - omega * t
    pending = ops.dotn_start((rhat, r), (r, r))
    x = x + alpha * p + omega * s     # under (r̂·r, r·r)
    rho_new, rr_new = pending.wait()
    beta = (rho_new / rho) * (alpha / omega)
    p = r + beta * (p - omega * v)
    return (x, r, rhat, p, rho_new, rr_new)


register_method(MethodDef(
    name="bicgstab", vectors=("x", "r", "rhat", "p"),
    scalars=("rho", "rr"), res_scalar="rr",
    init=_bicgstab_init, step=_bicgstab_step,
    guard=_rho_underflow_guard(4, 5)))


def _pbicgstab_step(ops, state):
    """Right-preconditioned BiCGStab (``A M⁻¹ y = b``, ``x = M⁻¹ y``): ``r``
    stays the TRUE residual, so stopping is comparable with ``bicgstab``;
    ``M`` need not be SPD-preserving.  3 reduction points, as
    ``bicgstab``, the ``x`` update under the third."""
    x, r, rhat, p, rho, rr = state
    phat = ops.M(p)
    v = ops.matvec(phat)
    rhat_v = ops.dot(rhat, v)
    alpha = rho / rhat_v
    s = r - alpha * v
    shat = ops.M(s)
    t = ops.matvec(shat)
    ts, tt = ops.dot2(t, s, t, t)
    omega = ts / tt
    r = s - omega * t
    pending = ops.dotn_start((rhat, r), (r, r))
    x = x + alpha * phat + omega * shat   # under (r̂·r, r·r)
    rho_new, rr_new = pending.wait()
    beta = (rho_new / rho) * (alpha / omega)
    p = r + beta * (p - omega * v)
    return (x, r, rhat, p, rho_new, rr_new)


register_method(MethodDef(
    name="pbicgstab", vectors=("x", "r", "rhat", "p"),
    scalars=("rho", "rr"), res_scalar="rr",
    init=_bicgstab_init, step=_pbicgstab_step,
    variant_of="bicgstab", accepts_precond=True,
    guard=_rho_underflow_guard(4, 5)))


def _bicgstab_b1_init(ops, x0):
    r = ops.b - ops.matvec(x0)
    beta_rr = ops.dot(r, r)
    rhat = r / torch.sqrt(beta_rr)
    an = ops.dot(r, rhat)
    return (x0, r, r, rhat, an, beta_rr)


def _bicgstab_b1_step(ops, state):
    """BiCGStab one-blocking (paper Alg. 2) with the restart procedure
    (``ε_restart`` from ``ops.params``, default 1e-5, paper §4.1).  One
    reduction blocks (``α_d``, the paper's name); ``x_half`` runs under
    ω's pair and ``p_half`` under the last pair, the order the reference's
    ``optimization_barrier``s pin."""
    x, r, p, rhat, an, beta_rr = state
    restart_thresh = ops.params.get("eps_restart", 1e-5) * ops.norm_ref
    Ap = ops.matvec(p)
    ad = ops.dot(Ap, rhat)
    alpha = an / ad
    s = r - alpha * Ap
    As = ops.matvec(s)
    pending = ops.dotn_start((As, s), (As, As))
    x_half = x + alpha * p            # under (As·s, As·As)
    ts, tt = pending.wait()
    omega = ts / tt
    x_new = x_half + omega * s
    r_new = s - omega * As
    pending = ops.dotn_start((r_new, rhat), (r_new, r_new))
    p_half = p - omega * Ap           # under (r·r̂, r·r)
    an_new, beta_rr_new = pending.wait()
    restart = torch.sqrt(torch.abs(an_new)) < restart_thresh
    p_reg = r_new + (an_new / (ad * omega)) * p_half
    p_new = torch.where(restart, r_new, p_reg)
    rhat_new = torch.where(restart, r_new / torch.sqrt(beta_rr_new), rhat)
    an_next = torch.where(restart, torch.sqrt(beta_rr_new), an_new)
    return (x_new, r_new, p_new, rhat_new, an_next, beta_rr_new)


register_method(MethodDef(
    name="bicgstab_b1", vectors=("x", "r", "p", "rhat"),
    scalars=("an", "beta_rr"), res_scalar="beta_rr",
    init=_bicgstab_b1_init, step=_bicgstab_b1_step,
    variant_of="bicgstab", params=("eps_restart",)))


def _merged_bicgstab_matvec(ops, preconditioned: bool):
    if not preconditioned:
        return ops.matvec
    return lambda v: ops.matvec(ops.M(v))


def _clamp_nonneg(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0)`` that keeps NaN, as ``jnp.maximum(x, 0.0)`` does (a NaN
    residual must still end the loop as a breakdown)."""
    return torch.clamp(x, min=0.0)


def _make_bicgstab_merged_init(preconditioned: bool):
    def init(ops, x0):
        mv = _merged_bicgstab_matvec(ops, preconditioned)
        r0 = ops.b - ops.matvec(x0)
        y0 = torch.zeros_like(ops.b) if preconditioned else x0
        w = mv(r0)
        t = mv(w)
        rho, rhw = ops.dotn((r0, r0), (r0, w))   # r̂ = r0
        alpha = rho / rhw
        rr = rho                           # r̂ = r0 ⇒ (r̂,r0) = ‖r0‖²
        return (y0, r0, w, t, r0, w, t, r0, rho, alpha, rr)
    return init


def _make_bicgstab_merged_step(preconditioned: bool):
    def step(ops, state):
        """Single-reduction BiCGStab (cf. Cools–Vanroose): the auxiliary
        images ``w = A r``, ``t = A w``, ``s = A p``, ``z = A s`` are kept by
        recurrence, so ω's pair, ρ, the α denominator and ‖r‖² are all
        linear in nine dots of vectors available before ω — ONE stacked
        reduction per iteration, two SpMVs.  The preconditioned form runs the
        same core on ``B = A∘M⁻¹`` with a zero initial guess and recovers
        ``x = x0 + M⁻¹ y`` once at exit (``finalize``); right
        preconditioning leaves the residual unchanged, so stopping stays on
        the true residual.  ``rr`` is the recurrence estimate ``‖q − ωy‖²``
        from pre-update dots, clamped at 0."""
        mv = _merged_bicgstab_matvec(ops, preconditioned)
        y, r, w, t, p, s, z, rhat, rho, alpha, rr = state
        q = r - alpha * s                  # classical s_j
        yv = w - alpha * z                 # = A q
        v = mv(z)                          # SpMV 1
        (qy, yy, qq, rhq, rhy, rht, rhv, rhz, rhs) = ops.dotn(
            (q, yv), (yv, yv), (q, q), (rhat, q), (rhat, yv),
            (rhat, t), (rhat, v), (rhat, z), (rhat, s))
        omega = qy / yy
        y = y + alpha * p + omega * q
        r = q - omega * yv
        rr_new = _clamp_nonneg(qq - 2.0 * omega * qy + omega * omega * yy)
        rho_new = rhq - omega * rhy
        beta = (rho_new / rho) * (alpha / omega)
        w = yv - omega * (t - alpha * v)   # = A r_new
        t = mv(w)                          # SpMV 2
        rhw = rhy - omega * (rht - alpha * rhv)      # (r̂, w_new)
        alpha_new = rho_new / (rhw + beta * (rhs - omega * rhz))
        p = r + beta * (p - omega * s)
        s = w + beta * (s - omega * z)     # = A p_new
        z = t + beta * (z - omega * v)     # = A s_new
        return (y, r, w, t, p, s, z, rhat, rho_new, alpha_new, rr_new)
    return step


def _make_bicgstab_merged_fused_step(preconditioned: bool):
    def fused_step(ops, state):
        """Single-reduction BiCGStab as THREE fused memory passes (``ops.A``
        is a ``KernelOp``): SpMV 1 ``v = A z̃`` with ``q``, ``y`` and all nine
        dot partials (``bicgstab_fused_spmv_dots``), the ω-half y/r/w updates
        (``bicgstab_fused_update1``), then SpMV 2 with the three direction
        recurrences (``bicgstab_fused_spmv_update``).  α, ω and β stay on the
        device and reach the kernels by pointer.  The preconditioned form
        applies ``M`` (on its own kernels) to each SpMV operand.  Same
        recurrence as the unfused step."""
        y, r, w, t, p, s, z, rhat, rho, alpha, rr = state
        zi = ops.M(z) if preconditioned else z
        v, q, yv, parts = ops.A.bicgstab_spmv_dots(
            zi, z, r, w, s, rhat, t, alpha)                      # pass 1
        qy, yy, qq, rhq, rhy, rht, rhv, rhz, rhs = parts
        omega = qy / yy
        rr_new = _clamp_nonneg(qq - 2.0 * omega * qy + omega * omega * yy)
        rho_new = rhq - omega * rhy
        beta = (rho_new / rho) * (alpha / omega)
        y, r, w = ops.A.bicgstab_update1(
            alpha, omega, y, p, q, yv, t, v)                     # pass 2
        wi = ops.M(w) if preconditioned else w
        t, p, s, z = ops.A.bicgstab_spmv_update(
            wi, w, r, p, s, z, v, omega, beta)                   # pass 3
        rhw = rhy - omega * (rht - alpha * rhv)
        alpha_new = rho_new / (rhw + beta * (rhs - omega * rhz))
        return (y, r, w, t, p, s, z, rhat, rho_new, alpha_new, rr_new)
    return fused_step


def _pbicgstab_merged_finalize(ops, x0, state):
    # the loop iterates in the preconditioned ŷ space; recover x once
    return x0 + ops.M(state[0])


def _make_bicgstab_merged_refresh(preconditioned: bool):
    def refresh(ops, x0, state):
        """Residual replacement: the
        true residual from the iterate (through ``finalize``'s map in the
        preconditioned ŷ space), every recurrence image ``w, t, s, z``
        rebuilt from it, and ρ, α and ‖r‖² from one stacked reduction."""
        mv = _merged_bicgstab_matvec(ops, preconditioned)
        y, r, w, t, p, s, z, rhat, rho, alpha, rr = state
        x = x0 + ops.M(y) if preconditioned else y
        r = ops.b - ops.matvec(x)
        w = mv(r)
        t = mv(w)
        s = mv(p)
        z = mv(s)
        rho, rr, rhs = ops.dotn((rhat, r), (r, r), (rhat, s))
        alpha = rho / rhs                  # α = ρ / r̂·(B p)
        return (y, r, w, t, p, s, z, rhat, rho, alpha, rr)
    return refresh


_BICGSTAB_MERGED_FUSED = ("bicgstab_spmv_dots", "bicgstab_update1",
                          "bicgstab_spmv_update")

register_method(MethodDef(
    name="bicgstab_merged",
    vectors=("x", "r", "w", "t", "p", "s", "z", "rhat"),
    scalars=("rho", "alpha", "rr"), res_scalar="rr",
    init=_make_bicgstab_merged_init(False),
    step=_make_bicgstab_merged_step(False),
    variant_of="bicgstab", reduce_hide="merged",
    fused_kernels=_BICGSTAB_MERGED_FUSED,
    fused_init=_make_bicgstab_merged_init(False),
    fused_step=_make_bicgstab_merged_fused_step(False),
    guard=_rho_underflow_guard(8, 10),
    refresh=_make_bicgstab_merged_refresh(False), refresh_spmvs=5))

register_method(MethodDef(
    name="pbicgstab_merged",
    vectors=("x", "r", "w", "t", "p", "s", "z", "rhat"),
    scalars=("rho", "alpha", "rr"), res_scalar="rr",
    init=_make_bicgstab_merged_init(True),
    step=_make_bicgstab_merged_step(True),
    finalize=_pbicgstab_merged_finalize,
    variant_of="pbicgstab", reduce_hide="merged", accepts_precond=True,
    fused_kernels=_BICGSTAB_MERGED_FUSED,
    fused_init=_make_bicgstab_merged_init(True),
    fused_step=_make_bicgstab_merged_fused_step(True),
    guard=_rho_underflow_guard(8, 10),
    refresh=_make_bicgstab_merged_refresh(True), refresh_spmvs=5))


# =============================================================================
# Stationary methods
# =============================================================================

def _jacobi_init(ops, x0):
    r = ops.b - ops.matvec(x0)
    rr = ops.dot(r, r)
    return (x0, r, rr)


def _jacobi_step(ops, state):
    """Jacobi: x += D⁻¹ r; one SpMV + one reduction per iteration."""
    x, r, rr = state
    x = x + r / ops.diag
    r = ops.b - ops.matvec(x)
    rr = ops.dot(r, r)
    return (x, r, rr)


register_method(MethodDef(
    name="jacobi", vectors=("x", "r"), scalars=("rr",), res_scalar="rr",
    init=_jacobi_init, step=_jacobi_step, stationary=True,
    default_maxiter=1000))


def _plane_sweep(A, b, x, *, forward: bool) -> torch.Tensor:
    """One relaxed Gauss-Seidel sweep: GS-fresh across z-planes, Jacobi
    within a plane.  The reference's ``fori_loop`` over planes is a Python
    loop of whole-plane tensor ops writing into a fresh padded copy."""
    nz = x.shape[-1]
    xp = A.pad_exchange(x)
    for i in range(nz):
        k = i if forward else nz - 1 - i
        off = A.stencil.plane_offdiag_apply(xp, k)
        xp[..., 1:-1, 1:-1, k + 1] = (b[..., k] - off) / A.diag
    return xp[..., 1:-1, 1:-1, 1:-1]


def _stationary_init(ops, x0):
    r = ops.b - ops.matvec(x0)
    rr = ops.dot(r, r)
    return (x0, rr)


def _gauss_seidel_step(ops, state):
    """Relaxed symmetric GS (paper §3.4 Code 4 adaptation): forward sweep
    (ascending z-planes) then backward sweep (descending)."""
    x, rr = state
    x = _plane_sweep(ops.A, ops.b, x, forward=True)
    x = _plane_sweep(ops.A, ops.b, x, forward=False)
    r = ops.b - ops.matvec(x)
    rr = ops.dot(r, r)
    return (x, rr)


def _colour_mask(shape: tuple[int, int, int], colour: int,
                 device: torch.device) -> torch.Tensor:
    i, j, k = (torch.arange(n, device=device) for n in shape)
    parity = i[:, None, None] + j[None, :, None] + k[None, None, :]
    return (parity % 2) == colour


def _rb_half_sweep(A, b, x, colour_mask) -> torch.Tensor:
    off = A.stencil.offdiag_apply_padded(A.pad_exchange(x))
    return torch.where(colour_mask, (b - off) / A.diag, x)


def _gauss_seidel_rb_step(ops, state):
    """Red-black coloured symmetric GS (paper §3.4): forward = red, black;
    backward = black, red."""
    x, rr = state
    red = _colour_mask(tuple(x.shape[-3:]), 0, x.device)
    black = _colour_mask(tuple(x.shape[-3:]), 1, x.device)
    x = _rb_half_sweep(ops.A, ops.b, x, red)
    x = _rb_half_sweep(ops.A, ops.b, x, black)
    x = _rb_half_sweep(ops.A, ops.b, x, black)
    x = _rb_half_sweep(ops.A, ops.b, x, red)
    r = ops.b - ops.matvec(x)
    rr = ops.dot(r, r)
    return (x, rr)


register_method(MethodDef(
    name="gauss_seidel_rb", vectors=("x",), scalars=("rr",),
    res_scalar="rr", init=_stationary_init, step=_gauss_seidel_rb_step,
    stationary=True, default_maxiter=1000))

register_method(MethodDef(
    name="gauss_seidel", vectors=("x",), scalars=("rr",),
    res_scalar="rr", init=_stationary_init, step=_gauss_seidel_step,
    variant_of="gauss_seidel_rb", stationary=True, default_maxiter=1000))
