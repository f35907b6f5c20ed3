"""Typed solver options (counterpart of ``repro/api/options.py``).

The reference's fields that wait for a module not ported yet raise
``NotImplementedError`` naming the ROADMAP item that ports them:
``halo_mode`` and ``dims_map`` (item 10) and ``layout`` other than one device
(item 10).  Everything else is validated as the reference validates it
(``ValueError``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.methods import GuardSpec
#: accepted ``precond`` values ("none" + the repro_torch.precond registry)
from repro_torch.precond import precond_names

#: accepted ``layout`` values (the reference's mesh layouts are not ported)
LAYOUTS = ("auto", "local")
#: the reference's layouts that wait for the distributed port
_MESH_LAYOUTS = ("1d", "2d", "3d")
#: the reference's ``halo_mode`` values; only "auto" until item 10
HALO_MODES = ("auto", "scatter", "concat", "overlap")

#: accepted ``on_breakdown`` recovery policies (repro_torch.resilience):
#: "raise"    — raise SolveBreakdown on an abnormal guarded exit
#: "none"     — return the typed SolveResult.status untouched
#: "restart"  — re-solve from the last finite iterate, up to max_restarts
#: "fallback" — retry down the robustness ladder: kernels, dot and
#:              matvec_padded rolled back first, then variant_of back to the
#:              classical method
ON_BREAKDOWN = ("raise", "none", "restart", "fallback")

_QUEUE = "see ROADMAP.md queue 1"


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Everything that parameterises a solve, minus the problem itself.

    Attributes
    ----------
    tol:          convergence tolerance (relative to ``norm_ref``).
    maxiter:      iteration cap.
    f64:          solve in ``torch.float64`` (the paper's setting), else
                  ``torch.float32``.  No process-global flag is involved.
    layout:       ``"auto"`` or ``"local"``: one device.
    kernels:      run the stencil SpMV, the fused iteration body of the
                  methods that declare one, and the preconditioners that
                  have kernels (``KERNEL_PRECONDS``) on the hand-written CUDA
                  kernels.  The counterpart of the reference's ``pallas``;
                  off by default as there.  ``None`` lets the autotune cache
                  decide for this (stencil, grid, dtype, device kind)
                  (``kernels.autotune.resolve``, falling back to its default
                  table); the session resolves it to a bool at
                  construction.  With the kernels on, the ring pass's run
                  is the tuned one too.
    norm_ref:     residual normalisation; ``1.0`` = the paper's absolute
                  HPCCG criterion, ``None`` = relative to ``||b||``.
    dot:          override the reduction the solver uses (``(a, b) -> a·b``
                  on one grid; a batched solve calls it lane by lane).  A
                  custom ``dot`` keeps the solve off the fused kernel body.
    halo_mode:    the distributed halo exchange; only ``"auto"`` until the
                  distributed solve is ported.
    matvec_padded: override the padded-operand SpMV (``xp -> A·x`` on one
                  padded grid; a batched solve calls it lane by lane).  It
                  wins over ``kernels``: the solve runs on a plain
                  ``LocalOp`` around it, off the fused body.
    dims_map:     the distributed grid-dim -> mesh-axis map (not ported).
    precond:      preconditioner for the methods that take one (``pcg``,
                  ``pbicgstab``, ``pcg_merged``, ``pcg_pipe``): ``"none"`` |
                  ``"jacobi"`` | ``"block_jacobi"`` | ``"ssor"`` |
                  ``"chebyshev"`` (the ``repro_torch.precond`` registry).
                  Resolved by ``backend.resolve_precond``; asking for one
                  with a method that has no ``M=`` hook raises.
    precond_params: constructor knobs for the chosen preconditioner
                  (``{"sweeps": 3}``, ``{"degree": 5}``, ...);
                  ``options.kernels`` flows into the preconditioners that
                  have kernels unless ``use_kernels`` is pinned here.
    donate:       write a cached solve's iterate into the caller's ``x0``
                  (``solve``/``solve_batched``, ``x0``/``x0s`` passed as a
                  contiguous tensor of the problem's dtype, device and
                  shape) and return that tensor as ``result.x``, in place of
                  a fresh copy: the counterpart of the reference's
                  ``donate_argnums``, saving one allocation a solve.  The
                  results are the same bits either way.  An ``x0`` the
                  caller did not pass (the problem's own) is never written;
                  one that cannot take the result (another dtype, device or
                  layout, or the storage of ``b`` or of the problem's data)
                  is copied, with a warning.  ``donate=False`` keeps the
                  caller's ``x0`` as it was.  The eager loop and the
                  ``timed_*`` paths never donate.
    telemetry:    carry a bounded per-iteration buffer of every declared
                  loop-carry scalar and return it as
                  ``SolveResult.telemetry``: ``(min(telemetry_buffer,
                  maxiter + 1), n_scalars)``, row k the state after
                  iteration k (row 0 the initial state; NaN past the last
                  iteration; iterations past the buffer overwrite its last
                  row).  Off (the default), ``SolveResult.telemetry`` is
                  ``None`` and the solve is the one without it, bit for bit.
    telemetry_buffer: row bound of the telemetry buffer (clamped to
                  ``maxiter + 1``); read only when ``telemetry=True``.
    guards:       arm the per-iteration breakdown guards in the loop
                  condition: NaN in any loop-carry scalar, divergence past
                  ``divergence_factor``, the method's own guard
                  (ρ-underflow, negative curvature) and, with
                  ``stagnation_window > 0``, stagnation.  A fired guard
                  ends the loop before the step that would take the
                  poisoned state.  Off by default.
    on_breakdown: what ``SolverSession.solve`` does when a guarded solve
                  ends in breakdown, diverged or stagnated (``ON_BREAKDOWN``).
                  "restart" and "fallback" imply ``guards``.  Single solves
                  only: ``solve_batched`` returns each lane's status.
    max_restarts: attempt budget of the "restart" and "fallback" policies.
    residual_replacement: every N > 0 iterations, recompute the true
                  residual and the recurrence images from the iterate (the
                  methods whose ``MethodDef`` declares ``refresh``: the
                  merged and pipelined variants).  0 = off.
    breakdown_eps / divergence_factor / stagnation_window / stagnation_rtol:
                  the ``GuardSpec`` thresholds (``core.methods.GuardSpec``);
                  read only when the guards are armed.
    """

    tol: float = 1e-6
    maxiter: int = 600
    f64: bool = True
    layout: str = "auto"
    kernels: bool | None = False
    norm_ref: float | None = 1.0
    dot: Callable | None = None
    halo_mode: str = "auto"
    matvec_padded: Callable | None = None
    dims_map: dict[str, str | None] | None = None
    precond: str = "none"
    precond_params: dict | None = None
    donate: bool = True
    telemetry: bool = False
    telemetry_buffer: int = 256
    guards: bool = False
    on_breakdown: str = "raise"
    max_restarts: int = 2
    residual_replacement: int = 0
    breakdown_eps: float = 1e-12
    divergence_factor: float = 1e8
    stagnation_window: int = 0
    stagnation_rtol: float = 1.0

    def guards_armed(self) -> bool:
        """Whether the breakdown guards join the loop condition: armed
        explicitly (``guards=True``) or implied by a recovery policy that
        acts on the typed early exit ("restart", "fallback")."""
        return self.guards or self.on_breakdown in ("restart", "fallback")

    def guard_spec(self) -> GuardSpec | None:
        """The ``GuardSpec`` the driver takes; None when disarmed."""
        if not self.guards_armed():
            return None
        return GuardSpec(breakdown_eps=self.breakdown_eps,
                         divergence_factor=self.divergence_factor,
                         stagnation_window=self.stagnation_window,
                         stagnation_rtol=self.stagnation_rtol)

    def telemetry_rows(self) -> int:
        """The telemetry buffer's rows: 0 when off, else
        ``telemetry_buffer`` clamped to ``maxiter + 1``."""
        if not self.telemetry:
            return 0
        return min(self.telemetry_buffer, self.maxiter + 1)

    def __post_init__(self):
        if self.layout in _MESH_LAYOUTS:
            raise NotImplementedError(
                f"layout={self.layout!r}: the distributed solve is not ported "
                f"yet ({_QUEUE} item 10)")
        if self.layout not in LAYOUTS:
            raise ValueError(
                f"unknown layout {self.layout!r}; options: {LAYOUTS}")
        if self.precond not in precond_names():
            raise ValueError(
                f"unknown precond {self.precond!r}; "
                f"options: {precond_names()}")
        if self.precond_params and self.precond == "none":
            raise ValueError("precond_params given but precond='none'")
        if self.halo_mode not in HALO_MODES:
            raise ValueError(
                f"unknown halo_mode {self.halo_mode!r}; options: {HALO_MODES}")
        if self.halo_mode != "auto" or self.dims_map is not None:
            raise NotImplementedError(
                "halo_mode and dims_map: the distributed solve is not ported "
                f"yet ({_QUEUE} item 10)")
        if self.maxiter < 0:
            raise ValueError(f"maxiter must be >= 0, got {self.maxiter}")
        if self.telemetry_buffer < 1:
            raise ValueError(
                f"telemetry_buffer must be >= 1, got {self.telemetry_buffer}")
        if self.on_breakdown not in ON_BREAKDOWN:
            raise ValueError(
                f"unknown on_breakdown {self.on_breakdown!r}; "
                f"options: {ON_BREAKDOWN}")
        if self.max_restarts < 0:
            raise ValueError(
                f"max_restarts must be >= 0, got {self.max_restarts}")
        if self.residual_replacement < 0:
            raise ValueError(
                f"residual_replacement must be >= 0 (0 disables), got "
                f"{self.residual_replacement}")
        if self.guards_armed():
            self.guard_spec()   # validates the GuardSpec thresholds

    def replace(self, **kw) -> "SolverOptions":
        return dataclasses.replace(self, **kw)

    def solver_kwargs(self) -> dict:
        """The kwargs every solver in the registry accepts."""
        return dict(tol=self.tol, maxiter=self.maxiter, norm_ref=self.norm_ref)
