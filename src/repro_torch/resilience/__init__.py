# Breakdown-aware solving + fault injection (counterpart of repro.resilience).
#
# The solver side lives in repro_torch.core.methods (typed
# SolveResult.status, GuardSpec, the guard/refresh hooks and the Watch that
# every driver runs them through) and repro_torch.api (the on_breakdown
# recovery policies); this package re-exports that surface and adds the
# chaos harness (inject.py).  Its serve half comes with the serve port
# (ROADMAP queue 1 item 11).
from repro_torch.core.methods import (STATUS_BREAKDOWN, STATUS_CONVERGED,
                                      STATUS_DIVERGED, STATUS_MAXITER,
                                      STATUS_NAMES, STATUS_STAGNATED, GuardSpec,
                                      SolveBreakdown, status_name)
from repro_torch.resilience.inject import ChaosInjector, ChaosPlan, CompileFailure
from repro_torch.runtime.monitor import DeviceLost, SimulatedFailure

__all__ = [
    "ChaosInjector",
    "ChaosPlan",
    "CompileFailure",
    "DeviceLost",
    "GuardSpec",
    "STATUS_BREAKDOWN",
    "STATUS_CONVERGED",
    "STATUS_DIVERGED",
    "STATUS_MAXITER",
    "STATUS_NAMES",
    "STATUS_STAGNATED",
    "SimulatedFailure",
    "SolveBreakdown",
    "status_name",
]
