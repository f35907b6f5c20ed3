"""The solver facade (counterpart of ``repro.api``): one entry point for the
local solve on the card or, with ``device="cpu"``, on the CPU."""
from repro_torch.api.backend import Backend, resolve_backend, resolve_matvec
from repro_torch.api.options import LAYOUTS, SolverOptions
from repro_torch.api.registry import (
    REGISTRY,
    RegistryConsistencyError,
    SolverSpec,
    check_consistent_with_core,
    fused_solver_names,
    get_solver,
    register_solver,
    solver_names,
)
from repro_torch.api.session import SolverSession, solve, solve_batched
from repro_torch.api.timing import timed_result

__all__ = [
    "Backend",
    "LAYOUTS",
    "REGISTRY",
    "RegistryConsistencyError",
    "SolverOptions",
    "SolverSession",
    "SolverSpec",
    "check_consistent_with_core",
    "fused_solver_names",
    "get_solver",
    "register_solver",
    "resolve_backend",
    "resolve_matvec",
    "solve",
    "solve_batched",
    "solver_names",
    "timed_result",
]
