"""The solver facade (counterpart of ``repro.api``): one entry point for the
local solve on the card or, with ``device="cpu"``, on the CPU."""
from repro_torch.api.backend import (Backend, resolve_backend, resolve_halo_mode,
                                     resolve_matvec, resolve_precond)
from repro_torch.api.options import HALO_MODES, LAYOUTS, ON_BREAKDOWN, SolverOptions
from repro_torch.api.registry import (
    REGISTRY,
    RegistryConsistencyError,
    SolverSpec,
    check_consistent_with_core,
    fallback_chain,
    fused_solver_names,
    get_solver,
    register_solver,
    solver_names,
    variant_pairs,
)
from repro_torch.precond import (PRECONDITIONERS, Preconditioner, make_precond,
                                 precond_names)
from repro_torch.api.session import SolverSession, solve, solve_batched
from repro_torch.api.timing import timed, timed_result

__all__ = [
    "Backend",
    "HALO_MODES",
    "LAYOUTS",
    "ON_BREAKDOWN",
    "PRECONDITIONERS",
    "Preconditioner",
    "REGISTRY",
    "RegistryConsistencyError",
    "SolverOptions",
    "SolverSession",
    "SolverSpec",
    "check_consistent_with_core",
    "fallback_chain",
    "fused_solver_names",
    "get_solver",
    "make_precond",
    "precond_names",
    "register_solver",
    "resolve_backend",
    "resolve_halo_mode",
    "resolve_matvec",
    "resolve_precond",
    "solve",
    "solve_batched",
    "solver_names",
    "timed",
    "timed_result",
    "variant_pairs",
]
