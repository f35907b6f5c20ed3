"""Typed solver options (counterpart of ``repro/api/options.py``).

Only the fields this slice runs are accepted; the reference's other options
raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses

#: accepted ``precond`` values ("none" + the repro_torch.precond registry)
from repro_torch.precond import precond_names

#: accepted ``layout`` values (the reference's mesh layouts are not ported)
LAYOUTS = ("auto", "local")
#: the reference's layouts that wait for the distributed port
_MESH_LAYOUTS = ("1d", "2d", "3d")

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
                  off by default as there.  ``None`` (autotuned routing) is
                  not ported.
    norm_ref:     residual normalisation; ``1.0`` = the paper's absolute
                  HPCCG criterion, ``None`` = relative to ``||b||``.
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
    telemetry, guards, on_breakdown, residual_replacement:
                  the reference's options; only their defaults (off,
                  ``"raise"``, 0) are accepted until they are ported.
    """

    tol: float = 1e-6
    maxiter: int = 600
    f64: bool = True
    layout: str = "auto"
    kernels: bool | None = False
    norm_ref: float | None = 1.0
    precond: str = "none"
    precond_params: dict | None = None
    telemetry: bool = False
    guards: bool = False
    on_breakdown: str = "raise"
    residual_replacement: int = 0

    def __post_init__(self):
        if self.layout in _MESH_LAYOUTS:
            raise NotImplementedError(
                f"layout={self.layout!r}: the distributed solve is not ported "
                f"yet ({_QUEUE} item 10)")
        if self.layout not in LAYOUTS:
            raise ValueError(
                f"unknown layout {self.layout!r}; options: {LAYOUTS}")
        if self.kernels is None:
            raise NotImplementedError(
                f"kernels=None (autotuned routing) is not ported yet "
                f"({_QUEUE} item 9); pass kernels=True or False")
        if self.precond not in precond_names():
            raise ValueError(
                f"unknown precond {self.precond!r}; "
                f"options: {precond_names()}")
        if self.precond_params and self.precond == "none":
            raise ValueError("precond_params given but precond='none'")
        for name, off in (("telemetry", False), ("guards", False),
                          ("on_breakdown", "raise"),
                          ("residual_replacement", 0)):
            if getattr(self, name) != off:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r}: resilience and telemetry "
                    f"are not ported yet ({_QUEUE} item 8)")
        if self.maxiter < 0:
            raise ValueError(f"maxiter must be >= 0, got {self.maxiter}")

    def replace(self, **kw) -> "SolverOptions":
        return dataclasses.replace(self, **kw)

    def solver_kwargs(self) -> dict:
        """The kwargs every solver in the registry accepts."""
        return dict(tol=self.tol, maxiter=self.maxiter, norm_ref=self.norm_ref)
