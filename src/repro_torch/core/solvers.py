"""Solver functions — the callable surface over ``repro_torch.core.methods``.

Counterpart of ``repro/core/solvers.py``: every algorithm is one ``MethodDef``
run by the generic ``run_method`` driver, and this module derives the familiar
``solver(A, b, x0, *, tol, maxiter, dot, norm_ref)`` callables, ``SOLVERS`` and
``VARIANT_OF`` from those definitions: the reference's whole method set.

``LocalOp`` is the single-device operator (zero-padded halos == physical
boundary); the distributed operator is ROADMAP queue 1 item 10.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.methods import (METHODS, Ops, SolveResult, _default_dot,
                                      get_method, run_method)
from repro_torch.core.operators import Stencil, pad1


class LocalOp:
    """Single-device stencil operator (zero halos == physical boundary)."""

    def __init__(self, stencil: Stencil, matvec_padded: Callable | None = None):
        self.stencil = stencil
        self._mv_padded = matvec_padded or stencil.matvec_padded

    @property
    def diag(self) -> float:
        return self.stencil.diag

    def pad_exchange(self, x: torch.Tensor) -> torch.Tensor:
        return pad1(x)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self._mv_padded(self.pad_exchange(x))

    def matvec_local(self, x: torch.Tensor) -> torch.Tensor:
        """Zero-halo apply on the local block; on one device == matvec."""
        return self.matvec(x)

    def dotn(self, *pairs) -> tuple:
        """Stacked dot products — locally just the dots (no collective)."""
        return tuple(_default_dot(a, b) for a, b in pairs)

    def sum_partials(self, *vals) -> tuple:
        """Reduce already-computed partial scalars globally — locally the
        identity; the fused kernels' dot partials ride this."""
        return vals


def make_solver(name: str) -> Callable:
    """The classic ``solver(A, b, x0, *, tol, maxiter, dot, norm_ref, ...)``
    callable for one registered MethodDef (plus ``M=`` for the preconditioned
    methods and the definition's declared tuning knobs, e.g. ``eps_restart=``
    for bicgstab_b1, via ``Ops.params``)."""
    mdef = get_method(name)

    def solver(A, b, x0, *, tol=1e-6, maxiter=None, dot=None, norm_ref=None,
               M=None, **params) -> SolveResult:
        if M is not None and not mdef.accepts_precond:
            raise TypeError(f"{name!r} takes no preconditioner (M=)")
        unknown = set(params) - set(mdef.params)
        if unknown:
            raise TypeError(
                f"{name}() got unexpected keyword argument(s) "
                f"{sorted(unknown)}; this method accepts "
                f"{sorted(mdef.params) or 'no extra parameters'}")
        ops = Ops(A, b, M=M, dot=dot, norm_ref=norm_ref, params=params)
        return run_method(mdef, ops, x0, tol=tol, maxiter=maxiter)

    solver.__name__ = name
    solver.__qualname__ = name
    solver.__doc__ = (mdef.step.__doc__ or "") + (
        "\n\n(Defined once in repro_torch.core.methods; this callable runs "
        "the definition on the LocalOp protocol via run_method.)")
    solver.method_def = mdef
    return solver


cg = make_solver("cg")
cg_nb = make_solver("cg_nb")
pcg = make_solver("pcg")
cg_merged = make_solver("cg_merged")
pcg_merged = make_solver("pcg_merged")
cg_pipe = make_solver("cg_pipe")
pcg_pipe = make_solver("pcg_pipe")
bicgstab = make_solver("bicgstab")
pbicgstab = make_solver("pbicgstab")
bicgstab_b1 = make_solver("bicgstab_b1")
bicgstab_merged = make_solver("bicgstab_merged")
pbicgstab_merged = make_solver("pbicgstab_merged")
jacobi = make_solver("jacobi")
sym_gauss_seidel_relaxed = make_solver("gauss_seidel")
sym_gauss_seidel_rb = make_solver("gauss_seidel_rb")

SOLVERS: dict[str, Callable] = {
    "jacobi": jacobi,
    "gauss_seidel": sym_gauss_seidel_relaxed,
    "gauss_seidel_rb": sym_gauss_seidel_rb,
    "cg": cg,
    "cg_nb": cg_nb,
    "pcg": pcg,
    "cg_merged": cg_merged,
    "pcg_merged": pcg_merged,
    "cg_pipe": cg_pipe,
    "pcg_pipe": pcg_pipe,
    "bicgstab": bicgstab,
    "pbicgstab": pbicgstab,
    "bicgstab_b1": bicgstab_b1,
    "bicgstab_merged": bicgstab_merged,
    "pbicgstab_merged": pbicgstab_merged,
}

#: methods refining a classical baseline mapped to that baseline — derived
#: from the MethodDefs; the registry cross-checks it.
VARIANT_OF = {name: m.variant_of for name, m in METHODS.items()
              if m.variant_of is not None}
