"""Backend resolution: options + device -> how the solve executes.

Counterpart of ``repro/api/backend.py``.  Only the local backend is ported:
one device, ``LocalOp`` with zero-padded halos.  The kernel choice is
orthogonal: ``options.kernels`` swaps the stencil SpMV for the CUDA kernel and
turns on the preconditioners' own kernels (:func:`resolve_precond`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.api.options import SolverOptions
from repro_torch.core.operators import Stencil
from repro_torch.core.problems import resolve_device


@dataclasses.dataclass(frozen=True)
class Backend:
    """Resolved execution target for a solve."""

    kind: str                     # "local"
    device: torch.device

    def describe(self) -> str:
        return f"local(1 device, {self.device})"


def resolve_backend(*, device="cuda") -> Backend:
    """The local backend on ``device`` (``SolverOptions`` admits only the
    one-device layouts); CUDA without a card raises."""
    return Backend(kind="local", device=resolve_device(device))


def resolve_matvec(stencil: Stencil,
                   options: SolverOptions) -> Callable | None:
    """The padded-operand SpMV implementing ``options`` (None = plain);
    ``options.matvec_padded`` wins over ``kernels``."""
    if options.matvec_padded is not None:
        return options.matvec_padded
    if options.kernels:
        from repro_torch.kernels import ops
        return ops.make_matvec_padded(stencil)
    return None


def resolve_precond(options: SolverOptions):
    """The ``repro_torch.precond.Preconditioner`` ``options`` asks for.

    ``None`` for ``precond="none"``.  ``options.kernels`` flows into the
    preconditioners that have kernels (``KERNEL_PRECONDS``) unless
    ``precond_params`` pins ``use_kernels`` itself: the same one-flag rule as
    the stencil SpMV.
    """
    if options.precond in (None, "none"):
        return None
    from repro_torch.precond import KERNEL_PRECONDS, make_precond
    params = dict(options.precond_params or {})
    if options.kernels and options.precond in KERNEL_PRECONDS:
        params.setdefault("use_kernels", True)
    return make_precond(options.precond, **params)
