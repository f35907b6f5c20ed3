"""The preconditioner protocol and registry (counterpart of
``repro/precond/base.py``, whose docstring gives the design).

Every implementation is reduction-free and carries the cost metadata the
drivers and models read: ``extra_reductions_per_apply`` (0 for all built-ins),
``matvecs_per_apply`` / ``halo_matvecs_per_apply``, ``halo_hide`` and
``spd_preserving`` (whether ``pcg`` applies).

Protocol: ``setup(A) -> state`` (once per bind), ``apply(state, A, r) -> z``;
``bind(A)`` packages both into the ``z = M⁻¹ r`` callable the solvers take as
``M=``.  ``A`` is any operator satisfying the ``LocalOp`` protocol
(``matvec``, ``matvec_local``, ``pad_exchange``, ``diag``, ``stencil``), a
``KernelOp`` included.
"""

from __future__ import annotations

from typing import Callable

import torch


class Preconditioner:
    """Base class; subclasses are registered in ``PRECONDITIONERS``."""

    name: str = "?"
    spd_preserving: bool = True
    #: global reductions per apply (all built-ins: 0 — no new barriers)
    extra_reductions_per_apply: int = 0
    #: halo-exchange hide kind of the apply's exchanges: "interior" (rides
    #: behind the interior stencil apply) or "none" (consumed at once)
    halo_hide: str = "interior"

    # -- the protocol ---------------------------------------------------------
    def setup(self, A) -> tuple:
        """Build the per-solve state."""
        return ()

    def apply(self, state, A, r: torch.Tensor) -> torch.Tensor:
        """``z ≈ A⁻¹ r``: one application of ``M⁻¹``."""
        raise NotImplementedError

    def bind(self, A) -> Callable[[torch.Tensor], torch.Tensor]:
        """The ``z = M⁻¹ r`` callable the solvers accept as ``M=``."""
        state = self.setup(A)

        def apply_M(r: torch.Tensor) -> torch.Tensor:
            return self.apply(state, A, r)

        return apply_M

    # -- cost metadata --------------------------------------------------------
    @property
    def matvecs_per_apply(self) -> int:
        """Stencil applications per ``M⁻¹ r``."""
        return 0

    @property
    def halo_matvecs_per_apply(self) -> int:
        """...of which need a halo exchange in the distributed world."""
        return 0

    def touched_elements_per_apply(self, nbar: int) -> int:
        """Per-row memory traffic of one apply in the paper's §3.1 units."""
        raise NotImplementedError

    def describe(self) -> str:
        return self.name


#: name -> Preconditioner subclass; "none" is represented by Python None
PRECONDITIONERS: dict[str, type] = {}


def register_preconditioner(cls: type) -> type:
    """Class decorator: add a Preconditioner implementation to the registry."""
    if not issubclass(cls, Preconditioner):
        raise TypeError(f"{cls!r} is not a Preconditioner subclass")
    if cls.name in PRECONDITIONERS:
        raise ValueError(f"preconditioner {cls.name!r} already registered")
    PRECONDITIONERS[cls.name] = cls
    return cls


def precond_names() -> tuple[str, ...]:
    """Accepted ``SolverOptions.precond`` values ("none" + the registry)."""
    return ("none", *sorted(PRECONDITIONERS))


def make_precond(name: str | None, **params) -> Preconditioner | None:
    """Build a configured preconditioner; ``"none"``/``None`` -> ``None``.

    ``params`` are the implementation's constructor knobs (``sweeps=``,
    ``omega=``, ``degree=``, ``use_kernels=``, ...).
    """
    if name is None or name == "none":
        if params:
            raise ValueError(f"precond='none' takes no params, got {params}")
        return None
    try:
        cls = PRECONDITIONERS[name]
    except KeyError:
        raise KeyError(
            f"unknown preconditioner {name!r}; options: {precond_names()}"
        ) from None
    return cls(**params)
