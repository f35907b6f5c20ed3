"""Solver registry: methods + the metadata the paper reasons about.

Counterpart of ``repro/api/registry.py``, with every method of the reference.  Each
entry carries the per-iteration communication structure (reductions, how each
one hides, SpMV and halo-exchange counts) and the solver-selection facts; the
fields derivable from the ``MethodDef`` are cross-checked against it at
registration, and the whole table against ``core.solvers`` at import.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core import solvers as _solvers
from repro_torch.core.methods import METHODS, MethodDef

#: accepted ``SolverSpec.reduce_hide`` values (see the reference)
REDUCE_HIDES = ("none", "merged", "pipelined")


@dataclasses.dataclass(frozen=True)
class SolverSpec:
    """A solver plus the metadata the drivers and models need."""

    name: str
    fn: Callable                      # (A, b, x0, *, tol, maxiter, dot, norm_ref)
    reduction_hides: tuple[str, ...]
    spmvs_per_iter: int
    halo_hides: tuple[str, ...] = ()  # defaults to all-"interior"
    variant_of: str | None = None
    spd_required: bool = False
    stationary: bool = False
    accepts_precond: bool = False     # fn takes M= (repro_torch.precond apply)
    precond_applies_per_iter: int = 0  # M⁻¹ applications per iteration
    reduce_hide: str = "none"
    fused_kernels: tuple[str, ...] = ()
    allreduces_per_iter: int | None = None
    halo_exchanges_per_iter: int | None = None
    description: str = ""
    method_def: MethodDef | None = None

    def __post_init__(self):
        if not self.halo_hides:
            object.__setattr__(
                self, "halo_hides", ("interior",) * self.spmvs_per_iter)
        if len(self.halo_hides) != self.spmvs_per_iter:
            raise ValueError(
                f"{self.name!r}: halo_hides needs one entry per SpMV "
                f"({len(self.halo_hides)} != {self.spmvs_per_iter})")
        if self.precond_applies_per_iter and not self.accepts_precond:
            raise ValueError(
                f"{self.name!r}: precond_applies_per_iter without "
                f"accepts_precond")
        if self.reduce_hide not in REDUCE_HIDES:
            raise ValueError(
                f"{self.name!r}: unknown reduce_hide {self.reduce_hide!r}; "
                f"options: {REDUCE_HIDES}")
        if self.reduce_hide != "none" and len(self.reduction_hides) != 1:
            raise ValueError(
                f"{self.name!r}: reduce_hide={self.reduce_hide!r} means ONE "
                f"stacked reduction per iteration, but reduction_hides has "
                f"{len(self.reduction_hides)} entries")
        if self.reduce_hide == "pipelined" and self.reduction_hides != ("pipe",):
            raise ValueError(
                f"{self.name!r}: a pipelined variant's single reduction "
                f"hides behind the next SpMV, so reduction_hides must be "
                f"('pipe',)")
        if self.allreduces_per_iter is None:
            object.__setattr__(
                self, "allreduces_per_iter", self.reductions_per_iter)
        if self.halo_exchanges_per_iter is None:
            object.__setattr__(
                self, "halo_exchanges_per_iter", self.spmvs_per_iter)
        if self.allreduces_per_iter > self.reductions_per_iter:
            raise ValueError(
                f"{self.name!r}: allreduces_per_iter exceeds the declared "
                f"logical reductions")
        if self.halo_exchanges_per_iter < self.spmvs_per_iter:
            raise ValueError(
                f"{self.name!r}: halo_exchanges_per_iter below spmvs_per_iter")

    @property
    def reductions_per_iter(self) -> int:
        return len(self.reduction_hides)

    @property
    def blocking_reductions(self) -> int:
        """Reductions with no overlap window (the paper's hard barriers)."""
        return sum(1 for h in self.reduction_hides if h == "none")

    @property
    def has_fused_body(self) -> bool:
        """Whether the method declares a fused kernel iteration body — the
        capability the facade's ``kernels=True`` routing queries."""
        return bool(self.fused_kernels)


REGISTRY: dict[str, SolverSpec] = {}


class RegistryConsistencyError(RuntimeError):
    """The registry drifted from ``core.solvers``/``core.methods``.  A drift
    from a MethodDef prints every mismatched field as an aligned table
    (method, field, registry value, derived value)."""


@dataclasses.dataclass(frozen=True)
class FieldDiff:
    """One registry-vs-derived mismatch (a row of the consistency report)."""

    method: str
    field: str
    registry_value: object
    derived_value: object

    def __str__(self) -> str:
        return (f"{self.method}.{self.field}: registry declares "
                f"{self.registry_value!r}, derived says {self.derived_value!r}")


def format_field_diffs(diffs: list[FieldDiff]) -> str:
    """Render mismatches as an aligned expected-vs-actual table."""
    rows = [("method", "field", "registry", "derived")]
    rows += [(d.method, d.field, repr(d.registry_value), repr(d.derived_value))
             for d in diffs]
    widths = [max(len(r[c]) for r in rows) for c in range(4)]
    lines = ["  ".join(cell.ljust(w) for cell, w in zip(row, widths)).rstrip()
             for row in rows]
    lines.insert(1, "  ".join("-" * w for w in widths))
    return "\n".join(lines)


def method_field_diff(spec: SolverSpec, mdef: MethodDef) -> list[FieldDiff]:
    """Registry fields derivable from the MethodDef that disagree with it
    (the definition is the single source of truth); empty when consistent.
    ``python -m repro_torch.analysis`` re-runs it over the whole registry."""
    derived = {
        "stationary": mdef.stationary,
        "accepts_precond": mdef.accepts_precond,
        "reduce_hide": mdef.reduce_hide,
        "variant_of": mdef.variant_of,
        "fused_kernels": mdef.fused_kernels,
    }
    return [FieldDiff(spec.name, field, getattr(spec, field), want)
            for field, want in derived.items() if getattr(spec, field) != want]


def fused_capability_diff(spec: SolverSpec, mdef: MethodDef) -> list[FieldDiff]:
    """The ``fused_kernels`` capability must be executable, not just
    declared: a non-empty tuple needs the MethodDef to carry a fused body
    (``fused_step``/``fused_init``), and every named kernel must be a
    ``KernelOp`` hook (where the reference checks ``PallasOp``)."""
    if not spec.fused_kernels:
        return []
    from repro_torch.kernels.kernel_op import KernelOp

    diffs = []
    if mdef.fused_step is None or mdef.fused_init is None:
        diffs.append(FieldDiff(
            spec.name, "fused_kernels", spec.fused_kernels,
            "() — MethodDef has no fused body (fused_step/fused_init)"))
    missing = tuple(k for k in spec.fused_kernels
                    if not callable(getattr(KernelOp, k, None)))
    if missing:
        diffs.append(FieldDiff(
            spec.name, "fused_kernels", spec.fused_kernels,
            f"KernelOp hooks — {missing} not found on KernelOp"))
    return diffs


def _validate_against_method(spec: SolverSpec, mdef: MethodDef) -> None:
    diffs = method_field_diff(spec, mdef) + fused_capability_diff(spec, mdef)
    if diffs:
        raise RegistryConsistencyError(
            f"{spec.name!r} drifted from its MethodDef:\n" + format_field_diffs(diffs))


def register_solver(spec: SolverSpec) -> SolverSpec:
    if spec.name in REGISTRY:
        raise ValueError(f"solver {spec.name!r} already registered")
    if spec.variant_of is not None and spec.variant_of not in REGISTRY:
        raise ValueError(
            f"{spec.name!r}: unknown baseline {spec.variant_of!r} "
            f"(register the classical method first)")
    if spec.name not in METHODS:
        raise RegistryConsistencyError(
            f"{spec.name!r}: no MethodDef in repro_torch.core.methods")
    mdef = METHODS[spec.name]
    _validate_against_method(spec, mdef)
    object.__setattr__(spec, "method_def", mdef)
    REGISTRY[spec.name] = spec
    return spec


def get_solver(name: str) -> SolverSpec:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown method {name!r}; options: {sorted(REGISTRY)}") from None


def solver_names() -> list[str]:
    return sorted(REGISTRY)


def variant_pairs() -> list[tuple[str, str]]:
    """(classical, variant) pairs — the paper's side-by-side comparisons."""
    return sorted((s.variant_of, s.name) for s in REGISTRY.values()
                  if s.variant_of is not None)


def fallback_chain(name: str) -> list[str]:
    """``[name, its variant_of, ...]`` down to the classical method — the
    robustness ladder ``on_breakdown="fallback"`` walks: each rung trades
    back a communication-hiding rearrangement for the plainer recurrence it
    was derived from.  Cycle-safe, and always at least ``[name]``."""
    chain, seen = [name], {name}
    cur = get_solver(name)
    while cur.variant_of is not None and cur.variant_of not in seen:
        chain.append(cur.variant_of)
        seen.add(cur.variant_of)
        cur = get_solver(cur.variant_of)
    return chain


# --- the paper's methods (reduction structure per §3.1/Fig. 1) --------------

register_solver(SolverSpec(
    name="jacobi", fn=_solvers.jacobi,
    reduction_hides=("none",), spmvs_per_iter=1, stationary=True,
    description="x += D^-1 r; 1 SpMV + 1 blocking residual reduction"))

register_solver(SolverSpec(
    name="gauss_seidel_rb", fn=_solvers.sym_gauss_seidel_rb,
    reduction_hides=("none",), spmvs_per_iter=2, stationary=True,
    halo_hides=("none", "none"), halo_exchanges_per_iter=5,
    description="red-black coloured symmetric Gauss-Seidel (§3.4)"))

register_solver(SolverSpec(
    name="gauss_seidel", fn=_solvers.sym_gauss_seidel_relaxed,
    reduction_hides=("none",), spmvs_per_iter=2, stationary=True,
    halo_hides=("none", "none"), halo_exchanges_per_iter=3,
    variant_of="gauss_seidel_rb",
    description="relaxed symmetric GS (§3.4 Code 4, plane sweep)"))

register_solver(SolverSpec(
    name="cg", fn=_solvers.cg,
    reduction_hides=("none", "vec"), spmvs_per_iter=1, spd_required=True,
    description="classical conjugate gradient (2 blocking reductions)"))

register_solver(SolverSpec(
    name="cg_nb", fn=_solvers.cg_nb,
    reduction_hides=("spmv", "vec"), spmvs_per_iter=1, spd_required=True,
    variant_of="cg",
    description="nonblocking CG (Alg. 1): both reductions off the critical path"))

register_solver(SolverSpec(
    name="pcg", fn=_solvers.pcg,
    reduction_hides=("none", "none", "vec"), spmvs_per_iter=1,
    spd_required=True, variant_of="cg",
    allreduces_per_iter=2,       # the (r·z, r·r) pair rides one stacked dot2
    accepts_precond=True, precond_applies_per_iter=1,
    description="preconditioned CG (repro_torch.precond): p·Ap and r·z "
                "block, r·r feeds only the check; +0 reductions from the "
                "built-in preconditioners"))

register_solver(SolverSpec(
    name="bicgstab", fn=_solvers.bicgstab,
    reduction_hides=("none", "none", "vec"), spmvs_per_iter=2,
    description="classical BiCGStab (3 blocking reductions)"))

register_solver(SolverSpec(
    name="bicgstab_b1", fn=_solvers.bicgstab_b1,
    reduction_hides=("none", "vec", "vec"), spmvs_per_iter=2,
    variant_of="bicgstab",
    description="BiCGStab one-blocking (Alg. 2) with restart"))

register_solver(SolverSpec(
    name="pbicgstab", fn=_solvers.pbicgstab,
    reduction_hides=("none", "none", "vec"), spmvs_per_iter=2,
    variant_of="bicgstab",
    accepts_precond=True, precond_applies_per_iter=2,
    description="right-preconditioned BiCGStab (true-residual stopping)"))

register_solver(SolverSpec(
    name="cg_merged", fn=_solvers.cg_merged,
    reduction_hides=("none",), spmvs_per_iter=1, spd_required=True,
    variant_of="cg", reduce_hide="merged",
    fused_kernels=("cg_body", "spmv_dots"),
    description="Chronopoulos–Gear CG: all dots in ONE stacked reduction "
                "(Saad recurrence for p·Ap)"))

register_solver(SolverSpec(
    name="pcg_merged", fn=_solvers.pcg_merged,
    reduction_hides=("none",), spmvs_per_iter=1, spd_required=True,
    variant_of="pcg", reduce_hide="merged",
    accepts_precond=True, precond_applies_per_iter=1,
    fused_kernels=("pcg_body", "spmv_dots3"),
    description="merged-reduction PCG (Chronopoulos–Gear with M)"))

register_solver(SolverSpec(
    name="cg_pipe", fn=_solvers.cg_pipe,
    reduction_hides=("pipe",), spmvs_per_iter=1, spd_required=True,
    variant_of="cg", reduce_hide="pipelined",
    fused_kernels=("spmv_dots3", "pipe_body"),
    description="Ghysels–Vanroose pipelined CG: the ONE stacked reduction "
                "overlaps the SpMV"))

register_solver(SolverSpec(
    name="pcg_pipe", fn=_solvers.pcg_pipe,
    reduction_hides=("pipe",), spmvs_per_iter=1, spd_required=True,
    variant_of="pcg", reduce_hide="pipelined",
    accepts_precond=True, precond_applies_per_iter=1,
    fused_kernels=("fused_dots", "ppipe_body"),
    description="pipelined PCG: the stacked reduction overlaps M-apply + SpMV"))

register_solver(SolverSpec(
    name="bicgstab_merged", fn=_solvers.bicgstab_merged,
    reduction_hides=("none",), spmvs_per_iter=2,
    variant_of="bicgstab", reduce_hide="merged",
    fused_kernels=("bicgstab_spmv_dots", "bicgstab_update1",
                   "bicgstab_spmv_update"),
    description="single-reduction BiCGStab: nine dots, ONE stacked reduction "
                "(Cools–Vanroose recurrences)"))

register_solver(SolverSpec(
    name="pbicgstab_merged", fn=_solvers.pbicgstab_merged,
    reduction_hides=("none",), spmvs_per_iter=2,
    variant_of="pbicgstab", reduce_hide="merged",
    accepts_precond=True, precond_applies_per_iter=2,
    fused_kernels=("bicgstab_spmv_dots", "bicgstab_update1",
                   "bicgstab_spmv_update"),
    description="right-preconditioned single-reduction BiCGStab "
                "(merged core on A∘M⁻¹, true-residual stopping)"))


def fused_solver_names() -> list[str]:
    """Methods whose MethodDef declares a fused kernel iteration body."""
    return sorted(n for n, s in REGISTRY.items() if s.has_fused_body)


def check_consistent_with_core(registry=None, solvers=None,
                               variant_of=None) -> None:
    """The registry must cover exactly what ``core.solvers`` exports; raises
    :class:`RegistryConsistencyError` (not ``assert``, so ``-O`` keeps it)."""
    registry = REGISTRY if registry is None else registry
    solvers = _solvers.SOLVERS if solvers is None else solvers
    variant_of = _solvers.VARIANT_OF if variant_of is None else variant_of
    if set(registry) != set(solvers):
        raise RegistryConsistencyError(
            f"method sets differ: registry-only="
            f"{sorted(set(registry) - set(solvers))}, "
            f"core-only={sorted(set(solvers) - set(registry))}")
    for name, spec in registry.items():
        if spec.fn is not solvers[name]:
            raise RegistryConsistencyError(
                f"{name!r}: registered fn is not core.solvers.SOLVERS[{name!r}]")
    for variant, base in variant_of.items():
        if variant not in registry or registry[variant].variant_of != base:
            raise RegistryConsistencyError(
                f"{variant!r}: registry variant_of disagrees with core "
                f"({base!r})")


check_consistent_with_core()
