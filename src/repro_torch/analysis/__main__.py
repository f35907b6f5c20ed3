"""``python -m repro_torch.analysis`` — run the port's contract checks.

Counterpart of ``python -m repro.analysis``.  Modes::

    python -m repro_torch.analysis --lint-only     # registry, AST and kernel passes

``--lint-only`` runs the registry-vs-MethodDef field sweep, the MethodDef
lint (``lint_methods``) and the kernel lint (``lint_kernels``) and exits 1 on
any violation.  The reference's full audit (no mode, ``--check``,
``--write``) counts the collectives of every method on a mesh against a
committed baseline; the port's collectives come with the distributed solve
(ROADMAP.md queue 1 item 10), so each raises ``NotImplementedError`` naming
item 13.
"""

from __future__ import annotations

import argparse
import sys


def _registry_violations():
    """Re-assert registry <-> MethodDef consistency as auditable findings.

    Registration already fails on drift (``RegistryConsistencyError``), so
    the sweep is clean by construction; it exists so the report states the
    invariant was checked, and so a spec built outside ``register_solver``
    is still caught."""
    from repro_torch.analysis.violation import Violation
    from repro_torch.api.registry import REGISTRY, method_field_diff
    from repro_torch.core.methods import METHODS

    out = []
    for name in sorted(REGISTRY):
        if name not in METHODS:
            out.append(Violation("registry", name, "method_def",
                                 expected="a registered MethodDef", actual="missing"))
            continue
        for d in method_field_diff(REGISTRY[name], METHODS[name]):
            out.append(Violation("registry", name, d.field, expected=d.derived_value,
                                 actual=d.registry_value,
                                 detail="SolverSpec drifted from MethodDef"))
    for name in sorted(set(METHODS) - set(REGISTRY)):
        out.append(Violation("registry", name, "solver_spec",
                             expected="a registry entry per MethodDef", actual="missing"))
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static contract checks: the registry sweep, the MethodDef "
                    "AST lint, the CUDA kernel lint")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--check", metavar="AUDIT.json",
                      help="full audit against a baseline (needs item 10)")
    mode.add_argument("--write", metavar="AUDIT.json",
                      help="measure and write a baseline (needs item 10)")
    mode.add_argument("--lint-only", action="store_true",
                      help="the registry, MethodDef and kernel passes")
    args = ap.parse_args(argv)
    if not args.lint_only:
        raise NotImplementedError(
            "the full audit (--check, --write): the collective audit of ROADMAP.md "
            "queue 1 item 13 counts the collectives of the distributed solve, which "
            "is not ported yet (item 10); run --lint-only")

    from repro_torch.analysis.lint_kernels import check_kernels
    from repro_torch.analysis.lint_methods import check_methods
    from repro_torch.analysis.violation import format_violations

    violations = []
    print("[1/3] registry <-> MethodDef field sweep", flush=True)
    violations += _registry_violations()
    print("[2/3] MethodDef AST + state-layout lint", flush=True)
    violations += check_methods()
    print("[3/3] CUDA kernel static checks", flush=True)
    violations += check_kernels()
    if violations:
        print(format_violations(violations), file=sys.stderr)
        print(f"FAILED: {len(violations)} violation(s)", file=sys.stderr)
        return 1
    print("OK: all contracts hold")
    return 0


if __name__ == "__main__":
    sys.exit(main())
