"""``python -m repro_torch.analysis`` — run the port's contract checks.

Counterpart of ``python -m repro.analysis``.  Modes::

    python -m repro_torch.analysis --lint-only               # the static passes only
    python -m repro_torch.analysis --write AUDIT_torch.json  # measure, (re)write baseline
    python -m repro_torch.analysis --check AUDIT_torch.json  # full audit, fail on drift
    python -m repro_torch.analysis                           # full audit, no baseline

Every mode runs the registry-vs-MethodDef field sweep, the MethodDef lint
(``lint_methods``) and the kernel lint (``lint_kernels``); all but
``--lint-only`` then run the collective and donation audit
(``analysis.audit``: one step of every method on three meshes of 8 spawned
gloo ranks on the CPU) and compare it with the registry and, under
``--check``, with the committed baseline.  ``--write`` writes the baseline
when the audit is otherwise clean.  ``--methods a,b`` audits a subset and
skips the baseline.  Exit status 1 on any violation.
"""

from __future__ import annotations

import argparse
import json
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
    mode.add_argument("--check", metavar="AUDIT_torch.json",
                      help="full audit against this committed baseline")
    mode.add_argument("--write", metavar="AUDIT_torch.json",
                      help="measure and (re)write the baseline, then verify")
    mode.add_argument("--lint-only", action="store_true",
                      help="the registry, MethodDef and kernel passes only")
    ap.add_argument("--methods", default=None,
                    help="comma-separated subset (the baseline is skipped)")
    args = ap.parse_args(argv)

    from repro_torch.analysis.lint_kernels import check_kernels
    from repro_torch.analysis.lint_methods import check_methods
    from repro_torch.analysis.violation import format_violations

    violations = []
    n = 3 if args.lint_only else 4
    print(f"[1/{n}] registry <-> MethodDef field sweep", flush=True)
    violations += _registry_violations()
    print(f"[2/{n}] MethodDef AST + state-layout lint", flush=True)
    violations += check_methods()
    print(f"[3/{n}] CUDA kernel static checks", flush=True)
    violations += check_kernels()
    if not args.lint_only:
        from repro_torch.analysis import audit
        methods = args.methods.split(",") if args.methods else None
        baseline = None
        if args.check and methods is None:
            try:
                with open(args.check) as f:
                    baseline = json.load(f)
            except (OSError, ValueError) as e:
                print(f"cannot read baseline {args.check!r}: {e}", file=sys.stderr)
                return 1
        print(f"[4/4] collective/donation audit (one step of every method x mesh on "
              f"{audit.N_RANKS} gloo ranks)", flush=True)
        measured = audit.run_measurements(methods)
        n_cfg = sum(len(measured.get(k, {})) for k in
                    ("comms", "donate_mesh", "local", "guard_invariance"))
        print(f"      measured {n_cfg} configurations", flush=True)
        violations += audit.compare(measured, baseline=baseline)
        if args.write and methods is None and not violations:
            with open(args.write, "w") as f:
                json.dump(audit.baseline_doc(measured), f, indent=1, sort_keys=True)
                f.write("\n")
            print(f"wrote baseline: {args.write} ({n_cfg} configurations)")
    if violations:
        print(format_violations(violations), file=sys.stderr)
        print(f"FAILED: {len(violations)} violation(s)", file=sys.stderr)
        return 1
    print("OK: all contracts hold")
    return 0


if __name__ == "__main__":
    sys.exit(main())
