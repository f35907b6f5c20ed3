"""The one result type every analysis pass emits (a copy of
``repro/analysis/violation.py``: the port imports nothing of the reference).

A :class:`Violation` is a machine-checkable contract breach: which pass
found it, what it looked at, which field drifted, and the expected-vs-actual
pair.  Tests assert on (pass_name, subject, field) triples.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Violation:
    pass_name: str      # "lint_kernels"
    subject: str        # e.g. "kernel:spmv", "ptxas:fused_bodies"
    field: str          # e.g. "wrapper", "threads", "ptxas_spill"
    expected: object
    actual: object
    detail: str = ""

    def __str__(self) -> str:
        s = (f"[{self.pass_name}] {self.subject} :: {self.field}: "
             f"expected {self.expected!r}, got {self.actual!r}")
        return f"{s} — {self.detail}" if self.detail else s


def format_violations(violations: list[Violation]) -> str:
    if not violations:
        return "no violations"
    by_pass: dict[str, list[Violation]] = {}
    for v in violations:
        by_pass.setdefault(v.pass_name, []).append(v)
    lines = []
    for pass_name in sorted(by_pass):
        vs = by_pass[pass_name]
        lines.append(f"{pass_name}: {len(vs)} violation(s)")
        lines.extend(f"  {v}" for v in vs)
    return "\n".join(lines)
