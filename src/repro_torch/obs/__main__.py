"""``python -m repro_torch.obs`` — trace tooling (counterpart of
``python -m repro.obs``).

    python -m repro_torch.obs summarize TRACE.jsonl [--check] [--json]

``summarize`` validates every record against the ``repro.obs/v1`` schema
and prints the aggregation view (per-span percentiles, event counts);
``--check`` exits non-zero on any schema violation.  The reference's
``attribute`` mode (measured against predicted per-phase cost) waits for
the distributed solve and the analysis analogues (ROADMAP queue 1 items 10
and 13).
"""

from __future__ import annotations

import argparse
import json
import sys


def _summarize(args) -> int:
    from repro_torch.obs import trace

    errs = trace.validate_stream(args.trace)
    records = []
    with open(args.trace) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError:
                    pass
    summary = trace.summarize(records)
    summary["schema_errors"] = len(errs)
    if args.json:
        print(json.dumps(summary))
    else:
        print(f"[obs] {args.trace}: {summary['records']} records, "
              f"{len(errs)} schema error(s)")
        for name, st in summary["spans"].items():
            p = (f"p50={st['p50_s'] * 1e3:.1f}ms "
                 f"p99={st['p99_s'] * 1e3:.1f}ms" if st["p50_s"] is not None
                 else "")
            print(f"  span   {name:<24} x{st['count']:<5} "
                  f"total={st['total_s']:.3f}s {p}")
        for name, n in summary["events"].items():
            print(f"  event  {name:<24} x{n}")
        for name, n in summary["metrics"].items():
            print(f"  metric {name:<24} x{n}")
    for e in errs[:20]:
        print(f"[obs] schema: {e}", file=sys.stderr)
    if args.check and errs:
        print(f"[obs] FAIL: {len(errs)} schema violation(s) in {args.trace}",
              file=sys.stderr)
        return 1
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="repro.obs/v1 trace tooling: schema-checked summaries")
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("summarize", help="validate + aggregate a trace")
    s.add_argument("trace", help="JSONL trace (repro.obs/v1 records)")
    s.add_argument("--check", action="store_true",
                   help="exit non-zero on schema violations")
    s.add_argument("--json", action="store_true")
    args = ap.parse_args(sys.argv[1:] if argv is None else list(argv))
    return _summarize(args)


if __name__ == "__main__":
    sys.exit(main())
