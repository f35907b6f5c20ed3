"""``python -m repro_torch.obs`` — trace tooling and the measured cost
attribution (counterpart of ``python -m repro.obs``).

Modes::

    python -m repro_torch.obs summarize TRACE.jsonl [--check] [--json]
    python -m repro_torch.obs attribute --grid 16 16 16 \
        --methods cg cg_merged cg_pipe [--halo-mode overlap] [--json]
    torchrun --nproc_per_node 2 -m repro_torch.obs attribute --device cpu
    python -m repro_torch.obs attribute TRACE.jsonl        # re-render from records

``summarize`` validates every record against the ``repro.obs/v1`` schema
and prints the aggregation view (per-span percentiles, event counts);
``--check`` exits non-zero on any schema violation.  ``attribute``
measures the per-phase iteration split (see ``repro_torch.obs.attribution``)
on the 1-D ``cells`` mesh of ``min(--devices, ranks)`` ranks: one rank
with no process group, or the ranks ``torchrun`` starts (the group joined
as ``launch/solve.py`` joins it: ``nccl`` on the card, ``gloo`` on the
CPU; ranks outside the mesh wait at a barrier).  ``--grid`` is the global
grid, ``--device`` the card (default) or the CPU, ``--no-f64`` measures
f32.  The predicted columns print ``-`` until an H100 cost model is
fitted (ROADMAP queue 1, item 12b).  Given a trace file instead, it
re-renders the table from the ``obs.attribution`` records a prior run
emitted.  Only rank 0 prints.
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


def _measure(args) -> tuple[list[dict], bool]:
    """This rank's rows (empty outside the mesh) and whether it prints."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import Mesh, make_solver_mesh
    from repro_torch.launch.solve import init_ranks
    from repro_torch.obs.attribution import attribution_report

    device, owned = init_ranks(None, args.device)
    try:
        grouped = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if grouped else 1
        n = min(args.devices, world)
        if n == world:
            mesh = make_solver_mesh(n)
        else:                                  # every rank makes the subgroup
            group = dist.new_group(list(range(n)))
            mesh = Mesh((n,), ("cells",), group=group) if dist.get_rank() < n else None
        rows = [] if mesh is None else attribution_report(
            args.methods, tuple(args.grid), mesh, halo_mode=args.halo_mode,
            inner=args.inner, repeats=args.repeats, profile_dir=args.profile_dir,
            device=device, f64=args.f64)
        if grouped:
            dist.barrier()
        return rows, not grouped or dist.get_rank() == 0
    finally:
        if owned:
            dist.destroy_process_group()


def _attribute(args) -> int:
    from repro_torch.obs import trace
    from repro_torch.obs.attribution import format_table, rows_from_trace

    if args.trace:
        rows, lead = rows_from_trace(trace.read_trace(args.trace)), True
        if not rows:
            print(f"[obs] {args.trace}: no obs.attribution records",
                  file=sys.stderr)
            return 1
    else:
        rows, lead = _measure(args)
    if lead:
        print(format_table(rows))
        if args.json:
            print(json.dumps({"rows": rows}))
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="repro.obs/v1 trace tooling: schema-checked summaries and "
                    "the measured per-phase cost attribution")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("summarize", help="validate + aggregate a trace")
    s.add_argument("trace", help="JSONL trace (repro.obs/v1 records)")
    s.add_argument("--check", action="store_true",
                   help="exit non-zero on schema violations")
    s.add_argument("--json", action="store_true")

    a = sub.add_parser("attribute",
                       help="measure the per-phase iteration split")
    a.add_argument("trace", nargs="?", default=None,
                   help="re-render from a trace's obs.attribution records "
                        "instead of measuring")
    a.add_argument("--methods", nargs="+",
                   default=["cg", "cg_merged", "cg_pipe"])
    a.add_argument("--grid", type=int, nargs=3, default=[16, 16, 16],
                   help="the global grid")
    a.add_argument("--devices", type=int, default=8,
                   help="ranks of the mesh (at most the group's)")
    a.add_argument("--halo-mode", default="concat",
                   choices=["concat", "scatter", "overlap"])
    a.add_argument("--inner", type=int, default=8,
                   help="phase trips per timed call (amortises dispatch)")
    a.add_argument("--repeats", type=int, default=5)
    a.add_argument("--profile-dir", default=None,
                   help="also write each rank's torch.profiler trace here")
    a.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain versions)")
    a.add_argument("--f64", action=argparse.BooleanOptionalAction, default=True,
                   help="double precision (--no-f64 for f32)")
    a.add_argument("--json", action="store_true")

    args = ap.parse_args(sys.argv[1:] if argv is None else list(argv))
    return _summarize(args) if args.cmd == "summarize" else _attribute(args)


if __name__ == "__main__":
    sys.exit(main())
