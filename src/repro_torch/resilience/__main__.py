"""``python -m repro_torch.resilience --smoke`` — the seeded chaos suite's
solver half (counterpart of ``python -m repro.resilience --smoke``).

    python -m repro_torch.resilience --smoke                 # on the card
    python -m repro_torch.resilience --smoke --device cpu    # plain versions

One process runs the solver checks end to end against real solves, records
the run as a ``repro.obs/v1`` trace (``TRACE_chaos.jsonl`` by default), and
prints a JSON summary whose ``ok`` field is the gate (exit code 1 when it
is false):

  * ``nan_raises``               — a NaN-poisoned right-hand side ends a
    guarded solve with ``status="breakdown"``, and the ``raise`` policy
    raises ``SolveBreakdown``;
  * ``fallback_clean_converges`` — merged CG under ``on_breakdown=
    "fallback"`` converges on a clean system;
  * ``trace_validates``          — every record of the trace passes the
    schema (``python -m repro_torch.obs summarize --check``).

The reference's serve checks (compile failure, preemption retry, poison
quarantine, deadline) come with the serve port (ROADMAP queue 1 item 11).
"""

from __future__ import annotations

import argparse
import json
import sys


def run_smoke(out: str, seed: int = 0, device: str = "cuda") -> dict:
    from repro_torch.api import SolverOptions, SolverSession
    from repro_torch.core.methods import STATUS_BREAKDOWN, STATUS_CONVERGED, SolveBreakdown
    from repro_torch.obs import trace as obs

    checks: dict[str, bool] = {}
    obs.enable(out)
    try:
        with obs.span("chaos.smoke", seed=seed, device=device):
            grid = (8, 8, 8)

            # -- solver: NaN operand -> typed breakdown, raise policy ---------
            sess = SolverSession(grid=grid, method="cg", device=device,
                                 options=SolverOptions(tol=1e-8, maxiter=200,
                                                       guards=True))
            bad = sess.problem.b().clone()
            bad[0, 0, 0] = float("nan")
            try:
                sess.solve(bad)
                checks["nan_raises"] = False
            except SolveBreakdown as e:
                checks["nan_raises"] = e.result.status == STATUS_BREAKDOWN

            # -- solver: fallback ladder converges on a clean system ----------
            sess_fb = SolverSession(
                grid=grid, method="cg_merged", device=device,
                options=SolverOptions(tol=1e-8, maxiter=200, kernels=True,
                                      on_breakdown="fallback"))
            checks["fallback_clean_converges"] = (
                sess_fb.solve().status == STATUS_CONVERGED)
    finally:
        obs.disable()
    problems = obs.validate_stream(out)
    checks["trace_validates"] = not problems
    return {"ok": all(checks.values()), "seed": seed, "device": device,
            "checks": checks, "trace": out, "trace_problems": problems[:5]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.resilience")
    ap.add_argument("--smoke", action="store_true",
                    help="run the seeded chaos suite's solver checks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    ap.add_argument("--out", default="TRACE_chaos.jsonl",
                    help="trace artifact path")
    args = ap.parse_args(argv)
    if not args.smoke:
        ap.error("nothing to do: pass --smoke")
    summary = run_smoke(args.out, seed=args.seed, device=args.device)
    print(json.dumps(summary, indent=2, sort_keys=True))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
