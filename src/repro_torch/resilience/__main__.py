"""``python -m repro_torch.resilience --smoke`` — the seeded chaos suite
(counterpart of ``python -m repro.resilience --smoke``).

    python -m repro_torch.resilience --smoke                 # on the card
    python -m repro_torch.resilience --smoke --device cpu    # plain versions

One process runs every check end to end against real solves and a real
service (``kernels=True``), records
the run as a ``repro.obs/v1`` trace (``TRACE_chaos.jsonl`` by default), and
prints a JSON summary whose ``ok`` field is the gate (exit code 1 when it
is false):

  * ``nan_raises``               — a NaN-poisoned right-hand side ends a
    guarded solve with ``status="breakdown"``, and the ``raise`` policy
    raises ``SolveBreakdown``;
  * ``fallback_clean_converges`` — merged CG under ``on_breakdown=
    "fallback"`` converges on a clean system;
  * ``compile_fail_rejects``     — a bucket whose build fails (injected)
    turns its requests into typed ``compile_failed`` rejects;
  * ``clean_complete``           — the other bucket's clean requests
    converge;
  * ``poison_quarantined``       — a NaN right-hand side in a batch is
    rejected as ``poisoned`` (guards on), its neighbours served;
  * ``deadline_rejected``        — a request past its deadline is rejected
    at dispatch;
  * ``retry_not_requeue``        — an injected preemption is retried in
    place (backoff + seeded jitter), not requeued;
  * ``nothing_stranded``         — every submitted request is either served
    or rejected;
  * ``trace_validates``          — every record of the trace passes the
    schema (``python -m repro_torch.obs summarize --check``).

Everything is seeded: two runs make the same injections and rejects.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def run_smoke(out: str, seed: int = 0, device: str = "cuda") -> dict:
    from repro_torch.api import SolverOptions, SolverSession
    from repro_torch.core.methods import STATUS_BREAKDOWN, STATUS_CONVERGED, SolveBreakdown
    from repro_torch.obs import trace as obs
    from repro_torch.resilience import ChaosInjector, ChaosPlan
    from repro_torch.serve import Request, ServeConfig, SolverService

    rng = np.random.default_rng(seed)
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

            # -- serve: compile failure + preempt-retry + quarantine +
            #    deadline, one service ----------------------------------------
            inj = ChaosInjector(ChaosPlan(
                seed=seed, fail_compile_buckets=("bicgstab",),
                preempt_at=(0,)))
            svc = SolverService(
                ServeConfig(max_batch=4, guards=True, max_retries=2,
                            retry_backoff_s=0.01, retry_seed=seed,
                            kernels=True, device=device),
                injector=inj)
            ids_ok = [svc.submit(Request(b=rng.standard_normal(grid),
                                         method="cg", maxiter=200))
                      for _ in range(3)]
            ids_cf = [svc.submit(Request(b=rng.standard_normal(grid),
                                         method="bicgstab", maxiter=200))
                      for _ in range(2)]
            poisoned = rng.standard_normal(grid)
            poisoned[0, 0, 0] = np.nan
            id_poison = svc.submit(Request(b=poisoned, method="cg",
                                           maxiter=200))
            id_dead = svc.submit(Request(b=rng.standard_normal(grid),
                                         method="cg", maxiter=200,
                                         deadline_s=0.0))
            svc.run_until_drained()
            svc.close()
            res, rej = svc.results(), svc.rejects()
            snap = svc.snapshot()
            checks["compile_fail_rejects"] = all(
                rej.get(i) is not None
                and rej[i].reason == "compile_failed" for i in ids_cf)
            checks["clean_complete"] = all(
                i in res and res[i].status == "converged" for i in ids_ok)
            checks["poison_quarantined"] = (
                id_poison in rej and rej[id_poison].reason == "poisoned")
            checks["deadline_rejected"] = (
                id_dead in rej and rej[id_dead].reason == "deadline")
            checks["retry_not_requeue"] = (snap["retries"] >= 1
                                           and snap["preemptions"] == 0)
            checks["nothing_stranded"] = (
                len(res) + len(rej) == snap["completed"]
                + snap["service_rejects"] == len(ids_ok) + len(ids_cf) + 2)
    finally:
        obs.disable()
    problems = obs.validate_stream(out)
    checks["trace_validates"] = not problems
    return {"ok": all(checks.values()), "seed": seed, "device": device,
            "checks": checks, "trace": out, "trace_problems": problems[:5]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.resilience")
    ap.add_argument("--smoke", action="store_true",
                    help="run the seeded chaos suite")
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
