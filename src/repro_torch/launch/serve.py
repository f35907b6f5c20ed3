"""Serving entry points behind one CLI (counterpart of ``repro/launch/serve.py``):
``--mode solver`` (default ``lm``, as in the reference).

``solver`` — the solver service (``repro_torch.serve``): replay a
             mixed-workload trace through continuous batching over the
             executable cache, print SLO metrics, optionally inject a
             preemption to exercise the WAL recovery path.
``lm``     — the reference's batched LM decode demo; it waits for the LM
             side path (ROADMAP queue 1 item 14) and raises.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode solver \
        --kernels --scale 2 --fail-at 3 --json                 # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --mode solver \
        --device cpu --buckets smoke --json                    # plain versions

``--device`` (default ``cuda``) and ``--kernels`` (the reference's Pallas
route) are ``launch/solve.py``'s.
"""

from __future__ import annotations

import argparse
import json


def _solver_main(args) -> dict:
    from repro_torch.runtime.monitor import FailureInjector
    from repro_torch.serve import (MIXED_BUCKETS, SMOKE_BUCKETS, ServeConfig,
                                   SolverService, generate_trace, replay)

    if args.trace:
        from repro_torch.obs import trace as obs
        obs.enable(args.trace)   # equivalent: REPRO_TRACE=PATH
    cfg = ServeConfig(max_batch=args.max_batch,
                      cache_capacity=args.cache_capacity,
                      async_compile=not args.sync_compile,
                      recovery_dir=args.recovery_dir,
                      kernels=args.kernels, device=args.device)
    injector = (FailureInjector(args.fail_at)
                if args.fail_at is not None else None)
    service = SolverService(cfg, injector=injector)
    recovered = service.recover()
    if recovered:
        print(f"[serve] recovered {len(recovered)} orphaned request(s) "
              f"from {cfg.recovery_dir}")
    buckets = SMOKE_BUCKETS if args.buckets == "smoke" else MIXED_BUCKETS
    trace = generate_trace(buckets, seed=args.seed, scale=args.scale)
    results = replay(service, trace)
    service.close()
    snap = service.snapshot()

    n_buckets = len({r.key() for r in trace})
    print(f"[serve] mode=solver: {len(results)}/{len(trace)} requests over "
          f"{n_buckets} buckets  max_batch={cfg.max_batch} "
          f"cache_capacity={cfg.cache_capacity} device={cfg.device}"
          f"{' [kernels]' if cfg.kernels else ''}")
    print(f"[serve] qps={snap['qps']:.2f}  p50={snap['p50_s']*1e3:.0f}ms  "
          f"p95={snap['p95_s']*1e3:.0f}ms  p99={snap['p99_s']*1e3:.0f}ms  "
          f"preemptions={snap['preemptions']} requeued={snap['requeued']}")
    c = snap["cache"]
    print(f"[serve] cache: hits={c['hits']} misses={c['misses']} "
          f"evictions={c['evictions']} entries={c['entries']}")
    for b, st in c["per_bucket"].items():
        print(f"    {b}: compiles={st['misses']} "
              f"compile_s={st['compile_s']:.2f} batches={st['hits']}")
    out = {"mode": "solver", "requests": len(trace),
           "completed": len(results), "dropped": len(trace) - len(results),
           **{k: v for k, v in snap.items() if k != "t"}}
    if args.json:
        print(json.dumps(out))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("lm", "solver"), default="lm",
                    help="lm = batched decode demo (not ported yet); solver = "
                         "the repro_torch.serve solver service replaying a "
                         "mixed trace")
    # -- lm mode (the reference's flags) ----------------------------------------
    ap.add_argument("--arch", default=None, help="(lm) model config name")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--dtype", default="float32")
    # -- solver mode -----------------------------------------------------------
    ap.add_argument("--scale", type=int, default=1,
                    help="(solver) trace size multiplier per bucket")
    ap.add_argument("--buckets", choices=("mixed", "smoke"), default="mixed",
                    help="(solver) reference mix to replay: mixed = the "
                         "reference mix, smoke = tiny grids")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="(solver) append repro.obs/v1 records (serve "
                         "lifecycle spans + SLO events) to PATH; equivalent "
                         "to REPRO_TRACE=PATH")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-batch", type=int, default=4,
                    help="(solver) padded in-flight batch size per bucket")
    ap.add_argument("--cache-capacity", type=int, default=8,
                    help="(solver) LRU bound on resident executables")
    ap.add_argument("--sync-compile", action="store_true",
                    help="(solver) build inline instead of a background "
                         "thread")
    ap.add_argument("--recovery-dir", default=None,
                    help="(solver) write-ahead journal dir (enables "
                         "preemption recovery)")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="(solver) inject a preemption at dispatch N "
                         "(exercises the recovery path)")
    ap.add_argument("--device", default="cuda",
                    help="(solver) cuda (default) or cpu (the kernels' plain "
                         "versions)")
    ap.add_argument("--kernels", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="(solver) run the buckets on the hand-written CUDA "
                         "kernels (the reference's --pallas)")
    ap.add_argument("--json", action="store_true",
                    help="(solver) also print the metrics record as JSON")
    args = ap.parse_args(argv)

    if args.mode == "solver":
        return _solver_main(args)
    raise NotImplementedError(
        "--mode lm (the batched LM decode demo) waits for the LM side path "
        "(ROADMAP.md queue 1 item 14); use --mode solver")


if __name__ == "__main__":
    main()
