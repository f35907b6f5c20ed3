"""Solver driver — the paper's workload end to end on one device.

Counterpart of ``repro/launch/solve.py``, a thin client of ``repro_torch.api``
with the flags this slice supports plus ``--device`` (default ``cuda``):

    PYTHONPATH=src python -m repro_torch.launch.solve --method cg_merged \
        --stencil 27pt --grid 128 128 128 --kernels --json

``--kernels`` is the counterpart of the reference's ``--pallas``.
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch.api import (REGISTRY, SolverOptions, SolverSession,
                             precond_names, solver_names)
from repro_torch.configs.hpcg import SOLVER_CONFIGS


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None, choices=sorted(SOLVER_CONFIGS),
                    help="named HPCG cell supplying method/stencil/tol/"
                         "maxiter defaults (explicit flags win)")
    ap.add_argument("--method", default=None, choices=solver_names())
    ap.add_argument("--stencil", default=None, choices=["7pt", "27pt"])
    ap.add_argument("--grid", type=int, nargs=3, default=[64, 64, 64])
    ap.add_argument("--tol", type=float, default=None)
    ap.add_argument("--maxiter", type=int, default=None)
    ap.add_argument("--f64", action=argparse.BooleanOptionalAction,
                    default=True, help="double precision (--no-f64 for f32)")
    ap.add_argument("--kernels", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="run the SpMV, the merged and pipelined methods' "
                         "fused bodies and the block-Jacobi/Chebyshev sweeps "
                         "on the hand-written CUDA kernels")
    takers = "/".join(n for n in solver_names() if REGISTRY[n].accepts_precond)
    ap.add_argument("--precond", default=None, choices=list(precond_names()),
                    help=f"preconditioner for {takers}: "
                         "jacobi | block_jacobi | ssor | chebyshev")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    ap.add_argument("--json", action="store_true",
                    help="also print the result record as one JSON line")
    ap.add_argument("--repeats", type=int, default=1,
                    help="timed repetitions after the warm-up call")
    args = ap.parse_args(argv)

    cfg = SOLVER_CONFIGS[args.config] if args.config else None
    method = args.method or (cfg.method if cfg else "cg_nb")
    stencil = args.stencil or (cfg.stencil if cfg else "27pt")
    overrides = dict(f64=args.f64, kernels=args.kernels)
    if args.precond is not None:
        overrides["precond"] = args.precond
    if args.tol is not None:
        overrides["tol"] = args.tol
    if args.maxiter is not None:
        overrides["maxiter"] = args.maxiter
    opts = (cfg.to_options(**overrides) if cfg
            else SolverOptions(**overrides))
    sess = SolverSession(method=method, grid=tuple(args.grid),
                         stencil=stencil, options=opts, device=args.device)
    res, stats = sess.timed_solve(repeats=args.repeats, warmup=1)
    dt = stats["median"]

    err = float(torch.max(torch.abs(res.x - sess.problem.x_true())))
    print(f"[solve] {sess.describe()} "
          f"iters={int(res.iters)} res={float(res.res_norm):.3e} "
          f"err_inf={err:.3e} wall={dt:.2f}s")
    out = {"method": method, "stencil": stencil,
           "precond": sess.options.precond,
           "iters": int(res.iters), "res_norm": float(res.res_norm),
           "err": err, "wall_s": dt, "backend": sess.backend.describe()}
    if args.json:
        print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
