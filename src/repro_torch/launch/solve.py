"""Solver driver — the paper's workload end to end on one device.

Counterpart of ``repro/launch/solve.py``, a thin client of ``repro_torch.api``
with the flags this slice supports plus ``--device`` (default ``cuda``):

    PYTHONPATH=src python -m repro_torch.launch.solve --method cg_merged \
        --stencil 27pt --grid 128 128 128 --kernels --json

``--kernels`` is the counterpart of the reference's ``--pallas``.  The solve
goes through the session's executable cache (on the card: CUDA graphs
replayed in blocks of steps); ``--json`` also reports the executable's build
seconds (``compile_s``), its block ladder, the blocks the last solve ran and
the steps it ran and dropped (``rolled_back``).  ``--batch N`` also solves N
random right-hand sides (``numpy.random.default_rng(0)``, the problem's
dtype) in one batched solve, the serving path, and reports ``batch_wall_s``,
``batch_iters`` and ``batch_res_norm``.  ``--trace PATH`` appends the
solve's ``repro.obs/v1`` spans to PATH (as ``REPRO_TRACE=PATH`` does);
``--telemetry`` carries the per-iteration scalar history through the solve
and adds its curves to the ``--json`` record (``convergence``);
``--telemetry-buffer N`` caps its rows.

``--layout 1d|2d|3d`` (or ``auto`` with more than one rank) solves on a mesh
of the ranks that ``torchrun`` starts, each a process of the group it
initialises from ``env://`` with ``--backend`` (``nccl``: one card a rank;
``gloo``: several ranks may share one card, or run on the CPU)::

    torchrun --nproc_per_node 4 -m repro_torch.launch.solve --layout 1d \
        --backend gloo --grid 128 128 512 --method cg --json

Every rank solves its block (``--grid`` is the global grid): under gloo
with the eager loop, under NCCL through the executable cache (the halo
swaps and gathers captured in the CUDA graphs); ``--halo-mode`` picks the
halo exchange, and rank 0 prints the record, ``backend`` the mesh's
``describe()``.  ``--batch N`` with ``--layout`` solves the N global lanes
as one batched mesh solve, each rank its blocks of them::

    torchrun --nproc_per_node 4 -m repro_torch.launch.solve --layout 1d \
        --backend gloo --grid 128 128 512 --method cg --batch 4 --json
"""

from __future__ import annotations

import argparse
import datetime
import json
import os

import numpy as np
import torch

from repro_torch.api import (REGISTRY, SolverOptions, SolverSession,
                             precond_names, solver_names)
from repro_torch.api.options import HALO_MODES, LAYOUTS
from repro_torch.configs.hpcg import SOLVER_CONFIGS
from repro_torch.launch.mesh import BACKENDS, check_backend, default_backend


def init_ranks(backend: str | None, device: str, *,
               timeout_s: float = 300.0) -> tuple[str, bool]:
    """Join the group ``torchrun`` describes (``env://``: ``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``...) when it has more than one process and none
    is initialised yet.  Returns this rank's device (``cuda:<LOCAL_RANK>``
    under ``nccl``, the one card shared under ``gloo``) and whether this
    call made the group (the caller then destroys it)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 or torch.distributed.is_initialized():
        return device, False
    backend = backend or default_backend(device)
    check_backend(backend, world)
    if torch.device(device).type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        index = local if backend == "nccl" else local % torch.cuda.device_count()
        torch.cuda.set_device(index)
        device = f"cuda:{index}"
    torch.distributed.init_process_group(
        backend, init_method="env://", timeout=datetime.timedelta(seconds=timeout_s))
    return device, True


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
    ap.add_argument("--layout", default="auto", choices=list(LAYOUTS),
                    help="auto = one device with one rank, else the paper-faithful "
                         "1-D z decomposition over the ranks")
    ap.add_argument("--halo-mode", default="auto", choices=list(HALO_MODES),
                    help="the distributed halo exchange (auto: overlap for the "
                         "plain apply, concat under --kernels)")
    ap.add_argument("--backend", default=None, choices=list(BACKENDS),
                    help="the process group's backend under torchrun (default: "
                         "nccl on cuda, gloo on cpu)")
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
    ap.add_argument("--batch", type=int, default=0,
                    help="also solve N random right-hand sides in one batched "
                         "solve (the serving path)")
    ap.add_argument("--repeats", type=int, default=1,
                    help="timed repetitions after the warm-up call")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="append repro.obs/v1 trace records (solve lifecycle "
                         "spans) to PATH; equivalent to REPRO_TRACE=PATH")
    ap.add_argument("--telemetry", action="store_true",
                    help="carry the per-iteration scalar history through the "
                         "solve (SolverOptions.telemetry) and report the "
                         "convergence curve; off = the same solve bit for bit")
    ap.add_argument("--telemetry-buffer", type=int, default=None,
                    help="telemetry row cap (default "
                         "SolverOptions.telemetry_buffer)")
    args = ap.parse_args(argv)

    if args.trace:
        from repro_torch.obs import trace as obs
        obs.enable(args.trace)

    device, owned = init_ranks(args.backend, args.device)
    cfg = SOLVER_CONFIGS[args.config] if args.config else None
    method = args.method or (cfg.method if cfg else "cg_nb")
    stencil = args.stencil or (cfg.stencil if cfg else "27pt")
    overrides = dict(f64=args.f64, kernels=args.kernels, layout=args.layout,
                     halo_mode=args.halo_mode)
    if args.telemetry:
        overrides["telemetry"] = True
    if args.telemetry_buffer is not None:
        overrides["telemetry_buffer"] = args.telemetry_buffer
    if args.precond is not None:
        overrides["precond"] = args.precond
    if args.tol is not None:
        overrides["tol"] = args.tol
    if args.maxiter is not None:
        overrides["maxiter"] = args.maxiter
    opts = (cfg.to_options(**overrides) if cfg
            else SolverOptions(**overrides))
    sess = SolverSession(method=method, grid=tuple(args.grid),
                         stencil=stencil, options=opts, device=device)
    res, stats = sess.timed_solve(repeats=args.repeats, warmup=1)
    dt = stats["median"]

    err = float(torch.max(torch.abs(sess.gather(res.x) - sess.problem.x_true())))
    lead = sess.mesh is None or sess.mesh.rank == 0
    if lead:
        print(f"[solve] {sess.describe()} "
              f"iters={int(res.iters)} res={float(res.res_norm):.3e} "
              f"err_inf={err:.3e} wall={dt:.2f}s")
    out = {"method": method, "stencil": stencil,
           "precond": sess.options.precond,
           "iters": int(res.iters), "res_norm": float(res.res_norm),
           "err": err, "wall_s": dt, "backend": sess.backend.describe()}
    if sess.mesh is not None:
        out["halo_mode"] = sess.halo_mode
    if sess._graphed:
        exe = sess._executables[sess.problem.shape]
        (cache,) = sess.cache_stats().values()
        out.update(compile_s=cache["compile_s"], ladder=list(exe.ladder),
                   blocks=exe.blocks, rolled_back=sum(exe.blocks) - int(res.iters))
    if args.telemetry:
        from repro_torch.obs.convergence import curve_record
        out["convergence"] = curve_record(res, method, scalars=True)
        print(f"[solve] telemetry: {out['convergence']['telemetry_rows']} "
              f"rows, scalars={sorted(out['convergence']['scalars'])}")
    if args.batch:
        rng = np.random.default_rng(0)
        bs = torch.as_tensor(rng.standard_normal((args.batch, *args.grid)),
                             dtype=res.x.dtype)
        bres, bstats = sess.timed_solve_batched(bs, repeats=args.repeats)
        if lead:
            print(f"[solve] batched x{args.batch}: iters={bres.iters.tolist()} "
                  f"wall={bstats['median']:.2f}s")
        out["batch_wall_s"] = bstats["median"]
        out["batch_iters"] = bres.iters.tolist()
        out["batch_res_norm"] = bres.res_norm.tolist()
    if args.json and lead:
        print(json.dumps(out))
    if owned:
        torch.distributed.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
