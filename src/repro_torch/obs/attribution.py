"""Measured cost attribution per (method, mesh, halo_mode) (counterpart of
``repro/obs/attribution.py``).

The split of one solver iteration's time into its phases, measured with
the distributed step machinery of ``core/distributed.py`` on the ranks of a
:class:`repro_torch.launch.mesh.Mesh`:

  * ``t_iter``    — one full solver iteration, the method's
                    ``MethodDef.step`` as ``solve_step_shardmap`` builds it
                    for one rank;
  * ``t_halo``    — the halo-assembly phase: ``DistributedOp.pad_exchange``
                    (the point-to-point swaps and the concat/scatter
                    assembly) alone, times the registry's
                    ``halo_exchanges_per_iter``;
  * ``t_reduce``  — the reduction phase: one global ``DistributedOp.dot``
                    (one ``all_gather`` of the partials, summed in rank
                    order) alone, times ``allreduces_per_iter``;
  * ``t_compute`` — the remainder ``t_iter - t_halo - t_reduce`` (interior
                    compute; it can dip negative on a noisy host, and is
                    reported raw so the three phases sum to ``t_iter``
                    exactly).

Each phase runs ``inner`` trips in one call, each trip's output the next
trip's input, timed as the minimum over ``repeats`` calls after one warm-up
call.  Every rank times on its own host clock, with a barrier on the mesh's
group and a drained card before each call and the card drained after it;
the row takes each phase's slowest rank (one gather through the mesh's
comm), as a call over the devices of one host ends when its last device
does.  Every rank of the mesh must call :func:`measure_phase_split`, and
every rank gets the same row.  ``profile_dir`` writes each rank's
``torch.profiler`` Chrome trace of the timed calls beside the numbers.

The predicted column stays empty: the reference prices each phase with its
scaling model (``benchmarks/scaling_model.py``), whose constants are a TPU
v5e's.  The port imports nothing of it and copies none of its constants;
a cost model fitted to the H100's own measurements (ROADMAP queue 1, item
12b) fills ``predicted`` and ``drift``.  Until then every predicted time
and every drift ratio is ``None``, and the table prints ``-`` for each.

CLI: ``python -m repro_torch.obs attribute --methods cg cg_merged`` (one
rank, or the ranks ``torchrun`` starts; the row also goes to the active
trace as an ``obs.attribution`` metric record, written by rank 0) or
``python -m repro_torch.obs attribute TRACE.jsonl`` (re-render a table from
a trace that carries such records).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from repro_torch.obs import trace as _trace

#: the reference's prediction keys (``scaling_model.iteration_breakdown``)
PREDICTED_KEYS = ("t_mem", "t_halo", "t_precond", "t_reduce", "t_rr", "total")


def _drain(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_min(fn, args, *, repeats: int, mesh, device: torch.device) -> float:
    """Min-over-repeats wall time of ``fn(*args)`` on this rank, after one
    warm-up call; each call starts behind a barrier on the mesh's group
    with the card drained, and ends with the card drained."""
    fn(*args)                                  # warm-up
    _drain(device)
    ts = []
    for _ in range(repeats):
        mesh.comm.barrier()
        _drain(device)
        t0 = time.perf_counter()
        fn(*args)
        _drain(device)
        ts.append(time.perf_counter() - t0)
    return min(ts)


def _phase_fns(problem, method: str, mesh, *, halo_mode: str, inner: int):
    """(step_chain, halo_chain, reduce_chain, layout, state0) — each chain
    runs ``inner`` trips of one phase on this rank's block."""
    from repro_torch.core.distributed import (DistributedOp, init_step_state,
                                              make_layout, solve_step_shardmap)
    from repro_torch.core.solvers import LocalOp

    layout = make_layout(mesh, None)
    stencil = problem.stencil
    step_fn, _ = solve_step_shardmap(problem, method, mesh, halo_mode=halo_mode)
    op = DistributedOp(stencil, layout, halo_mode=halo_mode)

    def step_chain(b, *state):
        for _ in range(inner):
            state = step_fn(b, *state)
        return state

    def halo_chain(x):
        x = layout.block(x, problem.shape)
        for _ in range(inner):
            x = op.pad_exchange(x)[1:-1, 1:-1, 1:-1]
        return x

    def reduce_chain(x):
        x = layout.block(x, problem.shape)
        acc = torch.zeros((), dtype=x.dtype, device=x.device)
        for _ in range(inner):
            acc = acc + op.dot(x, x)
        return acc

    state0 = init_step_state(method, LocalOp(stencil), problem.b(), problem.x0())
    return step_chain, halo_chain, reduce_chain, layout, state0


@contextlib.contextmanager
def _profile(profile_dir: str | None, device: torch.device, name: str):
    """A ``torch.profiler`` window whose Chrome trace is written to
    ``profile_dir/name`` when it closes (no window without a directory)."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, name))


def measure_phase_split(problem, method: str, mesh, *,
                        halo_mode: str = "concat", inner: int = 8,
                        repeats: int = 5, profile_dir: str | None = None
                        ) -> dict:
    """One attribution row: measured t_iter/t_halo/t_reduce/t_compute, the
    slowest rank's, beside the (empty) prediction.  Every rank of ``mesh``
    calls it and gets the same row; rank 0 emits it as an
    ``obs.attribution`` metric record to the active trace (if any)."""
    from repro_torch.api.registry import get_solver
    from repro_torch.core.methods import get_method

    spec = get_solver(method)
    device = problem.device
    with _trace.span("attribute.measure", method=method, halo_mode=halo_mode):
        step_chain, halo_chain, reduce_chain, layout, state0 = _phase_fns(
            problem, method, mesh, halo_mode=halo_mode, inner=inner)
        # this rank's blocks once, so no timed call slices a global array
        nvec = 1 + len(get_method(method).vectors)
        state0 = (*(layout.block(v, problem.shape) for v in state0[:nvec]),
                  *state0[nvec:])
        x = layout.block(problem.b(), problem.shape)
        name = f"attribute.{method}.{halo_mode}.rank{mesh.rank}.json"
        with _profile(profile_dir, device, name):
            t_iter = _time_min(step_chain, state0, repeats=repeats, mesh=mesh,
                               device=device)
            t_halo1 = _time_min(halo_chain, (x,), repeats=repeats, mesh=mesh,
                                device=device)
            t_red1 = _time_min(reduce_chain, (x,), repeats=repeats, mesh=mesh,
                               device=device)
        mine = torch.tensor([t_iter, t_halo1, t_red1], dtype=torch.float64, device=device)
        t_iter, t_halo1, t_red1 = (
            v / inner for v in mesh.comm.all_gather(mine).amax(0).tolist())
    n_halo = spec.halo_exchanges_per_iter
    n_red = spec.allreduces_per_iter
    t_halo = n_halo * t_halo1
    t_red = n_red * t_red1
    row = {
        "method": method,
        "halo_mode": halo_mode,
        "grid": list(problem.shape),
        "mesh": {"axes": list(mesh.axis_names),
                 "shape": list(mesh.shape.values()),
                 "devices": int(mesh.size)},
        "counts": {"halo_exchanges": n_halo, "allreduces": n_red},
        "measured": {
            "t_iter": t_iter,
            "t_halo": t_halo,
            "t_reduce": t_red,
            # raw remainder: the three phases sum to t_iter EXACTLY
            "t_compute": t_iter - t_halo - t_red,
        },
        "predicted": dict.fromkeys(PREDICTED_KEYS),
        "drift": {"total": None, "halo": None, "reduce": None},
    }
    if mesh.rank == 0:
        _trace.emit(_trace.make_metric("obs.attribution", **row))
    return row


def attribution_report(methods, grid, mesh, *, halo_mode: str = "concat",
                       inner: int = 8, repeats: int = 5,
                       profile_dir: str | None = None, device="cuda",
                       f64: bool = True) -> list[dict]:
    """Attribution rows for several methods on one mesh: the 27pt problem
    of global ``grid`` on ``device``, in f64 (``f64=False``: f32)."""
    from repro_torch.core.problems import make_problem

    dtype = torch.float64 if f64 else torch.float32
    problem = make_problem(tuple(grid), "27pt", dtype=dtype, device=device)
    return [measure_phase_split(problem, m, mesh, halo_mode=halo_mode,
                                inner=inner, repeats=repeats,
                                profile_dir=profile_dir)
            for m in methods]


def _us(v) -> str:
    return "      -" if v is None else f"{v * 1e6:10.1f}"


def format_table(rows: list[dict]) -> str:
    """The predicted-vs-measured table (times in microseconds/iteration).
    ``meas``/``pred`` column pairs per phase; ``drift`` = measured/predicted
    total."""
    head = (f"{'method':<18} {'halo':<8} "
            f"{'iter_us':>10} {'comp_us':>10} "
            f"{'halo_us':>10} {'halo_pred':>10} "
            f"{'red_us':>10} {'red_pred':>10} "
            f"{'pred_us':>10} {'drift':>8}")
    lines = [head, "-" * len(head)]
    for r in rows:
        m, p, d = r["measured"], r["predicted"], r["drift"]
        drift = f"{d['total']:8.1f}x" if d["total"] else "       -"
        lines.append(
            f"{r['method']:<18} {r['halo_mode']:<8} "
            f"{_us(m['t_iter'])} {_us(m['t_compute'])} "
            f"{_us(m['t_halo'])} {_us(p['t_halo'])} "
            f"{_us(m['t_reduce'])} {_us(p['t_reduce'])} "
            f"{_us(p['total'])} {drift}")
    return "\n".join(lines)


def rows_from_trace(records: list[dict]) -> list[dict]:
    """Recover attribution rows from a trace's ``obs.attribution`` metric
    records (the ``attribute TRACE.jsonl`` re-render path)."""
    return [r["attrs"] for r in records
            if r.get("kind") == "metric" and r.get("name") == "obs.attribution"]
