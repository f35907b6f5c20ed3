"""The collective and donation audit: the registry's communication metadata
held against what the port's steps issue (counterpart of
``repro/analysis/audit.py``).

For every registry method the audit runs ONE iteration
(``solve_step_shardmap``'s step, the loop body of the eager solve) on three
meshes of 8 ranks (1-D/2-D/3-D), under the concat and overlapped halo modes,
on the fused kernels' route where the method declares one, and with a bound
Jacobi preconditioner where it accepts one, each under the recording comm and
the op log (``analysis.oplog``), and asserts:

* ``all_gather`` count == ``SolverSpec.allreduces_per_iter`` (+ the
  preconditioner's ``extra_reductions_per_apply`` × applies);
* ``exchange`` count == halo exchanges × split dims (one ``exchange`` is the
  swap of one split dim, both directions; the reference counts two
  ``collective-permute``\\s for it), halo exchanges =
  ``halo_exchanges_per_iter`` (+ ``halo_matvecs_per_apply`` × applies);
* no other collective, and every collective waited inside the step;
* payload bytes (summed over the ranks) equal to the committed baseline
  (``AUDIT_torch.json``);
* on the unfused route each reduction's window, the bytes of work issued
  between its start and its wait, meets its registry class
  (``core.overlap.collective_hides``/``meets_hide``): ``"none"`` below
  ``V/8``, ``"vec"`` at least ``V``, ``"spmv"``/``"pipe"`` at least the
  step's own SpMV, ``V`` one local vector's bytes;
* halos: under ``overlap`` every swap of a method whose SpMVs all hide their
  halos (``halo_hides``) carries at least one boundary plane of work; under
  ``concat``/``scatter`` none carries more than one plane.

A batch of lanes (the batched solve on a mesh) makes the single step's
collectives: :func:`measure_batched_step` runs one step of a method on one
lane and on ``B`` lanes under ``core.overlap.record_step``, and
:func:`compare_batched` holds the batched step to the same count of each
collective, every gather carrying the ``B`` lanes' partials (``B``× the
payload) and every halo swap ``B`` lanes' planes (``B``× the bytes).  The
committed baseline does not hold it: it is a property of the step, checked
where it is measured.

Donation: a mesh solve with ``donate`` returns the caller's ``x0`` block with
the iterate in it, and without it does not (every method, two meshes); so
does the local solve.  Guard invariance: the whole mesh solves of cg,
cg_merged and bicgstab_merged make the same collectives with the breakdown
guards on and off.

The measurements run in 8 spawned ``gloo`` ranks on the CPU (a ``file://``
rendezvous in a temporary directory); the parent merges the ranks' records
and compares them with the registry and the baseline.  A job key is
``method|mesh|halo|route|precond``, ``route`` ``xla`` (the plain operator)
or ``kernels`` (the reference's ``pallas``).  ``python -m
repro_torch.analysis`` drives this.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
import warnings

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.analysis.oplog import collective_stats, overlap_slack
from repro_torch.analysis.violation import Violation
from repro_torch.api import REGISTRY, SolverOptions, SolverSession
from repro_torch.core import overlap
from repro_torch.core.distributed import (DistributedOp, solve_shardmap,
                                          solve_step_shardmap, step_state_layout)
from repro_torch.core.methods import GuardSpec
from repro_torch.core.problems import make_problem
from repro_torch.kernels.autotune import DEFAULT_RUN
from repro_torch.launch.mesh import Mesh
from repro_torch.precond import PointJacobi

#: audit meshes: name -> (mesh shape, axis names, # grid dims actually split)
MESHES: dict[str, tuple[tuple[int, ...], tuple[str, ...], int]] = {
    "1d": ((8,), ("cells",), 1),
    "2d": ((2, 4), ("data", "model"), 2),
    "3d": ((2, 2, 2), ("pod", "data", "model"), 3),
}
N_RANKS = 8
GRID = (8, 8, 16)            # divisible by every audit mesh layout
STENCIL = "27pt"
#: mesh shapes the donation record runs on
DONATION_MESHES = ("1d", "2d")
#: methods whose whole mesh solve runs plain and guarded
GUARD_METHODS = ("cg", "cg_merged", "bicgstab_merged")
#: the preconditioner bound for the precond-accepting methods' extra jobs
AUDIT_PRECOND_SWEEPS = 2
#: iterations of the whole solves (donation, guard invariance)
SOLVE_ITERS = 5
#: the fused kernels' route in a job key, and the reference's name for it
KERNEL_ROUTE, REFERENCE_KERNEL_ROUTE = "kernels", "pallas"
#: the hard limit of one spawned measurement, and of each collective in it (s)
SPAWN_TIMEOUT = 600
GROUP_TIMEOUT = 120
#: the record sections the baseline holds
BASELINE_SECTIONS = ("comms", "donate_mesh", "local")


def _precond_meta() -> dict[str, int]:
    """Cost metadata of the audit's Jacobi preconditioner instance."""
    p = PointJacobi(sweeps=AUDIT_PRECOND_SWEEPS)
    return {"extra_reductions_per_apply": p.extra_reductions_per_apply,
            "halo_matvecs_per_apply": p.halo_matvecs_per_apply}


def comms_jobs(registry=None) -> list[dict]:
    """The audit matrix.  Key: ``method|mesh|halo|route|precond``."""
    registry = REGISTRY if registry is None else registry
    jobs = []

    def add(method, mesh, halo, route="xla", prec="none"):
        jobs.append(dict(key=f"{method}|{mesh}|{halo}|{route}|{prec}", method=method,
                         mesh=mesh, halo=halo, kernels=(route == KERNEL_ROUTE),
                         precond=prec))

    for name in sorted(registry):
        spec = registry[name]
        add(name, "1d", "concat")
        add(name, "1d", "overlap")
        add(name, "2d", "auto")
        add(name, "3d", "auto")
        if spec.accepts_precond:
            add(name, "1d", "auto", prec="jacobi")
            add(name, "2d", "auto", prec="jacobi")
        if spec.has_fused_body:
            add(name, "1d", "auto", route=KERNEL_ROUTE)
            add(name, "2d", "auto", route=KERNEL_ROUTE)
    return jobs


def reference_key(key: str) -> str:
    """The reference's ``AUDIT.json`` key of a port job key."""
    parts = key.split("|")
    if parts[3] == KERNEL_ROUTE:
        parts[3] = REFERENCE_KERNEL_ROUTE
    return "|".join(parts)


def expected_comms(spec, mesh: str, *, precond: str = "none",
                   precond_meta: dict[str, int] | None = None,
                   split_dims: int | None = None) -> dict[str, int]:
    """Collective counts the registry metadata predicts for one step on
    the audit mesh ``mesh`` (or on a mesh with ``split_dims`` split grid
    dims)."""
    n_split = MESHES[mesh][2] if split_dims is None else split_dims
    allreduce = spec.allreduces_per_iter
    halos = spec.halo_exchanges_per_iter
    if precond != "none":
        meta = precond_meta or _precond_meta()
        allreduce += spec.precond_applies_per_iter * meta["extra_reductions_per_apply"]
        halos += spec.precond_applies_per_iter * meta["halo_matvecs_per_apply"]
    return {"all_gather": allreduce, "exchange": halos * n_split, "broadcast": 0}


# =============================================================================
# Measurement (each of N_RANKS spawned gloo ranks)
# =============================================================================

def _precond(name: str):
    return PointJacobi(sweeps=AUDIT_PRECOND_SWEEPS) if name == "jacobi" else None


def measure_job(prob, mesh, job: dict) -> dict:
    """One rank's record of one job's step: the counts and payload bytes of
    its collectives, each reduction's window, each halo swap's window and
    plane, the collectives never waited, ``V`` and (unfused) the bytes of
    one SpMV."""
    fn, layout = solve_step_shardmap(prob, job["method"], mesh, halo_mode=job["halo"],
                                     precond=_precond(job["precond"]),
                                     kernels_fused=job["kernels"], run=DEFAULT_RUN)
    vecs, scals = step_state_layout(job["method"])
    b = layout.block(prob.b(), prob.shape)
    one = torch.ones((), dtype=prob.dtype, device=prob.device)
    events = overlap.record_step(fn, b, *([b] * len(vecs)), *([one] * len(scals)),
                                 mesh=mesh)
    rep = overlap_slack(events)
    stats = collective_stats(events)
    rec = {"counts": {op: s["count"] for op, s in sorted(stats.items())},
           "bytes": sum(s["bytes"] for s in stats.values()),
           "reductions": [r["slack_bytes"] for r in rep if r["op"] == "all_gather"],
           "halos": [[r["slack_bytes"], r["plane"]] for r in overlap.halo_slack(rep)],
           "unwaited": sum(1 for r in rep if not r["waited"]),
           "vector_bytes": b.numel() * b.element_size(), "spmv_bytes": None}
    if not job["kernels"]:
        op = DistributedOp(prob.stencil, layout, halo_mode=job["halo"])
        rec["spmv_bytes"] = overlap.spmv_bytes(op, b, mesh=mesh)
    return rec


def _starts(events: list[dict]) -> dict:
    """The collectives of a logged step: counts by op, and each start's
    ``(op, bytes, plane)`` in issue order."""
    starts = [e for e in events if e.get("event") == "start"]
    counts: dict[str, int] = {}
    for e in starts:
        counts[e["op"]] = counts.get(e["op"], 0) + 1
    return {"counts": counts, "starts": [[e["op"], e["bytes"], e["plane"]] for e in starts]}


def measure_batched_step(prob, mesh, method: str, lanes: int, *, halo: str = "auto",
                         matvec_padded=None) -> dict:
    """One step of ``method``'s unfused body (the batched solve's) on
    ``mesh``, on one lane and on ``lanes`` lanes, each under
    ``core.overlap.record_step``: this rank's :func:`_starts` of each,
    keyed ``single`` and ``batched``.  The state is the right-hand side's
    block in every vector slot and ones in the scalar slots (per lane)."""
    fn, layout = solve_step_shardmap(prob, method, mesh, halo_mode=halo,
                                     matvec_padded=matvec_padded)
    vecs, scals = step_state_layout(method)
    b = layout.block(prob.b(), prob.shape)
    bb = b.expand(lanes, *b.shape).contiguous()
    like = dict(dtype=prob.dtype, device=prob.device)
    one, ones = torch.ones((), **like), torch.ones((lanes, 1, 1, 1), **like)
    single = overlap.record_step(fn, b, *([b] * len(vecs)), *([one] * len(scals)),
                                 mesh=mesh)
    batched = overlap.record_step(fn, bb, *([bb] * len(vecs)), *([ones] * len(scals)),
                                  mesh=mesh)
    return {"lanes": lanes, "single": _starts(single), "batched": _starts(batched)}


def compare_batched(key: str, rec: dict) -> list[Violation]:
    """A batched step (:func:`measure_batched_step`) against the single
    step: the same count of each collective, issued in the same order, each
    gather's and each swap's payload (and a swap's plane) ``lanes`` times
    the single step's."""
    out: list[Violation] = []
    single, batched, lanes = rec["single"], rec["batched"], rec["lanes"]
    if batched["counts"] != single["counts"]:
        out.append(Violation("batched", key, "counts", expected=single["counts"],
                             actual=batched["counts"],
                             detail="a batched step makes the single step's collectives"))
        return out
    for i, ((op, nb, plane), (bop, bnb, bplane)) in enumerate(
            zip(single["starts"], batched["starts"])):
        want = [op, lanes * nb, lanes * plane]
        if [bop, bnb, bplane] != want:
            out.append(Violation("batched", key, f"start[{i}]", expected=want,
                                 actual=[bop, bnb, bplane],
                                 detail=f"{lanes} lanes' payload in the single "
                                        f"step's collective"))
    return out


def _donation(prob, mesh) -> dict[str, dict[str, int]]:
    """Per method: does the solve on ``mesh`` (None: the local path) hand
    back the caller's ``x0`` (this rank's block) with ``donate`` on (``on``:
    1) and off (``off``: 0)?"""
    out = {}
    for name in sorted(REGISTRY):
        rec = {}
        for mode, donate in (("on", True), ("off", False)):
            sess = SolverSession(prob, method=name, mesh=mesh, options=SolverOptions(
                maxiter=SOLVE_ITERS, donate=donate,
                layout="auto" if mesh is not None else "local"))
            shape = (prob.shape if mesh is None
                     else sess.layout.local_shape(prob.shape))
            x0 = torch.zeros(shape, dtype=prob.dtype, device=prob.device)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")     # a refused donation shows as 0
                res = sess.solve(x0=x0)
            rec[mode] = int(res.x is x0)
        out[name] = rec
    return out


def measure_rank(methods: list[str] | None = None) -> dict:
    """Every job, the donation and the guard records of this rank (every
    rank of the default group runs it, in the same order)."""
    prob = make_problem(GRID, STENCIL, device="cpu")
    meshes = {name: Mesh(shape, axes) for name, (shape, axes, _) in MESHES.items()}
    keep = (lambda m: True) if methods is None else (lambda m: m in methods)

    jobs = {job["key"]: measure_job(prob, meshes[job["mesh"]], job)
            for job in comms_jobs() if keep(job["method"])}

    donate_mesh = {}
    for mesh_name in DONATION_MESHES:
        for name, rec in _donation(prob, meshes[mesh_name]).items():
            if keep(name):
                donate_mesh[f"{name}|{mesh_name}"] = rec
    local = ({name: rec for name, rec in _donation(prob, None).items() if keep(name)}
             if dist.get_rank() == 0 else {})

    guard_invariance = {}
    mesh = meshes["1d"]
    for name in GUARD_METHODS:
        if not keep(name):
            continue
        rec = {}
        for mode, gs in (("plain", None), ("guarded", GuardSpec())):
            fn, _ = solve_shardmap(prob, name, mesh, maxiter=SOLVE_ITERS, guard_spec=gs)
            with mesh.record() as rc:
                fn(prob.b(), prob.x0())
            rec[mode] = {k: v for k, v in rc.counts.items() if v}
        guard_invariance[f"{name}|1d"] = rec
    return {"jobs": jobs, "donate_mesh": donate_mesh, "local": local,
            "guard_invariance": guard_invariance}


def merge_ranks(recs: list[dict]) -> dict:
    """The measured record from every rank's: counts (every rank must
    agree: ``ranks_disagree`` where they do not), payload bytes summed over
    the ranks, and each window's least and greatest bytes over the ranks."""
    comms, windows = {}, {}
    for key, r0 in recs[0]["jobs"].items():
        per = [r["jobs"][key] for r in recs]
        comms[key] = {"counts": r0["counts"], "bytes": sum(p["bytes"] for p in per)}
        if any(p["counts"] != r0["counts"] or len(p["reductions"]) != len(r0["reductions"])
               or len(p["halos"]) != len(r0["halos"]) for p in per):
            comms[key]["ranks_disagree"] = True
            continue
        spmv = [p["spmv_bytes"] for p in per if p["spmv_bytes"] is not None]
        windows[key] = {
            "reductions": [[min(p["reductions"][i] for p in per),
                            max(p["reductions"][i] for p in per)]
                           for i in range(len(r0["reductions"]))],
            "halos": [[min(p["halos"][i][0] for p in per),
                       max(p["halos"][i][0] for p in per),
                       max(p["halos"][i][1] for p in per)]
                      for i in range(len(r0["halos"]))],
            "unwaited": max(p["unwaited"] for p in per),
            "vector_bytes": r0["vector_bytes"],
            "spmv_bytes": min(spmv) if spmv else None,
        }
    return {"comms": comms, "windows": windows, "donate_mesh": recs[0]["donate_mesh"],
            "local": recs[0]["local"], "guard_invariance": recs[0]["guard_invariance"]}


def _entry(rank: int, world: int, out_dir: str, methods) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rendezvous",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    try:
        torch.save(measure_rank(methods), os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_measurements(methods: list[str] | None = None, *,
                     timeout: float = SPAWN_TIMEOUT) -> dict:
    """:func:`measure_rank` on ``N_RANKS`` spawned gloo ranks, merged
    (:func:`merge_ranks`).  A rank's exception, or the deadline, fails the
    run and ends every rank."""
    with tempfile.TemporaryDirectory(prefix="repro_torch_audit_") as out_dir:
        ctx = mp.start_processes(_entry, args=(N_RANKS, out_dir, methods),
                                 nprocs=N_RANKS, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the audit's {N_RANKS} ranks ran past {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        recs = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(N_RANKS)]
    return merge_ranks(recs)


# =============================================================================
# Comparison: measured vs registry expectations vs committed baseline
# =============================================================================

def _window_violations(key: str, spec, win: dict) -> list[Violation]:
    """A job's reduction windows against the registry's classes (unfused
    route), and its halo swaps against one boundary plane."""
    _method, _mesh, halo, route, _prec = key.split("|")
    out = []
    if win["unwaited"]:
        out.append(Violation("windows", key, "unwaited", expected=0, actual=win["unwaited"],
                             detail="a collective started in a step must be waited "
                                    "in it"))
    V, spmv = win["vector_bytes"], win["spmv_bytes"]
    if route != KERNEL_ROUTE:
        hides = overlap.collective_hides(spec.reduction_hides, len(win["reductions"]))
        for i, (hide, (lo, hi)) in enumerate(zip(hides, win["reductions"])):
            slack = hi if hide == "none" else lo
            if not overlap.meets_hide(hide, slack, vector_bytes=V, spmv=spmv):
                out.append(Violation(
                    "windows", key, f"reduction[{i}]", expected=hide, actual=slack,
                    detail=f"bytes of work between its start and wait (V={V}, "
                           f"SpMV={spmv})"))
    for i, (lo, hi, plane) in enumerate(win["halos"]):
        if halo != "overlap" and hi > plane:
            out.append(Violation("windows", key, f"halo[{i}]", expected=f"<= {plane}",
                                 actual=hi, detail="a blocking swap carries work"))
        elif (halo == "overlap" and route != KERNEL_ROUTE
              and all(h == "interior" for h in spec.halo_hides) and lo < plane):
            out.append(Violation("windows", key, f"halo[{i}]", expected=f">= {plane}",
                                 actual=lo, detail="an overlapped swap carries no "
                                                   "interior work"))
    return out


def compare(measured: dict, registry=None, baseline: dict | None = None, *,
            split_dims: dict[str, int] | None = None) -> list[Violation]:
    """Every contract breach between measurement, registry and baseline.
    ``split_dims`` maps a job key's mesh name to its split grid dims where
    it is not one of :data:`MESHES` (``chip_smoke.py``'s meshes)."""
    registry = REGISTRY if registry is None else registry
    meta = _precond_meta()
    out: list[Violation] = []

    # --- comms vs registry ---------------------------------------------------
    for key, rec in sorted(measured.get("comms", {}).items()):
        method, mesh, _halo, _route, prec = key.split("|")
        spec = registry.get(method)
        if spec is None:
            out.append(Violation("comms", key, "method", expected="a registered method",
                                 actual="unknown"))
            continue
        if rec.get("ranks_disagree"):
            out.append(Violation("comms", key, "ranks", expected="the same collectives "
                                 "on every rank", actual="ranks disagree"))
        want = expected_comms(spec, mesh, precond=prec, precond_meta=meta,
                              split_dims=(split_dims or {}).get(mesh))
        counts = rec["counts"]
        for op, n in want.items():
            got = counts.get(op, 0)
            if got != n:
                out.append(Violation("comms", key, op, expected=n, actual=got,
                                     detail="registry metadata vs the step's collectives"))
        for op, got in counts.items():
            if op not in want and got:
                out.append(Violation("comms", key, op, expected=0, actual=got,
                                     detail="unexpected collective in the step"))
        win = measured.get("windows", {}).get(key)
        if win is not None:
            out += _window_violations(key, spec, win)

    # --- donation ------------------------------------------------------------
    donated = [(key, rec) for key, rec in sorted(measured.get("donate_mesh", {}).items())]
    donated += [(f"{name}|local", rec)
                for name, rec in sorted(measured.get("local", {}).items())]
    for key, rec in donated:
        if rec.get("on") != 1:
            out.append(Violation("donation", key, "on", expected=1, actual=rec.get("on"),
                                 detail="donate=True must hand back the caller's x0"))
        if rec.get("off") != 0:
            out.append(Violation("donation", key, "off", expected=0, actual=rec.get("off"),
                                 detail="donate=False must not write the caller's x0"))

    # --- guard invariance ----------------------------------------------------
    for key, rec in sorted(measured.get("guard_invariance", {}).items()):
        if rec.get("guarded") != rec.get("plain"):
            out.append(Violation(
                "guard_invariance", key, "collectives", expected=rec.get("plain"),
                actual=rec.get("guarded"),
                detail="arming the breakdown guards must add no collective"))

    if baseline is not None:
        out += compare_baseline(measured, baseline)
    return out


def compare_baseline(measured: dict, baseline: dict) -> list[Violation]:
    """Exact equality against the baseline (counts AND bytes)."""
    out: list[Violation] = []
    base = baseline.get("measured", baseline)
    for section in BASELINE_SECTIONS:
        got, want = measured.get(section, {}), base.get(section, {})
        for key in sorted(set(got) | set(want)):
            if key not in want:
                out.append(Violation("baseline", f"{section}:{key}", "coverage",
                                     expected="present in the baseline", actual="new config",
                                     detail="rewrite it: python -m repro_torch.analysis "
                                            "--write AUDIT_torch.json"))
            elif key not in got:
                out.append(Violation("baseline", f"{section}:{key}", "coverage",
                                     expected=want[key], actual="config no longer measured"))
            elif got[key] != want[key]:
                out.append(Violation("baseline", f"{section}:{key}", "drift",
                                     expected=want[key], actual=got[key],
                                     detail="the measured step drifted from the baseline"))
    return out


def baseline_doc(measured: dict) -> dict:
    """What ``--write`` commits: the setting and the baseline sections."""
    return {"grid": list(GRID), "stencil": STENCIL, "ranks": N_RANKS,
            "meshes": {k: {"ranks": list(v[0]), "axes": list(v[1])}
                       for k, v in MESHES.items()},
            "measured": {s: measured.get(s, {}) for s in BASELINE_SECTIONS}}
