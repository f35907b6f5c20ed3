#!/usr/bin/env python3
"""Time the port's stencil kernels from two trees of the repository, turn about.

    python3 chip_kernel_ab.py --other DIR [--rounds 4] [--record PATH] [--solves]

``DIR`` is another checkout of this repository (for example the parent commit
unpacked by ``git archive`` into a gitignored directory).  Each round runs
one child process on this tree and one on ``DIR`` (A B, then B A, ...): the
child imports that tree's ``repro_torch``, builds that tree's kernels into
its own ``build/``, and times the wrappers of ``kernels.ops`` listed in
``CASES`` at 128³ (27pt and 7pt) in float64, float32 and bfloat16, each
output held to that tree's plain version (bitwise in float64 and bfloat16,
within 1e-5 in float32).  The inputs are drawn on the card from one seed, so
both trees see the same operands; each output's bytes are hashed, and a
case whose hashes differ between the trees is reported (a change that keeps
a dtype's code must keep its bits).  Times are CUDA events, the median of
``--n`` launches, L2 flushed before each by reading a 512 MiB buffer (as
``chip_smoke.py``'s ``Timer``); a case's time is the median of its rounds.
With ``--solves`` each child also times the solves of ``SOLVES`` at 128³
27pt in float64 and float32, graphed (``SolverSession.solve``) and eager (its
eager loop, one read an iteration), warm, the median of three solves: ms an
iteration, the iterate's hash and the iterations.  Needs one CUDA card and
``nvcc``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPE = (128, 128, 128)
DTYPES = ("float64", "float32", "bfloat16")
#: the wrappers timed, each on the padded operand (the stencil rows on the
#: old pass in float64 and float32, and the SpMV's ring pass beside them;
#: ``gs_half_sweep`` in both colours, the ring in float64 27pt)
CASES = ("spmv", "cheb_step", "jacobi_sweep", "bicgstab_spmv_dots", "bicgstab_spmv_update",
         "gs_half_sweep")
#: the solves ``--solves`` times: (method, preconditioner), each in float64
#: and float32, graphed and eager
SOLVES = (("pcg", "chebyshev"), ("pcg", "block_jacobi"))


def solve_times(root: Path) -> dict:
    """The solves of ``SOLVES`` with the tree at ``root``, in float64 and
    float32, graphed and eager: {label: [ms an iteration, iterate hash,
    iterations]}."""
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.api import SolverOptions, SolverSession

    out = {}
    for f64 in (True, False):
        for method, precond in SOLVES:
            sess = SolverSession(method=method, grid=SHAPE, stencil="27pt",
                                 options=SolverOptions(kernels=True, precond=precond,
                                                       f64=f64))
            for route, solve in (("graphed", sess.solve), ("eager", sess._solve_eager)):
                res = solve()
                walls = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = solve()
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                digest = hashlib.sha256(
                    res.x.contiguous().view(torch.uint8).cpu().numpy().tobytes())
                dtype = "float64" if f64 else "float32"
                out[f"solve {method}+{precond} 27pt {dtype} {route}"] = [
                    statistics.median(walls) / res.iters * 1e3, digest.hexdigest()[:16],
                    res.iters]
            del sess
    return out


def child(root: Path, n: int) -> dict:
    """Time ``CASES`` with the tree at ``root``: {label: [ms, output hash]}."""
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.core.operators import STENCILS, pad1
    from repro_torch.kernels import ops, ref

    flush = torch.ones(128 << 20, dtype=torch.float32, device="cuda")

    def ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(n):
            flush.sum()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            events.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in events)

    out = {}
    for dname in DTYPES:
        dt = getattr(torch, dname)
        gen = torch.Generator(device="cuda").manual_seed(5)
        x, r, d, *vecs = (torch.randn(SHAPE, generator=gen, device="cuda").to(dt)
                          for _ in range(9))
        xp = pad1(x)
        al, om, be = (torch.tensor(c, dtype=dt, device="cuda") for c in (0.37, 1.3, -0.41))
        for sname in ("27pt", "7pt"):
            st = STENCILS[sname]
            calls = {
                "spmv": (lambda: ops.spmv(xp, st), lambda: ref.stencil_spmv_ref(xp, stencil=st)),
                "cheb_step": (lambda: ops.cheb_step(xp, r, d, st, a=0.37, c=0.11),
                              lambda: ref.cheb_fused_step_ref(xp, r, d, stencil=st, a=0.37,
                                                              c=0.11)),
                "jacobi_sweep": (lambda: ops.jacobi_sweep(xp, r, st, omega=1.0),
                                 lambda: ref.block_jacobi_sweep_ref(xp, r, stencil=st,
                                                                    omega=1.0)),
                "bicgstab_spmv_dots": (
                    lambda: ops.bicgstab_spmv_dots(xp, *vecs[:6], al, st)[:3],
                    lambda: ref.bicgstab_spmv_dots_ref(xp, *vecs[:6], al, stencil=st)[:3]),
                "bicgstab_spmv_update": (
                    lambda: ops.bicgstab_spmv_update(xp, *vecs[:6], om, be, st),
                    lambda: ref.bicgstab_spmv_update_ref(xp, *vecs[:6], om, be, stencil=st)),
                "gs_half_sweep": (
                    lambda: tuple(ops.gs_half_sweep(xp, r, st, c) for c in (0, 1)),
                    lambda: tuple(ref.rb_gs_half_sweep_ref(xp, r, stencil=st, colour=c)
                                  for c in (0, 1))),
            }
            for case in CASES:
                call, plain = calls[case]
                got, want = call(), plain()
                got, want = ((g,) if isinstance(g, torch.Tensor) else tuple(g)
                             for g in (got, want))
                for g, w in zip(got, want):
                    same = (torch.allclose(g, w, rtol=1e-5, atol=1e-5) if dt == torch.float32
                            else torch.equal(g, w))
                    if not same:
                        raise SystemExit(f"{root} {case} {sname} {dname}: not equal to the "
                                         f"plain version")
                digest = hashlib.sha256()
                for g in got:
                    digest.update(g.contiguous().view(torch.uint8).cpu().numpy().tobytes())
                out[f"{case} {sname} {dname}"] = [ms(call), digest.hexdigest()[:16]]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="the other tree's root")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--n", type=int, default=25, help="launches a time is the median of")
    ap.add_argument("--record", default=None, metavar="PATH")
    ap.add_argument("--solves", action="store_true",
                    help="also time the f64 and f32 solves of SOLVES, graphed and eager")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        out = child(args.child.resolve(), args.n)
        if args.solves:
            out.update(solve_times(args.child.resolve()))
        args.out.write_text(json.dumps(out))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_kernel_ab: needs an NVIDIA card", file=sys.stderr)
        return 1
    if args.other is None or not (args.other / "src" / "repro_torch").is_dir():
        print("chip_kernel_ab: --other must be a checkout of this repository", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    print(card)
    trees = {"this": ROOT, "other": args.other.resolve()}
    runs = {name: [] for name in trees}
    with tempfile.TemporaryDirectory() as tmp:
        for rnd in range(args.rounds):
            for name in (("this", "other") if rnd % 2 == 0 else ("other", "this")):
                out = Path(tmp) / f"{name}{rnd}.json"
                subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child",
                                str(trees[name]), "--out", str(out), "--n", str(args.n),
                                *(["--solves"] if args.solves else [])],
                               check=True, cwd=trees[name], timeout=1200)
                runs[name].append(json.loads(out.read_text()))
    record = dict(card=card, trees={k: str(v) for k, v in trees.items()}, cases={})
    for label in runs["this"][0]:
        row = {}
        for name in trees:
            row[f"{name}_ms"] = statistics.median(r[label][0] for r in runs[name])
            row[f"{name}_rounds"] = [r[label][0] for r in runs[name]]
            row[f"{name}_hash"] = sorted({r[label][1] for r in runs[name]})
        row["same_bits"] = row["this_hash"] == row["other_hash"]
        if label.startswith("solve "):
            row["iters"] = {name: sorted({r[label][2] for r in runs[name]}) for name in trees}
        record["cases"][label] = row
        print(f"[ab] {label:36s} this {row['this_ms']:.4f} ms  other {row['other_ms']:.4f} ms  "
              f"diff {row['this_ms'] - row['other_ms']:+.4f}  "
              f"{'same bits' if row['same_bits'] else 'BITS DIFFER'}")
    if args.record:
        Path(args.record).parent.mkdir(parents=True, exist_ok=True)
        Path(args.record).write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
