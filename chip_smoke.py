#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card
    python3 chip_smoke.py --record PATH   # also write every measurement as JSON

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` and runs, in
order (any failure exits non-zero, no phase's failure is caught):

0. card and build: the card's name and power limit, torch/CUDA versions, the
   kernel build time;
1. every kernel against its plain PyTorch version on the card at 128³ (the
   paper's per-rank block) for 7pt/27pt in f64/f32, with the tolerances of
   the CPU tests, bitwise-reproducible partials, and CUDA-event times
   (median of 25 launches, L2 flushed before each) beside the plain version's,
   a PyTorch library call's where one computes the same function, and the
   bound (bytes over the card's memory rate, operations over its rate);
2. the main path: merged CG with ``kernels=True`` at 128³, 27pt and 7pt, f64,
   then cg, cg_nb, bicgstab, bicgstab_b1 (27pt) and jacobi, gauss_seidel,
   gauss_seidel_rb (7pt), each converged, with the iteration count of the
   same solve with ``kernels=False`` and the launch counts each solve must
   make; then, outside the counted window, the device time of one warm
   merged-CG solve by kernel (``torch.profiler``) against its wall time;
3. the paper's per-socket hybrid block, 128x128x3072 (27pt, f64), merged CG
   on the kernels: iterations, time per iteration, achieved GB/s;
4. one JSON line listing every kernel, then the contract line
   ``{"ok": true, "device": {...}}`` last.

With ``--record PATH`` the detailed record (every kernel row, each main-path
solve, the profile and the socket block) is written to ``PATH`` as JSON.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.api import SolverOptions, SolverSession  # noqa: E402
from repro_torch.core.operators import STENCILS, pad1  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402

RANK_BLOCK = (128, 128, 128)
SOCKET_BLOCK = (128, 128, 3072)

#: name fragment -> (memory bytes/s, f64 op/s, f32 op/s) without tensor cores,
#: NVIDIA's data sheets; the first fragment found in the card's name wins
CARD_PEAKS = (
    ("H100 PCIe", (2.0e12, 25.6e12, 51.2e12)),
    ("H100 NVL", (3.9e12, 30e12, 60e12)),
    ("H100", (3.35e12, 34e12, 67e12)),          # SXM5, 80 GB HBM3
    ("H200", (4.8e12, 34e12, 67e12)),
)

KERNELS = {
    "stencil_spmv": dict(source="src/repro_torch/kernels/csrc/stencil_spmv.cu",
                         replaces="src/repro/kernels/stencil_spmv.py:100"),
    "stencil_spmv_dots": dict(source="src/repro_torch/kernels/csrc/spmv_dot.cu",
                              replaces="src/repro/kernels/spmv_dot.py:58"),
    "fused_cg_body": dict(source="src/repro_torch/kernels/csrc/cg_fused_update.cu",
                          replaces="src/repro/kernels/cg_fused_update.py:109"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_peaks(name: str):
    for frag, peaks in CARD_PEAKS:
        if frag in name:
            return peaks
    raise SmokeFailure(f"no peak rates known for card {name!r}")


def tols(dt):
    """(output rtol=atol, partial rtol): the CPU tests' tolerances."""
    return (1e-12, 1e-11) if dt == torch.float64 else (1e-5, 1e-4)


class Timer:
    """CUDA-event time of one call, median of ``n``, with the 50 MB L2 cache
    flushed (a 512 MiB buffer zeroed) before each launch, as the solver's
    loop finds it: every iteration streams more than L2 holds."""

    def __init__(self, n: int = 25):
        self.n = n
        self.flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn) -> float:
        fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(self.n):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)


def max_err(pairs) -> float:
    return max(float((a.double() - b.double()).abs().max()) for a, b in pairs)


def conv_weights(st, dt):
    w = torch.zeros((1, 1, 3, 3, 3), dtype=dt, device="cuda")
    w[0, 0, 1, 1, 1] = st.diag
    for dx, dy, dz in st.offsets:
        w[0, 0, 1 + dx, 1 + dy, 1 + dz] = st.off_coeff
    return w


def phase_kernels(timer: Timer, peaks) -> dict:
    """Phase 1: each kernel against its plain version at 128³."""
    bw = peaks[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for dt in (torch.float64, torch.float32):
        peak_ops = peaks[1] if dt == torch.float64 else peaks[2]
        es = torch.finfo(dt).bits // 8
        out_tol, part_rtol = tols(dt)
        for sname in ("27pt", "7pt"):
            st = STENCILS[sname]
            x = torch.randn(RANK_BLOCK, generator=gen, dtype=dt, device="cuda")
            xp = pad1(x)
            n, npad = x.numel(), xp.numel()

            def close(a, b, what):
                check(torch.allclose(a, b, rtol=out_tol, atol=out_tol),
                      f"{what} {sname} {dt}: max err {max_err([(a, b)])}")

            def close_part(a, b, what):
                check(abs(float(a) - float(b)) <= part_rtol * abs(float(b)),
                      f"{what} partial {sname} {dt}: {float(a)} vs {float(b)}")

            # kernel 1: the SpMV and its fuse_dot form
            y = ops.spmv(xp, st)
            yr = ref.stencil_spmv_ref(xp, stencil=st)
            y1, d1 = ops.spmv_dot(xp, st)
            _, dr = ref.stencil_spmv_dot_ref(xp, stencil=st)
            _, d1b = ops.spmv_dot(xp, st)
            torch.cuda.synchronize()
            close(y, yr, "stencil_spmv")
            close(y1, yr, "stencil_spmv(fuse_dot)")
            close_part(d1, dr, "stencil_spmv(fuse_dot)")
            check(torch.equal(d1, d1b), "stencil_spmv: partial not reproducible")
            w = conv_weights(st, dt)
            check(torch.allclose(F.conv3d(xp[None, None], w)[0, 0], yr,
                                 rtol=1e-4, atol=1e-4),
                  "conv3d library call disagrees with the stencil")
            ops_k1 = n * (2 * st.npoint - 1)
            rows[("stencil_spmv", sname, str(dt))] = dict(
                max_abs_err=max_err([(y, yr), (y1, yr), (d1, dr)]),
                ms=timer.ms(lambda: ops.spmv(xp, st)),
                plain_ms=timer.ms(lambda: ref.stencil_spmv_ref(xp, stencil=st)),
                library_ms=timer.ms(lambda: F.conv3d(xp[None, None], w)),
                bytes=(npad + n) * es, ops=ops_k1, peak_ops=peak_ops)

            # kernel 2: the SpMV with both merged-CG partials
            wv, de, ga = ops.spmv_dots(xp, st)
            _, der, gar = ref.stencil_spmv_dots_ref(xp, stencil=st)
            _, de2, ga2 = ops.spmv_dots(xp, st)
            torch.cuda.synchronize()
            close(wv, yr, "stencil_spmv_dots")
            close_part(de, der, "stencil_spmv_dots delta")
            close_part(ga, gar, "stencil_spmv_dots gamma")
            check(torch.equal(de, de2) and torch.equal(ga, ga2),
                  "stencil_spmv_dots: partials not reproducible")
            rows[("stencil_spmv_dots", sname, str(dt))] = dict(
                max_abs_err=max_err([(wv, yr), (de, der), (ga, gar)]),
                ms=timer.ms(lambda: ops.spmv_dots(xp, st)),
                plain_ms=timer.ms(lambda: ref.stencil_spmv_dots_ref(xp, stencil=st)),
                library_ms=None,
                bytes=(npad + n) * es + 2 * es, ops=ops_k1 + 4 * n,
                peak_ops=peak_ops)

        # the zero-halo pad every stencil kernel's operand goes through
        rows[("pad_exchange", "-", str(dt))] = dict(
            max_abs_err=0.0, ms=timer.ms(lambda: pad1(x)), plain_ms=None,
            library_ms=None, bytes=(npad + n) * es, ops=0, peak_ops=peak_ops)

        # kernel 3: the four vector updates (no stencil)
        vecs = [torch.randn(RANK_BLOCK, generator=gen, dtype=dt, device="cuda")
                for _ in range(5)]
        a = torch.tensor(0.37, dtype=dt, device="cuda")
        b = torch.tensor(-0.21, dtype=dt, device="cuda")
        out = ops.cg_body(a, b, *vecs)
        outr = ref.fused_cg_body_ref(a, b, *vecs)
        torch.cuda.synchronize()
        for o, orf in zip(out, outr):
            check(torch.allclose(o, orf, rtol=out_tol, atol=out_tol),
                  f"fused_cg_body {dt}: max err {max_err([(o, orf)])}")
        n = vecs[0].numel()
        rows[("fused_cg_body", "-", str(dt))] = dict(
            max_abs_err=max_err(zip(out, outr)),
            ms=timer.ms(lambda: ops.cg_body(a, b, *vecs)),
            plain_ms=timer.ms(lambda: ref.fused_cg_body_ref(a, b, *vecs)),
            library_ms=None, bytes=9 * n * es + 2 * es, ops=8 * n,
            peak_ops=peak_ops)
    for row in rows.values():
        t_bytes = row["bytes"] / bw * 1e3
        t_ops = row.pop("ops") / row.pop("peak_ops") * 1e3
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    for (name, sname, dt), row in rows.items():
        def fmt(v):
            return "-" if v is None else f"{v:.4f}"
        print(f"[kernels] {name:18s} {sname:4s} {dt:13s} ms={row['ms']:.4f} "
              f"plain_ms={fmt(row['plain_ms'])} library_ms={fmt(row['library_ms'])} "
              f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
              f"max_abs_err={row['max_abs_err']:.3e}")
    return rows


#: launches each kernel-path solve must make, from its iteration count
def expected_launches(method: str, iters: int) -> dict:
    spmv = {"cg": 1 + iters, "cg_nb": 2 + iters, "bicgstab": 1 + 2 * iters,
            "bicgstab_b1": 1 + 2 * iters, "jacobi": 1 + iters,
            "gauss_seidel": 1 + iters, "gauss_seidel_rb": 1 + iters,
            "cg_merged": 1}[method]
    fused = method == "cg_merged"
    return {"stencil_spmv": spmv,
            "stencil_spmv_dots": iters + 1 if fused else 0,
            "fused_cg_body": iters if fused else 0}


def run_solve(method, stencil, grid, kernels):
    sess = SolverSession(method=method, grid=grid, stencil=stencil,
                         options=SolverOptions(kernels=kernels))
    before = dict(ops.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sess.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}
    return sess, res, wall, launches


def phase_main_path() -> list[dict]:
    """Phase 2: the main path through the kernels, each solve checked."""
    cases = ([("cg_merged", "27pt"), ("cg_merged", "7pt")]
             + [(m, "27pt") for m in ("cg", "cg_nb", "bicgstab", "bicgstab_b1")]
             + [(m, "7pt") for m in ("jacobi", "gauss_seidel", "gauss_seidel_rb")])
    out = []
    for method, stencil in cases:
        sess, res, wall, launches = run_solve(method, stencil, RANK_BLOCK, True)
        _, plain, plain_wall, plain_launches = run_solve(method, stencil,
                                                         RANK_BLOCK, False)
        err = float((res.x - sess.problem.x_true()).abs().max())
        dx = float((res.x - plain.x).abs().max())
        rec = dict(method=method, stencil=stencil, iters=res.iters,
                   plain_iters=plain.iters, status=res.status, err=err,
                   x_vs_plain=dx, wall_s=wall, plain_wall_s=plain_wall,
                   launches=launches)
        print(f"[main] {method:15s} {stencil:4s} iters={res.iters} "
              f"(plain {plain.iters}) status={res.status} max|x-1|={err:.3e} "
              f"max|x-x_plain|={dx:.3e} wall={wall:.4f}s "
              f"(plain {plain_wall:.4f}s) launches={launches}")
        check(res.status == 0, f"{method}/{stencil}: status {res.status}")
        check(res.iters == plain.iters,
              f"{method}/{stencil}: {res.iters} iterations on the kernels, "
              f"{plain.iters} without")
        check(err < 1e-6, f"{method}/{stencil}: max|x-1| = {err}")
        check(launches == expected_launches(method, res.iters),
              f"{method}/{stencil}: launches {launches}, expected "
              f"{expected_launches(method, res.iters)}")
        check(not any(plain_launches.values()),
              f"{method}/{stencil}: kernels=False launched {plain_launches}")
        out.append(rec)
    return out


def profile_main_path(warm_ms_per_iter: float) -> dict:
    """Where the time of one warm merged-CG solve (128³, 27pt, f64, kernels)
    goes on the card: device time by kernel from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    sess = SolverSession(method="cg_merged", grid=RANK_BLOCK, stencil="27pt",
                         options=SolverOptions(kernels=True))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = sess.solve()
        torch.cuda.synchronize()
    groups = {"fused_cg_body": "fused_cg_body_kernel",
              "stencil_spmv_dots": "stencil_kernel<double, 27, 2>",
              "stencil_spmv": "stencil_kernel<double, 27, 0>",
              "reduce_partials": "reduce_partials", "DtoH": "Memcpy DtoH"}
    us = {g: 0.0 for g in groups}
    us["other"] = 0.0
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        t = float(getattr(e, "self_device_time_total", 0.0))
        g = next((g for g, frag in groups.items() if frag in e.key), "other")
        us[g] += t
    total = sum(us.values())
    per_iter = {g: v / res.iters / 1e3 for g, v in us.items()}
    rec = dict(iters=res.iters, device_ms_per_iter=per_iter,
               device_ms_total_per_iter=total / res.iters / 1e3,
               warm_wall_ms_per_iter=warm_ms_per_iter,
               device_busy_share=(total / res.iters / 1e3) / warm_ms_per_iter
               if total else None)
    print(f"[profile] cg_merged 27pt 128^3: warm wall {warm_ms_per_iter:.4f} ms/iter "
          f"(median of 5 solves); "
          f"device ms/iter " + " ".join(f"{g}={v:.4f}" for g, v in per_iter.items())
          + f"; busy share {rec['device_busy_share']}")
    return rec


def phase_socket_block() -> dict:
    """Phase 3: merged CG on the kernels at the per-socket hybrid block."""
    run_solve("cg_merged", "27pt", SOCKET_BLOCK, True)        # warm allocator
    sess, res, wall, launches = run_solve("cg_merged", "27pt", SOCKET_BLOCK, True)
    n = sess.problem.rows
    es = 8
    # one iteration: fused body 5 reads + 4 writes; the zero-halo pad of r
    # (read r, write padded r); the stencil pass (read padded r, write w)
    npad = (SOCKET_BLOCK[0] + 2) * (SOCKET_BLOCK[1] + 2) * (SOCKET_BLOCK[2] + 2)
    bytes_iter = (9 * n + 2 * (n + npad)) * es
    err = float((res.x - sess.problem.x_true()).abs().max())
    rec = dict(grid=list(SOCKET_BLOCK), iters=res.iters, status=res.status,
               wall_s=wall, ms_per_iter=wall / max(res.iters, 1) * 1e3,
               bytes_per_iter=bytes_iter,
               gb_per_s=bytes_iter * res.iters / wall / 1e9, err=err,
               launches=launches)
    print(f"[socket] cg_merged 27pt {SOCKET_BLOCK} iters={res.iters} "
          f"status={res.status} wall={wall:.4f}s ms/iter={rec['ms_per_iter']:.4f} "
          f"GB/s={rec['gb_per_s']:.1f} (bytes/iter={bytes_iter}) "
          f"max|x-1|={err:.3e} launches={launches}")
    check(res.status == 0, f"socket block: status {res.status}")
    check(err < 1e-6, f"socket block: max|x-1| = {err}")
    check(launches == expected_launches("cg_merged", res.iters),
          f"socket block: launches {launches}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", default=None, metavar="PATH",
                    help="write the detailed record as JSON to PATH")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {kind}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    peaks = card_peaks(kind)

    t0 = time.perf_counter()
    build = _build.build_all()
    print(f"[build] {len(_build.sources())} sources into {build.relative_to(ROOT)} "
          f"in {time.perf_counter() - t0:.2f}s")

    timer = Timer()
    rows = phase_kernels(timer, peaks)
    # one untimed solve warms the caching allocator; the median of five
    # warm solves gives the wall time per iteration the profile is read against
    run_solve("cg_merged", "27pt", RANK_BLOCK, True)
    warm = [run_solve("cg_merged", "27pt", RANK_BLOCK, True) for _ in range(5)]
    warm_ms_per_iter = statistics.median(w / r.iters * 1e3 for _, r, w, _ in warm)
    ops.reset_launches()                         # the main path starts here
    main_runs = phase_main_path()
    launches = dict(ops.LAUNCHES)                # ...and ends here
    profile = profile_main_path(warm_ms_per_iter)
    socket = phase_socket_block()

    kernels = []
    for name, meta in KERNELS.items():
        key = (name, "-" if name == "fused_cg_body" else "27pt", str(torch.float64))
        row = rows[key]
        check(launches[name] > 0, f"{name} was not launched on the main path")
        kernels.append(dict(name=name, route="cuda", **meta,
                            launches=launches[name],
                            max_abs_err=row["max_abs_err"], ms=row["ms"],
                            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                            bound_by=row["bound_by"],
                            library_ms=row["library_ms"]))

    record = dict(card=smi, kind=kind, torch=torch.__version__,
                  cuda=torch.version.cuda, peaks=peaks,
                  kernels=[dict(name=k[0], stencil=k[1], dtype=k[2], **v)
                           for k, v in rows.items()],
                  main_path=main_runs, main_path_launches=launches,
                  profile=profile, socket_block=socket)
    if args.record:
        path = Path(args.record)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
