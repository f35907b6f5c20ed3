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
2. four paths through the kernels, each in its own counted window (launch
   counts set to 0 just before it, read just after):
   a. the unpreconditioned path: merged CG with ``kernels=True`` at 128³,
      27pt and 7pt, f64, then cg, cg_nb, bicgstab, bicgstab_b1 (27pt) and
      jacobi, gauss_seidel, gauss_seidel_rb (7pt);
   b. the preconditioned path: pcg with chebyshev and block_jacobi (27pt
      and 7pt), pcg_merged with chebyshev and block_jacobi (the fused
      route), pcg with jacobi and ssor, and pbicgstab with chebyshev (27pt);
   c. the pipelined path: cg_pipe (27pt and 7pt), pcg_pipe with chebyshev
      (27pt and 7pt) and with block_jacobi, jacobi and ssor (27pt), all on
      the fused route;
   d. the single-reduction BiCGStab path: bicgstab_merged (27pt and 7pt),
      pbicgstab_merged with chebyshev (27pt and 7pt) and with block_jacobi,
      jacobi and ssor (27pt), all on the fused route;
   each solve converged, with the iteration count of the same solve with
   ``kernels=False`` (for the merged BiCGStabs, whose stopping iteration
   depends on the summation order of their nine dots, within 10 % + 1 and
   with the true residual below the tolerance: ``ORDER_SENSITIVE``) and the
   launch counts it must make; then, outside the
   counted windows, the warm wall times of the profiled solves and of
   bicgstab and pbicgstab + chebyshev, all in turn, before any profiler
   session, and the device time by kernel (``torch.profiler``) of one warm
   solve each of merged CG, pcg_merged + chebyshev, cg_pipe, pcg_pipe +
   chebyshev, bicgstab_merged and pbicgstab_merged + chebyshev;
3. the paper's per-socket hybrid block, 128x128x3072 (27pt, f64), on the
   kernels: merged CG, pcg_merged + chebyshev, cg_pipe, pcg_pipe +
   chebyshev, bicgstab_merged and pbicgstab_merged + chebyshev (iterations,
   time per iteration, achieved GB/s), and bicgstab and pbicgstab +
   chebyshev (iterations, time per iteration) beside them;
4. the bytes bound at 128³ f64 of each bytes-bound TPU kernel not ported
   yet, one JSON line listing every kernel, then the contract line
   ``{"ok": true, "device": {...}}`` last.

With ``--record PATH`` the detailed record (every kernel row, each counted
solve, the warm wall times, the profiles, the socket block and the unported
kernels' bounds) is written to ``PATH`` as JSON.
"""

from __future__ import annotations

import argparse
import json
import math
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
from repro_torch.core.solvers import LocalOp  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.precond import Chebyshev  # noqa: E402

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

#: kernel -> its source, the TPU kernel it replaces, and the path of phase 2
#: whose counted window must launch it ("main", "precond", "pipe" or
#: "bicgstab")
KERNELS = {
    "stencil_spmv": dict(source="src/repro_torch/kernels/csrc/stencil_spmv.cu",
                         replaces="src/repro/kernels/stencil_spmv.py:100",
                         path="main"),
    "stencil_spmv_dots": dict(source="src/repro_torch/kernels/csrc/spmv_dot.cu",
                              replaces="src/repro/kernels/spmv_dot.py:58",
                              path="main"),
    "fused_cg_body": dict(source="src/repro_torch/kernels/csrc/cg_fused_update.cu",
                          replaces="src/repro/kernels/cg_fused_update.py:109",
                          path="main"),
    "stencil_spmv_dots3": dict(source="src/repro_torch/kernels/csrc/spmv_dot.cu",
                               replaces="src/repro/kernels/spmv_dot.py:114",
                               path="precond"),
    "fused_pcg_body": dict(source="src/repro_torch/kernels/csrc/fused_bodies.cu",
                           replaces="src/repro/kernels/fused_bodies.py:166",
                           path="precond"),
    "cheb_fused_step": dict(source="src/repro_torch/kernels/csrc/precond.cu",
                            replaces="src/repro/kernels/precond.py:52",
                            path="precond"),
    "block_jacobi_sweep": dict(source="src/repro_torch/kernels/csrc/precond.cu",
                               replaces="src/repro/kernels/precond.py:97",
                               path="precond"),
    "fused_pipe_body": dict(source="src/repro_torch/kernels/csrc/fused_bodies.cu",
                            replaces="src/repro/kernels/fused_bodies.py:115",
                            path="pipe"),
    "fused_dots": dict(source="src/repro_torch/kernels/csrc/fused_bodies.cu",
                       replaces="src/repro/kernels/fused_bodies.py:68",
                       path="pipe"),
    "fused_ppipe_body": dict(source="src/repro_torch/kernels/csrc/fused_bodies.cu",
                             replaces="src/repro/kernels/fused_bodies.py:223",
                             path="pipe"),
    "bicgstab_fused_spmv_dots": dict(
        source="src/repro_torch/kernels/csrc/bicgstab_fused.cu",
        replaces="src/repro/kernels/bicgstab_fused.py:69", path="bicgstab"),
    "bicgstab_fused_update1": dict(
        source="src/repro_torch/kernels/csrc/fused_bodies.cu",
        replaces="src/repro/kernels/fused_bodies.py:274", path="bicgstab"),
    "bicgstab_fused_spmv_update": dict(
        source="src/repro_torch/kernels/csrc/bicgstab_fused.cu",
        replaces="src/repro/kernels/bicgstab_fused.py:134", path="bicgstab"),
}
#: the kernels without a stencil; their rows are keyed by stencil "-"
BODY_KERNELS = ("fused_cg_body", "fused_pcg_body", "fused_pipe_body", "fused_dots",
                "fused_ppipe_body", "bicgstab_fused_update1")
#: the bytes-bound TPU kernels not ported yet: elements each moves at a
#: block of n points (npad padded), each input read once and each output
#: written once; their bound at the rank block goes into the record
UNPORTED_ELEMS = {
    "cg_fused_update (src/repro/kernels/cg_fused_update.py:54)": lambda n, npad: 6 * n,
    "fused_axpby (src/repro/kernels/fused_axpby.py:58)": lambda n, npad: 4 * n,
    "fused_axpby_dot (src/repro/kernels/fused_axpby.py:96)": lambda n, npad: 5 * n,
    "rb_gs_half_sweep (src/repro/kernels/rb_gs.py:52)": lambda n, npad: 2 * n + npad,
}
#: the order of the BiCGStab pass's nine partials
BICG_PARTS = ("q·y", "y·y", "q·q", "r̂·q", "r̂·y", "r̂·t", "r̂·v", "r̂·z", "r̂·s")


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

            # kernel 4: the SpMV with merged PCG's three partials (r unpadded)
            r = torch.randn(RANK_BLOCK, generator=gen, dtype=dt, device="cuda")
            y3, yx, rx, rr = ops.spmv_dots3(xp, r, st)
            _, yxr, rxr, rrr = ref.stencil_spmv_dots3_ref(xp, r, stencil=st)
            _, yx2, rx2, rr2 = ops.spmv_dots3(xp, r, st)
            torch.cuda.synchronize()
            close(y3, yr, "stencil_spmv_dots3")
            for got, want, what in ((yx, yxr, "y·x"), (rx, rxr, "r·x"), (rr, rrr, "r·r")):
                close_part(got, want, f"stencil_spmv_dots3 {what}")
            check(torch.equal(yx, yx2) and torch.equal(rx, rx2) and torch.equal(rr, rr2),
                  "stencil_spmv_dots3: partials not reproducible")
            rows[("stencil_spmv_dots3", sname, str(dt))] = dict(
                max_abs_err=max_err([(y3, yr), (yx, yxr), (rx, rxr), (rr, rrr)]),
                ms=timer.ms(lambda: ops.spmv_dots3(xp, r, st)),
                plain_ms=timer.ms(lambda: ref.stencil_spmv_dots3_ref(xp, r, stencil=st)),
                library_ms=None,
                bytes=(npad + 2 * n) * es + 3 * es, ops=ops_k1 + 6 * n,
                peak_ops=peak_ops)

            # kernel 16: one Chebyshev step, with the (a, c) of the first step
            # of the default schedule on this stencil
            d = torch.randn(RANK_BLOCK, generator=gen, dtype=dt, device="cuda")
            cheb_a, cheb_c = Chebyshev().setup(LocalOp(st))[1][0]
            zn, dn = ops.cheb_step(xp, r, d, st, a=cheb_a, c=cheb_c)
            znr, dnr = ref.cheb_fused_step_ref(xp, r, d, stencil=st, a=cheb_a, c=cheb_c)
            torch.cuda.synchronize()
            close(zn, znr, "cheb_fused_step z")
            close(dn, dnr, "cheb_fused_step d")
            rows[("cheb_fused_step", sname, str(dt))] = dict(
                max_abs_err=max_err([(zn, znr), (dn, dnr)]),
                ms=timer.ms(lambda: ops.cheb_step(xp, r, d, st, a=cheb_a, c=cheb_c)),
                plain_ms=timer.ms(lambda: ref.cheb_fused_step_ref(
                    xp, r, d, stencil=st, a=cheb_a, c=cheb_c)),
                library_ms=None,
                bytes=(npad + 4 * n) * es, ops=ops_k1 + 5 * n, peak_ops=peak_ops)

            # kernel 17: one block-Jacobi sweep (the solver's default ω = 1)
            zs = ops.jacobi_sweep(xp, r, st, omega=1.0)
            zsr = ref.block_jacobi_sweep_ref(xp, r, stencil=st, omega=1.0)
            torch.cuda.synchronize()
            close(zs, zsr, "block_jacobi_sweep")
            rows[("block_jacobi_sweep", sname, str(dt))] = dict(
                max_abs_err=max_err([(zs, zsr)]),
                ms=timer.ms(lambda: ops.jacobi_sweep(xp, r, st, omega=1.0)),
                plain_ms=timer.ms(lambda: ref.block_jacobi_sweep_ref(
                    xp, r, stencil=st, omega=1.0)),
                library_ms=None,
                bytes=(npad + 2 * n) * es, ops=ops_k1 + 4 * n, peak_ops=peak_ops)

            # kernels 13 and 14: single-reduction BiCGStab's two stencil
            # passes.  The padded operand xp is not z padded (M(z) when
            # preconditioned); the f64 vector outputs must be bitwise equal
            # to the plain version's, the partials bitwise reproducible
            bv = [torch.randn(RANK_BLOCK, generator=gen, dtype=dt, device="cuda")
                  for _ in range(6)]
            al, om, be = (torch.tensor(c, dtype=dt, device="cuda")
                          for c in (0.37, 1.3, -0.41))

            def bitwise(got, want, what):
                for g, w in zip(got, want):
                    close(g, w, what)
                    check(dt != torch.float64 or torch.equal(g, w),
                          f"{what} {sname} {dt}: not bitwise equal to the plain version")

            v1, q1, y1, parts = ops.bicgstab_spmv_dots(xp, *bv, al, st)
            _, _, _, parts2 = ops.bicgstab_spmv_dots(xp, *bv, al, st)
            v1r, q1r, y1r, partsr = ref.bicgstab_spmv_dots_ref(xp, *bv, al, stencil=st)
            torch.cuda.synchronize()
            bitwise((v1, q1, y1), (v1r, q1r, y1r), "bicgstab_fused_spmv_dots")
            for got, again, want, what in zip(parts, parts2, partsr, BICG_PARTS):
                close_part(got, want, f"bicgstab_fused_spmv_dots {what}")
                check(torch.equal(got, again),
                      f"bicgstab_fused_spmv_dots {what}: partial not reproducible")
            rows[("bicgstab_fused_spmv_dots", sname, str(dt))] = dict(
                max_abs_err=max_err([(v1, v1r), (q1, q1r), (y1, y1r),
                                     *zip(parts, partsr)]),
                ms=timer.ms(lambda: ops.bicgstab_spmv_dots(xp, *bv, al, st)),
                plain_ms=timer.ms(lambda: ref.bicgstab_spmv_dots_ref(
                    xp, *bv, al, stencil=st)),
                library_ms=None,
                bytes=(npad + 9 * n) * es + 10 * es, ops=ops_k1 + 22 * n,
                peak_ops=peak_ops)
            out = ops.bicgstab_spmv_update(xp, *bv, om, be, st)
            outr = ref.bicgstab_spmv_update_ref(xp, *bv, om, be, stencil=st)
            torch.cuda.synchronize()
            bitwise(out, outr, "bicgstab_fused_spmv_update")
            rows[("bicgstab_fused_spmv_update", sname, str(dt))] = dict(
                max_abs_err=max_err(zip(out, outr)),
                ms=timer.ms(lambda: ops.bicgstab_spmv_update(xp, *bv, om, be, st)),
                plain_ms=timer.ms(lambda: ref.bicgstab_spmv_update_ref(
                    xp, *bv, om, be, stencil=st)),
                library_ms=None,
                bytes=(npad + 10 * n) * es + 2 * es, ops=ops_k1 + 12 * n,
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

        # kernel 10: merged PCG's four vector updates (no stencil)
        vecs6 = vecs + [torch.randn(RANK_BLOCK, generator=gen, dtype=dt, device="cuda")]
        out = ops.pcg_body(a, b, *vecs6)
        outr = ref.fused_pcg_body_ref(a, b, *vecs6)
        torch.cuda.synchronize()
        for o, orf in zip(out, outr):
            check(torch.allclose(o, orf, rtol=out_tol, atol=out_tol),
                  f"fused_pcg_body {dt}: max err {max_err([(o, orf)])}")
        rows[("fused_pcg_body", "-", str(dt))] = dict(
            max_abs_err=max_err(zip(out, outr)),
            ms=timer.ms(lambda: ops.pcg_body(a, b, *vecs6)),
            plain_ms=timer.ms(lambda: ref.fused_pcg_body_ref(a, b, *vecs6)),
            library_ms=None, bytes=10 * n * es + 2 * es, ops=8 * n,
            peak_ops=peak_ops)

        # kernels 9 and 11: the pipelined CGs' six and eight recurrences;
        # each operation rounds on its own, so f64 outputs must be bitwise
        # equal to the plain version's
        vecs10 = vecs6 + [torch.randn(RANK_BLOCK, generator=gen, dtype=dt, device="cuda")
                          for _ in range(4)]
        for name, fn, plain, nvec, nout, nops in (
                ("fused_pipe_body", ops.pipe_body, ref.fused_pipe_body_ref, 7, 6, 12),
                ("fused_ppipe_body", ops.ppipe_body, ref.fused_ppipe_body_ref, 10, 8,
                 16)):
            vs = vecs10[:nvec]
            out = fn(a, b, *vs)
            outr = plain(a, b, *vs)
            torch.cuda.synchronize()
            for o, orf in zip(out, outr):
                check(torch.allclose(o, orf, rtol=out_tol, atol=out_tol),
                      f"{name} {dt}: max err {max_err([(o, orf)])}")
                check(dt != torch.float64 or torch.equal(o, orf),
                      f"{name} {dt}: not bitwise equal to the plain version")
            rows[(name, "-", str(dt))] = dict(
                max_abs_err=max_err(zip(out, outr)),
                ms=timer.ms(lambda: fn(a, b, *vs)),
                plain_ms=timer.ms(lambda: plain(a, b, *vs)),
                library_ms=None, bytes=(nvec + nout) * n * es + 2 * es,
                ops=nops * n, peak_ops=peak_ops)

        # kernel 12: single-reduction BiCGStab's ω-half (α = a, ω = b here)
        vs = vecs10[:6]
        out = ops.bicgstab_update1(a, b, *vs)
        outr = ref.bicgstab_update1_ref(a, b, *vs)
        torch.cuda.synchronize()
        for o, orf in zip(out, outr):
            check(torch.allclose(o, orf, rtol=out_tol, atol=out_tol),
                  f"bicgstab_fused_update1 {dt}: max err {max_err([(o, orf)])}")
            check(dt != torch.float64 or torch.equal(o, orf),
                  f"bicgstab_fused_update1 {dt}: not bitwise equal to the plain version")
        rows[("bicgstab_fused_update1", "-", str(dt))] = dict(
            max_abs_err=max_err(zip(out, outr)),
            ms=timer.ms(lambda: ops.bicgstab_update1(a, b, *vs)),
            plain_ms=timer.ms(lambda: ref.bicgstab_update1_ref(a, b, *vs)),
            library_ms=None, bytes=9 * n * es + 2 * es, ops=10 * n, peak_ops=peak_ops)

        # kernel 8: pipelined PCG's reduction triple (r·u, w·u, r·r)
        ru, uu, wu = vecs[:3]
        dots = ops.fused_dots(ru, uu, wu)
        dots2 = ops.fused_dots(ru, uu, wu)
        dotsr = ref.fused_dots_ref(ru, uu, wu)
        torch.cuda.synchronize()
        for got, want, what in zip(dots, dotsr, ("a·b", "c·b", "a·a")):
            check(abs(float(got) - float(want)) <= part_rtol * abs(float(want)),
                  f"fused_dots {what} {dt}: {float(got)} vs {float(want)}")
        check(all(torch.equal(d, e) for d, e in zip(dots, dots2)),
              "fused_dots: partials not reproducible")
        rows[("fused_dots", "-", str(dt))] = dict(
            max_abs_err=max_err(zip(dots, dotsr)),
            ms=timer.ms(lambda: ops.fused_dots(ru, uu, wu)),
            plain_ms=timer.ms(lambda: ref.fused_dots_ref(ru, uu, wu)),
            library_ms=None,
            three_dots_ms=timer.ms(lambda: (torch.dot(ru.view(-1), uu.view(-1)),
                                            torch.dot(wu.view(-1), uu.view(-1)),
                                            torch.dot(ru.view(-1), ru.view(-1)))),
            bytes=3 * n * es + 3 * es, ops=6 * n, peak_ops=peak_ops)
    for row in rows.values():
        t_bytes = row["bytes"] / bw * 1e3
        t_ops = row.pop("ops") / row.pop("peak_ops") * 1e3
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    for (name, sname, dt), row in rows.items():
        def fmt(v):
            return "-" if v is None else f"{v:.4f}"
        extra = (f" three_torch_dot_ms={row['three_dots_ms']:.4f}"
                 if "three_dots_ms" in row else "")
        print(f"[kernels] {name:26s} {sname:4s} {dt:13s} ms={row['ms']:.4f} "
              f"plain_ms={fmt(row['plain_ms'])} library_ms={fmt(row['library_ms'])} "
              f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
              f"max_abs_err={row['max_abs_err']:.3e}{extra}")
    return rows


#: M⁻¹ applications per solve (pcg, pcg_merged and pcg_pipe: one at set-up
#: and one per iteration; pbicgstab: two per iteration; pbicgstab_merged: two
#: at set-up, two per iteration and one in finalize) and each preconditioner's kernel
#: launches and SpMVs per application at its defaults (chebyshev degree 4:
#: three steps; block_jacobi 3 sweeps: two kernel sweeps; jacobi 2 sweeps:
#: one matvec; ssor: no kernel and no SpMV)
PRECOND_APPLIES = {"pcg": lambda k: 1 + k, "pcg_merged": lambda k: 1 + k,
                   "pcg_pipe": lambda k: 1 + k, "pbicgstab": lambda k: 2 * k,
                   "pbicgstab_merged": lambda k: 2 * k + 3}
PRECOND_LAUNCHES = {"chebyshev": ("cheb_fused_step", 3),
                    "block_jacobi": ("block_jacobi_sweep", 2),
                    "jacobi": ("stencil_spmv", 1), "ssor": (None, 0)}


def expected_launches(method: str, iters: int, precond: str = "none") -> dict:
    """The launches a ``kernels=True`` solve must make, from its iteration
    count (the fused route for the merged and pipelined methods, whose set-up
    is the unfused init: two SpMVs, r = b − A·x0 and A·r or A·u, except
    cg_merged's, which gets A·r from its first ``stencil_spmv_dots``, and
    the merged BiCGStabs', which make three: r0 = b − A·x0, w = A·r0 and
    t = A·w, each operand through M first when preconditioned)."""
    out = dict.fromkeys(ops.LAUNCHES, 0)
    out["stencil_spmv"] = {
        "cg": 1 + iters, "cg_nb": 2 + iters, "bicgstab": 1 + 2 * iters,
        "bicgstab_b1": 1 + 2 * iters, "jacobi": 1 + iters,
        "gauss_seidel": 1 + iters, "gauss_seidel_rb": 1 + iters,
        "cg_merged": 1, "pcg": 1 + iters, "pbicgstab": 1 + 2 * iters,
        "pcg_merged": 2, "cg_pipe": 2, "pcg_pipe": 2 + iters,
        "bicgstab_merged": 3, "pbicgstab_merged": 3}[method]
    if method == "cg_merged":
        out["stencil_spmv_dots"] = iters + 1
        out["fused_cg_body"] = iters
    if method == "pcg_merged":
        out["stencil_spmv_dots3"] = iters
        out["fused_pcg_body"] = iters
    if method == "cg_pipe":           # n = A·w with its partials, then the body
        out["stencil_spmv_dots3"] = iters
        out["fused_pipe_body"] = iters
    if method == "pcg_pipe":          # the partials, M⁻¹w, n = A·m, the body
        out["fused_dots"] = iters
        out["fused_ppipe_body"] = iters
    if method in ("bicgstab_merged", "pbicgstab_merged"):   # the three passes
        for kernel in ("bicgstab_fused_spmv_dots", "bicgstab_fused_update1",
                       "bicgstab_fused_spmv_update"):
            out[kernel] = iters
    if precond != "none":
        kernel, per_apply = PRECOND_LAUNCHES[precond]
        if kernel is not None:
            out[kernel] += per_apply * PRECOND_APPLIES[method](iters)
    return out


def run_solve(method, stencil, grid, kernels, precond="none"):
    sess = SolverSession(method=method, grid=grid, stencil=stencil,
                         options=SolverOptions(kernels=kernels, precond=precond))
    before = dict(ops.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sess.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}
    return sess, res, wall, launches


#: phase 2a, the unpreconditioned path: (method, stencil, precond)
MAIN_CASES = ([("cg_merged", "27pt", "none"), ("cg_merged", "7pt", "none")]
              + [(m, "27pt", "none") for m in ("cg", "cg_nb", "bicgstab", "bicgstab_b1")]
              + [(m, "7pt", "none") for m in ("jacobi", "gauss_seidel", "gauss_seidel_rb")])
#: phase 2b, the preconditioned path
PRECOND_CASES = [("pcg", "27pt", "chebyshev"), ("pcg", "7pt", "chebyshev"),
                 ("pcg", "27pt", "block_jacobi"), ("pcg", "7pt", "block_jacobi"),
                 ("pcg_merged", "27pt", "chebyshev"),
                 ("pcg_merged", "27pt", "block_jacobi"),
                 ("pcg", "27pt", "jacobi"), ("pcg", "27pt", "ssor"),
                 ("pbicgstab", "27pt", "chebyshev")]
#: phase 2c, the pipelined path (the fused route)
PIPE_CASES = [("cg_pipe", "27pt", "none"), ("cg_pipe", "7pt", "none"),
              ("pcg_pipe", "27pt", "chebyshev"), ("pcg_pipe", "7pt", "chebyshev"),
              ("pcg_pipe", "27pt", "block_jacobi"), ("pcg_pipe", "27pt", "jacobi"),
              ("pcg_pipe", "27pt", "ssor")]
#: phase 2d, the single-reduction BiCGStab path (the fused route)
BICGSTAB_CASES = [("bicgstab_merged", "27pt", "none"), ("bicgstab_merged", "7pt", "none"),
                  ("pbicgstab_merged", "27pt", "chebyshev"),
                  ("pbicgstab_merged", "7pt", "chebyshev"),
                  ("pbicgstab_merged", "27pt", "block_jacobi"),
                  ("pbicgstab_merged", "27pt", "jacobi"),
                  ("pbicgstab_merged", "27pt", "ssor")]


#: methods whose stopping iteration depends on the summation order of their
#: dot products.  The single-reduction BiCGStabs' nine dots are summed in
#: per-block slots by the kernel and by ``torch.dot`` without it; at 128³ the
#: recurrence carries the last-bit differences far enough that the two
#: solves may stop a few iterations apart, as the port's two routes do on the
#: CPU with no kernel at all.  For them the iteration counts must agree
#: within the reference's budget for variants (``tests/test_reduction_hiding.py``:
#: 10 % + 1), and the solve's TRUE residual must meet the tolerance.
ORDER_SENSITIVE = ("bicgstab_merged", "pbicgstab_merged")


def iters_agree(method: str, iters: int, plain_iters: int) -> bool:
    if method not in ORDER_SENSITIVE:
        return iters == plain_iters
    return abs(iters - plain_iters) <= math.ceil(0.1 * plain_iters) + 1


def phase_path(tag: str, cases) -> list[dict]:
    """Phase 2: one path through the kernels, each solve checked against the
    same solve with ``kernels=False`` (:func:`iters_agree`) and against its
    exact launch counts."""
    out = []
    for method, stencil, precond in cases:
        what = f"{method}/{stencil}/{precond}"
        sess, res, wall, launches = run_solve(method, stencil, RANK_BLOCK, True,
                                              precond)
        _, plain, plain_wall, plain_launches = run_solve(method, stencil,
                                                         RANK_BLOCK, False, precond)
        err = float((res.x - sess.problem.x_true()).abs().max())
        dx = float((res.x - plain.x).abs().max())
        prob = sess.problem
        true_res = float(torch.linalg.vector_norm(prob.b() - prob.stencil.matvec(res.x)))
        want = expected_launches(method, res.iters, precond)
        rec = dict(method=method, stencil=stencil, precond=precond,
                   iters=res.iters, plain_iters=plain.iters, status=res.status,
                   plain_status=plain.status, err=err, x_vs_plain=dx,
                   true_res=true_res, wall_s=wall, plain_wall_s=plain_wall,
                   launches={k: v for k, v in launches.items() if v})
        print(f"[{tag}] {method:15s} {stencil:4s} {precond:12s} iters={res.iters} "
              f"(plain {plain.iters}) status={res.status} max|x-1|={err:.3e} "
              f"max|x-x_plain|={dx:.3e} |b-Ax|={true_res:.3e} wall={wall:.4f}s "
              f"(plain {plain_wall:.4f}s) launches={rec['launches']}")
        check(res.status == 0 and plain.status == 0,
              f"{what}: status {res.status} (plain {plain.status})")
        check(iters_agree(method, res.iters, plain.iters),
              f"{what}: {res.iters} iterations on the kernels, {plain.iters} without")
        check(method not in ORDER_SENSITIVE or true_res < 10 * sess.options.tol,
              f"{what}: true residual {true_res}")
        check(err < 1e-6, f"{what}: max|x-1| = {err}")
        check(launches == want, f"{what}: launches {launches}, expected {want}")
        check(not any(plain_launches.values()),
              f"{what}: kernels=False launched {plain_launches}")
        out.append(rec)
    return out


#: device-time groups of the profile: name -> fragment of the kernel's name
PROFILE_GROUPS = {
    "fused_cg_body": "fused_cg_body_kernel",
    "fused_pcg_body": "fused_pcg_body_kernel",
    "fused_pipe_body": "fused_pipe_body_kernel",
    "fused_ppipe_body": "fused_ppipe_body_kernel",
    "fused_dots": "fused_dots_kernel",
    "bicgstab_fused_update1": "bicgstab_update1_kernel",
    "bicgstab_fused_spmv_dots": "BicgDotsTail<double>",
    "bicgstab_fused_spmv_update": "BicgUpdateTail<double>",
    "stencil_spmv_dots": "SpmvTail<double, 2>",
    "stencil_spmv_dots3": "Dots3Tail<double>",
    "stencil_spmv": "SpmvTail<double, 0>",
    "cheb_fused_step": "ChebTail<double>",
    "block_jacobi_sweep": "JacobiTail<double>",
    "reduce_partials": "reduce_partials",
    "DtoH": "Memcpy DtoH",
}


#: the solves whose device time phase 2 profiles: (method, precond)
PROFILE_CASES = (("cg_merged", "none"), ("pcg_merged", "chebyshev"),
                 ("cg_pipe", "none"), ("pcg_pipe", "chebyshev"),
                 ("bicgstab_merged", "none"), ("pbicgstab_merged", "chebyshev"))
#: solves timed beside them, not profiled: the classical BiCGStabs on the
#: SpMV kernel, against which the merged ones' time to solution is read
WALL_ONLY_CASES = (("bicgstab", "none"), ("pbicgstab", "chebyshev"))


def warm_walls(cases, rounds: int = 5) -> dict:
    """Median wall time per iteration (ms) of each warm unprofiled solve
    (128³, 27pt, f64, kernels), the cases taken in turn, ``rounds`` times,
    before any profiler session starts, so that every case meets the same
    host state."""
    for method, precond in cases:                             # warm allocator
        run_solve(method, "27pt", RANK_BLOCK, True, precond)
    walls = {case: [] for case in cases}
    iters = {}
    for _ in range(rounds):
        for method, precond in cases:
            _, res, wall, _ = run_solve(method, "27pt", RANK_BLOCK, True, precond)
            walls[(method, precond)].append(wall / res.iters * 1e3)
            iters[(method, precond)] = res.iters
    out = {case: statistics.median(v) for case, v in walls.items()}
    for (method, precond), ms in out.items():
        k = iters[(method, precond)]
        print(f"[walls] {method} precond={precond} 27pt 128^3: iters={k} warm wall "
              f"{ms:.4f} ms/iter, {k * ms:.4f} ms to solution (median of {rounds})")
    return out


def profile_solve(method: str, precond: str, warm_ms_per_iter: float) -> dict:
    """Where the time of one warm solve (128³, 27pt, f64, kernels) goes on
    the card: device time by kernel from ``torch.profiler``, against the
    median warm wall time per iteration from :func:`warm_walls`."""
    from torch.profiler import ProfilerActivity, profile
    sess = SolverSession(method=method, grid=RANK_BLOCK, stencil="27pt",
                         options=SolverOptions(kernels=True, precond=precond))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = sess.solve()
        torch.cuda.synchronize()
    us = dict.fromkeys(PROFILE_GROUPS, 0.0)
    us["other"] = 0.0
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        t = float(getattr(e, "self_device_time_total", 0.0))
        g = next((g for g, frag in PROFILE_GROUPS.items() if frag in e.key), "other")
        us[g] += t
    total = sum(us.values())
    per_iter = {g: v / res.iters / 1e3 for g, v in us.items() if v}
    rec = dict(method=method, precond=precond, iters=res.iters,
               device_ms_per_iter=per_iter,
               device_ms_total_per_iter=total / res.iters / 1e3,
               warm_wall_ms_per_iter=warm_ms_per_iter,
               device_busy_share=(total / res.iters / 1e3) / warm_ms_per_iter
               if total else None)
    print(f"[profile] {method} precond={precond} 27pt 128^3: iters={res.iters} "
          f"warm wall {warm_ms_per_iter:.4f} ms/iter (median of 5 unprofiled solves); "
          f"device ms/iter " + " ".join(f"{g}={v:.4f}" for g, v in per_iter.items())
          + f"; busy share {rec['device_busy_share']}")
    return rec


def socket_solve(method: str, precond: str, elems_per_iter=None) -> dict:
    """Phase 3: one method on the kernels at the per-socket hybrid block;
    ``elems_per_iter(n, npad)`` is the elements one iteration moves (None
    for the classical methods, whose eager iteration is not counted)."""
    run_solve(method, "27pt", SOCKET_BLOCK, True, precond)    # warm allocator
    sess, res, wall, launches = run_solve(method, "27pt", SOCKET_BLOCK, True, precond)
    n = sess.problem.rows
    npad = (SOCKET_BLOCK[0] + 2) * (SOCKET_BLOCK[1] + 2) * (SOCKET_BLOCK[2] + 2)
    bytes_iter = elems_per_iter(n, npad) * 8 if elems_per_iter else None
    err = float((res.x - sess.problem.x_true()).abs().max())
    rec = dict(method=method, precond=precond, grid=list(SOCKET_BLOCK),
               iters=res.iters, status=res.status, wall_s=wall,
               ms_per_iter=wall / max(res.iters, 1) * 1e3,
               bytes_per_iter=bytes_iter,
               gb_per_s=bytes_iter * res.iters / wall / 1e9 if bytes_iter else None,
               err=err, launches={k: v for k, v in launches.items() if v})
    rate = (f"GB/s={rec['gb_per_s']:.1f} (bytes/iter={bytes_iter})" if bytes_iter
            else "GB/s not counted")
    print(f"[socket] {method} precond={precond} 27pt {SOCKET_BLOCK} "
          f"iters={res.iters} status={res.status} wall={wall:.4f}s "
          f"ms/iter={rec['ms_per_iter']:.4f} {rate} max|x-1|={err:.3e} "
          f"launches={rec['launches']}")
    check(res.status == 0, f"socket block {method}: status {res.status}")
    check(err < 1e-6, f"socket block {method}: max|x-1| = {err}")
    check(launches == expected_launches(method, res.iters, precond),
          f"socket block {method}: launches {launches}")
    return rec


def phase_socket_block() -> list[dict]:
    """Phase 3: the merged and pipelined CG and PCG + Chebyshev and the
    merged BiCGStabs at the socket block, with the classical BiCGStabs beside
    them.

    Elements moved per iteration (each input read once, each output written
    once): merged CG's fused body 5 reads + 4 writes, the zero-halo pad of r
    (read r, write padded r) and the stencil pass (read padded r, write w):
    11n + 2·npad.  Merged PCG + Chebyshev: the fused body 6 reads + 4 writes
    (10n); ``z = r/θ`` (2n); three Chebyshev steps, each a pad (n + npad) and
    a pass reading padded z, r, d and writing z, d (npad + 4n); the pad of u
    and the ``spmv_dots3`` pass reading padded u and r and writing w
    (n + npad, npad + 2n): 30n + 8·npad.  Pipelined CG: the pad of w and the
    ``spmv_dots3`` pass (n + npad, npad + 2n), the body 7 reads + 6 writes:
    16n + 2·npad.  Pipelined PCG + Chebyshev: ``fused_dots`` 3 reads; the
    Chebyshev apply on w as above (17n + 6·npad); the pad of m and the SpMV
    (n + npad, npad + n); the body 10 reads + 8 writes: 40n + 8·npad.
    Merged BiCGStab: the pad of z (n + npad), pass 1 reading padded z and six
    vectors and writing three (npad + 9n), the ω-half 6 reads + 3 writes
    (9n), the pad of w (n + npad), pass 3 reading padded w and six vectors
    and writing four (npad + 10n): 30n + 4·npad.  pbicgstab_merged +
    Chebyshev adds two Chebyshev applies as above: 64n + 16·npad.
    """
    return [socket_solve("cg_merged", "none", lambda n, npad: 11 * n + 2 * npad),
            socket_solve("pcg_merged", "chebyshev",
                         lambda n, npad: 30 * n + 8 * npad),
            socket_solve("cg_pipe", "none", lambda n, npad: 16 * n + 2 * npad),
            socket_solve("pcg_pipe", "chebyshev",
                         lambda n, npad: 40 * n + 8 * npad),
            socket_solve("bicgstab_merged", "none", lambda n, npad: 30 * n + 4 * npad),
            socket_solve("pbicgstab_merged", "chebyshev",
                         lambda n, npad: 64 * n + 16 * npad),
            socket_solve("bicgstab", "none"),
            socket_solve("pbicgstab", "chebyshev")]


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
    # one untimed solve of each path warms the caching allocator and loads
    # the PyTorch kernels the paths use
    run_solve("cg_merged", "27pt", RANK_BLOCK, True)
    run_solve("pcg_merged", "27pt", RANK_BLOCK, True, "chebyshev")
    run_solve("pcg_pipe", "27pt", RANK_BLOCK, True, "chebyshev")
    run_solve("pbicgstab_merged", "27pt", RANK_BLOCK, True, "chebyshev")
    runs, launches = {}, {}
    for path, cases in (("main", MAIN_CASES), ("precond", PRECOND_CASES),
                        ("pipe", PIPE_CASES), ("bicgstab", BICGSTAB_CASES)):
        ops.reset_launches()                     # the path starts here
        runs[path] = phase_path(path, cases)
        launches[path] = dict(ops.LAUNCHES)      # ...and ends here
    walls = warm_walls(PROFILE_CASES + WALL_ONLY_CASES)
    profiles = [profile_solve(m, p, walls[(m, p)]) for m, p in PROFILE_CASES]
    socket = phase_socket_block()
    n = math.prod(RANK_BLOCK)
    npad = math.prod(d + 2 for d in RANK_BLOCK)
    unported = {name: elems(n, npad) * 8 / peaks[0] * 1e3
                for name, elems in UNPORTED_ELEMS.items()}
    for name, ms in unported.items():
        print(f"[unported] {name}: bound_ms={ms:.4f} (bytes, 128^3 f64)")

    kernels = []
    for name, meta in KERNELS.items():
        key = (name, "-" if name in BODY_KERNELS else "27pt", str(torch.float64))
        row = rows[key]
        n_launch = launches[meta["path"]][name]
        check(n_launch > 0, f"{name} was not launched on the {meta['path']} path")
        kernels.append(dict(name=name, route="cuda", source=meta["source"],
                            replaces=meta["replaces"], launches=n_launch,
                            max_abs_err=row["max_abs_err"], ms=row["ms"],
                            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                            bound_by=row["bound_by"],
                            library_ms=row["library_ms"]))

    record = dict(card=smi, kind=kind, torch=torch.__version__,
                  cuda=torch.version.cuda, peaks=peaks,
                  kernels=[dict(name=k[0], stencil=k[1], dtype=k[2], **v)
                           for k, v in rows.items()],
                  paths=runs, path_launches=launches,
                  warm_wall_ms_per_iter={f"{m}/{p}": v for (m, p), v in walls.items()},
                  profiles=profiles, socket_block=socket,
                  unported_bound_ms=unported)
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
