#!/usr/bin/env python3
"""How the ring pass's geometry and the merged bodies' block size move their time.

    python3 chip_stencil_variants.py            # needs one CUDA card and nvcc
    python3 chip_stencil_variants.py --record PATH
    python3 chip_stencil_variants.py --bf16     # the bf16 cases and variants alone
    python3 chip_stencil_variants.py --f32      # the f32 pair stage's cases and variants alone
    python3 chip_stencil_variants.py --f64      # f64's two sweeps: old pass, ring, their runs

Builds ``src/repro_torch/kernels/csrc/stencil_spmv.cu``, ``spmv_dot.cu``,
``rb_gs.cu``, ``precond.cu`` and ``bicgstab_fused.cu`` as they are and in
variants, each a copy of ``csrc/`` with the ring pass's constants of
``stencil.cuh`` changed (its (y, z) tile ``kRingY`` × ``kRingZ``, its ring of
``kRingDepth`` plane tiles), with ``no_prefetch`` the tail's prefetch a step
ahead (``stencil_spmv_dots3``'s r, ``rb_gs_half_sweep``'s b, and in bf16 the
block-Jacobi, Chebyshev and both BiCGStab tails' streams) switched off,
or, for ``stencil_kernel``, ``stencil_spmv.cu``'s SpMV, ``spmv_dot.cu``'s
``stencil_spmv_dots`` and ``rb_gs.cu``'s half-sweep put back on the old pass
(one output per thread, 27 global loads a point; padded operand only), all
compiled in parallel into ``build/stencil_variants/``.
``stencil_kernel_one_lane`` is ``stencil_kernel`` with the old pass's lane
fold taken out (``lane = 0``: the one-lane indexing it had before the
lane-batched forms), so the two time what the fold costs a one-lane launch.
``rb_gs.cu`` runs f64 27pt and bf16 on the ring (its static rule,
``on_ring``), in runs of ``kRingRunRbGs`` x-planes; ``gs_ring_all`` puts every
(dtype, stencil) pair of it on the ring, against ``stencil_kernel`` the
evidence for the rule, and ``gs_run4``/``gs_run16`` change its run (f64 and
bf16 alike); these three build and time only the half-sweep, and
``bicg_update_run4``/``bicg_update_run16`` (``kRingRunBicgUpdate``, bf16's
BiCGStab update pass) only the update pass.  The other geometry variants
move the half-sweep only where it runs on the ring.  The run of x-planes of the other tails is
a launch argument (8, 16 or 32, one kernel instance each): ``chip_smoke.py``'s
``autotune`` phase times every run, so no variant changes it here; the
variants launch the default run.
bf16 (the ``BF16_VARIANTS``, each also timed on the bf16 cases; ``--bf16``
times those alone): the ring pass's pair stage (4-byte ``cp.async`` of bf16
pairs, two z-outputs a thread in bf16x2) against ``bf16_register`` (the
register stage forced: ``ring_stage``'s rule switched off, one output a
thread, one plane in flight), ``bf16_scalar`` (the pair stage with its
arithmetic one lane at a time in scalar ``mul.rn``/``add.rn.bf16``, which
the compiler cannot pack, ``kRingPairPacked = 0``) and ``bf16_mul_add`` (the
packed sums with a multiply and an add a term where off = ±1 lets the
kernel fuse them), so a gain splits between the stage and the arithmetic;
``stencil_kernel`` also puts bf16's
block-Jacobi sweep, Chebyshev step, half-sweep and BiCGStab's two passes
back on the old pass (``precond.cu``'s ``jacobi_on_ring`` and
``cheb_on_ring``, ``rb_gs.cu``'s ``on_ring``, ``bicgstab_fused.cu``'s
``bicgstab_dots_on_ring`` and ``bicgstab_update_on_ring`` switched off); the tile
variants (``y8``, ``z32_y8``) and ``depth4``/``depth6`` move the pair
stage's tile and ring too, ``run8``/``run32`` change ``kRingRun``, the run
of the lane-batched SpMV, ``jacobi_run4``/``jacobi_run16``
``kRingRunJacobi``, the run of bf16's block-Jacobi sweep (8),
``cheb_run4``/``cheb_run16`` ``kRingRunCheb`` and ``bicg_run4``/``bicg_run16``
``kRingRunBicgDots``, the runs of bf16's Chebyshev step and dots pass,
``gs_run4``/``gs_run16`` and ``bicg_update_run4``/``bicg_update_run16``
those of the half-sweep and the update pass (above), and
``pair_tail_off`` hands the Chebyshev, half-sweep and both BiCGStab tails a
thread's two outputs in two scalar calls instead of one call of their pair
form (``kRingPairTail = 0``).  The bf16 cases: ``ops.spmv`` (27pt and
7pt, both forms), ``ops.spmv_dots``, ``ops.spmv_dots3``,
``ops.jacobi_sweep`` (padded z, ω = 1), ``ops.cheb_step``,
``ops.bicgstab_spmv_dots``, ``ops.bicgstab_spmv_update`` and
``ops.gs_half_sweep`` (colour 0 timed, both checked; 27pt and 7pt, padded)
at 128³ and 128×128×3072, and the lane-batched ``ops.spmv`` (unpadded),
``ops.jacobi_sweep`` and ``ops.cheb_step`` at B = 4 and 8 lanes of 128³,
each output bitwise the plain version's (the dots pass's vectors; its
partials repeated bitwise).
f32 (the ``F32_VARIANTS``; ``--f32`` times those alone on the f32 cases):
the ring's f32 pair stage under ``ops.cheb_step`` and ``ops.jacobi_sweep``
(8-byte ``cp.async`` of float2 pairs, two z-outputs a thread, ``precond.cu``'s
rule ``on_ring``, which keeps the 7pt Chebyshev step on the old pass)
against ``f32_old`` (the rule switched off: every f32
launch on ``stencil_kernel``), ``f32_element`` (both sweeps on the ring's
element stage, ``kStageAsync``: the f32 pair stage's per-tail rule
``f32_pair_tail`` switched off and the rule taking the ring at every
launch, the 7pt Chebyshev step too), ``pair_tail_off``, ``cheb_run4``/``cheb_run16`` and
``jacobi_run4``/``jacobi_run16`` (which move bf16's runs alike), and
``f32_spmv_pairs``, an information-only build that also puts f32's
``stencil_spmv`` (``SpmvTail<float, 0>``, both operand forms, the
lane-batched form too) on the pair stage, timed against ``kernel``'s
element stage (no wrapper launches it outside this script).  The f32
cases: ``ops.cheb_step`` and ``ops.jacobi_sweep`` (27pt and 7pt, padded z)
at 128³ and 128×128×3072, at B = 4 and 8 lanes of 128³ (27pt), and
``ops.spmv`` (27pt and 7pt, both forms; ``kernel`` and ``f32_spmv_pairs``
only), each output bitwise the plain version's (the old pass's too: its
operations and their order are the plain version's).
f64 (the ``F64_VARIANTS``; ``--f64`` times those alone on the f64 cases):
``ops.cheb_step`` and ``ops.jacobi_sweep`` (27pt and 7pt) at 128³ and
128×128×3072, and at B = 4 and 8 lanes of 128³, each in four forms: the old
pass behind its pad (``old_pad``: ``precond``'s ``old_pass`` on the
unpadded z, which pads it first, as a launch the rule leaves on
``stencil_kernel`` does), the old pass on the padded z (``old``), and the
ring pass (``precond.cu``'s rule: f64 on the ring's element stage) from the
padded z (``padded``) and from z unpadded (``zero_halo``, no pad pass); the
variants ``cheb_run16``/``cheb_run32`` and ``jacobi_run16``/``jacobi_run32``
time the two ring forms of their own sweep in runs of 16 and 32 planes
(``kRingRunCheb``, ``kRingRunJacobi``: 8); every output bitwise the plain
version's and repeated.
``flat128`` and ``flat512`` change the flat passes' block size
(``kFlatThreads``, 256) and build only ``cg_fused_update.cu`` and
``fused_bodies.cu``: they time ``ops.cg_body`` and ``ops.pcg_body`` (rows 3
and 10, merged CG's and merged PCG's update passes) in f64 and f32 against
the same calls of ``kernel``, each output held to the plain version's
(bitwise in f64, within 1e-5 in f32); the evidence on which the block size
stays a constant, not a tuned knob.
Each variant's ``ops.spmv`` (27pt and 7pt), ``ops.spmv_dots`` (27pt) and
``ops.spmv_dots3`` (27pt; not on the old pass) run in f64 at the rank block
128³ and the socket block 128×128×3072, from x unpadded (the zero halo made
in the kernel) and padded, and ``ops.gs_half_sweep`` (27pt and 7pt, padded,
colour 0) in f64 and f32 at both; every f64 output must be bitwise equal to
the plain version's (the half-sweep's in both colours; f32 within 1e-5).
Times are CUDA events, median of ``--n`` launches, L2 flushed
before each by reading a 512 MiB buffer (as ``chip_smoke.py``'s ``Timer``),
the variants taken in turn four times (forward, backward, forward,
backward); a variant's time is the median of its rounds, each round's kept
in the record.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.core.operators import STENCILS, pad1  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import (bicgstab_fused, cg_fused_update,  # noqa: E402
                                 fused_bodies, precond, rb_gs, spmv_dot, stencil_spmv)

OUT = ROOT / "build" / "stencil_variants"
#: turns over the variants, forward and backward in alternation
ROUNDS = 4
GRIDS = {"rank": (128, 128, 128), "socket": (128, 128, 3072)}
#: variant -> the ring constants it changes
GEOMETRY = {
    "kernel": {},
    "no_prefetch": {},
    "depth4": {"kRingDepth": 4},
    "depth6": {"kRingDepth": 6},
    "y8": {"kRingY": 8},
    "z32_y8": {"kRingZ": 32, "kRingY": 8},
    "stencil_kernel": {},
    "stencil_kernel_one_lane": {},
    "gs_ring_all": {},
    "gs_run4": {"kRingRunRbGs": 4},
    "gs_run16": {"kRingRunRbGs": 16},
    "flat128": {"kFlatThreads": 128},
    "flat512": {"kFlatThreads": 512},
    "bf16_register": {},
    "bf16_scalar": {"kRingPairPacked": 0},
    "bf16_mul_add": {},
    "run8": {"kRingRun": 8},
    "run32": {"kRingRun": 32},
    "jacobi_run4": {"kRingRunJacobi": 4},
    "jacobi_run16": {"kRingRunJacobi": 16},
    "cheb_run4": {"kRingRunCheb": 4},
    "cheb_run16": {"kRingRunCheb": 16},
    "cheb_run32": {"kRingRunCheb": 32},
    "jacobi_run32": {"kRingRunJacobi": 32},
    "bicg_run4": {"kRingRunBicgDots": 4},
    "bicg_run16": {"kRingRunBicgDots": 16},
    "bicg_update_run4": {"kRingRunBicgUpdate": 4},
    "bicg_update_run16": {"kRingRunBicgUpdate": 16},
    "pair_tail_off": {"kRingPairTail": 0},
    "f32_old": {},
    "f32_element": {},
    "f32_spmv_pairs": {},
}
#: rb_gs.cu's static rule: the (dtype, stencil) pairs on the ring pass
RB_GS_RULE = ("return (std::is_same<T, double>::value && npoint == 27) ||\n"
              "         std::is_same<T, __nv_bfloat16>::value;")
#: stencil.cuh's stage rule: when bf16 (and f32's pair tails) copy pairs (else
#: bf16's register stage)
PAIR_RULE = ("const bool pairs = nz % 2 == 0 && reinterpret_cast<uintptr_t>(x) % "
             "(2 * sizeof(T)) == 0;")
#: stencil.cuh's rule for the pair stage's fma (off = ±1)
UNIT_RULE = "const bool unit = off == 1.0 || off == -1.0;"
#: the static rules of precond.cu (block_jacobi_sweep, cheb_fused_step: on_ring
#: and sweep's bf16 branch; f32's part, the pair stage) and bicgstab_fused.cu
#: (the dots pass): the dtypes each puts on the ring pass
RING_DTYPE = "std::is_same<T, __nv_bfloat16>::value"
PRECOND_BF16_RULE = f"  if constexpr ({RING_DTYPE})\n    return true;"
PRECOND_BF16_RING = (f"  else if constexpr ({RING_DTYPE})\n"
                     "    return repro::launch_stencil_ring<T>(")
PRECOND_F32_RULE = ("return repro::pair_stage(repro::ring_tail_stage<T>(tail, nz, 0, z)) &&\n"
                    "           (npoint == 27 || !std::is_same<Tail, repro::ChebTail<T>>::value);")
#: stencil.cuh's per-tail rule of f32's pair stage
F32_PAIR_TAILS = ("template <>\nstruct f32_pair_tail<ChebTail<float>> : std::true_type {};\n"
                  "template <>\nstruct f32_pair_tail<JacobiTail<float>> : std::true_type {};")
BICG_RULE = f"constexpr bool bicgstab_dots_on_ring() {{\n  return {RING_DTYPE};"
BICG_UPDATE_RULE = f"constexpr bool bicgstab_update_on_ring() {{\n  return {RING_DTYPE};"
#: variant -> [(file, anchor, replacement)] text switches
SWITCHES = {
    "no_prefetch": [("stencil.cuh", "if constexpr (prefetch_tail<Tail>::value) {",
                     "if constexpr (false) {")],
    "stencil_kernel": [("stencil_spmv.cu", "repro::launch_stencil_ring<T>(xi, zero_halo, ",
                        "repro::launch_stencil<T>(xi, "),
                       ("stencil_spmv.cu", ", s, 1, run);", ", s);"),
                       ("stencil_spmv.cu", ", s, lanes, run);", ", s, lanes);"),
                       ("stencil_spmv.cu", "repro::stencil_ring_num_blocks(nx, ny, nz, run)",
                        "repro::stencil_num_blocks(nx, ny, nz)"),
                       ("spmv_dot.cu",
                        "return repro::launch_stencil_ring<T>(static_cast<const T*>(x), "
                        "zero_halo,",
                        "return repro::launch_stencil<T>(static_cast<const T*>(x),"),
                       ("spmv_dot.cu", "npoint, diag,\n" + " " * 39
                        + "off, static_cast<cudaStream_t>(stream), 1, run);",
                        "npoint, diag, off, static_cast<cudaStream_t>(stream));"),
                       ("spmv_dot.cu", "long long spmv_dots_partials(int nx, int ny, int nz, "
                        "int run) {\n  return repro::stencil_ring_num_blocks(nx, ny, nz, run);",
                        "long long spmv_dots_partials(int nx, int ny, int nz, int run) {"
                        "\n  return repro::stencil_num_blocks(nx, ny, nz);"),
                       ("rb_gs.cu", RB_GS_RULE, "return false;"),
                       ("precond.cu", PRECOND_F32_RULE, "return false;"),
                       *((src, rule, rule.replace(RING_DTYPE, "false"))
                         for src, rule in (("precond.cu", PRECOND_BF16_RULE),
                                           ("precond.cu", PRECOND_BF16_RING),
                                           ("bicgstab_fused.cu", BICG_RULE),
                                           ("bicgstab_fused.cu", BICG_UPDATE_RULE)))],
    "gs_ring_all": [("rb_gs.cu", RB_GS_RULE, "return true;")],
    "bf16_register": [("stencil.cuh", PAIR_RULE, "const bool pairs = false;")],
    "bf16_mul_add": [("stencil.cuh", UNIT_RULE, "const bool unit = false;")],
    "f32_old": [("precond.cu", PRECOND_F32_RULE, "return false;")],
    "f32_element": [("precond.cu", PRECOND_F32_RULE, "return true;"),
                    ("stencil.cuh", F32_PAIR_TAILS,
                     F32_PAIR_TAILS.replace("std::true_type", "std::false_type"))],
    "f32_spmv_pairs": [("stencil.cuh", F32_PAIR_TAILS, F32_PAIR_TAILS
                        + "\ntemplate <>\nstruct f32_pair_tail<SpmvTail<float, 0>> : "
                        "std::true_type {};")],
}
SWITCHES["stencil_kernel_one_lane"] = SWITCHES["stencil_kernel"] + [
    ("stencil.cuh", "const int runs = (nx + kPlanesX - 1) / kPlanesX;\n"
     "  const int lane = blockIdx.z / runs;",
     "const int runs = (nx + kPlanesX - 1) / kPlanesX;\n  const int lane = 0;")]
#: the old pass's variants (padded operand only, no dots3)
OLD_PASS = ("stencil_kernel", "stencil_kernel_one_lane")
#: the variants that build and time the half-sweep alone, and bf16's
#: BiCGStab update pass alone
GS_ONLY = ("gs_ring_all", "gs_run4", "gs_run16")
BICG_UPDATE_ONLY = ("bicg_update_run4", "bicg_update_run16")
#: the variants that build and time the merged bodies alone
FLAT_ONLY = ("flat128", "flat512")
#: the variants timed on the bf16 cases (the last four on them alone)
BF16_VARIANTS = ("kernel", "stencil_kernel", "depth4", "depth6", "y8", "z32_y8",
                 "bf16_register", "bf16_scalar", "bf16_mul_add", "run8", "run32",
                 "jacobi_run4", "jacobi_run16", "cheb_run4", "cheb_run16", "bicg_run4",
                 "bicg_run16", "gs_run4", "gs_run16", "bicg_update_run4", "bicg_update_run16",
                 "pair_tail_off", "no_prefetch")
BF16_ONLY = ("bf16_register", "bf16_scalar", "bf16_mul_add", "run8", "run32", "jacobi_run4",
             "jacobi_run16", "cheb_run4", "cheb_run16", "bicg_run4", "bicg_run16",
             "bicg_update_run4", "bicg_update_run16", "pair_tail_off")
#: the lane counts of the bf16 lane-batched cases (at 128³ only)
BF16_LANES = (4, 8)
#: the variants timed on the f32 cases, and those timed on them alone (the
#: f32 sweeps' runs move bf16's too: their bf16 cases are timed beside)
F32_VARIANTS = ("kernel", "f32_old", "f32_element", "pair_tail_off", "cheb_run4",
                "cheb_run16", "jacobi_run4", "jacobi_run16", "f32_spmv_pairs")
F32_ONLY = ("f32_old", "f32_element", "f32_spmv_pairs")
#: the variants timed on the f64 sweeps' cases (``--f64``), and the lane
#: counts of their batched cases (at 128³ only)
F64_VARIANTS = ("kernel", "cheb_run16", "cheb_run32", "jacobi_run16", "jacobi_run32")
F64_LANES = (4, 8)
#: the forms of an f64 sweep: the old pass behind its pad, the old pass, the
#: ring from the padded z, the ring from z unpadded
F64_FORMS = ("old_pad", "old", "padded", "zero_halo")
SOURCES = {"stencil_spmv": stencil_spmv.SIGNATURES, "spmv_dot": spmv_dot.SIGNATURES,
           "rb_gs": rb_gs.SIGNATURES, "precond": precond.SIGNATURES,
           "bicgstab_fused": bicgstab_fused.SIGNATURES}
#: the merged bodies' sources (``kernel`` and ``FLAT_ONLY`` build them)
FLAT_SOURCES = {"cg_fused_update": cg_fused_update.SIGNATURES,
                "fused_bodies": fused_bodies.SIGNATURES}


def sources(name: str, mode: str | None = None) -> tuple[str, ...]:
    """The sources a variant builds (with ``mode`` "bf16" or "f32", those of
    its cases in that dtype)."""
    if name in GS_ONLY:
        return ("rb_gs",)
    if name in BICG_UPDATE_ONLY:
        return ("bicgstab_fused",)
    if mode == "f64":
        return ("precond",)
    if mode == "f32" or name in F32_ONLY:
        return {"kernel": ("precond", "stencil_spmv"),
                "f32_spmv_pairs": ("stencil_spmv",)}.get(name, ("precond",))
    if mode == "bf16":
        return ("stencil_spmv", "spmv_dot", "precond", "bicgstab_fused", "rb_gs")
    if name in FLAT_ONLY:
        return tuple(FLAT_SOURCES)
    return tuple(SOURCES) + (tuple(FLAT_SOURCES) if name == "kernel" else ())


def write_variant(name: str) -> Path:
    """csrc copied to OUT/name with the variant's constants and switches."""
    out = OUT / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC, out)
    for const, value in GEOMETRY[name].items():
        path = out / "stencil.cuh"
        text, k = re.subn(rf"(constexpr int {const} = )\d+;", rf"\g<1>{value};",
                          path.read_text())
        if k != 1:
            raise SystemExit(f"{name}: constant {const} not found once in stencil.cuh")
        path.write_text(text)
    for fname, anchor, repl in SWITCHES.get(name, []):
        path = out / fname
        if anchor not in path.read_text():
            raise SystemExit(f"{name}: anchor missing from {fname}:\n{anchor}")
        path.write_text(path.read_text().replace(anchor, repl))
    return out


def kernel_registers(log: str) -> dict[str, int]:
    """ptxas's registers for each kernel (mangled name) of a build log."""
    out, fn = {}, "?"
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            fn = m.group(1)
        if m := re.search(r"Used (\d+) registers", line):
            out[fn] = int(m.group(1))
    return out


def build(names, registers: dict, mode: str | None = None) -> dict[str, dict[str, ctypes.CDLL]]:
    """Every variant's libraries, built in parallel; ``registers`` gets each
    variant's and source's :func:`kernel_registers`."""
    nvcc = _build._nvcc()
    procs = {}
    for n in names:
        out = write_variant(n)
        for src in sources(n, mode):
            procs[(n, src)] = subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-o", str(out / f"lib{src}.so"),
                 str(out / f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs: dict[str, dict[str, ctypes.CDLL]] = {n: {} for n in names}
    for (n, src), proc in procs.items():
        log, _ = proc.communicate()
        (OUT / n / f"{src}.log").write_text(log)
        if proc.returncode:
            raise SystemExit(f"{n}/{src}: build failed\n{log[-4000:]}")
        lib = ctypes.CDLL(str(OUT / n / f"lib{src}.so"))
        for fn, (argtypes, restype) in {**SOURCES, **FLAT_SOURCES}[src].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[n][src] = lib
        registers[f"{n}/{src}"] = kernel_registers(log)
        regs = sorted(set(registers[f"{n}/{src}"].values()))
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"[build] {n}/{src}: registers {regs}, spill stores "
              f"{sorted({int(s) for s in spills})}")
    return libs


def use(libs: dict[str, ctypes.CDLL]) -> None:
    """Route ``ops.spmv``/``ops.spmv_dots``/``ops.spmv_dots3``/
    ``ops.gs_half_sweep``/``ops.cg_body``/``ops.pcg_body`` to a variant's
    libraries."""
    for src, lib in libs.items():
        _build._LIBS[src] = lib


def bf16_cases(name: str, grid: str):
    """(label, kind, stencil, zero_halo, dtype) of a variant's bf16 calls at
    ``grid``: rows 1, 2, 4, 13–17 at both grids, rows 1b, 16b and 17b
    (``kind`` ``spmv_b<B>``, ``cheb_b<B>``, ``jacobi_b<B>``) at the rank
    block; the old pass's SpMVs padded only, and no dots3; the half-sweep's
    (``gs``) alone for the variants of :data:`GS_ONLY`, the update pass's
    (``bicg_update``) alone for those of :data:`BICG_UPDATE_ONLY`."""
    if name not in BF16_VARIANTS:
        return []
    bf = torch.bfloat16
    own = "gs" if name in GS_ONLY else "bicg_update" if name in BICG_UPDATE_ONLY else None
    if own:
        return [(f"{own} {st} padded bf16", own, st, False, bf) for st in ("27pt", "7pt")]
    old = name in OLD_PASS
    out = []
    for form in ("padded",) if old else ("zero_halo", "padded"):
        for st in ("27pt", "7pt"):
            out.append((f"spmv {st} {form} bf16", "spmv", st, form == "zero_halo", bf))
        out.append((f"dots 27pt {form} bf16", "dots", "27pt", form == "zero_halo", bf))
        if not old:
            out.append((f"dots3 27pt {form} bf16", "dots3", "27pt", form == "zero_halo", bf))
    for kind in ("jacobi", "cheb", "bicg", "bicg_update", "gs"):
        for st in ("27pt", "7pt"):
            out.append((f"{kind} {st} padded bf16", kind, st, False, bf))
    if grid == "rank":
        for B in BF16_LANES:
            form = "padded" if old else "zero_halo"
            out.append((f"spmv_b{B} 27pt {form} bf16", f"spmv_b{B}", "27pt", not old, bf))
            out.append((f"jacobi_b{B} 27pt padded bf16", f"jacobi_b{B}", "27pt", False, bf))
            out.append((f"cheb_b{B} 27pt padded bf16", f"cheb_b{B}", "27pt", False, bf))
    return out


def f32_cases(name: str, grid: str):
    """(label, kind, stencil, zero_halo, dtype) of a variant's f32 calls
    (``kind`` ``f32_<call>``) at ``grid``: rows 16 and 17 (27pt and 7pt,
    padded z) at both grids and rows 16b, 17b (``cheb_b<B>``,
    ``jacobi_b<B>``, 27pt) at the rank block, but for ``f32_spmv_pairs``;
    row 1 (27pt and 7pt, both forms) for ``kernel`` and ``f32_spmv_pairs``,
    and row 1b (27pt, unpadded) at the rank block."""
    if name not in F32_VARIANTS:
        return []
    f32 = torch.float32
    out = []
    if name in ("kernel", "f32_spmv_pairs"):
        for form in ("zero_halo", "padded"):
            for st in ("27pt", "7pt"):
                out.append((f"spmv {st} {form} f32", "f32_spmv", st, form == "zero_halo", f32))
        if grid == "rank":
            for B in BF16_LANES:
                out.append((f"spmv_b{B} 27pt zero_halo f32", f"f32_spmv_b{B}", "27pt", True,
                            f32))
    if name == "f32_spmv_pairs":
        return out
    for kind in ("jacobi", "cheb"):
        for st in ("27pt", "7pt"):
            out.append((f"{kind} {st} padded f32", f"f32_{kind}", st, False, f32))
    if grid == "rank":
        for B in BF16_LANES:
            for kind in ("jacobi", "cheb"):
                out.append((f"{kind}_b{B} 27pt padded f32", f"f32_{kind}_b{B}", "27pt", False,
                            f32))
    return out


def f64_cases(name: str, grid: str):
    """(label, kind, stencil, zero_halo, dtype) of a variant's f64 sweep calls
    (``kind`` ``f64_<call>|<form>``) at ``grid``: rows 16 and 17 (27pt and
    7pt) and, at the rank block, rows 16b and 17b (``cheb_b<B>``,
    ``jacobi_b<B>``), each in the :data:`F64_FORMS` (``kernel``), or in the
    ring's two forms for a run variant's own sweep."""
    f64 = torch.float64
    own = {"kernel": ("cheb", "jacobi")}.get(name, (name.split("_run")[0],))
    forms = F64_FORMS if name == "kernel" else ("padded", "zero_halo")
    out = []
    for kind in own:
        calls = [(kind, st) for st in ("27pt", "7pt")]
        if grid == "rank":
            calls += [(f"{kind}_b{B}", st) for B in F64_LANES for st in ("27pt", "7pt")]
        for call, st in calls:
            for form in forms:
                out.append((f"{call} {st} {form} f64", f"f64_{call}|{form}", st,
                            form == "zero_halo", f64))
    return out


def cases(name: str, grid: str = "rank", mode: str | None = None):
    """(label, kind, stencil, zero_halo, dtype) of the calls a variant is
    timed on: the old pass takes only the padded operand and has no dots3 of
    its own; the half-sweep takes only the padded operand; the merged bodies
    take no stencil; the bf16 cases are :func:`bf16_cases` (alone with
    ``mode`` "bf16", or for a variant of :data:`BF16_ONLY`), the f32 pair
    stage's :func:`f32_cases` (alone with ``mode`` "f32", or for a variant
    of :data:`F32_ONLY`)."""
    if mode == "bf16":
        return bf16_cases(name, grid)
    if mode == "f32":
        return f32_cases(name, grid)
    if mode == "f64":
        return f64_cases(name, grid)
    if name in BF16_ONLY or name in F32_ONLY:
        return bf16_cases(name, grid) + f32_cases(name, grid)
    f64, f32 = torch.float64, torch.float32
    flat = [(f"{kind} {str(dt)[6:]}", kind, None, False, dt)
            for kind in ("cg_body", "pcg_body") for dt in (f64, f32)]
    if name in FLAT_ONLY:
        return flat
    out = flat if name == "kernel" else []
    for form in () if name in GS_ONLY else ("zero_halo", "padded"):
        if name in OLD_PASS and form == "zero_halo":
            continue
        for st in ("27pt", "7pt"):
            out.append((f"spmv {st} {form}", "spmv", st, form == "zero_halo", f64))
        out.append((f"dots 27pt {form}", "dots", "27pt", form == "zero_halo", f64))
        if name not in OLD_PASS:
            out.append((f"dots3 27pt {form}", "dots3", "27pt", form == "zero_halo", f64))
    for dt in (f64, f32):
        for st in ("27pt", "7pt"):
            out.append((f"gs {st} padded {str(dt)[6:]}", "gs", st, False, dt))
    return out + bf16_cases(name, grid) + f32_cases(name, grid)


def _flat(out) -> list:
    """A call's tensors in order, a tuple of partials flattened."""
    flat = []
    for o in (out if isinstance(out, tuple) else (out,)):
        flat += list(o) if isinstance(o, tuple) else [o]
    return flat


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", default=None, metavar="PATH")
    ap.add_argument("--n", type=int, default=15, help="launches a time is the median of")
    ap.add_argument("--bf16", action="store_true",
                    help="build and time the bf16 variants on their bf16 cases alone")
    ap.add_argument("--f32", action="store_true",
                    help="build and time the f32 variants on their f32 cases alone")
    ap.add_argument("--f64", action="store_true",
                    help="build and time f64's sweeps, old pass and ring, and their runs")
    args = ap.parse_args(argv)
    mode = "bf16" if args.bf16 else "f32" if args.f32 else "f64" if args.f64 else None
    if not torch.cuda.is_available():
        print("chip_stencil_variants: needs an NVIDIA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    print(card)
    names = {"bf16": BF16_VARIANTS, "f32": F32_VARIANTS,
             "f64": F64_VARIANTS}.get(mode, tuple(GEOMETRY))
    registers: dict[str, dict[str, int]] = {}
    libs = build(names, registers, mode)
    flush = torch.ones(128 << 20, dtype=torch.float32, device="cuda")

    def ms(fn):
        fn()
        times = []
        for _ in range(args.n):
            flush.sum()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    record = dict(card=card, geometry=GEOMETRY, registers=registers, grids={})
    gen = torch.Generator(device="cuda").manual_seed(9)
    for grid, shape in GRIDS.items():
        x, r = (torch.randn(shape, generator=gen, dtype=torch.float64, device="cuda")
                for _ in range(2))
        xp = pad1(x)
        half = {torch.float64: (xp, r), torch.float32: (xp.float(), r.float())}
        vecs = {dt: [torch.randn(shape, generator=gen, dtype=dt, device="cuda")
                     for _ in range(6)] for dt in half}
        coef = {dt: (torch.tensor(0.37, dtype=dt, device="cuda"),
                     torch.tensor(-0.21, dtype=dt, device="cuda")) for dt in half}
        # bf16: x and r rounded, and the lanes of the batched cases
        xb, rb = x.to(torch.bfloat16), r.to(torch.bfloat16)
        xbp = pad1(xb)
        lanes = {B: torch.randn((B, *shape), generator=gen, device="cuda").to(torch.bfloat16)
                 for B in BF16_LANES} if grid == "rank" else {}
        lanes_p = {B: pad1(v) for B, v in lanes.items()}
        lane_r = {B: torch.randn((B, *shape), generator=gen, device="cuda").to(torch.bfloat16)
                  for B in lanes}
        lane_d = {B: torch.randn((B, *shape), generator=gen, device="cuda").to(torch.bfloat16)
                  for B in lanes}
        # the Chebyshev step's d and (a, c), the dots pass's six streams and α
        db = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        cheb_ac = dict(a=0.3719, c=0.1137)
        bicg = [torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(6)]
        alpha = torch.tensor(0.37, dtype=torch.bfloat16, device="cuda")
        # the update pass's ω and β (its six streams are the dots pass's)
        omb, beb = (torch.tensor(c, dtype=torch.bfloat16, device="cuda") for c in (1.3, -0.41))
        # f32: x and r rounded, the Chebyshev step's d and the lanes of the
        # batched cases (from a generator of their own: the other cases'
        # inputs stay as they were)
        gen32 = torch.Generator(device="cuda").manual_seed(10)
        x32, r32 = x.float(), r.float()
        x32p = pad1(x32)
        d32 = torch.randn(shape, generator=gen32, device="cuda")
        lanes32 = {B: [torch.randn((B, *shape), generator=gen32, device="cuda")
                       for _ in range(3)] for B in BF16_LANES} if grid == "rank" else {}
        for v in lanes32.values():
            v[0] = pad1(v[0])                   # (z padded, r, d) a batch
        # f64's sweeps: z = x, r, a seeded d, and (z, r, d) lanes at 128³
        # (from a generator of their own, as f32's)
        gen64 = torch.Generator(device="cuda").manual_seed(11)
        d64 = torch.randn(shape, generator=gen64, dtype=torch.float64, device="cuda")
        lanes64 = {B: [torch.randn((B, *shape), generator=gen64, dtype=torch.float64,
                                   device="cuda") for _ in range(3)]
                   for B in F64_LANES} if grid == "rank" and mode == "f64" else {}

        def call(kind, st, zero_halo, dt=torch.float64, colour=0):
            if kind.startswith("f64_"):
                return f64_call(*kind[4:].split("|"), st)
            if kind.startswith("f32_"):
                return f32_call(kind[4:], st, zero_halo)
            if dt == torch.bfloat16:
                return bf16_call(kind, st, zero_halo, colour)
            opnd = x if zero_halo else xp
            if kind == "cg_body":
                return lambda: ops.cg_body(*coef[dt], *vecs[dt][:5])
            if kind == "pcg_body":
                return lambda: ops.pcg_body(*coef[dt], *vecs[dt])
            if kind == "gs":
                return lambda: ops.gs_half_sweep(*half[dt], STENCILS[st], colour)
            if kind == "spmv":
                return lambda: ops.spmv(opnd, STENCILS[st], zero_halo=zero_halo)
            if kind == "dots":
                return lambda: ops.spmv_dots(opnd, STENCILS[st], zero_halo=zero_halo)
            return lambda: ops.spmv_dots3(opnd, r, STENCILS[st], zero_halo=zero_halo)

        def bf16_call(kind, st, zero_halo, colour=0):
            s = STENCILS[st]
            opnd = xb if zero_halo else xbp
            if kind.startswith("spmv_b"):
                B = int(kind[6:])
                return lambda: ops.spmv(lanes[B] if zero_halo else lanes_p[B], s,
                                        zero_halo=zero_halo)
            if kind.startswith("jacobi_b"):
                B = int(kind[8:])
                return lambda: ops.jacobi_sweep(lanes_p[B], lane_r[B], s, omega=1.0)
            if kind.startswith("cheb_b"):
                B = int(kind[6:])
                return lambda: ops.cheb_step(lanes_p[B], lane_r[B], lane_d[B], s, **cheb_ac)
            if kind == "jacobi":
                return lambda: ops.jacobi_sweep(xbp, rb, s, omega=1.0)
            if kind == "cheb":
                return lambda: ops.cheb_step(xbp, rb, db, s, **cheb_ac)
            if kind == "bicg":
                return lambda: ops.bicgstab_spmv_dots(xbp, *bicg, alpha, s)
            if kind == "bicg_update":
                return lambda: ops.bicgstab_spmv_update(xbp, *bicg, omb, beb, s)
            if kind == "gs":
                return lambda: ops.gs_half_sweep(xbp, rb, s, colour)
            if kind == "spmv":
                return lambda: ops.spmv(opnd, s, zero_halo=zero_halo)
            if kind == "dots":
                return lambda: ops.spmv_dots(opnd, s, zero_halo=zero_halo)
            return lambda: ops.spmv_dots3(opnd, rb, s, zero_halo=zero_halo)

        def bf16_plain(kind, st, colour=0):
            """The plain version's vector outputs, the first ones of the call's."""
            s = STENCILS[st]
            if kind.startswith("spmv_b"):
                return [ref.stencil_spmv_ref(lanes_p[int(kind[6:])], stencil=s)]
            if kind.startswith("jacobi_b"):
                B = int(kind[8:])
                return [ref.block_jacobi_sweep_ref(lanes_p[B], lane_r[B], stencil=s, omega=1.0)]
            if kind.startswith("cheb_b"):
                B = int(kind[6:])
                return list(ref.cheb_fused_step_ref(lanes_p[B], lane_r[B], lane_d[B], stencil=s,
                                                    **cheb_ac))
            if kind == "jacobi":
                return [ref.block_jacobi_sweep_ref(xbp, rb, stencil=s, omega=1.0)]
            if kind == "cheb":
                return list(ref.cheb_fused_step_ref(xbp, rb, db, stencil=s, **cheb_ac))
            if kind == "bicg":
                return list(ref.bicgstab_spmv_dots_ref(xbp, *bicg, alpha, stencil=s)[:3])
            if kind == "bicg_update":
                return list(ref.bicgstab_spmv_update_ref(xbp, *bicg, omb, beb, stencil=s))
            if kind == "gs":
                return [ref.rb_gs_half_sweep_ref(xbp, rb, stencil=s, colour=colour)]
            return [ref.stencil_spmv_ref(xbp, stencil=s)]

        def f32_call(kind, st, zero_halo):
            s = STENCILS[st]
            if kind.startswith("spmv_b"):
                lx = lanes32[int(kind[6:])][0][..., 1:-1, 1:-1, 1:-1].contiguous()
                return lambda: ops.spmv(lx, s, zero_halo=True)
            if kind.startswith(("jacobi_b", "cheb_b")):
                zp, lr, ld = lanes32[int(kind.split("_b")[1])]
                if kind.startswith("jacobi"):
                    return lambda: ops.jacobi_sweep(zp, lr, s, omega=1.0)
                return lambda: ops.cheb_step(zp, lr, ld, s, **cheb_ac)
            if kind == "jacobi":
                return lambda: ops.jacobi_sweep(x32p, r32, s, omega=1.0)
            if kind == "cheb":
                return lambda: ops.cheb_step(x32p, r32, d32, s, **cheb_ac)
            return lambda: ops.spmv(x32 if zero_halo else x32p, s, zero_halo=zero_halo)

        def f32_plain(kind, st):
            """The plain version's outputs of an f32 call, in its order."""
            s = STENCILS[st]
            if kind.startswith("spmv_b"):
                return [ref.stencil_spmv_ref(pad1(lanes32[int(kind[6:])][0][
                    ..., 1:-1, 1:-1, 1:-1]), stencil=s)]
            if kind.startswith(("jacobi_b", "cheb_b")):
                zp, lr, ld = lanes32[int(kind.split("_b")[1])]
                if kind.startswith("jacobi"):
                    return [ref.block_jacobi_sweep_ref(zp, lr, stencil=s, omega=1.0)]
                return list(ref.cheb_fused_step_ref(zp, lr, ld, stencil=s, **cheb_ac))
            if kind == "jacobi":
                return [ref.block_jacobi_sweep_ref(x32p, r32, stencil=s, omega=1.0)]
            if kind == "cheb":
                return list(ref.cheb_fused_step_ref(x32p, r32, d32, stencil=s, **cheb_ac))
            return [ref.stencil_spmv_ref(x32p, stencil=s)]

        def f64_operands(call):
            """(z, r, d) of an f64 sweep call, z unpadded."""
            if "_b" in call:
                return lanes64[int(call.split("_b")[1])]
            return x, r, d64

        def f64_call(call, form, st):
            s = STENCILS[st]
            z, rr, dd = f64_operands(call)
            zp = z if form == "zero_halo" else pad1(z)
            zh, old = form in ("zero_halo", "old_pad"), form.startswith("old")
            opnd = z if zh else zp
            if call.startswith("jacobi"):
                if old:
                    return lambda: precond.block_jacobi_sweep(
                        opnd, rr, stencil=s, omega=1.0, zero_halo=zh, old_pass=True)
                return lambda: ops.jacobi_sweep(opnd, rr, s, omega=1.0, zero_halo=zh)
            if old:
                return lambda: precond.cheb_fused_step(opnd, rr, dd, stencil=s, zero_halo=zh,
                                                       old_pass=True, **cheb_ac)
            return lambda: ops.cheb_step(opnd, rr, dd, s, zero_halo=zh, **cheb_ac)

        def f64_plain(call, st):
            """The plain version's outputs of an f64 sweep call, in its order."""
            s = STENCILS[st]
            z, rr, dd = f64_operands(call)
            if call.startswith("jacobi"):
                return [ref.block_jacobi_sweep_ref(pad1(z), rr, stencil=s, omega=1.0)]
            return list(ref.cheb_fused_step_ref(pad1(z), rr, dd, stencil=s, **cheb_ac))

        plain = {}          # the f64/f32 cases' plain outputs (with --bf16, --f32 none)
        if mode is None:
            plain = {st: ref.stencil_spmv_ref(xp, stencil=STENCILS[st])
                     for st in ("27pt", "7pt")}
            plain.update({(dt, st, colour): ref.rb_gs_half_sweep_ref(
                *half[dt], stencil=STENCILS[st], colour=colour)
                for dt in half for st in ("27pt", "7pt") for colour in (0, 1)})
            plain.update({(kind, dt): fn(*coef[dt], *vecs[dt][:n_in]) for dt in half
                          for kind, fn, n_in in (("cg_body", ref.fused_cg_body_ref, 5),
                                                 ("pcg_body", ref.fused_pcg_body_ref, 6))})
        for n in names:
            use(libs[n])
            for label, kind, st, zh, dt in cases(n, grid, mode):
                if kind.startswith(("f32_", "f64_")):
                    out, again = (_flat(call(kind, st, zh, dt)()) for _ in range(2))
                    want = (f64_plain(kind[4:].split("|")[0], st) if kind.startswith("f64_")
                            else f32_plain(kind[4:], st))
                    if not (all(torch.equal(g, w) for g, w in zip(out, want))
                            and all(torch.equal(g, g2) for g, g2 in zip(out, again))):
                        raise SystemExit(f"{n} {grid} {label}: not bitwise equal to the "
                                         f"plain version, or not repeated")
                    continue
                if dt == torch.bfloat16:
                    for colour in (0, 1) if kind == "gs" else (0,):
                        out, again = (_flat(call(kind, st, zh, dt, colour)())
                                      for _ in range(2))
                        want = bf16_plain(kind, st, colour)
                        if not (all(torch.equal(g, w) for g, w in zip(out, want))
                                and all(torch.equal(g, g2) for g, g2 in zip(out, again))):
                            raise SystemExit(f"{n} {grid} {label} colour {colour}: not bitwise "
                                             f"equal to the plain version, or not repeated")
                    continue
                if kind == "gs":
                    for colour in (0, 1):
                        got = call(kind, st, zh, dt, colour)()
                        want = plain[(dt, st, colour)]
                        same = (torch.equal(got, want) if dt == torch.float64 else
                                torch.allclose(got, want, rtol=1e-5, atol=1e-5))
                        if not same or not torch.equal(got, call(kind, st, zh, dt, colour)()):
                            raise SystemExit(f"{n} {grid} {label} colour {colour}: not equal "
                                             f"to the plain version, or not repeated")
                    continue
                if kind in ("cg_body", "pcg_body"):
                    got, want = call(kind, st, zh, dt)(), plain[(kind, dt)]
                    same = all(torch.equal(g, w) if dt == torch.float64 else
                               torch.allclose(g, w, rtol=1e-5, atol=1e-5)
                               for g, w in zip(got, want))
                    if not same:
                        raise SystemExit(f"{n} {grid} {label}: not equal to the plain "
                                         f"version")
                    continue
                out = call(kind, st, zh)()
                y = out if kind == "spmv" else out[0]
                if not torch.equal(y, plain[st]):
                    raise SystemExit(f"{n} {grid} {label}: not bitwise equal to the plain "
                                     f"version")
        del plain
        rounds = {(n, label): [] for n in names for label, *_ in cases(n, grid, mode)}
        for rnd in range(ROUNDS):
            for n in names[::-1] if rnd % 2 else names:
                use(libs[n])
                for label, kind, st, zh, dt in cases(n, grid, mode):
                    rounds[(n, label)].append(ms(call(kind, st, zh, dt)))
        times = {f"{n} | {label}": statistics.median(v) for (n, label), v in rounds.items()}
        record["grids"][grid] = dict(shape=list(shape), ms=times, rounds={
            f"{n} | {label}": v for (n, label), v in rounds.items()})
        for key, t in times.items():
            print(f"[variants] {grid} {key}: {t:.4f} ms")
        del x, r, xp, half, vecs, xb, rb, xbp, lanes, lanes_p, lane_r, lane_d, db, bicg, omb, beb
        del x32, r32, x32p, d32, lanes32, d64, lanes64
    if args.record:
        Path(args.record).parent.mkdir(parents=True, exist_ok=True)
        Path(args.record).write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
