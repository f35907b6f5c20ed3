#!/usr/bin/env python3
"""How the plane-ring stencil pass's geometry moves its time.

    python3 chip_stencil_variants.py            # needs one CUDA card and nvcc
    python3 chip_stencil_variants.py --record PATH

Builds ``src/repro_torch/kernels/csrc/stencil_spmv.cu`` and ``spmv_dot.cu``
as they are and in variants, each a copy of ``csrc/`` with the ring pass's
constants of ``stencil.cuh`` changed (its (y, z) tile ``kRingY`` ×
``kRingZ``, its run of x-planes ``kRingRun``, its ring of ``kRingDepth``
plane tiles), with ``no_prefetch`` the tail's prefetch a step ahead
(``stencil_spmv_dots3``'s r) switched off, or, for ``stencil_kernel``,
``stencil_spmv.cu``'s SpMV and ``spmv_dot.cu``'s ``stencil_spmv_dots`` put
back on the old pass (one output per thread, 27 global loads a point; padded
operand only), all compiled in parallel into ``build/stencil_variants/``.
Each variant's ``ops.spmv`` (27pt and 7pt), ``ops.spmv_dots`` (27pt) and
``ops.spmv_dots3`` (27pt; not on the old pass) run in f64 at the rank block
128³ and the socket block 128×128×3072, from x unpadded (the zero halo made
in the kernel) and padded; every output must be bitwise equal to the plain
version's.  Times are CUDA events, median of ``--n`` launches, L2 flushed
before each by reading a 512 MiB buffer (as ``chip_smoke.py``'s ``Timer``),
the variants taken in turn twice (forward, then backward); a variant's time
is the median of both rounds.
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
from repro_torch.kernels import spmv_dot, stencil_spmv  # noqa: E402

OUT = ROOT / "build" / "stencil_variants"
GRIDS = {"rank": (128, 128, 128), "socket": (128, 128, 3072)}
#: variant -> the ring constants it changes
GEOMETRY = {
    "kernel": {},
    "no_prefetch": {},
    "depth4": {"kRingDepth": 4},
    "depth6": {"kRingDepth": 6},
    "run8": {"kRingRun": 8},
    "run32": {"kRingRun": 32},
    "y8": {"kRingY": 8},
    "z32_y8": {"kRingZ": 32, "kRingY": 8},
    "stencil_kernel": {},
}
#: variant -> [(file, anchor, replacement)] text switches
SWITCHES = {
    "no_prefetch": [("stencil.cuh", "if constexpr (prefetch_tail<Tail>::value) {",
                     "if constexpr (false) {")],
    "stencil_kernel": [("stencil_spmv.cu", "repro::launch_stencil_ring<T>(xi, zero_halo, ",
                        "repro::launch_stencil<T>(xi, "),
                       ("stencil_spmv.cu", "repro::stencil_ring_num_blocks(",
                        "repro::stencil_num_blocks("),
                       ("spmv_dot.cu",
                        "return repro::launch_stencil_ring<T>(static_cast<const T*>(x), "
                        "zero_halo,",
                        "return repro::launch_stencil<T>(static_cast<const T*>(x),"),
                       ("spmv_dot.cu", "long long spmv_dots_partials(int nx, int ny, int nz) {"
                        "\n  return repro::stencil_ring_num_blocks(",
                        "long long spmv_dots_partials(int nx, int ny, int nz) {"
                        "\n  return repro::stencil_num_blocks(")],
}
SOURCES = ("stencil_spmv", "spmv_dot")


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


def build(names) -> dict[str, dict[str, ctypes.CDLL]]:
    nvcc = _build._nvcc()
    procs = {}
    for n in names:
        out = write_variant(n)
        for src in SOURCES:
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
        sigs = stencil_spmv.SIGNATURES if src == "stencil_spmv" else spmv_dot.SIGNATURES
        for fn, (argtypes, restype) in sigs.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[n][src] = lib
        regs = sorted({int(m) for m in re.findall(r"Used (\d+) registers", log)})
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"[build] {n}/{src}: registers {regs}, spill stores "
              f"{sorted({int(s) for s in spills})}")
    return libs


def use(libs: dict[str, ctypes.CDLL]) -> None:
    """Route ``ops.spmv``/``ops.spmv_dots``/``ops.spmv_dots3`` to a variant's
    libraries."""
    for src, lib in libs.items():
        _build._LIBS[src] = lib


def cases(name: str):
    """(label, call) pairs a variant is timed on: the old pass takes only the
    padded operand and has no dots3 of its own."""
    out = []
    for form in ("zero_halo", "padded"):
        if name == "stencil_kernel" and form == "zero_halo":
            continue
        for st in ("27pt", "7pt"):
            out.append((f"spmv {st} {form}", "spmv", st, form == "zero_halo"))
        out.append((f"dots 27pt {form}", "dots", "27pt", form == "zero_halo"))
        if name != "stencil_kernel":
            out.append((f"dots3 27pt {form}", "dots3", "27pt", form == "zero_halo"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", default=None, metavar="PATH")
    ap.add_argument("--n", type=int, default=15, help="launches a time is the median of")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_stencil_variants: needs an NVIDIA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    print(card)
    names = tuple(GEOMETRY)
    libs = build(names)
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

    record = dict(card=card, geometry=GEOMETRY, grids={})
    gen = torch.Generator(device="cuda").manual_seed(9)
    for grid, shape in GRIDS.items():
        x, r = (torch.randn(shape, generator=gen, dtype=torch.float64, device="cuda")
                for _ in range(2))
        xp = pad1(x)

        def call(kind, st, zero_halo):
            opnd = x if zero_halo else xp
            if kind == "spmv":
                return lambda: ops.spmv(opnd, STENCILS[st], zero_halo=zero_halo)
            if kind == "dots":
                return lambda: ops.spmv_dots(opnd, STENCILS[st], zero_halo=zero_halo)
            return lambda: ops.spmv_dots3(opnd, r, STENCILS[st], zero_halo=zero_halo)

        plain = {st: ref.stencil_spmv_ref(xp, stencil=STENCILS[st]) for st in ("27pt", "7pt")}
        for n in names:
            use(libs[n])
            for label, kind, st, zh in cases(n):
                out = call(kind, st, zh)()
                y = out if kind == "spmv" else out[0]
                if not torch.equal(y, plain[st]):
                    raise SystemExit(f"{n} {grid} {label}: not bitwise equal to the plain "
                                     f"version")
        del plain
        rounds = {(n, label): [] for n in names for label, *_ in cases(n)}
        for order in (names, names[::-1]):
            for n in order:
                use(libs[n])
                for label, kind, st, zh in cases(n):
                    rounds[(n, label)].append(ms(call(kind, st, zh)))
        times = {f"{n} | {label}": statistics.median(v) for (n, label), v in rounds.items()}
        record["grids"][grid] = dict(shape=list(shape), ms=times)
        for key, t in times.items():
            print(f"[variants] {grid} {key}: {t:.4f} ms")
        del x, r, xp
    if args.record:
        Path(args.record).parent.mkdir(parents=True, exist_ok=True)
        Path(args.record).write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
