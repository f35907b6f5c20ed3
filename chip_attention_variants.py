#!/usr/bin/env python3
"""What binds the 3xTF32 attention body: time it with parts switched off.

    python3 chip_attention_variants.py            # needs one CUDA card and nvcc
    python3 chip_attention_variants.py --record PATH

Builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` as it is and in
variants, each a copy with one text switch applied to the 3xTF32 body
(``flash_f32_tf32x3_kernel``), all compiled in parallel into
``build/attention_variants/``, and times ``flash_attention_f32`` of each at
the f32 attention cases of ``chip_smoke.py`` (internlm2-1.8b: 16 heads of
128, causal; hymba-1.5b: 25 heads of 64, window 2048; S = 4096):

* ``kernel``: the source as it is;
* ``cvt``: TF32 rounding by ``cvt.rna.tf32.f32`` in place of the two
  integer instructions of ``hopper::tf32_rna`` (the same values);
* ``no_s``: no S product (the scores stay 0); ``s_hihi``: its hi·hi product
  only;
* ``no_pv``: no PV product;
* ``no_softmax``: no max, exp or rescale (p = the raw scores);
* ``no_stores``: the producer loads and splits each tile but writes nothing;
* ``producer_only``: no products and no softmax: the producer and the
  handoffs alone.

Only ``kernel`` and ``cvt`` compute attention; both are held to the f32 rule
(rtol 1e-4, atol 1e-5 against ``kernels.ref.flash_attention_ref``, TF32 off).
The others time what is left.  Times are CUDA events, median of ``--n``
launches, the 50 MB L2 flushed before each, the variants taken in turn twice
(forward, then backward); a variant's time is the median of both rounds.
A switch whose anchor text is missing from the source fails the run.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

OUT = ROOT / "build" / "attention_variants"
#: the f32 cases of chip_smoke.py's ATTENTION
CASES = {"internlm2-1.8b": dict(B=1, S=4096, H=16, hd=128, window=0),
         "hymba-1.5b": dict(B=1, S=4096, H=25, hd=64, window=2048)}

_S_PRODUCTS = """          hopper::wgmma_m64n32k8_tf32_ss(s, al, bh, 1);
          hopper::wgmma_m64n32k8_tf32_rs(s, qh[kk], bl, 1);
          hopper::wgmma_m64n32k8_tf32_rs(s, qh[kk], bh, 1);"""
_PV_64 = """            hopper::wgmma_m64n64k8_tf32_rs(acc, pl[kt], bh, 1);
            hopper::wgmma_m64n64k8_tf32_rs(acc, ph[kt], bl, 1);
            hopper::wgmma_m64n64k8_tf32_rs(acc, ph[kt], bh, 1);"""
_PV_128 = _PV_64.replace("m64n64k8", "m64n128k8")
_SOFTMAX_START = """        // the mask only where some pair of the warpgroup's rows is not kept"""
_SOFTMAX_END = """          acc[4 * n + 3] *= al1;
        }
"""
_K_STORE = """        *reinterpret_cast<uint4*>(kst + off) = hi;
        *reinterpret_cast<uint4*>(kst + kK + off) = lo;"""
_V_STORE = """          *reinterpret_cast<uint4*>(vst + off) = hi;
          *reinterpret_cast<uint4*>(vst + kV + off) = lo;"""
_RNA = "  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;"

_CVT = '  uint32_t y;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));\n  return y;'
# the stores go; the split stays live through a test no value passes
_K_NO_STORE = "        if (hi.x == 1u && lo.y == 1u && hi.z == 1u && lo.w == 1u) kst[p] = 1;"
_V_NO_STORE = "          if (hi.y == 1u && lo.z == 1u && hi.w == 1u && lo.x == 1u) vst[p] = 1;"
_FA = "flash_attention.cu"

#: switch -> [(file, anchor, replacement)]
SWITCHES = {
    "cvt": [("hopper.cuh", _RNA, _CVT)],
    "no_s": [(_FA, _S_PRODUCTS, "")],
    "s_hihi": [(_FA, _S_PRODUCTS, "          hopper::wgmma_m64n32k8_tf32_rs(s, qh[kk], bh, 1);")],
    "no_pv": [(_FA, _PV_64, ""), (_FA, _PV_128, "")],
    "no_softmax": [(_FA, _SOFTMAX_START,
                    "        l0 += s[0];\n        l1 += s[2];\n        if (false) {\n"
                    + _SOFTMAX_START),
                   (_FA, _SOFTMAX_END, _SOFTMAX_END + "        }\n")],
    "no_stores": [(_FA, _K_STORE, _K_NO_STORE), (_FA, _V_STORE, _V_NO_STORE)],
}
SWITCHES["producer_only"] = SWITCHES["no_s"] + SWITCHES["no_pv"] + SWITCHES["no_softmax"]
VARIANTS = ("kernel", "cvt", "no_s", "s_hihi", "no_pv", "no_softmax", "no_stores",
            "producer_only")
#: the variants that still compute attention
EXACT = ("kernel", "cvt")


def write_variant(name: str) -> Path:
    """csrc copied to OUT/name with the variant's switches applied."""
    out = OUT / name
    out.mkdir(parents=True, exist_ok=True)
    texts = {f: (_build.CSRC / f).read_text() for f in ("flash_attention.cu", "hopper.cuh")}
    for fname, anchor, repl in SWITCHES.get(name, []):
        if anchor not in texts[fname]:
            raise SystemExit(f"{name}: anchor missing from {fname}:\n{anchor}")
        texts[fname] = texts[fname].replace(anchor, repl, 1)
    for fname, text in texts.items():
        (out / fname).write_text(text)
    return out / "flash_attention.cu"


def build(names) -> dict[str, ctypes.CDLL]:
    nvcc = _build._nvcc()
    procs = {n: subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-o", str(OUT / n / "lib.so"),
                                  str(write_variant(n))],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for n in names}
    fns = {}
    for n, proc in procs.items():
        log, _ = proc.communicate()
        (OUT / n / "ptxas.log").write_text(log)
        if proc.returncode:
            raise SystemExit(f"{n}: build failed\n{log[-4000:]}")
        f = ctypes.CDLL(str(OUT / n / "lib.so")).flash_attention_f32
        f.argtypes, f.restype = fa.SIGNATURES["flash_attention_f32"]
        fns[n] = f
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", default=None, metavar="PATH")
    ap.add_argument("--n", type=int, default=15, help="launches a time is the median of")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_attention_variants: needs an NVIDIA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = build(VARIANTS)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch(f, q, k, v, o, cfg):
        err = f(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), cfg["B"], cfg["S"],
                cfg["H"], cfg["hd"], cfg["window"], cfg["hd"] ** -0.5, stream)
        _build.check(err, "flash_attention")

    def ms(f, q, k, v, o, cfg):
        times = []
        for _ in range(args.n):
            flush.zero_()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            launch(f, q, k, v, o, cfg)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    record = dict(card=card, cases={})
    gen = torch.Generator(device="cuda").manual_seed(2)
    for case, cfg in CASES.items():
        shape = (cfg["B"], cfg["S"], cfg["H"], cfg["hd"])
        q, k, v = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
        o = torch.empty_like(q)
        plain = ref.flash_attention_ref(q, k, v, window=cfg["window"])
        errs = {}
        for n in EXACT:
            launch(fns[n], q, k, v, o, cfg)
            torch.cuda.synchronize()
            errs[n] = float((o - plain).abs().max())
            if not torch.allclose(o, plain, rtol=1e-4, atol=1e-5):
                raise SystemExit(f"{case} {n}: max err {errs[n]} against the plain version")
        del plain
        rounds = {n: [] for n in VARIANTS}
        for order in (VARIANTS, VARIANTS[::-1]):
            for n in order:
                launch(fns[n], q, k, v, o, cfg)     # warm
                rounds[n].append(ms(fns[n], q, k, v, o, cfg))
        times = {n: statistics.median(r) for n, r in rounds.items()}
        record["cases"][case] = dict(**cfg, ms=times, rounds=rounds, max_abs_err=errs)
        print(f"[variants] {case}: " + " ".join(f"{n}={t:.4f}" for n, t in times.items())
              + " ms; max_abs_err " + " ".join(f"{n}={e:.3e}" for n, e in errs.items()))
    if args.record:
        Path(args.record).parent.mkdir(parents=True, exist_ok=True)
        Path(args.record).write_text(json.dumps(record, indent=1))
    print(json.dumps(record["cases"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
