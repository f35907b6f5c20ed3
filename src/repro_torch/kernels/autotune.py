"""Persistent autotuner for the CUDA kernels' launch geometry and the
kernels-versus-plain crossover.

Counterpart of ``repro/kernels/autotune.py``, with the TPU's tiling knobs
replaced by what a launch can choose on this card:

* ``run``: the x-planes one block of the plane-ring stencil pass marches
  (``csrc/stencil.cuh``, ``RingRuns``: one kernel instance each) under
  ``stencil_spmv``, ``stencil_spmv_dots`` and ``stencil_spmv_dots3``.  The
  run sets the block count, and so the order in which the dot partials are
  summed: each run's scalars are bitwise reproducible, two runs' agree to
  rounding.
* the routing bit ``use_kernels``: whether the kernels beat their plain
  versions at this size.

The reference's second knob, ``br`` (the rows of a vector-update block),
has no counterpart here: the flat passes' block size (``kFlatThreads``) moved
merged CG's update pass by noise on the card, and a larger block slowed
merged PCG's (PERF.md §6, "the kernel autotuner").

``sweep`` measures both per ``(stencil, grid, dtype, device_kind)`` and
``tune`` persists the winner in a JSON cache (exact shapes, no fuzzy
matching).  ``resolve`` is the read side: ``SolverSession`` reads it once
(``SolverOptions(kernels=None)`` -> the routing bit; the run it hands its
``KernelOp``); a cache miss falls back to the static default table, so nothing ever
*requires* a tuning run:

  default table
  -------------
  use_kernels :  a CUDA device AND nx·ny·nz >= MIN_KERNEL_VOLUME; never on
                 the CPU (the plain versions run there either way)
  run         :  DEFAULT_RUN (16)

Cache file: ``$REPRO_TORCH_AUTOTUNE_CACHE`` or
``~/.cache/repro_torch/autotune.json``.
CLI: ``python -m repro_torch.kernels.autotune --grid 128 128 128 [--retune]
[--dtype bfloat16]`` (on the card; ``--device cpu`` times the plain versions
only); ``--smoke`` runs the two bounded configurations of ``SMOKE_CONFIGS``.
A bfloat16 sweep times the kernels' bf16 forms (bf16 in and out, f32
partials) and keys its entry ``…|bfloat16|<kind>``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import time
from pathlib import Path

import torch

#: the run the ring pass marches when nothing is tuned (``kRingRun``)
DEFAULT_RUN = 16
#: the runs a launch may pick (``csrc/stencil.cuh``'s ``RingRuns``)
RUN_CANDIDATES = (8, 16, 32)
#: the smallest grid at which the default table routes to the kernels.  Set
#: from chip_smoke.py's ``autotune`` phase on an NVIDIA H100 80GB HBM3 at
#: 700.00 W: graphed cg_merged, 27pt f64, warm ms/iter with kernels=True
#: against False was 0.2285 / 0.4718 at 8³, 0.0882 / 0.3137 at 16³,
#: 0.0975 / 0.2713 at 24³, 0.0950 / 0.2147 at 32³ and 0.0688 / 0.2921 at 64³.
#: The kernels won at every grid measured, so this is the smallest of them
#: (PERF.md §6, "the kernel autotuner").
MIN_KERNEL_VOLUME = 8 ** 3

#: the dtypes a sweep measures (``--dtype``); bfloat16 sweeps the kernels'
#: bf16 forms, which the solver facade does not run (it solves in f32/f64)
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}
_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"


@dataclasses.dataclass(frozen=True)
class TuneDecision:
    """What the kernel layer should do at one (stencil, grid, dtype) point.

    ``source`` is ``"default"`` (the
    static table) or ``"cache"`` (a persisted tuning run), carried into the
    session's ``resolve`` span so a silent fallback is visible.
    """

    use_kernels: bool
    run: int = DEFAULT_RUN
    source: str = "default"


def _device(device) -> torch.device:
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def device_kind(device=None) -> str:
    """``torch.cuda.get_device_name`` of a CUDA device, ``"cpu"`` otherwise
    (``None``: the current CUDA device if there is one)."""
    device = _device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def tune_key(stencil: str, grid, dtype, kind: str | None = None) -> str:
    """``"27pt|128x128x128|float64|NVIDIA H100 80GB HBM3"`` (``bfloat16``
    for a bf16 sweep): the four coordinates of one entry (``kind``:
    :func:`device_kind`'s)."""
    nx, ny, nz = grid
    kind = device_kind() if kind is None else kind
    return f"{stencil}|{nx}x{ny}x{nz}|{_dtype_name(dtype)}|{kind}"


def cache_path() -> Path:
    env = os.environ.get(_ENV)
    if env:
        return Path(env)
    return Path.home() / ".cache" / "repro_torch" / "autotune.json"


_CACHE: tuple[Path, int, dict] | None = None


def load_cache(path: Path | None = None) -> dict:
    """The persisted tune table, memoised on (path, mtime); a missing or
    corrupt file reads as ``{}``."""
    global _CACHE
    path = cache_path() if path is None else Path(path)
    try:
        mtime = path.stat().st_mtime_ns
    except OSError:
        return {}
    if _CACHE is not None and _CACHE[0] == path and _CACHE[1] == mtime:
        return _CACHE[2]
    try:
        table = json.loads(path.read_text())
    except (OSError, ValueError):
        return {}
    if not isinstance(table, dict):
        return {}
    _CACHE = (path, mtime, table)
    return table


def save_cache(table: dict, path: Path | None = None) -> Path:
    global _CACHE
    path = cache_path() if path is None else Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(table, indent=2, sort_keys=True) + "\n")
    _CACHE = None
    return path


def default_decision(grid, device=None) -> TuneDecision:
    """The documented static fallback (no cache entry, no tuning run)."""
    nx, ny, nz = grid
    on = _device(device).type == "cuda" and nx * ny * nz >= MIN_KERNEL_VOLUME
    return TuneDecision(use_kernels=on)


def resolve(stencil: str, grid, dtype, device=None, *,
            path: Path | None = None) -> TuneDecision:
    """Cache lookup with default-table fallback (the KernelOp/session read)."""
    kind = device_kind(device)
    entry = load_cache(path).get(tune_key(stencil, tuple(grid), dtype, kind))
    if entry is None:
        return default_decision(tuple(grid), device)
    return TuneDecision(use_kernels=bool(entry["use_kernels"]), run=int(entry["run"]),
                        source="cache")


# ---------------------------------------------------------------- measurement

class _CardTimer:
    """CUDA-event time of one call, median of ``repeats``, with the 50 MB L2
    flushed before each launch by *reading* a 512 MiB buffer (a flush that
    writes leaves dirty lines for the timed call to write back)."""

    def __init__(self, device: torch.device, repeats: int):
        self.repeats = repeats
        self.flush = torch.ones(128 << 20, dtype=torch.float32, device=device)

    def __call__(self, fn) -> float:
        fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(self.repeats):
            self.flush.sum()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events) / 1e3


def _host_time(fn, repeats: int) -> float:
    """min-of-repeats wall seconds of ``fn()`` on the CPU (first call excluded)."""
    fn()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def sweep(grid, stencil: str = "7pt", dtype=torch.float32, device="cuda", *,
          repeats: int = 3) -> dict:
    """Measure the run winner and the kernels-versus-plain
    crossover at one point; returns a JSON-ready cache entry.

    On a CUDA device: ``run`` over :data:`RUN_CANDIDATES` on ``ops.spmv_dots``
    in its zero-halo form (merged CG's SpMV pass), and the tuned pass against
    its plain version ``ref.stencil_spmv_dots_ref`` on the same card
    tensors, each by CUDA events with L2 flushed.  On the CPU there are no
    tiles: only the plain version is timed, and the entry keeps the default
    ``run`` with ``use_kernels = False``.  The entry records
    ``backend`` (the key already pins the device kind)."""
    from repro_torch.core.operators import STENCILS, pad1
    from repro_torch.kernels import ops, ref

    device = torch.device(device)
    st = STENCILS[stencil]
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(tuple(grid), generator=gen, dtype=dtype, device=device)

    def plain():
        return ref.stencil_spmv_dots_ref(pad1(x), stencil=st)

    if device.type != "cuda":
        return {"use_kernels": False, "run": DEFAULT_RUN, "backend": device.type,
                "timings": {"run": {}, "kernel_s": None,
                            "plain_s": _host_time(plain, repeats)}}
    timer = _CardTimer(device, repeats)
    run_s = {r: timer(lambda r=r: ops.spmv_dots(x, st, zero_halo=True, run=r))
             for r in RUN_CANDIDATES}
    best_run = min(run_s, key=run_s.get)
    kernel_s, plain_s = run_s[best_run], timer(plain)
    return {
        "use_kernels": bool(kernel_s <= plain_s),
        "run": int(best_run),
        "backend": device.type,
        "timings": {"run": {str(k): v for k, v in run_s.items()},
                    "kernel_s": kernel_s, "plain_s": plain_s},
    }


def tune(grid, stencil: str = "7pt", dtype=torch.float32, device="cuda", *,
         path: Path | None = None, retune: bool = False,
         repeats: int = 3) -> TuneDecision:
    """Sweep-and-persist (skipped if already cached, unless ``retune``)."""
    key = tune_key(stencil, tuple(grid), dtype, device_kind(device))
    table = dict(load_cache(path))
    if key not in table or retune:
        table[key] = sweep(grid, stencil, dtype, device, repeats=repeats)
        save_cache(table, path)
    return resolve(stencil, grid, dtype, device, path=path)


SMOKE_CONFIGS = (((16, 16, 16), "7pt"), ((32, 32, 32), "7pt"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, nargs=3, default=(32, 32, 32))
    ap.add_argument("--stencil", choices=("7pt", "27pt"), default="7pt")
    ap.add_argument("--dtype", choices=sorted(_DTYPES), default="float32")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; times the kernels) or cpu (the "
                         "plain versions only)")
    ap.add_argument("--cache", type=Path, default=None,
                    help=f"cache file (default: ${_ENV} or "
                         f"~/.cache/repro_torch/autotune.json)")
    ap.add_argument("--retune", action="store_true",
                    help="re-measure even if the key is already cached")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--smoke", action="store_true",
                    help="bounded sweep over the two smoke configurations")
    args = ap.parse_args(argv)

    dtype = _DTYPES[args.dtype]
    configs = SMOKE_CONFIGS if args.smoke else ((tuple(args.grid), args.stencil),)
    for grid, stencil in configs:
        dec = tune(grid, stencil, dtype, args.device, path=args.cache,
                   retune=args.retune, repeats=args.repeats)
        print(f"{tune_key(stencil, grid, dtype, device_kind(args.device))}: "
              f"use_kernels={dec.use_kernels} run={dec.run} "
              f"[{dec.source}]")
    print(f"cache: {args.cache or cache_path()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
