#!/usr/bin/env python3
"""What the serve layer's device lock prevents, on one NVIDIA card.

    python3 chip_serve_lock.py [--record PATH]

``repro_torch.serve.SolverService`` holds one lock over a build's
``compile_batched`` (an eager warm-up step and the capture of the bucket's
CUDA graphs, on the build thread) and over a dispatch's device work (the
batch's upload, ``solve_batched``, the synchronize, the copies to the
host, on the scheduler thread).  This script replays ``chip_smoke.py``'s
serve stream (``SERVE_BUCKETS``: six buckets of 10 requests at 128³ f64,
B = 4, ``kernels=True``, builds on the background thread) twice: with the
lock (``locked``), then with the lock replaced by one that never waits
(``unlocked``), so builds capture while dispatches run.  For each it prints
the requests served and rejected (by reason), the error that stopped the
replay if one did, the wall time of the stream, and whether each served
result is bitwise the locked stream's.  It checks nothing: the locked
stream is ``chip_smoke.py``'s to check.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import (SERVE_BUCKETS, SERVE_CONFIG, fresh,  # noqa: E402
                        same_served)
from repro_torch.serve import (ServeConfig, SolverService, generate_trace,  # noqa: E402
                               replay)


class NoLock:
    """A lock that never waits."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def stream(trace, locked: bool) -> dict:
    svc = SolverService(ServeConfig(**SERVE_CONFIG))
    if not locked:
        svc._device_lock = NoLock()
    error = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        replay(svc, trace, chunk=4)
        torch.cuda.synchronize()
    except Exception as e:                       # noqa: BLE001 (reported, not handled)
        error = f"{type(e).__name__}: {e}"
        traceback.print_exc()
    wall = time.perf_counter() - t0
    try:
        svc.close()
    except Exception as e:                       # noqa: BLE001
        error = error or f"close: {type(e).__name__}: {e}"
    rej = svc.rejects()
    reasons = {}
    for r in rej.values():
        reasons[r.reason] = reasons.get(r.reason, 0) + 1
    results = {i: svc.results()[r.id] for i, r in enumerate(trace)
               if r.id is not None and r.id in svc.results()}
    details = sorted({r.detail[:300] for r in rej.values()})
    return dict(served=len(results), rejected=len(rej), reasons=reasons,
                reject_details=details, error=error, wall_s=wall,
                waits_ms=[d["wait_s"] * 1e3 for d in svc.dispatch_log if d["compiling"]],
                misses=svc.cache.stats()["misses"], results=results)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", default=None, metavar="PATH")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_serve_lock: needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    trace = generate_trace(SERVE_BUCKETS, seed=0)
    out = {}
    for name, locked in (("locked", True), ("unlocked", False)):
        rec = stream(fresh(trace), locked)
        if name == "unlocked":
            base = out["locked"].pop("results")
            rec["bitwise_locked"] = sum(
                1 for i, r in rec["results"].items() if i in base and same_served(r, base[i]))
        out[name] = rec
        print(f"[serve-lock] {name}: served {rec['served']}/{len(trace)}, rejected "
              f"{rec['rejected']} {rec['reasons']}, misses {rec['misses']}, wall "
              f"{rec['wall_s']:.4f}s, waits on a build {len(rec['waits_ms'])}, error "
              f"{rec['error']}, bitwise the locked stream "
              f"{rec.get('bitwise_locked', '-')}; reject details {rec['reject_details']}")
    out["unlocked"].pop("results")
    out["card"] = smi
    if args.record:
        Path(args.record).parent.mkdir(parents=True, exist_ok=True)
        Path(args.record).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: {kk: vv for kk, vv in v.items() if kk != "reject_details"}
                      if isinstance(v, dict) else v for k, v in out.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
