"""Which actions, taken while a CUDA graph is being captured in the default
("global") mode, invalidate that capture.

Each case runs in a process of its own (a spoiled capture can leave the
context unusable for the next one): an instantiated graph, a recorded event,
a pinned buffer and a tensor made on a side stream exist before the capture;
inside it the case destroys, queries or frees one of them, or another thread
makes an unsafe call.  ``gc_cycle`` is the port's case: a graph held only by
a reference cycle, freed by a collection of the cyclic garbage collector
inside the capture (``api/executable.py`` holds the collector off while it
captures, ``collector_held``).

    python3 chip_capture_probe.py            # every case; needs one card
    python3 chip_capture_probe.py CASE       # one case

Prints ``<case>: ok`` or ``<case>: FAIL <error>`` per case, then one JSON
object ``{"cases": {case: "ok" | error}}``.  Exits 1 without a card.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import threading

import torch

CASES = ("none", "graph_del", "gc_cycle", "event_del", "event_query", "pinned_del",
         "side_stream_tensor_del", "empty_cache", "other_thread_event_query",
         "other_thread_alloc", "other_thread_sync")


def run_case(case: str) -> str:
    dev = torch.device("cuda")
    x = torch.randn(1 << 22, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x * 2                                   # warm the kernel off the capture stream
    torch.cuda.current_stream().wait_stream(side)
    made, in_cycle = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    for g in (made, in_cycle):
        with torch.cuda.graph(g):
            x * 3 + 1
        g.replay()
    cycle = {"graph": in_cycle}
    cycle["self"] = cycle                       # freed only by the collector
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    pin = torch.empty(1 << 20, pin_memory=True)
    pin.copy_(x[: 1 << 20], non_blocking=True)
    with torch.cuda.stream(side):
        on_side = torch.randn(1 << 20, device=dev)
    on_side.record_stream(torch.cuda.current_stream())
    box = {"graph": made, "event": ev, "pinned": pin, "side": on_side}
    del g, made, in_cycle, ev, pin, on_side
    y = x.clone()
    for _ in range(200):                        # the card is busy during the capture
        y = y * 1.0000001 + 1e-9
    box["graph"].replay()
    box["cycle"] = cycle
    del cycle
    others = {"other_thread_event_query": lambda: box["event"].query(),
              "other_thread_alloc": lambda: torch.empty(1 << 28, device=dev),
              "other_thread_sync": torch.cuda.synchronize}
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            z = x * 5
            if case == "graph_del":
                del box["graph"]                # its last reference
            elif case == "gc_cycle":
                del box["cycle"]                # the cycle is garbage now
                gc.collect()
            elif case == "event_del":
                del box["event"]
            elif case == "event_query":
                box["event"].query()
            elif case == "pinned_del":
                del box["pinned"]
            elif case == "side_stream_tensor_del":
                del box["side"]
            elif case == "empty_cache":
                torch.cuda.empty_cache()
            elif case in others:
                t = threading.Thread(target=others[case])
                t.start()
                t.join()
            z + 1
        graph.replay()
        torch.cuda.synchronize()
        return "ok"
    except Exception as e:                      # noqa: BLE001 — the finding
        return f"{type(e).__name__}: {str(e).splitlines()[0]}"


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("chip_capture_probe: needs an NVIDIA card", file=sys.stderr)
        return 1
    if argv:
        print(json.dumps({argv[0]: run_case(argv[0])}))
        return 0
    out = {}
    for case in CASES:
        proc = subprocess.run([sys.executable, __file__, case], capture_output=True,
                              text=True, timeout=120)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        out[case] = (json.loads(lines[-1])[case] if lines
                     else f"exit {proc.returncode}: {proc.stderr.strip()[-300:]}")
        print(f"{case}: {'ok' if out[case] == 'ok' else 'FAIL ' + out[case]}", flush=True)
    print(json.dumps({"cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
