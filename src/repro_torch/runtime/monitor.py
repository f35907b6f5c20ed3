"""Heartbeat / straggler monitoring and failure injection (the port's copy
of ``repro/runtime/monitor.py``).

  * ``Heartbeat`` — per-step wall-time records with robust outlier detection
    (median + MAD); each host reports its step time into a shared store (a
    directory of per-host files, ``write_host_heartbeat``), which the
    coordinator reads with ``scan_hosts``.  A heartbeat file is one
    ``repro.obs/v1`` metric record (``repro_torch.obs``), the schema the
    serve metrics and every trace span use, so either package's scan reads
    the other's files.
  * ``FailureInjector`` — deterministic fault scheduling: the duck-typed hook
    surface the serve layer (``repro_torch.serve``) calls and the chaos
    harness (``repro_torch.resilience.inject.ChaosInjector``) extends:
    ``maybe_fail(step)`` at dispatch points and ``maybe_fail_compile(key)``
    at build points.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from dataclasses import dataclass, field


@dataclass
class Heartbeat:
    window: int = 50
    straggler_factor: float = 3.0
    times: deque = field(default_factory=lambda: deque(maxlen=256))
    _last: float | None = None

    def tick(self) -> dict:
        now = time.monotonic()
        if self._last is None:
            # cold start: no interval yet; a well-formed record all the same
            self._last = now
            return {"step_time": None, "straggler": False, "warmup": True}
        dt = now - self._last
        self.times.append(dt)
        self._last = now
        return self.check(dt)

    def check(self, dt: float) -> dict:
        if len(self.times) < 8:
            return {"step_time": dt, "straggler": False}
        xs = sorted(self.times)
        med = xs[len(xs) // 2]
        mad = sorted(abs(x - med) for x in xs)[len(xs) // 2]
        # identical samples give mad == 0 (and med may be 0): floor the
        # spread so that dt == med is never flagged
        spread = max(mad, 0.05 * med, 1e-9)
        threshold = med + self.straggler_factor * spread
        return {
            "step_time": dt,
            "median": med,
            "mad": mad,
            "straggler": dt > threshold,
        }


def write_host_heartbeat(directory: str, host_id: int, step: int,
                         step_time: float) -> None:
    """One per-host heartbeat record: a ``repro.obs/v1`` metric record
    (``name="heartbeat"``, step and step_time in ``attrs``) in
    ``directory/host_<id>.json``, also forwarded to the active trace."""
    from repro_torch.obs import trace as obs

    os.makedirs(directory, exist_ok=True)
    rec = obs.make_metric("heartbeat", host=host_id, step=step,
                          step_time=step_time)
    obs.emit(rec)
    with open(os.path.join(directory, f"host_{host_id}.json"), "w") as f:
        json.dump(rec, f)


def _read_heartbeat(path: str) -> dict:
    """``{host, step, t, step_time}`` from a heartbeat file: a schema record
    or the older flat shape."""
    with open(path) as f:
        rec = json.load(f)
    if rec.get("schema", "").startswith("repro.obs/"):
        a = rec["attrs"]
        return {"host": rec["host"], "step": a["step"], "t": rec["t_wall"],
                "step_time": a.get("step_time")}
    return rec


def scan_hosts(directory: str, timeout_s: float = 60.0) -> dict:
    """Coordinator side: which hosts are alive, dead, and how far each got."""
    now = time.time()
    alive, dead, steps = [], [], {}
    if not os.path.isdir(directory):
        return {"alive": [], "dead": [], "min_step": None}
    for fn in os.listdir(directory):
        if not fn.startswith("host_"):
            continue
        rec = _read_heartbeat(os.path.join(directory, fn))
        (alive if now - rec["t"] < timeout_s else dead).append(rec["host"])
        steps[rec["host"]] = rec["step"]
    return {
        "alive": sorted(alive),
        "dead": sorted(dead),
        "min_step": min(steps.values()) if steps else None,
        "max_step": max(steps.values()) if steps else None,
    }


class FailureInjector:
    """Raises ``SimulatedFailure`` at the configured step (tests/examples).

    ``maybe_fail(step)`` is the dispatch hook and ``maybe_fail_compile(key)``
    the build hook; the base injector never fails a build."""

    def __init__(self, fail_at_step: int | None):
        self.fail_at_step = fail_at_step
        self.fired = False

    def maybe_fail(self, step: int) -> None:
        if (self.fail_at_step is not None and step == self.fail_at_step
                and not self.fired):
            self.fired = True
            raise SimulatedFailure(f"injected failure at step {step}")

    def maybe_fail_compile(self, key) -> None:
        """Hook point before a build keyed by ``key`` (a solve shape, ...).
        No-op here; chaos injectors override it."""


class SimulatedFailure(RuntimeError):
    pass


class DeviceLost(RuntimeError):
    """A device dropped out mid-run (the chaos harness raises it
    deterministically).  The serve layer drops every resident executable
    and replays the in-flight batch from its journal."""
