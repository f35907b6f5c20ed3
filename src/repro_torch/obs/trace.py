"""Zero-dependency structured tracing: spans, events and metric records.

The port's own copy of ``repro/obs/trace.py`` (the ``repro.obs/v1`` schema:
the same record kinds, keys and tag, so a trace of either package reads
with the other's tools; ``tests/test_torch_obs.py`` holds the two copies
together).  One schema for every record — facade solve spans, resilience
attempts, events and metric records — persisted as JSON lines so a trace
is greppable, appendable across processes, and machine-checkable
(``validate_stream``).  Aggregations (p50/p95/p99) are views over this
stream (:func:`summarize`).

Record kinds
------------
``span``   — a timed region: ``name``, monotonic ``t_start``/``t_end``/
             ``dur_s`` (``time.perf_counter``), wall-clock ``t_wall`` (for
             cross-process alignment), ``span_id`` + ``parent_id`` links,
             ``pid``/``tid``/``host``, free-form ``attrs``.
``event``  — a point-in-time fact: ``name``, ``t`` (monotonic), ``t_wall``,
             the enclosing ``span_id`` (or None), ids, ``attrs``.
``metric`` — a counter/gauge snapshot (heartbeats, snapshots):
             ``name``, ``t_wall``, ``host``, ``attrs``.

Activation
----------
Disabled by default at near-zero cost (one module-level check per span).
Enable programmatically (``enable(path)`` / ``disable()``) or via the
``REPRO_TRACE=PATH`` environment variable (checked lazily on first use;
``python -m repro_torch.launch.solve --trace PATH`` is the CLI spelling).
Files are opened in append mode: several commands can share one trace.
Span parents are tracked per-thread (``contextvars``), so a span opened on
another thread starts its own root.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import os
import platform
import threading
import time

#: the schema tag every record carries; bump on incompatible changes
SCHEMA = "repro.obs/v1"

#: required keys per record kind — the contract ``validate_record`` checks
REQUIRED_KEYS = {
    "span": ("schema", "kind", "name", "span_id", "parent_id",
             "t_start", "t_end", "dur_s", "t_wall", "pid", "tid", "host",
             "attrs"),
    "event": ("schema", "kind", "name", "t", "t_wall", "span_id",
              "pid", "tid", "host", "attrs"),
    "metric": ("schema", "kind", "name", "t_wall", "host", "attrs"),
}


class Tracer:
    """A thread-safe JSON-lines sink.  Construct via :func:`enable`."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._f = open(path, "a")
        self._lock = threading.Lock()
        self._ids = itertools.count(1)

    def next_id(self) -> str:
        return f"{os.getpid():x}-{next(self._ids):x}"

    def emit(self, rec: dict) -> None:
        line = json.dumps(rec)
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


_tracer: Tracer | None = None
_env_checked = False
_span_stack: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "repro_torch_obs_span", default=None)


def enable(path: str) -> Tracer:
    """Start emitting records to ``path`` (append mode)."""
    global _tracer, _env_checked
    disable()
    _env_checked = True      # an explicit enable/disable wins over REPRO_TRACE
    _tracer = Tracer(path)
    return _tracer


def disable() -> None:
    global _tracer, _env_checked
    _env_checked = True
    if _tracer is not None:
        _tracer.close()
        _tracer = None


def current() -> Tracer | None:
    """The active tracer, resolving ``REPRO_TRACE`` lazily on first use."""
    global _env_checked, _tracer
    if _tracer is None and not _env_checked:
        _env_checked = True
        path = os.environ.get("REPRO_TRACE")
        if path:
            _tracer = Tracer(path)
    return _tracer


def active() -> bool:
    return current() is not None


def _ids() -> dict:
    return {"pid": os.getpid(), "tid": threading.get_ident(),
            "host": platform.node()}


@contextlib.contextmanager
def span(name: str, **attrs):
    """Time a region: ``with span("solve", method="cg"): ...``.

    Yields the span id (``None`` when tracing is disabled — the only cost
    then is this one check).  The record is emitted on exit, carrying the
    parent span id of the enclosing ``span`` on this thread.
    """
    tr = current()
    if tr is None:
        yield None
        return
    sid = tr.next_id()
    parent = _span_stack.get()
    token = _span_stack.set(sid)
    t_wall = time.time()
    t0 = time.perf_counter()
    try:
        yield sid
    finally:
        t1 = time.perf_counter()
        _span_stack.reset(token)
        tr.emit({"schema": SCHEMA, "kind": "span", "name": name,
                 "span_id": sid, "parent_id": parent,
                 "t_start": t0, "t_end": t1, "dur_s": t1 - t0,
                 "t_wall": t_wall, **_ids(), "attrs": attrs})


def event(name: str, **attrs) -> dict | None:
    """Emit (and return) a point-in-time event record; None when disabled."""
    rec = make_event(name, **attrs)
    tr = current()
    if tr is not None:
        tr.emit(rec)
    return rec


def make_event(name: str, **attrs) -> dict:
    """Build an event record without requiring an active tracer."""
    return {"schema": SCHEMA, "kind": "event", "name": name,
            "t": time.perf_counter(), "t_wall": time.time(),
            "span_id": _span_stack.get(), **_ids(), "attrs": attrs}


def make_metric(name: str, *, host=None, **attrs) -> dict:
    """Build a metric record (a counter or gauge snapshot)."""
    return {"schema": SCHEMA, "kind": "metric", "name": name,
            "t_wall": time.time(),
            "host": platform.node() if host is None else host,
            "attrs": attrs}


def emit(rec: dict) -> None:
    """Forward a pre-built record to the active tracer (no-op when off)."""
    tr = current()
    if tr is not None:
        tr.emit(rec)


# -- reading / validation / views ---------------------------------------------

def read_trace(path: str) -> list[dict]:
    """Parse a JSONL trace; malformed lines raise (use ``validate_stream``
    for a non-throwing report)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def validate_record(rec: dict) -> list[str]:
    """Schema errors for one record ([] == valid)."""
    errs = []
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not an object"]
    kind = rec.get("kind")
    if kind not in REQUIRED_KEYS:
        return [f"unknown kind {kind!r}"]
    if rec.get("schema") != SCHEMA:
        errs.append(f"schema {rec.get('schema')!r} != {SCHEMA!r}")
    missing = [k for k in REQUIRED_KEYS[kind] if k not in rec]
    if missing:
        errs.append(f"{kind} record missing keys {missing}")
    if not isinstance(rec.get("attrs", {}), dict):
        errs.append("attrs is not an object")
    if kind == "span" and "dur_s" in rec and "t_start" in rec \
            and "t_end" in rec:
        if abs((rec["t_end"] - rec["t_start"]) - rec["dur_s"]) > 1e-6:
            errs.append("dur_s != t_end - t_start")
    return errs


def validate_stream(path: str) -> list[str]:
    """Every schema violation in a trace file, prefixed by line number."""
    errs: list[str] = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                errs.append(f"line {i}: not JSON ({e})")
                continue
            errs.extend(f"line {i}: {e}" for e in validate_record(rec))
    return errs


def _pcts(vals: list[float]) -> dict:
    import numpy as np
    if not vals:
        return {"p50_s": None, "p95_s": None, "p99_s": None}
    arr = np.asarray(vals)
    return {f"p{p}_s": float(np.percentile(arr, p)) for p in (50, 95, 99)}


def summarize(records: list[dict]) -> dict:
    """Aggregation view over a record stream: per-span-name count/total and
    latency percentiles, per-event-name counts, metric record counts."""
    spans: dict[str, list[float]] = {}
    events: dict[str, int] = {}
    metrics: dict[str, int] = {}
    for rec in records:
        # tolerate malformed records: summarize runs on streams --check has
        # not gated yet, so a missing key must not crash the report
        kind = rec.get("kind")
        name = rec.get("name", "<unnamed>")
        if kind == "span" and isinstance(rec.get("dur_s"), (int, float)):
            spans.setdefault(name, []).append(rec["dur_s"])
        elif kind == "event":
            events[name] = events.get(name, 0) + 1
        elif kind == "metric":
            metrics[name] = metrics.get(name, 0) + 1
    return {
        "records": len(records),
        "spans": {
            name: {"count": len(ds), "total_s": float(sum(ds)),
                   "max_s": float(max(ds)), **_pcts(ds)}
            for name, ds in sorted(spans.items())
        },
        "events": dict(sorted(events.items())),
        "metrics": dict(sorted(metrics.items())),
    }
