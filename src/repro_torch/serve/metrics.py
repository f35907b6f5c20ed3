"""SLO metrics for the solver service (the port's copy of
``repro/serve/metrics.py``): latency percentiles, sustained QPS, queue
depth, per-bucket compile time.

Latency is end-to-end (admission -> result committed), which is what a
client experiences: queue wait + any compile the request was unlucky
enough to trigger + solve time.  Sustained QPS is completions over the
span from first admission to last completion — the number a capacity
plan can use, not a burst peak.

Every ``record_*`` call builds one ``repro.obs/v1`` *event* record
(``serve.admit`` / ``serve.complete`` / ``serve.queue_depth`` /
``serve.preempt`` / ``serve.reject`` / ``serve.retry`` /
``serve.device_loss``) through ``repro_torch.obs.trace.make_event``, keeps
it in memory, and forwards it to the active trace (``emit``), so a traced
run of the service and the numbers it prints come from the same stream.
The counters and percentiles are views over those events; the percentiles
go through the helper ``repro_torch.obs.trace.summarize`` uses, and
``snapshot()`` has the reference's key set.

``write()`` persists a snapshot as ``metrics_<name>.json`` (the per-host
record idiom of ``runtime/monitor.py``) and ``scan_metrics`` is the
coordinator-side reader; both readers accept untagged records
(``load_record``).
"""

from __future__ import annotations

import json
import os
import time

from repro_torch.obs import trace as obs

#: the SLO percentiles every snapshot reports (those of ``obs.trace._pcts``)
PERCENTILES = (50, 95, 99)


def load_record(rec: dict) -> dict:
    """Back-compat reader: normalise a metrics/heartbeat record written
    before the unified schema (no ``schema`` key) into the tagged shape.
    Already-tagged records pass through unchanged."""
    if "schema" in rec:
        return rec
    out = dict(rec)
    out["schema"] = f"{obs.SCHEMA}+legacy"
    if "t_wall" not in out and "t" in out:
        out["t_wall"] = out["t"]
    return out


class ServeMetrics:
    def __init__(self):
        self._events: list[dict] = []     # repro.obs/v1 event records
        self.rejected = 0
        self._t_first_submit: float | None = None
        self._t_last_done: float | None = None

    # -- recording (each call = one schema event, forwarded to the trace) -----
    def _record(self, name: str, **attrs) -> None:
        rec = obs.make_event(name, **attrs)
        self._events.append(rec)
        obs.emit(rec)

    def record_submit(self, now: float, *, bucket: str | None = None,
                      rid: int | None = None) -> None:
        if self._t_first_submit is None:
            self._t_first_submit = now
        self._record("serve.admit", bucket=bucket, id=rid)

    def record_completion(self, bucket: str, latency_s: float,
                          now: float) -> None:
        self._t_last_done = now
        self._record("serve.complete", bucket=bucket, latency_s=latency_s)

    def record_queue_depth(self, depth: int) -> None:
        self._record("serve.queue_depth", depth=depth)

    def record_preemption(self, n_requeued: int) -> None:
        self._record("serve.preempt", requeued=n_requeued)

    def record_reject(self, bucket: str, reason: str, *,
                      rid: int | None = None) -> None:
        """A service-level reject (compile_failed / deadline / poisoned) —
        distinct from ``rejected``, which counts admission-time refusals."""
        self._record("serve.reject", bucket=bucket, reason=reason, id=rid)

    def record_retry(self, bucket: str, attempt: int,
                     backoff_s: float) -> None:
        self._record("serve.retry", bucket=bucket, attempt=attempt,
                     backoff_s=backoff_s)

    def record_device_loss(self, n_lost: int, survivors: int | None) -> None:
        self._record("serve.device_loss", lost=n_lost, survivors=survivors)

    # -- views over the event stream ------------------------------------------
    def events(self) -> list[dict]:
        """The raw schema-tagged event records (what a trace would hold)."""
        return list(self._events)

    def _named(self, name: str) -> list[dict]:
        return [e for e in self._events if e["name"] == name]

    @property
    def completed(self) -> int:
        return len(self._named("serve.complete"))

    @property
    def preemptions(self) -> int:
        return len(self._named("serve.preempt"))

    @property
    def service_rejects(self) -> int:
        return len(self._named("serve.reject"))

    @property
    def retries(self) -> int:
        return len(self._named("serve.retry"))

    @property
    def device_losses(self) -> int:
        return len(self._named("serve.device_loss"))

    @property
    def requeued(self) -> int:
        return sum(e["attrs"]["requeued"] for e in self._named("serve.preempt"))

    @staticmethod
    def _pcts(lats: list[float]) -> dict[str, float]:
        return obs._pcts(lats)

    def qps(self) -> float | None:
        """Sustained throughput: completions / (first submit -> last done)."""
        if self.completed == 0 or self._t_first_submit is None:
            return None
        span = self._t_last_done - self._t_first_submit
        return self.completed / max(span, 1e-9)

    def snapshot(self, *, cache_stats: dict | None = None,
                 queue_depth: int | None = None) -> dict:
        lats = [e["attrs"]["latency_s"] for e in self._named("serve.complete")]
        by_bucket: dict[str, list[float]] = {}
        for e in self._named("serve.complete"):
            by_bucket.setdefault(e["attrs"]["bucket"], []).append(
                e["attrs"]["latency_s"])
        depths = [e["attrs"]["depth"] for e in self._named("serve.queue_depth")]
        rec = {
            "schema": obs.SCHEMA,
            "t": time.time(),
            "completed": self.completed,
            "preemptions": self.preemptions,
            "requeued": self.requeued,
            "rejected": self.rejected,
            "service_rejects": self.service_rejects,
            "rejects_by_reason": {
                r: sum(1 for e in self._named("serve.reject")
                       if e["attrs"]["reason"] == r)
                for r in sorted({e["attrs"]["reason"]
                                 for e in self._named("serve.reject")})},
            "retries": self.retries,
            "device_losses": self.device_losses,
            "qps": self.qps(),
            "queue_depth": queue_depth,
            "queue_depth_max": max(depths) if depths else 0,
            **self._pcts(lats),
            "per_bucket": {
                b: {"served": len(ls), **self._pcts(ls)}
                for b, ls in sorted(by_bucket.items())
            },
        }
        if cache_stats is not None:
            rec["cache"] = cache_stats
        return rec

    def write(self, directory: str, *, name: str = "serve",
              **snapshot_kw) -> str:
        """Persist a snapshot as ``directory/metrics_<name>.json`` (the
        monitor.py per-host-record idiom)."""
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"metrics_{name}.json")
        with open(path, "w") as f:
            json.dump(self.snapshot(**snapshot_kw), f, indent=2)
        return path


def scan_metrics(directory: str) -> dict[str, dict]:
    """Coordinator-side reader for ``ServeMetrics.write`` records; accepts
    pre-schema (untagged) files via :func:`load_record`."""
    out = {}
    if not os.path.isdir(directory):
        return out
    for fn in sorted(os.listdir(directory)):
        if fn.startswith("metrics_") and fn.endswith(".json"):
            with open(os.path.join(directory, fn)) as f:
                out[fn[len("metrics_"):-len(".json")]] = load_record(
                    json.load(f))
    return out
