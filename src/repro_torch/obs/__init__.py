# Observability of the port (counterpart of repro.obs): structured spans and
# events on the repro.obs/v1 JSONL schema (the port's own copy, trace.py)
# and the host-side half of the per-iteration convergence telemetry
# (convergence.py; the device-side half is core.methods.Watch).  Only the
# zero-dependency trace surface is imported here, so span() stays near-free
# when tracing is off.  The reference's cost attribution (attribution.py,
# `python -m repro.obs attribute`) waits for the distributed solve and the
# analysis analogues (ROADMAP queue 1 items 10 and 13).
from repro_torch.obs.trace import (SCHEMA, Tracer, active, current, disable,
                                   emit, enable, event, make_event, make_metric,
                                   read_trace, span, summarize, validate_record,
                                   validate_stream)

__all__ = [
    "SCHEMA",
    "Tracer",
    "active",
    "current",
    "disable",
    "emit",
    "enable",
    "event",
    "make_event",
    "make_metric",
    "read_trace",
    "span",
    "summarize",
    "validate_record",
    "validate_stream",
]
