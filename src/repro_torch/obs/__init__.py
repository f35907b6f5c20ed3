# Observability of the port (counterpart of repro.obs): structured spans and
# events on the repro.obs/v1 JSONL schema (the port's own copy, trace.py)
# and the host-side half of the per-iteration convergence telemetry
# (convergence.py; the device-side half is core.methods.Watch), and the
# measured cost attribution of an iteration's phases on a mesh of ranks
# (attribution.py, `python -m repro_torch.obs attribute`; its predicted
# column waits for an H100 cost model, ROADMAP queue 1 item 12b).  Only the
# zero-dependency trace surface is imported here, so span() stays near-free
# when tracing is off.
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
