# The solver service (counterpart of repro.serve): continuous batching of a
# heterogeneous request stream over an LRU cache of pre-built executables
# (CUDA graphs of the lane-batched solve on the card), with SLO metrics and
# WAL-based preemption recovery.
from repro_torch.serve.cache import CacheEntry, ExecutableCache, session_for
from repro_torch.serve.metrics import PERCENTILES, ServeMetrics, scan_metrics
from repro_torch.serve.queue import (BucketKey, DTYPES, QueueFull, Request,
                               RequestQueue)
from repro_torch.serve.service import (ServeConfig, ServeReject, ServeResult,
                                 SolverService)
from repro_torch.serve.trace import (MIXED_BUCKETS, SMOKE_BUCKETS, TraceBucket,
                               generate_trace, replay)

__all__ = [
    "BucketKey",
    "CacheEntry",
    "DTYPES",
    "ExecutableCache",
    "MIXED_BUCKETS",
    "SMOKE_BUCKETS",
    "PERCENTILES",
    "QueueFull",
    "Request",
    "RequestQueue",
    "ServeConfig",
    "ServeMetrics",
    "ServeReject",
    "ServeResult",
    "SolverService",
    "TraceBucket",
    "generate_trace",
    "replay",
    "scan_metrics",
    "session_for",
]
