"""Mixed-workload trace generation + replay (the port's copy of
``repro/serve/trace.py``).

A trace is a deterministic, interleaved stream of heterogeneous requests
— the workload the service exists for (one homogeneous burst would just
be ``solve_batched``).  ``MIXED_BUCKETS`` is the reference's fixed mix:
two grids x two methods, one of them preconditioned, so the stream
exercises bucketing, padding, warm-cache reuse and compile-then-admit in
one pass.  The payloads come from the same seeded numpy ``default_rng`` in
the same order as the reference's, so a seed gives both packages the same
requests, bit for bit.

Replay interleaves submission with scheduling steps (a request stream,
not an offline batch): ``chunk`` requests are admitted, then one
``step()`` runs, until the trace is exhausted; the service then drains.
Everything is seeded — the same trace replayed twice produces bitwise-
identical results.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serve.queue import Request
from repro_torch.serve.service import ServeResult, SolverService


@dataclasses.dataclass(frozen=True)
class TraceBucket:
    """``count`` requests for one bucket, payloads drawn from the trace's
    seeded RNG."""

    grid: tuple[int, int, int]
    method: str
    stencil: str = "27pt"
    precond: str = "none"
    precond_params: tuple = ()      # frozen dict items, hashable
    dtype: str = "f64"
    count: int = 8
    tol: float = 1e-8
    maxiter: int = 500
    norm_ref: float | None = 1.0


#: the reference heterogeneous mix (>= 4 distinct buckets: two grids x
#: two methods, one preconditioned)
MIXED_BUCKETS = (
    TraceBucket(grid=(12, 12, 12), method="cg", stencil="27pt"),
    TraceBucket(grid=(16, 16, 16), method="cg", stencil="7pt"),
    TraceBucket(grid=(12, 12, 12), method="bicgstab_b1", stencil="27pt"),
    TraceBucket(grid=(16, 16, 16), method="pcg", stencil="27pt",
                precond="jacobi", precond_params=(("sweeps", 2),)),
)

#: the same mix shrunk to tiny grids and modest counts (``launch/serve.py
#: --buckets smoke``, the tests)
SMOKE_BUCKETS = (
    TraceBucket(grid=(8, 8, 8), method="cg", stencil="27pt", count=6,
                maxiter=200),
    TraceBucket(grid=(12, 12, 12), method="cg", stencil="7pt", count=6,
                maxiter=200),
    TraceBucket(grid=(8, 8, 8), method="bicgstab_b1", stencil="27pt",
                count=6, maxiter=200),
    TraceBucket(grid=(12, 12, 12), method="pcg", stencil="27pt",
                precond="jacobi", precond_params=(("sweeps", 2),),
                count=6, maxiter=200),
)


def generate_trace(buckets=MIXED_BUCKETS, *, seed: int = 0,
                   scale: int = 1) -> list[Request]:
    """Build the request stream: ``scale * bucket.count`` requests per
    bucket, round-robin interleaved (a heterogeneous arrival order, the
    worst case for a batcher that wants runs of identical work)."""
    rng = np.random.default_rng(seed)
    per_bucket = []
    for tb in buckets:
        dt = np.float64 if tb.dtype == "f64" else np.float32
        reqs = [Request(b=rng.standard_normal(tb.grid).astype(dt),
                        method=tb.method, stencil=tb.stencil,
                        precond=tb.precond,
                        precond_params=(dict(tb.precond_params)
                                        if tb.precond_params else None),
                        dtype=tb.dtype, tol=tb.tol, maxiter=tb.maxiter,
                        norm_ref=tb.norm_ref)
                for _ in range(tb.count * scale)]
        per_bucket.append(reqs)
    trace = []
    for i in range(max(len(rs) for rs in per_bucket)):
        for rs in per_bucket:
            if i < len(rs):
                trace.append(rs[i])
    return trace


def replay(service: SolverService, trace: list[Request], *,
           chunk: int = 4) -> dict[int, ServeResult]:
    """Feed ``trace`` through ``service`` as a stream (``chunk`` submits
    per scheduling step), then drain.  Returns ``{request id: result}``."""
    for i, req in enumerate(trace):
        service.submit(req)
        if (i + 1) % chunk == 0:
            service.step()
    return service.run_until_drained()
