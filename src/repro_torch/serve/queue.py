"""Request admission + bucketing for the solver service (the port's copy of
``repro/serve/queue.py``).

A request is one right-hand side plus everything that determines which
compiled executable can serve it.  Admission validates against the solver
registry *before* the request costs anything (unknown method, a
preconditioner on a method with no ``M=`` hook, a wrong-shaped RHS and a
bad dtype are all rejected at the door), then files the request into a
FIFO bucket keyed by

    ``(grid, stencil, method, precond, dtype)``  + solve params

— exactly the tuple that pins one compiled executable.  ``tol`` /
``maxiter`` / ``norm_ref`` / ``precond_params`` are fixed in the cached
executable (its threshold and its captured graphs), so they ride along in
``BucketKey.solve_params``: requests that differ there *cannot* share an
executable and honestly fork their own bucket.

The queue is pure bookkeeping — no tensors, no threads; a request's
payload is a host numpy array, as in the reference.  The service drains
it bucket-at-a-time (``next_batch``) and pushes preempted work back at
the *front* (``requeue_front``) so recovery preserves FIFO order.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import NamedTuple

import numpy as np

from repro_torch.api.registry import get_solver, solver_names
from repro_torch.precond.base import precond_names

#: accepted request dtypes (``SolverOptions.f64`` on or off)
DTYPES = ("f32", "f64")


class BucketKey(NamedTuple):
    """Everything that pins ONE compiled executable (== one cache entry)."""

    grid: tuple[int, int, int]
    stencil: str
    method: str
    precond: str
    dtype: str
    #: (tol, maxiter, norm_ref, frozen precond_params) — compiled-in
    #: constants; requests differing here fork their own bucket.
    solve_params: tuple

    def short(self) -> str:
        g = "x".join(map(str, self.grid))
        pre = f"+{self.precond}" if self.precond != "none" else ""
        return f"{self.method}{pre}/{self.stencil}/{g}/{self.dtype}"


@dataclasses.dataclass
class Request:
    """One solve request.  ``b`` is the RHS (host array, ``grid``-shaped);
    the rest selects the executable.  Runtime fields (``id``, timestamps,
    ``requeues``) are filled in by the queue/service."""

    b: np.ndarray
    method: str = "cg"
    stencil: str = "27pt"
    precond: str = "none"
    precond_params: dict | None = None
    dtype: str = "f64"
    tol: float = 1e-8
    maxiter: int = 500
    norm_ref: float | None = 1.0
    #: end-to-end deadline (seconds after admission); a request still
    #: queued past it is rejected at dispatch time instead of solved
    #: (``ServeConfig.default_deadline_s`` applies when None).  Not part
    #: of the bucket key — deadlines don't pin an executable — and not
    #: persisted in the WAL (a recovered batch re-solves regardless: the
    #: work is already journalled and paid for).
    deadline_s: float | None = None

    id: int | None = None
    t_submit: float | None = None
    requeues: int = 0

    def key(self) -> BucketKey:
        pp = (tuple(sorted(self.precond_params.items()))
              if self.precond_params else ())
        return BucketKey(grid=tuple(self.b.shape), stencil=self.stencil,
                         method=self.method, precond=self.precond,
                         dtype=self.dtype,
                         solve_params=(self.tol, self.maxiter,
                                       self.norm_ref, pp))


class QueueFull(RuntimeError):
    """Admission control: the queue is at ``max_depth``."""


class RequestQueue:
    """Per-bucket FIFO queues with validated admission."""

    def __init__(self, max_depth: int | None = None):
        self.max_depth = max_depth
        self._buckets: OrderedDict[BucketKey, deque[Request]] = OrderedDict()
        self._next_id = 0
        self.admitted = 0
        self.rejected = 0

    # -- admission ------------------------------------------------------------
    def _validate(self, req: Request) -> None:
        if req.dtype not in DTYPES:
            raise ValueError(f"unknown dtype {req.dtype!r}; options: {DTYPES}")
        if req.method not in solver_names():
            raise ValueError(f"unknown method {req.method!r}; "
                             f"options: {solver_names()}")
        if req.precond not in precond_names():
            raise ValueError(f"unknown precond {req.precond!r}; "
                             f"options: {precond_names()}")
        if req.precond != "none" and not get_solver(req.method).accepts_precond:
            raise ValueError(
                f"method {req.method!r} takes no preconditioner "
                f"(requested {req.precond!r})")
        b = np.asarray(req.b)
        if b.ndim != 3:
            raise ValueError(f"request RHS must be (nx, ny, nz), "
                             f"got shape {b.shape}")

    def admit(self, req: Request, *, now: float) -> int:
        """Validate + enqueue; returns the assigned request id.  Raises
        ``ValueError`` (malformed) or ``QueueFull`` (at ``max_depth``) —
        the request costs nothing past this point."""
        try:
            self._validate(req)
        except ValueError:
            self.rejected += 1
            raise
        if self.max_depth is not None and self.depth() >= self.max_depth:
            self.rejected += 1
            raise QueueFull(f"queue at max_depth={self.max_depth}")
        req.id = self._next_id
        self._next_id += 1
        req.t_submit = now
        self._buckets.setdefault(req.key(), deque()).append(req)
        self.admitted += 1
        return req.id

    # -- draining -------------------------------------------------------------
    def buckets(self) -> list[BucketKey]:
        """Bucket keys with pending work, oldest head-request first (the
        service's fairness order)."""
        live = [(k, q[0].t_submit) for k, q in self._buckets.items() if q]
        return [k for k, _ in sorted(live, key=lambda kv: kv[1])]

    def pending(self, key: BucketKey) -> int:
        return len(self._buckets.get(key, ()))

    def depth(self) -> int:
        return sum(len(q) for q in self._buckets.values())

    def next_batch(self, key: BucketKey, n: int) -> list[Request]:
        """Pop up to ``n`` requests from ``key``'s FIFO."""
        q = self._buckets.get(key)
        out = []
        while q and len(out) < n:
            out.append(q.popleft())
        return out

    def peek(self, key: BucketKey, n: int) -> list[Request]:
        """The first ``n`` requests of ``key``'s FIFO, left in place."""
        return list(self._buckets.get(key, ()))[:n]

    def bucket_of(self, rid: int) -> BucketKey:
        """The bucket whose head request has id ``rid``."""
        for k, q in self._buckets.items():
            if q and q[0].id == rid:
                return k
        raise KeyError(f"no bucket is headed by request {rid}")

    def requeue_front(self, key: BucketKey, reqs: list[Request]) -> None:
        """Push preempted requests back at the FRONT, preserving order."""
        q = self._buckets.setdefault(key, deque())
        for r in reversed(reqs):
            r.requeues += 1
            q.appendleft(r)
