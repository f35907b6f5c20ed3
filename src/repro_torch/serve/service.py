"""The serving loop: continuous batching over the executable cache (the port's
copy of ``repro/serve/service.py``).

Instead of one homogeneous ``solve_batched`` call, a *stream* of
heterogeneous requests keeps the card busy — warm buckets dispatch while
cold buckets build off to the side, and a preemption costs a re-enqueue,
not the queue.

One ``step()`` is one scheduling action:

  1. admit any finished builds into the LRU cache;
  2. for every pending bucket with no resident executable, record a cache
     miss and start its build (a background thread by default, so a cold
     bucket never stalls a warm one);
  3. dispatch one padded batch from the warmest pending bucket (the one
     whose head request has waited longest), or — if nothing is warm —
     block on the oldest build in flight.

A build is ``SolverSession.compile_batched(max_batch)``: the executable's
static buffers and, on the card, an eager warm-up step and the capture of
its CUDA graphs.  Dispatches pad to the bucket's fixed ``max_batch`` with
zero lanes (a zero right-hand side stops at iteration 0 under an absolute
criterion and is masked out by the batched loop), so each bucket builds
**exactly once** — ``SolverSession.cache_stats()`` shows one entry with one
miss.  Under ``norm_ref=None`` a zero lane's relative threshold is 0: it
takes one step, which divides 0 by 0, and stops in breakdown at iteration
1, as the reference's lane does; a pad lane is no request, so its status is
neither served nor quarantined, and the real lanes' results are the same.

**Builds and dispatches never overlap on the card.**  A capture on the
build thread runs in CUDA's global capture mode, under which any other
thread's allocation, synchronous copy or synchronize (a dispatch makes all
three) invalidates it; and ``torch.cuda.graph`` synchronizes the device and
empties the allocator's cache before it begins.  So one lock covers a
build's ``compile_batched`` and a dispatch's device work (the batch's
upload, ``solve_batched``, the injector's hook, the synchronize and the
copies to the host).  The build's session and problem are made outside it
(no capture runs then: the build thread is the only one that captures).
What it costs a warm dispatch is the time it waited for the lock, in
``dispatch_log`` (``wait_s``) beside the dispatch's upload, solve and copy
times; a warm bucket still completes before a cold one that was submitted
first, since the cold one dispatches only once its build is admitted.

``ServeResult.x`` is a host numpy copy of the lane, taken before the lock
is released.  The batched solve's ``x`` is a fresh tensor (``core.methods.
batched_result`` clones the state's iterate or builds it in ``finalize``),
not the executable's static state, so the next dispatch of the bucket
cannot overwrite a result.

Preemption recovery: with ``recovery_dir`` set, every dispatch first
journals its in-flight batch (request ids + right-hand sides) as a
``runtime/checkpoint.py`` write-ahead entry.  An injected preemption
(``runtime.monitor.FailureInjector``) mid-solve restores the batch *from
disk* and re-enqueues it at the front of its bucket — zero dropped
requests, bitwise-identical results.  A service that starts over a dead
process's journal re-admits the orphaned batches via
:meth:`SolverService.recover`.  The journal's files are the reference's, so
either package recovers the other's.

Self-healing (``repro_torch.resilience``, all default-off): a bucket whose
build FAILS is marked broken and its requests — queued and future — become
typed :class:`ServeReject`\\ s; requests carry deadlines and are rejected at
dispatch once expired; transient dispatch failures retry in place with
exponential backoff + seeded jitter before falling back to the journal
requeue; with ``guards`` on, lanes whose solve exits breakdown/diverged/
stagnated are quarantined as rejects; ``DeviceLost`` drops every resident
executable and replays the in-flight batch from the journal.

**On a mesh** (``ServeConfig.mesh``, a ``launch.mesh.Mesh``) the service
runs SPMD, one process a rank, where the reference is one controller over
many devices: every rank builds the same service and submits the same
requests in the same order, as every rank of a mesh solve passes the same
global ``b``.  Each bucket's session solves the rank's blocks
(``session_for(mesh=)``), and a served result holds the global ``x``
(gathered), as the reference's client sees it.  What depends on timing
would differ from rank to rank (the wall-clock deadlines, and the order of
buckets whose head requests tie), so rank 0 decides each ``step()`` and
broadcasts one small int tensor: build a bucket, dispatch one (with the
ids it rejects), or stop.  A session's construction is itself a collective
(the tune decision's broadcast), which a background build would interleave
with a dispatch's, so on a mesh builds run on the service's own thread, in
step order (``async_compile`` applies to ``mesh=None`` only).  Rank 0
writes and clears the journal; every rank reads it, with a barrier before
rank 0 clears an entry.  ``DeviceLost`` (``lost``: mesh ranks) shrinks the
mesh onto the survivors (``runtime.elastic.shrink_mesh``, trimmed to a
count that divides the grid's last extent), records ``survivors``, drops
every session and requeues the in-flight batch from the journal; each lane
is placed onto the new mesh at dispatch (``runtime.elastic.reshard_array``).
A rank left out of the shrunk mesh stops serving: ``run_until_drained``
returns there.  :meth:`SolverService.recover` replays a journal written on P
ranks onto a service on any P′.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait as futures_wait

import numpy as np
import torch

from repro_torch.core.methods import status_name
from repro_torch.obs import trace as obs
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime import elastic
from repro_torch.runtime.monitor import (DeviceLost, FailureInjector,
                                         SimulatedFailure)
from repro_torch.serve.cache import CacheEntry, ExecutableCache, session_for
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.queue import BucketKey, Request, RequestQueue

#: per-lane statuses the poison quarantine rejects (guards on)
_POISON_STATUSES = ("breakdown", "diverged", "stagnated")
#: rank 0's decision of a step on a mesh: ``[action, head id, rejects, ids...]``
_STOP, _BUILD, _DISPATCH = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Service knobs.  ``max_batch`` is the padded in-flight batch size
    every bucket builds at (one executable per bucket); ``async_compile``
    runs builds on a background thread (compile-then-admit);
    ``recovery_dir`` enables the write-ahead journal; ``kernels`` (the
    reference's ``pallas``) runs the buckets on the CUDA kernels, and
    ``device`` is where they run.

    Resilience knobs (all default-off): ``guards`` arms per-lane breakdown
    guards and the poison quarantine; ``default_deadline_s`` applies to
    requests that declare none; ``max_retries``/``retry_backoff_s``/
    ``retry_jitter`` bound the in-place dispatch retry (exponential backoff,
    jitter drawn from a ``retry_seed``-seeded RNG).  ``mesh`` (a
    ``launch.mesh.Mesh``, 1-axis for the device-loss shrink) serves every
    bucket on that mesh, SPMD: every rank builds the same service (see the
    module's docstring); its builds run on the service's thread."""

    max_batch: int = 4
    cache_capacity: int = 8
    max_queue_depth: int | None = None
    async_compile: bool = True
    recovery_dir: str | None = None
    kernels: bool = False
    device: str = "cuda"
    guards: bool = False
    default_deadline_s: float | None = None
    max_retries: int = 0
    retry_backoff_s: float = 0.05
    retry_jitter: float = 0.5
    retry_seed: int = 0
    mesh: object | None = None


@dataclasses.dataclass
class ServeResult:
    """One completed request, as the client sees it."""

    id: int
    bucket: str
    x: np.ndarray
    iters: int
    res_norm: float
    latency_s: float
    requeues: int
    #: the solve's typed exit (``repro_torch.core.methods.STATUS_NAMES``);
    #: with ``ServeConfig.guards`` on, poisoned lanes never get here —
    #: they become :class:`ServeReject` instead
    status: str = "converged"


@dataclasses.dataclass
class ServeReject:
    """One request the service refused to (or could not) serve, with a
    machine-readable reason: ``"compile_failed"`` (its bucket's
    executable never built), ``"deadline"`` (expired in queue) or
    ``"poisoned"`` (its solve lane exited breakdown/diverged/stagnated
    under ``ServeConfig.guards``)."""

    id: int
    bucket: str
    reason: str
    detail: str
    latency_s: float


class SolverService:
    def __init__(self, config: ServeConfig | None = None, *,
                 injector: FailureInjector | None = None):
        self.config = config or ServeConfig()
        self.queue = RequestQueue(max_depth=self.config.max_queue_depth)
        self.cache = ExecutableCache(self.config.cache_capacity)
        self.metrics = ServeMetrics()
        self.injector = injector
        self._results: dict[int, ServeResult] = {}
        self._rejects: dict[int, ServeReject] = {}
        self._failed: dict[BucketKey, str] = {}   # broken buckets -> detail
        self._retry_rng = np.random.default_rng(self.config.retry_seed)
        self._compiling: dict[BucketKey, object] = {}   # key -> Future
        #: the mesh the buckets are served on (None: one device); a device
        #: loss shrinks it, and a rank left out of the shrunk mesh retires
        self.mesh = self.config.mesh
        self._retired = False
        self._pool = (ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix="serve-compile")
                      if self.config.async_compile and self.mesh is None else None)
        #: held by a build's compile_batched and a dispatch's device work
        self._device_lock = threading.Lock()
        #: one record per dispatch that reached the card: bucket, lanes,
        #: iters, and its seconds waiting for the lock, uploading the batch,
        #: solving (to the synchronize) and copying x to the host
        self.dispatch_log: list[dict] = []
        self._seq = 0

    # -- client surface -------------------------------------------------------
    def submit(self, req: Request) -> int:
        now = time.monotonic()
        try:
            rid = self.queue.admit(req, now=now)
        except Exception:
            self.metrics.rejected += 1
            raise
        # serve lifecycle events (repro.obs): admit -> queue_wait ->
        # compile -> dispatch -> complete, all on the one schema
        self.metrics.record_submit(now, bucket=req.key().short(), rid=rid)
        self.metrics.record_queue_depth(self.queue.depth())
        return rid

    def results(self) -> dict[int, ServeResult]:
        return self._results

    def rejects(self) -> dict[int, ServeReject]:
        """Requests the service refused with a typed reason — the client-
        visible complement of :meth:`results` (every admitted id ends up
        in exactly one of the two once the queue drains)."""
        return self._rejects

    def run_until_drained(self) -> dict[int, ServeResult]:
        while self.step():
            pass
        return self._results

    def snapshot(self) -> dict:
        return self.metrics.snapshot(cache_stats=self.cache.stats(),
                                     queue_depth=self.queue.depth())

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)

    # -- the scheduling step --------------------------------------------------
    def step(self) -> bool:
        """One scheduling action; returns False when fully drained (or, on
        a mesh, when this rank was left out of a shrunk mesh)."""
        if self.config.mesh is not None:
            return self._mesh_step()
        self._admit_ready_compiles(block=False)
        # a broken bucket rejects everything queued for it, including
        # requests submitted after the failure
        for k in [k for k in self.queue.buckets() if k in self._failed]:
            self._drain_failed(k)
        keys = self.queue.buckets()
        if not keys:
            if self._compiling:
                self._admit_ready_compiles(block=True)
                return True
            return False
        warm = [k for k in keys if self.cache.contains(k)]
        for k in keys:
            if not self.cache.contains(k) and k not in self._compiling:
                # the miss event: this bucket's traffic needs a build
                self.cache.record_miss(k)
                self._start_compile(k)
        if warm:
            self._dispatch(warm[0])
            return True
        self._admit_ready_compiles(block=True)
        return True

    def _mesh_step(self) -> bool:
        """One scheduling action on a mesh: rank 0's decision, broadcast,
        acted on by every rank alike (one build a step, in rank 0's order,
        before any dispatch of the buckets already built)."""
        if self._retired:
            return False
        for k in [k for k in self.queue.buckets() if k in self._failed]:
            self._drain_failed(k)
        decision = torch.zeros(3 + self.config.max_batch, dtype=torch.int64,
                               device="cuda" if self.mesh.backend == "nccl" else "cpu")
        if self.mesh.rank == 0:
            decision.copy_(torch.as_tensor(self._decide(decision.numel())))
        self.mesh.comm.broadcast(decision, 0)
        action, head, n_rej, *ids = decision.tolist()
        if action == _STOP:
            return False
        key = self.queue.bucket_of(head)
        if action == _BUILD:
            self.cache.record_miss(key)
            self._start_compile(key)
        else:
            self._dispatch(key, expired=set(ids[:n_rej]))
        return True

    def _decide(self, size: int) -> list[int]:
        """Rank 0's decision of a mesh step, ``size`` ints: stop when no
        bucket is pending, else build the first cold bucket, else dispatch
        the warmest with the ids of its batch whose deadline has passed."""
        keys = self.queue.buckets()
        out = [_STOP] * size
        if not keys:
            return out
        cold = [k for k in keys if not self.cache.contains(k)]
        key = cold[0] if cold else keys[0]
        out[:3] = [_BUILD if cold else _DISPATCH, self.queue.peek(key, 1)[0].id, 0]
        if not cold:
            now = time.monotonic()
            late = [r.id for r in self.queue.peek(key, self.config.max_batch)
                    if self._expired(r, now)]
            out[2:3 + len(late)] = [len(late), *late]
        return out

    # -- compile-then-admit ---------------------------------------------------
    def _build_entry(self, key: BucketKey) -> CacheEntry:
        # runs on the build thread: the span starts its own root there
        with obs.span("serve.compile", bucket=key.short(),
                      batch=self.config.max_batch):
            if self.injector is not None:
                self.injector.maybe_fail_compile(key)
            session = session_for(key, kernels=self.config.kernels,
                                  guards=self.config.guards,
                                  device=self.config.device, mesh=self.mesh)
            with self._device_lock:
                session.compile_batched(self.config.max_batch)
        return CacheEntry(key, session, self.config.max_batch)

    def _start_compile(self, key: BucketKey) -> None:
        if self._pool is None:
            try:
                entry = self._build_entry(key)
            except Exception as e:
                self._fail_bucket(key, e)
                return
            self.cache.insert(entry)
            return
        self._compiling[key] = self._pool.submit(self._build_entry, key)

    def _admit_ready_compiles(self, *, block: bool) -> None:
        if not self._compiling:
            return
        done = [k for k, f in self._compiling.items() if f.done()]
        if block and not done:
            # wait without .result(): a failed build must become a
            # per-bucket reject below, not an exception on the scheduler
            oldest = next(iter(self._compiling))
            futures_wait([self._compiling[oldest]])
            done = [k for k, f in self._compiling.items() if f.done()]
        for k in done:
            fut = self._compiling.pop(k)
            try:
                entry = fut.result()
            except Exception as e:
                self._fail_bucket(k, e)
                continue
            self.cache.insert(entry)

    def _fail_bucket(self, key: BucketKey, exc: Exception) -> None:
        """A bucket's executable will never build: mark it broken and
        convert its queued requests into typed rejects."""
        detail = f"{type(exc).__name__}: {exc}"
        self._failed[key] = detail
        obs.event("serve.compile_failed", bucket=key.short(), detail=detail)
        self._drain_failed(key)

    def _drain_failed(self, key: BucketKey) -> None:
        detail = self._failed[key]
        now = time.monotonic()
        while True:
            reqs = self.queue.next_batch(key, self.config.max_batch)
            if not reqs:
                break
            for r in reqs:
                self._reject(r, key, "compile_failed", detail, now)
        self.metrics.record_queue_depth(self.queue.depth())

    # -- dispatch + recovery --------------------------------------------------
    def _reject(self, r: Request, key: BucketKey, reason: str, detail: str,
                now: float) -> None:
        self._rejects[r.id] = ServeReject(
            id=r.id, bucket=key.short(), reason=reason, detail=detail,
            latency_s=now - r.t_submit if r.t_submit is not None else 0.0)
        self.metrics.record_reject(key.short(), reason, rid=r.id)

    def _deadline(self, r: Request) -> float | None:
        return r.deadline_s if r.deadline_s is not None else self.config.default_deadline_s

    def _expired(self, r: Request, now: float) -> bool:
        dl = self._deadline(r)
        return dl is not None and now - r.t_submit > dl

    def _expire_deadlines(self, key: BucketKey, reqs: list[Request],
                          now: float, expired: set[int] | None = None) -> list[Request]:
        """The live requests of a batch; the expired ones (by this clock,
        or the ids ``expired`` that rank 0 decided on a mesh) rejected."""
        live = []
        for r in reqs:
            if self._expired(r, now) if expired is None else r.id in expired:
                self._reject(r, key, "deadline",
                             f"queued {now - r.t_submit:.3f}s > "
                             f"deadline {self._deadline(r)}s", now)
            else:
                live.append(r)
        return live

    def _solve_on_device(self, entry: CacheEntry, seq: int,
                         lanes: list[np.ndarray]) -> dict:
        """One attempt of a dispatch's device work, under the lock: the
        padded batch built on the session's device, ``solve_batched``, the
        injector's hook ("mid-solve": the results are lost if it fires), the
        synchronize, then the real lanes' results copied to the host."""
        session = entry.session
        t0 = time.perf_counter()
        with self._device_lock:
            t1 = time.perf_counter()
            grid = (entry.key.grid if self.mesh is None
                    else session.layout.local_shape(entry.key.grid))
            bs = torch.zeros((entry.batch, *grid),
                             dtype=session.problem.dtype, device=session.device)
            for i, b in enumerate(lanes):
                if self.mesh is None:
                    bs[i].copy_(torch.from_numpy(b))
                else:           # this rank's block of the global lane
                    bs[i].copy_(elastic.reshard_array(b, self.mesh, session.layout))
            t2 = time.perf_counter()
            res = session.solve_batched(bs)
            if self.injector is not None:
                self.injector.maybe_fail(seq)
            if session.device.type == "cuda":
                torch.cuda.synchronize(session.device)
            t3 = time.perf_counter()
            n = len(lanes)
            x = res.x[:n] if self.mesh is None else session.gather(res.x[:n])
            out = dict(x=x.cpu().numpy(), iters=res.iters[:n].tolist(),
                       res_norm=res.res_norm[:n].tolist(),
                       status=res.status[:n].tolist())
            t4 = time.perf_counter()
        self.dispatch_log.append(dict(
            seq=seq, bucket=entry.key.short(), lanes=n, iters=out["iters"],
            wait_s=t1 - t0, upload_s=t2 - t1, solve_s=t3 - t2, copy_s=t4 - t3,
            device_s=t4 - t1, compiling=bool(self._compiling)))
        return out

    def _dispatch(self, key: BucketKey, expired: set[int] | None = None) -> None:
        """Dispatch one padded batch of ``key``; ``expired`` (on a mesh,
        rank 0's decision) names the requests rejected for their
        deadline."""
        entry = self.cache.lookup(key)
        assert entry is not None, key
        with obs.span("serve.dispatch", bucket=key.short(),
                      batch=entry.batch):
            reqs = self.queue.next_batch(key, entry.batch)
            t_disp = time.monotonic()
            for r in reqs:
                obs.event("serve.queue_wait", id=r.id, bucket=key.short(),
                          wait_s=t_disp - r.t_submit)
            reqs = self._expire_deadlines(key, reqs, t_disp, expired)
            self.metrics.record_queue_depth(self.queue.depth())
            if not reqs:
                return
            np_dtype = np.float64 if key.dtype == "f64" else np.float32
            lanes = [np.asarray(r.b, np_dtype) for r in reqs]
            seq = self._seq
            self._seq += 1
            self._wal_write(seq, key, reqs, entry.batch, lanes)
            attempt = 0
            while True:
                try:
                    res = self._solve_on_device(entry, seq, lanes)
                    break
                except DeviceLost as e:
                    # drop every resident entry and replay this batch from
                    # the journal; the rebuild takes the normal path (a
                    # rank left out of a shrunk mesh has retired)
                    self._on_device_loss(e, key)
                    if not self._retired:
                        self._recover_inflight(seq, key, reqs)
                    return
                except SimulatedFailure:
                    if attempt >= self.config.max_retries:
                        self._recover_inflight(seq, key, reqs)
                        self.metrics.record_preemption(len(reqs))
                        return
                    attempt += 1
                    backoff = (self.config.retry_backoff_s
                               * (2.0 ** (attempt - 1))
                               * (1.0 + self.config.retry_jitter
                                  * float(self._retry_rng.random())))
                    self.metrics.record_retry(key.short(), attempt, backoff)
                    time.sleep(backoff)
            now = time.monotonic()
            for i, r in enumerate(reqs):
                st = status_name(res["status"][i])
                if self.config.guards and st in _POISON_STATUSES:
                    # quarantine: one poisoned lane must not ship a NaN x
                    self._reject(r, key, "poisoned",
                                 f"lane exited with status={st!r} "
                                 f"(res_norm={res['res_norm'][i]:.3e})", now)
                    continue
                self._results[r.id] = ServeResult(
                    id=r.id, bucket=key.short(), x=res["x"][i],
                    iters=int(res["iters"][i]), res_norm=res["res_norm"][i],
                    latency_s=now - r.t_submit, requeues=r.requeues,
                    status=st)
                self.metrics.record_completion(key.short(), now - r.t_submit,
                                               now)
            self._wal_clear(seq)

    def _on_device_loss(self, exc: DeviceLost, key: BucketKey) -> None:
        """Shrink the mesh onto the survivors (``lost``: mesh ranks; every
        rank of the old mesh takes part, and one left out retires), then
        drop every session."""
        lost = tuple(getattr(exc, "lost", ()) or ())
        survivors = None
        if self.mesh is not None:
            survivors = len(elastic.survivors(self.mesh, lost, divides=key.grid[-1]))
            self.mesh = elastic.shrink_mesh(self.mesh, lost, divides=key.grid[-1])
            self._retired = self.mesh is None
        self.metrics.record_device_loss(len(lost), survivors)
        obs.event("serve.device_loss", bucket=key.short(), lost=list(lost),
                  survivors=survivors)
        # builds in flight are discarded too: let them finish (the build
        # thread holds references) and drop them
        if self._compiling:
            futures_wait(list(self._compiling.values()))
            self._compiling.clear()
        self.cache.clear()

    # -- the write-ahead journal ----------------------------------------------
    def _wal_meta_path(self, seq: int) -> str:
        return os.path.join(self.config.recovery_dir, f"wal_{seq:08d}.json")

    @staticmethod
    def _wal_template(key: BucketKey, batch: int, dtype: str):
        np_dtype = np.float64 if dtype == "f64" else np.float32
        return {"ids": np.zeros(batch, np.int64),
                "t_submit": np.zeros(batch, np.float64),
                "requeues": np.zeros(batch, np.int64),
                "bs": np.zeros((batch, *key.grid), np_dtype)}

    @property
    def _wal_writer(self) -> bool:
        """Whether this rank writes and clears the journal (rank 0 of a
        mesh; the only process without one)."""
        return self.mesh is None or self.mesh.rank == 0

    def _wal_write(self, seq: int, key: BucketKey, reqs: list[Request],
                   batch: int, lanes: list[np.ndarray]) -> None:
        if self.config.recovery_dir is None or not self._wal_writer:
            return
        state = self._wal_template(key, batch, key.dtype)
        state["ids"][:] = -1
        for i, r in enumerate(reqs):
            state["bs"][i] = lanes[i]
            state["ids"][i] = r.id
            state["t_submit"][i] = r.t_submit
            state["requeues"][i] = r.requeues
        os.makedirs(self.config.recovery_dir, exist_ok=True)
        with open(self._wal_meta_path(seq), "w") as f:
            json.dump({"seq": seq, "batch": batch, "n": len(reqs),
                       "key": {"grid": list(key.grid),
                               "stencil": key.stencil, "method": key.method,
                               "precond": key.precond, "dtype": key.dtype,
                               "solve_params": [key.solve_params[0],
                                                key.solve_params[1],
                                                key.solve_params[2],
                                                [list(kv) for kv in
                                                 key.solve_params[3]]]}}, f)
        ckpt.save(state, self.config.recovery_dir, step=seq, keep=10 ** 9)

    def _wal_clear(self, seq: int) -> None:
        if self.config.recovery_dir is None or not self._wal_writer:
            return
        shutil.rmtree(os.path.join(self.config.recovery_dir,
                                   f"step_{seq:08d}"), ignore_errors=True)
        try:
            os.remove(self._wal_meta_path(seq))
        except FileNotFoundError:
            pass

    @staticmethod
    def _key_from_meta(meta: dict) -> BucketKey:
        k = meta["key"]
        tol, maxiter, norm_ref, pp = k["solve_params"]
        return BucketKey(grid=tuple(k["grid"]), stencil=k["stencil"],
                         method=k["method"], precond=k["precond"],
                         dtype=k["dtype"],
                         solve_params=(tol, maxiter, norm_ref,
                                       tuple(tuple(kv) for kv in pp)))

    def _requests_from_wal(self, seq: int, key: BucketKey,
                           meta: dict) -> list[Request]:
        """Rebuild the in-flight requests from the journal (the on-disk
        copy is authoritative — the preempted dispatch's memory is gone)."""
        template = self._wal_template(key, meta["batch"], key.dtype)
        state, _ = ckpt.restore(template, self.config.recovery_dir, step=seq)
        tol, maxiter, norm_ref, pp = key.solve_params
        return [Request(
            b=state["bs"][i], method=key.method, stencil=key.stencil,
            precond=key.precond, precond_params=dict(pp) if pp else None,
            dtype=key.dtype, tol=tol, maxiter=maxiter, norm_ref=norm_ref,
            id=int(state["ids"][i]), t_submit=float(state["t_submit"][i]),
            requeues=int(state["requeues"][i]))
            for i in range(meta["n"])]

    def _recover_inflight(self, seq: int, key: BucketKey,
                          reqs: list[Request]) -> None:
        """A dispatch was preempted: put its requests back at the front of
        their bucket.  With the journal enabled the batch is rebuilt from
        disk; without it, from memory."""
        if self.config.recovery_dir is not None:
            with open(self._wal_meta_path(seq)) as f:
                meta = json.load(f)
            reqs = self._requests_from_wal(seq, key, meta)
            self._read_by_all()
            self._wal_clear(seq)
        self.queue.requeue_front(key, reqs)

    def _read_by_all(self) -> None:
        """On a mesh, wait until every rank has read the journal entries
        rank 0 is about to clear."""
        if self.mesh is not None:
            self.mesh.comm.barrier()

    def recover(self) -> dict[int, int]:
        """Cold-start recovery: scan ``recovery_dir`` for journal entries a
        dead process left behind and re-admit their requests (front of
        queue, fresh ids, ``t_submit`` reset to now — queue-wait before the
        death is not double-counted).  Returns ``{old_id: new_id}``.  On a
        mesh every rank calls it (the journal may come from a service on
        any number of ranks) and re-admits the same requests."""
        remap: dict[int, int] = {}
        d = self.config.recovery_dir
        if d is None or not os.path.isdir(d):
            return remap
        metas = sorted(fn for fn in os.listdir(d)
                       if fn.startswith("wal_") and fn.endswith(".json"))
        for fn in metas:
            with open(os.path.join(d, fn)) as f:
                meta = json.load(f)
            key = self._key_from_meta(meta)
            seq = meta["seq"]
            for r in self._requests_from_wal(seq, key, meta):
                old = r.id
                r.id = None
                r.requeues += 1
                new = self.queue.admit(r, now=time.monotonic())
                remap[old] = new
            self._read_by_all()
            self._wal_clear(seq)
        return remap
