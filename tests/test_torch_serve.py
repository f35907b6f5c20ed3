"""The port's solver service (``repro_torch.serve``) on the CPU: the cases of
``tests/test_serve.py`` — admission and bucketing, the LRU executable cache,
SLO metrics, and the serving contract: a mixed trace replayed through the
service completes with every result bitwise equal to a direct solve of its
request, one build a bucket, zero dropped across an injected preemption,
LRU-bounded residency — each service case on both routes (``kernels=False``
and ``kernels=True``, the kernels' plain versions here).  Unlike the
reference, which pins one verified trace, the bitwise contract holds for
every seed: each lane of the port's batched solve is its single solve bit
for bit.  Also: an f32 bucket, a ``norm_ref=None`` request in a padded
batch, the device lock (no build overlaps a dispatch), the checks of
``benchmarks/bench_serve.py``'s ``check_record`` and
``check_chaos_record`` on the smoke trace, and the CLI.  The file imports
no JAX."""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch

from repro_torch.api import SolverOptions, SolverSession
from repro_torch.runtime.monitor import FailureInjector
from repro_torch.serve import (
    SMOKE_BUCKETS,
    BucketKey,
    CacheEntry,
    ExecutableCache,
    QueueFull,
    Request,
    RequestQueue,
    ServeConfig,
    ServeMetrics,
    SolverService,
    TraceBucket,
    generate_trace,
    replay,
    scan_metrics,
    session_for,
)

#: the test trace: >= 4 distinct buckets — two grids x two methods, one
#: preconditioned (the reference's test mix) — and one f32 bucket
TEST_BUCKETS = (
    TraceBucket(grid=(8, 8, 8), method="cg", stencil="27pt", count=5,
                maxiter=200),
    TraceBucket(grid=(12, 12, 12), method="cg", stencil="7pt", count=5,
                maxiter=200),
    TraceBucket(grid=(12, 12, 12), method="bicgstab", stencil="27pt",
                count=5, maxiter=200),
    TraceBucket(grid=(12, 12, 12), method="pcg", stencil="27pt",
                precond="jacobi", precond_params=(("sweeps", 2),),
                count=5, maxiter=200),
    TraceBucket(grid=(10, 7, 13), method="pcg", stencil="27pt",
                precond="chebyshev", dtype="f32", count=3, tol=1e-5,
                maxiter=200),
)

ROUTES = pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])


def _cfg(kernels, **kw):
    return ServeConfig(kernels=kernels, device="cpu", **kw)


def _direct_solve(req, kernels):
    """The yardstick: one direct facade solve of the request, on the route
    its bucket runs."""
    sess = SolverSession(
        method=req.method, grid=tuple(req.b.shape), stencil=req.stencil,
        device="cpu",
        options=SolverOptions(tol=req.tol, maxiter=req.maxiter,
                              norm_ref=req.norm_ref, precond=req.precond,
                              precond_params=req.precond_params,
                              f64=req.dtype == "f64", kernels=kernels))
    return sess.solve(b=req.b)


def _same(got, ref) -> bool:
    """A served result against a direct solve: iterations, status and
    residual norm equal, the iterate bit for bit."""
    x = ref.x.numpy()
    return (got.iters == int(ref.iters) and got.status == "converged"
            and got.res_norm == float(ref.res_norm)
            and got.x.dtype == x.dtype and got.x.tobytes() == x.tobytes())


# -----------------------------------------------------------------------------
# queue: admission + bucketing
# -----------------------------------------------------------------------------

def _req(**kw):
    kw.setdefault("b", np.zeros((8, 8, 8)))
    return Request(**kw)


def test_admission_rejects_malformed_requests():
    q = RequestQueue()
    with pytest.raises(ValueError, match="method"):
        q.admit(_req(method="nope"), now=0.0)
    with pytest.raises(ValueError, match="precond"):
        q.admit(_req(method="pcg", precond="nope"), now=0.0)
    with pytest.raises(ValueError, match="no precond"):
        q.admit(_req(method="cg", precond="jacobi"), now=0.0)
    with pytest.raises(ValueError, match="dtype"):
        q.admit(_req(dtype="f16"), now=0.0)
    with pytest.raises(ValueError, match="nx, ny, nz"):
        q.admit(_req(b=np.zeros((8, 8))), now=0.0)
    assert q.rejected == 5 and q.admitted == 0 and q.depth() == 0


def test_admission_control_queue_full():
    q = RequestQueue(max_depth=2)
    q.admit(_req(), now=0.0)
    q.admit(_req(), now=0.0)
    with pytest.raises(QueueFull):
        q.admit(_req(), now=0.0)
    assert q.rejected == 1


def test_bucketing_key_and_fifo():
    q = RequestQueue()
    a1 = _req()
    a2 = _req()
    b1 = _req(tol=1e-4)                # differing solve params fork a bucket
    c1 = _req(method="bicgstab")
    for i, r in enumerate((a1, b1, a2, c1)):
        q.admit(r, now=float(i))
    assert a1.key() == a2.key()
    assert a1.key() != b1.key() and a1.key() != c1.key()
    assert q.depth() == 4 and len(q.buckets()) == 3
    assert q.buckets()[0] == a1.key()
    batch = q.next_batch(a1.key(), 8)
    assert [r.id for r in batch] == [a1.id, a2.id]
    q.requeue_front(a1.key(), batch)
    again = q.next_batch(a1.key(), 8)
    assert [r.id for r in again] == [a1.id, a2.id]
    assert all(r.requeues == 1 for r in again)


def test_bucket_short_names_are_the_references():
    """``BucketKey.short()`` letter for letter as the reference writes it."""
    assert _req().key().short() == "cg/27pt/8x8x8/f64"
    r = _req(b=np.zeros((12, 10, 14), np.float32), method="pcg", precond="chebyshev",
             stencil="7pt", dtype="f32")
    assert r.key().short() == "pcg+chebyshev/7pt/12x10x14/f32"
    assert r.key().solve_params == (1e-8, 500, 1.0, ())


# -----------------------------------------------------------------------------
# cache: LRU bound + counters (no builds — sessions stubbed)
# -----------------------------------------------------------------------------

class _StubSession:
    def cache_stats(self):
        return {("shape", "m", "none"): {"hits": 0, "misses": 1,
                                         "compile_s": 0.25}}


def _key(n):
    return BucketKey(grid=(8, 8, n), stencil="27pt", method="cg",
                     precond="none", dtype="f64",
                     solve_params=(1e-8, 100, 1.0, ()))


def test_cache_lru_eviction_respects_bound():
    cache = ExecutableCache(capacity=2)
    k1, k2, k3 = _key(1), _key(2), _key(3)
    for k in (k1, k2, k3):
        cache.record_miss(k)
    cache.insert(CacheEntry(k1, _StubSession(), batch=4))
    cache.insert(CacheEntry(k2, _StubSession(), batch=4))
    assert cache.lookup(k1) is not None          # k1 now most-recently-used
    evicted = cache.insert(CacheEntry(k3, _StubSession(), batch=4))
    assert evicted == [k2]
    assert cache.contains(k1) and not cache.contains(k2)
    st = cache.stats()
    assert st["entries"] == 2 == st["capacity"]
    assert st["hits"] == 1 and st["misses"] == 3 and st["evictions"] == 1
    assert st["per_bucket"][k2.short()]["evictions"] == 1
    assert st["per_bucket"][k1.short()]["compile_s"] == 0.25
    cache.contains(k1)
    assert cache.stats()["hits"] == 1


def test_cache_capacity_validation():
    with pytest.raises(ValueError, match="capacity"):
        ExecutableCache(capacity=0)


@pytest.mark.parametrize("guards", [False, True])
def test_session_for_maps_the_bucket(guards):
    """``session_for``: the bucket's solve params, ``kernels`` for the
    reference's ``pallas``, ``on_breakdown`` "none" under guards; a mesh
    pins the session to it, and a service on a one-rank mesh serves a
    request as the session on it solves it."""
    key = _req(b=np.zeros((8, 6, 4), np.float32), method="pcg", precond="jacobi",
               precond_params={"sweeps": 2}, dtype="f32", tol=1e-5, maxiter=50,
               norm_ref=None).key()
    sess = session_for(key, kernels=True, guards=guards, device="cpu")
    o = sess.options
    assert (o.tol, o.maxiter, o.norm_ref, o.f64, o.kernels, o.guards) == (
        1e-5, 50, None, False, True, guards)
    assert o.precond == "jacobi" and o.precond_params == {"sweeps": 2}
    assert o.on_breakdown == ("none" if guards else "raise")
    assert sess.problem.shape == (8, 6, 4) and sess.device.type == "cpu"
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh.one_rank()
    on_mesh = session_for(key, device="cpu", mesh=mesh)
    assert on_mesh.mesh is mesh and on_mesh.backend.kind == "shard_map"
    service = SolverService(ServeConfig(mesh=mesh, device="cpu", max_batch=2))
    req = _req(b=np.random.default_rng(2).standard_normal((8, 6, 4)), maxiter=200)
    rid = service.submit(req)
    got = service.run_until_drained()[rid]
    service.close()
    one = session_for(req.key(), device="cpu", mesh=mesh).solve(b=req.b)
    assert got.x.tobytes() == one.x.numpy().tobytes() and got.iters == one.iters


# -----------------------------------------------------------------------------
# metrics: percentiles, QPS, monitor-style records
# -----------------------------------------------------------------------------

def test_metrics_percentiles_and_qps(tmp_path):
    m = ServeMetrics()
    m.record_submit(now=100.0)
    lats = [0.01 * (i + 1) for i in range(100)]       # 10ms .. 1s
    for i, lat in enumerate(lats):
        m.record_completion("b", lat, now=100.0 + i * 0.1)
    snap = m.snapshot(queue_depth=0)
    assert snap["p50_s"] == pytest.approx(np.percentile(lats, 50))
    assert snap["p95_s"] == pytest.approx(np.percentile(lats, 95))
    assert snap["p99_s"] == pytest.approx(np.percentile(lats, 99))
    assert snap["qps"] == pytest.approx(100 / 9.9)
    assert snap["per_bucket"]["b"]["served"] == 100
    path = m.write(str(tmp_path), name="test")
    assert os.path.basename(path) == "metrics_test.json"
    assert scan_metrics(str(tmp_path))["test"]["completed"] == 100
    assert all(e["schema"] == "repro.obs/v1" and e["kind"] == "event"
               for e in m.events())


def test_metrics_empty_snapshot():
    snap = ServeMetrics().snapshot()
    assert snap["qps"] is None and snap["p99_s"] is None
    assert snap["completed"] == 0


def test_metrics_read_untagged_records(tmp_path):
    """``scan_metrics`` normalises a record written before the schema tag."""
    with open(os.path.join(tmp_path, "metrics_old.json"), "w") as f:
        json.dump({"t": 5.0, "completed": 3}, f)
    rec = scan_metrics(str(tmp_path))["old"]
    assert rec["schema"] == "repro.obs/v1+legacy" and rec["t_wall"] == 5.0
    assert scan_metrics(str(tmp_path / "none")) == {}


# -----------------------------------------------------------------------------
# SolverSession.cache_stats (the compile-cache observability the service uses)
# -----------------------------------------------------------------------------

def test_session_cache_stats_counts_and_compile_seconds():
    sess = SolverSession(method="cg", grid=(8, 8, 8), stencil="27pt", device="cpu",
                         options=SolverOptions(tol=1e-8, maxiter=100))
    sess.solve()
    sess.solve()
    key = ((8, 8, 8), "cg", "none")
    st = sess.cache_stats()[key]
    assert st["misses"] == 1 and st["hits"] == 1
    assert st["compile_s"] > 0
    bs = torch.stack([sess.problem.b()] * 3)
    sess.solve_batched(bs)
    bst = sess.cache_stats()[((3, 8, 8, 8), "cg", "none")]
    assert bst["misses"] == 1 and bst["hits"] == 0


def test_session_compile_batched_makes_later_solves_hits():
    sess = SolverSession(method="cg", grid=(8, 8, 8), stencil="27pt", device="cpu",
                         options=SolverOptions(tol=1e-8, maxiter=100))
    dt = sess.compile_batched(2)
    assert dt > 0
    sess.solve_batched(torch.stack([sess.problem.b()] * 2))
    st = sess.cache_stats()[((2, 8, 8, 8), "cg", "none")]
    assert st["misses"] == 1 and st["hits"] == 1


# -----------------------------------------------------------------------------
# the serving loop: trace replay parity, one build per bucket, recovery
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5, 9])
@ROUTES
def test_trace_replay_bitwise_parity_and_one_compile_per_bucket(kernels, seed):
    service = SolverService(_cfg(kernels, max_batch=4, cache_capacity=8))
    trace = generate_trace(TEST_BUCKETS, seed=seed)
    results = replay(service, trace)
    service.close()
    # (a) zero dropped: every admitted request has a result
    assert sorted(results) == list(range(len(trace)))
    # (b) every result matches a direct solve bitwise, for any seed
    for i, req in enumerate(generate_trace(TEST_BUCKETS, seed=seed)):
        assert _same(results[i], _direct_solve(req, kernels)), (i, results[i].bucket)
    # (c) exactly one build per bucket, via SolverSession.cache_stats()
    assert len({r.key() for r in trace}) == len(TEST_BUCKETS)
    for key, entry in service.cache._entries.items():
        stats = entry.session.cache_stats()
        assert len(stats) == 1, key
        (st,) = stats.values()
        assert st["misses"] == 1, key
    cache = service.cache.stats()
    assert cache["misses"] == len(TEST_BUCKETS) and cache["evictions"] == 0
    snap = service.snapshot()
    assert snap["completed"] == len(trace) and snap["qps"] > 0
    assert {r.x.dtype for r in results.values()} == {np.dtype(np.float64),
                                                     np.dtype(np.float32)}


@ROUTES
def test_partial_batch_pads_with_converged_lanes(kernels):
    """1 request into a max_batch=4 bucket: the pad lanes are zero RHS
    (stopped at iteration 0) and the real lane is bitwise-unaffected."""
    service = SolverService(_cfg(kernels, max_batch=4))
    rng = np.random.default_rng(7)
    req = Request(b=rng.standard_normal((8, 8, 8)), method="cg",
                  stencil="27pt", maxiter=200)
    service.submit(req)
    results = service.run_until_drained()
    service.close()
    ref = _direct_solve(Request(b=req.b, method="cg", stencil="27pt",
                                maxiter=200), kernels)
    assert _same(results[0], ref)


@ROUTES
def test_relative_request_in_a_padded_batch(kernels):
    """``norm_ref=None`` (a relative criterion) in a padded batch: a zero pad
    lane's threshold is 0, so it takes one step (0/0) and stops in
    breakdown at iteration 1, as the reference's lane does
    (``tests/test_torch_serve_ref.py``).  The real lanes are bitwise their
    direct solves, and the pad lanes, not being requests, are neither served
    nor quarantined (guards on)."""
    service = SolverService(_cfg(kernels, max_batch=4, guards=True))
    rng = np.random.default_rng(4)
    reqs = [Request(b=rng.standard_normal((8, 6, 10)), method="cg", norm_ref=None,
                    tol=1e-9, maxiter=80) for _ in range(2)]
    for r in reqs:
        service.submit(r)
    results = service.run_until_drained()
    service.close()
    assert sorted(results) == [r.id for r in reqs] and not service.rejects()
    for r in reqs:
        assert _same(results[r.id], _direct_solve(r, kernels))
    (d,) = service.dispatch_log
    assert d["lanes"] == 2 and d["iters"] == [results[r.id].iters for r in reqs]
    sess = service.cache._entries[reqs[0].key()].session
    pad = sess.solve_batched(torch.zeros((4, 8, 6, 10), dtype=torch.float64))
    assert pad.iters.tolist() == [1] * 4 and pad.status.tolist() == [2] * 4


@ROUTES
def test_served_x_is_a_host_copy(kernels):
    """The batched solve's ``x`` is not the executable's static state: a
    result stays as served after later dispatches of its bucket."""
    service = SolverService(_cfg(kernels, max_batch=2))
    rng = np.random.default_rng(8)
    first = Request(b=rng.standard_normal((8, 8, 8)), method="cg", maxiter=200)
    service.submit(first)
    service.run_until_drained()
    kept = service.results()[first.id].x.copy()
    for _ in range(3):
        service.submit(Request(b=rng.standard_normal((8, 8, 8)), method="cg",
                               maxiter=200))
    service.run_until_drained()
    service.close()
    got = service.results()[first.id].x
    assert isinstance(got, np.ndarray) and got.tobytes() == kept.tobytes()
    assert len(service.dispatch_log) == 3


def test_builds_and_dispatches_never_overlap():
    """The device lock: with builds on the background thread, no build's
    ``compile_batched`` overlaps any dispatch's ``solve_batched``."""
    spans, guard = [], threading.Lock()
    real_compile = SolverSession.compile_batched
    real_solve = SolverSession.solve_batched

    def timed(kind, fn):
        def wrapper(self, *a, **k):
            import time
            t0 = time.perf_counter()
            out = fn(self, *a, **k)
            with guard:
                spans.append((kind, t0, time.perf_counter()))
            return out
        return wrapper

    SolverSession.compile_batched = timed("build", real_compile)
    SolverSession.solve_batched = timed("dispatch", real_solve)
    try:
        service = SolverService(_cfg(True, max_batch=2))
        results = replay(service, generate_trace(TEST_BUCKETS[:4], seed=1), chunk=3)
        service.close()
    finally:
        SolverSession.compile_batched = real_compile
        SolverSession.solve_batched = real_solve
    assert len(results) == 20
    builds = [s for s in spans if s[0] == "build"]
    dispatches = [s for s in spans if s[0] == "dispatch"]
    assert len(builds) == 4 and dispatches
    for _, b0, b1 in builds:
        for _, d0, d1 in dispatches:
            assert b1 <= d0 or d1 <= b0
    assert any(d["compiling"] for d in service.dispatch_log)


@ROUTES
def test_preemption_recovery_zero_dropped(tmp_path, kernels):
    """An injected preemption mid-solve re-enqueues the batch from the
    write-ahead journal: zero dropped requests, bitwise-identical results,
    and a clean journal afterwards."""
    wal = str(tmp_path / "wal")
    service = SolverService(_cfg(kernels, max_batch=4, recovery_dir=wal),
                            injector=FailureInjector(fail_at_step=1))
    trace = generate_trace(TEST_BUCKETS, seed=0)
    results = replay(service, trace)
    service.close()
    assert sorted(results) == list(range(len(trace)))          # zero dropped
    snap = service.snapshot()
    assert snap["preemptions"] == 1 and snap["requeued"] >= 1
    assert sum(r.requeues for r in results.values()) == snap["requeued"]
    clean = SolverService(_cfg(kernels, max_batch=4))
    ref = replay(clean, generate_trace(TEST_BUCKETS, seed=0))
    clean.close()
    for i in results:
        assert results[i].x.tobytes() == ref[i].x.tobytes(), i
        assert results[i].iters == ref[i].iters
    assert not any(f.startswith(("wal_", "step_")) for f in os.listdir(wal))


class _HardDeath(RuntimeError):
    """Not a SimulatedFailure: the service does NOT catch it — the
    dispatch dies with its journal entry still on disk."""


class _KillInjector(FailureInjector):
    def maybe_fail(self, step):
        if step == self.fail_at_step and not self.fired:
            self.fired = True
            raise _HardDeath(f"process died at dispatch {step}")


@ROUTES
def test_cold_start_recovery_from_orphaned_wal(tmp_path, kernels):
    """A service that dies mid-dispatch leaves its journal behind; a fresh
    service over the same recovery_dir re-admits the orphaned requests and
    completes them bitwise as a service that never died."""
    wal = str(tmp_path / "wal")
    rng = np.random.default_rng(11)
    reqs = [Request(b=rng.standard_normal((8, 8, 8)), method="cg",
                    stencil="27pt", maxiter=200) for _ in range(3)]
    dying = SolverService(_cfg(kernels, max_batch=4, recovery_dir=wal,
                               async_compile=False),
                          injector=_KillInjector(fail_at_step=0))
    for r in reqs:
        dying.submit(r)
    with pytest.raises(_HardDeath):
        dying.run_until_drained()
    dying.close()
    assert any(f.startswith("wal_") for f in os.listdir(wal))   # orphaned
    fresh = SolverService(_cfg(kernels, max_batch=4, recovery_dir=wal))
    remap = fresh.recover()
    assert len(remap) == 3
    results = fresh.run_until_drained()
    fresh.close()
    assert sorted(results) == sorted(remap.values())
    clean = SolverService(_cfg(kernels, max_batch=4))
    for r in reqs:
        clean.submit(Request(b=r.b, method="cg", stencil="27pt", maxiter=200))
    refs = clean.run_until_drained()
    clean.close()
    for old, new in remap.items():
        assert results[new].x.tobytes() == refs[old].x.tobytes()
        assert results[new].iters == refs[old].iters
        assert results[new].requeues >= 1
    assert not any(f.startswith(("wal_", "step_")) for f in os.listdir(wal))


@ROUTES
def test_cold_bucket_does_not_stall_warm_bucket(kernels):
    """Compile-then-admit: while a cold bucket builds on the background
    thread, a warm bucket's requests keep dispatching — the warm request
    finishes first despite later submission."""
    service = SolverService(_cfg(kernels, max_batch=2))
    rng = np.random.default_rng(3)

    def warm():
        return Request(b=rng.standard_normal((8, 8, 8)), method="cg",
                       stencil="27pt", maxiter=200)
    cold = Request(b=rng.standard_normal((10, 10, 12)), method="bicgstab_b1",
                   stencil="27pt", maxiter=200)
    service.submit(warm())
    service.run_until_drained()                    # bucket A is now warm
    cold_id = service.submit(cold)                 # triggers a build
    warm_id = service.submit(warm())
    results = service.run_until_drained()
    service.close()
    order = list(results)                          # dict preserves commit order
    assert order.index(warm_id) < order.index(cold_id)
    assert service.cache.stats()["misses"] == 2


# -----------------------------------------------------------------------------
# the bench's gates on the smoke trace, and the CLI
# -----------------------------------------------------------------------------

@ROUTES
def test_smoke_trace_meets_the_bench_record_gate(kernels):
    """``benchmarks/bench_serve.py::check_record`` on the smoke trace:
    nothing dropped, one build a bucket, qps >= 0.5, p99 <= 60 s."""
    trace = generate_trace(SMOKE_BUCKETS, seed=0)
    service = SolverService(_cfg(kernels, max_batch=4, cache_capacity=8))
    results = replay(service, trace)
    service.close()
    snap = service.snapshot()
    assert len(trace) - len(results) - len(service.rejects()) == 0
    compiles = {b: st["misses"] for b, st in snap["cache"]["per_bucket"].items()}
    assert len(compiles) == len(SMOKE_BUCKETS) and set(compiles.values()) == {1}
    assert snap["qps"] >= 0.5 and snap["p99_s"] <= 60.0


@ROUTES
def test_smoke_trace_meets_the_bench_chaos_gate(kernels):
    """``benchmarks/bench_serve.py::check_chaos_record`` on the smoke trace
    under its faults (bicgstab_b1 never builds, a preemption at dispatch 0
    inside a retry budget of 2): every request completed or rejected, the
    broken bucket's traffic all ``compile_failed``, the preemption retried
    and not requeued."""
    from repro_torch.resilience import ChaosInjector, ChaosPlan
    trace = generate_trace(SMOKE_BUCKETS, seed=0)
    broken = "bicgstab_b1"
    injector = ChaosInjector(ChaosPlan(seed=0, fail_compile_buckets=(broken,),
                                       preempt_at=(0,)))
    service = SolverService(_cfg(kernels, max_batch=4, guards=True, max_retries=2,
                                 retry_backoff_s=0.01, retry_seed=0),
                            injector=injector)
    results = replay(service, trace)
    service.close()
    snap = service.snapshot()
    rejects = service.rejects()
    assert len(results) + len(rejects) == len(trace)
    assert snap["rejects_by_reason"].get("compile_failed", 0) == sum(
        1 for r in trace if r.method == broken)
    assert {r.bucket for r in rejects.values()} == {
        next(r.key().short() for r in trace if r.method == broken)}
    assert snap["retries"] >= 1 and snap["preemptions"] == 0


def test_serve_cli_smoke_trace(capsys):
    """``python -m repro_torch.launch.serve --mode solver --device cpu
    --buckets smoke --json``: every request served, one build a bucket;
    ``--mode lm`` serves the reduced enc-dec model (the last family the
    port took) on the CPU: tokens inside its vocabulary."""
    from repro_torch.launch.serve import main
    out = main(["--mode", "solver", "--device", "cpu", "--buckets", "smoke",
                "--kernels", "--json"])
    assert out["completed"] == out["requests"] == 24 and out["dropped"] == 0
    assert {st["misses"] for st in out["cache"]["per_bucket"].values()} == {1}
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["completed"] == 24 and line["schema"] == "repro.obs/v1"
    lm = main(["--mode", "lm", "--arch", "seamless-m4t-large-v2", "--reduced", "--device", "cpu",
               "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    assert lm["finite"] and lm["tokens"].shape == (2, 5)
    assert 0 <= int(lm["tokens"].min()) and int(lm["tokens"].max()) < 256


def test_deadline_and_quarantine_are_typed_rejects():
    """A request past its deadline and a NaN right-hand side (guards on)
    become typed rejects; their batch-mates are served."""
    service = SolverService(_cfg(True, max_batch=4, guards=True))
    rng = np.random.default_rng(2)
    ok = service.submit(Request(b=rng.standard_normal((8, 8, 8)), maxiter=200))
    bad_b = rng.standard_normal((8, 8, 8))
    bad_b[1, 2, 3] = np.nan
    bad = service.submit(Request(b=bad_b, maxiter=200))
    late = service.submit(Request(b=rng.standard_normal((8, 8, 8)), maxiter=200,
                                  deadline_s=0.0))
    service.run_until_drained()
    service.close()
    rej = service.rejects()
    assert service.results()[ok].status == "converged"
    assert rej[bad].reason == "poisoned" and "breakdown" in rej[bad].detail
    assert rej[late].reason == "deadline"
    assert dataclasses.asdict(rej[late]).keys() == {"id", "bucket", "reason", "detail",
                                                    "latency_s"}


@ROUTES
def test_device_loss_drops_the_executables_and_replays(tmp_path, kernels):
    """``DeviceLost`` at a dispatch, no mesh: the loss is recorded with
    ``survivors=None``, every resident executable is dropped (no eviction
    counted), the in-flight batch replays from the journal, the bucket
    rebuilds (a second miss), and every request completes bitwise as in a
    clean run."""
    from repro_torch.resilience import ChaosInjector, ChaosPlan
    trace = generate_trace(TEST_BUCKETS[:2], seed=3)
    wal = str(tmp_path / "wal")
    service = SolverService(_cfg(kernels, max_batch=4, recovery_dir=wal),
                            injector=ChaosInjector(ChaosPlan(device_loss_at=(1,),
                                                             lose_devices=(0,))))
    results = replay(service, trace)
    service.close()
    clean = SolverService(_cfg(kernels, max_batch=4))
    ref = replay(clean, generate_trace(TEST_BUCKETS[:2], seed=3))
    clean.close()
    assert sorted(results) == sorted(ref) and not service.rejects()
    for i in ref:
        assert results[i].x.tobytes() == ref[i].x.tobytes()
    snap = service.snapshot()
    assert snap["device_losses"] == 1 and snap["cache"]["evictions"] == 0
    assert snap["cache"]["misses"] > len(TEST_BUCKETS[:2])
    (loss,) = [e for e in service.metrics.events() if e["name"] == "serve.device_loss"]
    assert loss["attrs"] == {"lost": 1, "survivors": None}
    assert not os.listdir(wal)
