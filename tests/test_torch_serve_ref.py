"""The port's solver service against the reference's (``repro.serve``), on the
CPU.

``SMOKE_BUCKETS`` (seed 0) is replayed through the reference's
``SolverService`` and the port's, builds inline (``async_compile=False``)
so both dispatch in one order, on both routes: ``pallas=False`` against
``kernels=False``, and ``pallas=True`` (the reference's Pallas kernels in
interpret mode) against ``kernels=True`` (the kernels' plain versions).
Per request: the same bucket string, equal ``iters`` and ``status``, ``x``
within 1e-12 absolute and ``res_norm`` within rtol 1e-10 (the tolerances of
``tests/test_torch_batched_ref.py``); the same ``snapshot()`` key set and
the same cache counters and ``per_bucket`` names.  Also a ``norm_ref=None``
request in a padded batch, and the journal and a checkpoint written by each
package restored by the other.  The reference is reached through
``tests/test_torch_harness.py``'s shim and its ``x64`` fixture.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import x64  # noqa: F401  (fixture)
from test_torch_harness import ref_module

from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime.monitor import FailureInjector
from repro_torch.serve import (SMOKE_BUCKETS, Request, ServeConfig, SolverService,
                               generate_trace, replay)

ROUTES = pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])


def _ref_serve():
    return ref_module("serve")


def _assert_agree(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for i in want:
        g, w = got[i], want[i]
        assert g.bucket == w.bucket, i
        assert (g.iters, g.status) == (int(w.iters), w.status), (i, g.bucket)
        np.testing.assert_allclose(g.x, np.asarray(w.x), rtol=0, atol=1e-12,
                                   err_msg=f"request {i} ({g.bucket})")
        np.testing.assert_allclose(g.res_norm, float(w.res_norm), rtol=1e-10)


@ROUTES
def test_smoke_trace_matches_reference_service(x64, kernels):
    rs = _ref_serve()
    ref_svc = rs.SolverService(rs.ServeConfig(max_batch=4, async_compile=False,
                                              pallas=kernels))
    want = rs.replay(ref_svc, rs.generate_trace(rs.SMOKE_BUCKETS, seed=0))
    ref_svc.close()
    svc = SolverService(ServeConfig(max_batch=4, async_compile=False, kernels=kernels,
                                    device="cpu"))
    trace = generate_trace(SMOKE_BUCKETS, seed=0)
    got = replay(svc, trace)
    svc.close()
    for mine, theirs in zip(trace, rs.generate_trace(rs.SMOKE_BUCKETS, seed=0)):
        assert mine.b.tobytes() == np.asarray(theirs.b).tobytes()    # the same payloads
    _assert_agree(got, want)
    snap, ref_snap = svc.snapshot(), ref_svc.snapshot()
    assert snap.keys() == ref_snap.keys()
    for k in ("completed", "preemptions", "requeued", "rejected", "service_rejects",
              "rejects_by_reason", "retries", "device_losses", "queue_depth"):
        assert snap[k] == ref_snap[k], k
    assert snap["per_bucket"].keys() == ref_snap["per_bucket"].keys()
    cache, ref_cache = snap["cache"], ref_snap["cache"]
    for k in ("hits", "misses", "evictions", "entries", "capacity"):
        assert cache[k] == ref_cache[k], k
    assert cache["per_bucket"].keys() == ref_cache["per_bucket"].keys()
    for b, st in cache["per_bucket"].items():
        assert {k: v for k, v in st.items() if k != "compile_s"} == {
            k: v for k, v in ref_cache["per_bucket"][b].items() if k != "compile_s"}


def test_relative_request_in_padded_batch_matches_reference(x64):
    """``norm_ref=None`` requests, two in a ``max_batch=4`` bucket: the port's
    served lanes are the reference's, and the zero pad lanes stop alike."""
    rs = _ref_serve()
    rng = np.random.default_rng(6)
    payloads = [rng.standard_normal((8, 6, 10)) for _ in range(2)]
    kw = dict(method="cg", norm_ref=None, tol=1e-9, maxiter=80)
    ref_svc = rs.SolverService(rs.ServeConfig(max_batch=4, async_compile=False))
    for b in payloads:
        ref_svc.submit(rs.Request(b=b, **kw))
    want = ref_svc.run_until_drained()
    ref_svc.close()
    svc = SolverService(ServeConfig(max_batch=4, async_compile=False, device="cpu"))
    for b in payloads:
        svc.submit(Request(b=b, **kw))
    got = svc.run_until_drained()
    svc.close()
    _assert_agree(got, want)
    (entry,) = ref_svc.cache._entries.values()
    pad = entry.session.solve_batched(jnp.zeros((4, 8, 6, 10)))
    (mine,) = svc.cache._entries.values()
    pad_mine = mine.session.solve_batched(torch.zeros((4, 8, 6, 10), dtype=torch.float64))
    assert pad_mine.iters.tolist() == np.asarray(pad.iters).tolist()
    assert pad_mine.status.tolist() == np.asarray(pad.status).tolist()


class _HardDeath(RuntimeError):
    """Not a SimulatedFailure: the dispatch dies with its journal on disk."""


def _killer(base):
    class Kill(base):
        def maybe_fail(self, step):
            if step == self.fail_at_step and not self.fired:
                self.fired = True
                raise _HardDeath(f"died at dispatch {step}")
    return Kill(fail_at_step=0)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_journal_recovers_across_packages(x64, tmp_path, writer):
    """A service of one package dies mid-dispatch; a service of the other
    recovers its journal and completes the orphans as a clean service of
    the writer would (within the parity tolerances)."""
    rs = _ref_serve()
    monitor = ref_module("runtime.monitor")
    wal = str(tmp_path / "wal")
    rng = np.random.default_rng(12)
    payloads = [rng.standard_normal((8, 8, 8)) for _ in range(3)]
    kw = dict(method="pcg", precond="jacobi", precond_params={"sweeps": 2}, maxiter=200)

    def port(**cfg):
        return SolverService(ServeConfig(max_batch=4, async_compile=False, device="cpu",
                                         **cfg))

    if writer == "port":
        dying = port(recovery_dir=wal)
        dying.injector = _killer(FailureInjector)
        Req, Recovering = Request, (lambda: rs.SolverService(rs.ServeConfig(
            max_batch=4, recovery_dir=wal, async_compile=False)))
    else:
        dying = rs.SolverService(rs.ServeConfig(max_batch=4, async_compile=False,
                                                recovery_dir=wal),
                                 injector=_killer(monitor.FailureInjector))
        Req, Recovering = rs.Request, (lambda: port(recovery_dir=wal))
    for b in payloads:
        dying.submit(Req(b=b, **kw))
    with pytest.raises(_HardDeath):
        dying.run_until_drained()
    dying.close()
    assert any(f.startswith("wal_") for f in os.listdir(wal))
    fresh = Recovering()
    remap = fresh.recover()
    results = fresh.run_until_drained()
    fresh.close()
    assert len(remap) == 3 and not os.listdir(wal)
    clean = port()
    for b in payloads:
        clean.submit(Request(b=b, **kw))
    refs = clean.run_until_drained()
    clean.close()
    _assert_agree({old: results[new] for old, new in remap.items()},
                  {old: refs[old] for old in remap})


def _tree(rng):
    return {"f64": rng.standard_normal((3, 4)), "f32": rng.standard_normal(5).astype(np.float32),
            "i64": np.arange(6, dtype=np.int64).reshape(2, 3),
            "i32": np.arange(4, dtype=np.int32),
            "zero_d": np.asarray(2.5), "nest": [np.ones(2), (np.zeros(3, np.int64),)]}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_restores_across_packages(x64, tmp_path, writer):
    """A checkpoint of f64, f32, int and 0-d leaves written by one package
    restores bitwise in the other (numpy templates, and tensor templates in
    the port); the two packages write the same leaf files and manifest."""
    ref_ckpt = ref_module("runtime.checkpoint")
    state = _tree(np.random.default_rng(3))
    template = _tree(np.random.default_rng(4))
    d = str(tmp_path / writer)
    if writer == "port":
        ckpt.save(state, d, step=7)
        back, step = ref_ckpt.restore(template, d)
        other = str(tmp_path / "other")
        ref_ckpt.save({k: jnp.asarray(v) if k != "nest" else v for k, v in state.items()},
                      other, step=7)
    else:
        ref_ckpt.save({k: jnp.asarray(v) if k != "nest" else v for k, v in state.items()},
                      d, step=7)
        back, step = ckpt.restore(template, d)
        as_tensors, _ = ckpt.restore({k: torch.from_numpy(np.array(v)) if k != "nest" else v
                                      for k, v in template.items()}, d)
        for k in ("f64", "f32", "i64", "i32", "zero_d"):
            assert as_tensors[k].numpy().tobytes() == state[k].tobytes()
            assert as_tensors[k].shape == state[k].shape
        other = str(tmp_path / "other")
        ckpt.save(state, other, step=7)
    assert step == 7
    leaves = lambda t: [leaf for _, leaf in ckpt._paths(t)]  # noqa: E731
    for g, w in zip(leaves(back), leaves(state)):
        g = np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()
    a, b = (os.path.join(p, "step_00000007") for p in (d, other))
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    import json
    with open(os.path.join(a, "manifest.json")) as f, \
            open(os.path.join(b, "manifest.json")) as g:
        assert json.load(f) == json.load(g)
