"""The port's observability on the CPU against the reference (the local cases
of ``tests/test_obs.py``): telemetry off is the solve without it, bit for
bit; telemetry on reports the truth (its residual column is the history,
its last entry the offline true residual, every method's buffer the
reference's: the same iterations and status, the residual column held as
the history is and the other entries within 1e-12 relative scaled by the
residual's fall); the buffer's overflow keeps the final state;
the ``repro.obs/v1`` span stream round-trips through ``python -m
repro_torch.obs summarize --check``; and the port's copy of the schema
agrees with the reference's.  10×10×12 and 8³, 27pt, f64.
"""

import json

import numpy as np
import pytest
import torch

from test_torch_harness import x64  # noqa: F401  (fixture)
from test_torch_harness import assert_telemetry_close, ref_api, ref_module, to_np

from repro_torch.api import SolverOptions, SolverSession, solve, solver_names
from repro_torch.core.methods import METHODS, get_method
from repro_torch.core.problems import from_reference, make_problem
from repro_torch.core.solvers import SOLVERS, LocalOp
from repro_torch.obs import trace as obs
from repro_torch.obs.convergence import (curve_record, effective_rows, residual_curve,
                                         scalar_history, telemetry_residuals,
                                         true_residual_norm)
from repro_torch.precond import precond_names

SHAPE = (10, 10, 12)
GRID = (8, 8, 8)


@pytest.fixture(scope="module")
def problem():
    return make_problem(SHAPE, "27pt", torch.float64, "cpu")


@pytest.fixture(scope="module")
def problems(x64):
    jprob = ref_module("core.problems").make_problem(GRID, "27pt")
    prob = from_reference("27pt", GRID, np.dtype(np.float64), b=to_np(jprob.b()),
                          x0=to_np(jprob.x0()), device="cpu")
    return jprob, prob


@pytest.fixture()
def tracer_path(tmp_path):
    """An enabled tracer for the test body, torn down unconditionally."""
    path = str(tmp_path / "trace.jsonl")
    obs.enable(path)
    yield path
    obs.disable()


def _res_col(method: str) -> int:
    """The telemetry column of the method's residual scalar."""
    mdef = get_method(method)
    return mdef.scalars.index(mdef.res_scalar)


def _tele_opts(**kw):
    base = dict(tol=1e-8, maxiter=2000, telemetry=True, telemetry_buffer=4096)
    base.update(kw)
    return SolverOptions(**base)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view({8: torch.int64, 4: torch.int32}[t.element_size()])


# -----------------------------------------------------------------------------
# telemetry off == the solve without it
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("method", ["cg", "cg_merged", "bicgstab"])
def test_telemetry_off_is_bitwise_noop(problem, method, kernels):
    off = solve(problem, method=method, tol=1e-8, maxiter=2000, kernels=kernels)
    on = solve(problem, method=method, options=_tele_opts(kernels=kernels))
    assert off.telemetry is None and on.telemetry is not None
    assert (off.iters, off.status) == (on.iters, on.status)
    for a, b in ((off.x, on.x), (off.res_norm, on.res_norm), (off.history, on.history)):
        assert torch.equal(_bits(a), _bits(b))


def test_telemetry_off_matches_direct_solver_bitwise(problem):
    res = solve(problem, method="cg", tol=1e-8, maxiter=2000)
    ref = SOLVERS["cg"](LocalOp(problem.stencil), problem.b(), problem.x0(),
                        tol=1e-8, maxiter=2000, norm_ref=1.0)
    assert torch.equal(res.x, ref.x)
    assert res.telemetry is None and ref.telemetry is None


# -----------------------------------------------------------------------------
# telemetry on: the curves are true
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("method,precond", [
    ("cg", "none"), ("bicgstab", "none"), ("pcg", "jacobi"), ("pcg_merged", "chebyshev"),
])
def test_telemetry_matches_offline_residual(problem, method, precond):
    """The buffered curve's last entry is ``res_norm`` and, within the
    recurrences' drift, the offline ``||b - A x||``."""
    res = solve(problem, method=method, options=_tele_opts(maxiter=400, precond=precond))
    tele_res = telemetry_residuals(res, method)
    true_res = true_residual_norm(LocalOp(problem.stencil), problem.b(), res.x)
    assert tele_res.shape == (res.iters + 1,)
    assert float(tele_res[-1]) == pytest.approx(float(res.res_norm))
    assert float(tele_res[-1]) == pytest.approx(true_res, rel=1e-3, abs=1e-10)


@pytest.mark.parametrize("method, kernels", [
    (m, k) for m in sorted(SOLVERS)
    for k in ((False, True) if METHODS[m].has_fused_body else (False,))])
def test_telemetry_all_methods_local(problem, method, kernels):
    """Every method carries a buffer whose residual column reproduces the
    driver's history (on the fused route too, where it has one)."""
    mdef = get_method(method)
    res = solve(problem, method=method, options=_tele_opts(maxiter=600, kernels=kernels))
    assert res.telemetry.shape == (601, len(mdef.scalars))
    rows = effective_rows(res)
    assert rows == res.iters + 1
    np.testing.assert_allclose(telemetry_residuals(res, method),
                               to_np(res.history)[:rows], rtol=1e-12, atol=0)
    hist = scalar_history(res, method)
    assert set(hist) == set(mdef.scalars)
    assert all(v.shape == (rows,) for v in hist.values())


@pytest.mark.parametrize("route", ["cached", "eager"])
def test_telemetry_buffer_overflow_keeps_final_state(problems, route):
    """A buffer smaller than the iteration count overwrites its last row:
    no NaNs, the last row holds the final scalar state, and the buffer is
    the reference's."""
    jprob, prob = problems
    kw = dict(tol=1e-12, maxiter=50, telemetry=True, telemetry_buffer=4)
    sess = SolverSession(prob, method="jacobi", options=SolverOptions(**kw))
    res = sess.solve() if route == "cached" else sess._solve_eager()
    tele = to_np(res.telemetry)
    assert tele.shape[0] == 4 and res.iters > 4
    assert not np.isnan(tele).any()
    assert float(np.sqrt(tele[-1, 0])) == pytest.approx(float(res.res_norm))
    assert effective_rows(res) == 4
    api = ref_api()
    want = api.solve(jprob, method="jacobi", options=api.SolverOptions(**kw))
    assert res.iters == int(want.iters)
    assert_telemetry_close(res.telemetry, want.telemetry, want.history, res.iters,
                           _res_col("jacobi"))


def test_curve_record_is_json_able(problem):
    res = solve(problem, method="cg", options=_tele_opts(maxiter=400))
    rec = curve_record(res, "cg", scalars=True)
    json.dumps(rec)
    assert rec["iters"] == res.iters
    assert len(rec["residuals"]) == res.iters + 1
    assert rec["telemetry_rows"] == res.iters + 1
    assert rec["residuals"][-1] == pytest.approx(float(res.res_norm))
    np.testing.assert_allclose(rec["scalars"]["rr"],
                               to_np(res.history)[:res.iters + 1] ** 2, rtol=1e-12)
    np.testing.assert_allclose(residual_curve(res), rec["residuals"])
    assert "telemetry_rows" not in curve_record(solve(problem, method="cg"), "cg")


def test_curve_record_matches_the_reference_cli(x64, capsys):
    """``--telemetry --json`` of the port's CLI against the reference's: the
    same iterations, rows and scalar names, the curves within 1e-10."""
    from repro_torch.launch import solve as tlaunch
    flags = ["--method", "pcg_merged", "--precond", "jacobi", "--grid", "8", "8", "8",
             "--telemetry", "--telemetry-buffer", "64", "--json"]
    ref = ref_module("launch.solve").main(flags)["convergence"]
    out = tlaunch.main(flags + ["--device", "cpu"])["convergence"]
    assert (out["iters"], out["telemetry_rows"]) == (ref["iters"], ref["telemetry_rows"])
    assert sorted(out["scalars"]) == sorted(ref["scalars"])
    np.testing.assert_allclose(out["residuals"], ref["residuals"], rtol=1e-10)
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["convergence"]["iters"] == out["iters"]


#: (method, precond, kernels): every method, each preconditioner it takes,
#: and both routes where the method has a fused body
PARITY = [(m, p, k) for m in solver_names()
          for p in (precond_names() if METHODS[m].accepts_precond else ("none",))
          for k in ((False, True) if METHODS[m].has_fused_body else (False,))]


@pytest.mark.parametrize("method, precond, kernels", PARITY)
def test_telemetry_matches_the_reference(problems, method, precond, kernels):
    """Telemetry alone (no guards): the reference's iterations, status and
    buffer, on the cached solve and the eager loop alike."""
    jprob, prob = problems
    kw = dict(tol=1e-8, maxiter=300, precond=precond, telemetry=True, telemetry_buffer=40)
    sess = SolverSession(prob, method=method, options=SolverOptions(kernels=kernels, **kw))
    got = sess.solve()
    api = ref_api()
    want = api.solve(jprob, method=method, options=api.SolverOptions(pallas=kernels, **kw))
    assert (got.iters, got.status) == (int(want.iters), int(want.status))
    assert_telemetry_close(got.telemetry, want.telemetry, want.history, got.iters,
                           _res_col(method))
    assert torch.equal(_bits(got.telemetry), _bits(sess._solve_eager().telemetry))


# -----------------------------------------------------------------------------
# the span stream: schema, nesting, CLI summarizer round-trip
# -----------------------------------------------------------------------------

def test_span_stream_roundtrip(problem, tracer_path, capsys):
    sess = SolverSession(problem, method="cg", options=SolverOptions(tol=1e-8, maxiter=300))
    sess.solve()
    sess.solve()                       # second call: an executable-cache hit
    obs.disable()

    assert obs.validate_stream(tracer_path) == []
    by_name = {}
    for r in obs.read_trace(tracer_path):
        by_name.setdefault(r["name"], []).append(r)
    for name in ("resolve", "precond.setup", "compile", "solve", "execute"):
        assert name in by_name, name
    assert len(by_name["solve"]) == 2
    assert len(by_name["compile"]) == 1      # the second solve reused the cache
    solve_ids = {r["span_id"] for r in by_name["solve"]}
    assert all(r["parent_id"] in solve_ids for r in by_name["execute"])

    from repro_torch.obs.__main__ import main as obs_main
    assert obs_main(["summarize", tracer_path, "--check", "--json"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["schema_errors"] == 0
    assert summary["spans"]["solve"]["count"] == 2
    assert summary["spans"]["execute"]["p50_s"] is not None
    assert obs_main(["summarize", tracer_path]) == 0          # the table view
    assert "span   solve" in capsys.readouterr().out


def test_batched_and_timed_solves_are_traced(problem, tracer_path):
    sess = SolverSession(problem, method="cg", options=SolverOptions(tol=1e-8, maxiter=300))
    sess.solve_batched(torch.stack([problem.b(), problem.b()]))
    sess.timed_solve(repeats=1)
    obs.disable()
    solves = [r for r in obs.read_trace(tracer_path) if r["name"] == "solve"]
    assert [r["attrs"].get("batch") for r in solves] == [2, None]
    assert solves[1]["attrs"]["timed"] is True


def test_batched_input_is_converted_before_its_span(problem, tracer_path):
    """``solve_batched`` takes what its checks take (a nested list, traced
    with its batch) and raises their ValueError on a 0-d input, tracing
    on."""
    sess = SolverSession(problem, method="cg", options=SolverOptions(tol=1e-8, maxiter=300))
    b = problem.b()
    res = sess.solve_batched([b.tolist()])
    assert torch.equal(res.x, sess.solve_batched(b[None]).x)
    with pytest.raises(ValueError, match="batch"):
        sess.solve_batched(torch.tensor(1.0))
    obs.disable()
    solves = [r for r in obs.read_trace(tracer_path) if r["name"] == "solve"]
    assert [r["attrs"]["batch"] for r in solves] == [1, 1]


def test_summarize_check_fails_on_bad_record(tmp_path):
    path = tmp_path / "bad.jsonl"
    good = obs.make_event("ok")
    bad = {"schema": obs.SCHEMA, "kind": "span", "name": "x"}  # missing keys
    path.write_text(json.dumps(good) + "\n" + json.dumps(bad) + "\n")
    from repro_torch.obs.__main__ import main as obs_main
    assert obs_main(["summarize", str(path), "--check"]) == 1
    assert obs_main(["summarize", str(path)]) == 0   # report-only mode


def test_tracer_disabled_is_noop():
    obs.disable()
    with obs.span("nothing") as sid:
        assert sid is None
    assert obs.event("nothing") is not None      # record built, not written
    assert not obs.active()


def test_repro_trace_environment_variable(tmp_path, monkeypatch):
    """``REPRO_TRACE=PATH`` turns tracing on at first use; an explicit
    ``disable()`` wins over it."""
    path = tmp_path / "env.jsonl"
    monkeypatch.setenv("REPRO_TRACE", str(path))
    monkeypatch.setattr(obs, "_tracer", None)
    monkeypatch.setattr(obs, "_env_checked", False)
    try:
        with obs.span("from_env"):
            pass
        assert obs.active()
    finally:
        obs.disable()
    assert [r["name"] for r in obs.read_trace(str(path))] == ["from_env"]
    assert not obs.active()


def test_schema_copies_agree(x64, tmp_path):
    """The port's ``obs/trace.py`` and the reference's share the schema tag,
    the required keys, and each other's verdicts and summaries: records made
    by either validate with both, a broken one fails with both."""
    jobs = ref_module("obs.trace")
    assert obs.SCHEMA == jobs.SCHEMA == "repro.obs/v1"
    assert obs.REQUIRED_KEYS == jobs.REQUIRED_KEYS
    path = str(tmp_path / "mixed.jsonl")
    obs.enable(path)
    try:
        with obs.span("port.span", n=1):
            obs.event("port.event", k=2)
    finally:
        obs.disable()
    jobs.enable(path)
    try:
        with jobs.span("ref.span"):
            jobs.event("ref.event")
        jobs.emit(jobs.make_metric("ref.metric", x=1))
    finally:
        jobs.disable()
    obs.emit(obs.make_metric("port.metric"))                 # tracing off: dropped
    records = obs.read_trace(path)
    records.append(obs.make_metric("port.metric", y=3))
    assert [r["kind"] for r in records] == ["event", "span", "event", "span",
                                            "metric", "metric"]
    for rec in records:
        assert obs.validate_record(rec) == [] == jobs.validate_record(rec)
    broken = dict(records[1], dur_s=records[1]["dur_s"] + 1.0)
    assert obs.validate_record(broken) == jobs.validate_record(broken) != []
    assert obs.validate_record({"kind": "?"}) == jobs.validate_record({"kind": "?"})
    assert obs.summarize(records) == jobs.summarize(records)
    assert obs.validate_stream(path) == jobs.validate_stream(path) == []


def test_resilience_smoke_trace_passes_summarize_check(tmp_path, capsys):
    """``python -m repro_torch.resilience --smoke --device cpu``: every check
    ok (the solver half's three and the serve half's six), and its trace
    passes ``summarize --check``."""
    from repro_torch.obs.__main__ import main as obs_main
    from repro_torch.resilience.__main__ import main as chaos_main
    path = str(tmp_path / "TRACE_chaos.jsonl")
    assert chaos_main(["--smoke", "--device", "cpu", "--out", path]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["ok"] and set(summary["checks"]) == {
        "nan_raises", "fallback_clean_converges", "trace_validates",
        "compile_fail_rejects", "clean_complete", "poison_quarantined",
        "deadline_rejected", "retry_not_requeue", "nothing_stranded"}
    assert obs_main(["summarize", path, "--check"]) == 0
    names = {r["name"] for r in obs.read_trace(path)}
    assert {"chaos.smoke", "solve", "execute", "compile", "serve.compile",
            "serve.dispatch", "serve.compile_failed", "serve.retry",
            "serve.reject"} <= names


def test_chaos_injector_poisons_by_seed():
    """``ChaosInjector.poison_b``: seeded, never mutates its input, works on
    numpy arrays and tensors alike; the failure hooks fire once each."""
    from repro_torch.resilience import (ChaosInjector, ChaosPlan, CompileFailure,
                                        DeviceLost, SimulatedFailure)
    b = np.ones(GRID)
    inj = ChaosInjector(ChaosPlan(seed=3, nan_rate=1.0, nan_count=2))
    out, hit = inj.poison_b(b)
    assert hit and np.isnan(out).sum() in (1, 2) and not np.isnan(b).any()
    inj_t = ChaosInjector(ChaosPlan(seed=3, nan_rate=1.0, nan_count=2))
    out_t, hit_t = inj_t.poison_b(torch.ones(GRID, dtype=torch.float64))
    assert hit_t and np.array_equal(np.isnan(out_t.numpy()), np.isnan(out))
    assert ChaosInjector(ChaosPlan(seed=0)).poison_b(b) == (b, False)
    plan = ChaosPlan(seed=0, preempt_at=(1,), device_loss_at=(2,), lose_devices=(5,),
                     fail_compile_buckets=("cg",))
    inj = ChaosInjector(plan)
    inj.maybe_fail(0)
    with pytest.raises(SimulatedFailure):
        inj.maybe_fail(1)
    inj.maybe_fail(1)                      # once only
    with pytest.raises(DeviceLost) as lost:
        inj.maybe_fail(2)
    assert lost.value.lost == (5,)
    with pytest.raises(CompileFailure):
        inj.maybe_fail_compile("cg/27pt")
    assert inj.compile_failures == 1
    for bad in (dict(nan_rate=2.0), dict(nan_count=0), dict(halo_delay_s=-1.0)):
        with pytest.raises(ValueError):
            ChaosPlan(**bad)
