"""The port's resilience on the CPU against the reference (the local cases of
``tests/test_resilience.py``): options and their validation, the fallback
chain, the typed status, guarded solves bitwise free when healthy, the
singular-direction and negative-curvature operators through
``matvec_padded``, the ``raise``/``restart``/``fallback`` policies with
their ``resilience.attempt`` spans, residual replacement, and every
method, preconditioner and route with guards, telemetry and (where the
method declares it) residual replacement armed: the reference's iteration
count and status exactly, its telemetry's residual column as the history
is held and every other column within 1e-12 relative, scaled by the
residual's fall (``assert_telemetry_close``).  8³, 27pt, f64.
"""

import numpy as np
import pytest
import torch

from test_torch_harness import x64  # noqa: F401  (fixture)
from test_torch_harness import (assert_telemetry_close, ref_api, ref_module,
                                seeded, to_np)

from repro_torch.api import (ON_BREAKDOWN, REGISTRY, SolverOptions, SolverSession,
                             fallback_chain, solve, solver_names, variant_pairs)
from repro_torch.core.methods import (METHODS, STATUS_BREAKDOWN, STATUS_CONVERGED,
                                      STATUS_MAXITER, GuardSpec, SolveBreakdown)
from repro_torch.core.problems import from_reference, make_problem
from repro_torch.obs import trace as obs
from repro_torch.precond import precond_names

GRID = (8, 8, 8)


@pytest.fixture(scope="module")
def problems(x64):
    """The reference's 8³ 27pt problem and the port's copy of it."""
    jprob = ref_module("core.problems").make_problem(GRID, "27pt")
    prob = from_reference("27pt", GRID, np.dtype(np.float64), b=to_np(jprob.b()),
                          x0=to_np(jprob.x0()), device="cpu")
    return jprob, prob


@pytest.fixture(scope="module")
def problem():
    return make_problem(GRID, "27pt", torch.float64, "cpu")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view({8: torch.int64, 4: torch.int32}[t.element_size()])


def _assert_same_solve(got, want):
    """Iterations and status equal; iterate, residual norm, history and
    telemetry bitwise equal."""
    assert (got.iters, got.status) == (want.iters, want.status)
    for a, b in ((got.x, want.x), (got.res_norm, want.res_norm),
                 (got.history, want.history), (got.telemetry, want.telemetry)):
        assert (a is None and b is None) or torch.equal(_bits(a), _bits(b))


def _nan_rhs(problem) -> torch.Tensor:
    bad = problem.b().clone()
    bad[0, 0, 0] = float("nan")
    return bad


def _attempt_spans(path):
    return [r for r in obs.read_trace(path)
            if r["kind"] == "span" and r["name"] == "resilience.attempt"]


# -----------------------------------------------------------------------------
# options & registry plumbing
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("kw, match", [
    (dict(on_breakdown="retry"), "on_breakdown"),
    (dict(residual_replacement=-1), "residual_replacement"),
    (dict(guards=True, divergence_factor=0.5), "divergence_factor"),
    (dict(on_breakdown="restart", stagnation_rtol=0.0), "stagnation_rtol"),
    (dict(guards=True, breakdown_eps=-1.0), "breakdown_eps"),
    (dict(max_restarts=-1), "max_restarts"),
    (dict(telemetry_buffer=0), "telemetry_buffer"),
    (dict(halo_mode="ring"), "halo_mode"),
])
def test_options_validation(x64, kw, match):
    """Each bad value raises ``ValueError`` here and in the reference."""
    with pytest.raises(ValueError, match=match):
        SolverOptions(**kw)
    with pytest.raises(ValueError, match=match):
        ref_api().SolverOptions(**kw)


def test_option_fields_and_policies_match_the_reference(x64):
    """The port takes the reference's resilience and override fields with
    the reference's defaults, and its four policies."""
    import dataclasses
    ref = {f.name: f.default for f in dataclasses.fields(ref_api().SolverOptions)}
    port = {f.name: f.default for f in dataclasses.fields(SolverOptions)}
    for name in ("telemetry", "telemetry_buffer", "guards", "on_breakdown",
                 "max_restarts", "residual_replacement", "breakdown_eps",
                 "divergence_factor", "stagnation_window", "stagnation_rtol",
                 "dot", "matvec_padded", "halo_mode", "dims_map"):
        assert port[name] == ref[name], name
    assert ON_BREAKDOWN == ref_module("api.options").ON_BREAKDOWN
    for policy in ON_BREAKDOWN:
        assert SolverOptions(on_breakdown=policy).on_breakdown == policy


def test_guards_armed_semantics(x64):
    assert not SolverOptions().guards_armed()
    assert SolverOptions().guard_spec() is None
    assert SolverOptions(guards=True).guards_armed()
    assert SolverOptions(on_breakdown="restart").guards_armed()
    assert SolverOptions(on_breakdown="fallback").guard_spec() is not None
    assert not SolverOptions(on_breakdown="raise").guards_armed()
    assert not SolverOptions(on_breakdown="none").guards_armed()
    kw = dict(guards=True, breakdown_eps=1e-9, divergence_factor=1e4,
              stagnation_window=7, stagnation_rtol=0.5)
    assert SolverOptions(**kw).guard_spec() == GuardSpec(
        breakdown_eps=1e-9, divergence_factor=1e4, stagnation_window=7,
        stagnation_rtol=0.5)
    jspec = ref_api().SolverOptions(**kw).guard_spec()
    assert (jspec.breakdown_eps, jspec.divergence_factor, jspec.stagnation_window,
            jspec.stagnation_rtol) == (1e-9, 1e4, 7, 0.5)
    for maxiter, buf in ((600, 256), (10, 256), (600, 4)):
        opts = dict(telemetry=True, telemetry_buffer=buf, maxiter=maxiter)
        assert (SolverOptions(**opts).telemetry_rows()
                == ref_api().SolverOptions(**opts).telemetry_rows())
    assert SolverOptions(telemetry_buffer=4).telemetry_rows() == 0


def test_residual_replacement_requires_refresh_hook(problem):
    with pytest.raises(ValueError, match="residual_replacement"):
        SolverSession(problem, method="cg",
                      options=SolverOptions(residual_replacement=8))


@pytest.mark.parametrize("name", solver_names())
def test_fallback_chain_matches_the_reference(x64, name):
    jreg = ref_module("api.registry")
    assert fallback_chain(name) == jreg.fallback_chain(name)
    assert variant_pairs() == [p for p in jreg.variant_pairs()
                               if p[1] in REGISTRY]


def test_fallback_chain_walks_variant_ancestry():
    assert fallback_chain("cg") == ["cg"]
    assert fallback_chain("cg_merged") == ["cg_merged", "cg"]
    assert fallback_chain("pbicgstab_merged") == [
        "pbicgstab_merged", "pbicgstab", "bicgstab"]
    with pytest.raises(KeyError):
        fallback_chain("not_a_method")


# -----------------------------------------------------------------------------
# typed status: always on, and free when healthy
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["cg", "cg_merged", "bicgstab", "pcg"])
def test_status_converged_always_filled(problem, method):
    res = solve(problem, method=method, tol=1e-8, maxiter=500)
    assert res.status == STATUS_CONVERGED


def test_status_maxiter(problem):
    assert solve(problem, method="cg", tol=1e-12, maxiter=2).status == STATUS_MAXITER


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("method", ["cg", "cg_merged", "pcg_pipe"])
def test_nan_rhs_is_breakdown_even_without_guards(problem, method, kernels):
    res = SolverSession(problem, method=method,
                        options=SolverOptions(tol=1e-8, maxiter=50, kernels=kernels)
                        ).solve(_nan_rhs(problem))
    assert res.status == STATUS_BREAKDOWN and res.iters == 0


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("method, precond", [("cg_merged", "none"), ("bicgstab", "none"),
                                             ("pcg_merged", "chebyshev"),
                                             ("pbicgstab_merged", "jacobi")])
def test_guarded_solve_is_bitwise_free_when_healthy(problem, method, precond, kernels):
    """Guards and telemetry armed change nothing a healthy solve returns,
    on the cached solve and the eager loop."""
    base = dict(tol=1e-8, maxiter=200, precond=precond, kernels=kernels)
    plain = SolverSession(problem, method=method, options=SolverOptions(**base))
    guarded = SolverSession(problem, method=method, options=SolverOptions(
        guards=True, on_breakdown="none", telemetry=True, **base))
    for got, want in ((guarded.solve(), plain.solve()),
                      (guarded._solve_eager(), plain._solve_eager())):
        assert got.telemetry is not None and want.telemetry is None
        _assert_same_solve(got._replace(telemetry=None), want)
        assert got.status == STATUS_CONVERGED


# -----------------------------------------------------------------------------
# operators made singular or indefinite through matvec_padded
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("guards", [False, True])
@pytest.mark.parametrize("method", ["bicgstab", "bicgstab_merged"])
def test_bicgstab_singular_direction_never_silent(problems, method, guards):
    """A' = P·A, P zeroing the z=0 plane, with an RHS in that plane: α = ρ/0
    at k=0.  The exit is typed breakdown, guards or not, with the
    reference's iteration count."""
    jprob, prob = problems
    jst, st = jprob.stencil, prob.stencil

    def masked_mv(xp):
        y = st.matvec_padded(xp)
        y[:, :, 0] = 0.0
        return y

    b = np.zeros(GRID)
    b[:, :, 0] = 1.0
    kw = dict(tol=1e-8, maxiter=50, guards=guards, on_breakdown="none")
    res = SolverSession(prob, method=method, options=SolverOptions(
        matvec_padded=masked_mv, kernels=True, **kw)).solve(torch.from_numpy(b))
    api = ref_api()
    want = api.SolverSession(jprob, method=method, options=api.SolverOptions(
        matvec_padded=lambda xp: jst.matvec_padded(xp).at[:, :, 0].set(0.0), **kw)
    ).solve(b)
    assert res.status == STATUS_BREAKDOWN == int(want.status)
    assert res.iters == int(want.iters)


@pytest.mark.parametrize("method", ["cg_nb", "cg_merged"])
def test_negative_curvature_guard_exits_early(problems, method):
    """A shifted past the RHS's Rayleigh quotient: pᵀA'p < 0 at k=0.  The
    guarded loop exits at once (finite iterate, typed breakdown); the
    unguarded one must not claim convergence.  Both as the reference."""
    jprob, prob = problems
    st, jst = prob.stencil, jprob.stencil
    b = seeded(GRID, 0)
    Ab = st.matvec(torch.from_numpy(b)).numpy()
    shift = float((b * Ab).sum() / (b * b).sum()) + 5.0
    api = ref_api()

    def run(guards):
        kw = dict(tol=1e-8, maxiter=60, guards=guards, on_breakdown="none")
        got = SolverSession(prob, method=method, options=SolverOptions(
            matvec_padded=lambda xp: st.matvec_padded(xp) - shift * xp[1:-1, 1:-1, 1:-1],
            **kw)).solve(torch.from_numpy(b))
        want = api.SolverSession(jprob, method=method, options=api.SolverOptions(
            matvec_padded=lambda xp: jst.matvec_padded(xp) - shift * xp[1:-1, 1:-1, 1:-1],
            **kw)).solve(b)
        assert (got.iters, got.status) == (int(want.iters), int(want.status))
        return got

    guarded = run(True)
    assert guarded.status == STATUS_BREAKDOWN and guarded.iters == 0
    assert bool(torch.isfinite(guarded.x).all())
    assert run(False).status != STATUS_CONVERGED


def test_custom_matvec_padded_runs_on_a_plain_operator(problem):
    """Under ``kernels=True`` a custom ``matvec_padded`` keeps the solve on
    a plain ``LocalOp`` around it (a ``KernelOp`` would replace it with the
    stencil kernel) and off the fused body; a custom ``dot`` keeps it off
    the fused body."""
    from repro_torch.core.solvers import LocalOp
    calls = []

    def mv(xp):
        calls.append(1)
        return problem.stencil.matvec_padded(xp)

    sess = SolverSession(problem, method="cg_merged",
                         options=SolverOptions(kernels=True, matvec_padded=mv))
    assert type(sess._operator()) is LocalOp and not sess._use_fused_body()
    res = sess.solve()
    assert calls and res.status == STATUS_CONVERGED
    dots = []

    def dot(a, b):
        dots.append(1)
        return torch.dot(a.reshape(-1), b.reshape(-1))

    sess = SolverSession(problem, method="cg_merged", options=SolverOptions(kernels=True, dot=dot))
    assert not sess._use_fused_body()
    got = sess.solve()
    assert dots and got.iters == res.iters


# -----------------------------------------------------------------------------
# recovery policies
# -----------------------------------------------------------------------------

def test_raise_policy(problem):
    sess = SolverSession(problem, method="cg",
                         options=SolverOptions(tol=1e-8, maxiter=50, guards=True))
    with pytest.raises(SolveBreakdown) as exc:
        sess.solve(_nan_rhs(problem))
    assert exc.value.result.status == STATUS_BREAKDOWN
    assert exc.value.method == "cg" and "cg" in str(exc.value)


def test_restart_recovers_from_transient_breakdown(problem, tmp_path):
    """The first attempt is stamped breakdown with a finite garbage iterate;
    the restart policy re-enters from that iterate and converges."""
    sess = SolverSession(problem, method="cg",
                         options=SolverOptions(tol=1e-8, maxiter=300,
                                               on_breakdown="restart", max_restarts=3))
    real, calls = sess._solve_once, []

    def flaky(b=None, x0=None):
        calls.append(None if x0 is None else float(x0.reshape(-1)[0]))
        res = real(b, x0)
        if len(calls) == 1:
            return res._replace(x=torch.full_like(res.x, 0.5), status=STATUS_BREAKDOWN)
        return res

    sess._solve_once = flaky
    path = str(tmp_path / "restart.jsonl")
    obs.enable(path)
    try:
        res = sess.solve()
    finally:
        obs.disable()
    assert res.status == STATUS_CONVERGED
    assert calls == [None, 0.5]          # restarted FROM the last finite iterate
    spans = _attempt_spans(path)
    assert len(spans) == 1
    assert spans[0]["attrs"]["policy"] == "restart"
    assert spans[0]["attrs"]["from_status"] == "breakdown"
    assert {k: spans[0]["attrs"][k] for k in ("kernels", "dot", "matvec_padded")} == dict(
        kernels=False, dot=False, matvec_padded=False)


@pytest.mark.parametrize("kernels", [False, True])
def test_restart_starts_from_a_copy_of_the_iterate(problem, kernels):
    """The restart hands the next attempt a copy of the failed attempt's
    iterate, never the executable's static state."""
    sess = SolverSession(problem, method="cg_merged",
                         options=SolverOptions(tol=1e-8, maxiter=300, kernels=kernels,
                                               on_breakdown="restart", max_restarts=1))
    real, seen = sess._solve_once, []

    def stamped(b=None, x0=None):
        seen.append(x0)
        res = real(b, x0)
        return res._replace(status=STATUS_BREAKDOWN) if len(seen) == 1 else res

    sess._solve_once = stamped
    first = real()
    res = sess.solve()
    exe = sess._executables[GRID]
    assert torch.equal(seen[1], first.x)
    assert all(seen[1].data_ptr() != t.data_ptr() for s in exe._sets for t in s)
    assert res.status == STATUS_CONVERGED and res.iters <= 1


def test_restart_exhausts_budget_with_typed_status(problem, tmp_path):
    sess = SolverSession(problem, method="cg",
                         options=SolverOptions(tol=1e-8, maxiter=50,
                                               on_breakdown="restart", max_restarts=2))
    path = str(tmp_path / "exhaust.jsonl")
    obs.enable(path)
    try:
        res = sess.solve(_nan_rhs(problem))     # unfixable: b itself is NaN
    finally:
        obs.disable()
    assert res.status == STATUS_BREAKDOWN       # typed, never an exception
    assert len(_attempt_spans(path)) == 2       # the whole budget was spent


@pytest.mark.parametrize("kernels", [False, True])
def test_fallback_ladder_reaches_classic(problem, tmp_path, kernels):
    """Every primary attempt is stamped breakdown; the ladder runs the
    classical ancestor (first the same method without the kernels, when
    they were on) and returns its answer, bitwise the classical solve."""
    sess = SolverSession(problem, method="cg_merged",
                         options=SolverOptions(tol=1e-8, maxiter=300, kernels=kernels,
                                               on_breakdown="fallback", max_restarts=2))
    real = sess._solve_once
    sess._solve_once = lambda b=None, x0=None: real(b, x0)._replace(status=STATUS_BREAKDOWN)
    ladder = [name for name, _ in sess._fallback_ladder()]
    assert ladder == (["cg_merged", "cg"] if kernels else ["cg"])
    if kernels:                          # the first rung converges: stamp it too
        rung = sess._fallback_ladder()[0][1]
        rung_real = rung._solve_once
        rung._solve_once = lambda b=None, x0=None: rung_real(b, x0)._replace(
            status=STATUS_BREAKDOWN)
    path = str(tmp_path / "fallback.jsonl")
    obs.enable(path)
    try:
        res = sess.solve()
    finally:
        obs.disable()
    assert res.status == STATUS_CONVERGED
    spans = _attempt_spans(path)
    assert [s["attrs"]["method"] for s in spans] == ladder
    assert all(s["attrs"]["policy"] == "fallback" for s in spans)
    ref = solve(problem, method="cg", tol=1e-8, maxiter=300)
    assert torch.equal(res.x, ref.x)


@pytest.mark.parametrize("override", ["kernels", "dot", "matvec_padded"])
def test_fallback_rung_records_the_route(problem, tmp_path, override):
    """A primary attempt stamped breakdown is answered by the first rung, the
    same method with the override rolled back: its ``resilience.attempt``
    span and the ``resilience.fallback_rung`` event name the plain route."""
    value = {"matvec_padded": problem.stencil.matvec_padded,
             "dot": lambda a, b: torch.dot(a.reshape(-1), b.reshape(-1)),
             "kernels": True}[override]
    sess = SolverSession(problem, method="cg_merged", options=SolverOptions(
        tol=1e-8, maxiter=300, on_breakdown="fallback", **{override: value}))
    real = sess._solve_once
    sess._solve_once = lambda b=None, x0=None: real(b, x0)._replace(status=STATUS_BREAKDOWN)
    path = str(tmp_path / "rung.jsonl")
    obs.enable(path)
    try:
        res = sess.solve()
    finally:
        obs.disable()
    assert res.status == STATUS_CONVERGED
    plain = dict(kernels=False, dot=False, matvec_padded=False)
    spans = _attempt_spans(path)
    assert [s["attrs"]["method"] for s in spans] == ["cg_merged"]
    assert {k: spans[0]["attrs"][k] for k in plain} == plain
    rungs = [r["attrs"] for r in obs.read_trace(path)
             if r["kind"] == "event" and r["name"] == "resilience.fallback_rung"]
    assert rungs == [dict(rung=1, method="cg_merged", status="converged", **plain)]


def test_fallback_unfixable_returns_typed_status(problem):
    res = SolverSession(problem, method="cg_merged",
                        options=SolverOptions(tol=1e-8, maxiter=50,
                                              on_breakdown="fallback")
                        ).solve(_nan_rhs(problem))
    assert res.status == STATUS_BREAKDOWN


@pytest.mark.parametrize("override", ["matvec_padded", "dot", "kernels"])
def test_fallback_ladder_retreats_overrides_first(problem, override):
    """With a kernel or an override on, the first rung re-runs the same
    method with ``kernels``, ``matvec_padded`` and ``dot`` rolled back, then
    walks the ancestry; rungs never recurse and drop what their method
    cannot honour (residual replacement without a refresh hook)."""
    value = {"matvec_padded": problem.stencil.matvec_padded,
             "dot": lambda a, b: torch.dot(a.reshape(-1), b.reshape(-1)),
             "kernels": True}[override]
    sess = SolverSession(problem, method="cg_merged", options=SolverOptions(
        tol=1e-8, maxiter=50, on_breakdown="fallback", residual_replacement=8,
        **{override: value}))
    ladder = sess._fallback_ladder()
    assert [name for name, _ in ladder] == ["cg_merged", "cg"]
    for _, rung in ladder:
        assert rung.options.on_breakdown == "none" and rung.options.guards
        assert rung.options.matvec_padded is None and rung.options.dot is None
        assert not rung.options.kernels
    assert ladder[0][1].options.residual_replacement == 8   # has refresh
    assert ladder[1][1].options.residual_replacement == 0   # cg has none
    assert sess._fallback_ladder() is ladder                # built once


def test_fallback_drops_the_preconditioner_for_rungs_without_one(problem):
    sess = SolverSession(problem, method="pbicgstab_merged", options=SolverOptions(
        on_breakdown="fallback", precond="chebyshev"))
    ladder = sess._fallback_ladder()
    assert [(n, s.options.precond) for n, s in ladder] == [
        ("pbicgstab", "chebyshev"), ("bicgstab", "none")]


# -----------------------------------------------------------------------------
# residual replacement
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("method", ["cg_merged", "cg_pipe"])
def test_residual_replacement_converges(problems, method, kernels):
    """Converges with the reference's iterations and status, and the true
    residual (recomputed with the plain stencil) below the tolerance."""
    jprob, prob = problems
    kw = dict(tol=1e-8, maxiter=300, residual_replacement=8)
    res = SolverSession(prob, method=method,
                        options=SolverOptions(kernels=kernels, **kw)).solve()
    api = ref_api()
    want = api.SolverSession(jprob, method=method,
                             options=api.SolverOptions(pallas=kernels, **kw)).solve()
    assert res.status == STATUS_CONVERGED
    assert (res.iters, res.status) == (int(want.iters), int(want.status))
    true = torch.linalg.vector_norm(prob.b() - prob.stencil.matvec(res.x))
    assert float(true) < 1e-6


# -----------------------------------------------------------------------------
# every method, preconditioner and route against the reference
# -----------------------------------------------------------------------------

#: (method, precond, kernels): every method, each preconditioner it takes,
#: and both routes where the method has a fused body
PARITY = [(m, p, k) for m in solver_names()
          for p in (precond_names() if METHODS[m].accepts_precond else ("none",))
          for k in ((False, True) if METHODS[m].has_fused_body else (False,))]


@pytest.mark.parametrize("method, precond, kernels", PARITY)
def test_guarded_solve_matches_the_reference(problems, method, precond, kernels):
    """Guards (with stagnation detection) and telemetry armed, and residual
    replacement every 5 iterations where the method declares it: the cached
    solve gives the reference's iterations and status and its telemetry,
    and is bitwise the eager loop."""
    jprob, prob = problems
    kw = dict(tol=1e-8, maxiter=300, precond=precond, guards=True,
              on_breakdown="none", stagnation_window=25, telemetry=True,
              residual_replacement=5 if METHODS[method].has_refresh else 0)
    sess = SolverSession(prob, method=method, options=SolverOptions(kernels=kernels, **kw))
    got = sess.solve()
    api = ref_api()
    want = api.solve(jprob, method=method, options=api.SolverOptions(pallas=kernels, **kw))
    assert (got.iters, got.status) == (int(want.iters), int(want.status))
    mdef = METHODS[method]
    assert_telemetry_close(got.telemetry, want.telemetry, want.history, got.iters,
                           mdef.scalars.index(mdef.res_scalar))
    _assert_same_solve(got, sess._solve_eager())
