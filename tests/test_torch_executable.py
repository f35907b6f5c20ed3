"""The session's executable cache on the CPU: ``SolverSession.solve`` through
``api.executable.SolveExecutable`` and ``core.methods.run_method_blocks``
(the block driver, its steps run eagerly on the executable's static buffers)
against the session's eager loop (``run_method``, one read per iteration).

Every comparison is bitwise: iterations, status, iterate, residual norm and
the NaN-padded history, in f64 and f32, on ragged grids, on both routes
(``kernels=True``: the fused bodies on the kernels' plain versions).  The
ladders are forced to run past the stop and roll back; the threshold's f32
rounding, inputs that change between solves and the cache's counters are
checked; and the iteration counts hold against the reference's
``pallas=False``/``pallas=True`` solves.
"""

import math

import numpy as np
import pytest
import torch

from test_torch_harness import x64  # noqa: F401  (fixture)
from test_torch_harness import ref_api, ref_module, seeded, to_np

from repro_torch.api import SolverOptions, SolverSession, solver_names
from repro_torch.api.executable import SolveExecutable
from repro_torch.core.methods import (METHODS, MethodDef, Ops, block_ladder,
                                      pick_block, predict_steps, run_method,
                                      run_method_blocks)
from repro_torch.core.problems import from_reference, make_problem
from repro_torch.core.solvers import LocalOp

#: every method without a preconditioner, each preconditioner with
#: pcg_merged, and one with each other method that takes one
CASES = ([(m, "none") for m in solver_names()]
         + [("pcg_merged", p) for p in ("jacobi", "block_jacobi", "ssor", "chebyshev")]
         + [("pcg", "block_jacobi"), ("pcg_pipe", "ssor"), ("pbicgstab", "chebyshev"),
            ("pbicgstab_merged", "jacobi")])
#: (grid, stencil, dtype): ragged grids, both stencils, both precisions
PROBLEMS = [((10, 7, 13), "27pt", torch.float64), ((5, 9, 6), "7pt", torch.float32),
            ((5, 9, 6), "27pt", torch.float64), ((10, 7, 13), "7pt", torch.float32)]


def _session(method, precond="none", grid=(10, 7, 13), stencil="27pt",
             dtype=torch.float64, **opts) -> SolverSession:
    opts.setdefault("maxiter", 300)
    return SolverSession(method=method, grid=grid, stencil=stencil, device="cpu",
                         options=SolverOptions(precond=precond,
                                               f64=dtype == torch.float64, **opts))


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bit patterns (NaN included) as integers."""
    return t.contiguous().view({8: torch.int64, 4: torch.int32}[t.element_size()])


def _assert_same_solve(got, want):
    """Iterations and status equal; iterate, residual norm and NaN-padded
    history bitwise equal."""
    assert (got.iters, got.status) == (want.iters, want.status)
    for a, b in ((got.x, want.x), (got.res_norm, want.res_norm),
                 (got.history, want.history)):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _always_the_largest(ladder, predicted, budget):
    """A pick that ignores the prediction: every block takes the largest
    rung the budget allows, so a solve runs past its stop and rolls back."""
    return max(k for k in ladder if k <= budget)


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("problem", PROBLEMS[:2], ids=str)
@pytest.mark.parametrize("method, precond", CASES)
def test_cached_solve_matches_eager(method, precond, problem, kernels):
    """``solve`` (the executable, a miss, then a hit) against the eager loop."""
    grid, st, dt = problem
    sess = _session(method, precond, grid, st, dt, kernels=kernels)
    want = sess._solve_eager()
    _assert_same_solve(sess.solve(), want)
    _assert_same_solve(sess.solve(), want)
    assert want.x.dtype == dt


@pytest.mark.parametrize("problem", PROBLEMS[2:], ids=str)
@pytest.mark.parametrize("method", ["cg_merged", "pcg_pipe", "bicgstab_merged",
                                    "gauss_seidel_rb", "jacobi"])
def test_cached_solve_matches_eager_other_problems(method, problem):
    grid, st, dt = problem
    sess = _session(method, "none", grid, st, dt, kernels=True)
    _assert_same_solve(sess.solve(), sess._solve_eager())


@pytest.mark.parametrize("max_block", [1, 4, 16])
@pytest.mark.parametrize("method, precond", [
    ("cg_merged", "none"), ("cg_pipe", "none"), ("pbicgstab_merged", "jacobi"),
    ("gauss_seidel", "none"), ("bicgstab_b1", "none")])
@pytest.mark.parametrize("maxiter", [300, 7, 0])
def test_rollback_matches_eager(method, precond, max_block, maxiter):
    """Every block takes the largest rung (so each converged solve runs past
    its stop and is run again from the block's start), with a ``maxiter``
    that ends inside the first block of 16 and ``maxiter = 0``."""
    sess = _session(method, precond, kernels=True, maxiter=maxiter)
    sess._max_block = max_block
    want = sess._solve_eager()
    sess.solve()
    exe = sess._executables[(10, 7, 13)]
    assert exe.ladder == block_ladder(max_block)
    exe.pick = _always_the_largest
    got = sess.solve()
    _assert_same_solve(got, want)
    assert all(k in exe.ladder for k in exe.blocks)
    if maxiter == 0:
        assert got.iters == 0 and exe.blocks == []
    elif maxiter == 7:                           # the budget caps each block
        assert got.iters == 7 and got.status == 1
        assert exe.blocks == ([1] * 7 if max_block == 1 else [4, 2, 1])
    elif got.iters % max_block:
        assert sum(exe.blocks) > got.iters           # it ran past and redid


def test_rollback_redoes_the_steps_in_rungs():
    """A block of 16 that stops after ``rest`` of its steps is dropped and
    ``rest`` steps run again from its start in rungs (11 = 8 + 2 + 1), with
    no read between them."""
    sess = _session("cg_merged", kernels=True)
    want = sess._solve_eager()
    assert want.iters % 16
    sess.solve()
    exe = sess._executables[(10, 7, 13)]
    exe.pick = _always_the_largest
    got = sess.solve()
    _assert_same_solve(got, want)
    full, rest = divmod(want.iters, 16)
    redo = [k for k in (8, 4, 2, 1) if rest & k]
    assert exe.blocks == [16] * full + ([16] + redo if rest else [])


@pytest.mark.parametrize("dt", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("method", ["cg", "bicgstab_b1", "jacobi"])
def test_inputs_change_between_solves(method, dt):
    """Under ``norm_ref=None`` each solve takes its own ``b``, norm and
    threshold: a second ``b`` and ``x0``, then the first again, give what
    fresh eager solves give; the first solve's inputs build the executable
    and are not reused."""
    sess = _session(method, stencil="7pt", dtype=dt, norm_ref=None, kernels=True)
    b2 = torch.from_numpy(seeded((10, 7, 13), 3)).to(dt) * 1e3
    x2 = torch.from_numpy(seeded((10, 7, 13), 4)).to(dt)
    for b, x0 in ((None, None), (b2, x2), (None, None), (b2, None)):
        want = sess._solve_eager(b, x0)    # first: the donating solve takes x0
        _assert_same_solve(sess.solve(b, x0), want)
    st = sess.cache_stats()[((10, 7, 13), method, "none")]
    assert st["misses"] == 1 and st["hits"] == 3


@pytest.mark.parametrize("kernels", [False, True])
def test_special_inputs(kernels):
    """A ``b`` that converges at init (``x0`` the exact solution) runs no
    step; a ``b`` holding a NaN ends as a breakdown at once; an all-zero
    ``b`` under ``norm_ref=None`` breaks down in its first step."""
    sess = _session("pcg_merged", "chebyshev", kernels=kernels)
    x_true = sess.problem.x_true()
    at_init = sess.solve(x0=x_true)
    _assert_same_solve(at_init, sess._solve_eager(x0=x_true))
    assert at_init.iters == 0 and at_init.status == 0
    bnan = sess.problem.b().clone()
    bnan[3, 2, 1] = float("nan")
    nan = sess.solve(bnan)
    _assert_same_solve(nan, sess._solve_eager(bnan))
    assert nan.iters == 0 and nan.status == 2
    zero = _session("cg", norm_ref=None, kernels=kernels)
    z = torch.zeros((10, 7, 13), dtype=torch.float64)
    got = zero.solve(z, z)
    _assert_same_solve(got, zero._solve_eager(z, z))
    assert got.status == 2


def _trap_method(value: float) -> MethodDef:
    """A method whose residual scalar is 1, then ``value``, then 0."""
    def init(ops, x0):
        return (x0, torch.ones((), dtype=x0.dtype))

    def step(ops, state):
        x, rr = state
        nxt = torch.where(rr > 0.5, torch.full_like(rr, value), torch.zeros_like(rr))
        return (x + 1.0, nxt)

    return MethodDef(name="f32_trap", vectors=("x",), scalars=("rr",),
                     res_scalar="rr", init=init, step=step)


def test_f32_threshold_rounds_as_the_loop_compares():
    """``run_method`` compares an f32 ``res2`` with the Python float
    ``(tol·norm_ref)²`` in f32, so the threshold is rounded to f32 first.  A
    residual equal to that rounding (below the f64 threshold) continues the
    loop; the executable's static threshold, held in the state's dtype,
    continues it too (an f64 threshold would stop one step early)."""
    thresh2 = (1e-6 * 1.0) ** 2
    value = float(np.float32(thresh2))
    assert value < thresh2                       # between the two roundings
    mdef = _trap_method(value)
    b = torch.zeros((3, 4, 5), dtype=torch.float32)
    A = LocalOp(make_problem((3, 4, 5), "7pt", torch.float32, "cpu").stencil)
    want = run_method(mdef, Ops(A, b, norm_ref=1.0), b, maxiter=10)
    assert want.iters == 2 and want.status == 0
    exe = SolveExecutable(mdef, A, None, fused=False, tol=1e-6, maxiter=10,
                          norm_ref=1.0, shape=b.shape, dtype=b.dtype, device=b.device)
    for max_block in (1, 2):
        exe.ladder = block_ladder(max_block)
        _assert_same_solve(exe.solve(b, b), want)
        assert exe.thresh2.dtype == torch.float32 and float(exe.thresh2) == value
    wrong = torch.tensor(value, dtype=torch.float32) >= torch.tensor(thresh2, dtype=torch.float64)
    assert not bool(wrong)                       # what an f64 threshold says


@pytest.mark.parametrize("name, fused", [(n, False) for n in sorted(METHODS)]
                         + [(n, True) for n in sorted(METHODS)
                            if METHODS[n].has_fused_body])
def test_block_driver_matches_run_method(name, fused):
    """The driver on an executable built straight from the method (no
    session; ``norm_ref=None``), with its own block sizes and with the
    largest rung every block, against ``run_method``."""
    mdef = METHODS[name]
    from repro_torch.kernels.kernel_op import KernelOp
    from repro_torch.precond import make_precond
    prob = make_problem((5, 9, 6), "27pt", torch.float64, "cpu")
    A = KernelOp(LocalOp(prob.stencil)) if fused else LocalOp(prob.stencil)
    M = make_precond("chebyshev").bind(A) if mdef.accepts_precond else None
    b, x0 = prob.b(), prob.x0()
    want = run_method(mdef, Ops(A, b, M=M, norm_ref=None), x0, tol=1e-8,
                      maxiter=200, fused=fused)
    exe = SolveExecutable(mdef, A, M, fused=fused, tol=1e-8, maxiter=200,
                          norm_ref=None, shape=b.shape, dtype=b.dtype,
                          device=b.device, max_block=8)
    _assert_same_solve(exe.solve(b, x0), want)
    exe.pick = _always_the_largest
    _assert_same_solve(exe.solve(b, x0), want)
    _assert_same_solve(run_method_blocks(mdef, exe.ops, x0, tol=1e-8, maxiter=200,
                                         fused=fused, runner=exe), want)


def test_ladder_prediction_and_pick():
    assert block_ladder(1) == (1,) and block_ladder(16) == (1, 2, 4, 8, 16)
    for bad in (0, 3, 12):
        with pytest.raises(ValueError):
            block_ladder(bad)
    # halving every step from 1: 20 steps to reach 1e-6
    assert predict_steps(1.0, 2.0 ** -4, 4, 2.0 ** -20) == pytest.approx(16.0)
    assert predict_steps(1.0, 1.0, 3, 1e-6) == 3            # no fall: n again
    assert predict_steps(1.0, 2.0, 3, 1e-6) == 3
    assert predict_steps(1.0, 0.5, 1, 0.0) == math.inf       # tol = 0
    ladder = block_ladder(16)
    assert pick_block(ladder, math.inf, 600) == 16
    assert pick_block(ladder, math.inf, 11) == 8              # the budget
    assert pick_block(ladder, 20.0, 600) == 8                 # half of 20 = 10
    assert pick_block(ladder, 12.0, 600) == 4
    assert pick_block(ladder, 4.0, 600) == 2                  # the first block
    assert pick_block(ladder, 4.0, 1) == 1
    assert pick_block(ladder, 0.2, 600) == 1                  # the first rung


def test_collector_held_across_overlapping_holders():
    """The captures' hold on the cyclic collector: off inside the block, on
    again when the last of overlapping holders (another thread's included)
    leaves, also when a block raises; a collector that was off stays off."""
    import gc
    import threading

    from repro_torch.api.executable import collector_held

    assert gc.isenabled()
    inside, release = threading.Event(), threading.Event()
    seen = {}

    def other():
        with collector_held():
            inside.set()
            release.wait(10)
            seen["other"] = gc.isenabled()

    t = threading.Thread(target=other)
    with pytest.raises(ValueError):
        with collector_held():
            t.start()
            assert inside.wait(10)
            seen["first"] = gc.isenabled()
            raise ValueError("the block fails")
    seen["between"] = gc.isenabled()            # the other thread still holds it
    release.set()
    t.join(10)
    assert seen == {"first": False, "between": False, "other": False}
    assert gc.isenabled()
    gc.disable()
    try:
        with collector_held():
            assert not gc.isenabled()
        assert not gc.isenabled()
    finally:
        gc.enable()


def test_session_reuses_the_executable():
    """``tests/test_api.py::test_session_reuses_compiled_fn``: one build,
    then hits, the same executable object, the same answer."""
    sess = SolverSession(method="cg", grid=(8, 8, 8), stencil="27pt", device="cpu",
                         options=SolverOptions(tol=1e-8, maxiter=500))
    r1 = sess.solve()
    exe = sess._executables[(8, 8, 8)]
    r2 = sess.solve()
    assert sess._executables[(8, 8, 8)] is exe
    assert torch.equal(r1.x, r2.x)
    st = sess.cache_stats()[((8, 8, 8), "cg", "none")]
    assert st["misses"] == 1 and st["hits"] == 1 and st["compile_s"] > 0
    assert list(sess.cache_stats()) == [((8, 8, 8), "cg", "none")]


@pytest.mark.parametrize("method, precond", [("cg", "none"), ("pcg_merged", "ssor")])
def test_cache_stats_counts_and_timed_solve_hits(method, precond):
    """``tests/test_serve.py::test_session_cache_stats_counts_and_compile_seconds``
    (its single-RHS half), and ``timed_solve``: its warm-up builds the
    executable, every timed call is a hit."""
    sess = SolverSession(method=method, grid=(8, 8, 8), stencil="27pt", device="cpu",
                         options=SolverOptions(tol=1e-8, maxiter=100, precond=precond))
    res, stats = sess.timed_solve(repeats=2)
    key = ((8, 8, 8), method, precond)
    st = sess.cache_stats()[key]
    assert st["misses"] == 1 and st["hits"] == 2 and st["compile_s"] > 0
    assert stats["median"] > 0 and res.status == 0
    sess.solve()
    assert sess.cache_stats()[key]["hits"] == 3
    copy = sess.cache_stats()
    copy[key]["hits"] = 0                        # a copy, not the counters
    assert sess.cache_stats()[key]["hits"] == 3


@pytest.mark.parametrize("method, precond, st, dt", [
    ("cg_merged", "none", "27pt", np.float64), ("pcg_merged", "chebyshev", "27pt", np.float64),
    ("cg_pipe", "none", "7pt", np.float64), ("pbicgstab_merged", "block_jacobi", "27pt",
                                             np.float64),
    ("bicgstab_b1", "none", "7pt", np.float64), ("gauss_seidel_rb", "none", "7pt",
                                                 np.float64),
    ("pcg", "jacobi", "27pt", np.float32)])
def test_cached_iterations_match_the_reference(x64, method, precond, st, dt):
    """The cached solve's iteration count against the reference's
    ``pallas=False`` solve (``kernels=False``) and, for the methods with a
    fused body, its ``pallas=True`` solve (``kernels=True``; the Pallas
    kernels in interpret mode)."""
    api = ref_api()
    jprob = ref_module("core.problems").make_problem((12, 12, 12), st, dtype=dt)
    prob = from_reference(st, (12, 12, 12), np.dtype(dt), b=to_np(jprob.b()),
                          x0=to_np(jprob.x0()), device="cpu")
    f64 = dt == np.float64
    fused_too = METHODS[method].has_fused_body
    for kernels in ((False, True) if fused_too else (False,)):
        want = api.solve(jprob, method=method, options=api.SolverOptions(
            precond=precond, pallas=kernels, f64=f64))
        got = SolverSession(prob, method=method, options=SolverOptions(
            precond=precond, kernels=kernels, f64=f64)).solve()
        assert got.iters == int(want.iters) and got.status == int(want.status)
