"""The resilient driver on the cached and batched routes, on the CPU: the
executable's blocks (``core.methods.run_method_blocks`` on
``api.executable.SolveExecutable``'s static buffers, the steps the card
replays as CUDA graphs) and the batched loops against the eager loop,
bitwise: iterations, status, iterate, residual norm, history and
telemetry.  Guards fire mid-block (stagnation, divergence, a method's guard
hook, a NaN) and the block rolls back as a convergence stop does; blocks
are forced to run past every stop; residual replacement puts its boundary
inside what would have been one block; the lanes of a batched solve with
guards, telemetry and refresh armed are each their single solve.  The
reference holds the statuses of the firing cases.  10×7×13 (8³ against the
reference), f64.
"""

import numpy as np
import pytest
import torch

from test_torch_harness import x64  # noqa: F401  (fixture)
from test_torch_harness import ref_api, ref_module, seeded, to_np

from repro_torch.api import SolverOptions, SolverSession
from repro_torch.api.executable import BatchedSolveExecutable, SolveExecutable
from repro_torch.core.methods import (STATUS_BREAKDOWN, STATUS_CONVERGED,
                                      STATUS_DIVERGED, STATUS_STAGNATED, GuardSpec,
                                      MethodDef, Ops, block_ladder, run_method,
                                      run_method_batched)
from repro_torch.core.problems import from_reference, make_problem
from repro_torch.core.solvers import LocalOp
from repro_torch.resilience import ChaosInjector, ChaosPlan

GRID = (10, 7, 13)


@pytest.fixture(scope="module")
def problem():
    return make_problem(GRID, "27pt", torch.float64, "cpu")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view({8: torch.int64, 4: torch.int32}[t.element_size()])


def _same(a, b) -> bool:
    return (a is None and b is None) or (a is not None and b is not None
                                         and torch.equal(_bits(a), _bits(b)))


def _assert_same_solve(got, want):
    """Iterations and status equal; iterate, residual norm, history and
    telemetry bitwise equal."""
    assert (got.iters, got.status) == (want.iters, want.status)
    for a, b in ((got.x, want.x), (got.res_norm, want.res_norm),
                 (got.history, want.history), (got.telemetry, want.telemetry)):
        assert _same(a, b)


def _always_the_largest(ladder, predicted, budget):
    return max(k for k in ladder if k <= budget)


def _block_starts(blocks: list[int], iters: int) -> list[int]:
    """The iteration each block of a solve started from: a block that ran
    past the stop (the one whose later blocks redo fewer steps than it
    took) and its redo start at the same iteration."""
    starts, k, rolled = [], 0, sum(blocks) - iters
    for i, n in enumerate(blocks):
        starts.append(k)
        if not (rolled and n == rolled and sum(blocks[i + 1:]) < n):
            k += n
    return starts


def _assert_refreshes_at_block_ends(blocks, iters, every):
    """Only a block's last step may be a multiple of ``every``."""
    for start, n in zip(_block_starts(blocks, iters), blocks):
        assert all((start + i) % every for i in range(1, n)), (blocks, start, n)


def _shifted(stencil, shift):
    """``A - shift·I``: indefinite for a shift past A's smallest eigenvalue."""
    return lambda xp: stencil.matvec_padded(xp) - shift * xp[1:-1, 1:-1, 1:-1]


#: (method, precond, options, status the guarded solve ends in)
FIRING = [
    ("cg_merged", "none", dict(stagnation_window=3, stagnation_rtol=0.2), STATUS_STAGNATED),
    ("cg_merged", "none", dict(stagnation_window=5, stagnation_rtol=0.1), STATUS_STAGNATED),
    ("cg_pipe", "none", dict(stagnation_window=5, stagnation_rtol=0.1), STATUS_STAGNATED),
    ("jacobi", "none", dict(stagnation_window=5, stagnation_rtol=0.1), STATUS_STAGNATED),
    ("cg_pipe", "none", dict(matvec_padded=30.0, divergence_factor=10.0), STATUS_DIVERGED),
    ("jacobi", "none", dict(matvec_padded=30.0, divergence_factor=1e3), STATUS_DIVERGED),
    ("bicgstab", "none", dict(matvec_padded=30.0, divergence_factor=10.0), STATUS_BREAKDOWN),
    ("pcg_merged", "chebyshev", dict(residual_replacement=5, telemetry=True,
                                     telemetry_buffer=9), STATUS_CONVERGED),
    ("cg_merged", "none", dict(residual_replacement=5, telemetry=True,
                               stagnation_window=30), STATUS_CONVERGED),
    ("pcg_pipe", "chebyshev", dict(residual_replacement=3, telemetry=True), STATUS_CONVERGED),
    ("bicgstab_merged", "none", dict(residual_replacement=4, telemetry=True,
                                     telemetry_buffer=3), STATUS_CONVERGED),
    ("pbicgstab_merged", "jacobi", dict(residual_replacement=7), STATUS_CONVERGED),
]


def _options(problem, precond, kw, **extra) -> SolverOptions:
    kw = dict(kw)
    if "matvec_padded" in kw:
        kw["matvec_padded"] = _shifted(problem.stencil, kw["matvec_padded"])
    return SolverOptions(tol=1e-10, maxiter=300, precond=precond, guards=True,
                         on_breakdown="none", **kw, **extra)


@pytest.mark.parametrize("max_block", [1, 4, 16])
@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("method, precond, kw, status", FIRING)
def test_guarded_blocks_match_eager(problem, method, precond, kw, status, kernels,
                                    max_block):
    """The cached solve (its own block sizes, then the largest rung every
    block, so each stop falls inside a block that is rolled back) against
    the eager loop: bitwise, with the status the guard gives."""
    sess = SolverSession(problem, method=method,
                         options=_options(problem, precond, kw, kernels=kernels))
    sess._max_block = max_block
    want = sess._solve_eager()
    assert want.status == status
    _assert_same_solve(sess.solve(), want)
    exe = sess._executables[GRID]
    assert exe.ladder == block_ladder(max_block)
    exe.pick = _always_the_largest
    _assert_same_solve(sess.solve(), want)
    every = sess.options.residual_replacement
    if every:
        _assert_refreshes_at_block_ends(exe.blocks, want.iters, every)
    elif max_block > 1 and want.iters % max_block:
        assert sum(exe.blocks) > want.iters     # ran past the stop and redid
    if every and max_block > every:
        assert max(exe.blocks) <= every < max_block


def test_refresh_boundaries_split_the_blocks(problem):
    """With ``refresh_every`` = 5 and blocks of up to 16 forced, the blocks
    end on the multiples of 5 (the refreshing graph's last step), and the
    solve is the eager one."""
    sess = SolverSession(problem, method="cg_merged", options=SolverOptions(
        tol=1e-10, maxiter=300, kernels=True, residual_replacement=5))
    want = sess._solve_eager()
    sess.solve()
    exe = sess._executables[GRID]
    exe.pick = _always_the_largest
    _assert_same_solve(sess.solve(), want)
    assert exe.blocks[:4] == [4, 1, 4, 1] and sum(exe.blocks) == want.iters


def _trap_method(fire_at: int, what: str) -> MethodDef:
    """A method whose residual falls tenfold a step and whose step ``fire_at``
    makes its guard hook fire (``what="guard"``) or a NaN in a scalar slot
    that is not the residual (``what="nan"``)."""
    def init(ops, x0):
        z = torch.zeros((), dtype=x0.dtype)
        return (x0, torch.ones((), dtype=x0.dtype), z)

    def step(ops, state):
        x, rr, c = state
        c = c + 1.0
        aux = torch.where(c == fire_at, float("nan"), c) if what == "nan" else c
        return (x + 1.0, rr * 0.1, aux if what == "nan" else c)

    def guard(ops, state, rr0, eps):
        return state[2] == fire_at

    return MethodDef(name=f"trap_{what}", vectors=("x",), scalars=("rr", "c"),
                     res_scalar="rr", init=init, step=step,
                     guard=guard if what == "guard" else None)


@pytest.mark.parametrize("fire_at", [1, 5, 11])
@pytest.mark.parametrize("what", ["guard", "nan"])
@pytest.mark.parametrize("max_block", [1, 8, 16])
def test_a_guard_that_fires_mid_block_rolls_back(problem, what, fire_at, max_block):
    """A guard hook or a NaN scalar that appears after step ``fire_at`` ends
    the solve there, in breakdown, however the blocks fall."""
    mdef = _trap_method(fire_at, what)
    b = torch.zeros(GRID, dtype=torch.float64)
    A = LocalOp(problem.stencil)
    spec = GuardSpec()
    want = run_method(mdef, Ops(A, b, norm_ref=1.0), b, tol=1e-30, maxiter=40,
                      guard_spec=spec, telemetry=40)
    assert (want.iters, want.status) == (fire_at, STATUS_BREAKDOWN)
    assert float(want.x.reshape(-1)[0]) == fire_at
    exe = SolveExecutable(mdef, A, None, fused=False, tol=1e-30, maxiter=40,
                          norm_ref=1.0, shape=GRID, dtype=b.dtype, device=b.device,
                          max_block=max_block, guard_spec=spec, telemetry=40)
    _assert_same_solve(exe.solve(b, b), want)
    exe.pick = _always_the_largest
    _assert_same_solve(exe.solve(b, b), want)
    if max_block > fire_at:
        assert exe.blocks[0] == max_block and sum(exe.blocks) > fire_at


@pytest.mark.parametrize("method, precond, kw, status", [
    ("cg_merged", "none", dict(stagnation_window=3, stagnation_rtol=0.2), STATUS_STAGNATED),
    ("cg_pipe", "none", dict(matvec_padded=20.0, divergence_factor=10.0), STATUS_DIVERGED),
    ("jacobi", "none", dict(matvec_padded=30.0, divergence_factor=1e3), STATUS_DIVERGED),
    ("cg_merged", "none", dict(matvec_padded=20.0), STATUS_BREAKDOWN),
])
def test_firing_statuses_match_the_reference(x64, method, precond, kw, status):
    """The same guards fire at the reference's iteration with its status
    (8³, the reference's problem).  BiCGStab on the shifted operator is left
    to the port's own bitwise cases: without any guard its residual history
    and the reference's part by 1e-3 relative within 10 iterations (two
    summation orders on an indefinite system), so where a guard fires there
    says nothing about the guards."""
    grid = (8, 8, 8)
    jprob = ref_module("core.problems").make_problem(grid, "27pt")
    prob = from_reference("27pt", grid, np.dtype(np.float64), b=to_np(jprob.b()),
                          x0=to_np(jprob.x0()), device="cpu")
    got = SolverSession(prob, method=method, options=_options(prob, precond, kw)).solve()
    api = ref_api()
    jkw = dict(kw)
    if "matvec_padded" in jkw:
        jkw["matvec_padded"] = _shifted(jprob.stencil, jkw["matvec_padded"])
    want = api.solve(jprob, method=method, options=api.SolverOptions(
        tol=1e-10, maxiter=300, precond=precond, guards=True, on_breakdown="none", **jkw))
    assert (got.iters, got.status) == (int(want.iters), int(want.status))
    assert got.status == status


# -----------------------------------------------------------------------------
# the batched drivers: guards, counters and telemetry lane by lane
# -----------------------------------------------------------------------------

def _lanes(problem) -> torch.Tensor:
    """A·1, a seeded normal lane, the same lane poisoned by the chaos
    injector, a zero lane."""
    normal = torch.from_numpy(seeded(GRID, 4))
    poisoned, hit = ChaosInjector(ChaosPlan(seed=1, nan_rate=1.0)).poison_b(normal)
    assert hit and bool(torch.isnan(poisoned).any()) and not bool(torch.isnan(normal).any())
    return torch.stack([problem.b(), normal, poisoned, torch.zeros(GRID, dtype=torch.float64)])


#: (method, precond, options) of the batched cases
BATCHED = [("cg", "none", dict(guards=True, telemetry=True, telemetry_buffer=12)),
           ("cg_merged", "none", dict(guards=True, stagnation_window=5,
                                      stagnation_rtol=0.1, telemetry=True)),
           ("cg_merged", "none", dict(guards=True, residual_replacement=5, telemetry=True,
                                      telemetry_buffer=7)),
           ("pcg_pipe", "chebyshev", dict(residual_replacement=3, telemetry=True)),
           ("pbicgstab_merged", "block_jacobi", dict(guards=True, residual_replacement=4)),
           ("bicgstab", "none", dict(guards=True, divergence_factor=2.0, telemetry=True)),
           ("gauss_seidel", "none", dict(guards=True, stagnation_window=4,
                                         stagnation_rtol=0.5))]


@pytest.mark.parametrize("max_block", [1, 16])
@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("method, precond, kw", BATCHED)
def test_batched_lanes_match_single_solves(problem, method, precond, kw, kernels,
                                           max_block):
    """Each lane of the eager batched solve is bitwise the single solve of it
    (the poisoned lane ends in breakdown and spoils no other lane), and the
    cached batched solve is bitwise the eager one."""
    sess = SolverSession(problem, method=method, options=SolverOptions(
        tol=1e-10, maxiter=300, precond=precond, kernels=kernels,
        on_breakdown="none", **kw))
    sess._max_block = max_block
    bs = _lanes(problem)
    want = sess._solve_batched_eager(bs)
    for i in range(len(bs)):
        one = sess._solve_unfused(bs[i])
        assert (int(want.iters[i]), int(want.status[i])) == (one.iters, one.status)
        for a, b in ((want.x[i], one.x), (want.res_norm[i], one.res_norm),
                     (want.history[i], one.history)):
            assert _same(a, b)
        assert _same(None if want.telemetry is None else want.telemetry[i], one.telemetry)
    if sess.options.guards_armed():
        assert int(want.status[2]) == STATUS_BREAKDOWN and int(want.iters[2]) == 0
    for _ in range(2):
        got = sess.solve_batched(bs)
        for a, b in zip(got, want):
            assert _same(a, b)
    exe = sess._executables[(4, *GRID)]
    assert isinstance(exe, BatchedSolveExecutable)
    every = sess.options.residual_replacement
    if every:                       # a batched block never rolls back
        _assert_refreshes_at_block_ends(exe.blocks, sum(exe.blocks), every)


def test_batched_driver_with_a_guard_hook_per_lane(problem):
    """The trap method's guard fires in each lane at its own step: every
    lane ends there in breakdown, as its single solve does."""
    mdef = _trap_method(3, "guard")
    A = LocalOp(problem.stencil)
    bs = torch.zeros((2, *GRID), dtype=torch.float64)
    res = run_method_batched(mdef, Ops(A, bs, norm_ref=1.0), bs, tol=1e-30, maxiter=20,
                             guard_spec=GuardSpec(), telemetry=5)
    one = run_method(mdef, Ops(A, bs[0], norm_ref=1.0), bs[0], tol=1e-30, maxiter=20,
                     guard_spec=GuardSpec(), telemetry=5)
    assert res.iters.tolist() == [3, 3] and res.status.tolist() == [STATUS_BREAKDOWN] * 2
    assert _same(res.telemetry[0], one.telemetry) and _same(res.history[1], one.history)
    exe = BatchedSolveExecutable(mdef, A, None, tol=1e-30, maxiter=20, norm_ref=1.0,
                                 shape=bs.shape, dtype=bs.dtype, device=bs.device,
                                 max_block=4, guard_spec=GuardSpec(), telemetry=5)
    for a, b in zip(exe.solve(bs, bs), res):
        assert _same(a, b)


@pytest.mark.parametrize("override", ["dot", "matvec_padded"])
def test_batched_overrides_apply_lane_by_lane(problem, override):
    """A custom ``dot`` or ``matvec_padded`` (written for one grid) applies
    to each lane of a batched solve, as the reference's vmap applies it:
    every lane is its single solve, cached and eager alike."""
    value = {"dot": lambda a, b: torch.dot(a.reshape(-1), b.reshape(-1)),
             "matvec_padded": _shifted(problem.stencil, 0.5)}[override]
    sess = SolverSession(problem, method="cg_merged", options=SolverOptions(
        tol=1e-10, maxiter=300, kernels=True, norm_ref=None, **{override: value}))
    bs = _lanes(problem)[:2]
    want = sess._solve_batched_eager(bs)
    for i in range(2):
        one = sess._solve_unfused(bs[i])
        assert (int(want.iters[i]), int(want.status[i])) == (one.iters, one.status)
        assert _same(want.x[i], one.x) and _same(want.history[i], one.history)
    for a, b in zip(sess.solve_batched(bs), want):
        assert _same(a, b)
