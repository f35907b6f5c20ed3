"""The batched multi-RHS solve on the CPU: ``SolverSession.solve_batched``,
``compile_batched``, ``timed_solve_batched``, the module-level
``solve_batched`` and ``launch.solve --batch``, over
``core.methods.run_method_batched`` (the eager loop of batched steps, each
lane masked as it stops) and ``api.executable.BatchedSolveExecutable``
(the same steps in blocks, run eagerly on the CPU).

Every comparison here is bitwise: each lane against the session's own
unfused single solve of it (in f64 and f32), the cached solve against the
eager one (blocks that run past the last lane's stop included), the plain
kernel versions on a batch of lanes against their one-lane results.  The
lanes against the reference's ``solve_batched`` are
``tests/test_torch_batched_ref*.py``; the lane-batched CUDA kernels are
``-k batched`` in ``tests/test_torch_cuda.py``.
"""

import json

import numpy as np
import pytest
import torch

from repro_torch.api import SolverOptions, SolverSession, solve_batched, solver_names
from repro_torch.api.executable import BatchedSolveExecutable
from repro_torch.core.methods import _default_dot
from repro_torch.core.operators import STENCILS, pad1
from repro_torch.kernels import ops, ref
from repro_torch.kernels.kernel_op import KernelOp
from repro_torch.precond import precond_names

GRID = (10, 7, 13)
#: the methods that take a preconditioner
TAKERS = ("pcg", "pcg_merged", "pcg_pipe", "pbicgstab", "pbicgstab_merged")
#: every method without a preconditioner and each preconditioner on every
#: method that takes one
CASES = ([(m, "none") for m in solver_names()]
         + [(m, p) for m in TAKERS for p in precond_names() if p != "none"])


def session(method, precond="none", *, stencil="27pt", dtype=torch.float64,
            grid=GRID, **opts) -> SolverSession:
    opts.setdefault("maxiter", 300)
    return SolverSession(method=method, grid=grid, stencil=stencil, device="cpu",
                         options=SolverOptions(precond=precond,
                                               f64=dtype == torch.float64, **opts))


def lanes(sess: SolverSession, seed: int = 0) -> torch.Tensor:
    """The three lanes: a seeded normal one, ``A·1`` and a zero one."""
    shape, dt = sess.problem.shape, sess.problem.dtype
    normal = np.random.default_rng(seed).standard_normal(shape)
    return torch.stack([torch.as_tensor(normal, dtype=dt), sess.problem.b(),
                        torch.zeros(shape, dtype=dt)])


def bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bit patterns (NaN included) as integers."""
    return t.contiguous().view({8: torch.int64, 4: torch.int32}[t.element_size()])


def assert_same(a: torch.Tensor, b: torch.Tensor) -> None:
    assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(bits(a), bits(b))


def assert_same_batched(got, want) -> None:
    for a, b in zip(got, want):
        if a is None or b is None:
            assert a is None and b is None
        else:
            assert_same(a, b)


def assert_lanes_are_single_solves(sess: SolverSession, bs: torch.Tensor, res) -> None:
    """Each lane bitwise the session's unfused single solve of it."""
    B = bs.shape[0]
    assert res.x.shape == bs.shape and res.history.shape == (B, sess.options.maxiter + 1)
    assert res.iters.shape == res.status.shape == res.res_norm.shape == (B,)
    assert res.iters.dtype == res.status.dtype == torch.int32 and res.telemetry is None
    for i in range(B):
        one = sess._solve_unfused(bs[i])
        assert (int(res.iters[i]), int(res.status[i])) == (one.iters, one.status)
        for a, b in ((res.x[i], one.x), (res.res_norm[i], one.res_norm),
                     (res.history[i], one.history)):
            assert_same(a, b)


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("method, precond", CASES)
def test_f32_lanes_are_single_solves(method, precond, kernels):
    """In f32 (7pt, relative criterion) too, each lane of the eager batched
    solve is bitwise its single solve."""
    sess = session(method, precond, stencil="7pt", dtype=torch.float32, kernels=kernels,
                   norm_ref=None)
    bs = lanes(sess)
    assert_lanes_are_single_solves(sess, bs, sess._solve_batched_eager(bs))


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("method, precond", CASES)
def test_cached_batched_solve_is_the_eager_one(method, precond, kernels):
    """``solve_batched`` (the executable: a miss, then a hit) bitwise
    ``_solve_batched_eager``, under the relative criterion (the zero lane
    runs to a breakdown or to ``maxiter``)."""
    sess = session(method, precond, kernels=kernels, norm_ref=None)
    bs = lanes(sess, seed=1)
    want = sess._solve_batched_eager(bs)
    for _ in range(2):
        assert_same_batched(sess.solve_batched(bs), want)
    st = sess.cache_stats()[((3, *GRID), method, precond)]
    assert (st["misses"], st["hits"]) == (1, 1)


@pytest.mark.parametrize("maxiter", [300, 7, 0])
@pytest.mark.parametrize("method, precond", [("cg_merged", "none"),
                                             ("pbicgstab_merged", "jacobi"),
                                             ("gauss_seidel", "none")])
def test_blocks_past_the_last_stop_change_nothing(method, precond, maxiter):
    """Every block the largest rung the budget allows: the solve runs steps
    past each lane's stop (and past the last), with the eager result."""
    sess = session(method, precond, kernels=True, maxiter=maxiter)
    bs = lanes(sess, seed=2)
    want = sess._solve_batched_eager(bs)
    sess.compile_batched(3)
    exe = sess._executables[(3, *GRID)]
    exe.pick = lambda ladder, predicted, budget: max(k for k in ladder if k <= budget)
    got = sess.solve_batched(bs)
    assert_same_batched(got, want)
    if maxiter:
        assert sum(exe.blocks) >= int(got.iters.max())


def test_inputs_change_between_batched_solves():
    """A second batch with other lanes and ``x0s`` takes its own norms and
    thresholds; a lane holding a NaN breaks down at once beside lanes that
    converge; a batch that converges at init runs no step."""
    sess = session("bicgstab_b1", kernels=True, norm_ref=None)
    gen = torch.Generator().manual_seed(3)
    b2 = torch.randn((3, *GRID), generator=gen, dtype=torch.float64)
    x2 = torch.randn((3, *GRID), generator=gen, dtype=torch.float64)
    bnan = lanes(sess)
    bnan[1, 3, 2, 1] = float("nan")
    for bs, x0s in ((lanes(sess), None), (b2 * 1e3, x2), (bnan, None)):
        want = sess._solve_batched_eager(bs, x0s)    # first: the donating solve takes x0s
        assert_same_batched(sess.solve_batched(bs, x0s), want)
    res = sess.solve_batched(bnan)
    assert (int(res.status[1]), int(res.iters[1])) == (2, 0)
    assert sess.cache_stats()[((3, *GRID), "bicgstab_b1", "none")]["misses"] == 1
    sess = session("cg", kernels=True)
    xs = sess.problem.x_true().expand(3, *GRID)
    bs = sess.problem.b().expand(3, *GRID)
    at_init = sess.solve_batched(bs, xs)
    assert at_init.iters.tolist() == [0, 0, 0] and at_init.status.tolist() == [0, 0, 0]
    assert sess._executables[(3, *GRID)].blocks == []


def test_compile_batched_then_solve_is_one_miss_then_a_hit():
    """``compile_batched(B)`` builds the ``(B, *grid)`` executable, its state
    set included, before any solve (the single-RHS key is untouched); the
    next ``solve_batched`` and ``timed_solve_batched`` at that B are hits,
    another B is another key."""
    sess = session("pcg", "chebyshev", kernels=True)
    secs = sess.compile_batched(3)
    assert secs > 0
    exe = sess._executables[(3, *GRID)]
    assert isinstance(exe, BatchedSolveExecutable) and exe.state is not None
    assert sess.cache_stats() == {((3, *GRID), "pcg", "chebyshev"): dict(
        hits=0, misses=1, compile_s=exe.compile_s)}
    bs = lanes(sess)
    res = sess.solve_batched(bs)
    assert_same_batched(res, sess._solve_batched_eager(bs))
    again, stats = sess.timed_solve_batched(bs, repeats=2)
    assert_same_batched(again, res) and stats["median"] > 0
    assert sess.cache_stats()[((3, *GRID), "pcg", "chebyshev")]["hits"] == 4
    sess.solve_batched(bs[:2])
    sess.solve()
    assert set(sess.cache_stats()) == {((3, *GRID), "pcg", "chebyshev"),
                                       ((2, *GRID), "pcg", "chebyshev"),
                                       (GRID, "pcg", "chebyshev")}
    assert sess._executables[(3, *GRID)] is exe


def test_batched_inputs_are_validated():
    """The reference's checks and messages: not 4-D ("batch"), another grid
    ("grid"); ``x0s`` of another shape."""
    sess = session("cg")
    with pytest.raises(ValueError, match="batch"):
        sess.solve_batched(torch.zeros(GRID, dtype=torch.float64))
    with pytest.raises(ValueError, match="grid"):
        sess.solve_batched(torch.zeros((2, 10, 7, 12), dtype=torch.float64))
    with pytest.raises(ValueError, match="batch"):
        sess.timed_solve_batched(torch.zeros((2, 1, *GRID), dtype=torch.float64))
    with pytest.raises(ValueError):
        sess.solve_batched(torch.zeros((2, *GRID), dtype=torch.float64),
                           torch.zeros((3, *GRID), dtype=torch.float64))
    with pytest.raises(ValueError, match="batch"):
        solve_batched(torch.zeros(GRID), method="cg", device="cpu")


def test_module_level_solve_batched():
    """The grid comes from ``bs``; overrides are ``SolverOptions`` fields;
    the lanes are the session's."""
    sess = session("cg_nb", stencil="7pt", kernels=True)
    bs = lanes(sess)
    got = solve_batched(bs, method="cg_nb", stencil="7pt", device="cpu", kernels=True,
                        maxiter=300)
    assert_same_batched(got, sess.solve_batched(bs))
    x0s = torch.ones_like(bs)
    want = sess._solve_batched_eager(bs, x0s)    # first: the donating solve takes x0s
    got = solve_batched(bs, sess.problem, method="cg_nb", device="cpu",
                        options=SolverOptions(kernels=True, maxiter=300), x0s=x0s)
    assert_same_batched(got, want)
    assert got.x is x0s


@pytest.mark.parametrize("dt", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("st", ["7pt", "27pt"])
def test_plain_kernel_versions_on_lanes_are_per_lane(st, dt):
    """The plain versions the CPU runs (``ops.spmv`` in both operand forms,
    ``ops.cheb_step``, ``ops.jacobi_sweep``, and the operator's stencil
    helpers) on a batch of lanes: each lane bitwise the one-lane result;
    no launch is counted on the CPU."""
    stencil = STENCILS[st]
    gen = torch.Generator().manual_seed(4)
    x, r, d = (torch.randn((3, *GRID), generator=gen, dtype=dt) for _ in range(3))
    xh = torch.randn((3, *(n + 2 for n in GRID)), generator=gen, dtype=dt)

    def calls(x, xh, r, d):
        return [ops.spmv(x, stencil, zero_halo=True), ops.spmv(xh, stencil),
                *ops.cheb_step(xh, r, d, stencil, a=0.37, c=1.21),
                ops.jacobi_sweep(pad1(x), r, stencil, omega=0.9),
                stencil.matvec(x), stencil.offdiag_apply_padded(xh),
                stencil.plane_offdiag_apply(xh, 4),
                ref.rb_gs_half_sweep_ref(xh, r, stencil=stencil, colour=1)]

    ops.reset_launches()
    got = calls(x, xh, r, d)
    assert not any(ops.LAUNCHES.values())
    for i in range(3):
        for g, o in zip(got, calls(x[i], xh[i], r[i], d[i])):
            assert_same(g[i], o)


def test_lane_dot_is_each_lanes_torch_dot():
    """A batch's dot is one ``torch.dot`` per lane, shaped ``(B, 1, 1, 1)``;
    one grid's is ``torch.dot`` itself."""
    gen = torch.Generator().manual_seed(5)
    a, b = (torch.randn((3, *GRID), generator=gen, dtype=torch.float64) for _ in range(2))
    got = _default_dot(a, b)
    assert got.shape == (3, 1, 1, 1)
    for i in range(3):
        assert_same(got[i, 0, 0, 0], torch.dot(a[i].reshape(-1), b[i].reshape(-1)))
        assert_same(_default_dot(a[i], b[i]), got[i, 0, 0, 0])


def test_kernel_op_takes_lanes_on_its_surface_only():
    """``KernelOp.matvec`` takes a batch to the SpMV's lane-batched form (on
    the CPU its plain version); every fused hook refuses a batch."""
    sess = session("cg_merged", kernels=True)
    A = sess._operator()
    assert isinstance(A, KernelOp)
    bs = lanes(sess)
    assert_same(A.matvec(bs), sess.problem.stencil.matvec(bs))
    s = torch.zeros(())
    for hook, args in (("spmv_dots", (bs,)), ("spmv_dots3", (bs, bs)),
                       ("cg_body", (s, s, bs, bs, bs, bs, bs)),
                       ("fused_dots", (bs, bs, bs)),
                       ("pcg_body", (s, s, bs, bs, bs, bs, bs, bs)),
                       ("pipe_body", (s, s, *[bs] * 7)),
                       ("ppipe_body", (s, s, *[bs] * 10)),
                       ("bicgstab_spmv_dots", (bs, bs, bs, bs, bs, bs, bs, s)),
                       ("bicgstab_update1", (s, s, *[bs] * 6)),
                       ("bicgstab_spmv_update", (bs, bs, bs, bs, bs, bs, bs, s, s))):
        with pytest.raises(ValueError, match="fused hooks"):
            getattr(A, hook)(*args)


def test_solve_cli_batch_reports_its_keys(capsys):
    """``launch.solve --batch 3 --device cpu --json`` solves three seeded
    lanes and reports their wall time, iterations and residual norms."""
    from repro_torch.launch.solve import main
    out = main(["--device", "cpu", "--grid", "6", "5", "7", "--method", "cg",
                "--batch", "3", "--kernels", "--json"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert out["batch_wall_s"] > 0 and len(out["batch_iters"]) == 3
    assert len(out["batch_res_norm"]) == 3 and all(k > 0 for k in out["batch_iters"])
    sess = SolverSession(method="cg", grid=(6, 5, 7), device="cpu",
                         options=SolverOptions(kernels=True))
    bs = torch.as_tensor(np.random.default_rng(0).standard_normal((3, 6, 5, 7)))
    want = sess._solve_batched_eager(bs)
    assert out["batch_iters"] == want.iters.tolist()
    assert out["batch_res_norm"] == want.res_norm.tolist()
