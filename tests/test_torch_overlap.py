"""The paper's barrier structure on the port's mesh: nonblocking reductions,
the op log (``analysis.oplog``) and the overlap report (``core.overlap``).

One spawn of 8 gloo ranks (``overlap8``) measures:

* the barrier assertions of the reference's
  ``tests/test_distributed_solvers.py`` on the port's own steps, on the
  (2, 4) data×model mesh at 16³ 27pt under the scatter halo mode: hard
  barriers (a window below an eighth of one local vector ``V``) cg 1, cg_nb
  0 with a SpMV-sized window (> 10 V), bicgstab >= 1, bicgstab_b1 1;
* the same steps through :class:`ForkJoinComm`, a test double whose
  ``all_gather_start`` waits at once (the fork-join yardstick): every
  reduction hard;
* the halo assertions of the reference's ``tests/test_halo_overlap.py`` on
  the ("cells",) mesh of 8 at 16×16×32: under ``overlap`` every swap
  carries more than a vector of interior work, under ``concat`` less;
* every method's mesh solve on both routes, bitwise the same solve through
  the fork-join double (only the issue order of independent work differs);
* the mesh solve's donation of this rank's ``x0`` block.

The structural cases of the reference's ``tests/test_hlo_analysis.py`` run
on synthetic logs.
"""

from __future__ import annotations

import warnings

import pytest
import torch
from test_torch_distributed_ranks import MESH8_GRID, spawn

from repro_torch.analysis.oplog import (OpLog, collective_bytes, collective_stats,
                                        count_collectives, op_bytes, overlap_slack)
from repro_torch.api import REGISTRY, SolverOptions, SolverSession
from repro_torch.core.overlap import (blocking_halos, blocking_reductions, halo_slack,
                                      iteration_overlap_report, spmv_bytes)
from repro_torch.launch.mesh import Mesh

BARRIER_METHODS = ("cg", "cg_nb", "bicgstab", "bicgstab_b1")
HALO_GRID = (16, 16, 32)
BITWISE_GRID = (8, 8, 16)
ROUTES = [(m, k) for m in sorted(REGISTRY)
          for k in ((False, True) if REGISTRY[m].has_fused_body else (False,))]


class ForkJoinComm:
    """Test double: a comm whose ``all_gather_start`` waits at once, so
    every reduction is a barrier (the fork-join form); all else is the
    wrapped comm's."""

    def __init__(self, inner):
        self.inner = inner

    def all_gather_start(self, t):
        handle = self.inner.all_gather_start(t)
        handle.wait()
        return handle

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _step_args(prob, layout, method):
    from repro_torch.core.distributed import step_state_layout
    vecs, scals = step_state_layout(method)
    b = layout.block(prob.b(), prob.shape)
    one = torch.ones((), dtype=prob.dtype)
    return (b, *[b] * len(vecs), *[one] * len(scals))


def _bits(res) -> tuple:
    return res.x, int(res.iters), res.res_norm


def overlap8(rank: int, world: int) -> dict:
    """The 8 ranks' measurements (see the module docstring)."""
    from repro_torch.core.distributed import DistributedOp, solve_step_shardmap
    from repro_torch.core.problems import make_problem
    from repro_torch.kernels.autotune import DEFAULT_RUN
    from repro_torch.kernels.kernel_op import KernelOp

    out = {}
    mesh = Mesh((2, 4), ("data", "model"))
    prob = make_problem(MESH8_GRID, "27pt", device="cpu")
    for m in sorted(REGISTRY):
        fn, layout = solve_step_shardmap(prob, m, mesh, halo_mode="scatter")
        args = _step_args(prob, layout, m)
        out[("nb", m)] = iteration_overlap_report(fn, *args, mesh=mesh)
        out[("fj", m)] = iteration_overlap_report(fn, *args, mesh=mesh, wrap=ForkJoinComm)
    out["V"] = args[0].numel() * args[0].element_size()

    fn, layout = solve_step_shardmap(prob, "pcg_pipe", mesh, kernels_fused=True,
                                     run=DEFAULT_RUN)
    args = _step_args(prob, layout, "pcg_pipe")
    out["pcg_pipe_fused"] = iteration_overlap_report(fn, *args, mesh=mesh)
    out["fused_spmv"] = spmv_bytes(KernelOp(DistributedOp(prob.stencil, layout)), args[0],
                                   mesh=mesh)

    cells = Mesh((8,), ("cells",))
    hprob = make_problem(HALO_GRID, "27pt", device="cpu")
    for hm in ("concat", "overlap"):
        fn, layout = solve_step_shardmap(hprob, "cg", cells, halo_mode=hm)
        rep = iteration_overlap_report(fn, *_step_args(hprob, layout, "cg"), mesh=cells)
        out[("halo", hm)] = halo_slack(rep)
    out["halo_vec"] = HALO_GRID[0] * HALO_GRID[1] * (HALO_GRID[2] // 8) * 8

    bprob = make_problem(BITWISE_GRID, "27pt", device="cpu")
    for m, kern in ROUTES:
        sess = SolverSession(bprob, method=m, mesh=mesh,
                             options=SolverOptions(tol=1e-10, maxiter=30, kernels=kern))
        nb = sess.solve()
        inner = mesh.comm
        mesh.comm = ForkJoinComm(inner)
        try:
            fj = sess.solve()
        finally:
            mesh.comm = inner
        out[("bitwise", m, kern)] = (_bits(nb), _bits(fj))

    opts = dict(tol=1e-10, maxiter=10)
    sess = SolverSession(bprob, method="cg", mesh=mesh,
                         options=SolverOptions(donate=True, **opts))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        glob = torch.zeros(BITWISE_GRID, dtype=bprob.dtype)
        res = sess.solve(x0=glob)
    out["donate_global"] = (len(caught), res.x is glob, bool(glob.abs().sum() == 0))
    blk = torch.zeros(sess.layout.local_shape(BITWISE_GRID), dtype=bprob.dtype)
    res = sess.solve(x0=blk)
    plain = SolverSession(bprob, method="cg", mesh=mesh,
                          options=SolverOptions(**opts)).solve()
    out["donate_block"] = (res.x is blk, torch.equal(blk, plain.x))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn(8, "overlap8", tmp_path_factory.mktemp("overlap8"))


def _gathers(rep):
    return [r for r in rep if r["op"] == "all_gather"]


# -- the paper's barrier structure ------------------------------------------------------

def test_collective_counts_per_iteration(ranks):
    """One collective per (stacked) reduction: CG 2, CG-NB 2, BiCGStab 3, B1 3."""
    want = {"cg": 2, "cg_nb": 2, "bicgstab": 3, "bicgstab_b1": 3}
    for rec in ranks:
        assert {m: len(_gathers(rec[("nb", m)])) for m in want} == want


def test_barrier_elimination_matches_paper(ranks):
    """Hard barriers: classical CG keeps one, CG-NB none (its r·r reduction
    has a SpMV-sized window), BiCGStab at least one, B1 exactly one."""
    for rec in ranks:
        V = rec["V"]
        hard = {m: blocking_reductions(rec[("nb", m)], V) for m in BARRIER_METHODS}
        assert hard["cg"] == 1
        assert hard["cg_nb"] == 0
        assert max(r["slack_bytes"] for r in _gathers(rec[("nb", "cg_nb")])) > 10 * V
        assert hard["bicgstab"] >= 1
        assert hard["bicgstab_b1"] == 1


def test_fork_join_double_shows_every_reduction_hard(ranks):
    """Through the double, every reduction of every step is a barrier (what
    the blocking comm gave: cg 2, cg_nb 2, bicgstab_b1 3), and the steps
    issue the same collectives."""
    for rec in ranks:
        for m in REGISTRY:
            fj, nb = rec[("fj", m)], rec[("nb", m)]
            assert blocking_reductions(fj, rec["V"]) == len(_gathers(fj)), m
            assert [r["op"] for r in fj] == [r["op"] for r in nb], m
        assert blocking_reductions(rec[("fj", "cg_nb")], rec["V"]) == 2
        assert blocking_reductions(rec[("fj", "bicgstab_b1")], rec["V"]) == 3


def test_fused_pipelined_pcg_hides_its_reduction(ranks):
    """On the fused route pipelined PCG's reduction triple is in flight
    under the preconditioner apply and the SpMV."""
    for rec in ranks:
        (g,) = _gathers(rec["pcg_pipe_fused"])
        assert g["waited"] and g["slack_bytes"] >= rec["fused_spmv"] > 0


def test_overlap_exposes_hideable_halo_work(ranks):
    """More than a vector's worth of hideable work per swap under overlap,
    less than a vector under concat (the port's one ``exchange`` is the
    reference's two ``collective-permute``\\s)."""
    for rec in ranks:
        vec = rec["halo_vec"]
        con, ovl = rec[("halo", "concat")], rec[("halo", "overlap")]
        assert len(con) == len(ovl) == 1
        assert all(r["slack_bytes"] > vec for r in ovl)
        assert all(r["slack_bytes"] < vec for r in con)
        assert blocking_halos(ovl, vec) == 0
        assert blocking_halos(con, vec) == len(con)
        assert min(r["slack_bytes"] for r in ovl) > 4 * max(r["slack_bytes"] for r in con)


@pytest.mark.parametrize("route", ROUTES, ids=lambda r: f"{r[0]}-{'kernels' if r[1] else 'plain'}")
def test_mesh_solve_bitwise_the_fork_join_solve(ranks, route):
    for rec in ranks:
        (x, iters, res), (x_fj, iters_fj, res_fj) = rec[("bitwise", *route)]
        assert iters == iters_fj
        assert torch.equal(x, x_fj) and torch.equal(res, res_fj)


def test_mesh_solve_donates_this_ranks_block(ranks):
    """A donated x0 block takes the iterate (bitwise the undonated solve);
    the global array is not this rank's block: a warning, and untouched."""
    for rec in ranks:
        assert rec["donate_block"] == (True, True)
        assert rec["donate_global"] == (1, False, True)


# -- the op log on synthetic steps ------------------------------------------------------

def _ev(kind, **kw):
    return {"event": kind, **kw}


def test_overlap_slack_structure():
    """Nested windows, a never-waited collective, and the payload bytes."""
    log = [_ev("op", op="a", bytes=7),
           _ev("start", op="all_gather", id=0, bytes=16, plane=0),
           _ev("op", op="b", bytes=100),
           _ev("start", op="exchange", id=1, bytes=64, plane=32),
           _ev("op", op="c", bytes=50),
           _ev("wait", op="exchange", id=1),
           _ev("op", op="d", bytes=25),
           _ev("wait", op="all_gather", id=0),
           _ev("start", op="all_gather", id=2, bytes=8, plane=0),
           _ev("op", op="e", bytes=10)]
    rep = overlap_slack(log)
    assert [(r["op"], r["slack_bytes"], r["waited"]) for r in rep] == [
        ("all_gather", 175, True), ("exchange", 50, True), ("all_gather", 10, False)]
    assert rep[0]["slack_fraction"] == 175 / 192
    assert count_collectives(log) == {"all_gather": 2, "exchange": 1}
    assert collective_stats(log) == {"all_gather": {"count": 2, "bytes": 24},
                                     "exchange": {"count": 1, "bytes": 64}}
    assert collective_bytes(log) == 88
    assert [r["op"] for r in overlap_slack(log, ops=("exchange",))] == ["exchange"]
    assert halo_slack(rep) == [rep[1]]
    assert blocking_halos(rep) == 0 and blocking_halos(rep, 51) == 1
    assert blocking_reductions(rep, 8 * 11) == 1


def test_no_collectives_in_a_local_step():
    a = torch.ones(64, dtype=torch.float64)
    with OpLog() as log:
        b = a + a
        torch.dot(b, a)
    assert count_collectives(log.events) == {} and collective_bytes(log.events) == 0
    assert overlap_slack(log.events) == []
    assert [e["bytes"] for e in log.events] == [3 * 512, 2 * 512 + 8]


def test_op_bytes_of_views_allocations_and_copies():
    x = torch.ones(4, 8, dtype=torch.float64)
    with OpLog() as log:
        v = x.view(32)
        torch.empty_like(x)
        y = torch.zeros(4, 8, dtype=torch.float64)
        y.copy_(x)
        v.sum()
    sizes = {e["op"]: e["bytes"] for e in log.events}
    assert sizes["aten.view.default"] == 0
    assert sizes["aten.empty_like.default"] == 0
    assert sizes["aten.zeros.default"] == 256
    assert sizes["aten.copy_.default"] == 512
    assert sizes["aten.sum.default"] == 256 + 8
    assert op_bytes(torch.ops.aten.add.Tensor, (x, x), {}, x + x) == 3 * 256


def test_kernel_launch_is_logged_where_it_is_counted():
    """A dispatch mode does not see a kernel's launch: the wrappers report
    it, with its operands' and outputs' bytes."""
    from repro_torch.kernels import ops
    before = dict(ops.LAUNCHES)
    partials = torch.zeros(3, dtype=torch.float64)
    try:
        with OpLog() as log:
            ops._operand_bytes = 3 * 800
            ops._launched("fused_dots", partials)
        assert ops.OBSERVER is None
        assert log.events == [{"event": "op", "op": "kernel:fused_dots", "bytes": 2424}]
    finally:
        ops.LAUNCHES.update(before)


def test_recording_comm_logs_starts_and_waits_in_order():
    mesh = Mesh.one_rank()
    t = torch.arange(3, dtype=torch.float64)
    with mesh.record() as rec:
        h = mesh.comm.all_gather_start(t)
        assert torch.equal(mesh.comm.all_gather(t), t[None])
        assert torch.equal(h.wait(), t[None]) and torch.equal(h.wait(), t[None])
        mesh.comm.broadcast(t)
    assert rec.counts == {"all_gather": 2, "exchange": 0, "broadcast": 1}
    assert [(e["event"], e["id"]) for e in rec.events] == [
        ("start", 0), ("start", 1), ("wait", 1), ("wait", 0), ("start", 2), ("wait", 2)]
    assert rec.events[0]["bytes"] == 24
    assert type(mesh.comm).__name__ == "LocalComm"
