"""The distributed solve's rank side: the spawn harness, the work each gloo
rank does for the mesh tests, and the tests that need no second process.

``spawn(world, worker, tmp_path)`` starts ``world`` processes with
``torch.multiprocessing`` (spawn), each a ``gloo`` rank of a group met
through a ``file://`` rendezvous in ``tmp_path`` (so test workers never
share a port), runs ``WORKERS[worker]`` on every rank and returns each
rank's record.  Every run has a hard timeout: the group's own
(``init_process_group(timeout=)``, so a collective that waits for a rank
that failed raises) and the join's (the worker's measured ``SPAWN_LIMITS``),
after which every rank is killed; an exception on any rank fails the run.
This module imports no JAX, so the ranks start light; the modules holding
the ranks to the reference import it.
"""

from __future__ import annotations

import datetime
import importlib
import itertools
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.api import REGISTRY, SolverOptions, SolverSession
from repro_torch.api.backend import resolve_backend, resolve_halo_mode
from repro_torch.core.distributed import (DistributedOp, GridLayout, init_step_state,
                                          make_layout, solve_shardmap, solve_step_shardmap,
                                          step_state_layout)
from repro_torch.core.methods import Ops, get_method
from repro_torch.core.operators import (STENCILS, ELLOperator, build_dense_from_stencil,
                                        build_ell_from_stencil, interior_matvec,
                                        shell_assemble)
from repro_torch.core.problems import make_problem
from repro_torch.core.solvers import SOLVERS, LocalOp
from repro_torch.launch.mesh import Mesh

#: the hard limit of each collective inside a spawned run (s)
GROUP_TIMEOUT = 60
#: the hard limit of one spawned run of each worker (s): three times its
#: seconds under the suite's parallel command (``-n 6 --dist loadfile``,
#: load average 20–30 at their ends: overlap8 97.1, mesh8 81.6, mesh8_fused
#: 11.6, elastic8 17.8, batched8 206.2, batched8_kernels 157.4, cells4 26.4;
#: attrib2 4.2 in a later run of the suite), rounded up to 30 s, and never
#: under 120 s (300 s, 480 s: the limits they had before)
SPAWN_LIMITS = {"overlap8": 300, "mesh8": 270, "mesh8_fused": 120, "cells4": 120,
                "elastic8": 300, "batched8": 630, "batched8_kernels": 480, "attrib2": 120}

#: the fused routes (method, precond) under kernels=True
FUSED_ROUTES = (("cg_merged", "none"), ("pcg_merged", "chebyshev"), ("cg_pipe", "none"),
                ("pcg_pipe", "chebyshev"), ("bicgstab_merged", "none"),
                ("pbicgstab_merged", "chebyshev"))
#: every preconditioner, with pcg and pbicgstab
PRECONDS = ("jacobi", "block_jacobi", "ssor", "chebyshev")
#: the guarded solves with telemetry held to the reference
GUARDED = (("cg", "none"), ("pcg_merged", "chebyshev"))
#: the cases on the ("cells",) mesh of 4 whose local z extent is odd (3)
ODD_CASES = (("gauss_seidel_rb", "none"), ("pcg", "ssor"), ("pbicgstab", "ssor"),
             ("pcg", "block_jacobi"))
#: the methods solved on a seeded b (global, the same on every rank)
SEEDED = ("cg", "bicgstab_b1", "pcg_pipe")
HALO_GRID = (8, 8, 16)
MESH8_GRID = (16, 16, 16)
CELLS_GRID, ODD_GRID = (8, 8, 16), (8, 8, 12)
TOL, MAXITER = 1e-6, 700


# -- the spawn harness -----------------------------------------------------------

def _entry(rank: int, world: int, worker: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rendezvous",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    try:
        out = WORKERS[worker](rank, world)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(world: int, worker: str, tmp_path) -> list:
    """``WORKERS[worker](rank, world)`` on ``world`` gloo ranks; each
    rank's record, in rank order.  A rank's exception, or the worker's
    deadline (``SPAWN_LIMITS``), fails the run and ends every rank."""
    timeout = SPAWN_LIMITS[worker]
    out_dir = str(tmp_path)
    ctx = mp.start_processes(_entry, args=(world, worker, out_dir), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{worker}: {world} ranks ran past {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# -- what the ranks do -----------------------------------------------------------

def _record(sess, res, gather: bool = True) -> dict:
    """A solve's record: scalars from this rank, ``x`` gathered to the
    global array."""
    out = dict(iters=int(res.iters), status=int(res.status), res_norm=res.res_norm,
               history=res.history, telemetry=res.telemetry)
    if gather:
        out["x"] = sess.gather(res.x)
    return out


def _solve(mesh, grid, stencil, method, precond="none", **opts) -> dict:
    sess = SolverSession(method=method, grid=grid, stencil=stencil, device="cpu",
                         mesh=mesh, options=SolverOptions(tol=TOL, maxiter=MAXITER,
                                                          precond=precond, **opts))
    return _record(sess, sess.solve())


def _backends(world: int) -> dict:
    out = {}
    for layout in ("auto", "local", "1d", "2d", "3d"):
        try:
            out[layout] = resolve_backend(SolverOptions(layout=layout), device="cpu").describe()
        except ValueError as e:
            out[layout] = f"ValueError: {e}"
    return out


def mesh8(rank: int, world: int) -> dict:
    """World 8: every method on the (2, 4) data×model mesh at 16³ 27pt and
    the backend rules over 8 ranks."""
    out = {"backends": _backends(world)}
    mesh = Mesh((2, 4), ("data", "model"))
    for m in sorted(SOLVERS):
        out[("plain", m)] = _solve(mesh, MESH8_GRID, "27pt", m)
    b = torch.as_tensor(np.random.default_rng(28).standard_normal(MESH8_GRID))
    for m in SEEDED:
        sess = SolverSession(method=m, grid=MESH8_GRID, device="cpu", mesh=mesh,
                             options=SolverOptions(tol=1e-8, maxiter=MAXITER))
        out[("seeded", m)] = _record(sess, sess.solve(b=b))
    return out


def mesh8_fused(rank: int, world: int) -> dict:
    """World 8: the fused routes under kernels=True and the guarded solves
    with telemetry on the (2, 4) mesh at 16³ 27pt; the three halo modes on
    the 1-D mesh of 8 and the 3-D mesh (2, 2, 2), both stencils."""
    out = {}
    mesh = Mesh((2, 4), ("data", "model"))
    for m, p in FUSED_ROUTES:
        out[("fused", m, p)] = _solve(mesh, MESH8_GRID, "27pt", m, p, kernels=True)
    for m, p in GUARDED:
        out[("guarded", m, p)] = _solve(mesh, MESH8_GRID, "27pt", m, p, guards=True,
                                        telemetry=True)
    for tag, shape, axes in (("1d", (8,), ("cells",)),
                             ("3d", (2, 2, 2), ("pod", "data", "model"))):
        halo_mesh = Mesh(shape, axes)
        for st, hm in itertools.product(("7pt", "27pt"), ("scatter", "concat", "overlap")):
            out[("halo", tag, st, hm)] = _solve(halo_mesh, HALO_GRID, st, "cg",
                                                halo_mode=hm)
    return out


def _step_counts(mesh, grid, method: str) -> dict:
    """The collectives and halo swaps of one ``solve_step_shardmap`` step."""
    prob = make_problem(grid, "27pt", dtype=torch.float64, device="cpu")
    layout = make_layout(mesh)
    b = layout.block(prob.b(), grid)
    x0 = layout.block(prob.x0(), grid)
    state = init_step_state(method, DistributedOp(prob.stencil, layout), b, x0)
    fn, _ = solve_step_shardmap(prob, method, mesh)
    with mesh.record() as rec:
        fn(*state)
    return dict(rec.counts)


def cells4(rank: int, world: int) -> dict:
    """World 4: every preconditioner with pcg and pbicgstab on the
    ("cells",) mesh of 4 at 8×8×16, the odd local extent (8×8×12: 3 z
    planes a rank), the collectives of one step of every method, the
    refusal of the overlap split under the kernels, and the backend rules
    over 4 ranks."""
    mesh = Mesh((4,), ("cells",))
    out = {"backends": _backends(world)}
    for p, m in itertools.product(PRECONDS, ("pcg", "pbicgstab")):
        out[("precond", m, p)] = _solve(mesh, CELLS_GRID, "27pt", m, p)
    for m, p in ODD_CASES:
        out[("odd", m, p)] = _solve(mesh, ODD_GRID, "27pt", m, p)
    for m in sorted(SOLVERS):
        out[("counts", m)] = _step_counts(mesh, CELLS_GRID, m)
    try:
        SolverSession(method="cg", grid=CELLS_GRID, device="cpu", mesh=mesh,
                      options=SolverOptions(kernels=True, halo_mode="overlap"))
        out["overlap_kernels"] = None
    except ValueError as e:
        out["overlap_kernels"] = str(e)
    from repro_torch.launch.solve import main
    out["cli"] = main(["--device", "cpu", "--layout", "1d", "--grid", *map(str, CELLS_GRID),
                       "--method", "cg_merged", "--kernels", "--halo-mode", "concat"])
    from repro_torch.configs.hpcg import SOLVER_CONFIGS
    sess = SOLVER_CONFIGS["hpcg-pcg-ssor-27pt"].session(mesh=mesh, grid=CELLS_GRID,
                                                         device="cpu")
    out["config"] = _record(sess, sess.solve())
    return out


def attrib2(rank: int, world: int) -> dict:
    """World 2: the cost attribution on the ("cells",) mesh of 2 at 8×8×16
    (cg, cg_merged), the collectives of one trip of its step chain, and the
    CLI on every rank into one trace: the mesh of both ranks, then of rank
    0 alone (rank 1 waiting at the barrier)."""
    from repro_torch.obs import trace
    from repro_torch.obs.__main__ import main
    from repro_torch.obs.attribution import _phase_fns, attribution_report
    mesh = Mesh((2,), ("cells",))
    out = {"rows": attribution_report(["cg", "cg_merged"], CELLS_GRID, mesh, inner=2,
                                      repeats=2, device="cpu")}
    prob = make_problem(CELLS_GRID, "27pt", dtype=torch.float64, device="cpu")
    for m in ("cg", "cg_merged"):
        step_chain, _, _, _, state0 = _phase_fns(prob, m, mesh, halo_mode="concat", inner=1)
        with mesh.record() as rec:
            step_chain(*state0)
        out[("trip", m)] = dict(rec.counts)
    path = os.environ["ATTRIB_TRACE"]
    trace.enable(path)
    try:
        cli = ["attribute", "--device", "cpu", "--grid", *map(str, CELLS_GRID),
               "--methods", "cg", "--inner", "1", "--repeats", "1"]
        out["cli"] = [main([*cli, "--devices", n]) for n in ("2", "1")]
    finally:
        trace.disable()
    return out


def _elsewhere(module: str, name: str):
    """A worker defined in another test module, imported on the rank."""
    def worker(rank: int, world: int):
        return getattr(importlib.import_module(module), name)(rank, world)
    return worker


WORKERS = {"mesh8": mesh8, "mesh8_fused": mesh8_fused, "cells4": cells4, "attrib2": attrib2,
           "overlap8": _elsewhere("test_torch_overlap", "overlap8"),
           "batched8": _elsewhere("test_torch_distributed_batched", "batched8"),
           "batched8_kernels": _elsewhere("test_torch_distributed_batched_kernels",
                                          "batched8_kernels"),
           "elastic8": _elsewhere("test_torch_elastic", "elastic8")}


# -- tests that need no second process ---------------------------------------------

def _seeded(shape, seed=0) -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(shape))


SPLITS = [s for n in (1, 2, 3) for s in itertools.combinations(range(3), n)]


@pytest.mark.parametrize("stencil", ["7pt", "27pt"])
@pytest.mark.parametrize("split", SPLITS, ids=lambda s: "".join("xyz"[d] for d in s))
def test_interior_shell_split_bitwise_monolithic(stencil, split):
    """The overlap split (interior from the block, shell slabs from the
    exchanged padded array) is bitwise the monolithic apply, on every
    combination of split dims (f64, a seeded block and halo)."""
    st = STENCILS[stencil]
    shape = (5, 4, 6)
    xp = _seeded(tuple(n + 2 for n in shape), seed=len(split))
    unsplit = [d for d in range(3) if d not in split]
    for d in unsplit:                       # the physical boundary: zero halo
        xp.narrow(d, 0, 1).zero_()
        xp.narrow(d, xp.shape[d] - 1, 1).zero_()
    x = xp[1:-1, 1:-1, 1:-1].contiguous()
    y_int = interior_matvec(st.matvec_padded, x, split)
    assert tuple(y_int.shape) == tuple(n - 2 if d in split else n
                                       for d, n in enumerate(shape))
    y = shell_assemble(st.matvec_padded, xp, y_int, split)
    assert torch.equal(y, st.matvec_padded(xp))


@pytest.mark.parametrize("stencil", ["7pt", "27pt"])
@pytest.mark.parametrize("shape", [(4, 4, 4), (5, 3, 6), (8, 8, 8)])
def test_ell_matches_stencil_and_dense(stencil, shape):
    """The ELL operator applies the stencil (within rounding: another
    summation order) and is the dense matrix."""
    st = STENCILS[stencil]
    x = _seeded(shape, seed=1)
    ell = build_ell_from_stencil(st, shape)
    assert isinstance(ell, ELLOperator) and ell.rows == int(np.prod(shape))
    torch.testing.assert_close(ell.matvec(x), st.matvec(x), rtol=1e-13, atol=1e-13)
    dense = build_dense_from_stencil(st, shape)
    np.testing.assert_allclose(dense @ x.numpy().reshape(-1),
                               ell.matvec(x).numpy().reshape(-1), rtol=1e-13, atol=1e-12)
    np.testing.assert_array_equal(dense, dense.T)


@pytest.mark.parametrize("method", sorted(REGISTRY))
def test_one_step_matches_one_solver_iteration(method):
    """On a mesh of one rank (no process group), one ``solve_step_shardmap``
    step is one iteration of the solver, bitwise (the same operator
    arithmetic, the reductions the local dots)."""
    mesh = Mesh.one_rank()
    prob = make_problem((8, 8, 10), "27pt", dtype=torch.float64, device="cpu")
    A = LocalOp(prob.stencil)
    b, x0 = prob.b(), prob.x0()
    mdef = get_method(method)
    fn, layout = solve_step_shardmap(prob, method, mesh)
    assert layout.dim_axes == (None, None, "cells")
    out = fn(*init_step_state(method, A, b, x0))
    ops = Ops(A, b, norm_ref=1.0)
    x_step = mdef.finalize(ops, x0, out) if mdef.finalize else out[0]
    ref = SOLVERS[method](A, b, x0, tol=1e-30, maxiter=1, norm_ref=1.0)
    assert ref.iters == 1
    assert torch.equal(x_step, ref.x), method
    assert torch.equal(torch.sqrt(out[mdef.res_index]), ref.res_norm), method


def test_fused_step_matches_local_fused_iteration():
    """One fused step on a mesh of one rank is one local fused iteration
    (``KernelOp`` over the ``DistributedOp``, the plain versions here)."""
    from repro_torch.kernels.kernel_op import KernelOp
    prob = make_problem((8, 8, 10), "27pt", dtype=torch.float64, device="cpu")
    A = KernelOp(LocalOp(prob.stencil))
    b, x0 = prob.b(), prob.x0()
    mdef = get_method("cg_merged")
    fn, _ = solve_step_shardmap(prob, "cg_merged", Mesh.one_rank(), kernels_fused=True)
    ops = Ops(A, b, norm_ref=1.0)
    state0 = tuple(mdef.fused_init(ops, x0))
    for slot, (got, want) in enumerate(zip(fn(b, *state0), mdef.fused_step(ops, state0))):
        assert torch.equal(got, want), slot


def test_step_state_and_method_errors():
    """The step state is the MethodDef's; an unregistered method and a
    fused request of a method without a fused body raise as in the
    reference."""
    assert step_state_layout("cg") == (("x", "r", "p"), ("rr",))
    assert step_state_layout("cg_merged") == (
        ("x", "r", "p", "s", "w"), ("gamma", "delta", "gamma_prev", "alpha_prev"))
    prob = make_problem((8, 8, 10), "27pt", dtype=torch.float64, device="cpu")
    mesh = Mesh.one_rank()
    with pytest.raises(ValueError, match="unknown method 'sor'"):
        solve_step_shardmap(prob, "sor", mesh)
    with pytest.raises(ValueError, match="cg_merged"):
        solve_shardmap(prob, "sor", mesh)
    with pytest.raises(ValueError, match="declares no fused kernels"):
        solve_step_shardmap(prob, "cg", mesh, kernels_fused=True)
    with pytest.raises(ValueError, match="takes no preconditioner"):
        solve_shardmap(prob, "cg", mesh, precond=object())
    with pytest.raises(ValueError, match="incompatible with a custom matvec_padded"):
        solve_shardmap(prob, "cg_merged", mesh, kernels_fused=True,
                       matvec_padded=prob.stencil.matvec_padded)


def test_one_rank_mesh_is_the_local_solve():
    """``layout="1d"`` in one process is a mesh of one rank with no
    process group: every reduction its local dot, so the solve is bitwise
    the local one, and ``gather`` returns the block; so is the batched
    solve, lane by lane, and ``gather`` returns its lanes."""
    for method, kw in (("cg", {}), ("cg_merged", dict(kernels=True)),
                       ("pcg", dict(precond="chebyshev"))):
        opts = SolverOptions(layout="1d", **kw)
        sess = SolverSession(method=method, grid=(8, 8, 10), device="cpu", options=opts)
        assert sess.backend.kind == "shard_map" and sess.backend.n_devices == 1
        assert sess.mesh.backend is None and sess.mesh.coords == (0,)
        res = sess.solve()
        local_sess = SolverSession(method=method, grid=(8, 8, 10), device="cpu",
                                   options=opts.replace(layout="local"))
        local = local_sess.solve()
        assert res.iters == local.iters and res.status == local.status
        assert torch.equal(res.x, local.x)
        torch.testing.assert_close(res.history, local.history, rtol=0, atol=0,
                                   equal_nan=True)
        assert torch.equal(sess.gather(res.x), res.x)
    bs = torch.stack([sess.problem.b(), _seeded((8, 8, 10), seed=4)])
    got = sess.solve_batched(bs)
    want = local_sess.solve_batched(bs)
    assert got.iters.tolist() == want.iters.tolist() and torch.equal(got.x, want.x)
    assert torch.equal(sess.gather(got.x), got.x)


def test_mesh_builders_and_backend_rule():
    """The reference's mesh builders over this process alone, the
    production mesh's shape, and NCCL refused with more ranks than cards
    (several ranks share a card only under gloo)."""
    from repro_torch.launch.mesh import (check_backend, default_backend,
                                         make_mesh_for_devices, make_production_mesh,
                                         make_solver_mesh)
    assert make_solver_mesh().shape == {"cells": 1}
    assert make_mesh_for_devices().shape == {"data": 1, "model": 1}
    assert make_production_mesh() == ((16, 16), ("data", "model"))
    assert make_production_mesh(multi_pod=True) == ((2, 16, 16), ("pod", "data", "model"))
    assert default_backend("cpu") == "gloo" and default_backend("cuda") == "nccl"
    with pytest.raises(RuntimeError, match="one card a rank"):
        check_backend("nccl", torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="unknown backend"):
        check_backend("mpi", 1)
    check_backend("gloo", 64)


def test_recording_comm_counts_a_one_rank_step():
    """The recording wrapper counts the reductions of a step (cg: 2) and
    no halo swap on a mesh with nothing split."""
    mesh = Mesh.one_rank()
    prob = make_problem((6, 6, 6), "7pt", dtype=torch.float64, device="cpu")
    state = init_step_state("cg", LocalOp(prob.stencil), prob.b(), prob.x0())
    fn, _ = solve_step_shardmap(prob, "cg", mesh)
    with mesh.record() as rec:
        fn(*state)
    assert rec.counts == {"all_gather": 2, "exchange": 0, "broadcast": 0}
    assert mesh.comm is not rec


@pytest.mark.parametrize("opts, want", [
    (dict(), "overlap"),
    (dict(halo_mode="scatter"), "scatter"),
    (dict(kernels=True), "concat"),
    (dict(matvec_padded=STENCILS["7pt"].matvec_padded), "concat"),
    (dict(kernels=True, halo_mode="overlap"), "overlap"),
])
def test_resolve_halo_mode(opts, want):
    """``auto`` is ``overlap`` for the plain apply and ``concat`` under
    the kernels or a custom ``matvec_padded``; an explicit mode wins."""
    assert resolve_halo_mode(SolverOptions(**opts)) == want


def test_resolve_backend_one_rank():
    """With no process group: ``auto`` and ``local`` are one device, ``1d``
    and ``2d`` meshes of one rank, ``3d`` needs ≥ 8 ranks; an explicit mesh
    wins, with ``dims_map`` over its default layout."""
    assert resolve_backend(SolverOptions(), device="cpu").kind == "local"
    assert resolve_backend(SolverOptions(layout="local"), device="cpu").kind == "local"
    one = resolve_backend(SolverOptions(layout="1d"), device="cpu")
    assert one.describe() == "shard_map(cells=1; no group, cpu)"
    assert one.layout.dim_axes == (None, None, "cells")
    two = resolve_backend(SolverOptions(layout="2d"), device="cpu")
    assert two.mesh.shape == {"data": 1, "model": 1}
    assert two.layout.dim_axes == ("model", "data", None)
    with pytest.raises(ValueError, match=">= 8"):
        resolve_backend(SolverOptions(layout="3d"), device="cpu")
    mesh = Mesh.one_rank(("data", "model"))
    be = resolve_backend(SolverOptions(dims_map={"z": "model"}), mesh=mesh, device="cpu")
    assert be.layout.dim_axes == (None, None, "model") and be.n_devices == 1
    with pytest.raises(RuntimeError, match="init_process_group"):
        Mesh((4,), ("cells",))
    with pytest.raises(ValueError, match="not in mesh"):
        GridLayout(mesh, ("cells", None, None))
