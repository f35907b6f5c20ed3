"""The batched solve on a mesh of gloo ranks on the kernels' route
(``kernels=True``: ``KernelOp`` over the lane-batched ``DistributedOp``, the
lane-batched SpMV, Chebyshev step and block-Jacobi sweep on the exchanged
padded lanes; their plain versions here) against the reference's batched
mesh solve with ``pallas=True`` (its kernels in interpret mode).

The cases and tolerances are ``test_torch_distributed_batched.py``'s on the
(2, 4) data×model mesh at 16³ 27pt: every ``SOLVERS`` method at B = 4 (the
stationary ones to ``tol=1e-3`` within 40 iterations), each
lane's iterations and status the reference's, ``max|Δx| < 1e-9``, each lane
bitwise the port's single mesh solve of it on every rank.  Also: pcg +
chebyshev and pcg + block_jacobi, whose preconditioner sweeps run on the
lane-batched kernels, each lane bitwise its single mesh solve.
"""

from __future__ import annotations

import pytest
import torch
from test_torch_distributed_batched import (LANES, MAXITER, MESH24, TOL, BatchedOracle,
                                            assert_lanes_match, batched_cases, key, lanes_of,
                                            solve_cases)
from test_torch_distributed_batched import _lane_bits
from test_torch_distributed_ranks import MESH8_GRID, spawn

from repro_torch.api import SolverOptions, SolverSession
from repro_torch.core.solvers import SOLVERS
from repro_torch.launch.mesh import Mesh

#: the preconditioned batched cases whose sweeps run on lane-batched kernels
PRECOND_CASES = (("pcg", "chebyshev"), ("pcg", "block_jacobi"))


def batched8_kernels(rank: int, world: int) -> dict:
    """World 8: every kernels-route case, and the preconditioned cases."""
    out = {"cases": solve_cases("kernels")}
    mesh = Mesh(*MESH24)
    bs = torch.as_tensor(lanes_of(MESH8_GRID, "27pt", LANES, 30, a1=True))
    for m, p in PRECOND_CASES:
        sess = SolverSession(method=m, grid=MESH8_GRID, device="cpu", mesh=mesh,
                             options=SolverOptions(tol=TOL, maxiter=MAXITER, precond=p,
                                                   kernels=True))
        res = sess.solve_batched(bs)
        out[("precond", m, p)] = dict(
            iters=res.iters.tolist(),
            bitwise=[_lane_bits(res, i, sess._solve_unfused(bs[i])) for i in range(LANES)])
    return out


@pytest.fixture(scope="module")
def started_oracle(tmp_path_factory):
    oracle = BatchedOracle(batched_cases("kernels"), tmp_path_factory.mktemp("oracle"))
    yield oracle
    if oracle.proc.poll() is None:
        oracle.proc.kill()


@pytest.fixture(scope="module")
def ranks(started_oracle, tmp_path_factory):
    return spawn(8, "batched8_kernels", tmp_path_factory.mktemp("batched8k"), timeout=480)


@pytest.fixture(scope="module")
def oracle(started_oracle):
    return started_oracle.result()


@pytest.mark.parametrize("method", sorted(SOLVERS))
def test_every_method_batched_kernels_match_reference_mesh(ranks, oracle, method):
    """Every method at B = 4 with ``kernels=True`` on the (2, 4) mesh: each
    lane the reference's (``pallas=True``) iterations and status, max |Δx|
    < 1e-9, bitwise its single mesh solve on every rank."""
    k = key("kernels", method)
    assert_lanes_match([r["cases"][k] for r in ranks], oracle[k], method)


@pytest.mark.parametrize("method, precond", PRECOND_CASES)
def test_batched_kernel_preconditioners_bitwise_single(ranks, method, precond):
    """pcg with the Chebyshev and block-Jacobi sweeps on the lane-batched
    kernels: every lane converged and bitwise its single mesh solve, the
    same on every rank."""
    recs = [r[("precond", method, precond)] for r in ranks]
    for rec in recs:
        assert rec["iters"] == recs[0]["iters"] and all(rec["bitwise"]), rec
    assert recs[0]["iters"][-1] == 0 and min(recs[0]["iters"][:-1]) > 0
