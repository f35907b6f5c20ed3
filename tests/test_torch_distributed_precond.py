"""Every preconditioner with pcg and pbicgstab on the ("cells",) mesh of 4
gloo ranks, an odd local z extent, and the collectives of one step of every
method, against the reference's own mesh solve on 4 host devices.

One spawn of 4 ranks (``test_torch_distributed_ranks.cells4``) and one
reference subprocess (``test_torch_distributed.run_oracle``).  Red-black
colouring is local in both packages (a block whose z offset is odd colours
apart from the global pattern), and block-Jacobi's block is the rank's:
both are held to the reference's mesh solve, not its single-device one.
Tolerances: iterations and status equal, ``max|Δx| < 1e-9``.
"""

from __future__ import annotations

import pytest
from test_torch_distributed import assert_matches_oracle, assert_ranks_agree, key, run_oracle
from test_torch_distributed_ranks import CELLS_GRID, ODD_CASES, ODD_GRID, PRECONDS, spawn

from repro_torch.api import REGISTRY

CELLS = ((4,), ("cells",))
PRECOND_CASES = [(m, p) for p in PRECONDS for m in ("pcg", "pbicgstab")]
CASES = ([(key("precond", m, p), *CELLS, CELLS_GRID, "27pt", m, p, False, False)
          for m, p in PRECOND_CASES]
         + [(key("odd", m, p), *CELLS, ODD_GRID, "27pt", m, p, False, False)
            for m, p in ODD_CASES])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn(4, "cells4", tmp_path_factory.mktemp("cells4"))


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    return run_oracle(CASES, tmp_path_factory.mktemp("oracle4"), devices=4)


@pytest.mark.parametrize("case", PRECOND_CASES, ids=lambda c: "+".join(c))
def test_every_precond_matches_reference_mesh_solve(ranks, oracle, case):
    """pcg and pbicgstab with each preconditioner at 8×8×16 27pt, 4 z
    planes a rank: the reference mesh solve's iterations and status,
    max |Δx| < 1e-9, every rank's scalars bitwise the same."""
    recs = [r[("precond", *case)] for r in ranks]
    assert_matches_oracle(recs, oracle[key("precond", *case)], case)
    assert_ranks_agree(recs, str(case))


@pytest.mark.parametrize("case", ODD_CASES, ids=lambda c: "+".join(c))
def test_odd_local_extent_matches_reference_mesh_solve(ranks, oracle, case):
    """8×8×12 on 4 ranks: 3 z planes a rank, so ranks 1 and 3 start on an
    odd global plane and their local red-black colouring differs from the
    global one, in both packages (gauss_seidel_rb, SSOR)."""
    recs = [r[("odd", *case)] for r in ranks]
    assert_matches_oracle(recs, oracle[key("odd", *case)], case)
    assert_ranks_agree(recs, str(case))


@pytest.mark.parametrize("method", ["cg", "cg_nb", "bicgstab", "bicgstab_b1"])
def test_collective_counts_per_step(ranks, method):
    """One collective a (fused) reduction, counted by the recording comm on
    one ``solve_step_shardmap`` step: cg 2, cg_nb 2, bicgstab 3, bicgstab_b1
    3 (the reference's ``test_collective_counts_per_iteration``)."""
    want = {"cg": 2, "cg_nb": 2, "bicgstab": 3, "bicgstab_b1": 3}[method]
    for r in ranks:
        assert r[("counts", method)]["all_gather"] == want


@pytest.mark.parametrize("method", sorted(REGISTRY))
def test_step_counts_match_registry(ranks, method):
    """Each method's step makes the registry's ``allreduces_per_iter``
    collectives and ``halo_exchanges_per_iter`` halo swaps (one split dim:
    one ``exchange`` a swap), on every rank."""
    spec = REGISTRY[method]
    for r in ranks:
        counts = r[("counts", method)]
        assert counts["all_gather"] == spec.allreduces_per_iter, counts
        assert counts["exchange"] == spec.halo_exchanges_per_iter, counts
        assert counts["broadcast"] == 0


def test_overlap_under_kernels_raises_naming_the_shapes(ranks):
    """``halo_mode="overlap"`` with ``kernels=True`` on a split mesh is
    refused by the session, naming the padded operands of the split (the
    interior and the 3-plane shell slabs), on every rank."""
    for r in ranks:
        msg = r["overlap_kernels"]
        assert msg is not None and "(10, 10, 4)" in msg and "(10, 10, 3)" in msg


def test_cli_and_config_on_the_mesh(ranks, oracle):
    """``launch/solve.py --layout 1d`` inside the ranks' group (as under
    ``torchrun``) solves on the cells mesh of 4, its record naming the
    mesh; ``SolverConfig.session(mesh=)`` runs a cell there, with the
    reference mesh solve's iterations."""
    for r in ranks:
        cli = r["cli"]
        assert cli["backend"] == "shard_map(cells=4; gloo, cpu)"
        assert cli["halo_mode"] == "concat" and cli["err"] < 1e-6
        assert r["config"]["iters"] == oracle[key("precond", "pcg", "ssor")]["iters"]
    assert_ranks_agree([r["config"] for r in ranks], "hpcg-pcg-ssor-27pt")


def test_resolve_backend_over_4_ranks(ranks):
    """``auto`` and ``1d``: cells=4; ``2d``: data=1 × model=4; ``3d``
    needs ≥ 8 ranks (the reference's ValueError)."""
    want = {"auto": "shard_map(cells=4; gloo, cpu)", "local": "local(1 device, cpu)",
            "1d": "shard_map(cells=4; gloo, cpu)",
            "2d": "shard_map(data=1,model=4; gloo, cpu)",
            "3d": "ValueError: 3d layout needs >= 8 devices, have 4"}
    for r in ranks:
        assert r["backends"] == want
