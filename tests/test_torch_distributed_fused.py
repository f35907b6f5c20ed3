"""The distributed solve's fused routes, guarded solves and halo modes on 8
gloo ranks, the first two against the reference's own mesh solve.

One spawn of 8 ranks (``test_torch_distributed_ranks.mesh8_fused``) and one
reference subprocess on 8 host devices (``test_torch_distributed.
run_oracle``).  The fused routes run ``kernels=True`` (the kernels' plain
versions on the CPU) against the reference's ``pallas_fused=True`` mesh solve
(its Pallas kernels in interpret mode).  Tolerances: iterations and status
equal, ``max|Δx| < 1e-9``, telemetry within ``assert_telemetry_close``; the
halo modes bitwise.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from test_torch_distributed import (MESH, assert_matches_oracle, assert_ranks_agree, key,
                                    run_oracle)
from test_torch_distributed_ranks import FUSED_ROUTES, GUARDED, HALO_GRID, MESH8_GRID, spawn
from test_torch_harness import assert_telemetry_close

from repro_torch.core.methods import get_method

CASES = ([(key("fused", m, p), *MESH, MESH8_GRID, "27pt", m, p, True, False)
          for m, p in FUSED_ROUTES]
         + [(key("guarded", m, p), *MESH, MESH8_GRID, "27pt", m, p, False, True)
            for m, p in GUARDED])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn(8, "mesh8_fused", tmp_path_factory.mktemp("mesh8_fused"))


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    return run_oracle(CASES, tmp_path_factory.mktemp("oracle8_fused"), devices=8)


@pytest.mark.parametrize("route", FUSED_ROUTES, ids=lambda r: "+".join(r))
def test_fused_routes_match_reference_pallas_mesh_solve(ranks, oracle, route):
    """The six fused routes under ``kernels=True`` (the kernels' plain
    versions on the CPU, the fused bodies on ``KernelOp`` over the
    ``DistributedOp``) against the reference's ``pallas_fused=True`` mesh
    solve (its Pallas kernels in interpret mode)."""
    recs = [r[("fused", *route)] for r in ranks]
    assert_matches_oracle(recs, oracle[key("fused", *route)], route)
    assert_ranks_agree(recs, str(route))


@pytest.mark.parametrize("route", GUARDED, ids=lambda r: "+".join(r))
def test_guarded_telemetry_solve_matches_reference(ranks, oracle, route):
    """A guarded solve with telemetry on the mesh: the reference's status
    and iterations, its telemetry within ``assert_telemetry_close``, every
    rank's telemetry bitwise the same."""
    recs = [r[("guarded", *route)] for r in ranks]
    ref = oracle[key("guarded", *route)]
    assert_matches_oracle(recs, ref, route)
    assert_ranks_agree(recs, str(route))
    mdef = get_method(route[0])
    assert_telemetry_close(recs[0]["telemetry"], np.asarray(ref["telemetry"]),
                           np.asarray(ref["history"]), ref["iters"],
                           mdef.scalars.index(mdef.res_scalar))


@pytest.mark.parametrize("layout", ["1d", "3d"])
@pytest.mark.parametrize("stencil", ["7pt", "27pt"])
def test_halo_modes_bitwise_identical(ranks, layout, stencil):
    """scatter, concat and overlap give bitwise the same cg solve (x,
    history) on the 1-D mesh of 8 and the 3-D mesh (2, 2, 2), 8×8×16."""
    for r in ranks:
        want = r[("halo", layout, stencil, "concat")]
        assert want["status"] == 0
        assert float((want["x"] - 1).abs().max()) < 1e-6
        for hm in ("scatter", "overlap"):
            got = r[("halo", layout, stencil, hm)]
            assert got["iters"] == want["iters"]
            assert torch.equal(got["x"], want["x"]), (layout, stencil, hm)
            torch.testing.assert_close(got["history"], want["history"], rtol=0, atol=0,
                                       equal_nan=True)
    assert HALO_GRID == (8, 8, 16)


