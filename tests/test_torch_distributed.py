"""Every method of the distributed solve on 8 gloo ranks against the
reference's own mesh solve (``repro.core.distributed.solve_shardmap`` on the
same mesh shape).

One spawn of 8 ranks (``test_torch_distributed_ranks.mesh8``) runs every
case; one subprocess runs the reference on 8 host devices
(``conftest.run_multidevice``, the jax-0.9 shim applied in it, and
``jax.shard_map`` given ``check_vma=False`` so that the reference's Pallas
kernels run inside it, as its jax < 0.6 branch passes ``check_rep=False``).
The oracle is the reference's mesh solve, not its single-device solve:
relaxed Gauss-Seidel's stale halos and block-Jacobi's block are the
mesh's.  Tolerances: iterations and status equal, ``max|Δx| < 1e-9``,
histories and telemetry as the port's other reference tests hold them.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from conftest import run_multidevice
from test_torch_distributed_ranks import MAXITER, MESH8_GRID, TOL, spawn
from test_torch_harness import assert_history_equal

from repro_torch.core.operators import STENCILS, build_ell_from_stencil
from repro_torch.core.solvers import SOLVERS

#: the reference's mesh solve of each case, in a subprocess with ``devices``
#: host devices; each case is (key, mesh shape, axes, grid, stencil, method,
#: precond, pallas_fused, guarded); x goes to an npz beside the JSON
_ORACLE = r"""
import functools, json, os, sys
sys.path.insert(0, "src")
import jax
from jax._src.interpreters import batching as _batching
_proxy = type(jax.interpreters.batching.primitive_batchers)
if "__contains__" not in vars(_proxy) and _proxy is not dict:
    _proxy.__contains__ = lambda self, p: p in _batching.fancy_primitive_batchers
jax.shard_map = functools.partial(jax.shard_map, check_vma=False)
jax.config.update("jax_enable_x64", True)
import numpy as np
from jax.sharding import NamedSharding
from repro.api import SolverOptions
from repro.core.compat import make_mesh
from repro.core.distributed import solve_shardmap
from repro.core.problems import make_problem
from repro.precond import make_precond

spec = json.loads(os.environ["ORACLE_SPEC"])
out, xs = {}, {}
for key, shape, axes, grid, st, m, p, fused, guarded in spec["cases"]:
    mesh = make_mesh(tuple(shape), tuple(axes))
    prob = make_problem(tuple(grid), st)
    pre = None if p == "none" else make_precond(p, **({"use_pallas": True} if fused else {}))
    opts = SolverOptions(guards=guarded, telemetry=guarded)
    fn, layout = solve_shardmap(prob, m, mesh, tol=spec["tol"], maxiter=spec["maxiter"],
                                precond=pre, pallas_fused=fused,
                                telemetry=opts.telemetry_rows() if guarded else 0,
                                guard_spec=opts.guard_spec())
    sh = NamedSharding(mesh, layout.spec())
    res = jax.jit(fn)(jax.device_put(prob.b(), sh), jax.device_put(prob.x0(), sh))
    xs[key] = np.asarray(res.x)
    out[key] = dict(iters=int(res.iters), status=int(res.status),
                    res_norm=float(res.res_norm),
                    history=np.asarray(res.history).tolist(),
                    telemetry=None if res.telemetry is None
                    else np.asarray(res.telemetry).tolist())
np.savez(spec["npz"], **xs)
print(json.dumps(out))
"""


def run_oracle(cases, tmp_path, *, devices: int, timeout: int = 60) -> dict:
    """The reference's mesh solves of ``cases``: ``{key: record}`` with
    ``x`` (the global array) in each record."""
    npz = str(tmp_path / "oracle.npz")
    spec = dict(cases=cases, tol=TOL, maxiter=MAXITER, npz=npz)
    out = run_multidevice(_ORACLE, devices=devices, timeout=timeout,
                          env={"ORACLE_SPEC": json.dumps(spec), "JAX_PLATFORMS": "cpu"})
    xs = np.load(npz)
    for key, rec in out.items():
        rec["x"] = xs[key]
    return out


def key(*parts) -> str:
    return "/".join(parts)


MESH = ((2, 4), ("data", "model"))
CASES = [(key("plain", m), *MESH, MESH8_GRID, "27pt", m, "none", False, False)
         for m in sorted(SOLVERS)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn(8, "mesh8", tmp_path_factory.mktemp("mesh8"))


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    return run_oracle(CASES, tmp_path_factory.mktemp("oracle8"), devices=8)


def _np(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def assert_matches_oracle(recs, ref, what: str) -> None:
    """Every rank: the reference's iterations and status; rank 0's gathered
    ``x`` within 1e-9 of the reference's; the histories as the port's
    reference tests hold them."""
    for r, rec in enumerate(recs):
        assert (rec["iters"], rec["status"]) == (ref["iters"], ref["status"]), (what, r)
    dx = float(np.abs(_np(recs[0]["x"]) - ref["x"]).max())
    assert dx < 1e-9, (what, dx)
    assert_history_equal(recs[0]["history"], np.asarray(ref["history"]))


def assert_ranks_agree(recs, what: str) -> None:
    """Every rank's scalars bitwise rank 0's (the same stop, the same
    residual history), and the same gathered ``x``."""
    for r, rec in enumerate(recs[1:], 1):
        assert rec["iters"] == recs[0]["iters"], (what, r)
        for name in ("res_norm", "history", "telemetry", "x"):
            a, b = rec[name], recs[0][name]
            if a is None:
                assert b is None
                continue
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                       msg=f"{what}: rank {r} {name}")


@pytest.mark.parametrize("method", sorted(SOLVERS))
def test_every_method_matches_reference_mesh_solve(ranks, oracle, method):
    """Every method of ``SOLVERS`` on the (2, 4) data×model mesh at 16³
    27pt: the reference mesh solve's iterations and status, max |Δx| <
    1e-9, every rank's scalars bitwise the same."""
    recs = [r[("plain", method)] for r in ranks]
    assert_matches_oracle(recs, oracle[key("plain", method)], method)
    assert_ranks_agree(recs, method)


@pytest.mark.parametrize("method", ["cg", "bicgstab_b1", "pcg_pipe"])
def test_ranks_agree_on_a_seeded_b(ranks, method):
    """On a seeded global b (tol 1e-8): every rank's scalars and stop bitwise
    the same, and the solve converged (``x`` solves the system)."""
    recs = [r[("seeded", method)] for r in ranks]
    assert recs[0]["status"] == 0
    assert_ranks_agree(recs, method)
    assert len({r["iters"] for r in recs}) == 1


def test_resolve_backend_over_8_ranks(ranks):
    """``auto`` and ``1d``: the 1-D cells mesh over the 8 ranks; ``2d``: the
    largest model axis ≤ 16 that divides 8; ``3d``: pod×data×model (2, 1,
    4), the reference's factoring."""
    want = {"auto": "shard_map(cells=8; gloo, cpu)", "local": "local(1 device, cpu)",
            "1d": "shard_map(cells=8; gloo, cpu)",
            "2d": "shard_map(data=1,model=8; gloo, cpu)",
            "3d": "shard_map(pod=2,data=1,model=4; gloo, cpu)"}
    for r in ranks:
        assert r["backends"] == want


@pytest.mark.parametrize("stencil", ["7pt", "27pt"])
def test_ell_equals_reference_ell(stencil):
    """``build_ell_from_stencil`` gives the reference's index and value
    arrays (``tests/test_operators.py``'s operator)."""
    from test_torch_harness import ref_module
    jop = ref_module("core.operators")
    shape = (5, 3, 6)
    ours = build_ell_from_stencil(STENCILS[stencil], shape)
    theirs = jop.build_ell_from_stencil(jop.STENCILS[stencil], shape)
    np.testing.assert_array_equal(ours.indices.numpy(), np.asarray(theirs.indices))
    np.testing.assert_array_equal(ours.values.numpy(), np.asarray(theirs.values))
