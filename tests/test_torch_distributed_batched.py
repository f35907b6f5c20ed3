"""The batched solve on a mesh of gloo ranks (``SolverSession.solve_batched``
on a lane-batched ``DistributedOp``) against the reference's
``SolverSession.solve_batched`` on the same mesh (vmap inside shard_map).

One spawn of 8 ranks (``test_torch_distributed_ranks.spawn``) runs every
case of the port; one subprocess runs the reference's on 8 host devices,
through the jax-0.9 shim as ``test_torch_distributed.run_oracle`` does.
The cases: cg_nb at 12×12×16 27pt on the 1-D mesh of 8 with 8 lanes
(``tests/test_api.py``'s batched shard path), pcg + jacobi at 12×12×16 7pt
on the same mesh with 4 lanes (``tests/test_precond.py``'s), and every
``SOLVERS`` method at B = 4 (A·1, two seeded lanes, a zero lane) on the
(2, 4) data×model mesh at 16³ 27pt on the plain route (the kernels' route
is ``test_torch_distributed_batched_kernels.py``), the stationary methods
to ``tol=1e-3`` within 40 iterations (at 1e-6 their hundreds of
iterations, each lane solved again alone, would hold 8 ranks for minutes;
so their slow lanes stop on ``maxiter``, the others converge).  Tolerances: every
lane's iterations and status equal, ``max|Δx| < 1e-9``.  Port-internal:
each lane bitwise the port's single mesh solve of it, on every rank; the
three halo modes bitwise alike; one batched step's collectives the single
step's, each carrying B lanes' payload (``analysis.audit.compare_batched``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_distributed_ranks import MESH8_GRID, spawn

from repro_torch.analysis import audit
from repro_torch.api import SolverOptions, SolverSession
from repro_torch.core.methods import get_method
from repro_torch.core.problems import make_problem
from repro_torch.core.solvers import SOLVERS
from repro_torch.launch.mesh import Mesh

#: the reference's batched mesh solve of each case, in a subprocess with 8
#: host devices: (key, mesh shape, axes, grid, stencil, method, precond,
#: pallas, tol, maxiter); the lanes come from the npz the test writes
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
import jax.numpy as jnp
from repro.api import SolverOptions, SolverSession
from repro.core.compat import make_mesh
from repro.core.problems import make_problem

spec = json.loads(os.environ["ORACLE_SPEC"])
lanes = np.load(spec["lanes"])
out, xs = {}, {}
for key, shape, axes, grid, st, m, p, fused, tol, maxiter in spec["cases"]:
    mesh = make_mesh(tuple(shape), tuple(axes))
    prob = make_problem(tuple(grid), st)
    opts = SolverOptions(tol=tol, maxiter=maxiter, precond=p, pallas=fused)
    sess = SolverSession(prob, method=m, mesh=mesh, options=opts)
    res = sess.solve_batched(jnp.asarray(lanes[key]))
    xs[key] = np.asarray(res.x)
    out[key] = dict(iters=np.asarray(res.iters).tolist(),
                    status=np.asarray(res.status).tolist())
np.savez(spec["npz"], **xs)
print(json.dumps(out))
"""

#: the repository's root (the ranks import this module: no conftest, no JAX)
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID12 = (12, 12, 16)
MESH24 = ((2, 4), ("data", "model"))
CELLS8 = ((8,), ("cells",))
TOL, MAXITER = 1e-6, 700
#: the stationary methods' tolerance and iteration cap in the batched cases
STATIONARY_TOL, STATIONARY_MAXITER = 1e-3, 40
LANES = 4


def key(*parts) -> str:
    return "/".join(parts)


def lanes_of(grid, stencil: str, n: int, seed: int, *, a1: bool) -> np.ndarray:
    """``n`` lanes: A·1 first (``a1``), seeded normal lanes, a zero lane
    last when ``a1``."""
    rng = np.random.default_rng(seed)
    out = []
    if a1:
        out.append(make_problem(grid, stencil, device="cpu").b().numpy())
    while len(out) < n - a1:
        out.append(rng.standard_normal(grid))
    if a1:
        out.append(np.zeros(grid))
    return np.stack(out)


def batched_cases(route: str) -> list:
    """The cases of a route (``plain`` or ``kernels``): (key, mesh shape,
    axes, grid, stencil, method, precond, kernels, tol, maxiter, lanes)."""
    fused = route == "kernels"
    out = [(key(route, m), *MESH24, MESH8_GRID, "27pt", m, "none", fused,
            *((STATIONARY_TOL, STATIONARY_MAXITER) if get_method(m).stationary
              else (TOL, MAXITER)),
            lanes_of(MESH8_GRID, "27pt", LANES, 30, a1=True)) for m in sorted(SOLVERS)]
    if route == "plain":
        out.append((key("api", "cg_nb"), *CELLS8, GRID12, "27pt", "cg_nb", "none", False,
                    1e-6, 600, lanes_of(GRID12, "27pt", 8, 1, a1=False)))
        out.append((key("precond", "pcg", "jacobi"), *CELLS8, GRID12, "7pt", "pcg",
                    "jacobi", False, 1e-6, 700, lanes_of(GRID12, "7pt", 4, 1, a1=False)))
    return out


class BatchedOracle:
    """The reference's batched mesh solves of ``cases`` in a subprocess on
    8 host devices, started at once (as ``conftest.run_multidevice`` runs
    one), so that it runs while the ranks do; :meth:`result` waits for it
    and gives ``{key: record}`` with ``x`` (the global lanes)."""

    def __init__(self, cases, tmp_path, timeout: float = 300):
        lanes = str(tmp_path / "lanes.npz")
        np.savez(lanes, **{c[0]: c[-1] for c in cases})
        self.npz, self.timeout = str(tmp_path / "oracle.npz"), timeout
        spec = dict(cases=[list(c[:-1]) for c in cases], lanes=lanes, npz=self.npz)
        env = dict(os.environ, ORACLE_SPEC=json.dumps(spec), JAX_PLATFORMS="cpu",
                   XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                              + " --xla_force_host_platform_device_count=8").strip(),
                   PYTHONPATH=os.pathsep.join([os.path.join(REPO_ROOT, "src"),
                                               os.environ.get("PYTHONPATH", "")]))
        self.proc = subprocess.Popen([sys.executable, "-c", _ORACLE], cwd=REPO_ROOT, env=env,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.value = None

    def result(self) -> dict:
        if self.value is None:
            try:
                out, err = self.proc.communicate(timeout=self.timeout)
            finally:
                if self.proc.poll() is None:
                    self.proc.kill()
            assert self.proc.returncode == 0, err[-3000:]
            self.value = json.loads(out.strip().splitlines()[-1])
            xs = np.load(self.npz)
            for k, rec in self.value.items():
                rec["x"] = xs[k]
        return self.value


# -- what the ranks do -----------------------------------------------------------

def bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits as integers (a NaN equals its own bits)."""
    return t.contiguous().view({8: torch.int64, 4: torch.int32}[t.element_size()])


def _lane_bits(res, i: int, one) -> bool:
    """Lane ``i`` of a batched result bitwise the single solve ``one``
    (iterate, residual norm and history; a zero lane's finalized iterate
    may be NaN in both)."""
    return (int(res.iters[i]) == one.iters and int(res.status[i]) == int(one.status)
            and all(torch.equal(bits(a), bits(b)) for a, b in (
                (res.x[i], one.x), (res.res_norm[i], one.res_norm),
                (res.history[i], one.history))))


def solve_cases(route: str, *, singles: bool = True) -> dict:
    """This rank's batched solve of every case of ``route``: per lane the
    iterations and status, rank 0's gathered ``x`` and (``singles``)
    whether each lane is bitwise its single mesh solve."""
    out = {}
    for k, shape, axes, grid, st, m, p, kern, tol, maxiter, lanes in batched_cases(route):
        mesh = Mesh(shape, axes)
        sess = SolverSession(method=m, grid=grid, stencil=st, device="cpu", mesh=mesh,
                             options=SolverOptions(tol=tol, maxiter=maxiter, precond=p,
                                                   kernels=kern))
        bs = torch.as_tensor(lanes)
        res = sess.solve_batched(bs)
        x = sess.gather(res.x)
        rec = dict(iters=res.iters.tolist(), status=res.status.tolist(),
                   res_norm=res.res_norm, x=x if mesh.rank == 0 else None)
        if singles:
            rec["bitwise"] = [_lane_bits(res, i, sess._solve_unfused(bs[i]))
                              for i in range(bs.shape[0])]
        out[k] = rec
    return out


def batched8(rank: int, world: int) -> dict:
    """World 8: every plain-route case, the halo modes under cg and pcg +
    chebyshev, the eager loop and the module-level ``solve_batched``
    against the session's, and one batched step of every method against
    the single step."""
    out = {"cases": solve_cases("plain")}
    mesh = Mesh(*MESH24)
    lanes = torch.as_tensor(lanes_of(MESH8_GRID, "27pt", LANES, 30, a1=True))
    for m, p in (("cg", "none"), ("pcg", "chebyshev")):
        for hm in ("scatter", "concat", "overlap"):
            sess = SolverSession(method=m, grid=MESH8_GRID, device="cpu", mesh=mesh,
                                 options=SolverOptions(tol=TOL, maxiter=MAXITER, precond=p,
                                                       halo_mode=hm))
            res = sess.solve_batched(lanes)
            out[("halo", m, hm)] = dict(iters=res.iters.tolist(), x=res.x)
    from repro_torch.api import solve_batched
    sess = SolverSession(method="cg", grid=MESH8_GRID, device="cpu", mesh=mesh,
                         options=SolverOptions(tol=TOL, maxiter=MAXITER))
    eager = sess._solve_batched_eager(lanes)
    facade = solve_batched(lanes, method="cg", device="cpu", mesh=mesh, tol=TOL,
                           maxiter=MAXITER)
    out["eager_is_solve"] = bool(torch.equal(eager.x, facade.x)
                                 and eager.iters.tolist() == facade.iters.tolist())
    prob = make_problem(MESH8_GRID, "27pt", device="cpu")
    out["steps"] = {m: audit.measure_batched_step(prob, mesh, m, LANES)
                    for m in sorted(SOLVERS)}
    return out


# -- the tests -------------------------------------------------------------------

@pytest.fixture(scope="module")
def started_oracle(tmp_path_factory):
    oracle = BatchedOracle(batched_cases("plain"), tmp_path_factory.mktemp("oracle"))
    yield oracle
    if oracle.proc.poll() is None:
        oracle.proc.kill()


@pytest.fixture(scope="module")
def ranks(started_oracle, tmp_path_factory):
    return spawn(8, "batched8", tmp_path_factory.mktemp("batched8"))


@pytest.fixture(scope="module")
def oracle(started_oracle):
    return started_oracle.result()


def assert_lanes_match(recs, ref, what: str) -> None:
    """Every rank: each lane's iterations and status the reference's, each
    lane bitwise its single mesh solve; rank 0's gathered lanes within
    1e-9 of the reference's."""
    for r, rec in enumerate(recs):
        assert rec["iters"] == ref["iters"], (what, r, rec["iters"], ref["iters"])
        assert rec["status"] == ref["status"], (what, r)
        if "bitwise" in rec:
            assert all(rec["bitwise"]), (what, r, rec["bitwise"])
        torch.testing.assert_close(rec["res_norm"], recs[0]["res_norm"], rtol=0, atol=0)
    x = recs[0]["x"].numpy()
    # cg_nb's finalize divides 0 by 0 on a zero lane, in both packages
    assert np.array_equal(np.isnan(x), np.isnan(ref["x"])), what
    dx = float(np.nanmax(np.abs(x - ref["x"])))
    assert dx < 1e-9, (what, dx)


@pytest.mark.parametrize("method", sorted(SOLVERS))
def test_every_method_batched_matches_reference_mesh(ranks, oracle, method):
    """Every method at B = 4 on the (2, 4) mesh at 16³ 27pt: each lane the
    reference's iterations and status, max |Δx| < 1e-9, bitwise its single
    mesh solve on every rank."""
    k = key("plain", method)
    assert_lanes_match([r["cases"][k] for r in ranks], oracle[k], method)


@pytest.mark.parametrize("case", [key("api", "cg_nb"), key("precond", "pcg", "jacobi")])
def test_reference_batched_shard_cases(ranks, oracle, case):
    """The reference's own batched mesh cases: cg_nb with 8 lanes (27pt)
    and pcg + jacobi with 4 lanes (7pt) at 12×12×16 on the 1-D mesh of 8."""
    assert_lanes_match([r["cases"][case] for r in ranks], oracle[case], case)


@pytest.mark.parametrize("method, precond", [("cg", "none"), ("pcg", "chebyshev")])
def test_batched_halo_modes_bitwise(ranks, method, precond):
    """scatter, concat and overlap give bitwise the same lanes on a batch."""
    for rec in ranks:
        want = rec[("halo", method, "concat")]
        for hm in ("scatter", "overlap"):
            got = rec[("halo", method, hm)]
            assert got["iters"] == want["iters"] and torch.equal(got["x"], want["x"]), hm


def test_batched_eager_and_module_level_solve(ranks):
    """The session's eager batched loop and the module-level
    ``solve_batched(mesh=)`` give the same lanes."""
    assert all(r["eager_is_solve"] for r in ranks)


@pytest.mark.parametrize("method", sorted(SOLVERS))
def test_batched_step_makes_the_single_steps_collectives(ranks, method):
    """One batched step (4 lanes) makes the single step's collectives in
    the same order, each gather carrying 4 lanes' partials and each halo
    swap 4 lanes' planes, on every rank."""
    for r, rec in enumerate(ranks):
        step = rec["steps"][method]
        assert not audit.compare_batched(f"{method}|rank{r}", step)
        assert step["single"]["counts"].get("all_gather", 0) >= 1
