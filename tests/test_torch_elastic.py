"""The solver service on a mesh of gloo ranks and the elastic runtime
(``runtime/elastic.py``, ``restore(shardings=)``) against the reference's
device-loss resume (``tests/test_resilience.py``'s ``SCRIPT_DEVICE_LOSS``).

One spawn of 8 ranks (``test_torch_distributed_ranks.spawn``) runs:
``shrink_mesh`` (8 ranks, 2 lost, trimmed to 4 that divide the grid's
extent 8; the axis kept; a multi-axis mesh raises ``ValueError``); the
reference's device-loss stream — 4 cg requests at 8³ on the ``cells`` mesh
of 8 with ``max_batch=2`` and guards, ranks 6 and 7 lost at dispatch 0 —
served SPMD, every rank submitting the same requests; ``reshard_array`` and
``restore(shardings=)`` of a checkpoint saved on 4 ranks onto 2; and a
journal orphaned by a service on 8 ranks recovered cold by a service on 4.
One subprocess runs the reference's stream on 8 host devices (the jax-0.9
shim applied) and keeps each result's ``x``: the port's are within 1e-9.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_distributed_ranks import spawn

from repro_torch.core.distributed import make_layout
from repro_torch.launch.mesh import Mesh
from repro_torch.resilience import ChaosInjector, ChaosPlan
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime import elastic
from repro_torch.runtime.monitor import FailureInjector
from repro_torch.serve import Request, ServeConfig, SolverService

#: the reference's device-loss stream (its test's), each result's x kept
_ORACLE = r"""
import json, os, sys
sys.path.insert(0, "src")
import jax
from jax._src.interpreters import batching as _batching
_proxy = type(jax.interpreters.batching.primitive_batchers)
if "__contains__" not in vars(_proxy) and _proxy is not dict:
    _proxy.__contains__ = lambda self, p: p in _batching.fancy_primitive_batchers
import numpy as np
from repro.core.problems import enable_f64
from repro.core.compat import make_mesh
from repro.resilience import ChaosInjector, ChaosPlan
from repro.serve import Request, ServeConfig, SolverService
enable_f64()
mesh = make_mesh((8,), ("cells",))
rng = np.random.default_rng(0)
inj = ChaosInjector(ChaosPlan(seed=0, device_loss_at=(0,), lose_devices=(6, 7)))
svc = SolverService(ServeConfig(max_batch=2, guards=True, mesh=mesh), injector=inj)
rids = [svc.submit(Request(b=rng.standard_normal((8, 8, 8)), method="cg", maxiter=200))
        for _ in range(4)]
svc.run_until_drained()
svc.close()
res = svc.results()
np.savez(os.environ["ORACLE_NPZ"], **{str(i): np.asarray(res[i].x) for i in rids})
print(json.dumps({str(i): dict(iters=res[i].iters, status=res[i].status) for i in rids}))
"""

GRID = (8, 8, 8)
N_REQ = 4


def requests(seed: int = 0) -> list[Request]:
    rng = np.random.default_rng(seed)
    return [Request(b=rng.standard_normal(GRID), method="cg", maxiter=200)
            for _ in range(N_REQ)]


class _HardDeath(RuntimeError):
    """Not a SimulatedFailure: the service does not catch it, and the
    dispatch dies with its journal entry on disk."""


class _KillInjector(FailureInjector):
    def maybe_fail(self, step):
        if step == self.fail_at_step and not self.fired:
            self.fired = True
            raise _HardDeath(f"process died at dispatch {step}")


def _served(svc) -> dict:
    return {i: dict(x=r.x, iters=r.iters, status=r.status, requeues=r.requeues)
            for i, r in svc.results().items()}


def elastic8(rank: int, world: int) -> dict:
    """World 8: the shrink, the device-loss stream, the resharded restore
    and the cold recovery onto another rank count (see the module)."""
    out = {}
    tmp = os.environ["REPRO_TORCH_ELASTIC_DIR"]
    mesh = Mesh((8,), ("cells",))
    small = elastic.shrink_mesh(mesh, lost=(6, 7), divides=8)
    out["shrunk_to"] = None if small is None else small.size
    out["axis_kept"] = None if small is None else small.axis_names == ("cells",)
    try:
        elastic.shrink_mesh(Mesh((4, 2), ("data", "model")), lost=())
        out["multiaxis_raises"] = False
    except ValueError:
        out["multiaxis_raises"] = True
    # the device-loss stream, served SPMD
    inj = ChaosInjector(ChaosPlan(seed=0, device_loss_at=(0,), lose_devices=(6, 7)))
    svc = SolverService(ServeConfig(max_batch=2, guards=True, mesh=mesh, device="cpu",
                                    recovery_dir=os.path.join(tmp, "wal_loss")),
                        injector=inj)
    rids = [svc.submit(r) for r in requests()]
    svc.run_until_drained()
    svc.close()
    snap = svc.snapshot()
    out["loss"] = dict(rids=rids, served=_served(svc), device_losses=snap["device_losses"],
                       rejected=snap["service_rejects"],
                       mesh_after=None if svc.mesh is None else svc.mesh.size,
                       events=[e["attrs"] for e in svc.metrics.events()
                               if e["name"] == "serve.device_loss"])
    dist.barrier()
    # a checkpoint of global arrays saved by 4 ranks, restored onto 2
    four_group, two_group = dist.new_group([0, 1, 2, 3]), dist.new_group([0, 1])
    four = Mesh((4,), ("cells",), group=four_group) if rank < 4 else None
    glob = np.arange(2 * 4 * 4 * 8, dtype=np.float64).reshape(2, 4, 4, 8)
    ck = os.path.join(tmp, "ckpt")
    if rank == 0:
        ckpt.save({"lanes": glob, "step": np.int64(3)}, ck, step=0)
    dist.barrier()
    if rank < 4:
        got4, _ = ckpt.restore({"lanes": glob * 0, "step": np.int64(0)}, ck,
                               shardings={"lanes": (four, None)})
        out["on4"] = dict(block=got4["lanes"], step=int(got4["step"]),
                          want=elastic.reshard_array(glob, four))
    if rank < 2:
        two = Mesh((2,), ("cells",), group=two_group)
        got2, _ = ckpt.restore({"lanes": torch.zeros(glob.shape, dtype=torch.float64),
                                "step": np.int64(0)}, ck,
                               shardings=({"lanes": (two, make_layout(two)), "step": None}))
        out["on2"] = dict(block=got2["lanes"], want=torch.as_tensor(
            glob[..., rank * 4:(rank + 1) * 4]))
    dist.barrier()
    # a journal orphaned on 8 ranks, recovered cold on 4, against a clean
    # service on the same 4
    wal = os.path.join(tmp, "wal_cold")
    dying = SolverService(ServeConfig(max_batch=4, mesh=mesh, device="cpu", recovery_dir=wal),
                          injector=_KillInjector(fail_at_step=0))
    for r in requests(11):
        dying.submit(r)
    try:
        dying.run_until_drained()
        out["died"] = False
    except _HardDeath:
        out["died"] = True
    dying.close()
    dist.barrier()
    out["orphaned"] = sorted(f for f in os.listdir(wal) if f.startswith("wal_"))
    dist.barrier()
    if rank < 4:
        fresh = SolverService(ServeConfig(max_batch=4, mesh=four, device="cpu",
                                          recovery_dir=wal))
        remap = fresh.recover()
        fresh.run_until_drained()
        clean = SolverService(ServeConfig(max_batch=4, mesh=four, device="cpu"))
        for r in requests(11):
            clean.submit(r)
        clean.run_until_drained()
        out["cold"] = dict(remap=remap, served=_served(fresh), clean=_served(clean),
                           left=sorted(os.listdir(wal)))
    dist.barrier()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    os.environ["REPRO_TORCH_ELASTIC_DIR"] = str(tmp_path_factory.mktemp("elastic8"))
    return spawn(8, "elastic8", tmp_path_factory.mktemp("spawn8"), timeout=300)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    from conftest import run_multidevice          # JAX: the test process only
    npz = str(tmp_path_factory.mktemp("oracle") / "x.npz")
    out = run_multidevice(_ORACLE, devices=8, timeout=180,
                          env={"ORACLE_NPZ": npz, "JAX_PLATFORMS": "cpu"})
    xs = np.load(npz)
    return {int(i): dict(rec, x=xs[i]) for i, rec in out.items()}


def test_shrink_mesh(ranks):
    """8 ranks, 6 and 7 lost, trimmed to the 4 that divide 8: ranks 0–3
    get a ``cells`` mesh of 4, the others none; a multi-axis mesh raises."""
    for r, rec in enumerate(ranks):
        assert rec["shrunk_to"] == (4 if r < 4 else None), r
        assert rec["axis_kept"] is (True if r < 4 else None)
        assert rec["multiaxis_raises"]


def test_device_loss_shrinks_mesh_and_resumes(ranks, oracle):
    """Losing 2 of 8 ranks mid-dispatch: the mesh shrinks to 4, every
    request completes converged with no reject and one device loss (4
    survivors recorded), and each result's ``x`` within 1e-9 of the
    reference's on its shrunk mesh, its iterations equal; the ranks left
    out stop serving."""
    for r, rec in enumerate(ranks):
        loss = rec["loss"]
        assert loss["device_losses"] == 1 and loss["rejected"] == 0, r
        assert loss["events"] == [{"lost": 2, "survivors": 4}], r
        if r >= 4:
            assert loss["mesh_after"] is None and not loss["served"], r
            continue
        assert loss["mesh_after"] == 4
        assert sorted(loss["served"]) == loss["rids"]
        for i in loss["rids"]:
            got, ref = loss["served"][i], oracle[i]
            assert got["status"] == "converged" == ref["status"]
            assert got["iters"] == ref["iters"], (i, got["iters"], ref["iters"])
            assert got["x"].shape == GRID
            assert float(np.abs(got["x"] - ref["x"]).max()) < 1e-9
            assert got["x"].tobytes() == ranks[0]["loss"]["served"][i]["x"].tobytes()


def test_restore_reshards_onto_fewer_ranks(ranks):
    """``restore(shardings=)`` of global lanes saved once: onto 4 ranks
    each its block (as ``reshard_array`` places it), onto 2 each its half
    of z, into the template's dtype and device; an unplaced leaf as saved."""
    for r, rec in enumerate(ranks):
        if r < 4:
            assert torch.equal(rec["on4"]["block"], rec["on4"]["want"])
            assert tuple(rec["on4"]["block"].shape) == (2, 4, 4, 2)
            assert rec["on4"]["step"] == 3
        if r < 2:
            assert torch.equal(rec["on2"]["block"], rec["on2"]["want"])


def test_wal_cold_recovery_onto_another_mesh(ranks):
    """A service on 8 ranks dies at its first dispatch with the journal on
    disk; a service on 4 ranks recovers it cold: every request re-admitted
    once and served bitwise as a clean service on the same 4 ranks, the
    journal empty after."""
    for r, rec in enumerate(ranks):
        assert rec["died"] and len(rec["orphaned"]) == 1
        if r >= 4:
            continue
        cold = rec["cold"]
        assert len(cold["remap"]) == N_REQ and not cold["left"]
        assert sorted(cold["served"]) == sorted(cold["remap"].values())
        for old, new in cold["remap"].items():
            got, want = cold["served"][new], cold["clean"][old]
            assert got["x"].tobytes() == want["x"].tobytes() and got["iters"] == want["iters"]
            assert got["requeues"] >= 1 and got["status"] == "converged"
