"""The port's kernel autotuner on the CPU (counterpart of
``tests/test_autotune.py``): the default table, the cache round trip and its
key, a corrupt cache, ``tune`` and ``--retune``, the session's
``kernels=None`` and ``KernelOp``'s tiles, the CLI; the launch-geometry
arguments the kernel wrappers check; and ``kernels=None`` sessions against
the reference's ``SolverSession`` with ``pallas`` set to the route the cache
resolves.  Every test reads and writes a ``tmp_path`` cache through
``REPRO_TORCH_AUTOTUNE_CACHE``."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import x64  # noqa: F401  (fixture)
from test_torch_harness import ref_api, seeded, to_np

from repro_torch.api import SolverOptions, SolverSession
from repro_torch.core.operators import STENCILS
from repro_torch.core.problems import make_problem
from repro_torch.core.solvers import LocalOp
from repro_torch.kernels import autotune, ops
from repro_torch.kernels.autotune import (DEFAULT_RUN, MIN_KERNEL_VOLUME, RUN_CANDIDATES,
                                          TuneDecision,
                                          default_decision, resolve, save_cache, tune_key)
from repro_torch.kernels.kernel_op import KernelOp
from repro_torch.obs import trace as obs

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def cache(tmp_path, monkeypatch):
    """An isolated cache file, for every test: none reads or writes ~/.cache."""
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    autotune._CACHE = None
    yield path
    autotune._CACHE = None


def _entry(use_kernels=True, run=DEFAULT_RUN):
    return {"use_kernels": use_kernels, "run": run}


# -----------------------------------------------------------------------------
# the default table
# -----------------------------------------------------------------------------

def test_default_table_small_grid_routes_to_the_plain_versions():
    """Below MIN_KERNEL_VOLUME the card runs the plain versions; the CPU
    never takes the kernels (it has none)."""
    below, at = (1, 1, MIN_KERNEL_VOLUME - 1), (1, 1, MIN_KERNEL_VOLUME)
    assert default_decision(below, "cuda") == TuneDecision(use_kernels=False)
    assert default_decision(at, "cuda") == TuneDecision(use_kernels=True)
    assert MIN_KERNEL_VOLUME <= 128 ** 3


def test_default_table_large_grid_uses_the_kernels_on_cuda_only():
    assert default_decision((64, 64, 64), "cuda").use_kernels
    assert not default_decision((64, 64, 64), "cpu").use_kernels
    dec = default_decision((64, 64, 64), "cuda")
    assert (dec.run, dec.source) == (DEFAULT_RUN, "default")
    assert DEFAULT_RUN in RUN_CANDIDATES


def test_resolve_without_cache_is_the_default_table(cache):
    dec = resolve("7pt", (64, 64, 64), torch.float64, "cpu")
    assert dec.source == "default"
    assert dec == default_decision((64, 64, 64), "cpu")


# -----------------------------------------------------------------------------
# the cache round trip
# -----------------------------------------------------------------------------

def test_cache_round_trip(cache):
    """A persisted entry wins over the default table, with identical choices
    after a write -> resolve cycle."""
    key = tune_key("7pt", (16, 16, 16), torch.float32, "cpu")
    assert key == "7pt|16x16x16|float32|cpu"
    save_cache({key: _entry(run=32)})
    dec = resolve("7pt", (16, 16, 16), torch.float32, "cpu")
    assert dec == TuneDecision(use_kernels=True, run=32, source="cache")
    assert resolve("7pt", (16, 16, 16), torch.float32, "cpu") == dec   # memoised read
    assert json.loads(cache.read_text())[key]["run"] == 32


def test_cache_key_pins_all_four_coordinates(cache):
    assert tune_key("27pt", (128, 128, 128), torch.float64, H100) == \
        f"27pt|128x128x128|float64|{H100}"
    key = tune_key("7pt", (16, 16, 16), torch.float32, "cpu")
    save_cache({key: _entry(run=8),
                tune_key("7pt", (16, 16, 16), torch.float64, H100): _entry(run=32)})
    hit = resolve("7pt", (16, 16, 16), torch.float32, "cpu")
    assert (hit.source, hit.run) == ("cache", 8)
    # another stencil, grid, dtype or device kind misses to the default table
    assert resolve("27pt", (16, 16, 16), torch.float32, "cpu").source == "default"
    assert resolve("7pt", (16, 16, 32), torch.float32, "cpu").source == "default"
    assert resolve("7pt", (16, 16, 16), torch.float64, "cpu").source == "default"
    assert autotune.device_kind("cpu") == "cpu"


def test_corrupt_cache_degrades_to_default(cache):
    cache.write_text("{not json")
    assert resolve("7pt", (16, 16, 16), torch.float32, "cpu").source == "default"
    cache.write_text("[1, 2]")
    assert resolve("7pt", (16, 16, 16), torch.float32, "cpu").source == "default"


def test_tune_is_idempotent_and_retune_remeasures(cache):
    """``tune`` sweeps once, then serves the cache; ``retune`` re-measures.
    On the CPU the sweep times the plain version only (4³ keeps it short)."""
    d1 = autotune.tune((4, 4, 4), "7pt", torch.float32, "cpu", repeats=1)
    assert d1 == TuneDecision(use_kernels=False, source="cache")
    entry = json.loads(cache.read_text())[tune_key("7pt", (4, 4, 4), torch.float32, "cpu")]
    assert entry["backend"] == "cpu" and entry["timings"]["plain_s"] > 0
    assert entry["timings"]["kernel_s"] is None and entry["timings"]["run"] == {}
    mtime = cache.stat().st_mtime_ns
    assert autotune.tune((4, 4, 4), "7pt", torch.float32, "cpu", repeats=1) == d1
    assert cache.stat().st_mtime_ns == mtime          # no re-sweep
    autotune.tune((4, 4, 4), "7pt", torch.float32, "cpu", repeats=1, retune=True)
    assert cache.stat().st_mtime_ns >= mtime          # rewritten


# -----------------------------------------------------------------------------
# the consumers: kernels=None and KernelOp's tiles
# -----------------------------------------------------------------------------

def test_session_resolves_kernels_none_from_the_cache(cache, tmp_path):
    prob = make_problem((8, 8, 8), "7pt", device="cpu")
    key = tune_key("7pt", (8, 8, 8), torch.float64, "cpu")
    opts = SolverOptions(maxiter=5, kernels=None)
    trace = str(tmp_path / "trace.jsonl")
    obs.enable(trace)
    try:
        # on the CPU the default table would say False; the cache says True
        save_cache({key: _entry()})
        assert SolverSession(prob, method="cg", options=opts).options.kernels is True
        # and without the entry, None resolves through the default table
        save_cache({})
        assert SolverSession(prob, method="cg", options=opts).options.kernels is False
        # a pinned bool reads no routing from the cache
        save_cache({key: _entry(use_kernels=False)})
        assert SolverSession(prob, method="cg",
                             options=SolverOptions(kernels=True)).options.kernels is True
    finally:
        obs.disable()
    spans = [r["attrs"] for r in obs.read_trace(trace) if r["name"] == "resolve"]
    assert [a.get("tune_source") for a in spans] == ["cache", "default", None]


def test_kernel_op_takes_the_tuned_run(cache):
    """``KernelOp`` marches the run its caller read from the cache (or the
    default, reading no file), and every run gives the same matvec and fused
    hooks on the CPU."""
    st = STENCILS["7pt"]
    save_cache({tune_key("7pt", (8, 8, 8), torch.float64, "cpu"): _entry(run=8)})
    x = torch.as_tensor(seeded((8, 8, 8), 0))
    op = KernelOp(LocalOp(st), run=resolve("7pt", x.shape, x.dtype, x.device).run)
    assert op._run(x) == 8
    assert KernelOp(LocalOp(st))._run(x) == DEFAULT_RUN
    pinned = KernelOp(LocalOp(st), run=16)
    assert pinned._run(x) == 16
    # another shape misses to the default table
    assert resolve("7pt", (8, 8, 4), x.dtype, x.device).run == DEFAULT_RUN
    assert torch.equal(op.matvec(x), pinned.matvec(x))
    for a, b in zip(op.spmv_dots(x), pinned.spmv_dots(x)):
        assert torch.equal(a, b)
    vecs = [torch.as_tensor(seeded((8, 8, 8), s)) for s in range(1, 5)]
    for a, b in zip(op.cg_body(0.5, 0.1, x, *vecs), pinned.cg_body(0.5, 0.1, x, *vecs)):
        assert torch.equal(a, b)
    # a batch of lanes marches the default run, whatever the tuned one
    lanes = torch.stack([x, 2 * x])
    assert torch.equal(op.matvec(lanes)[1], pinned.matvec(2 * x))


def test_session_tiles_are_fixed_when_it_is_built(cache):
    """A cache file rewritten after a session was built (and its graphs
    captured) changes nothing in that session."""
    key = tune_key("27pt", (8, 8, 8), torch.float64, "cpu")
    save_cache({key: _entry(run=8)})
    sess = SolverSession(method="cg_merged", grid=(8, 8, 8), device="cpu",
                         options=SolverOptions(kernels=True))
    first = sess.solve()
    save_cache({key: _entry(run=32)})
    assert sess._operator().run == 8
    again = sess.solve()
    assert again.iters == first.iters and torch.equal(again.x, first.x)
    fresh = SolverSession(method="cg_merged", grid=(8, 8, 8), device="cpu",
                          options=SolverOptions(kernels=True))
    assert fresh._operator().run == 32


def test_cli_writes_both_smoke_configs(cache, capsys):
    assert autotune.main(["--smoke", "--device", "cpu", "--repeats", "1"]) == 0
    table = json.loads(cache.read_text())
    for grid, stencil in autotune.SMOKE_CONFIGS:
        entry = table[tune_key(stencil, grid, torch.float32, "cpu")]
        assert set(entry) >= {"use_kernels", "run", "backend", "timings"}
    out = capsys.readouterr().out
    assert "use_kernels=False" in out and str(cache) in out


def test_cli_one_grid(cache, capsys):
    autotune.main(["--grid", "4", "4", "4", "--device", "cpu", "--repeats", "1",
                   "--dtype", "float64", "--stencil", "27pt"])
    assert tune_key("27pt", (4, 4, 4), torch.float64, "cpu") in json.loads(cache.read_text())
    assert "27pt|4x4x4|float64|cpu: use_kernels=False run=16" in capsys.readouterr().out


# -----------------------------------------------------------------------------
# the wrappers check the launch geometry on every device
# -----------------------------------------------------------------------------

def test_wrappers_refuse_unknown_runs():
    st = STENCILS["27pt"]
    x = torch.as_tensor(seeded((6, 5, 7), 1))
    for bad in (4, 12, 64, True, 16.0):
        with pytest.raises(ValueError, match="run must be one of"):
            ops.spmv(x, st, zero_halo=True, run=bad)
        with pytest.raises(ValueError, match="run must be one of"):
            ops.spmv_dots(x, st, zero_halo=True, run=bad)
        with pytest.raises(ValueError, match="run must be one of"):
            ops.spmv_dots3(x, x, st, zero_halo=True, run=bad)
        with pytest.raises(ValueError, match="run must be one of"):
            ops.spmv_dot(x, st, zero_halo=True, run=bad)
    with pytest.raises(ValueError, match="run must be one of"):
        ops.spmv(torch.stack([x, x]), st, zero_halo=True, run=8)   # lanes: 16 only


@pytest.mark.parametrize("run", RUN_CANDIDATES)
def test_every_run_is_the_plain_version_on_the_cpu(run):
    st = STENCILS["27pt"]
    x = torch.as_tensor(seeded((6, 5, 7), 2))
    r = torch.as_tensor(seeded((6, 5, 7), 3))
    for got, want in ((ops.spmv(x, st, zero_halo=True, run=run),
                       ops.spmv(x, st, zero_halo=True)),
                      (ops.spmv_dots(x, st, zero_halo=True, run=run),
                       ops.spmv_dots(x, st, zero_halo=True)),
                      (ops.spmv_dots3(x, r, st, zero_halo=True, run=run),
                       ops.spmv_dots3(x, r, st, zero_halo=True))):
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(a, b)


# -----------------------------------------------------------------------------
# kernels=None against the reference, for each route the cache resolves
# -----------------------------------------------------------------------------

PARITY = (("cg", "none"), ("cg_merged", "none"), ("pcg_merged", "chebyshev"))
GRID = (10, 7, 13)


@pytest.mark.parametrize("route", [False, True])
@pytest.mark.parametrize("stencil", ["27pt", "7pt"])
@pytest.mark.parametrize("method, precond", PARITY)
def test_kernels_none_matches_the_reference(x64, cache, method, precond, stencil, route):
    save_cache({tune_key(stencil, GRID, torch.float64, "cpu"): _entry(use_kernels=route)})
    sess = SolverSession(method=method, grid=GRID, stencil=stencil, device="cpu",
                         options=SolverOptions(kernels=None, precond=precond, tol=1e-8,
                                               maxiter=300))
    assert sess.options.kernels is route
    b = seeded(GRID, 11)
    got = sess.solve(b=torch.as_tensor(b))
    api = ref_api()
    want = api.SolverSession(
        method=method, grid=GRID, stencil=stencil,
        options=api.SolverOptions(pallas=route, precond=precond, tol=1e-8, maxiter=300)
    ).solve(b=jnp.asarray(b))
    assert got.iters == int(want.iters) and got.status == int(want.status)
    np.testing.assert_allclose(to_np(got.x), to_np(want.x), rtol=0, atol=1e-12)
