"""The port's facade on the CPU: CLI parity with the reference, options that
are not ported yet, device rules, the registry, the config cells, ``x0``
donation, and the package rule that nothing of the port imports JAX or the
reference."""

import json
import re
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_harness import x64  # noqa: F401  (fixture)
from test_torch_harness import ref_api, ref_module, seeded, to_np

from repro_torch.api import (REGISTRY, RegistryConsistencyError, SolverOptions,
                             SolverSession, check_consistent_with_core,
                             fused_solver_names, get_solver, solve, solver_names)
from repro_torch.core import solvers as tsolvers
from repro_torch.core.methods import METHODS, MethodDef, status_name
from repro_torch.core.problems import from_reference, make_problem
from repro_torch.configs.hpcg import SOLVER_CONFIGS
from repro_torch.launch import solve as tlaunch

REPO = Path(__file__).resolve().parents[1]
PORTED = ["bicgstab", "bicgstab_b1", "bicgstab_merged", "cg", "cg_merged", "cg_nb",
          "cg_pipe", "gauss_seidel", "gauss_seidel_rb", "jacobi", "pbicgstab",
          "pbicgstab_merged", "pcg", "pcg_merged", "pcg_pipe"]


@pytest.mark.parametrize("flags", [
    ["--method", "cg", "--stencil", "7pt"],
    ["--method", "cg_merged", "--stencil", "27pt", "--tol", "1e-8"],
    ["--config", "hpcg-gauss_seidel-7pt", "--maxiter", "50"],
    ["--config", "hpcg-pcg-chebyshev-27pt"],
    ["--method", "pbicgstab", "--stencil", "7pt", "--precond", "block_jacobi"],
    ["--method", "pcg_merged", "--precond", "ssor"],
    ["--method", "cg_pipe", "--stencil", "7pt"],
    ["--method", "pcg_pipe", "--precond", "chebyshev"],
    ["--method", "pcg_pipe", "--stencil", "7pt", "--precond", "block_jacobi"],
    ["--method", "bicgstab_merged", "--stencil", "7pt"],
    ["--method", "pbicgstab_merged", "--precond", "chebyshev"],
])
def test_cli_matches_reference(x64, capsys, flags):
    grid = ["--grid", "12", "12", "12"]
    ref = ref_module("launch.solve").main(flags + grid + ["--json"])
    out = tlaunch.main(flags + grid + ["--device", "cpu", "--json"])
    assert out["iters"] == ref["iters"] and out["method"] == ref["method"]
    assert out["err"] < 1e-6
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["iters"] == out["iters"] and record["backend"].startswith("local")


def test_cli_kernels_flag_routes_fused_body(capsys):
    from repro_torch.kernels import ops
    ops.reset_launches()
    out = tlaunch.main(["--method", "cg_merged", "--grid", "8", "8", "8",
                        "--kernels", "--device", "cpu"])
    assert out["iters"] > 0 and "[kernels]" in capsys.readouterr().out
    assert all(v == 0 for v in ops.LAUNCHES.values())   # CPU: plain versions


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        solve(method="cg", grid=(4, 4, 4))
    with pytest.raises(RuntimeError):
        SolverSession(method="cg_merged", grid=(4, 4, 4),
                      options=SolverOptions(kernels=True))
    with pytest.raises(RuntimeError):
        make_problem((4, 4, 4), "7pt")
    with pytest.raises(RuntimeError):
        tlaunch.main(["--grid", "4", "4", "4"])


@pytest.mark.parametrize("kw, item", [
    # preconditioners are ported: their params are validated as the
    # reference validates them (ValueError, not NotImplementedError)
    (dict(precond_params={"sweeps": 2}), "precond_params"),
    # item 8 is ported: an unknown policy is a ValueError, as in the reference
    (dict(on_breakdown="retry"), "on_breakdown"),
])
def test_unported_options_raise(kw, item):
    exc = NotImplementedError if item.startswith("item") else ValueError
    with pytest.raises(exc, match=item):
        SolverOptions(**kw)


@pytest.mark.parametrize("kw, kind, describe", [
    # item 10 is ported: the mesh layouts, halo_mode and dims_map are
    # accepted and resolved as the reference resolves them (here on one
    # process, so every mesh has one rank and no process group)
    (dict(layout="2d"), "shard_map", "shard_map(data=1,model=1; no group, cpu)"),
    (dict(halo_mode="overlap"), "local", "local(1 device, cpu)"),
    (dict(dims_map={"x": "cells"}), "local", "local(1 device, cpu)"),
    (dict(layout="1d"), "shard_map", "shard_map(cells=1; no group, cpu)"),
    (dict(layout="3d"), "ValueError", ">= 8 devices"),
    (dict(layout="1d", dims_map={"x": "cells"}), "shard_map",
     "shard_map(cells=1; no group, cpu)"),
])
def test_mesh_options_accepted_and_resolved(kw, kind, describe):
    from repro_torch.api.backend import resolve_backend, resolve_halo_mode
    opts = SolverOptions(**kw)
    assert resolve_halo_mode(opts) == kw.get("halo_mode", "overlap")
    if kind == "ValueError":
        with pytest.raises(ValueError, match=describe):
            resolve_backend(opts, device="cpu")
        return
    be = resolve_backend(opts, device="cpu")
    assert (be.kind, be.describe()) == (kind, describe)
    if "dims_map" in kw and be.layout is not None:
        assert be.layout.dim_axes == ("cells", None, None)
    sess = SolverSession(method="cg", grid=(4, 4, 6), device="cpu", options=opts)
    assert sess.backend.kind == kind and int(sess.solve().status) == 0


def test_option_and_session_validation():
    with pytest.raises(ValueError):
        SolverOptions(layout="ring")
    with pytest.raises(ValueError):
        SolverOptions(maxiter=-1)
    prob = make_problem((4, 4, 4), "7pt", dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError):
        SolverSession(prob, method="cg")                 # f64 default vs f32
    with pytest.raises(ValueError):
        SolverSession(prob, method="cg", options=SolverOptions(f64=False),
                      device="meta")
    with pytest.raises(ValueError):
        SolverSession(method="cg")                       # no problem, no grid
    with pytest.raises(KeyError):
        get_solver("no_such_method")                     # unknown name
    sess = SolverSession(prob, method="cg", options=SolverOptions(f64=False))
    assert sess.device == torch.device("cpu") and "cg/7pt" in sess.describe()
    with pytest.raises(ValueError):
        sess.solve(b=torch.zeros((4, 4, 5)))


def test_session_solve_takes_explicit_inputs():
    sess = SolverSession(method="cg_merged", grid=(6, 6, 6), stencil="7pt",
                         device="cpu", options=SolverOptions(kernels=True))
    res = sess.solve()
    again = sess.solve(b=sess.problem.b(), x0=torch.zeros((6, 6, 6),
                                                          dtype=torch.float64))
    assert res.iters == again.iters and status_name(res.status) == "converged"
    assert torch.equal(res.x, again.x)
    assert res.telemetry is None and res.history.shape == (601,)
    _, stats = sess.timed_solve(repeats=2)
    assert stats["median"] > 0


def test_registry_mirrors_reference_for_ported_methods(x64):
    jreg = ref_module("api.registry")
    assert solver_names() == PORTED == sorted(tsolvers.SOLVERS)
    assert fused_solver_names() == ["bicgstab_merged", "cg_merged", "cg_pipe",
                                    "pbicgstab_merged", "pcg_merged", "pcg_pipe"]
    for name in PORTED:
        s, r = get_solver(name), jreg.get_solver(name)
        for field in ("reduction_hides", "spmvs_per_iter", "halo_hides",
                      "variant_of", "spd_required", "stationary", "reduce_hide",
                      "fused_kernels", "allreduces_per_iter",
                      "halo_exchanges_per_iter", "blocking_reductions",
                      "accepts_precond", "precond_applies_per_iter"):
            assert getattr(s, field) == getattr(r, field), (name, field)
        m, jm = METHODS[name], s.method_def
        assert m is jm
        rm = r.method_def
        assert (m.vectors, m.scalars, m.res_scalar, m.params, m.default_maxiter,
                m.has_fused_body, m.has_refresh) == \
            (rm.vectors, rm.scalars, rm.res_scalar, rm.params, rm.default_maxiter,
             rm.has_fused_body, rm.has_refresh)
    assert tsolvers.VARIANT_OF == {n: v for n, v in
                                   ref_module("core.solvers").VARIANT_OF.items()
                                   if n in PORTED}


def test_method_set_equals_the_reference(x64):
    """Every method of the reference is ported: the same ``SOLVERS`` keys and
    the same ``VARIANT_OF`` map."""
    jsolvers = ref_module("core.solvers")
    assert set(tsolvers.SOLVERS) == set(jsolvers.SOLVERS)
    assert tsolvers.VARIANT_OF == dict(jsolvers.VARIANT_OF)


def test_registry_consistency_check_raises_on_drift():
    check_consistent_with_core()
    with pytest.raises(RegistryConsistencyError):
        check_consistent_with_core(registry={k: v for k, v in REGISTRY.items()
                                             if k != "cg"})
    with pytest.raises(ValueError):
        MethodDef(name="x", vectors=("x",), scalars=("rr",), res_scalar="r",
                  init=None, step=None)


def test_config_cells_build_sessions(x64):
    """The port has the reference's cells, the eight preconditioned PCG
    cells included, and each builds a session."""
    jcfg = ref_module("configs.hpcg").SOLVER_CONFIGS
    assert set(SOLVER_CONFIGS) == set(jcfg)
    assert set(c.method for c in SOLVER_CONFIGS.values()) <= set(PORTED)
    for name, cfg in SOLVER_CONFIGS.items():
        assert (cfg.method, cfg.stencil, cfg.precond, cfg.local_grid, cfg.tol,
                cfg.maxiter) == (jcfg[name].method, jcfg[name].stencil,
                                 jcfg[name].precond, jcfg[name].local_grid,
                                 jcfg[name].tol, jcfg[name].maxiter)
    sess = SOLVER_CONFIGS["hpcg-cg-27pt"].session(grid=(4, 4, 4), device="cpu")
    assert sess.method == "cg" and sess.problem.shape == (4, 4, 4)
    pre = [c for c in SOLVER_CONFIGS.values() if c.precond != "none"]
    assert len(pre) == 8
    for cfg in pre:
        sess = cfg.session(grid=(4, 4, 4), device="cpu", kernels=True)
        assert sess.method == "pcg" and sess.precond.name == cfg.precond
        assert f"precond={sess.precond.describe()}" in sess.describe()


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\.|import\s+repro\s*$|"
    r"import\s+repro\s*,|from\s+repro\.|from\s+repro\s+import)", re.MULTILINE)


def test_port_imports_no_jax_and_nothing_of_the_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    offenders = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
                 for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert offenders == []
    assert _FORBIDDEN.search("from repro.core import x\n")
    assert _FORBIDDEN.search("import jax.numpy as jnp\n")
    assert not _FORBIDDEN.search("from repro_torch.core import x\n")


# -----------------------------------------------------------------------------
# x0 donation (the reference's tests/test_reduction_hiding.py:236-290): a
# cached solve writes its iterate into the caller's x0 and returns it
# -----------------------------------------------------------------------------

def _donating(method, kernels, donate=True, grid=(6, 5, 7), **kw):
    return SolverSession(method=method, grid=grid, stencil="27pt", device="cpu",
                         options=SolverOptions(kernels=kernels, donate=donate, tol=1e-8,
                                               maxiter=300, **kw))


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equal, NaN where the other is (the history's padding)."""
    return torch.allclose(a, b, rtol=0, atol=0, equal_nan=True)


def _equal(a, b) -> bool:
    return (a.iters == b.iters and a.status == b.status and torch.equal(a.x, b.x)
            and _same_bits(a.history, b.history))


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("method", ["cg", "cg_merged", "bicgstab"])
def test_donated_solve_is_bitwise_the_undonated_one(method, kernels):
    x0 = torch.as_tensor(seeded((6, 5, 7), 3))
    kept = x0.clone()
    off = _donating(method, kernels, donate=False).solve(x0=x0)
    assert torch.equal(x0, kept)                      # donate=False: untouched
    on = _donating(method, kernels).solve(x0=x0)
    assert on.x is x0                                  # the caller's tensor ...
    assert on.x.untyped_storage().data_ptr() == x0.untyped_storage().data_ptr()
    assert _equal(on, off) and not torch.equal(x0, kept)   # ... holds the result


@pytest.mark.parametrize("kernels", [False, True])
def test_donated_batched_solve_is_bitwise_the_undonated_one(kernels):
    sess = _donating("cg", kernels)
    bs = torch.stack([torch.as_tensor(seeded((6, 5, 7), s)) for s in (1, 2)])
    x0s = torch.as_tensor(seeded((2, 6, 5, 7), 4))
    kept = x0s.clone()
    off = _donating("cg", kernels, donate=False).solve_batched(bs, x0s)
    assert torch.equal(x0s, kept)
    on = sess.solve_batched(bs, x0s)
    assert on.x is x0s and torch.equal(on.x, off.x)
    assert torch.equal(on.iters, off.iters) and torch.equal(on.status, off.status)
    assert _same_bits(on.history, off.history)


def test_donation_never_writes_the_problems_own_x0():
    x0 = seeded((6, 5, 7), 5)
    prob = from_reference("27pt", (6, 5, 7), torch.float64, x0=x0, device="cpu")
    sess = SolverSession(prob, method="cg", options=SolverOptions(tol=1e-8))
    first = sess.solve()                                 # x0 not passed
    np.testing.assert_array_equal(prob.x0().numpy(), x0)
    assert first.x is not prob.x0()
    with pytest.warns(UserWarning, match="not donated"):
        again = sess.solve(x0=prob.x0())                 # the problem's own, passed
    np.testing.assert_array_equal(prob.x0().numpy(), x0)
    assert _equal(first, again)


def test_an_x0_that_cannot_take_the_result_is_copied_with_a_warning():
    sess = _donating("cg", False)
    want = sess.solve(x0=torch.zeros((6, 5, 7), dtype=torch.float64))
    strided = torch.zeros((7, 5, 6), dtype=torch.float64).transpose(0, 2)
    f32 = torch.zeros((6, 5, 7), dtype=torch.float32)
    for x0 in (strided, f32):
        kept = x0.clone()
        with pytest.warns(UserWarning, match="not donated"):
            got = sess.solve(x0=x0)
        assert torch.equal(x0, kept) and _equal(got, want)
    b = sess.problem.b().clone()
    with pytest.warns(UserWarning, match="not donated"):
        sess.solve(b=b, x0=b)                             # x0 in b's storage
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sess.solve(x0=np.zeros((6, 5, 7)))                 # nothing of the caller's
        sess.solve()


@pytest.mark.parametrize("kernels", [False, True])
def test_repeated_donating_solves_on_one_session(kernels):
    """The serving loop: back-to-back donating solves, each with a fresh x0
    or none, on one session's cached executable."""
    sess = _donating("bicgstab_merged", kernels)
    r1, r2 = sess.solve(), sess.solve()
    x0a, x0b = (torch.zeros((6, 5, 7), dtype=torch.float64) for _ in range(2))
    r3, r4 = sess.solve(x0=x0a), sess.solve(x0=x0b)
    assert r3.x is x0a and r4.x is x0b
    for r in (r2, r3, r4):
        assert _equal(r, r1)
    assert sess.cache_stats()[((6, 5, 7), "bicgstab_merged", "none")]["misses"] == 1


def test_timed_solve_does_not_donate():
    sess = _donating("cg", True)
    x0 = torch.as_tensor(seeded((6, 5, 7), 6))
    kept = x0.clone()
    res, stats = sess.timed_solve(x0=x0, repeats=2)
    assert torch.equal(x0, kept) and res.x is not x0 and stats["median"] > 0
    bs = x0[None].clone()
    x0s = x0[None].clone()
    sess.timed_solve_batched(bs, x0s, repeats=1)
    assert torch.equal(x0s[0], kept)


@pytest.mark.parametrize("kernels", [False, True])
def test_donated_batched_lanes_match_the_reference(x64, kernels):
    """Donation changes nothing the reference's ``solve_batched`` (donating
    too, its default) would see: each lane's iterations, status and x."""
    import jax.numpy as jnp
    sess = _donating("cg", kernels, grid=(10, 7, 13))
    bs = torch.stack([torch.as_tensor(seeded((10, 7, 13), s)) for s in (7, 8, 9)])
    x0s = torch.zeros_like(bs)
    got = sess.solve_batched(bs, x0s)
    assert got.x is x0s
    api = ref_api()
    want = api.SolverSession(
        method="cg", grid=(10, 7, 13), stencil="27pt",
        options=api.SolverOptions(pallas=kernels, tol=1e-8, maxiter=300)
    ).solve_batched(jnp.asarray(to_np(bs)))
    np.testing.assert_array_equal(to_np(got.iters), to_np(want.iters))
    np.testing.assert_array_equal(to_np(got.status), to_np(want.status))
    np.testing.assert_allclose(to_np(got.x), to_np(want.x), rtol=0, atol=1e-12)
