"""The slices as a whole: every ported method on the CPU against the reference.

For each method, on 7pt and 27pt at 12³ and 16³ in f64, the port's
``solve(..., device="cpu")`` and ``repro.api.solve`` solve the identical
system (the reference problem's ``b`` carried over with ``from_reference``)
and must agree: the same ``iters`` and ``status``, ``x`` within rtol 1e-10 and
atol 1e-12, and the residual history (and ``res_norm``) equal where finite,
within rtol 1e-10 plus 1e-13 of the initial residual (the sums run in another
order; see ``history_atol``), with NaN at the same places.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import x64  # noqa: F401  (fixture)
from test_torch_harness import (assert_history_equal, history_atol, ref_api,
                                ref_module, seeded, to_np)

from repro_torch.api import SolverOptions, solve
from repro_torch.core.problems import from_reference

METHODS = ["cg", "cg_nb", "bicgstab", "bicgstab_b1", "jacobi", "gauss_seidel",
           "gauss_seidel_rb", "cg_merged", "pcg", "pbicgstab", "pcg_merged"]
GRIDS = [(12, 12, 12), (16, 16, 16)]


def _carry(jprob, b=None):
    """The port's problem for the reference problem ``jprob``."""
    return from_reference(jprob.stencil.name, jprob.shape, np.dtype(jprob.dtype),
                          b=to_np(jprob.b()) if b is None else b,
                          x0=to_np(jprob.x0()), device="cpu")


def _assert_agree(res, ref):
    assert int(res.iters) == int(ref.iters)
    assert int(res.status) == int(ref.status)
    np.testing.assert_allclose(to_np(res.x), to_np(ref.x), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(res.res_norm), float(ref.res_norm),
                               rtol=1e-10, atol=history_atol(ref.history))
    assert_history_equal(res.history, ref.history)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: "x".join(map(str, g)))
@pytest.mark.parametrize("stencil", ["7pt", "27pt"])
@pytest.mark.parametrize("method", METHODS)
def test_solve_matches_reference(x64, method, stencil, grid):
    api = ref_api()
    jprob = ref_module("core.problems").make_problem(grid, stencil)
    ref = api.solve(jprob, method=method, options=api.SolverOptions())
    res = solve(_carry(jprob), method=method, options=SolverOptions())
    assert int(ref.status) == 0
    _assert_agree(res, ref)


@pytest.mark.parametrize("stencil", ["7pt", "27pt"])
def test_cg_merged_kernel_path_matches_pallas_path(x64, stencil):
    """``kernels=True`` (the fused body on the kernels' plain versions) against
    the reference's ``pallas=True`` (its fused Pallas body, interpret mode)."""
    api = ref_api()
    jprob = ref_module("core.problems").make_problem((16, 16, 16), stencil)
    ref = api.solve(jprob, method="cg_merged", options=api.SolverOptions(pallas=True))
    res = solve(_carry(jprob), method="cg_merged", options=SolverOptions(kernels=True))
    _assert_agree(res, ref)


@pytest.mark.parametrize("stencil", ["7pt", "27pt"])
def test_cg_merged_fused_entry_point_matches_reference(x64, stencil):
    """``kernels.fused_cg.cg_merged_fused`` against the reference's (Pallas
    fused body in interpret mode), relative criterion."""
    from repro_torch.core.operators import STENCILS
    from repro_torch.kernels.fused_cg import cg_merged_fused
    jprob = ref_module("core.problems").make_problem((12, 12, 12), stencil)
    jfused = ref_module("kernels.fused_cg").cg_merged_fused
    ref = jfused(jprob.stencil, jprob.b(), jprob.x0(), tol=1e-8, maxiter=200)
    prob = _carry(jprob)
    res = cg_merged_fused(STENCILS[stencil], prob.b(), prob.x0(), tol=1e-8,
                          maxiter=200)
    _assert_agree(res, ref)


@pytest.mark.parametrize("stencil", ["7pt", "27pt"])
def test_cg_merged_fused_matches_unfused(stencil):
    """As the reference pins it: the fused body and the unfused step give
    the same iteration count and iterates within 1e-12."""
    kw = dict(method="cg_merged", grid=(16, 16, 16), stencil=stencil, device="cpu")
    plain = solve(**kw, options=SolverOptions(tol=1e-8, maxiter=300))
    fused = solve(**kw, options=SolverOptions(tol=1e-8, maxiter=300, kernels=True))
    assert int(fused.iters) == int(plain.iters)
    np.testing.assert_allclose(to_np(fused.x), to_np(plain.x), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("method", ["cg", "cg_nb", "cg_merged", "bicgstab",
                                    "bicgstab_b1", "bicgstab_merged"])
def test_random_rhs_matches_reference(x64, method):
    """A seeded random right-hand side, relative criterion (norm_ref=None)."""
    api = ref_api()
    jprob = ref_module("core.problems").make_problem((12, 12, 12), "27pt")
    b = seeded(jprob.shape, 7)
    ref = api.solve(jprob, method=method, b=b,
                    options=api.SolverOptions(norm_ref=None, tol=1e-9))
    res = solve(_carry(jprob, b=b), method=method,
                options=SolverOptions(norm_ref=None, tol=1e-9))
    _assert_agree(res, ref)


@pytest.mark.parametrize("method, precond", [
    ("pcg", "chebyshev"), ("pcg", "ssor"), ("pbicgstab", "block_jacobi"),
    ("pbicgstab", "jacobi"), ("pcg_merged", "chebyshev"), ("cg_pipe", "none"),
    ("pcg_pipe", "chebyshev"), ("pcg_pipe", "ssor"), ("bicgstab_merged", "none"),
    ("pbicgstab_merged", "chebyshev"), ("pbicgstab_merged", "block_jacobi")])
def test_preconditioned_random_rhs_matches_reference(x64, method, precond):
    """A seeded random right-hand side through a preconditioned solve (and
    the unpreconditioned fused routes of cg_pipe and bicgstab_merged),
    relative criterion, on the
    kernel route (the kernels' plain versions)."""
    api = ref_api()
    jprob = ref_module("core.problems").make_problem((12, 10, 14), "27pt")
    b = seeded(jprob.shape, 8)
    ref = api.solve(jprob, method=method, b=b, options=api.SolverOptions(
        norm_ref=None, tol=1e-9, precond=precond, pallas=True))
    res = solve(_carry(jprob, b=b), method=method, options=SolverOptions(
        norm_ref=None, tol=1e-9, precond=precond, kernels=True))
    _assert_agree(res, ref)


def test_maxiter_status_matches_reference(x64):
    api = ref_api()
    jprob = ref_module("core.problems").make_problem((12, 12, 12), "27pt")
    ref = api.solve(jprob, method="jacobi", options=api.SolverOptions(maxiter=5))
    res = solve(_carry(jprob), method="jacobi", options=SolverOptions(maxiter=5))
    assert int(ref.status) == 1
    _assert_agree(res, ref)


def test_float32_solve_matches_reference(x64):
    api = ref_api()
    jprob = ref_module("core.problems").make_problem((12, 12, 12), "7pt",
                                                     dtype=jnp.float32)
    ref = api.solve(jprob, method="cg", options=api.SolverOptions(f64=False))
    res = solve(_carry(jprob), method="cg", options=SolverOptions(f64=False))
    assert res.x.dtype == torch.float32
    assert int(res.iters) == int(ref.iters) and int(res.status) == int(ref.status)
    np.testing.assert_allclose(to_np(res.x), to_np(ref.x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", ["pcg", "pcg_merged"])
def test_float32_preconditioned_solve_matches_reference(x64, method):
    api = ref_api()
    jprob = ref_module("core.problems").make_problem((12, 12, 12), "7pt",
                                                     dtype=jnp.float32)
    opts = dict(f64=False, precond="chebyshev")
    ref = api.solve(jprob, method=method, options=api.SolverOptions(**opts))
    res = solve(_carry(jprob), method=method, options=SolverOptions(**opts))
    assert res.x.dtype == torch.float32
    assert int(res.iters) == int(ref.iters) and int(res.status) == int(ref.status)
    np.testing.assert_allclose(to_np(res.x), to_np(ref.x), rtol=1e-5, atol=1e-5)
