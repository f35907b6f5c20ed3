"""The pipelined CGs (cg_pipe, pcg_pipe) and their kernels on the CPU against
the JAX reference.

Kernels: on CPU tensors ``ops.fused_dots``/``pipe_body``/``ppipe_body`` run
their plain PyTorch versions; the reference runs its Pallas kernels in
interpret mode (as ``tests/test_kernels.py`` does).  Both get the same numpy
inputs.  Vector outputs agree within rtol=atol=1e-12 in f64 (1e-5 in f32);
the partials within rtol 1e-11 (1e-4), because the two sum in different
orders.

Solves: as ``tests/test_torch_solvers.py``: the same iterations and status
as ``repro.api.solve``, ``x`` within rtol 1e-10 and atol 1e-12, residual
histories within ``assert_history_equal``; unfused (``kernels=False``
against ``pallas=False``) and fused (``kernels=True`` against
``pallas=True``), on 7pt/27pt at 12³ and 16³, pcg_pipe with each
preconditioner.  The fused-against-unfused and true-residual cases follow
``tests/test_reduction_hiding.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import x64  # noqa: F401  (fixture)
from test_torch_harness import (assert_history_equal, history_atol, ref_api,
                                ref_module, seeded, to_np)

from repro_torch.api import REGISTRY, SolverOptions, SolverSession, solve
from repro_torch.core.operators import STENCILS
from repro_torch.core.problems import from_reference, make_problem
from repro_torch.core.solvers import SOLVERS, LocalOp, cg_pipe, pcg_pipe
from repro_torch.kernels import ops
from repro_torch.kernels.kernel_op import KernelOp
from repro_torch.precond import make_precond

PRECONDS = ("none", "jacobi", "block_jacobi", "ssor", "chebyshev")
GRIDS = [(12, 12, 12), (16, 16, 16)]
#: 3-D shapes as the solvers pass them, ragged ones included, and one flat
KERNEL_SHAPES = [(12, 10, 16), (9, 7, 5), (5000,)]
DTYPES = [np.float64, np.float32]


def out_tols(dt):
    return dict(rtol=1e-12, atol=1e-12) if dt == np.float64 else dict(rtol=1e-5, atol=1e-5)


def partial_rtol(dt):
    return 1e-11 if dt == np.float64 else 1e-4


@pytest.fixture(scope="module")
def jops(x64):
    return ref_module("kernels.ops")


def _inputs(shape, seed, count, dt):
    vecs = [seeded(shape, seed + i, dt) for i in range(count)]
    return vecs, [torch.from_numpy(v) for v in vecs], [jnp.asarray(v) for v in vecs]


# -----------------------------------------------------------------------------
# (a) the plain versions against the Pallas kernels (interpret mode)
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", KERNEL_SHAPES, ids=str)
def test_fused_dots_matches_reference(jops, shape, dt):
    _, tv, jv = _inputs(shape, 60, 3, dt)
    got = ops.fused_dots(*tv)
    want = jops.fused_dots(*jv)
    assert len(got) == 3                       # slot order (a·b, c·b, a·a)
    for g, w in zip(got, want):
        assert g.dtype == tv[0].dtype and g.dim() == 0
        np.testing.assert_allclose(float(g), float(w), rtol=partial_rtol(dt))


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", KERNEL_SHAPES, ids=str)
@pytest.mark.parametrize("body, nvec, nout", [("pipe_body", 7, 6),
                                              ("ppipe_body", 10, 8)])
def test_pipe_bodies_match_reference(jops, body, nvec, nout, shape, dt):
    """Ghysels–Vanroose ordering: x/r/w (and u) consume the UPDATED p/s/z
    (and q), in the reference's output order."""
    _, tv, jv = _inputs(shape, 70, nvec, dt)
    alpha, beta = dt(0.41), dt(-0.9)
    out = getattr(ops, body)(torch.tensor(alpha), torch.tensor(beta), *tv)
    outr = getattr(jops, body)(jnp.asarray(alpha), jnp.asarray(beta), *jv)
    assert len(out) == len(outr) == nout
    for o, orf in zip(out, outr):
        assert o.dtype == tv[0].dtype and tuple(o.shape) == shape
        np.testing.assert_allclose(to_np(o), to_np(orf), **out_tols(dt))


def test_pipe_wrappers_reject_bad_inputs():
    v = torch.ones((4, 5, 6), dtype=torch.float64)
    bad = torch.ones((4, 5, 7), dtype=torch.float64)
    for args in ((v, v, bad), (v, v, v.to(torch.float32)), (v, v, v.to(torch.int64)),
                 (v, v, v.transpose(0, 2).contiguous().transpose(0, 2))):
        with pytest.raises((ValueError, TypeError)):
            ops.fused_dots(*args)
        with pytest.raises((ValueError, TypeError)):
            ops.pipe_body(0.5, 0.5, v, v, v, v, *args)
        with pytest.raises((ValueError, TypeError)):
            ops.ppipe_body(0.5, 0.5, v, v, v, v, v, v, v, *args)
    meta = torch.empty((4, 5, 6), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        ops.fused_dots(meta, meta, meta)
    with pytest.raises(ValueError):
        ops.pipe_body(0.5, 0.5, *([meta] * 7))
    with pytest.raises(ValueError):
        ops.ppipe_body(0.5, 0.5, *([meta] * 10))


# -----------------------------------------------------------------------------
# (b) KernelOp's hooks against PallasOp's
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("st", ["7pt", "27pt"])
def test_kernel_op_pipe_hooks_match_pallas_op(x64, st):
    PallasOp = ref_module("kernels.pallas_op").PallasOp
    JLocalOp = ref_module("core.solvers").LocalOp
    jst = ref_module("core.operators").STENCILS
    pop = PallasOp(JLocalOp(jst[st]), bz=8)
    kop = KernelOp(LocalOp(STENCILS[st]))
    shape = (12, 10, 16)
    _, tv, jv = _inputs(shape, 80, 3, np.float64)
    for g, w in zip(kop.fused_dots(*tv), pop.fused_dots(*jv)):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-11)
    a, b = torch.tensor(0.5), torch.tensor(0.25)
    ja, jb = jnp.asarray(0.5), jnp.asarray(0.25)
    _, tv, jv = _inputs(shape, 90, 7, np.float64)
    for o, orf in zip(kop.pipe_body(a, b, *tv), pop.pipe_body(ja, jb, *jv)):
        np.testing.assert_allclose(to_np(o), to_np(orf), **out_tols(np.float64))
    _, tv, jv = _inputs(shape, 100, 10, np.float64)
    for o, orf in zip(kop.ppipe_body(a, b, *tv), pop.ppipe_body(ja, jb, *jv)):
        np.testing.assert_allclose(to_np(o), to_np(orf), **out_tols(np.float64))
    # cg_pipe's pass 1: spmv_dots3 with x = w (first partial unused)
    _, tv, jv = _inputs(shape, 110, 2, np.float64)
    got, want = kop.spmv_dots3(*tv), pop.spmv_dots3(*jv)
    np.testing.assert_allclose(to_np(got[0]), to_np(want[0]), **out_tols(np.float64))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-11)


# -----------------------------------------------------------------------------
# (c) the solves against the reference, unfused and fused
# -----------------------------------------------------------------------------

def _carry(jprob, b=None):
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


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: "x".join(map(str, g)))
@pytest.mark.parametrize("stencil", ["7pt", "27pt"])
@pytest.mark.parametrize("method, precond", [
    ("cg_pipe", "none"), *[("pcg_pipe", p) for p in PRECONDS]])
def test_pipe_solve_matches_reference(x64, method, precond, stencil, grid, fused):
    """``kernels=fused`` against the reference's ``pallas=fused`` (its fused
    Pallas bodies and preconditioner kernels in interpret mode)."""
    api = ref_api()
    jprob = ref_module("core.problems").make_problem(grid, stencil)
    ref = api.solve(jprob, method=method,
                    options=api.SolverOptions(precond=precond, pallas=fused))
    res = solve(_carry(jprob), method=method,
                options=SolverOptions(precond=precond, kernels=fused))
    assert int(ref.status) == 0
    _assert_agree(res, ref)


def test_pipe_stops_one_iteration_after_merged():
    """The lagged check: here the pipelined CGs report one more iteration
    than their merged counterparts (the reference's +1 budget)."""
    kw = dict(grid=(16, 16, 16), stencil="27pt", device="cpu")
    for pipe, merged in (("cg_pipe", "cg_merged"), ("pcg_pipe", "pcg_merged")):
        a = solve(method=pipe, **kw, options=SolverOptions(precond="none"))
        b = solve(method=merged, **kw, options=SolverOptions(precond="none"))
        assert a.iters == b.iters + 1, (pipe, a.iters, b.iters)


# -----------------------------------------------------------------------------
# (d) the fused route against the unfused one
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("method, precond", [
    ("cg_pipe", "none"), *[("pcg_pipe", p) for p in PRECONDS]])
def test_pipe_fused_facade_path_matches_unfused(method, precond):
    """``kernels=True`` takes the fused body (the kernels' plain versions on
    the CPU, no launches): same iteration count, iterates within 1e-12."""
    kw = dict(method=method, grid=(16, 16, 16), stencil="27pt", device="cpu")
    opts = dict(tol=1e-8, maxiter=300, precond=precond)
    ops.reset_launches()
    plain = solve(**kw, options=SolverOptions(**opts))
    fused = solve(**kw, options=SolverOptions(**opts, kernels=True))
    assert all(n == 0 for n in ops.LAUNCHES.values())
    assert int(fused.iters) == int(plain.iters) and fused.status == 0
    np.testing.assert_allclose(to_np(fused.x), to_np(plain.x), rtol=1e-12, atol=1e-12)
    sess = SolverSession(method=method, grid=(4, 4, 4), device="cpu",
                         options=SolverOptions(precond=precond, kernels=True))
    assert sess._use_fused_body()


# -----------------------------------------------------------------------------
# (e) the recurrence residual against the true one at convergence
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("method, precond", [
    ("cg_pipe", "none"), ("pcg_pipe", "none"), ("pcg_pipe", "chebyshev")])
def test_pipe_true_residual_matches_estimate_at_convergence(method, precond):
    """The recurrence-based ``‖r‖`` must not drift from the truth by the time
    it declares convergence (32³ 27pt, as the reference's test)."""
    tol = 1e-6
    prob = make_problem((32, 32, 32), "27pt", device="cpu")
    A = LocalOp(prob.stencil)
    M = None if precond == "none" else make_precond(precond).bind(A)
    kw = {"M": M} if REGISTRY[method].accepts_precond else {}
    res = SOLVERS[method](A, prob.b(), prob.x0(), tol=tol, maxiter=1500,
                          norm_ref=1.0, **kw)
    assert res.status == 0
    true_r = float(torch.linalg.vector_norm(prob.b() - A.matvec(res.x)))
    assert true_r < 10 * tol, (method, true_r, float(res.res_norm))


# -----------------------------------------------------------------------------
# (f) the registry's pipelined check, and the M= rule
# -----------------------------------------------------------------------------

def test_registry_rejects_inconsistent_pipelined_spec():
    for name in ("cg_pipe", "pcg_pipe"):
        spec = REGISTRY[name]
        assert spec.reduce_hide == "pipelined" and spec.reduction_hides == ("pipe",)
        assert spec.blocking_reductions == 0 and spec.allreduces_per_iter == 1
        with pytest.raises(ValueError, match="pipe"):
            dataclasses.replace(spec, name="bad", reduction_hides=("none",))
    with pytest.raises(ValueError, match="pipe"):
        dataclasses.replace(REGISTRY["cg_merged"], name="bad",
                            reduce_hide="pipelined")
    with pytest.raises(ValueError, match="ONE stacked reduction"):
        dataclasses.replace(REGISTRY["cg_pipe"], name="bad",
                            reduction_hides=("pipe", "pipe"))
    assert REGISTRY["pcg_pipe"].precond_applies_per_iter == 1


def test_only_pcg_pipe_takes_a_preconditioner():
    prob = make_problem((6, 6, 6), "7pt", device="cpu")
    A = LocalOp(prob.stencil)
    M = make_precond("jacobi").bind(A)
    with pytest.raises(TypeError, match="preconditioner"):
        cg_pipe(A, prob.b(), prob.x0(), M=M)
    res = pcg_pipe(A, prob.b(), prob.x0(), M=M, norm_ref=1.0)
    assert res.status == 0
    with pytest.raises(ValueError, match="takes no preconditioner"):
        SolverSession(prob, method="cg_pipe", options=SolverOptions(precond="ssor"))
