"""Single-reduction BiCGStab (bicgstab_merged, pbicgstab_merged) and its three
kernels on the CPU against the JAX reference.

Kernels: on CPU tensors ``ops.bicgstab_spmv_dots``/``bicgstab_update1``/
``bicgstab_spmv_update`` run their plain PyTorch versions; the reference runs
its Pallas kernels in interpret mode (as ``tests/test_kernels.py`` does).
Both get the same numpy inputs, with the padded stencil operand ``zi`` made
independently of ``z`` (in the preconditioned form ``zi = M(z)``, so a kernel
that read the stencil's centre value in place of ``z`` would show).  Vector
outputs agree within rtol=atol=1e-12 in f64 (1e-5 in f32); the nine partials
within rtol 1e-11 (1e-4), in slot order, because the two sum in different
orders.

Solves: as ``tests/test_torch_pipe.py``: the same iterations and status as
``repro.api.solve``, ``x`` within rtol 1e-10 and atol 1e-12, residual
histories within ``assert_history_equal``; unfused (``kernels=False``
against ``pallas=False``) and fused (``kernels=True`` against
``pallas=True``), on 7pt/27pt at 12³ and 16³, pbicgstab_merged with each
preconditioner.  The fused-against-unfused and true-residual cases follow
``tests/test_reduction_hiding.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import x64  # noqa: F401  (fixture)
from test_torch_harness import (assert_history_equal, history_atol, ref_api,
                                ref_module, seeded, to_np)

from repro_torch.api import REGISTRY, SolverOptions, SolverSession, solve
from repro_torch.core.methods import METHODS, Ops, _clamp_nonneg, run_method
from repro_torch.core.operators import STENCILS, pad1
from repro_torch.core.problems import from_reference, make_problem
from repro_torch.core.solvers import (SOLVERS, LocalOp, bicgstab_merged,
                                      pbicgstab_merged)
from repro_torch.kernels import ops
from repro_torch.kernels.kernel_op import KernelOp
from repro_torch.precond import make_precond

PRECONDS = ("none", "jacobi", "block_jacobi", "ssor", "chebyshev")
METHOD_CASES = [("bicgstab_merged", "none"), *[("pbicgstab_merged", p) for p in PRECONDS]]
GRIDS = [(12, 12, 12), (16, 16, 16)]
#: stencil shapes: regular and ragged; the body also takes a flat vector
STENCIL_SHAPES = [(12, 10, 16), (9, 7, 5)]
BODY_SHAPES = STENCIL_SHAPES + [(5000,)]
DTYPES = [np.float64, np.float32]
PART_NAMES = ("q·y", "y·y", "q·q", "r̂·q", "r̂·y", "r̂·t", "r̂·v", "r̂·z", "r̂·s")


def out_tols(dt):
    return dict(rtol=1e-12, atol=1e-12) if dt == np.float64 else dict(rtol=1e-5, atol=1e-5)


def partial_rtol(dt):
    return 1e-11 if dt == np.float64 else 1e-4


@pytest.fixture(scope="module")
def jops(x64):
    return ref_module("kernels.ops")


@pytest.fixture(scope="module")
def jstencils(x64):
    return ref_module("core.operators").STENCILS


def _inputs(shape, seed, count, dt):
    vecs = [seeded(shape, seed + i, dt) for i in range(count)]
    return [torch.from_numpy(v) for v in vecs], [jnp.asarray(v) for v in vecs]


def _padded(shape, seed, dt):
    """A halo-padded stencil operand, independent of the streamed vectors."""
    zi = seeded(shape, seed, dt)
    zp = np.pad(zi, 1)
    return torch.from_numpy(zp), jnp.asarray(zp)


def _assert_vectors(got, want, shape, dt):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert to_np(g).dtype == np.dtype(dt) and tuple(g.shape) == shape
        np.testing.assert_allclose(to_np(g), to_np(w), **out_tols(dt))


# -----------------------------------------------------------------------------
# (a) the plain versions against the Pallas kernels (interpret mode)
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", STENCIL_SHAPES, ids=str)
@pytest.mark.parametrize("st", ["7pt", "27pt"])
def test_bicgstab_spmv_dots_matches_reference(jops, jstencils, st, shape, dt):
    zp, jzp = _padded(shape, 200, dt)
    tv, jv = _inputs(shape, 210, 6, dt)               # z, r, w, s, r̂, t
    alpha = dt(0.37)
    v, q, y, parts = ops.bicgstab_spmv_dots(zp, *tv, torch.tensor(alpha), STENCILS[st])
    jv_, jq, jy, jparts = jops.bicgstab_spmv_dots(jzp, *jv, jnp.asarray(alpha),
                                                  jstencils[st])
    _assert_vectors((v, q, y), (jv_, jq, jy), shape, dt)
    assert len(parts) == len(jparts) == 9
    for name, g, w in zip(PART_NAMES, parts, jparts):
        assert g.dim() == 0 and g.dtype == tv[0].dtype
        np.testing.assert_allclose(float(g), float(w), rtol=partial_rtol(dt),
                                   err_msg=name)


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", STENCIL_SHAPES, ids=str)
@pytest.mark.parametrize("st", ["7pt", "27pt"])
def test_bicgstab_spmv_update_matches_reference(jops, jstencils, st, shape, dt):
    wp, jwp = _padded(shape, 300, dt)
    tv, jv = _inputs(shape, 310, 6, dt)               # w, r, p, s, z, v
    omega, beta = dt(0.83), dt(-0.41)
    got = ops.bicgstab_spmv_update(wp, *tv, torch.tensor(omega), torch.tensor(beta),
                                   STENCILS[st])
    want = jops.bicgstab_spmv_update(jwp, *jv, jnp.asarray(omega), jnp.asarray(beta),
                                     jstencils[st])
    _assert_vectors(got, want, shape, dt)             # (t', p', s', z')


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", BODY_SHAPES, ids=str)
def test_bicgstab_update1_matches_reference(jops, shape, dt):
    tv, jv = _inputs(shape, 400, 6, dt)               # y, p, q, yv, t, v
    alpha, omega = dt(0.37), dt(1.3)
    got = ops.bicgstab_update1(torch.tensor(alpha), torch.tensor(omega), *tv)
    want = jops.bicgstab_update1(jnp.asarray(alpha), jnp.asarray(omega), *jv)
    _assert_vectors(got, want, shape, dt)             # (y', r', w')


def test_bicgstab_plain_versions_keep_the_association():
    """``y + αp + ωq`` is ``(y + αp) + ωq`` and the recurrences round in the
    reference's order: the plain versions equal the expressions written out
    bitwise (the CUDA kernels round the same way)."""
    tv, _ = _inputs((6, 5, 7), 500, 6, np.float64)
    a, o, b = (torch.tensor(c, dtype=torch.float64) for c in (0.37, 1.3, -0.41))
    y, p, q, yv, t, v = tv
    got = ops.bicgstab_update1(a, o, *tv)
    for g, w in zip(got, ((y + a * p) + o * q, q - o * yv, yv - o * (t - a * v))):
        assert torch.equal(g, w)
    w_, r, p, s, z, v = tv
    wp = pad1(tv[0] * 0.5)
    tn, pn, sn, zn = ops.bicgstab_spmv_update(wp, *tv, o, b, STENCILS["27pt"])
    assert torch.equal(tn, STENCILS["27pt"].matvec_padded(wp))
    assert torch.equal(pn, r + b * (p - o * s))
    assert torch.equal(sn, w_ + b * (s - o * z))
    assert torch.equal(zn, tn + b * (z - o * v))


def test_bicgstab_wrappers_reject_bad_inputs():
    st = STENCILS["7pt"]
    v = torch.ones((4, 5, 6), dtype=torch.float64)
    vp = pad1(v)
    bad = torch.ones((4, 5, 7), dtype=torch.float64)
    for last in (bad, v.to(torch.float32), v.to(torch.int64),
                 v.transpose(0, 2).contiguous().transpose(0, 2)):
        with pytest.raises((ValueError, TypeError)):
            ops.bicgstab_spmv_dots(vp, v, v, v, v, v, last, 0.5, st)
        with pytest.raises((ValueError, TypeError)):
            ops.bicgstab_update1(0.5, 0.5, v, v, v, v, v, last)
        with pytest.raises((ValueError, TypeError)):
            ops.bicgstab_spmv_update(vp, v, v, v, v, v, last, 0.5, 0.5, st)
    with pytest.raises(ValueError):                   # unpadded stencil operand
        ops.bicgstab_spmv_dots(v, v, v, v, v, v, v, 0.5, st)
    with pytest.raises(ValueError):
        ops.bicgstab_spmv_update(v, v, v, v, v, v, v, 0.5, 0.5, st)
    meta = torch.empty((4, 5, 6), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        ops.bicgstab_update1(0.5, 0.5, *([meta] * 6))
    with pytest.raises(ValueError):
        ops.bicgstab_spmv_dots(pad1(meta), *([meta] * 6), 0.5, st)


# -----------------------------------------------------------------------------
# (b) KernelOp's hooks against PallasOp's
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("st", ["7pt", "27pt"])
def test_kernel_op_bicgstab_hooks_match_pallas_op(x64, jstencils, st):
    """The hooks pad ``zi``/``wi`` themselves; ``zi ≠ z`` as in the
    preconditioned form."""
    PallasOp = ref_module("kernels.pallas_op").PallasOp
    JLocalOp = ref_module("core.solvers").LocalOp
    pop = PallasOp(JLocalOp(jstencils[st]), bz=8)
    kop = KernelOp(LocalOp(STENCILS[st]))
    shape = (12, 10, 16)
    tv, jv = _inputs(shape, 600, 7, np.float64)       # zi, z, r, w, s, r̂, t
    f64 = dict(dtype=torch.float64)
    a, ja = torch.tensor(0.37, **f64), jnp.asarray(0.37)
    got, want = kop.bicgstab_spmv_dots(*tv, a), pop.bicgstab_spmv_dots(*jv, ja)
    _assert_vectors(got[:3], want[:3], shape, np.float64)
    for g, w in zip(got[3], want[3]):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-11)
    o, b = torch.tensor(0.83, **f64), torch.tensor(-0.41, **f64)
    jo, jb = jnp.asarray(0.83), jnp.asarray(-0.41)
    tv, jv = _inputs(shape, 700, 6, np.float64)
    _assert_vectors(kop.bicgstab_update1(a, o, *tv), pop.bicgstab_update1(ja, jo, *jv),
                    shape, np.float64)
    tv, jv = _inputs(shape, 800, 7, np.float64)       # wi, w, r, p, s, z, v
    _assert_vectors(kop.bicgstab_spmv_update(*tv, o, b),
                    pop.bicgstab_spmv_update(*jv, jo, jb), shape, np.float64)


# -----------------------------------------------------------------------------
# (c) the solves against the reference, unfused and fused
# -----------------------------------------------------------------------------

def _carry(jprob):
    return from_reference(jprob.stencil.name, jprob.shape, np.dtype(jprob.dtype),
                          b=to_np(jprob.b()), x0=to_np(jprob.x0()), device="cpu")


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: "x".join(map(str, g)))
@pytest.mark.parametrize("stencil", ["7pt", "27pt"])
@pytest.mark.parametrize("method, precond", METHOD_CASES)
def test_bicgstab_merged_solve_matches_reference(x64, method, precond, stencil, grid,
                                                 fused):
    """``kernels=fused`` against the reference's ``pallas=fused`` (its fused
    Pallas bodies and preconditioner kernels in interpret mode)."""
    api = ref_api()
    jprob = ref_module("core.problems").make_problem(grid, stencil)
    ref = api.solve(jprob, method=method,
                    options=api.SolverOptions(precond=precond, pallas=fused))
    res = solve(_carry(jprob), method=method,
                options=SolverOptions(precond=precond, kernels=fused))
    assert int(ref.status) == 0
    assert int(res.iters) == int(ref.iters)
    assert int(res.status) == int(ref.status)
    np.testing.assert_allclose(to_np(res.x), to_np(ref.x), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(res.res_norm), float(ref.res_norm),
                               rtol=1e-10, atol=history_atol(ref.history))
    assert_history_equal(res.history, ref.history)


# -----------------------------------------------------------------------------
# (d) the fused route against the unfused one
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("method, precond", METHOD_CASES)
def test_bicgstab_fused_facade_path_matches_unfused(method, precond):
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
    ("bicgstab_merged", "none"), ("pbicgstab_merged", "none"),
    ("pbicgstab_merged", "chebyshev")])
def test_bicgstab_true_residual_matches_estimate_at_convergence(method, precond):
    """The recurrence-based ``‖r‖`` (``‖q − ωy‖²`` from pre-update dots) must
    not drift from the truth by the time it declares convergence (32³ 27pt,
    as the reference's test)."""
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
# (f) finalize, the NaN-keeping clamp, the registry, the M= rule
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_pbicgstab_merged_finalize_recovers_x(fused):
    """The loop iterates in the preconditioned ŷ space: its ``y`` is no
    solution, ``finalize``'s ``x0 + M⁻¹y`` is."""
    prob = make_problem((12, 12, 12), "27pt", device="cpu")
    base = LocalOp(prob.stencil)
    A = KernelOp(base) if fused else base
    M = make_precond("chebyshev").bind(A)
    mdef = METHODS["pbicgstab_merged"]
    b, x0 = prob.b(), prob.x0() + 0.25
    res = run_method(mdef, Ops(A, b, M=M, norm_ref=1.0), x0, tol=1e-10,
                     maxiter=200, fused=fused)
    assert res.status == 0
    A_x = base.matvec(res.x)
    assert float(torch.linalg.vector_norm(b - A_x)) < 1e-9
    np.testing.assert_allclose(to_np(res.x), 1.0, atol=1e-9)
    # the iterate itself: x = x0 + M⁻¹y, and y is far from x
    ops_ = Ops(A, b, M=M, norm_ref=1.0)
    state = mdef.init(ops_, x0)
    for _ in range(res.iters):
        state = (mdef.fused_step if fused else mdef.step)(ops_, state)
    torch.testing.assert_close(mdef.finalize(ops_, x0, state), res.x,
                               rtol=0, atol=0)
    assert float((state[0] - res.x).abs().max()) > 1e-2


def test_rr_clamp_keeps_nan():
    x = torch.tensor([float("nan"), -1e-30, 0.0, 2.5], dtype=torch.float64)
    got = _clamp_nonneg(x)
    assert torch.isnan(got[0]) and got[1:].tolist() == [0.0, 0.0, 2.5]


def test_bicgstab_merged_registry_entries(x64):
    jreg = ref_module("api.registry")
    for name in ("bicgstab_merged", "pbicgstab_merged"):
        spec, ref = REGISTRY[name], jreg.get_solver(name)
        assert spec.fused_kernels == ref.fused_kernels == (
            "bicgstab_spmv_dots", "bicgstab_update1", "bicgstab_spmv_update")
        assert spec.spmvs_per_iter == 2 and spec.allreduces_per_iter == 1
        assert spec.precond_applies_per_iter == ref.precond_applies_per_iter
        m = METHODS[name]
        assert m.refresh_spmvs == 5 and m.has_fused_body and m.guard is not None
    assert REGISTRY["pbicgstab_merged"].precond_applies_per_iter == 2
    assert METHODS["pbicgstab_merged"].finalize is not None
    assert METHODS["bicgstab_merged"].finalize is None


def test_bicgstab_merged_guard_and_refresh_follow_the_reference():
    """The declared guard reads ρ and ‖r‖² from the reference's slots, and
    the refresh rebuilds the recurrence images from the true residual."""
    prob = make_problem((8, 8, 8), "7pt", device="cpu")
    A = LocalOp(prob.stencil)
    for name in ("bicgstab_merged", "pbicgstab_merged"):
        m = METHODS[name]
        M = make_precond("jacobi").bind(A) if m.accepts_precond else None
        ops_ = Ops(A, prob.b(), M=M, norm_ref=1.0)
        state = m.step(ops_, m.init(ops_, prob.x0()))
        assert not bool(m.guard(ops_, state, state[10], 1e-30))
        fresh = m.refresh(ops_, prob.x0(), state)
        x = m.finalize(ops_, prob.x0(), state) if m.finalize else state[0]
        torch.testing.assert_close(fresh[1], prob.b() - A.matvec(x))
        mv = (lambda v: A.matvec(M(v))) if M is not None else A.matvec
        torch.testing.assert_close(fresh[2], mv(fresh[1]))
        torch.testing.assert_close(fresh[6], mv(fresh[5]))


def test_only_pbicgstab_merged_takes_a_preconditioner():
    prob = make_problem((6, 6, 6), "7pt", device="cpu")
    A = LocalOp(prob.stencil)
    M = make_precond("jacobi").bind(A)
    with pytest.raises(TypeError, match="preconditioner"):
        bicgstab_merged(A, prob.b(), prob.x0(), M=M)
    res = pbicgstab_merged(A, prob.b(), prob.x0(), M=M, norm_ref=1.0)
    assert res.status == 0
    with pytest.raises(ValueError, match="takes no preconditioner"):
        SolverSession(prob, method="bicgstab_merged",
                      options=SolverOptions(precond="ssor"))
