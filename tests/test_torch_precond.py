"""The port's ``repro_torch.precond`` against ``repro.precond``, on the CPU.

Each preconditioner's apply, with ``use_kernels`` off and on (the reference's
``use_pallas``: its Pallas kernels in interpret mode, the port's kernels'
plain versions), is fed the same seeded numpy residual as the reference's
apply bound to its ``LocalOp``; the outputs agree within rtol=atol=1e-12
(both sum in the same order; the reference's fused XLA expressions may round
an intermediate differently).  Chebyshev's static schedule equals the
reference's exactly.  The preconditioned solves agree with the reference's:
same iterations and status, histories within ``assert_history_equal``.  The
facade and validation cases follow ``tests/test_precond.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import x64  # noqa: F401  (fixture)
from test_torch_harness import (assert_history_equal, history_atol, ref_api,
                                ref_module, seeded, to_np)

from repro_torch.api import (REGISTRY, SolverOptions, SolverSession,
                             resolve_precond, solve)
from repro_torch.core.operators import STENCIL_7PT, STENCIL_27PT, STENCILS
from repro_torch.core.problems import from_reference, make_problem
from repro_torch.core.solvers import LocalOp, bicgstab, cg, pbicgstab, pcg
from repro_torch.kernels import ops
from repro_torch.kernels.kernel_op import KernelOp
from repro_torch.precond import (KERNEL_PRECONDS, PRECONDITIONERS, SSOR,
                                 BlockJacobi, Chebyshev, PointJacobi,
                                 gershgorin_bounds, make_precond, precond_names)

PRECONDS = ("jacobi", "block_jacobi", "ssor", "chebyshev")
APPLY_TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def jprecond(x64):
    return ref_module("precond"), ref_module("core.solvers").LocalOp, \
        ref_module("core.operators").STENCILS


def _carry(jprob):
    return from_reference(jprob.stencil.name, jprob.shape, np.dtype(jprob.dtype),
                          b=to_np(jprob.b()), x0=to_np(jprob.x0()), device="cpu")


# -----------------------------------------------------------------------------
# protocol / registry / metadata (tests/test_precond.py:62-111)
# -----------------------------------------------------------------------------

def test_registry_and_factory():
    assert set(PRECONDS) == set(PRECONDITIONERS)
    assert precond_names() == ("none", *sorted(PRECONDS))
    assert make_precond("none") is None
    assert make_precond(None) is None
    with pytest.raises(KeyError, match="unknown preconditioner"):
        make_precond("ilu")
    with pytest.raises(ValueError, match="params"):
        make_precond("none", sweeps=2)
    for name in PRECONDS:
        inst = make_precond(name)
        assert inst.name == name
        assert inst.extra_reductions_per_apply == 0, name
        assert inst.spd_preserving, name
        assert inst.touched_elements_per_apply(27) > 0, name
    assert make_precond("block_jacobi").halo_matvecs_per_apply == 0
    assert make_precond("jacobi", sweeps=3).halo_matvecs_per_apply == 2
    assert make_precond("ssor").halo_hide == "none"
    assert make_precond("chebyshev", degree=5).matvecs_per_apply == 4
    assert KERNEL_PRECONDS == ("block_jacobi", "chebyshev")


def test_metadata_matches_reference(jprecond):
    jpre, _, _ = jprecond
    assert precond_names() == jpre.precond_names()
    assert KERNEL_PRECONDS == jpre.PALLAS_PRECONDS
    for name in PRECONDS:
        for params in ({}, {"sweeps": 2} if name != "chebyshev" else {"degree": 6}):
            mine, theirs = make_precond(name, **params), jpre.make_precond(name, **params)
            for attr in ("spd_preserving", "extra_reductions_per_apply",
                         "halo_hide", "matvecs_per_apply",
                         "halo_matvecs_per_apply"):
                assert getattr(mine, attr) == getattr(theirs, attr), (name, attr)
            assert mine.describe() == theirs.describe()
            for nbar in (7, 27):
                assert (mine.touched_elements_per_apply(nbar)
                        == theirs.touched_elements_per_apply(nbar))


def test_param_validation():
    with pytest.raises(ValueError, match="sweeps"):
        PointJacobi(sweeps=0)
    with pytest.raises(ValueError, match="omega"):
        BlockJacobi(omega=1.5)
    with pytest.raises(ValueError, match="omega"):
        SSOR(omega=2.0)
    with pytest.raises(ValueError, match="degree"):
        Chebyshev(degree=0)
    with pytest.raises(ValueError, match="bounds"):
        Chebyshev(bounds=(-1.0, 2.0)).setup(LocalOp(STENCIL_7PT))


def test_gershgorin_bounds():
    assert gershgorin_bounds(STENCIL_7PT) == (21.0, 33.0)
    assert gershgorin_bounds(STENCIL_27PT) == (1.0, 53.0)


def test_solver_registry_hooks():
    for m in ("pcg", "pbicgstab", "pcg_merged"):
        assert REGISTRY[m].accepts_precond
    assert REGISTRY["pcg"].precond_applies_per_iter == 1
    assert REGISTRY["pbicgstab"].precond_applies_per_iter == 2
    assert REGISTRY["pcg_merged"].precond_applies_per_iter == 1
    assert REGISTRY["pcg"].variant_of == "cg"
    assert REGISTRY["pbicgstab"].variant_of == "bicgstab"
    assert REGISTRY["pcg_merged"].variant_of == "pcg"
    for m in ("cg", "cg_nb", "cg_merged", "bicgstab", "bicgstab_b1", "jacobi"):
        assert not REGISTRY[m].accepts_precond
    with pytest.raises(TypeError, match="preconditioner"):
        cg(LocalOp(STENCIL_7PT), torch.zeros((3, 3, 3), dtype=torch.float64),
           torch.zeros((3, 3, 3), dtype=torch.float64), M=lambda r: r)


# -----------------------------------------------------------------------------
# the apply against the reference's, kernels off and on
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("st", ["7pt", "27pt"])
@pytest.mark.parametrize("degree, bounds", [(4, None), (6, None), (3, (2.0, 40.0))])
def test_chebyshev_setup_equals_reference(jprecond, st, degree, bounds):
    """The static ``(theta, coefs)`` schedule, float for float."""
    jpre, JLocalOp, jst = jprecond
    mine = Chebyshev(degree=degree, bounds=bounds).setup(LocalOp(STENCILS[st]))
    theirs = jpre.Chebyshev(degree=degree, bounds=bounds).setup(JLocalOp(jst[st]))
    assert mine == theirs


@pytest.mark.parametrize("shape", [(12, 10, 16), (9, 7, 5)], ids=str)
@pytest.mark.parametrize("st", ["7pt", "27pt"])
@pytest.mark.parametrize("name, use_kernels", [
    *[(p, False) for p in PRECONDS], *[(p, True) for p in KERNEL_PRECONDS]])
def test_apply_matches_reference(jprecond, name, use_kernels, st, shape):
    """``use_kernels`` maps to the reference's ``use_pallas``."""
    jpre, JLocalOp, jst = jprecond
    params, jparams = {}, {}
    if name in KERNEL_PRECONDS:
        params, jparams = {"use_kernels": use_kernels}, {"use_pallas": use_kernels}
    r = seeded(shape, 3)
    A = LocalOp(STENCILS[st])
    z = make_precond(name, **params).bind(A)(torch.from_numpy(r))
    zr = jpre.make_precond(name, **jparams).bind(JLocalOp(jst[st]))(jnp.asarray(r))
    assert z.dtype == torch.float64 and tuple(z.shape) == shape
    np.testing.assert_allclose(to_np(z), to_np(zr), **APPLY_TOL)


@pytest.mark.parametrize("name", KERNEL_PRECONDS)
def test_use_kernels_apply_matches_plain(name):
    """``use_kernels`` (the kernels' plain versions on the CPU, bound to a
    ``KernelOp`` as on the fused route) against the plain apply."""
    prob = make_problem((12, 12, 16), "27pt", device="cpu")
    r = torch.from_numpy(seeded(prob.shape, 2))
    A = LocalOp(prob.stencil)
    z_plain = make_precond(name).bind(A)(r)
    z_kern = make_precond(name, use_kernels=True).bind(KernelOp(A))(r)
    torch.testing.assert_close(z_kern, z_plain, rtol=1e-12, atol=1e-12)


def test_kernel_flag_flows_into_precond():
    prob = make_problem((6, 6, 6), "7pt", device="cpu")
    sess = SolverSession(prob, method="pcg", options=SolverOptions(
        precond="chebyshev", kernels=True))
    assert sess.precond.use_kernels
    sess2 = SolverSession(prob, method="pcg", options=SolverOptions(
        precond="chebyshev", kernels=True,
        precond_params={"use_kernels": False}))
    assert not sess2.precond.use_kernels
    sess3 = SolverSession(prob, method="pcg", options=SolverOptions(
        precond="jacobi", kernels=True))     # no kernel: flag not passed
    assert isinstance(sess3.precond, PointJacobi)
    assert resolve_precond(SolverOptions(precond="block_jacobi")).use_kernels is False
    assert resolve_precond(SolverOptions()) is None


# -----------------------------------------------------------------------------
# preconditioned solves against the reference
# -----------------------------------------------------------------------------

def _assert_agree(res, ref):
    assert int(res.iters) == int(ref.iters)
    assert int(res.status) == int(ref.status)
    np.testing.assert_allclose(to_np(res.x), to_np(ref.x), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(res.res_norm), float(ref.res_norm),
                               rtol=1e-10, atol=history_atol(ref.history))
    assert_history_equal(res.history, ref.history)


@pytest.mark.parametrize("stencil", ["7pt", "27pt"])
@pytest.mark.parametrize("method, precond", [
    *[("pcg", p) for p in PRECONDS],
    *[("pbicgstab", p) for p in PRECONDS],
    *[("pcg_merged", p) for p in ("none", "chebyshev", "block_jacobi")],
])
def test_preconditioned_solve_matches_reference(x64, method, precond, stencil):
    api = ref_api()
    jprob = ref_module("core.problems").make_problem((12, 12, 12), stencil)
    ref = api.solve(jprob, method=method,
                    options=api.SolverOptions(precond=precond))
    res = solve(_carry(jprob), method=method,
                options=SolverOptions(precond=precond))
    assert int(ref.status) == 0
    _assert_agree(res, ref)


@pytest.mark.parametrize("stencil", ["7pt", "27pt"])
def test_pcg_merged_chebyshev_kernel_path_matches_pallas_path(x64, stencil):
    """``kernels=True``: the fused body and the Chebyshev steps on the
    kernels' plain versions through ``KernelOp``, against the reference's
    ``pallas=True`` (its fused Pallas body and Chebyshev kernel in interpret
    mode)."""
    api = ref_api()
    jprob = ref_module("core.problems").make_problem((12, 12, 12), stencil)
    ref = api.solve(jprob, method="pcg_merged",
                    options=api.SolverOptions(precond="chebyshev", pallas=True))
    res = solve(_carry(jprob), method="pcg_merged",
                options=SolverOptions(precond="chebyshev", kernels=True))
    _assert_agree(res, ref)


def test_pcg_identity_matches_cg_bitwise():
    """With M=None the preconditioned forms ARE the classical methods."""
    prob = make_problem((10, 10, 12), "27pt", device="cpu")
    A = LocalOp(prob.stencil)
    kw = dict(tol=1e-8, maxiter=500, norm_ref=1.0)
    r1, r2 = cg(A, prob.b(), prob.x0(), **kw), pcg(A, prob.b(), prob.x0(), **kw)
    assert r1.iters == r2.iters and torch.equal(r1.x, r2.x)
    b1 = bicgstab(A, prob.b(), prob.x0(), **kw)
    b2 = pbicgstab(A, prob.b(), prob.x0(), **kw)
    assert b1.iters == b2.iters and torch.equal(b1.x, b2.x)


def test_pcg_strictly_beats_cg_with_every_preconditioner():
    """The reference's acceptance property (there at 64³), at 24³ 7pt."""
    prob = make_problem((24, 24, 24), "7pt", device="cpu")
    A = LocalOp(prob.stencil)
    b, x0 = prob.b(), prob.x0()
    base = cg(A, b, x0, tol=1e-6, maxiter=700, norm_ref=1.0)
    assert base.status == 0
    for name in PRECONDS:
        res = pcg(A, b, x0, tol=1e-6, maxiter=700, norm_ref=1.0,
                  M=make_precond(name).bind(A))
        assert float(res.res_norm) < 1e-6, name
        assert res.iters < base.iters, (name, res.iters, base.iters)


# -----------------------------------------------------------------------------
# facade plumbing (tests/test_precond.py:182-226)
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("stencil", ["7pt", "27pt"])
def test_facade_precond_options(stencil):
    prob = make_problem((10, 10, 12), stencil, device="cpu")
    base = solve(prob, method="cg", tol=1e-8, maxiter=800)
    res = solve(prob, method="pcg", precond="chebyshev", tol=1e-8, maxiter=800)
    assert res.iters < base.iters
    # facade == direct solver call, bit for bit (both eager)
    A = LocalOp(prob.stencil)
    direct = pcg(A, prob.b(), prob.x0(), tol=1e-8, maxiter=800, norm_ref=1.0,
                 M=make_precond("chebyshev").bind(A))
    assert res.iters == direct.iters and torch.equal(res.x, direct.x)
    # precond_params reach the constructor
    r6 = solve(prob, method="pcg", precond="chebyshev",
               precond_params={"degree": 6}, tol=1e-8, maxiter=800)
    assert r6.iters <= res.iters


def test_facade_precond_validation():
    prob = make_problem((6, 6, 6), "7pt", device="cpu")
    with pytest.raises(ValueError, match="precond"):
        SolverOptions(precond="ilu")
    with pytest.raises(ValueError, match="precond_params"):
        SolverOptions(precond_params={"sweeps": 2})
    with pytest.raises(ValueError, match="takes no preconditioner"):
        SolverSession(prob, method="cg", options=SolverOptions(precond="jacobi"))
    with pytest.raises(ValueError, match="takes no preconditioner"):
        SolverSession(prob, method="cg_merged",
                      options=SolverOptions(precond="chebyshev", kernels=True))
    sess = SolverSession(prob, method="pcg", options=SolverOptions(precond="ssor"))
    assert "precond=ssor" in sess.describe()
    assert sess.describe().endswith("precond=ssor(omega=1.0, sweeps=1)")


def test_pcg_rejects_non_spd_preserving_precond(monkeypatch):
    """``spd_preserving`` gates pcg and pcg_merged; pbicgstab has no such
    requirement."""
    prob = make_problem((6, 6, 6), "7pt", device="cpu")
    monkeypatch.setattr(PointJacobi, "spd_preserving", False)
    for method in ("pcg", "pcg_merged"):
        with pytest.raises(ValueError, match="SPD-preserving"):
            SolverSession(prob, method=method,
                          options=SolverOptions(precond="jacobi"))
    SolverSession(prob, method="pbicgstab", options=SolverOptions(precond="jacobi"))


@pytest.mark.parametrize("precond", KERNEL_PRECONDS)
def test_fused_route_takes_preconditioned_merged_pcg(precond):
    """``pcg_merged`` with ``kernels=True`` goes the fused route with the
    preconditioner bound against the ``KernelOp``: the solve equals the
    unfused one, and the CPU launches nothing."""
    kw = dict(method="pcg_merged", grid=(10, 9, 11), stencil="27pt", device="cpu")
    ops.reset_launches()
    fused = solve(**kw, options=SolverOptions(precond=precond, kernels=True))
    plain = solve(**kw, options=SolverOptions(precond=precond))
    assert all(v == 0 for v in ops.LAUNCHES.values())
    assert fused.iters == plain.iters and fused.status == 0
    torch.testing.assert_close(fused.x, plain.x, rtol=1e-12, atol=1e-12)
    sess = SolverSession(method="pcg_merged", grid=(4, 4, 4), device="cpu",
                         options=SolverOptions(precond=precond, kernels=True))
    assert sess._use_fused_body() and sess.precond.use_kernels
