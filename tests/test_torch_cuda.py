"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: every test skips where ``torch.cuda.is_available()`` is
False.  The file imports neither JAX nor the reference, so it runs on a
machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -p no:cacheprovider --noconftest -m gpu \
        tests/test_torch_cuda.py

Tolerances are the CPU tests' (outputs 1e-12 f64 / 1e-5 f32; partials rtol
1e-11 / 1e-4); the partials must also be bitwise equal from run to run, and
the kernels that round each operation in the plain version's order (the
pipelined and BiCGStab passes) give f64 outputs bitwise equal to it.
"""

import pytest
import torch

from repro_torch.api import SolverOptions, solve
from repro_torch.core.operators import STENCILS, pad1
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.gpu

#: ragged shapes: no dimension a multiple of the kernels' tile sizes
SHAPES = [(5, 7, 3), (9, 13, 70), (17, 6, 129)]
DTYPES = [torch.float64, torch.float32]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _tols(dt):
    return (1e-12, 1e-11) if dt == torch.float64 else (1e-5, 1e-4)


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("st", ["7pt", "27pt"])
def test_stencil_kernels_match_plain(cuda, st, shape, dt):
    stencil = STENCILS[st]
    gen = torch.Generator(device=cuda).manual_seed(1)
    xp = pad1(torch.randn(shape, generator=gen, dtype=dt, device=cuda))
    out_tol, part_rtol = _tols(dt)
    yr, dr = ref.stencil_spmv_dot_ref(xp, stencil=stencil)
    _, der, gar = ref.stencil_spmv_dots_ref(xp, stencil=stencil)
    y = ops.spmv(xp, stencil)
    y1, d1 = ops.spmv_dot(xp, stencil)
    w, de, ga = ops.spmv_dots(xp, stencil)
    _, de2, ga2 = ops.spmv_dots(xp, stencil)
    for out in (y, y1, w):
        torch.testing.assert_close(out, yr, rtol=out_tol, atol=out_tol)
    for got, want in ((d1, dr), (de, der), (ga, gar)):
        torch.testing.assert_close(got, want, rtol=part_rtol, atol=0.0)
    assert torch.equal(de, de2) and torch.equal(ga, ga2)


@pytest.mark.parametrize("dt", DTYPES, ids=str)
def test_cg_body_kernel_matches_plain(cuda, dt):
    gen = torch.Generator(device=cuda).manual_seed(2)
    vecs = [torch.randn((9, 13, 70), generator=gen, dtype=dt, device=cuda)
            for _ in range(5)]
    a = torch.tensor(0.37, dtype=dt, device=cuda)
    out = ops.cg_body(a, -0.21, *vecs)
    outr = ref.fused_cg_body_ref(a, torch.tensor(-0.21, dtype=dt, device=cuda), *vecs)
    tol = _tols(dt)[0]
    for o, orf in zip(out, outr):
        torch.testing.assert_close(o, orf, rtol=tol, atol=tol)


@pytest.mark.parametrize("method", ["cg_merged", "cg", "bicgstab_b1", "jacobi"])
def test_kernel_solve_matches_plain_solve(cuda, method):
    kw = dict(method=method, grid=(20, 18, 33), stencil="27pt", device=cuda)
    ops.reset_launches()
    fused = solve(**kw, options=SolverOptions(kernels=True))
    assert ops.LAUNCHES["stencil_spmv"] > 0
    if method == "cg_merged":
        assert ops.LAUNCHES["stencil_spmv_dots"] == fused.iters + 1
        assert ops.LAUNCHES["fused_cg_body"] == fused.iters
    plain = solve(**kw, options=SolverOptions(kernels=False))
    assert fused.status == 0 and fused.iters == plain.iters
    torch.testing.assert_close(fused.x, plain.x, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("st", ["7pt", "27pt"])
def test_precond_stencil_kernels_match_plain(cuda, st, shape, dt):
    """``stencil_spmv_dots3``, ``cheb_fused_step`` and ``block_jacobi_sweep``
    against their plain versions; the unpadded operands use the unpadded
    strides, which ragged shapes would expose."""
    stencil = STENCILS[st]
    gen = torch.Generator(device=cuda).manual_seed(3)
    z, r, d = (torch.randn(shape, generator=gen, dtype=dt, device=cuda)
               for _ in range(3))
    zp = pad1(z)
    out_tol, part_rtol = _tols(dt)
    y, yx, rx, rr = ops.spmv_dots3(zp, r, stencil)
    _, yx2, rx2, rr2 = ops.spmv_dots3(zp, r, stencil)
    yr, yxr, rxr, rrr = ref.stencil_spmv_dots3_ref(zp, r, stencil=stencil)
    torch.testing.assert_close(y, yr, rtol=out_tol, atol=out_tol)
    for got, want in ((yx, yxr), (rx, rxr), (rr, rrr)):
        torch.testing.assert_close(got, want, rtol=part_rtol, atol=0.0)
    assert torch.equal(yx, yx2) and torch.equal(rx, rx2) and torch.equal(rr, rr2)
    zn, dn = ops.cheb_step(zp, r, d, stencil, a=0.37, c=1.21)
    znr, dnr = ref.cheb_fused_step_ref(zp, r, d, stencil=stencil, a=0.37, c=1.21)
    torch.testing.assert_close(zn, znr, rtol=out_tol, atol=out_tol)
    torch.testing.assert_close(dn, dnr, rtol=out_tol, atol=out_tol)
    # Chebyshev's first step passes d and z as one tensor: no in-place write
    za, da = ops.cheb_step(zp, r, z, stencil, a=0.37, c=1.21)
    zar, dar = ref.cheb_fused_step_ref(zp, r, z.clone(), stencil=stencil, a=0.37, c=1.21)
    torch.testing.assert_close(za, zar, rtol=out_tol, atol=out_tol)
    torch.testing.assert_close(da, dar, rtol=out_tol, atol=out_tol)
    zs = ops.jacobi_sweep(zp, r, stencil, omega=0.9)
    zsr = ref.block_jacobi_sweep_ref(zp, r, stencil=stencil, omega=0.9)
    torch.testing.assert_close(zs, zsr, rtol=out_tol, atol=out_tol)


@pytest.mark.parametrize("dt", DTYPES, ids=str)
def test_pcg_body_kernel_matches_plain(cuda, dt):
    gen = torch.Generator(device=cuda).manual_seed(4)
    vecs = [torch.randn((9, 13, 70), generator=gen, dtype=dt, device=cuda)
            for _ in range(6)]
    a = torch.tensor(0.37, dtype=dt, device=cuda)
    out = ops.pcg_body(a, -0.21, *vecs)
    outr = ref.fused_pcg_body_ref(a, torch.tensor(-0.21, dtype=dt, device=cuda), *vecs)
    tol = _tols(dt)[0]
    for o, orf in zip(out, outr):
        torch.testing.assert_close(o, orf, rtol=tol, atol=tol)


@pytest.mark.parametrize("method, precond", [
    ("pcg_merged", "chebyshev"), ("pcg_merged", "block_jacobi"),
    ("pcg", "chebyshev"), ("pbicgstab", "block_jacobi")])
def test_preconditioned_kernel_solve_matches_plain_solve(cuda, method, precond):
    kw = dict(method=method, grid=(20, 18, 33), stencil="27pt", device=cuda)
    ops.reset_launches()
    fused = solve(**kw, options=SolverOptions(precond=precond, kernels=True))
    applies = {"pcg_merged": fused.iters + 1, "pcg": fused.iters + 1,
               "pbicgstab": 2 * fused.iters}[method]
    sweeps = {"chebyshev": ("cheb_fused_step", 3),
              "block_jacobi": ("block_jacobi_sweep", 2)}[precond]
    assert ops.LAUNCHES[sweeps[0]] == sweeps[1] * applies
    if method == "pcg_merged":
        assert ops.LAUNCHES["stencil_spmv_dots3"] == fused.iters
        assert ops.LAUNCHES["fused_pcg_body"] == fused.iters
    plain = solve(**kw, options=SolverOptions(precond=precond, kernels=False))
    assert fused.status == 0 and fused.iters == plain.iters
    torch.testing.assert_close(fused.x, plain.x, rtol=1e-10, atol=1e-12)


def test_kernel_rejects_mixed_devices(cuda):
    v = torch.zeros((4, 4, 4), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        ops.cg_body(0.5, 0.5, v, v, v, v, v.cpu())


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_pipe_kernels_match_plain(cuda, shape, dt):
    """``fused_pipe_body`` and ``fused_ppipe_body`` bitwise equal to their
    plain versions (each operation rounded on its own, in the same order);
    the ``fused_dots`` partials within the partial tolerance and bitwise
    equal from run to run."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    vecs = [torch.randn(shape, generator=gen, dtype=dt, device=cuda) for _ in range(10)]
    a = torch.tensor(0.41, dtype=dt, device=cuda)
    b = torch.tensor(-0.9, dtype=dt, device=cuda)
    ops.reset_launches()
    out = ops.pipe_body(a, b, *vecs[:7])
    outr = ref.fused_pipe_body_ref(a, b, *vecs[:7])
    assert len(out) == 6 and all(torch.equal(o, orf) for o, orf in zip(out, outr))
    out = ops.ppipe_body(a, b, *vecs)
    outr = ref.fused_ppipe_body_ref(a, b, *vecs)
    assert len(out) == 8 and all(torch.equal(o, orf) for o, orf in zip(out, outr))
    dots = ops.fused_dots(*vecs[:3])
    again = ops.fused_dots(*vecs[:3])
    want = ref.fused_dots_ref(*vecs[:3])
    for got, w in zip(dots, want):
        torch.testing.assert_close(got, w, rtol=_tols(dt)[1], atol=0.0)
    assert all(torch.equal(d, e) for d, e in zip(dots, again))
    assert (ops.LAUNCHES["fused_pipe_body"], ops.LAUNCHES["fused_ppipe_body"],
            ops.LAUNCHES["fused_dots"]) == (1, 1, 2)


@pytest.mark.parametrize("kernel", ["fused_dots", "pipe_body", "ppipe_body"])
def test_pipe_kernels_reject_bad_inputs(cuda, kernel):
    nvec = {"fused_dots": 3, "pipe_body": 7, "ppipe_body": 10}[kernel]
    scalars = () if kernel == "fused_dots" else (0.5, 0.25)
    fn = getattr(ops, kernel)
    v = torch.zeros((4, 5, 6), dtype=torch.float64, device=cuda)
    for last, exc in ((v.to(torch.int64), TypeError), (v.cpu(), ValueError),
                      (v.to(torch.float32), ValueError),
                      (torch.zeros((4, 5, 7), dtype=torch.float64, device=cuda),
                       ValueError)):
        with pytest.raises(exc):
            fn(*scalars, *([v] * (nvec - 1)), last)


@pytest.mark.parametrize("method, precond", [
    ("cg_pipe", "none"), ("pcg_pipe", "chebyshev"), ("pcg_pipe", "block_jacobi"),
    ("pcg_pipe", "jacobi")])
def test_pipe_kernel_solve_matches_plain_solve(cuda, method, precond):
    kw = dict(method=method, grid=(20, 18, 33), stencil="27pt", device=cuda)
    ops.reset_launches()
    fused = solve(**kw, options=SolverOptions(precond=precond, kernels=True))
    k = fused.iters
    if method == "cg_pipe":
        want = {"stencil_spmv": 2, "stencil_spmv_dots3": k, "fused_pipe_body": k}
    else:
        want = {"stencil_spmv": 2 + k, "fused_dots": k, "fused_ppipe_body": k}
        kernel, per_apply = {"chebyshev": ("cheb_fused_step", 3),
                             "block_jacobi": ("block_jacobi_sweep", 2),
                             "jacobi": ("stencil_spmv", 1)}[precond]
        want[kernel] = want.get(kernel, 0) + per_apply * (1 + k)
    assert {n: c for n, c in ops.LAUNCHES.items() if c} == want
    plain = solve(**kw, options=SolverOptions(precond=precond, kernels=False))
    assert fused.status == 0 and fused.iters == plain.iters
    torch.testing.assert_close(fused.x, plain.x, rtol=1e-10, atol=1e-12)


def _bicgstab_calls(st, vecs, zp, a, o, b):
    """The three BiCGStab kernels on ``vecs`` (z, r, w, s, r̂, t, y, p, v):
    pass 1, the ω-half and pass 3, as the fused step calls them."""
    z, r, w, s, rhat, t, y, p, v = vecs
    return (ops.bicgstab_spmv_dots(zp, z, r, w, s, rhat, t, a, st),
            ops.bicgstab_update1(a, o, y, p, r, w, t, v),
            ops.bicgstab_spmv_update(zp, w, r, p, s, z, v, o, b, st))


def _bicgstab_plain(st, vecs, zp, a, o, b):
    z, r, w, s, rhat, t, y, p, v = vecs
    return (ref.bicgstab_spmv_dots_ref(zp, z, r, w, s, rhat, t, a, stencil=st),
            ref.bicgstab_update1_ref(a, o, y, p, r, w, t, v),
            ref.bicgstab_spmv_update_ref(zp, w, r, p, s, z, v, o, b, stencil=st))


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("st", ["7pt", "27pt"])
def test_bicgstab_kernels_match_plain(cuda, st, shape, dt):
    """The three BiCGStab kernels against their plain versions: vector
    outputs bitwise equal in f64, the nine partials within the partial
    tolerance and bitwise equal from run to run.  The padded operand is not
    ``z`` padded (``zi = M(z)`` in the preconditioned form); a second call
    passes one tensor in several slots, as the first iteration does."""
    stencil = STENCILS[st]
    gen = torch.Generator(device=cuda).manual_seed(6)
    vecs = [torch.randn(shape, generator=gen, dtype=dt, device=cuda) for _ in range(9)]
    zp = pad1(torch.randn(shape, generator=gen, dtype=dt, device=cuda))
    a, o, b = (torch.tensor(c, dtype=dt, device=cuda) for c in (0.37, 1.3, -0.41))
    out_tol, part_rtol = _tols(dt)
    ops.reset_launches()
    got = _bicgstab_calls(stencil, vecs, zp, a, o, b)
    again = _bicgstab_calls(stencil, vecs, zp, a, o, b)
    want = _bicgstab_plain(stencil, vecs, zp, a, o, b)
    assert {k: n for k, n in ops.LAUNCHES.items() if n} == {
        "bicgstab_fused_spmv_dots": 2, "bicgstab_fused_update1": 2,
        "bicgstab_fused_spmv_update": 2}
    vec_got = list(got[0][:3]) + list(got[1]) + list(got[2])
    vec_want = list(want[0][:3]) + list(want[1]) + list(want[2])
    for g, w in zip(vec_got, vec_want):
        torch.testing.assert_close(g, w, rtol=out_tol, atol=out_tol)
        assert dt != torch.float64 or torch.equal(g, w)
    assert len(got[0][3]) == 9
    for g, g2, w in zip(got[0][3], again[0][3], want[0][3]):
        torch.testing.assert_close(g, w, rtol=part_rtol, atol=0.0)
        assert torch.equal(g, g2)
    # the first iteration's aliasing: r = p = r̂, s = w, z = t
    z, r, w, s, rhat, t, y, p, v = vecs
    alias = [z, r, w, w, r, z, y, r, v]
    got = _bicgstab_calls(stencil, alias, zp, a, o, b)
    want = _bicgstab_plain(stencil, [x.clone() for x in alias], zp, a, o, b)
    for g, w_ in zip(list(got[0][:3]) + list(got[1]) + list(got[2]),
                     list(want[0][:3]) + list(want[1]) + list(want[2])):
        torch.testing.assert_close(g, w_, rtol=out_tol, atol=out_tol)
    for g, w_ in zip(got[0][3], want[0][3]):
        torch.testing.assert_close(g, w_, rtol=part_rtol, atol=0.0)


@pytest.mark.parametrize("kernel", ["bicgstab_spmv_dots", "bicgstab_update1",
                                    "bicgstab_spmv_update"])
def test_bicgstab_kernels_reject_bad_inputs(cuda, kernel):
    st = STENCILS["27pt"]
    v = torch.zeros((4, 5, 6), dtype=torch.float64, device=cuda)
    vp = pad1(v)
    fn = {"bicgstab_spmv_dots": lambda last: ops.bicgstab_spmv_dots(
              vp, v, v, v, v, v, last, 0.5, st),
          "bicgstab_update1": lambda last: ops.bicgstab_update1(0.5, 0.5, v, v, v, v, v,
                                                                last),
          "bicgstab_spmv_update": lambda last: ops.bicgstab_spmv_update(
              vp, v, v, v, v, v, last, 0.5, 0.5, st)}[kernel]
    for last, exc in ((v.to(torch.int64), TypeError), (v.cpu(), ValueError),
                      (v.to(torch.float32), ValueError),
                      (torch.zeros((4, 5, 7), dtype=torch.float64, device=cuda),
                       ValueError)):
        with pytest.raises(exc):
            fn(last)


@pytest.mark.parametrize("method, precond", [
    ("bicgstab_merged", "none"), ("pbicgstab_merged", "chebyshev"),
    ("pbicgstab_merged", "block_jacobi"), ("pbicgstab_merged", "jacobi"),
    ("pbicgstab_merged", "ssor")])
def test_bicgstab_kernel_solve_matches_plain_solve(cuda, method, precond):
    """The fused route: 3 set-up SpMVs, k launches of each BiCGStab kernel
    and, preconditioned, 2k + 3 applies of M (two in the set-up, two per
    iteration, one in ``finalize``)."""
    kw = dict(method=method, grid=(20, 18, 33), stencil="27pt", device=cuda)
    ops.reset_launches()
    fused = solve(**kw, options=SolverOptions(precond=precond, kernels=True))
    k = fused.iters
    want = {"stencil_spmv": 3, "bicgstab_fused_spmv_dots": k,
            "bicgstab_fused_update1": k, "bicgstab_fused_spmv_update": k}
    if precond != "none":
        kernel, per_apply = {"chebyshev": ("cheb_fused_step", 3),
                             "block_jacobi": ("block_jacobi_sweep", 2),
                             "jacobi": ("stencil_spmv", 1),
                             "ssor": (None, 0)}[precond]
        if kernel is not None:
            want[kernel] = want.get(kernel, 0) + per_apply * (2 * k + 3)
    assert {n: c for n, c in ops.LAUNCHES.items() if c} == want
    plain = solve(**kw, options=SolverOptions(precond=precond, kernels=False))
    assert fused.status == 0 and fused.iters == plain.iters
    torch.testing.assert_close(fused.x, plain.x, rtol=1e-10, atol=1e-12)
