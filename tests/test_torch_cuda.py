"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: every test skips where ``torch.cuda.is_available()`` is
False.  The file imports neither JAX nor the reference, so it runs on a
machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -p no:cacheprovider --noconftest -m gpu \
        tests/test_torch_cuda.py

Tolerances are the CPU tests' (outputs 1e-12 f64 / 1e-5 f32; partials rtol
1e-11 / 1e-4); the partials must also be bitwise equal from run to run, and
the kernels that round each operation in the plain version's order (the
pipelined and BiCGStab passes, the kernel API's flat passes and red-black
half-sweep, the plane-ring pass in both operand forms) give f64 outputs
bitwise equal to it.  Flash attention is held
to the reference tests' rtol 1e-4 / atol 1e-5 in f32 (TF32 off) and, in
bf16, to twice the plain bf16 version's own distance from the f32 plain
version on the same inputs (or 2⁻⁷ of the largest output, if larger); its
outputs are bitwise equal from run to run.  Its two bf16 bodies, ``wgmma``
(hd 64 and 128) and ``mma.sync`` (every width, through
``flash_attention_bf16_mma``), are also held to that rule at lengths and
windows around the wgmma body's 128-row tiles; its two f32 bodies, 3xTF32
(hd 64 and 128) and FFMA (every width, through ``flash_attention_f32_ffma``),
to the f32 rule at the same lengths and windows.  The batched solve's
lane-batched kernels (``-k batched``) are held to their plain versions and,
lane by lane, to the 3-D kernels, bitwise in f64, and each batched solve's
lanes to the single solves, bitwise; on a one-rank NCCL mesh (``-k
mesh_graphed``) the graphed solves, single and batched, are held bitwise to
the mesh's eager loop.  Run these with ``-x``,
since a source that fails to build would be rebuilt by every test.
"""

import pytest
import torch

from repro_torch.api import SolverOptions, SolverSession, solve
from repro_torch.core.methods import _colour_mask
from repro_torch.core.operators import STENCILS, pad1
from repro_torch.kernels import flash_attention as fa
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


def _eager_solve(**kw):
    """The session's eager loop, on which ``ops.LAUNCHES`` counts every
    launch (a graph replay, as ``solve`` runs, passes no wrapper)."""
    return SolverSession(**kw)._solve_eager()


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


@pytest.mark.parametrize("form", ["padded", "zero_halo"])
@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("st", ["7pt", "27pt"])
def test_ring_pass_matches_plain(cuda, st, shape, dt, form):
    """The plane-ring pass (``stencil_spmv`` with and without ``fuse_dot``,
    ``stencil_spmv_dots``, ``stencil_spmv_dots3``) in both operand forms:
    padded with a halo that is not zero (the caller's), or unpadded with the
    halo made in the kernel.  f64 outputs bitwise equal to the plain
    version's, f32 within the output tolerance; partials within the partial
    tolerance and bitwise equal from run to run."""
    stencil = STENCILS[st]
    zero_halo = form == "zero_halo"
    gen = torch.Generator(device=cuda).manual_seed(7)
    shape_in = shape if zero_halo else tuple(n + 2 for n in shape)
    x = torch.randn(shape_in, generator=gen, dtype=dt, device=cuda)
    r = torch.randn(shape, generator=gen, dtype=dt, device=cuda)
    xp = pad1(x) if zero_halo else x
    out_tol, part_rtol = _tols(dt)
    ops.reset_launches()
    y = ops.spmv(x, stencil, zero_halo=zero_halo)
    y1, d1 = ops.spmv_dot(x, stencil, zero_halo=zero_halo)
    _, d1b = ops.spmv_dot(x, stencil, zero_halo=zero_halo)
    y2, *parts2 = ops.spmv_dots(x, stencil, zero_halo=zero_halo)
    _, *again2 = ops.spmv_dots(x, stencil, zero_halo=zero_halo)
    y3, *parts = ops.spmv_dots3(x, r, stencil, zero_halo=zero_halo)
    _, *again = ops.spmv_dots3(x, r, stencil, zero_halo=zero_halo)
    assert {k: n for k, n in ops.LAUNCHES.items() if n} == {
        "stencil_spmv": 3, "stencil_spmv_dots": 2, "stencil_spmv_dots3": 2}
    yr, dr = ref.stencil_spmv_dot_ref(xp, stencil=stencil)
    _, *parts2_r = ref.stencil_spmv_dots_ref(xp, stencil=stencil)
    _, *parts_r = ref.stencil_spmv_dots3_ref(xp, r, stencil=stencil)
    for out in (y, y1, y2, y3):
        torch.testing.assert_close(out, yr, rtol=out_tol, atol=out_tol)
        assert dt != torch.float64 or torch.equal(out, yr)
    for got, g2, want in ((d1, d1b, dr), *zip(parts2, again2, parts2_r),
                          *zip(parts, again, parts_r)):
        torch.testing.assert_close(got, want, rtol=part_rtol, atol=0.0)
        assert torch.equal(got, g2)


def test_ring_pass_raises_on_a_refused_launch(cuda):
    """An operand whose grid the ring pass cannot launch (grid.y above 65535)
    raises from the wrapper; nothing falls back and nothing is counted."""
    st = STENCILS["7pt"]
    x = torch.zeros((1, 8 * 65535 + 1, 1), dtype=torch.float64, device=cuda)
    ops.reset_launches()
    with pytest.raises(RuntimeError, match="stencil_spmv: CUDA error"):
        ops.spmv(x, st, zero_halo=True)
    with pytest.raises(RuntimeError, match="stencil_spmv: CUDA error"):
        ops.spmv(pad1(x), st)
    with pytest.raises(RuntimeError, match="stencil_spmv_dots: CUDA error"):
        ops.spmv_dots(x, st, zero_halo=True)
    with pytest.raises(RuntimeError, match="stencil_spmv_dots3: CUDA error"):
        ops.spmv_dots3(x, x, st, zero_halo=True)
    assert not any(ops.LAUNCHES.values())


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
    fused = _eager_solve(**kw, options=SolverOptions(kernels=True))
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
    fused = _eager_solve(**kw, options=SolverOptions(precond=precond, kernels=True))
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
    fused = _eager_solve(**kw, options=SolverOptions(precond=precond, kernels=True))
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
    fused = _eager_solve(**kw, options=SolverOptions(precond=precond, kernels=True))
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


#: flat lengths of the kernel-API passes: no multiple of the block, and one
#: above the rank block's 128³
API_SIZES = [1, 1000, 5000, 128 ** 3 + 1]


def _api_calls(vecs, a, b, c, beta):
    x, y, z, w = vecs
    return (ops.axpbypcz(a, x, b, y, c, z), ops.axpbypcz_dot(a, x, b, y, c, z, w),
            ops.cg_update(beta, x, y, z, w))


def _api_plain(vecs, a, b, c, beta):
    x, y, z, w = vecs
    return (ref.fused_axpby_ref(a, x, b, y, c, z),
            ref.fused_axpby_dot_ref(a, x, b, y, c, z, w),
            ref.cg_fused_update_ref(beta, x, y, z, w))


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("n", API_SIZES)
def test_kernel_api_passes_match_plain(cuda, n, dt):
    """``fused_axpby``, ``fused_axpby_dot`` and ``cg_fused_update`` against
    their plain versions on ragged lengths: vector outputs bitwise equal in
    f64, the partials within the partial tolerance and bitwise equal from
    run to run."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    vecs = [torch.randn(n, generator=gen, dtype=dt, device=cuda) for _ in range(4)]
    a, b, c, beta = (torch.tensor(v, dtype=dt, device=cuda) for v in (0.3, -1.2, 2.0, 0.7))
    out_tol, part_rtol = _tols(dt)
    ops.reset_launches()
    got = _api_calls(vecs, a, b, c, beta)
    again = _api_calls(vecs, a, b, c, beta)
    want = _api_plain(vecs, a, b, c, beta)
    assert {k: m for k, m in ops.LAUNCHES.items() if m} == {
        "fused_axpby": 2, "fused_axpby_dot": 2, "cg_fused_update": 2}
    vec_got = [got[0], got[1][0], got[2][0], got[2][1]]
    vec_want = [want[0], want[1][0], want[2][0], want[2][1]]
    for g, w in zip(vec_got, vec_want):
        torch.testing.assert_close(g, w, rtol=out_tol, atol=out_tol)
        assert dt != torch.float64 or torch.equal(g, w)
    for g, g2, w in ((got[1][1], again[1][1], want[1][1]),
                     (got[2][2], again[2][2], want[2][2])):
        assert g.dim() == 0
        torch.testing.assert_close(g, w, rtol=part_rtol, atol=0.0)
        assert torch.equal(g, g2)


def test_kernel_api_passes_take_aliased_inputs(cuda):
    """``axpbypcz(a, x, b, x, c, x)`` and ``cg_update(β, r, r, p, p)``: the
    kernels only read their inputs and write fresh outputs."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    x, p = (torch.randn((9, 13, 70), generator=gen, dtype=torch.float64, device=cuda)
            for _ in range(2))
    a, b, c, beta = (torch.tensor(v, dtype=torch.float64, device=cuda)
                     for v in (0.3, -1.2, 2.0, 0.7))
    out = ops.axpbypcz(a, x, b, x, c, x)
    assert out.data_ptr() != x.data_ptr()
    assert torch.equal(out, ref.fused_axpby_ref(a, x, b, x, c, x))
    o2, d = ops.axpbypcz_dot(a, x, b, x, c, x, x)
    o2r, dr = ref.fused_axpby_dot_ref(a, x, b, x, c, x, x)
    assert torch.equal(o2, o2r)
    torch.testing.assert_close(d, dr, rtol=1e-11, atol=0.0)
    pn, apn, ad = ops.cg_update(beta, x, x, p, p)
    pnr, apnr, adr = ref.cg_fused_update_ref(beta, x, x, p, p)
    assert torch.equal(pn, pnr) and torch.equal(apn, apnr)
    torch.testing.assert_close(ad, adr, rtol=1e-11, atol=0.0)


#: the plane-ring pass's ragged edges: nx not a multiple of the half-sweep's
#: run of 8 planes (a last run of 1 and of 7; nor of 16, the other tails'),
#: ny not a multiple of its tile's 4 rows, nz not a multiple of its tile's 64
#: columns (one past, one short)
RING_EDGES = [(33, 10, 65), (31, 5, 63)]


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SHAPES + RING_EDGES + [(128, 128, 128)], ids=str)
@pytest.mark.parametrize("st", ["7pt", "27pt"])
def test_rb_gs_kernel_matches_plain(cuda, st, shape, dt):
    """Both colours of the half-sweep (the plane-ring pass's off-diagonal
    form) against the plain version: bitwise equal in f64 (same offset
    order, same reciprocal multiply), repeated bitwise, and a full symmetric
    sweep bitwise equal to the plain one."""
    stencil = STENCILS[st]
    gen = torch.Generator(device=cuda).manual_seed(9)
    x, b = (torch.randn(shape, generator=gen, dtype=dt, device=cuda) for _ in range(2))
    out_tol = _tols(dt)[0]
    ops.reset_launches()
    for colour in (0, 1):
        got = ops.gs_half_sweep(pad1(x), b, stencil, colour)
        want = ref.rb_gs_half_sweep_ref(pad1(x), b, stencil=stencil, colour=colour)
        torch.testing.assert_close(got, want, rtol=out_tol, atol=out_tol)
        assert dt != torch.float64 or torch.equal(got, want)
        assert torch.equal(got, ops.gs_half_sweep(pad1(x), b, stencil, colour))
        other = ~_colour_mask(shape, colour, cuda)        # keeps its value
        assert torch.equal(got[other], x[other])
    xs, xr = x, x
    for colour in (0, 1, 1, 0):
        xs = ops.gs_half_sweep(pad1(xs), b, stencil, colour)
        xr = ref.rb_gs_half_sweep_ref(pad1(xr), b, stencil=stencil, colour=colour)
    assert dt != torch.float64 or torch.equal(xs, xr)
    assert ops.LAUNCHES["rb_gs_half_sweep"] == 8


def test_kernel_api_rejects_bad_inputs(cuda):
    st = STENCILS["7pt"]
    v = torch.zeros((4, 5, 6), dtype=torch.float64, device=cuda)
    vp = pad1(v)
    bad = ((v.to(torch.int64), TypeError), (v.to(torch.bfloat16), TypeError),
           (v.cpu(), ValueError), (v.to(torch.float32), ValueError),
           (torch.zeros((4, 5, 7), dtype=torch.float64, device=cuda), ValueError),
           (v.transpose(0, 2).contiguous().transpose(0, 2), ValueError))
    for last, exc in bad:
        with pytest.raises(exc):
            ops.axpbypcz(0.5, v, 0.5, v, 0.5, last)
        with pytest.raises(exc):
            ops.axpbypcz_dot(0.5, v, 0.5, v, 0.5, v, last)
        with pytest.raises(exc):
            ops.cg_update(0.5, v, v, v, last)
        with pytest.raises(exc):
            ops.gs_half_sweep(vp, last, st, 0)
    for colour in (2, -1):
        with pytest.raises(ValueError):
            ops.gs_half_sweep(vp, v, st, colour)


#: flash attention: head widths (the reference tests', hymba's, internlm2's,
#: gemma2's), ragged sequence lengths, and windows (0: causal only)
ATTN_HEAD_DIMS = [8, 16, 32, 64, 128, 256]
ATTN_LENGTHS = [1, 17, 100, 128, 513]
ATTN_DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def no_tf32(cuda):
    """The plain version's f32 products in full f32, as chip_smoke.py sets."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield cuda
    torch.backends.cuda.matmul.allow_tf32 = prev


def _assert_attention_close(out, q, k, v, window):
    """A kernel output against the plain version: f32 within rtol 1e-4 and
    atol 1e-5; bf16 by ``ref.attention_bf16_error``'s element-wise rule
    against the plain version in f32 on the same inputs."""
    plain = ref.flash_attention_ref(q, k, v, window=window)
    if out.dtype == torch.float32:
        torch.testing.assert_close(out, plain, rtol=1e-4, atol=1e-5,
                                   msg=lambda m: f"window {window}: {m}")
        return
    o32 = ref.flash_attention_ref(q.float(), k.float(), v.float(), window=window)
    e = ref.attention_bf16_error(out, o32, plain)
    assert e["ratio"] <= 1 and e["frob"] <= 2 * e["plain_frob"], f"window {window}: {e}"


@pytest.mark.parametrize("dt", ATTN_DTYPES, ids=str)
@pytest.mark.parametrize("hd", ATTN_HEAD_DIMS)
@pytest.mark.parametrize("S", ATTN_LENGTHS)
def test_flash_attention_kernel_matches_plain(no_tf32, S, hd, dt):
    gen = torch.Generator(device=no_tf32).manual_seed(S * 1000 + hd)
    q, k, v = (torch.randn((2, S, 3, hd), generator=gen, device=no_tf32).to(dt)
               for _ in range(3))
    for window in (0, 1, 7, 32, S):
        ops.reset_launches()
        out = ops.flash_attention(q, k, v, window=window)
        again = ops.flash_attention(q, k, v, window=window)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["flash_attention"] == 2
        assert out.dtype == dt and out.shape == q.shape
        assert bool(torch.isfinite(out).all())
        assert torch.equal(out, again), f"window {window}: not reproducible"
        _assert_attention_close(out, q, k, v, window)


def test_flash_attention_rejects_bad_inputs(no_tf32):
    q = torch.zeros((1, 8, 2, 16), device=no_tf32)
    bad = (((q.double(),) * 3, TypeError),                        # f64 has no kernel
           ((q, q.cpu(), q), ValueError),                         # mixed devices
           ((torch.zeros((1, 8, 2, 24), device=no_tf32),) * 3, ValueError),   # hd 24
           ((q.transpose(1, 2).contiguous().transpose(1, 2), q, q), ValueError))
    for args, exc in bad:
        with pytest.raises(exc, match="flash_attention"):
            ops.flash_attention(*args)


#: the wgmma bodies' widths; lengths around their 128- and 64-row blocks
#: (zeros past S, a partial last query block) and windows around them (the
#: split between masked and unmasked tiles); the window S is added per length
WGMMA_LENGTHS = [1, 17, 100, 128, 129, 513, 1000]
WGMMA_WINDOWS = (0, 1, 7, 32, 127, 128, 129)


@pytest.mark.parametrize("body", ["wgmma", "mma"])
@pytest.mark.parametrize("hd", list(fa.WGMMA_HEAD_DIMS))
@pytest.mark.parametrize("S", WGMMA_LENGTHS)
def test_flash_attention_bf16_bodies_match_plain(no_tf32, S, hd, body):
    """B = 2 and H = 3, so that a tile read from the next batch or head would
    show; each output finite, bitwise equal to a second launch, within
    ``ref.attention_bf16_error``'s rule, and counted on its body only."""
    call = ops.flash_attention if body == "wgmma" else fa.flash_attention_bf16_mma
    gen = torch.Generator(device=no_tf32).manual_seed(S * 1000 + hd + 7)
    q, k, v = (torch.randn((2, S, 3, hd), generator=gen, device=no_tf32).to(torch.bfloat16)
               for _ in range(3))
    for window in WGMMA_WINDOWS + (S,):
        fa.reset_body_launches()
        out = call(q, k, v, window=window)
        again = call(q, k, v, window=window)
        torch.cuda.synchronize()
        assert fa.BODY_LAUNCHES == {**dict.fromkeys(fa.BODIES, 0), body: 2}
        assert out.dtype == torch.bfloat16 and out.shape == q.shape
        assert bool(torch.isfinite(out).all()), f"window {window}: not finite"
        assert torch.equal(out, again), f"window {window}: not reproducible"
        _assert_attention_close(out, q, k, v, window)


@pytest.mark.parametrize("body", ["tf32x3", "ffma"])
@pytest.mark.parametrize("hd", list(fa.WGMMA_HEAD_DIMS))
@pytest.mark.parametrize("S", WGMMA_LENGTHS)
def test_flash_attention_f32_bodies_match_plain(no_tf32, S, hd, body):
    """The 3xTF32 body (``ops.flash_attention`` at hd 64 and 128) and the FFMA
    body (``flash_attention_f32_ffma``) at lengths and windows around the
    3xTF32 body's 64-row blocks and 32-key tiles, B = 2 and H = 3: each
    output finite, bitwise equal to a second launch, within rtol 1e-4 and
    atol 1e-5 of the plain version (TF32 off), and counted on its body
    only."""
    call = ops.flash_attention if body == "tf32x3" else fa.flash_attention_f32_ffma
    gen = torch.Generator(device=no_tf32).manual_seed(S * 1000 + hd + 11)
    q, k, v = (torch.randn((2, S, 3, hd), generator=gen, device=no_tf32) for _ in range(3))
    for window in WGMMA_WINDOWS + (S,):
        fa.reset_body_launches()
        out = call(q, k, v, window=window)
        again = call(q, k, v, window=window)
        torch.cuda.synchronize()
        assert fa.BODY_LAUNCHES == {**dict.fromkeys(fa.BODIES, 0), body: 2}
        assert out.dtype == torch.float32 and out.shape == q.shape
        assert bool(torch.isfinite(out).all()), f"window {window}: not finite"
        assert torch.equal(out, again), f"window {window}: not reproducible"
        _assert_attention_close(out, q, k, v, window)


def test_flash_attention_route_is_the_sources(cuda):
    """``route``, which the CPU tests check, gives the source's own answer
    (``flash_attention_body``) for every dtype and width."""
    for dt in ATTN_DTYPES:
        for hd in ATTN_HEAD_DIMS:
            assert fa.route(dt, hd) == fa.source_body(dt, hd), (dt, hd)


# -- the executable cache: the solve as CUDA graphs ------------------------------

#: each method once, with a preconditioner where it takes one (chebyshev and
#: block_jacobi have kernels, jacobi runs on the SpMV kernel, ssor on none)
GRAPHED_CASES = [("cg", "none"), ("cg_nb", "none"), ("pcg", "ssor"),
                 ("cg_merged", "none"), ("pcg_merged", "chebyshev"),
                 ("cg_pipe", "none"), ("pcg_pipe", "block_jacobi"),
                 ("bicgstab", "none"), ("pbicgstab", "jacobi"),
                 ("bicgstab_b1", "none"), ("bicgstab_merged", "none"),
                 ("pbicgstab_merged", "chebyshev"), ("jacobi", "none"),
                 ("gauss_seidel_rb", "none"), ("gauss_seidel", "none")]
#: (grid, stencil, dtype): ragged grids
GRAPHED_PROBLEMS = [((10, 7, 13), "27pt", torch.float64),
                    ((5, 9, 6), "7pt", torch.float32)]


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bit patterns (NaN included) as integers."""
    return t.contiguous().view({8: torch.int64, 4: torch.int32}[t.element_size()])


def _assert_same_solve(got, want):
    """Iterations and status equal; iterate, residual norm and NaN-padded
    history bitwise equal."""
    assert (got.iters, got.status) == (want.iters, want.status)
    for a, b in ((got.x, want.x), (got.res_norm, want.res_norm),
                 (got.history, want.history)):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("problem", GRAPHED_PROBLEMS, ids=str)
@pytest.mark.parametrize("method, precond", GRAPHED_CASES)
def test_graphed_solve_matches_eager(cuda, method, precond, problem, kernels):
    """``SolverSession.solve`` (CUDA graphs, one read per block) against the
    eager loop on the card, on both routes: bitwise, twice (the second solve
    a cache hit)."""
    grid, st, dt = problem
    sess = SolverSession(method=method, grid=grid, stencil=st, device=cuda,
                         options=SolverOptions(precond=precond, kernels=kernels,
                                               f64=dt == torch.float64,
                                               maxiter=300))
    want = sess._solve_eager()
    for _ in range(2):
        _assert_same_solve(sess.solve(), want)
    exe = sess._executables[grid]
    assert len(exe._graphs) == 2 * len(exe.ladder)
    ((key, st_),) = sess.cache_stats().items()
    assert key == (grid, method, precond)
    assert st_["misses"] == 1 and st_["hits"] == 1 and st_["compile_s"] > 0


@pytest.mark.parametrize("max_block", [1, 4, 16])
@pytest.mark.parametrize("method, precond", [("cg_merged", "none"),
                                             ("pbicgstab_merged", "jacobi"),
                                             ("gauss_seidel", "none")])
def test_graphed_rollback_matches_eager(cuda, method, precond, max_block):
    """Every block takes the largest rung the budget allows, so every solve
    runs past its stop and is run again from the block's start; a
    ``maxiter`` that ends inside a block and ``maxiter = 0`` too."""
    for maxiter in (300, 7, 0):
        sess = SolverSession(method=method, grid=(10, 7, 13), stencil="27pt",
                             device=cuda,
                             options=SolverOptions(precond=precond, kernels=True,
                                                   maxiter=maxiter))
        sess._max_block = max_block
        want = sess._solve_eager()
        sess.solve()
        exe = sess._executables[(10, 7, 13)]
        exe.pick = lambda ladder, predicted, budget: max(k for k in ladder if k <= budget)
        got = sess.solve()
        _assert_same_solve(got, want)
        if maxiter == 300 and got.iters % max_block:
            assert sum(exe.blocks) > got.iters      # it ran past and redid


def test_graphed_inputs_change_between_solves(cuda):
    """A second solve with another ``b`` and ``x0`` under ``norm_ref=None``
    takes its own norm and threshold; a ``b`` holding a NaN breaks down at
    once; a ``b`` that converges at init runs no step."""
    sess = SolverSession(method="bicgstab_b1", grid=(10, 7, 13), stencil="7pt",
                         device=cuda, options=SolverOptions(norm_ref=None, kernels=True))
    gen = torch.Generator(device=cuda).manual_seed(5)
    b2 = torch.randn((10, 7, 13), generator=gen, dtype=torch.float64, device=cuda)
    x2 = torch.randn((10, 7, 13), generator=gen, dtype=torch.float64, device=cuda)
    bnan = sess.problem.b().clone()
    bnan[3, 2, 1] = float("nan")
    for b, x0 in ((None, None), (b2 * 1e3, x2), (None, None), (bnan, None),
                  (torch.zeros_like(b2), torch.zeros_like(b2))):
        want = sess._solve_eager(b, x0)    # first: the donating solve takes x0
        _assert_same_solve(sess.solve(b, x0), want)
    assert sess.solve(bnan).status == 2 and sess.solve(bnan).iters == 0
    assert sess.cache_stats()[((10, 7, 13), "bicgstab_b1", "none")]["misses"] == 1
    sess = SolverSession(method="cg_merged", grid=(10, 7, 13), stencil="7pt",
                         device=cuda, options=SolverOptions(kernels=True))
    x_true = sess.problem.x_true()
    at_init = sess.solve(x0=x_true)
    _assert_same_solve(at_init, sess._solve_eager(x0=x_true))
    assert at_init.iters == 0 and at_init.status == 0


def test_graphed_captures_once_per_key(cuda, monkeypatch):
    """The executable is built (its graphs captured) on the first solve of a
    shape and replayed by every later solve and ``timed_solve``."""
    from repro_torch.api import executable
    captures = []
    real = executable.SolveExecutable._capture

    def counted(self):
        captures.append(self)
        return real(self)

    monkeypatch.setattr(executable.SolveExecutable, "_capture", counted)
    sess = SolverSession(method="pcg_merged", grid=(10, 7, 13), device=cuda,
                         options=SolverOptions(precond="chebyshev", kernels=True))
    first = sess.solve()
    exe = sess._executables[(10, 7, 13)]
    sess.solve()
    res, stats = sess.timed_solve(repeats=2)
    assert captures == [exe] and sess._executables[(10, 7, 13)] is exe
    assert stats["median"] > 0 and res.iters == first.iters
    st = sess.cache_stats()[((10, 7, 13), "pcg_merged", "chebyshev")]
    assert st["misses"] == 1 and st["hits"] == 4


def test_graphed_capture_of_a_host_sync_raises(cuda):
    """A step that reads the card to the host cannot be captured: building
    the executable raises, and nothing falls back to the eager loop."""
    from repro_torch.api.executable import SolveExecutable
    from repro_torch.core.methods import MethodDef, Ops, get_method, run_method
    from repro_torch.core.problems import make_problem
    from repro_torch.core.solvers import LocalOp

    cg = get_method("cg")

    def syncing_step(ops, state):
        out = cg.step(ops, state)
        return out if bool(out[-1] > 0) else out          # a host read

    mdef = MethodDef(name="cg_host_read", vectors=cg.vectors, scalars=cg.scalars,
                     res_scalar=cg.res_scalar, init=cg.init, step=syncing_step)
    prob = make_problem((6, 5, 7), "7pt", torch.float64, cuda)
    b, x0 = prob.b(), prob.x0()
    run_eager = run_method(mdef, Ops(LocalOp(prob.stencil), b, norm_ref=1.0), x0)
    kw = dict(fused=False, tol=1e-6, maxiter=100, norm_ref=1.0, shape=b.shape,
              dtype=b.dtype, device=b.device)
    exe = SolveExecutable(mdef, LocalOp(prob.stencil), None, **kw)
    for _ in range(2):                      # its first step captures, each time
        with pytest.raises(RuntimeError):
            exe.solve(b, x0)
    torch.cuda.synchronize()
    # the card still works: the same method without the read is captured
    got = SolveExecutable(cg, LocalOp(prob.stencil), None, **kw).solve(b, x0)
    assert got.iters == run_eager.iters and got.status == run_eager.status


# -- the batched solve: the lane-batched kernels and the batched executable -------

#: lanes of the batched kernels' operands
BATCH_LANES = [1, 3]


@pytest.mark.parametrize("lanes", BATCH_LANES)
@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("st", ["7pt", "27pt"])
def test_batched_kernels_match_plain(cuda, st, shape, dt, lanes):
    """The lane-batched forms of ``stencil_spmv`` (x unpadded, the zero halo
    made in the kernel, and padded with a halo that is not zero),
    ``cheb_fused_step`` and ``block_jacobi_sweep``: one launch each over all
    lanes, counted under its own key; each lane's output bitwise the 3-D
    kernel's on that lane, and the outputs within the output tolerance of
    the plain version on the 4-D operands (f64: bitwise)."""
    stencil = STENCILS[st]
    gen = torch.Generator(device=cuda).manual_seed(11)
    x, r, d = (torch.randn((lanes, *shape), generator=gen, dtype=dt, device=cuda)
               for _ in range(3))
    xh = torch.randn((lanes, *(n + 2 for n in shape)), generator=gen, dtype=dt,
                     device=cuda)
    xp = pad1(x)
    out_tol = _tols(dt)[0]

    def calls(x, xh, xp, r, d):
        return [ops.spmv(x, stencil, zero_halo=True), ops.spmv(xh, stencil),
                *ops.cheb_step(xh, r, d, stencil, a=0.37, c=1.21),
                ops.jacobi_sweep(xp, r, stencil, omega=0.9)]

    ops.reset_launches()
    got = calls(x, xh, xp, r, d)
    assert {k: n for k, n in ops.LAUNCHES.items() if n} == {
        "stencil_spmv_batched": 2, "cheb_fused_step_batched": 1,
        "block_jacobi_sweep_batched": 1}
    plain = [ref.stencil_spmv_ref(xp, stencil=stencil),
             ref.stencil_spmv_ref(xh, stencil=stencil),
             *ref.cheb_fused_step_ref(xh, r, d, stencil=stencil, a=0.37, c=1.21),
             ref.block_jacobi_sweep_ref(xp, r, stencil=stencil, omega=0.9)]
    for g, p in zip(got, plain):
        assert g.shape == (lanes, *shape)
        torch.testing.assert_close(g, p, rtol=out_tol, atol=out_tol)
        assert dt != torch.float64 or torch.equal(g, p)
    for i in range(lanes):
        one = calls(*(t[i].contiguous() for t in (x, xh, xp, r, d)))
        assert all(torch.equal(g[i], o) for g, o in zip(got, one))


def test_batched_kernels_raise_on_a_refused_launch(cuda):
    """A batch whose lanes fold into a grid.z above 65535 raises from the
    wrapper; nothing falls back to a loop over lanes, nothing is counted."""
    st = STENCILS["7pt"]
    x = torch.zeros((32768, 17, 1, 1), dtype=torch.float64, device=cuda)
    xp = pad1(x)
    ops.reset_launches()
    with pytest.raises(RuntimeError, match=r"stencil_spmv \(batched\): CUDA error"):
        ops.spmv(x, st, zero_halo=True)
    with pytest.raises(RuntimeError, match=r"stencil_spmv \(batched\): CUDA error"):
        ops.spmv(xp, st)
    with pytest.raises(RuntimeError, match="cheb_fused_step: CUDA error"):
        ops.cheb_step(xp, x, x, st, a=0.5, c=0.5)
    with pytest.raises(RuntimeError, match="block_jacobi_sweep: CUDA error"):
        ops.jacobi_sweep(xp, x, st)
    assert not any(ops.LAUNCHES.values())


#: one case of each path: (method, precond, the batched kernels it launches)
BATCHED_SOLVES = [("cg", "none", {"stencil_spmv_batched"}),
                  ("pcg", "chebyshev", {"stencil_spmv_batched", "cheb_fused_step_batched"}),
                  ("pcg_merged", "block_jacobi",
                   {"stencil_spmv_batched", "block_jacobi_sweep_batched"}),
                  ("pcg_pipe", "chebyshev", {"stencil_spmv_batched", "cheb_fused_step_batched"}),
                  ("pbicgstab_merged", "block_jacobi",
                   {"stencil_spmv_batched", "block_jacobi_sweep_batched"}),
                  ("gauss_seidel", "none", {"stencil_spmv_batched"})]


@pytest.mark.parametrize("norm_ref", [1.0, None])
@pytest.mark.parametrize("method, precond, kernels", BATCHED_SOLVES)
def test_batched_solve_lanes_match_single_solves(cuda, method, precond, kernels, norm_ref):
    """A batched ``kernels=True`` solve (lanes A·1, a seeded normal one, a
    zero one): on the eager route it launches only the batched kernels;
    each lane is bitwise the session's unfused single solve of it; the
    graphed solve (a miss, then a hit) is bitwise the eager one."""
    grid = (10, 7, 13)
    sess = SolverSession(method=method, grid=grid, stencil="27pt", device=cuda,
                         options=SolverOptions(precond=precond, kernels=True,
                                               norm_ref=norm_ref, maxiter=300))
    gen = torch.Generator(device=cuda).manual_seed(12)
    bs = torch.stack([sess.problem.b(),
                      torch.randn(grid, generator=gen, dtype=torch.float64, device=cuda),
                      torch.zeros(grid, dtype=torch.float64, device=cuda)])
    ops.reset_launches()
    want = sess._solve_batched_eager(bs)
    assert {k for k, n in ops.LAUNCHES.items() if n} == kernels
    for i in range(3):
        one = sess._solve_unfused(bs[i])
        assert (int(want.iters[i]), int(want.status[i])) == (one.iters, one.status)
        for a, b in ((want.x[i], one.x), (want.res_norm[i], one.res_norm),
                     (want.history[i], one.history)):
            assert torch.equal(_bits(a), _bits(b))
    for _ in range(2):
        got = sess.solve_batched(bs)
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(_bits(a), _bits(b))
    exe = sess._executables[(3, *grid)]
    assert len(exe._graphs) == len(exe.ladder)
    st_ = sess.cache_stats()[((3, *grid), method, precond)]
    assert st_["misses"] == 1 and st_["hits"] == 1 and st_["compile_s"] > 0


# -- the resilient drivers in captured graphs: guards, refresh, telemetry ---------

#: (method, precond, options, status): guards that fire mid-solve, residual
#: replacement with telemetry
RESILIENT_CASES = [
    ("cg_merged", "none", dict(guards=True, stagnation_window=5, stagnation_rtol=0.1), 4),
    ("pcg_merged", "chebyshev", dict(guards=True, stagnation_window=3,
                                     stagnation_rtol=0.01, telemetry=True), 4),
    ("cg_merged", "none", dict(guards=True, residual_replacement=5, telemetry=True,
                               telemetry_buffer=7), 0),
    ("pcg_pipe", "chebyshev", dict(residual_replacement=3, telemetry=True), 0),
    ("bicgstab_merged", "none", dict(guards=True, residual_replacement=4), 0),
    ("pbicgstab_merged", "block_jacobi", dict(residual_replacement=7, telemetry=True), 0),
]


def _same_watched(got, want):
    _assert_same_solve(got, want)
    assert (got.telemetry is None) == (want.telemetry is None)
    if got.telemetry is not None:
        assert torch.equal(_bits(got.telemetry), _bits(want.telemetry))


@pytest.mark.parametrize("max_block", [4, 16])
@pytest.mark.parametrize("method, precond, kw, status", RESILIENT_CASES)
def test_graphed_guard_rollback_and_refresh_match_eager(cuda, method, precond, kw, status,
                                                        max_block):
    """Guards, residual replacement and telemetry in the captured graphs:
    the cached solve (its own blocks, then the largest block every time, so
    a guard's stop falls inside a block that is rolled back) bitwise the
    eager loop, telemetry included; with residual replacement each block
    size is captured in both forms and no block crosses a refresh but at
    its last step."""
    sess = SolverSession(method=method, grid=(10, 7, 13), stencil="27pt", device=cuda,
                         options=SolverOptions(precond=precond, kernels=True, maxiter=300,
                                               tol=1e-10, on_breakdown="none", **kw))
    sess._max_block = max_block
    want = sess._solve_eager()
    assert want.status == status
    _same_watched(sess.solve(), want)
    exe = sess._executables[(10, 7, 13)]
    every = sess.options.residual_replacement
    assert len(exe._graphs) == 2 * len(exe.ladder) * (2 if every else 1)
    exe.pick = lambda ladder, predicted, budget: max(k for k in ladder if k <= budget)
    _same_watched(sess.solve(), want)
    if every:               # the block that ran past the stop and its redo share a start
        k, rolled = 0, sum(exe.blocks) - want.iters
        for i, n in enumerate(exe.blocks):
            assert all((k + j) % every for j in range(1, n))
            if not (rolled and n == rolled and sum(exe.blocks[i + 1:]) < n):
                k += n
    else:
        assert sum(exe.blocks) > want.iters          # ran past the stop and redid


@pytest.mark.parametrize("kw", [dict(guards=True, telemetry=True),
                                dict(guards=True, residual_replacement=4, telemetry=True)])
def test_graphed_batched_guards_match_lanes(cuda, kw):
    """A batched cg_merged solve with guards (a NaN lane among them) and
    telemetry: the poisoned lane ends in breakdown at 0, every lane is its
    single solve, and the graphed batched solve is bitwise the eager one."""
    grid = (10, 7, 13)
    method = "cg_merged" if kw.get("residual_replacement") else "cg"
    sess = SolverSession(method=method, grid=grid, stencil="27pt", device=cuda,
                         options=SolverOptions(kernels=True, maxiter=300,
                                               on_breakdown="none", **kw))
    gen = torch.Generator(device=cuda).manual_seed(13)
    normal = torch.randn(grid, generator=gen, dtype=torch.float64, device=cuda)
    poisoned = normal.clone()
    poisoned[3, 2, 1] = float("nan")
    bs = torch.stack([sess.problem.b(), normal, poisoned])
    want = sess._solve_batched_eager(bs)
    assert int(want.status[2]) == 2 and int(want.iters[2]) == 0
    for i in range(3):
        one = sess._solve_unfused(bs[i])
        assert (int(want.iters[i]), int(want.status[i])) == (one.iters, one.status)
        for a, b in ((want.x[i], one.x), (want.history[i], one.history),
                     (want.telemetry[i], one.telemetry)):
            assert torch.equal(_bits(a), _bits(b))
    for _ in range(2):
        got = sess.solve_batched(bs)
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(_bits(a), _bits(b))
    exe = sess._executables[(3, *grid)]
    assert len(exe._graphs) == len(exe.ladder) * (2 if kw.get("residual_replacement") else 1)


# -- the solver service (repro_torch.serve) on the card ----------------------------

def _serve_req(rng, grid, **kw):
    from repro_torch.serve import Request
    kw.setdefault("maxiter", 300)
    return Request(b=rng.standard_normal(grid), **kw)


def _served_bits_equal(got, one) -> bool:
    """A served result against a single solve on the card: iterations and
    status equal, the iterate bit for bit."""
    from repro_torch.core.methods import status_name
    return (got.iters == one.iters and got.status == status_name(one.status)
            and got.x.tobytes() == one.x.cpu().numpy().tobytes())


def test_serve_cold_bucket_builds_while_warm_dispatches(cuda):
    """A cold bucket builds (captures its graphs) on the build thread while a
    warm bucket dispatches: no reject, one build a bucket, every result
    bitwise the direct solve on its bucket's session, and the warm request,
    submitted after the cold one, completes first (the device lock holds a
    dispatch only while a capture runs; the cold bucket dispatches once its
    build is admitted)."""
    import numpy as np

    from repro_torch.serve import ServeConfig, SolverService
    svc = SolverService(ServeConfig(max_batch=2, kernels=True, device="cuda"))
    rng = np.random.default_rng(3)
    first = _serve_req(rng, (16, 16, 16), method="cg")
    svc.submit(first)
    svc.run_until_drained()                        # the cg bucket is warm
    cold = _serve_req(rng, (10, 12, 14), method="bicgstab_b1")
    warm = _serve_req(rng, (16, 16, 16), method="cg")
    cold_id, warm_id = svc.submit(cold), svc.submit(warm)
    results = svc.run_until_drained()
    svc.close()
    assert not svc.rejects() and sorted(results) == [0, cold_id, warm_id]
    order = list(results)
    assert order.index(warm_id) < order.index(cold_id)
    stats = svc.cache.stats()
    assert stats["misses"] == 2 and stats["evictions"] == 0
    for req in (first, cold, warm):
        sess = svc.cache._entries[req.key()].session
        ((_, st),) = sess.cache_stats().items()
        assert st["misses"] == 1
        one = sess._solve_unfused(torch.from_numpy(req.b).to(cuda))
        assert _served_bits_equal(results[req.id], one)
    assert any(d["compiling"] for d in svc.dispatch_log)


class _HardDeath(RuntimeError):
    """Not a SimulatedFailure: the dispatch dies with its journal entry on disk."""


def test_serve_preemption_and_cold_start_recovery(cuda, tmp_path):
    """On the card: an injected preemption requeues the batch from the
    journal (nothing dropped, bitwise a clean run, the journal empty after);
    a service that dies mid-dispatch leaves its journal, and a new one
    recovers and completes the orphans bitwise a clean run."""
    import os

    import numpy as np

    from repro_torch.runtime.monitor import FailureInjector
    from repro_torch.serve import ServeConfig, SolverService, replay

    class Kill(FailureInjector):
        def maybe_fail(self, step):
            if step == self.fail_at_step and not self.fired:
                self.fired = True
                raise _HardDeath(f"died at dispatch {step}")

    grid = (12, 10, 14)
    rng = np.random.default_rng(11)
    payloads = [rng.standard_normal(grid) for _ in range(6)]

    def reqs():
        from repro_torch.serve import Request
        return [Request(b=b, method="pcg", precond="chebyshev", maxiter=300)
                for b in payloads]

    cfg = dict(max_batch=4, kernels=True, device="cuda")
    clean = SolverService(ServeConfig(**cfg))
    ref = replay(clean, reqs())
    clean.close()
    wal = str(tmp_path / "wal")
    pre = SolverService(ServeConfig(**cfg, recovery_dir=wal),
                        injector=FailureInjector(fail_at_step=1))
    got = replay(pre, reqs())
    pre.close()
    assert sorted(got) == sorted(ref) and pre.snapshot()["preemptions"] == 1
    for i in ref:
        assert got[i].x.tobytes() == ref[i].x.tobytes() and got[i].iters == ref[i].iters
    assert not os.listdir(wal)
    dying = SolverService(ServeConfig(**cfg, recovery_dir=wal, async_compile=False),
                          injector=Kill(fail_at_step=0))
    for r in reqs()[:3]:
        dying.submit(r)
    with pytest.raises(_HardDeath):
        dying.run_until_drained()
    dying.close()
    assert any(f.startswith("wal_") for f in os.listdir(wal))
    fresh = SolverService(ServeConfig(**cfg, recovery_dir=wal))
    remap = fresh.recover()
    results = fresh.run_until_drained()
    fresh.close()
    assert len(remap) == 3 and sorted(results) == sorted(remap.values())
    for old, new in remap.items():
        assert results[new].x.tobytes() == ref[old].x.tobytes()
        assert results[new].requeues >= 1
    assert not os.listdir(wal)


# -- the launch geometry picked at run time (kernels.autotune) ----------------------

TUNE_RUNS = (8, 16, 32)


@pytest.mark.parametrize("run", TUNE_RUNS)
@pytest.mark.parametrize("form", ["padded", "zero_halo"])
@pytest.mark.parametrize("shape", SHAPES + RING_EDGES, ids=str)
@pytest.mark.parametrize("st", ["7pt", "27pt"])
def test_tune_every_run_matches_plain(cuda, st, shape, form, run):
    """Rows 1, 2 and 4 (``stencil_spmv`` with and without ``fuse_dot``,
    ``stencil_spmv_dots``, ``stencil_spmv_dots3``) in each run of x-planes a
    launch may pick, in both operand forms, f64: y bitwise the plain
    version's, the partials within the partial tolerance and bitwise equal
    from run to run under the same run."""
    stencil = STENCILS[st]
    zero_halo = form == "zero_halo"
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(shape if zero_halo else tuple(n + 2 for n in shape), generator=gen,
                    dtype=torch.float64, device=cuda)
    r = torch.randn(shape, generator=gen, dtype=torch.float64, device=cuda)
    xp = pad1(x) if zero_halo else x
    kw = dict(zero_halo=zero_halo, run=run)
    y = ops.spmv(x, stencil, **kw)
    y1, d1 = ops.spmv_dot(x, stencil, **kw)
    y2, *parts2 = ops.spmv_dots(x, stencil, **kw)
    y3, *parts3 = ops.spmv_dots3(x, r, stencil, **kw)
    _, d1b = ops.spmv_dot(x, stencil, **kw)
    _, *again2 = ops.spmv_dots(x, stencil, **kw)
    _, *again3 = ops.spmv_dots3(x, r, stencil, **kw)
    yr, dr = ref.stencil_spmv_dot_ref(xp, stencil=stencil)
    _, *parts2_r = ref.stencil_spmv_dots_ref(xp, stencil=stencil)
    _, *parts3_r = ref.stencil_spmv_dots3_ref(xp, r, stencil=stencil)
    for out in (y, y1, y2, y3):
        assert torch.equal(out, yr)
    for got, g2, want in ((d1, d1b, dr), *zip(parts2, again2, parts2_r),
                          *zip(parts3, again3, parts3_r)):
        torch.testing.assert_close(got, want, rtol=1e-11, atol=0.0)
        assert torch.equal(got, g2)


def test_tune_unknown_run_raises(cuda):
    """The wrappers refuse a run with no kernel instance, and so do the C
    entry points behind them: nothing launches another one."""
    from repro_torch.kernels.spmv_dot import stencil_spmv_dots, stencil_spmv_dots3
    from repro_torch.kernels.stencil_spmv import stencil_spmv
    st = STENCILS["27pt"]
    x = torch.zeros((9, 13, 70), dtype=torch.float64, device=cuda)
    ops.reset_launches()
    with pytest.raises(ValueError, match="run must be one of"):
        ops.spmv_dots(x, st, zero_halo=True, run=12)
    with pytest.raises(RuntimeError, match="stencil_spmv: CUDA error"):
        stencil_spmv(x, stencil=st, zero_halo=True, run=12)
    for fn, args in ((stencil_spmv, ()), (stencil_spmv_dots, ()),
                     (stencil_spmv_dots3, (x,))):
        kw = dict(fuse_dot=True) if fn is stencil_spmv else {}
        with pytest.raises(ValueError, match="no kernel instance marches runs of 64"):
            fn(x, *args, stencil=st, zero_halo=True, run=64, **kw)
    assert not any(ops.LAUNCHES.values())


@pytest.mark.parametrize("run", TUNE_RUNS)
@pytest.mark.parametrize("method, precond", [("cg_merged", "none"),
                                             ("pcg_merged", "chebyshev"),
                                             ("cg_pipe", "none"),
                                             ("pcg_pipe", "chebyshev")])
def test_tune_graphed_solve_under_a_pinned_run_matches_eager(cuda, tmp_path, monkeypatch,
                                                             method, precond, run):
    """A session whose tune cache pins the run captures its
    graphs with it: the graphed solve is bitwise its eager solve, and a run
    moves the stopping iteration by at most one from the default run's."""
    from repro_torch.kernels import autotune
    grid = (40, 9, 70)
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))
    autotune.save_cache({autotune.tune_key("27pt", grid, torch.float64,
                                           autotune.device_kind(cuda)):
                         {"use_kernels": True, "run": run}})
    kw = dict(method=method, grid=grid, stencil="27pt", device=cuda)
    sess = SolverSession(**kw, options=SolverOptions(kernels=None, precond=precond,
                                                     maxiter=400))
    assert sess.options.kernels is True and sess._tune.run == run
    want = sess._solve_eager()
    for _ in range(2):
        _assert_same_solve(sess.solve(), want)
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "none.json"))
    default = SolverSession(**kw, options=SolverOptions(kernels=True, precond=precond,
                                                        maxiter=400))._solve_eager()
    assert abs(want.iters - default.iters) <= 1 and want.status == default.status


# -- the mesh solve in CUDA graphs under NCCL: one rank ---------------------------

#: (method, precond, kernels): the fused, the unfused and a preconditioned route
MESH_GRAPHED = [("cg_merged", "none", True), ("pcg_merged", "chebyshev", True),
                ("pcg", "block_jacobi", True), ("cg", "none", False),
                ("bicgstab", "none", False)]


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A ``cells`` mesh of one rank on a real NCCL group of this process
    (a ``file://`` rendezvous), destroyed after the module's tests."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import Mesh
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    rdv = tmp_path_factory.mktemp("nccl") / "rendezvous"
    dist.init_process_group("nccl", init_method=f"file://{rdv}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield Mesh((1,), ("cells",))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("method, precond, kernels", MESH_GRAPHED)
def test_mesh_graphed_solve_matches_eager(cuda, nccl_mesh, method, precond, kernels):
    """On a one-rank NCCL mesh ``solve`` and ``solve_batched`` go through
    the executable cache (their gathers captured in the graphs, in
    thread-local capture mode): each bitwise its eager loop, twice; the
    batched lanes bitwise their single mesh solves."""
    assert nccl_mesh.backend == "nccl"
    grid = (12, 10, 16)
    sess = SolverSession(method=method, grid=grid, stencil="27pt", device=cuda,
                         mesh=nccl_mesh, options=SolverOptions(precond=precond,
                                                               kernels=kernels, maxiter=300))
    assert sess._graphed
    want = sess._solve_eager()
    for _ in range(2):
        _assert_same_solve(sess.solve(), want)
    exe = sess._executables[grid]
    assert exe.capture_mode == "thread_local" and exe._graphs
    gen = torch.Generator(device=cuda).manual_seed(7)
    bs = torch.stack([sess.problem.b(),
                      torch.randn(grid, generator=gen, dtype=torch.float64, device=cuda),
                      torch.zeros(grid, dtype=torch.float64, device=cuda)])
    eager = sess._solve_batched_eager(bs)
    for _ in range(2):
        got = sess.solve_batched(bs)
        for a, b in zip(got, eager):
            assert (a is None and b is None) or torch.equal(_bits(a), _bits(b))
    for i in range(3):
        one = sess._solve_unfused(bs[i])
        assert (int(eager.iters[i]), int(eager.status[i])) == (one.iters, one.status)
        assert torch.equal(_bits(eager.x[i]), _bits(one.x))
    assert torch.equal(sess.gather(got.x), got.x)
