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
    bad = ((v.to(torch.int64), TypeError), (v.to(torch.bfloat16), ValueError),
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


@pytest.mark.parametrize("batched", [False, True])
def test_graphed_capture_outlives_a_dead_session_in_a_cycle(cuda, monkeypatch, batched):
    """A graphed session that dies in a reference cycle while another one
    captures is not collected inside that capture: destroying its graphs
    there would invalidate the capture.  The capture's steps see the
    collector off (an automatic collection runs only while it is on, and
    here one runs then), the solve is bitwise its eager loop, and the dead
    session is collected after the capture."""
    import gc
    import weakref

    from repro_torch.api import executable

    grid = (10, 7, 13)
    dead = SolverSession(method="cg_merged", grid=grid, stencil="27pt", device=cuda,
                         options=SolverOptions(kernels=True))
    dead.solve()
    assert dead._executables[grid]._graphs
    dead.cycle = dead                           # only the collector frees it
    gone, holder = weakref.ref(dead), [dead]
    del dead
    seen = []
    cls = executable.BatchedSolveExecutable if batched else executable.SolveExecutable
    real = cls._block

    def dropping(self, *args):
        if torch.cuda.is_current_stream_capturing():
            holder.clear()                      # the cycle is garbage from here on
            seen.append(gc.isenabled())
            if seen[-1]:
                gc.collect()
        return real(self, *args)

    monkeypatch.setattr(cls, "_block", dropping)
    sess = SolverSession(method="cg_merged", grid=grid, stencil="27pt", device=cuda,
                         options=SolverOptions(kernels=True))
    if batched:
        bs = torch.stack([sess.problem.b(), 2 * sess.problem.b()])
        want, got = sess._solve_batched_eager(bs), sess.solve_batched(bs)
        assert all((a is None and b is None) or torch.equal(_bits(a), _bits(b))
                   for a, b in zip(got, want))
    else:
        want = sess._solve_eager()
        _assert_same_solve(sess.solve(), want)
    assert seen and not any(seen) and gc.isenabled()
    gc.collect()
    assert gone() is None


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


# -- bf16: the solver kernels' bf16 forms against their plain versions --------------
#
# bf16 in and out, the dot partials f32 sums of f32 products.  Each kernel
# rounds every operation to bf16 in the plain version's order (sm_90's
# add/sub/mul.rn.bf16; a division by diag as PyTorch's multiply by the f32
# reciprocal), so its outputs are bitwise the plain version's on the same
# card tensors; the partials lie within 1e-5·Σ|a_i·b_i| of the plain
# version's f32 sums and repeat bitwise from run to run.

#: the bf16 scalars' values (Python floats with more bits than bf16 keeps;
#: the wrappers and the plain versions round them alike)
BF16_SCALARS = dict(alpha=0.3719, beta=-0.2113, omega=0.8, c2=2.0, a=0.3719, c=0.1137)


def _bf16_calls(st, xp, x, r, d, T):
    """name -> (the wrapper's call, the plain version's call, what each
    output is: "O" a bf16 output, "P" an f32 partial, the partials'
    operands from the wrapper's outputs)."""
    s = BF16_SCALARS
    al, be, om, c2 = s["alpha"], s["beta"], s["omega"], s["c2"]

    def bicg_pairs(out):
        v, q, y, _ = out
        rh, t, z, w = T[4], T[5], T[0], T[3]
        return [(q, y), (y, y), (q, q), (rh, q), (rh, y), (rh, t), (rh, v), (rh, z), (rh, w)]

    return {
        "spmv": (lambda: ops.spmv(x, st, zero_halo=True),
                 lambda: ref.stencil_spmv_ref(xp, stencil=st), "O", lambda out: []),
        "spmv_dot": (lambda: ops.spmv_dot(xp, st),
                     lambda: ref.stencil_spmv_dot_ref(xp, stencil=st), "OP",
                     lambda out: [(out[0], x)]),
        "spmv_dots": (lambda: ops.spmv_dots(x, st, zero_halo=True),
                      lambda: ref.stencil_spmv_dots_ref(xp, stencil=st), "OPP",
                      lambda out: [(out[0], x), (x, x)]),
        "spmv_dots3": (lambda: ops.spmv_dots3(xp, r, st),
                       lambda: ref.stencil_spmv_dots3_ref(xp, r, stencil=st), "OPPP",
                       lambda out: [(out[0], x), (r, x), (r, r)]),
        "cg_body": (lambda: ops.cg_body(al, be, *T[:5]),
                    lambda: ref.fused_cg_body_ref(al, be, *T[:5]), "OOOO", lambda out: []),
        "pcg_body": (lambda: ops.pcg_body(al, be, *T[:6]),
                     lambda: ref.fused_pcg_body_ref(al, be, *T[:6]), "OOOO", lambda out: []),
        "pipe_body": (lambda: ops.pipe_body(al, be, *T[:7]),
                      lambda: ref.fused_pipe_body_ref(al, be, *T[:7]), "O" * 6,
                      lambda out: []),
        "ppipe_body": (lambda: ops.ppipe_body(al, be, *T[:10]),
                       lambda: ref.fused_ppipe_body_ref(al, be, *T[:10]), "O" * 8,
                       lambda out: []),
        "fused_dots": (lambda: ops.fused_dots(*T[:3]), lambda: ref.fused_dots_ref(*T[:3]),
                       "PPP", lambda out: [(T[0], T[1]), (T[2], T[1]), (T[0], T[0])]),
        "bicgstab_update1": (lambda: ops.bicgstab_update1(al, om, *T[:6]),
                             lambda: ref.bicgstab_update1_ref(al, om, *T[:6]), "OOO",
                             lambda out: []),
        "bicgstab_spmv_dots": (lambda: ops.bicgstab_spmv_dots(xp, *T[:6], al, st),
                               lambda: ref.bicgstab_spmv_dots_ref(xp, *T[:6], al, stencil=st),
                               "OOO" + "P" * 9, bicg_pairs),
        "bicgstab_spmv_update": (
            lambda: ops.bicgstab_spmv_update(xp, *T[:6], om, be, st),
            lambda: ref.bicgstab_spmv_update_ref(xp, *T[:6], om, be, stencil=st), "OOOO",
            lambda out: []),
        "cheb_step": (lambda: ops.cheb_step(xp, r, d, st, a=s["a"], c=s["c"]),
                      lambda: ref.cheb_fused_step_ref(xp, r, d, stencil=st, a=s["a"],
                                                      c=s["c"]), "OO", lambda out: []),
        "jacobi_sweep": (lambda: ops.jacobi_sweep(xp, r, st, omega=om),
                         lambda: ref.block_jacobi_sweep_ref(xp, r, stencil=st, omega=om), "O",
                         lambda out: []),
        "axpbypcz": (lambda: ops.axpbypcz(al, T[0], be, T[1], c2, T[2]),
                     lambda: ref.fused_axpby_ref(al, T[0], be, T[1], c2, T[2]), "O",
                     lambda out: []),
        "axpbypcz_dot": (lambda: ops.axpbypcz_dot(al, T[0], be, T[1], c2, T[2], T[3]),
                         lambda: ref.fused_axpby_dot_ref(al, T[0], be, T[1], c2, T[2], T[3]),
                         "OP", lambda out: [(out[0], T[3])]),
        "cg_update": (lambda: ops.cg_update(be, *T[:4]),
                      lambda: ref.cg_fused_update_ref(be, *T[:4]), "OOP",
                      lambda out: [(out[1], out[0])]),
        "gs_half_sweep/0": (lambda: ops.gs_half_sweep(xp, r, st, 0),
                            lambda: ref.rb_gs_half_sweep_ref(xp, r, stencil=st, colour=0),
                            "O", lambda out: []),
        "gs_half_sweep/1": (lambda: ops.gs_half_sweep(xp, r, st, 1),
                            lambda: ref.rb_gs_half_sweep_ref(xp, r, stencil=st, colour=1),
                            "O", lambda out: []),
    }


BF16_WRAPPERS = list(_bf16_calls(None, None, None, None, None, [None] * 10))


def _flat(out) -> list:
    flat = []
    for o in (out if isinstance(out, tuple) else (out,)):
        flat += list(o) if isinstance(o, tuple) else [o]
    return flat


def _bf16_inputs(cuda, shape, seed=3):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x, r, d, *T = (torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)
                   for _ in range(13))
    return x, r, d, T


@pytest.mark.parametrize("wrapper", BF16_WRAPPERS)
@pytest.mark.parametrize("shape", SHAPES + [(128, 128, 128)], ids=str)
@pytest.mark.parametrize("st", ["7pt", "27pt"])
def test_bf16_kernels_match_plain(cuda, st, shape, wrapper):
    """Each bf16 kernel bitwise its plain version on the card, its partials
    f32, within 1e-5·Σ|a_i·b_i| and repeated bitwise, one launch a call."""
    x, r, d, T = _bf16_inputs(cuda, shape)
    call, plain, kinds, pairs = _bf16_calls(STENCILS[st], pad1(x), x, r, d, T)[wrapper]
    ops.reset_launches()
    out = call()
    again = call()
    assert sum(ops.LAUNCHES.values()) == 2
    got, want, rep = _flat(out), _flat(plain()), _flat(again)
    assert len(got) == len(want) == len(kinds)
    ab = iter(pairs(out))
    for g, w, g2, kind in zip(got, want, rep, kinds):
        assert torch.equal(g, g2)
        if kind == "P":
            a, b = next(ab)
            assert g.dtype == w.dtype == torch.float32
            bound = 1e-5 * float((a.double() * b.double()).abs().sum())
            assert abs(float(g) - float(w)) <= bound, (wrapper, float(g), float(w))
        else:
            assert g.dtype == torch.bfloat16 and g.shape == w.shape
            assert torch.equal(g, w), (wrapper, float((g.float() - w.float()).abs().max()))


@pytest.mark.parametrize("run", [8, 16, 32])
@pytest.mark.parametrize("form", ["padded", "zero_halo"])
@pytest.mark.parametrize("shape", SHAPES + RING_EDGES, ids=str)
@pytest.mark.parametrize("st", ["7pt", "27pt"])
def test_bf16_ring_runs_match_plain(cuda, st, shape, form, run):
    """Rows 1, 2 and 4 on the bf16 plane ring (its tiles staged through
    registers) in both operand forms and every run: y bitwise the plain
    version's."""
    stencil = STENCILS[st]
    x, r, _, _ = _bf16_inputs(cuda, shape, seed=run)
    xp = pad1(x)
    xin = x if form == "zero_halo" else xp
    kw = dict(zero_halo=form == "zero_halo", run=run)
    yr = ref.stencil_spmv_ref(xp, stencil=stencil)
    for y in (ops.spmv(xin, stencil, **kw), ops.spmv_dot(xin, stencil, **kw)[0],
              ops.spmv_dots(xin, stencil, **kw)[0], ops.spmv_dots3(xin, r, stencil, **kw)[0]):
        assert y.dtype == torch.bfloat16 and torch.equal(y, yr)


@pytest.mark.parametrize("lanes", BATCH_LANES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("st", ["7pt", "27pt"])
def test_bf16_batched_kernels_match_plain(cuda, st, shape, lanes):
    """Rows 1b, 16b and 17b in bf16: one launch over the lanes, bitwise the
    plain version on the 4-D operands and, lane by lane, the 3-D kernel."""
    stencil = STENCILS[st]
    s = BF16_SCALARS
    gen = torch.Generator(device=cuda).manual_seed(lanes)
    x, r, d = (torch.randn((lanes, *shape), generator=gen, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    xp = pad1(x)

    def calls(x, xp, r, d):
        return [ops.spmv(x, stencil, zero_halo=True), ops.spmv(xp, stencil),
                *ops.cheb_step(xp, r, d, stencil, a=s["a"], c=s["c"]),
                ops.jacobi_sweep(xp, r, stencil, omega=s["omega"])]

    ops.reset_launches()
    got = calls(x, xp, r, d)
    assert ops.LAUNCHES["stencil_spmv_batched"] == 2
    assert ops.LAUNCHES["cheb_fused_step_batched"] == 1
    assert ops.LAUNCHES["block_jacobi_sweep_batched"] == 1
    yr = ref.stencil_spmv_ref(xp, stencil=stencil)
    plain = [yr, yr, *ref.cheb_fused_step_ref(xp, r, d, stencil=stencil, a=s["a"], c=s["c"]),
             ref.block_jacobi_sweep_ref(xp, r, stencil=stencil, omega=s["omega"])]
    for g, p in zip(got, plain):
        assert g.dtype == torch.bfloat16 and torch.equal(g, p)
    for i in range(lanes):
        one = calls(*(t[i].contiguous() for t in (x, xp, r, d)))
        assert all(torch.equal(g[i], o) for g, o in zip(got, one))


#: shapes around bf16's pair stage: nz even (the pair stage) and odd (the
#: register stage), ragged ny and nx, nz below, at and above the 64-wide tile
PAIR_SHAPES = [(5, 7, 6), (9, 13, 70), (17, 6, 129), (33, 10, 64), (3, 5, 3), (6, 4, 130)]


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` at an odd element offset of a fresh buffer:
    two bytes past a 4-byte boundary for a 2-byte dtype."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 4 == (2 if t.element_size() == 2 else 0)
    return view


def _want_stage(xin: torch.Tensor, zero_halo: bool) -> str:
    from repro_torch.kernels import stencil_spmv
    nz = xin.shape[-1] - (0 if zero_halo else 2)
    return stencil_spmv.ring_stage(xin.dtype, nz, zero_halo, xin.data_ptr())


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("form", ["padded", "zero_halo"])
@pytest.mark.parametrize("shape", PAIR_SHAPES, ids=str)
@pytest.mark.parametrize("st", ["7pt", "27pt"])
def test_bf16_pair_stage_matches_plain(cuda, st, shape, form, aligned):
    """Rows 1, 2, 4 and bf16's block-Jacobi sweep (padded z) on the ring, at
    the stage its rule gives (the pair stage for nz even and an aligned
    operand, the register stage otherwise, ``card_ring_stage`` the mirror's
    answer): y and z' bitwise the plain version's, the partials f32 within
    1e-5·Σ|a_i·b_i| and repeated bitwise, one launch a call."""
    from repro_torch.kernels.stencil_spmv import card_ring_stage
    stencil = STENCILS[st]
    zero_halo = form == "zero_halo"
    x, r, _, _ = _bf16_inputs(cuda, shape, seed=shape[2])
    xp = pad1(x)
    xin = x if zero_halo else xp
    zin = xp
    if not aligned:
        xin, zin = _misaligned(xin), _misaligned(xp)
    stage = _want_stage(xin, zero_halo)
    assert stage == (("pair_unpadded" if zero_halo else "pair_padded")
                     if shape[2] % 2 == 0 and aligned else "register")
    assert card_ring_stage(xin, zero_halo=zero_halo) == stage
    assert card_ring_stage(zin) == _want_stage(zin, False)
    kw = dict(zero_halo=zero_halo)
    yr, dr = ref.stencil_spmv_dot_ref(xp, stencil=stencil)
    _, der, gar = ref.stencil_spmv_dots_ref(xp, stencil=stencil)
    _, *parts3r = ref.stencil_spmv_dots3_ref(xp, r, stencil=stencil)
    ops.reset_launches()
    y = ops.spmv(xin, stencil, **kw)
    y1, d1 = ops.spmv_dot(xin, stencil, **kw)
    y2, *parts2 = ops.spmv_dots(xin, stencil, **kw)
    y3, *parts3 = ops.spmv_dots3(xin, r, stencil, **kw)
    z = ops.jacobi_sweep(zin, r, stencil, omega=BF16_SCALARS["omega"])
    assert ops.LAUNCHES["stencil_spmv"] == 2 and ops.LAUNCHES["stencil_spmv_dots"] == 1
    assert ops.LAUNCHES["stencil_spmv_dots3"] == 1 and ops.LAUNCHES["block_jacobi_sweep"] == 1
    for out in (y, y1, y2, y3):
        assert out.dtype == torch.bfloat16 and torch.equal(out, yr)
    assert torch.equal(z, ref.block_jacobi_sweep_ref(xp, r, stencil=stencil,
                                                     omega=BF16_SCALARS["omega"]))
    assert torch.equal(z, ops.jacobi_sweep(zin, r, stencil, omega=BF16_SCALARS["omega"]))
    again = [ops.spmv_dot(xin, stencil, **kw)[1], *ops.spmv_dots(xin, stencil, **kw)[1:],
             *ops.spmv_dots3(xin, r, stencil, **kw)[1:]]
    got = [d1, *parts2, *parts3]
    want = [dr, der, gar, *parts3r]
    pairs = [(yr, x), (yr, x), (x, x), (yr, x), (r, x), (r, r)]
    for g, g2, w, (a, b) in zip(got, again, want, pairs):
        assert g.dtype == torch.float32 and torch.equal(g, g2)
        assert abs(float(g) - float(w)) <= 1e-5 * float((a.double() * b.double()).abs().sum())


@pytest.mark.parametrize("lanes", [1, 4, 8])
@pytest.mark.parametrize("shape", [(5, 7, 6), (9, 13, 70), (17, 6, 129)], ids=str)
@pytest.mark.parametrize("st", ["7pt", "27pt"])
def test_bf16_pair_stage_lanes_match_one_lane(cuda, st, shape, lanes):
    """Rows 1b, 16b and 17b in bf16 on the ring, B lanes in one launch (aligned,
    and the SpMV's unpadded batch also at an odd element offset): bitwise
    the plain version on the 4-D operands and, lane by lane, the one-lane
    launch; the 4-D operand takes its lanes' stage."""
    from repro_torch.kernels.stencil_spmv import card_ring_stage
    stencil = STENCILS[st]
    omega = BF16_SCALARS["omega"]
    gen = torch.Generator(device=cuda).manual_seed(7 * lanes)
    x, r = (torch.randn((lanes, *shape), generator=gen, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    xp = pad1(x)
    yr = ref.stencil_spmv_ref(xp, stencil=stencil)
    zr = ref.block_jacobi_sweep_ref(xp, r, stencil=stencil, omega=omega)
    for xin, zero_halo in ((x, True), (xp, False), (_misaligned(x), True)):
        assert card_ring_stage(xin, zero_halo=zero_halo) == _want_stage(xin, zero_halo)
        ops.reset_launches()
        y = ops.spmv(xin, stencil, zero_halo=zero_halo)
        assert ops.LAUNCHES["stencil_spmv_batched"] == 1 and torch.equal(y, yr)
        for i in range(lanes):
            assert torch.equal(y[i], ops.spmv(xin[i].contiguous(), stencil,
                                              zero_halo=zero_halo))
    ops.reset_launches()
    z = ops.jacobi_sweep(xp, r, stencil, omega=omega)
    assert ops.LAUNCHES["block_jacobi_sweep_batched"] == 1 and torch.equal(z, zr)
    assert torch.equal(z, ops.jacobi_sweep(xp, r, stencil, omega=omega))
    for i in range(lanes):
        assert torch.equal(z[i], ops.jacobi_sweep(xp[i].contiguous(), r[i].contiguous(),
                                                  stencil, omega=omega))
    a, c = BF16_SCALARS["a"], BF16_SCALARS["c"]
    ops.reset_launches()
    zc, dc = ops.cheb_step(xp, r, x, stencil, a=a, c=c)
    assert ops.LAUNCHES["cheb_fused_step_batched"] == 1
    zcr, dcr = ref.cheb_fused_step_ref(xp, r, x, stencil=stencil, a=a, c=c)
    assert torch.equal(zc, zcr) and torch.equal(dc, dcr)
    for i in range(lanes):
        one = ops.cheb_step(xp[i].contiguous(), r[i].contiguous(), x[i].contiguous(), stencil,
                            a=a, c=c)
        assert torch.equal(zc[i], one[0]) and torch.equal(dc[i], one[1])


@pytest.mark.parametrize("dt", [torch.float64, torch.float32, torch.bfloat16], ids=str)
def test_ring_stage_is_the_sources(cuda, dt):
    """``stencil_ring_stage`` of the built source answers as the mirror
    ``stencil_spmv.ring_stage`` for every nz parity, form and alignment:
    f64 and f32 copy elements, bf16 copies pairs when nz is even and the
    operand 4-byte aligned and stages through registers otherwise."""
    from repro_torch.kernels import stencil_spmv
    seen = set()
    for shape in PAIR_SHAPES + [(128, 128, 128)]:
        x = torch.zeros(shape, dtype=dt, device=cuda)
        for xin, zero_halo in ((x, True), (pad1(x), False), (_misaligned(x), True),
                               (_misaligned(pad1(x)), False)):
            got = stencil_spmv.card_ring_stage(xin, zero_halo=zero_halo)
            assert got == _want_stage(xin, zero_halo), (shape, zero_halo, xin.data_ptr() % 4)
            seen.add(got)
    assert seen == ({"async"} if dt != torch.bfloat16 else
                    {"register", "pair_padded", "pair_unpadded"})


#: the streams of the tails with a pair form, by position in their
#: wrappers' calls: ``ops.cheb_step(zp, r, d)``, ``ops.bicgstab_spmv_dots(zp,
#: z, r, w, s, rhat, t)``, ``ops.gs_half_sweep(xp, b, st, colour)`` and
#: ``ops.bicgstab_spmv_update(wp, w, r, p, s, z, v)``; None keeps every
#: stream aligned ("zs", the padded operand's grid, is not a stream)
PAIR_TAIL_STREAMS = {"cheb_step": [None, "r", "d"],
                     "bicgstab_spmv_dots": [None, "z", "r", "w", "s", "rhat", "t"],
                     "gs_half_sweep": [None, "b"],
                     "bicgstab_spmv_update": [None, "w", "r", "p", "s", "z", "v"]}


def _pair_tail_case(cuda, wrapper, shape, seed, misaligned=None, aliased=False):
    """(the wrapper's call and the plain version's, each of a stencil; the
    partials' operands; the operands the launch reads) for ``cheb_step``,
    ``bicgstab_spmv_dots``, ``gs_half_sweep/<colour>`` or
    ``bicgstab_spmv_update`` in bf16 at ``shape``: ``misaligned`` names one
    stream given at an odd element offset ("operand": the padded operand);
    ``aliased`` passes one tensor in several slots (Chebyshev's first step:
    d = z; BiCGStab's first iteration: r̂ = r, s = w, t = z in the dots pass,
    p = r, s = w in the update pass)."""
    s = BF16_SCALARS
    gen = torch.Generator(device=cuda).manual_seed(seed)
    vecs = {n: torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)
            for n in ("zs", "z", "r", "w", "s", "rhat", "t", "d", "b", "p", "v")}
    if aliased and wrapper == "cheb_step":
        vecs["d"] = vecs["z"]
    elif aliased and wrapper == "bicgstab_spmv_update":
        vecs.update(p=vecs["r"], s=vecs["w"])
    elif aliased:
        vecs.update(rhat=vecs["r"], s=vecs["w"], t=vecs["z"])
    if misaligned not in (None, "operand"):
        vecs[misaligned] = _misaligned(vecs[misaligned])
    xp = pad1(vecs["zs"])              # z̃ = M(z) when preconditioned: not z
    if misaligned == "operand":
        xp = _misaligned(xp)
    if wrapper.startswith("gs_half_sweep/"):
        colour, b = int(wrapper[-1]), vecs["b"]
        return (lambda st: ops.gs_half_sweep(xp, b, st, colour),
                lambda st: ref.rb_gs_half_sweep_ref(xp, b, stencil=st, colour=colour),
                lambda out: [], (xp, b))
    if wrapper == "bicgstab_spmv_update":
        U = [vecs[n] for n in ("w", "r", "p", "s", "z", "v")]
        om, be = (torch.tensor(s[n], dtype=torch.bfloat16, device=cuda)
                  for n in ("omega", "beta"))
        return (lambda st: ops.bicgstab_spmv_update(xp, *U, om, be, st),
                lambda st: ref.bicgstab_spmv_update_ref(xp, *U, om, be, stencil=st),
                lambda out: [], (xp, *U))
    if wrapper == "cheb_step":
        zp, r, d = pad1(vecs["z"]), vecs["r"], vecs["d"]
        return (lambda st: ops.cheb_step(zp, r, d, st, a=s["a"], c=s["c"]),
                lambda st: ref.cheb_fused_step_ref(zp, r, d, stencil=st, a=s["a"], c=s["c"]),
                lambda out: [], (zp, r, d))
    zp = xp
    T = [vecs[n] for n in ("z", "r", "w", "s", "rhat", "t")]
    al = s["alpha"]

    def pairs(out):
        v, q, y, _ = out
        rh, tt, z, sv = T[4], T[5], T[0], T[3]
        return [(q, y), (y, y), (q, q), (rh, q), (rh, y), (rh, tt), (rh, v), (rh, z), (rh, sv)]

    return (lambda st: ops.bicgstab_spmv_dots(zp, *T, al, st),
            lambda st: ref.bicgstab_spmv_dots_ref(zp, *T, al, stencil=st), pairs, (zp, *T))


#: the ring's ragged edges (``RING_EDGES``, nz odd: the register stage) and
#: the same with nz even (the pair stage)
PAIR_EDGES = RING_EDGES + [(nx, ny, nz + 1) for nx, ny, nz in RING_EDGES]


@pytest.mark.parametrize("misaligned", ["aligned", "stream", "operand"])
@pytest.mark.parametrize("aliased", [False, True], ids=["distinct", "aliased"])
@pytest.mark.parametrize("shape", PAIR_SHAPES + PAIR_EDGES + [(128, 128, 128)], ids=str)
@pytest.mark.parametrize("st", ["7pt", "27pt"])
@pytest.mark.parametrize("wrapper", ["cheb_step", "bicgstab_spmv_dots", "gs_half_sweep/0",
                                     "gs_half_sweep/1", "bicgstab_spmv_update"])
def test_bf16_pair_tails_match_plain(cuda, wrapper, st, shape, aliased, misaligned):
    """bf16's Chebyshev step, BiCGStab's two passes and the red-black
    half-sweep (both colours) on the ring, their tails' pair form on the
    pair stage (nz even, every stream aligned) and the scalar calls on the
    register stage (odd nz, ``RING_EDGES``' ragged runs, rows and columns
    among them; one stream at an odd element offset, each in turn; or the
    padded operand itself): outputs bitwise the plain version's (the
    half-sweep's other colour keeping its value), the nine partials f32
    within 1e-5·Σ|a_i·b_i| and repeated bitwise, one launch a call; with one
    tensor in several slots too (the half-sweep has one stream, so there it
    repeats the distinct case)."""
    if misaligned == "stream":
        streams = PAIR_TAIL_STREAMS[wrapper.split("/")[0]][1:]
    else:
        streams = [None if misaligned == "aligned" else "operand"]
    for k, name in enumerate(streams):
        call, plain, pairs, opnds = _pair_tail_case(cuda, wrapper, shape, 7 * k + len(shape),
                                                    misaligned=name, aliased=aliased)
        stencil = STENCILS[st]
        ops.reset_launches()
        out, again = call(stencil), call(stencil)
        assert sum(ops.LAUNCHES.values()) == 2
        got, want, rep = _flat(out), _flat(plain(stencil)), _flat(again)
        assert len(got) == len(want)
        ab = iter(pairs(out))
        for g, w, g2 in zip(got, want, rep):
            assert torch.equal(g, g2)
            if g.dim() == 0:
                a, b = next(ab)
                assert g.dtype == torch.float32
                assert abs(float(g) - float(w)) <= 1e-5 * float(
                    (a.double() * b.double()).abs().sum()), (wrapper, name)
            else:
                assert g.dtype == torch.bfloat16 and torch.equal(g, w), (wrapper, name)
        if wrapper.startswith("gs_half_sweep/"):
            other = ~_colour_mask(shape, int(wrapper[-1]), cuda)      # keeps its value
            assert torch.equal(got[0][other], opnds[0][1:-1, 1:-1, 1:-1][other])


def _ring_launches(fns) -> list[str]:
    """The names of the ``stencil_ring_kernel`` instances the calls ``fns``
    launch, in one ``torch.profiler`` window (one name each)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and "stencil_ring_kernel" in e.key]


@pytest.mark.parametrize("wrapper", ["cheb_step", "bicgstab_spmv_dots", "gs_half_sweep/0",
                                     "bicgstab_spmv_update"])
def test_bf16_pair_tails_take_their_stage(cuda, wrapper):
    """The launched instance (``torch.profiler``): the tail's pair stage
    from the padded operand (STAGE 2) with aligned streams and nz even, the
    register stage (STAGE 1) with a stream at an odd element offset or nz
    odd, as ``stencil_spmv.ring_stage`` mirrors with the streams; f64 and
    f32 launch ``stencil_kernel`` on the 7pt stencil (the half-sweep: f64
    27pt is on the ring, ``test_rb_gs_kernel_matches_plain``; f32's
    Chebyshev step takes its pair stage on 27pt alone,
    ``test_f32_sweeps_take_their_pass``), but f64's Chebyshev step, on the
    ring at both (``test_f64_sweeps_take_the_ring``)."""
    import re

    from repro_torch.kernels import stencil_spmv
    tail = {"cheb_step": "ChebTail<__nv_bfloat16>",
            "bicgstab_spmv_dots": "BicgDotsTail<__nv_bfloat16>",
            "gs_half_sweep/0": "RbGsTail<__nv_bfloat16>",
            "bicgstab_spmv_update": "BicgUpdateTail<__nv_bfloat16>"}[wrapper]
    last = PAIR_TAIL_STREAMS[wrapper.split("/")[0]][-1]
    for shape, name, want in (((9, 13, 70), None, "pair_padded"),
                              ((9, 13, 70), last, "register"),
                              ((9, 13, 71), None, "register")):
        call, _, _, opnds = _pair_tail_case(cuda, wrapper, shape, 3, misaligned=name)
        assert stencil_spmv.ring_stage(torch.bfloat16, shape[2], False, opnds[0].data_ptr(),
                                       streams=[o.data_ptr() for o in opnds[1:]]) == want
        names = _ring_launches([lambda: call(STENCILS["27pt"])])
        assert len(names) == 1 and tail in names[0], names
        m = re.search(re.escape(tail) + r"\s*,\s*(true|false)\s*,\s*(\d+)\s*,\s*(\d+)\s*>",
                      names[0])
        assert m is not None and int(m.group(2)) == stencil_spmv.RING_STAGES.index(want)
    x = torch.zeros((5, 7, 6), dtype=torch.float64, device=cuda)
    for dt in (torch.float64, torch.float32):
        xp = pad1(x.to(dt))
        r = x.to(dt)
        fn = {"cheb_step": lambda: ops.cheb_step(xp, r, r, STENCILS["7pt"], a=0.5, c=0.5),
              "bicgstab_spmv_dots": lambda: ops.bicgstab_spmv_dots(xp, *[r] * 6, 0.5,
                                                                   STENCILS["7pt"]),
              "gs_half_sweep/0": lambda: ops.gs_half_sweep(xp, r, STENCILS["7pt"], 0),
              "bicgstab_spmv_update": lambda: ops.bicgstab_spmv_update(
                  xp, *[r] * 6, 0.5, 0.5, STENCILS["7pt"])}[wrapper]
        names = _ring_launches([fn])
        if wrapper == "cheb_step" and dt == torch.float64:
            assert len(names) == 1 and "ChebTail<double>" in names[0], names
        else:
            assert names == []


def test_bicgstab_partials_follow_the_pass(cuda):
    """``bicgstab_partials_<sfx>`` of the built source: the ring's block
    count at kRingRunBicgDots in bf16, ``stencil_kernel``'s in f64 and f32
    (``bicgstab_fused.partial_slots`` sizes the scratch from it)."""
    import math

    from repro_torch.analysis import lint_kernels as lint
    from repro_torch.kernels import _build, bicgstab_fused
    lib = _build.load("bicgstab_fused", bicgstab_fused.SIGNATURES)
    run = lint.STENCIL_GEOMETRY["kRingRunBicgDots"]
    for shape in PAIR_SHAPES + [(128, 128, 128), (128, 128, 3072), (33, 9, 200)]:
        assert bicgstab_fused.partial_slots(lib, torch.bfloat16, shape) == math.prod(
            lint.stencil_ring_grid(shape, 1, run))
        for dt in (torch.float64, torch.float32):
            assert bicgstab_fused.partial_slots(lib, dt, shape) == math.prod(
                lint.stencil_grid(shape))


@pytest.mark.parametrize("off", [-1.0, 1.0, -0.4375, 0.75])
@pytest.mark.parametrize("form", ["padded", "zero_halo"])
@pytest.mark.parametrize("st", ["7pt", "27pt"])
def test_bf16_pair_stage_any_off_matches_plain(cuda, st, form, off):
    """The pair stage's two sums: one fma a neighbour term where off is ±1
    (off·x exact), a multiply and an add otherwise; both bitwise the plain
    version's for a stencil of the same offsets with that off-diagonal
    coefficient (diag 26, exact in bf16), SpMV and block-Jacobi alike."""
    from repro_torch.core.operators import Stencil
    base = STENCILS[st]
    stencil = Stencil(f"{st}_off", base.offsets, diag=26.0, off_coeff=off)
    zero_halo = form == "zero_halo"
    x, r, _, _ = _bf16_inputs(cuda, (9, 13, 70), seed=int(off * 16) + 40)
    xp = pad1(x)
    y = ops.spmv(x if zero_halo else xp, stencil, zero_halo=zero_halo)
    assert torch.equal(y, ref.stencil_spmv_ref(xp, stencil=stencil))
    z = ops.jacobi_sweep(xp, r, stencil, omega=BF16_SCALARS["omega"])
    assert torch.equal(z, ref.block_jacobi_sweep_ref(xp, r, stencil=stencil,
                                                     omega=BF16_SCALARS["omega"]))


#: shapes around f32's pair stage: the ring's ragged edges with nz even
#: (runs, rows and columns cut short), nz below, at and above the 64-wide
#: tile, and the rank block
F32_PAIR_SHAPES = ([(nx, ny, nz + 1) for nx, ny, nz in RING_EDGES]
                   + [(5, 7, 6), (9, 13, 70), (6, 4, 130), (128, 128, 128)])


def _f32_sweeps(cuda, shape, lanes, seed):
    """Seeded f32 operands of both sweeps (a batch of ``lanes`` when not
    None): the padded z, r, d, and the padded z again at a 4-byte offset
    (the old pass's launch on the same values)."""
    full = shape if lanes is None else (lanes, *shape)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    z, r, d = (torch.randn(full, generator=gen, device=cuda) for _ in range(3))
    zp = pad1(z)
    return zp, r, d, _misaligned(zp)


@pytest.mark.parametrize("lanes", [None, 1, 4, 8], ids=["one_lane", "B1", "B4", "B8"])
@pytest.mark.parametrize("shape", F32_PAIR_SHAPES, ids=str)
@pytest.mark.parametrize("st", ["7pt", "27pt"])
def test_f32_pair_stage_is_the_old_pass(cuda, st, shape, lanes):
    """f32 rows 16 and 17 (one lane) and 16b, 17b (B lanes) on the ring's f32
    pair stage (nz even, 8-byte aligned operands; the 7pt Chebyshev step
    stays on the old pass): each output bitwise the old pass's
    (``stencil_kernel``, which the same values at a 4-byte offset take) and
    the plain version's on the card, repeated bitwise, one launch a call;
    with d the same tensor as z (Chebyshev's first step) too."""
    stencil = STENCILS[st]
    zp, r, d, zm = _f32_sweeps(cuda, shape, lanes, seed=sum(shape) + (lanes or 0))
    z = zp[..., 1:-1, 1:-1, 1:-1].contiguous()
    a, c = 0.3719, 0.1137
    for dd in (d, z):
        ops.reset_launches()
        got = [*ops.cheb_step(zp, r, dd, stencil, a=a, c=c),
               ops.jacobi_sweep(zp, r, stencil, omega=0.8)]
        assert sum(ops.LAUNCHES.values()) == 2
        again = [*ops.cheb_step(zp, r, dd, stencil, a=a, c=c),
                 ops.jacobi_sweep(zp, r, stencil, omega=0.8)]
        old = [*ops.cheb_step(zm, r, dd, stencil, a=a, c=c),
               ops.jacobi_sweep(zm, r, stencil, omega=0.8)]
        plain = [*ref.cheb_fused_step_ref(zp, r, dd, stencil=stencil, a=a, c=c),
                 ref.block_jacobi_sweep_ref(zp, r, stencil=stencil, omega=0.8)]
        for g, g2, o, p in zip(got, again, old, plain):
            assert g.dtype == torch.float32
            assert torch.equal(g, o) and torch.equal(g, g2) and torch.equal(g, p)


@pytest.mark.parametrize("kernel", ["cheb_step", "jacobi_sweep"])
def test_f32_sweeps_take_their_pass(cuda, kernel):
    """The launched instance (``torch.profiler``): f32's sweep on the ring's
    pair stage from the padded operand (STAGE 2, fma terms) at nz even with
    aligned operands, one lane and 4 lanes; ``stencil_kernel`` with nz odd,
    the padded z at a 4-byte offset, r at a 4-byte offset, and (the
    Chebyshev step) on the 7pt stencil; ``precond.cheb_pass``/``jacobi_pass``
    and ``card_ring_stage`` say the same."""
    import re

    from repro_torch.kernels import precond, stencil_spmv
    tail, name = {"cheb_step": ("ChebTail<float>", "cheb_fused_step"),
                  "jacobi_sweep": ("JacobiTail<float>", "block_jacobi_sweep")}[kernel]
    mirror = precond.cheb_pass if kernel == "cheb_step" else precond.jacobi_pass
    for shape, lanes, odd, st, want in (
            ((9, 13, 70), None, None, "27pt", "pair_padded"),
            ((9, 13, 70), 4, None, "27pt", "pair_padded"),
            ((9, 13, 70), None, None, "7pt",
             "stencil" if kernel == "cheb_step" else "pair_padded"),
            ((9, 13, 71), None, None, "27pt", "stencil"),
            ((9, 13, 70), None, "operand", "27pt", "stencil"),
            ((9, 13, 70), None, "r", "27pt", "stencil")):
        zp, r, d, zm = _f32_sweeps(cuda, shape, lanes, seed=3)
        if odd == "operand":
            zp = zm
        elif odd == "r":
            r = _misaligned(r)
        stencil = STENCILS[st]
        if kernel == "cheb_step":
            def call():
                return ops.cheb_step(zp, r, d, stencil, a=0.5, c=0.25)
        else:
            def call():
                return ops.jacobi_sweep(zp, r, stencil)
        streams = (r.data_ptr(), d.data_ptr()) if kernel == "cheb_step" else (r.data_ptr(),)
        got = mirror(torch.float32, shape[2], zp.data_ptr(), streams, npoint=stencil.npoint)
        assert got == ("stencil" if want == "stencil" else "ring"), (shape, odd, st)
        if odd != "r":
            stage = stencil_spmv.card_ring_stage(zp, kernel=name)
            assert stage == stencil_spmv.ring_stage(torch.float32, shape[2], False,
                                                    zp.data_ptr(), kernel=name)
        names = _ring_launches([call])
        if want == "stencil":
            assert names == [], (shape, odd, st, names)
            continue
        assert len(names) == 1 and tail in names[0], (shape, lanes, odd, st, names)
        m = re.search(re.escape(tail) + r"\s*,\s*(true|false)\s*,\s*(\d+)\s*,\s*(\d+)\s*>",
                      names[0])
        assert m is not None and m.group(1) == "true"
        assert int(m.group(2)) == stencil_spmv.RING_STAGES.index(want)


@pytest.mark.parametrize("off", [-0.4375, 0.75])
@pytest.mark.parametrize("st", ["7pt", "27pt"])
def test_f32_pair_stage_any_off_matches_plain(cuda, st, off):
    """Where off is not ±1 f32's pair stage multiplies and adds a term (no
    fma): both sweeps bitwise the plain version's for a stencil of the same
    offsets with that off-diagonal coefficient (diag 26), and the old
    pass's."""
    from repro_torch.core.operators import Stencil
    base = STENCILS[st]
    stencil = Stencil(f"{st}_off", base.offsets, diag=26.0, off_coeff=off)
    zp, r, d, zm = _f32_sweeps(cuda, (9, 13, 70), None, seed=int(off * 16) + 40)
    for zin in (zp, zm):
        z = ops.jacobi_sweep(zin, r, stencil, omega=0.8)
        assert torch.equal(z, ref.block_jacobi_sweep_ref(zp, r, stencil=stencil, omega=0.8))
        got = ops.cheb_step(zin, r, d, stencil, a=0.375, c=0.125)
        want = ref.cheb_fused_step_ref(zp, r, d, stencil=stencil, a=0.375, c=0.125)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("kernel", ["cheb_fused_step", "block_jacobi_sweep", "stencil_spmv"])
def test_f32_ring_stage_is_the_sources(cuda, kernel):
    """``stencil_ring_stage`` of the built source for a kernel's f32 tail
    answers as the mirror ``stencil_spmv.ring_stage(kernel=)`` for every nz
    parity, form and alignment: the two sweeps' tails copy 8-byte pairs at
    nz even on an 8-byte aligned operand and elements otherwise, every other
    f32 tail copies elements."""
    from repro_torch.kernels import stencil_spmv
    seen = set()
    for shape in PAIR_SHAPES + [(128, 128, 128)]:
        x = torch.zeros(shape, dtype=torch.float32, device=cuda)
        for xin, zero_halo in ((x, True), (pad1(x), False), (_misaligned(x), True),
                               (_misaligned(pad1(x)), False)):
            nz = xin.shape[-1] - (0 if zero_halo else 2)
            got = stencil_spmv.card_ring_stage(xin, zero_halo=zero_halo, kernel=kernel)
            assert got == stencil_spmv.ring_stage(torch.float32, nz, zero_halo,
                                                  xin.data_ptr(), kernel=kernel)
            seen.add(got)
    assert seen == ({"async", "pair_padded", "pair_unpadded"}
                    if kernel in stencil_spmv.F32_PAIR_KERNELS else {"async"})


@pytest.mark.parametrize("lanes", [None, 4], ids=["one_lane", "lanes4"])
@pytest.mark.parametrize("st", ["7pt", "27pt"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_f64_sweeps_on_the_ring_match_plain(cuda, shape, st, lanes):
    """f64's Chebyshev step and block-Jacobi sweep on the ring from z
    unpadded and padded, bitwise the plain version's and the old pass's
    (``old_pass``, z padded by the wrapper), at ragged shapes, one lane and
    a batch."""
    from repro_torch.kernels import precond
    stencil = STENCILS[st]
    gen = torch.Generator(device=cuda).manual_seed(36)
    full = shape if lanes is None else (lanes, *shape)
    z, r, d = (torch.randn(full, generator=gen, dtype=torch.float64, device=cuda)
               for _ in range(3))
    zp = pad1(z)
    want = [*ref.cheb_fused_step_ref(zp, r, d, stencil=stencil, a=0.37, c=1.21),
            ref.block_jacobi_sweep_ref(zp, r, stencil=stencil, omega=0.9)]
    for zz, zh in ((z, True), (zp, False)):
        got = [*ops.cheb_step(zz, r, d, stencil, a=0.37, c=1.21, zero_halo=zh),
               ops.jacobi_sweep(zz, r, stencil, omega=0.9, zero_halo=zh)]
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    # the first step's aliased d is z
    got = ops.cheb_step(z, r, z, stencil, a=0.37, c=1.21, zero_halo=True)
    want_a = ref.cheb_fused_step_ref(zp, r, z.clone(), stencil=stencil, a=0.37, c=1.21)
    assert all(torch.equal(g, w) for g, w in zip(got, want_a))
    old = [*precond.cheb_fused_step(z, r, d, stencil=stencil, a=0.37, c=1.21,
                                    zero_halo=True, old_pass=True),
           precond.block_jacobi_sweep(z, r, stencil=stencil, omega=0.9, zero_halo=True,
                                      old_pass=True)]
    assert all(torch.equal(g, w) for g, w in zip(old, want))


@pytest.mark.parametrize("kernel", ["cheb_step", "jacobi_sweep"])
def test_f64_sweeps_take_the_ring(cuda, kernel):
    """The launched instance (``torch.profiler``): f64's sweep on the ring's
    element stage (STAGE 0, no fma) from z unpadded and padded, one lane and
    4 lanes, on both stencils; ``old_pass`` on ``stencil_kernel``."""
    import re

    from repro_torch.kernels import precond
    tail = {"cheb_step": "ChebTail<double>", "jacobi_sweep": "JacobiTail<double>"}[kernel]
    gen = torch.Generator(device=cuda).manual_seed(37)
    for lanes in (None, 4):
        full = (9, 13, 70) if lanes is None else (lanes, 9, 13, 70)
        z, r, d = (torch.randn(full, generator=gen, dtype=torch.float64, device=cuda)
                   for _ in range(3))
        for st in ("27pt", "7pt"):
            stencil = STENCILS[st]
            for zz in (z, pad1(z)):
                zh = zz is z
                if kernel == "cheb_step":
                    def call():
                        return ops.cheb_step(zz, r, d, stencil, a=0.5, c=0.25, zero_halo=zh)
                else:
                    def call():
                        return ops.jacobi_sweep(zz, r, stencil, zero_halo=zh)
                names = _ring_launches([call])
                assert len(names) == 1 and tail in names[0], (lanes, st, zh, names)
                m = re.search(r"<double, (\d+), repro::" + re.escape(tail)
                              + r"\s*,\s*(true|false)\s*,\s*(\d+)\s*,\s*(\d+)\s*>",
                              names[0])
                assert m is not None and int(m.group(1)) == stencil.npoint
                assert m.group(2) == "false" and int(m.group(3)) == 0
    if kernel == "cheb_step":
        def old():
            return precond.cheb_fused_step(z, r, d, stencil=STENCILS["27pt"], a=0.5, c=0.25,
                                           zero_halo=True, old_pass=True)
    else:
        def old():
            return precond.block_jacobi_sweep(z, r, stencil=STENCILS["27pt"],
                                              zero_halo=True, old_pass=True)
    assert _ring_launches([old]) == []
