"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: every test skips where ``torch.cuda.is_available()`` is
False.  The file imports neither JAX nor the reference, so it runs on a
machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -p no:cacheprovider --noconftest -m gpu \
        tests/test_torch_cuda.py

Tolerances are the CPU tests' (outputs 1e-12 f64 / 1e-5 f32; partials rtol
1e-11 / 1e-4); the partials must also be bitwise equal from run to run.
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


def test_kernel_rejects_mixed_devices(cuda):
    v = torch.zeros((4, 4, 4), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        ops.cg_body(0.5, 0.5, v, v, v, v, v.cpu())
