"""The port's operators and problems on the CPU against the reference.

The plain stencil applies (``repro_torch.core.operators``) get the same
seeded numpy inputs as ``repro.core.operators``; f64 outputs agree within
rtol=atol=1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import x64  # noqa: F401  (fixture)
from test_torch_harness import ref_module, seeded, to_np

from repro_torch.core import operators as T
from repro_torch.core.problems import as_torch_dtype, from_reference, make_problem

TOL = dict(rtol=1e-12, atol=1e-12)
SHAPES = [(8, 8, 8), (12, 10, 16)]


@pytest.fixture(scope="module")
def jop(x64):
    return ref_module("core.operators")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("st", ["7pt", "27pt"])
def test_stencil_applies_match_reference(jop, st, shape):
    x = seeded(shape, 1)
    xp = np.pad(x, 1)
    tst, jst = T.STENCILS[st], jop.STENCILS[st]
    assert (tst.offsets, tst.diag, tst.off_coeff, tst.npoint, tst.nbar) == \
        (jst.offsets, jst.diag, jst.off_coeff, jst.npoint, jst.nbar)
    np.testing.assert_allclose(to_np(tst.matvec_padded(torch.from_numpy(xp))),
                               to_np(jst.matvec_padded(jnp.asarray(xp))), **TOL)
    np.testing.assert_allclose(to_np(tst.matvec(torch.from_numpy(x))),
                               to_np(jst.matvec(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(to_np(tst.offdiag_apply_padded(torch.from_numpy(xp))),
                               to_np(jst.offdiag_apply_padded(jnp.asarray(xp))), **TOL)
    for k in (0, shape[2] // 2, shape[2] - 1):
        np.testing.assert_allclose(
            to_np(tst.plane_offdiag_apply(torch.from_numpy(xp), k)),
            to_np(jst.plane_offdiag_apply(jnp.asarray(xp), k)), **TOL)


@pytest.mark.parametrize("st", ["7pt", "27pt"])
def test_dense_matrix_matches_reference(jop, st):
    shape = (3, 4, 5)
    A = T.build_dense_from_stencil(T.STENCILS[st], shape)
    np.testing.assert_array_equal(A, jop.build_dense_from_stencil(jop.STENCILS[st], shape))
    x = seeded(shape, 2)
    np.testing.assert_allclose(A @ x.reshape(-1),
                               to_np(T.STENCILS[st].matvec(torch.from_numpy(x))).reshape(-1),
                               **TOL)


def test_touched_elements_match_reference(jop):
    for m in ("cg", "cg_nb", "bicgstab", "bicgstab_b1", "cg_merged", "jacobi",
              "gauss_seidel", "gauss_seidel_rb", "pcg", "pbicgstab", "cg_pipe",
              "pcg_merged", "pcg_pipe", "bicgstab_merged", "pbicgstab_merged"):
        for nbar in (7, 27):
            assert T.touched_elements_per_iter(m, nbar) == \
                jop.touched_elements_per_iter(m, nbar), m


@pytest.mark.parametrize("st", ["7pt", "27pt"])
def test_problem_matches_reference(x64, st):
    jprob = ref_module("core.problems").make_problem((6, 7, 8), st)
    prob = make_problem((6, 7, 8), st, dtype=torch.float64, device="cpu")
    assert prob.rows == jprob.rows and prob.shape == jprob.shape
    np.testing.assert_allclose(to_np(prob.b()), to_np(jprob.b()), **TOL)
    np.testing.assert_array_equal(to_np(prob.x0()), to_np(jprob.x0()))
    np.testing.assert_array_equal(to_np(prob.x_true()), to_np(jprob.x_true()))


def test_from_reference_carries_state(x64):
    """The function that carries state across: the reference problem's
    description and arrays become the port's problem, unchanged."""
    jprob = ref_module("core.problems").make_problem((5, 6, 7), "27pt")
    b, x0 = seeded(jprob.shape, 3), seeded(jprob.shape, 4)
    prob = from_reference(jprob.stencil.name, jprob.shape, np.dtype(jprob.dtype),
                          b=b, x0=x0, device="cpu")
    assert prob.stencil == T.STENCIL_27PT and prob.dtype == torch.float64
    assert prob.device == torch.device("cpu")
    np.testing.assert_array_equal(to_np(prob.b()), b)
    np.testing.assert_array_equal(to_np(prob.x0()), x0)
    plain = from_reference("7pt", (4, 4, 4), "float32", device="cpu")
    assert plain.b_data is None and plain.dtype == torch.float32
    with pytest.raises(ValueError):
        from_reference("7pt", (4, 4, 4), np.float64, b=np.zeros((4, 4, 5)),
                       device="cpu")


def test_dtype_and_stencil_validation():
    assert as_torch_dtype(np.float32) is torch.float32
    assert as_torch_dtype(jnp.float64) is torch.float64
    with pytest.raises(TypeError):
        as_torch_dtype(np.int32)
    with pytest.raises(ValueError):
        make_problem((4, 4, 4), "9pt", device="cpu")
