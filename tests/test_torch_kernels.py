"""The port's kernel layer on the CPU against the JAX kernels.

On CPU tensors each ``repro_torch.kernels.ops`` wrapper runs its kernel's
plain PyTorch version; the reference runs its Pallas kernels in interpret
mode (as ``tests/test_kernels.py`` does).  Both get the same numpy inputs.
Tolerances: outputs rtol=atol=1e-12 in f64 and 1e-5 in f32; the dot partials
rtol 1e-11 in f64 and 1e-4 in f32, because the two sum in different orders.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import x64  # noqa: F401  (fixture)
from test_torch_harness import ref_module, seeded, to_np

from repro_torch.core.operators import STENCILS, pad1
from repro_torch.core.solvers import LocalOp
from repro_torch.kernels import ops
from repro_torch.kernels.kernel_op import KernelOp

SHAPES = [(8, 8, 8), (12, 10, 16), (16, 16, 16)]
DTYPES = [np.float64, np.float32]
STENCIL_NAMES = ["7pt", "27pt"]


def out_tols(dt):
    return dict(rtol=1e-12, atol=1e-12) if dt == np.float64 else dict(rtol=1e-5, atol=1e-5)


def partial_rtol(dt):
    return 1e-11 if dt == np.float64 else 1e-4


def _padded(shape, seed, dt):
    xp = np.pad(seeded(shape, seed, dt), 1)
    return xp, jnp.asarray(xp), torch.from_numpy(xp)


@pytest.fixture(scope="module")
def jref(x64):
    return ref_module("kernels.ops"), ref_module("core.operators").STENCILS


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("st", STENCIL_NAMES)
def test_spmv_matches_reference(jref, st, shape, dt):
    jops, jst = jref
    _, xj, xt = _padded(shape, 1, dt)
    y = ops.spmv(xt, STENCILS[st])
    assert y.dtype == xt.dtype and tuple(y.shape) == shape
    np.testing.assert_allclose(to_np(y), to_np(jops.spmv(xj, jst[st])), **out_tols(dt))


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("st", STENCIL_NAMES)
def test_spmv_dot_matches_reference(jref, st, shape, dt):
    jops, jst = jref
    _, xj, xt = _padded(shape, 2, dt)
    y, d = ops.spmv_dot(xt, STENCILS[st])
    yr, dr = jops.spmv_dot(xj, jst[st])
    np.testing.assert_allclose(to_np(y), to_np(yr), **out_tols(dt))
    np.testing.assert_allclose(float(d), float(dr), rtol=partial_rtol(dt))


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("st", STENCIL_NAMES)
def test_spmv_dots_matches_reference(jref, st, shape, dt):
    jops, jst = jref
    _, xj, xt = _padded(shape, 3, dt)
    w, delta, gamma = ops.spmv_dots(xt, STENCILS[st])
    wr, deltar, gammar = jops.spmv_dots(xj, jst[st])
    np.testing.assert_allclose(to_np(w), to_np(wr), **out_tols(dt))
    np.testing.assert_allclose(float(delta), float(deltar), rtol=partial_rtol(dt))
    np.testing.assert_allclose(float(gamma), float(gammar), rtol=partial_rtol(dt))


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_cg_body_matches_reference(jref, shape, dt):
    jops, _ = jref
    vecs = [seeded(shape, 10 + i, dt) for i in range(5)]
    alpha, beta = dt(0.37), dt(-0.21)
    out = ops.cg_body(torch.tensor(alpha), torch.tensor(beta),
                      *(torch.from_numpy(v) for v in vecs))
    outr = jops.cg_body(jnp.asarray(alpha), jnp.asarray(beta),
                        *(jnp.asarray(v) for v in vecs))
    for o, orf in zip(out, outr):
        assert o.dtype == torch.from_numpy(vecs[0]).dtype
        np.testing.assert_allclose(to_np(o), to_np(orf), **out_tols(dt))


@pytest.mark.parametrize("st", STENCIL_NAMES)
def test_kernel_op_matches_pallas_op(jref, st):
    """``KernelOp`` on CPU tensors (its plain versions) against the
    reference's ``PallasOp`` hooks on the same inputs."""
    _, jst = jref
    PallasOp = ref_module("kernels.pallas_op").PallasOp
    JLocalOp = ref_module("core.solvers").LocalOp
    pop = PallasOp(JLocalOp(jst[st]), bz=8)
    kop = KernelOp(LocalOp(STENCILS[st]))
    shape = (12, 10, 16)
    r = seeded(shape, 20, np.float64)
    w, delta, gamma = kop.spmv_dots(torch.from_numpy(r))
    wr, deltar, gammar = pop.spmv_dots(jnp.asarray(r))
    np.testing.assert_allclose(to_np(w), to_np(wr), **out_tols(np.float64))
    np.testing.assert_allclose(float(delta), float(deltar), rtol=1e-11)
    np.testing.assert_allclose(float(gamma), float(gammar), rtol=1e-11)
    np.testing.assert_allclose(to_np(kop.matvec(torch.from_numpy(r))),
                               to_np(pop.matvec(jnp.asarray(r))),
                               **out_tols(np.float64))
    vecs = [seeded(shape, 30 + i, np.float64) for i in range(5)]
    out = kop.cg_body(torch.tensor(0.5), torch.tensor(0.25),
                      *(torch.from_numpy(v) for v in vecs))
    outr = pop.cg_body(jnp.asarray(0.5), jnp.asarray(0.25),
                       *(jnp.asarray(v) for v in vecs))
    for o, orf in zip(out, outr):
        np.testing.assert_allclose(to_np(o), to_np(orf), **out_tols(np.float64))
    assert kop.diag == pop.diag and kop.stencil.name == pop.stencil.name


def test_cpu_path_counts_no_launches():
    ops.reset_launches()
    xp = pad1(torch.ones((4, 4, 4), dtype=torch.float64))
    ops.spmv(xp, STENCILS["7pt"])
    ops.spmv_dots(xp, STENCILS["27pt"])
    assert all(v == 0 for v in ops.LAUNCHES.values())


@pytest.mark.parametrize("bad", ["dtype", "device", "shape", "contiguity"])
def test_wrappers_reject_bad_inputs(bad):
    st = STENCILS["27pt"]
    xp = pad1(torch.ones((4, 5, 6), dtype=torch.float64))
    if bad == "dtype":
        xp, exc = xp.to(torch.int64), TypeError
    elif bad == "device":
        xp, exc = torch.empty(xp.shape, dtype=torch.float64, device="meta"), ValueError
    elif bad == "shape":
        xp, exc = xp[0], ValueError
    else:
        xp, exc = xp.transpose(0, 2), ValueError
    with pytest.raises(exc):
        ops.spmv(xp, st)
    with pytest.raises(exc):
        ops.spmv_dots(xp, st)


def test_cg_body_rejects_mismatched_operands():
    v = torch.zeros((4, 4, 4), dtype=torch.float64)
    with pytest.raises(ValueError):
        ops.cg_body(0.5, 0.5, v, v, v, v, torch.zeros((4, 4, 5), dtype=torch.float64))
    with pytest.raises(ValueError):
        ops.cg_body(0.5, 0.5, v, v, v, v, v.to(torch.float32))


def test_kernel_build_is_lazy():
    """Importing every module of the port builds and loads nothing (a fresh
    interpreter, so earlier launches in this process cannot interfere); the
    build directory is keyed by the sources."""
    from repro_torch.kernels import _build
    probe = ("import pkgutil, importlib, repro_torch\n"
             "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
             "    importlib.import_module(m.name)\n"
             "from repro_torch.kernels import _build\n"
             "print(len(_build._LIBS), _build.build_dir().exists())\n")
    env = dict(os.environ, PYTHONPATH=str(Path(_build.__file__).parents[2]))
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, env=env, timeout=120, check=True).stdout
    assert out.split()[0] == "0"
    names = {s.stem for s in _build.sources()}
    assert names == {"stencil_spmv", "spmv_dot", "cg_fused_update"}
    assert _build.build_dir().parent == _build.BUILD_ROOT
