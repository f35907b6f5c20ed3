"""The port's kernel layer on the CPU against the JAX kernels.

On CPU tensors each ``repro_torch.kernels.ops`` wrapper runs its kernel's
plain PyTorch version; the reference runs its Pallas kernels in interpret
mode (as ``tests/test_kernels.py`` does).  Both get the same numpy inputs.
Tolerances: outputs rtol=atol=1e-12 in f64 and 1e-5 in f32; the dot partials
rtol 1e-11 in f64 and 1e-4 in f32, because the two sum in different orders.
The preconditioner sweeps (``cheb_step``, ``jacobi_sweep``) use the reference
tests' ``KTOLS``: rtol=atol=1e-12 in f64, rtol 1e-4/atol 1e-5 in f32.
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
from test_torch_harness import ref_api, ref_module, seeded, to_np

from repro_torch.core.operators import STENCILS, pad1
from repro_torch.core.solvers import LocalOp
from repro_torch.kernels import ops, ref
from repro_torch.kernels.kernel_op import KernelOp

SHAPES = [(8, 8, 8), (12, 10, 16), (16, 16, 16)]
#: the shapes of the kernels added with the preconditioned solve (ragged)
PRECOND_SHAPES = [(12, 10, 16), (9, 7, 5)]
DTYPES = [np.float64, np.float32]
STENCIL_NAMES = ["7pt", "27pt"]


def out_tols(dt):
    return dict(rtol=1e-12, atol=1e-12) if dt == np.float64 else dict(rtol=1e-5, atol=1e-5)


def partial_rtol(dt):
    return 1e-11 if dt == np.float64 else 1e-4


def ktols(dt):
    """``KTOLS`` of ``tests/test_precond.py``."""
    return dict(rtol=1e-12, atol=1e-12) if dt == np.float64 else dict(rtol=1e-4, atol=1e-5)


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


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", PRECOND_SHAPES, ids=str)
@pytest.mark.parametrize("st", STENCIL_NAMES)
def test_spmv_dots3_matches_reference(jref, st, shape, dt):
    jops, jst = jref
    _, xj, xt = _padded(shape, 4, dt)
    r = seeded(shape, 5, dt)
    y, yx, rx, rr = ops.spmv_dots3(xt, torch.from_numpy(r), STENCILS[st])
    yr, yxr, rxr, rrr = jops.spmv_dots3(xj, jnp.asarray(r), jst[st])
    assert y.dtype == xt.dtype and tuple(y.shape) == shape
    np.testing.assert_allclose(to_np(y), to_np(yr), **out_tols(dt))
    for got, want in ((yx, yxr), (rx, rxr), (rr, rrr)):   # slot order (y·x, r·x, r·r)
        np.testing.assert_allclose(float(got), float(want), rtol=partial_rtol(dt))


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", PRECOND_SHAPES, ids=str)
def test_pcg_body_matches_reference(jref, shape, dt):
    jops, _ = jref
    vecs = [seeded(shape, 40 + i, dt) for i in range(6)]
    alpha, beta = dt(0.37), dt(-0.21)
    out = ops.pcg_body(torch.tensor(alpha), torch.tensor(beta),
                       *(torch.from_numpy(v) for v in vecs))
    outr = jops.pcg_body(jnp.asarray(alpha), jnp.asarray(beta),
                         *(jnp.asarray(v) for v in vecs))
    assert len(out) == 4
    for o, orf in zip(out, outr):
        assert o.dtype == torch.from_numpy(vecs[0]).dtype
        np.testing.assert_allclose(to_np(o), to_np(orf), **ktols(dt))


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", PRECOND_SHAPES, ids=str)
@pytest.mark.parametrize("st", STENCIL_NAMES)
def test_cheb_step_matches_reference(jref, st, shape, dt):
    jops, jst = jref
    _, zj, zt = _padded(shape, 6, dt)
    r, d = seeded(shape, 7, dt), seeded(shape, 8, dt)
    zn, dn = ops.cheb_step(zt, torch.from_numpy(r), torch.from_numpy(d),
                           STENCILS[st], a=0.37, c=1.21)
    znr, dnr = jops.cheb_step(zj, jnp.asarray(r), jnp.asarray(d), jst[st],
                              a=0.37, c=1.21)
    np.testing.assert_allclose(to_np(zn), to_np(znr), **ktols(dt))
    np.testing.assert_allclose(to_np(dn), to_np(dnr), **ktols(dt))


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", PRECOND_SHAPES, ids=str)
@pytest.mark.parametrize("st", STENCIL_NAMES)
def test_jacobi_sweep_matches_reference(jref, st, shape, dt):
    jops, jst = jref
    _, zj, zt = _padded(shape, 9, dt)
    r = seeded(shape, 10, dt)
    z = ops.jacobi_sweep(zt, torch.from_numpy(r), STENCILS[st], omega=0.9)
    zr = jops.jacobi_sweep(zj, jnp.asarray(r), jst[st], omega=0.9)
    np.testing.assert_allclose(to_np(z), to_np(zr), **ktols(dt))


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
    u = seeded(shape, 21, np.float64)
    y, yx, rx, rr = kop.spmv_dots3(torch.from_numpy(u), torch.from_numpy(r))
    yr, yxr, rxr, rrr = pop.spmv_dots3(jnp.asarray(u), jnp.asarray(r))
    np.testing.assert_allclose(to_np(y), to_np(yr), **out_tols(np.float64))
    for got, want in ((yx, yxr), (rx, rxr), (rr, rrr)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-11)
    vecs = [seeded(shape, 50 + i, np.float64) for i in range(6)]
    out = kop.pcg_body(torch.tensor(0.5), torch.tensor(0.25),
                       *(torch.from_numpy(v) for v in vecs))
    outr = pop.pcg_body(jnp.asarray(0.5), jnp.asarray(0.25),
                        *(jnp.asarray(v) for v in vecs))
    for o, orf in zip(out, outr):
        np.testing.assert_allclose(to_np(o), to_np(orf), **out_tols(np.float64))
    assert kop.diag == pop.diag and kop.stencil.name == pop.stencil.name


def test_cpu_path_counts_no_launches():
    ops.reset_launches()
    xp = pad1(torch.ones((4, 4, 4), dtype=torch.float64))
    v = torch.ones((4, 4, 4), dtype=torch.float64)
    ops.spmv(xp, STENCILS["7pt"])
    ops.spmv_dots(xp, STENCILS["27pt"])
    ops.spmv_dots3(xp, v, STENCILS["27pt"])
    ops.pcg_body(0.5, 0.5, v, v, v, v, v, v)
    ops.cheb_step(xp, v, v, STENCILS["7pt"], a=0.5, c=0.5)
    ops.jacobi_sweep(xp, v, STENCILS["7pt"])
    ops.fused_dots(v, v, v)
    ops.pipe_body(0.5, 0.5, *([v] * 7))
    ops.ppipe_body(0.5, 0.5, *([v] * 10))
    ops.bicgstab_spmv_dots(xp, *([v] * 6), 0.5, STENCILS["27pt"])
    ops.bicgstab_update1(0.5, 0.5, *([v] * 6))
    ops.bicgstab_spmv_update(xp, *([v] * 6), 0.5, 0.5, STENCILS["7pt"])
    assert {"fused_dots", "fused_pipe_body", "fused_ppipe_body", "bicgstab_fused_spmv_dots",
            "bicgstab_fused_update1", "bicgstab_fused_spmv_update"} <= set(ops.LAUNCHES)
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
    # an unpadded operand that fits, so the padded one is what is rejected
    r = torch.ones(tuple(n - 2 for n in xp.shape) if xp.dim() == 3 else (4, 5, 6),
                   dtype=torch.float64)
    if bad in ("dtype", "device"):
        r = torch.empty(r.shape, dtype=xp.dtype, device=xp.device)
    with pytest.raises(exc):
        ops.spmv_dots3(xp, r, st)
    with pytest.raises(exc):
        ops.cheb_step(xp, r, r, st, a=0.5, c=0.5)
    with pytest.raises(exc):
        ops.jacobi_sweep(xp, r, st)


def test_precond_wrappers_reject_mismatched_operands():
    """The unpadded operands must match the padded operand's interior, and
    the vectors of ``pcg_body`` one shape and dtype."""
    st = STENCILS["7pt"]
    xp = pad1(torch.ones((4, 5, 6), dtype=torch.float64))
    r = torch.ones((4, 5, 6), dtype=torch.float64)
    bad = torch.ones((4, 5, 7), dtype=torch.float64)
    with pytest.raises(ValueError):
        ops.spmv_dots3(xp, bad, st)
    with pytest.raises(ValueError):
        ops.cheb_step(xp, r, bad, st, a=0.5, c=0.5)
    with pytest.raises(ValueError):
        ops.jacobi_sweep(xp, bad, st)
    with pytest.raises(ValueError):
        ops.spmv_dots3(xp, r.to(torch.float32), st)
    with pytest.raises(ValueError):
        ops.pcg_body(0.5, 0.5, r, r, r, r, r, bad)
    with pytest.raises(ValueError):
        ops.pcg_body(0.5, 0.5, r, r, r, r, r, r.to(torch.float32))


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
    assert names == {"stencil_spmv", "spmv_dot", "cg_fused_update",
                     "fused_bodies", "precond", "bicgstab_fused",
                     "fused_axpby", "rb_gs", "flash_attention"}
    assert _build.build_dir().parent == _build.BUILD_ROOT


# --- the zero-halo entries: the operand unpadded, the halo made in the kernel


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", SHAPES + PRECOND_SHAPES[1:], ids=str)
@pytest.mark.parametrize("st", STENCIL_NAMES)
def test_zero_halo_entries_match_reference(jref, st, shape, dt):
    """``spmv`` and its ``fuse_dot`` form, ``spmv_dots`` and ``spmv_dots3`` on
    the unpadded ``x`` against the reference's kernels on ``jnp.pad(x, 1)``."""
    jops, jst = jref
    x, r = seeded(shape, 11, dt), seeded(shape, 12, dt)
    xt, xj = torch.from_numpy(x), jnp.pad(jnp.asarray(x), 1)
    y = ops.spmv(xt, STENCILS[st], zero_halo=True)
    assert y.dtype == xt.dtype and tuple(y.shape) == shape
    np.testing.assert_allclose(to_np(y), to_np(jops.spmv(xj, jst[st])), **out_tols(dt))
    y1, d = ops.spmv_dot(xt, STENCILS[st], zero_halo=True)
    yr, dr = jops.spmv_dot(xj, jst[st])
    np.testing.assert_allclose(to_np(y1), to_np(yr), **out_tols(dt))
    np.testing.assert_allclose(float(d), float(dr), rtol=partial_rtol(dt))
    y2, yx2, xx = ops.spmv_dots(xt, STENCILS[st], zero_halo=True)
    y2r, yx2r, xxr = jops.spmv_dots(xj, jst[st])
    np.testing.assert_allclose(to_np(y2), to_np(y2r), **out_tols(dt))
    for got, want in ((yx2, yx2r), (xx, xxr)):
        np.testing.assert_allclose(float(got), float(want), rtol=partial_rtol(dt))
    y3, yx, rx, rr = ops.spmv_dots3(xt, torch.from_numpy(r), STENCILS[st], zero_halo=True)
    y3r, yxr, rxr, rrr = jops.spmv_dots3(xj, jnp.asarray(r), jst[st])
    np.testing.assert_allclose(to_np(y3), to_np(y3r), **out_tols(dt))
    for got, want in ((yx, yxr), (rx, rxr), (rr, rrr)):
        np.testing.assert_allclose(float(got), float(want), rtol=partial_rtol(dt))


@pytest.mark.parametrize("dt", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("st", STENCIL_NAMES)
def test_zero_halo_plain_form_is_the_padded_form(st, dt):
    """On the CPU each zero-halo entry is its plain version on ``pad1(x)``:
    bitwise equal to the padded entry, outputs and partials."""
    gen = torch.Generator().manual_seed(13)
    x, r = (torch.randn((9, 7, 5), generator=gen, dtype=dt) for _ in range(2))
    stencil = STENCILS[st]
    assert torch.equal(ops.spmv(x, stencil, zero_halo=True), ops.spmv(pad1(x), stencil))
    for got, want in ((ops.spmv_dot(x, stencil, zero_halo=True), ops.spmv_dot(pad1(x), stencil)),
                      (ops.spmv_dots(x, stencil, zero_halo=True),
                       ops.spmv_dots(pad1(x), stencil)),
                      (ops.spmv_dots3(x, r, stencil, zero_halo=True),
                       ops.spmv_dots3(pad1(x), r, stencil))):
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_zero_halo_entries_reject_bad_operands():
    st = STENCILS["27pt"]
    x = torch.ones((4, 5, 6), dtype=torch.float64)
    for bad in (x[0], torch.ones((0, 5, 6), dtype=torch.float64)):
        with pytest.raises(ValueError):
            ops.spmv(bad, st, zero_halo=True)
        with pytest.raises(ValueError):
            ops.spmv_dot(bad, st, zero_halo=True)
        with pytest.raises(ValueError):
            ops.spmv_dots(bad, st, zero_halo=True)
    with pytest.raises(ValueError):            # r must have x's shape
        ops.spmv_dots3(x, torch.ones((4, 5, 7), dtype=torch.float64), st, zero_halo=True)
    with pytest.raises(ValueError):            # ...not its padded one
        ops.spmv_dots3(pad1(x), x, st, zero_halo=True)


class _Spy:
    """Records the ``zero_halo`` flag of every ``ops.spmv``/``ops.spmv_dots``/
    ``ops.spmv_dots3`` call, then calls through."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("spmv", "spmv_dots", "spmv_dots3"):
            real = getattr(ops, name)

            def spy(*args, _name=name, _real=real, zero_halo=False, **kw):
                self.calls.append((_name, zero_halo))
                return _real(*args, zero_halo=zero_halo, **kw)

            monkeypatch.setattr(ops, name, spy)


class _HaloOp(LocalOp):
    """A base whose halo is not the zero pad: every halo cell holds 0.5."""

    def pad_exchange(self, x):
        return torch.nn.functional.pad(x, (1, 1, 1, 1, 1, 1), value=0.5)


@pytest.mark.parametrize("st", STENCIL_NAMES)
def test_kernel_op_routes_by_halo(monkeypatch, st):
    """On a ``LocalOp`` base ``matvec``, ``matvec_local``, ``spmv_dots`` and
    ``spmv_dots3`` take the zero-halo entries (no pad pass) and give what the
    padded entries give on ``pad1(x)``; on a base whose ``pad_exchange`` fills
    a real halo, ``matvec``, ``spmv_dots`` and ``spmv_dots3`` still pad and
    give ``A·pad_exchange(x)``, while ``matvec_local`` keeps the zero halo."""
    stencil = STENCILS[st]
    x = torch.from_numpy(seeded((9, 7, 5), 14, np.float64))
    r = torch.from_numpy(seeded((9, 7, 5), 15, np.float64))
    spy = _Spy(monkeypatch)
    kop = KernelOp(LocalOp(stencil))
    assert kop.zero_halo
    y, y_local, (y3, *parts) = kop.matvec(x), kop.matvec_local(x), kop.spmv_dots3(x, r)
    assert spy.calls == [("spmv", True), ("spmv", True), ("spmv_dots3", True)]
    want = stencil.matvec_padded(pad1(x))
    assert torch.equal(y, want) and torch.equal(y_local, want) and torch.equal(y3, want)
    want_parts = ref.stencil_spmv_dots3_ref(pad1(x), r, stencil=stencil)[1:]
    assert all(torch.equal(g, w) for g, w in zip(parts, want_parts))
    spy.calls.clear()
    y2, *parts2 = kop.spmv_dots(x)
    assert spy.calls == [("spmv_dots", True)] and torch.equal(y2, want)
    want_parts2 = ref.stencil_spmv_dots_ref(pad1(x), stencil=stencil)[1:]
    assert all(torch.equal(g, w) for g, w in zip(parts2, want_parts2))

    spy.calls.clear()
    halo = KernelOp(_HaloOp(stencil))
    assert not halo.zero_halo
    y, y_local, (y3, *parts) = halo.matvec(x), halo.matvec_local(x), halo.spmv_dots3(x, r)
    assert spy.calls == [("spmv", False), ("spmv", True), ("spmv_dots3", False)]
    xh = _HaloOp(stencil).pad_exchange(x)
    assert not torch.equal(stencil.matvec_padded(xh), want)      # the halo matters
    assert torch.equal(y, stencil.matvec_padded(xh)) and torch.equal(y3, y)
    assert torch.equal(y_local, want)
    want_parts = ref.stencil_spmv_dots3_ref(xh, r, stencil=stencil)[1:]
    assert all(torch.equal(g, w) for g, w in zip(parts, want_parts))
    spy.calls.clear()
    y2, *parts2 = halo.spmv_dots(x)
    assert spy.calls == [("spmv_dots", False)] and torch.equal(y2, y)
    want_parts2 = ref.stencil_spmv_dots_ref(xh, stencil=stencil)[1:]
    assert all(torch.equal(g, w) for g, w in zip(parts2, want_parts2))


@pytest.mark.parametrize("method, precond, st", [
    ("pcg_merged", "block_jacobi", "27pt"), ("cg_pipe", "none", "27pt"),
    ("pcg", "jacobi", "27pt"), ("gauss_seidel", "none", "7pt"),
    ("cg_merged", "none", "27pt"), ("cg_merged", "none", "7pt")])
def test_zero_halo_route_keeps_the_iterations(x64, monkeypatch, method, precond, st):
    """A ``kernels=True`` solve on the CPU (the kernels' plain versions) runs
    its matvecs and ``spmv_dots``/``spmv_dots3`` passes through the zero-halo
    entries (the Gauss-Seidel sweep's strided iterate too), and takes the
    iteration count of the padded route, of ``kernels=False`` and of the
    reference; its iterate is bitwise the padded route's.  (Merged CG's
    initial residual alone goes through the wrapped operator's padded
    matvec.)"""
    from repro_torch.api import SolverOptions, solve
    from repro_torch.core.problems import make_problem

    api = ref_api()
    jprob = ref_module("core.problems").make_problem((12, 12, 12), st)
    want = int(api.solve(jprob, method=method,
                         options=api.SolverOptions(precond=precond)).iters)
    prob = make_problem((12, 12, 12), st, torch.float64, "cpu")
    opts = dict(precond=precond)
    spy = _Spy(monkeypatch)
    fused = solve(prob, method=method, options=SolverOptions(**opts, kernels=True))
    calls = spy.calls
    if method == "cg_merged":
        # its initial residual goes through the wrapped operator's padded
        # matvec, as the reference's does; the kernels take over after it
        assert calls[0] == ("spmv", False)
        calls = calls[1:]
    assert calls and all(zero_halo for _, zero_halo in calls)
    spy.calls.clear()
    monkeypatch.setattr(KernelOp, "zero_halo", False)
    padded = solve(prob, method=method, options=SolverOptions(**opts, kernels=True))
    assert spy.calls and not any(zero_halo for _, zero_halo in spy.calls)
    plain = solve(prob, method=method, options=SolverOptions(**opts, kernels=False))
    assert fused.status == 0
    assert fused.iters == padded.iters == plain.iters == want
    assert torch.equal(fused.x, padded.x)
