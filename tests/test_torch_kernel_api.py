"""The port's kernel API (``repro_torch.kernels.ops``) on the CPU against the
JAX kernel API (``repro.kernels.ops``): ``axpbypcz``, ``axpbypcz_dot``,
``cg_update`` and ``gs_half_sweep``, whose kernels no solver path calls.

On CPU tensors each port wrapper runs its kernel's plain PyTorch version;
the reference runs its Pallas kernels in interpret mode (as
``tests/test_kernels.py`` does, on the same cases).  Both get the same numpy
inputs made from a seed.  Tolerances: outputs rtol=atol=1e-12 in f64 and
1e-5 in f32; the partials rtol 1e-11 in f64 and 1e-4 in f32, because the two
sum in different orders.  The compositions are the ones ``chip_smoke.py``
drives on the card (phase 2e): one symmetric red-black sweep of four
``gs_half_sweep`` calls, and CG-NB's Alg. 1 lines 4–8 through
``axpbypcz``/``axpbypcz_dot``/``cg_update``, each against the port's own
step (bitwise) and the reference's (1e-12).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import x64  # noqa: F401  (fixture)
from test_torch_harness import ref_module, seeded, to_np

from repro_torch.core.methods import Ops, get_method
from repro_torch.core.operators import STENCILS, pad1
from repro_torch.core.solvers import LocalOp
from repro_torch.kernels import ops, ref

DTYPES = [np.float64, np.float32]
STENCIL_NAMES = ["7pt", "27pt"]
#: the reference tests' cases (tests/test_kernels.py)
AXPBY_SIZES = [1000, 4096, 5000]
SWEEP_SHAPES = [(8, 8, 8), (12, 10, 16), (9, 7, 5)]
#: the compositions' grid
COMPOSE_SHAPE = (12, 12, 12)


def out_tols(dt):
    return dict(rtol=1e-12, atol=1e-12) if dt == np.float64 else dict(rtol=1e-5, atol=1e-5)


def partial_rtol(dt):
    return 1e-11 if dt == np.float64 else 1e-4


@pytest.fixture(scope="module")
def jref(x64):
    return ref_module("kernels.ops"), ref_module("core.operators").STENCILS


def _scalars(dt, *vals):
    """The same scalars for both packages: jax and torch 0-d arrays of ``dt``."""
    tdt = torch.float64 if dt == np.float64 else torch.float32
    return [jnp.asarray(v, dt) for v in vals], [torch.tensor(v, dtype=tdt) for v in vals]


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("n", AXPBY_SIZES)
def test_axpbypcz_matches_reference(jref, n, dt):
    jops, _ = jref
    x, y, z = (seeded((n,), s, dt) for s in (1, 2, 3))
    (ja, jb, jc), (ta, tb, tc) = _scalars(dt, 0.3, -1.2, 2.0)
    out = ops.axpbypcz(ta, torch.from_numpy(x), tb, torch.from_numpy(y), tc,
                       torch.from_numpy(z))
    want = jops.axpbypcz(ja, jnp.asarray(x), jb, jnp.asarray(y), jc, jnp.asarray(z))
    assert out.dtype == torch.from_numpy(x).dtype and tuple(out.shape) == (n,)
    np.testing.assert_allclose(to_np(out), to_np(want), **out_tols(dt))


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("n", AXPBY_SIZES)
def test_axpbypcz_dot_matches_reference(jref, n, dt):
    jops, _ = jref
    x, y, z, w = (seeded((n,), s, dt) for s in (4, 5, 6, 7))
    (ja, jb, jc), (ta, tb, tc) = _scalars(dt, 0.3, -1.2, 2.0)
    out, d = ops.axpbypcz_dot(ta, torch.from_numpy(x), tb, torch.from_numpy(y), tc,
                              torch.from_numpy(z), torch.from_numpy(w))
    want, dr = jops.axpbypcz_dot(ja, jnp.asarray(x), jb, jnp.asarray(y), jc,
                                 jnp.asarray(z), jnp.asarray(w))
    np.testing.assert_allclose(to_np(out), to_np(want), **out_tols(dt))
    assert d.dim() == 0 and d.dtype == out.dtype
    np.testing.assert_allclose(float(d), float(dr), rtol=partial_rtol(dt))


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
def test_cg_update_matches_reference(jref, dt):
    jops, _ = jref
    r, ar, p, ap = (seeded((3000,), s, dt) for s in (8, 9, 10, 11))
    (jbeta,), (tbeta,) = _scalars(dt, 0.7)
    pn, apn, ad = ops.cg_update(tbeta, *(torch.from_numpy(v) for v in (r, ar, p, ap)))
    pnr, apnr, adr = jops.cg_update(jbeta, *(jnp.asarray(v) for v in (r, ar, p, ap)))
    np.testing.assert_allclose(to_np(pn), to_np(pnr), **out_tols(dt))
    np.testing.assert_allclose(to_np(apn), to_np(apnr), **out_tols(dt))
    assert ad.dim() == 0
    np.testing.assert_allclose(float(ad), float(adr), rtol=partial_rtol(dt))


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", SWEEP_SHAPES, ids=str)
@pytest.mark.parametrize("colour", [0, 1])
@pytest.mark.parametrize("st", STENCIL_NAMES)
def test_gs_half_sweep_matches_reference(jref, st, colour, shape, dt):
    """The global (i + j + k) parity decides the colour, whatever the
    reference's z-block (ragged shapes shrink it)."""
    jops, jst = jref
    xp = np.pad(seeded(shape, 12, dt), 1)
    b = seeded(shape, 13, dt)
    out = ops.gs_half_sweep(torch.from_numpy(xp), torch.from_numpy(b), STENCILS[st], colour)
    want = jops.gs_half_sweep(jnp.asarray(xp), jnp.asarray(b), jst[st], colour)
    assert tuple(out.shape) == shape and out.dtype == torch.from_numpy(b).dtype
    np.testing.assert_allclose(to_np(out), to_np(want), **out_tols(dt))
    # the other colour keeps the old iterate exactly
    i, j, k = np.indices(shape)
    other = (i + j + k) % 2 != colour
    np.testing.assert_array_equal(to_np(out)[other], xp[1:-1, 1:-1, 1:-1][other])


#: padded x-planes before (b), at (c) and after (a) an output, and the 3 × 3
#: neighbourhood element q = 3·(dy + 1) + (dz + 1) of each, in the order the
#: ring pass's off-diagonal sum takes them: (ring_first's terms, ring_last's)
RING_OFFDIAG_ORDER = {
    "27pt": ([("b", q) for q in range(9)] + [("c", q) for q in range(9) if q != 4],
             [("a", q) for q in range(9)]),
    "7pt": ([("b", 4)], [("a", 4), ("c", 1), ("c", 7), ("c", 3), ("c", 5)]),
}


def _ring_half_sweep(xp: np.ndarray, b: np.ndarray, st: str, colour: int,
                     divide: bool) -> np.ndarray:
    """``rb_gs_half_sweep`` as the plane-ring pass computes it
    (``csrc/stencil.cuh``: ``ring_first`` then ``ring_last`` with OFFDIAG,
    then ``RbGsTail``), emulated in numpy float64 with one rounding per
    operation: each output's sum starts from 0 when its centre plane arrives
    and ends on the plane after; the parity is (i + j + k) & 1 of the global
    index.  ``divide`` takes the CPU plain version's true division by diag in
    place of the kernel's multiply by the reciprocal rounded in f64."""
    stencil = STENCILS[st]
    nx, ny, nz = b.shape
    off = np.float64(stencil.off_coeff)
    first, last = RING_OFFDIAG_ORDER[st]
    sums = np.empty_like(b)
    for i in range(nx):
        planes = {"b": xp[i], "c": xp[i + 1], "a": xp[i + 2]}
        part = np.zeros((ny, nz))
        for terms in (first, last):
            for name, q in terms:
                dy, dz = divmod(q, 3)
                part = part + off * planes[name][dy:dy + ny, dz:dz + nz]
        sums[i] = part
    new = ((b - sums) / np.float64(stencil.diag) if divide
           else (b - sums) * (np.float64(1.0) / np.float64(stencil.diag)))
    i, j, k = np.indices(b.shape)
    return np.where((i + j + k) & 1 == colour, new, xp[1:-1, 1:-1, 1:-1])


@pytest.mark.parametrize("shape", [(17, 5, 67), (5, 9, 6), (33, 4, 64)], ids=str)
@pytest.mark.parametrize("colour", [0, 1])
@pytest.mark.parametrize("st", STENCIL_NAMES)
def test_ring_half_sweep_emulation_matches_plain(jref, st, colour, shape):
    """The ring pass's split of the off-diagonal sum (from 0, in
    ``Stencil.offsets`` order: 27pt b's nine, c's eight, a's nine; 7pt b[4],
    then a[4], c[1], c[7], c[3], c[5]) is the plain version's sum: with the
    CPU's division the emulated half-sweep is bitwise the port's
    ``ref.rb_gs_half_sweep_ref`` and the reference's; with the kernel's
    reciprocal multiply it is within an ulp of them at the updated points and
    equal elsewhere.  (On the card the plain version multiplies by the
    reciprocal too, so there the kernel is bitwise.)"""
    jst = jref[1]
    jplain = ref_module("kernels.ref").rb_gs_half_sweep_ref
    xp = np.pad(seeded(shape, 21), 1)
    b = seeded(shape, 22)
    want = to_np(ref.rb_gs_half_sweep_ref(torch.from_numpy(xp), torch.from_numpy(b),
                                          stencil=STENCILS[st], colour=colour))
    np.testing.assert_array_equal(
        to_np(jplain(jnp.asarray(xp), jnp.asarray(b), stencil=jst[st], colour=colour)), want)
    np.testing.assert_array_equal(_ring_half_sweep(xp, b, st, colour, divide=True), want)
    got = _ring_half_sweep(xp, b, st, colour, divide=False)
    assert np.all(np.abs(got - want) <= np.spacing(np.abs(want)))
    i, j, k = np.indices(shape)
    other = (i + j + k) % 2 != colour
    np.testing.assert_array_equal(got[other], want[other])


def _both_ops(st: str, seed: int):
    """The same system in both packages: the stencil with a seeded RHS,
    the absolute criterion (``norm_ref=1``)."""
    b = seeded(COMPOSE_SHAPE, seed)
    port = Ops(LocalOp(STENCILS[st]), torch.from_numpy(b), norm_ref=1.0)
    rmethods = ref_module("core.methods")
    rsolvers = ref_module("core.solvers")
    rstencils = ref_module("core.operators").STENCILS
    ref = rmethods.Ops(rsolvers.LocalOp(rstencils[st]), jnp.asarray(b), norm_ref=1.0)
    return port, ref, rmethods


@pytest.mark.parametrize("st", STENCIL_NAMES)
def test_rb_sweep_from_ops_equals_the_step(x64, st):
    """One symmetric sweep (red, black, black, red) of ``ops.gs_half_sweep``
    on a gauss_seidel_rb iterate equals the port's step bitwise and the
    reference's to 1e-12."""
    port, ref, rmethods = _both_ops(st, 14)
    mdef = get_method("gauss_seidel_rb")
    state = mdef.init(port, torch.zeros(COMPOSE_SHAPE, dtype=torch.float64))
    for _ in range(2):
        state = mdef.step(port, state)
    x = state[0]
    swept = x
    for colour in (0, 1, 1, 0):
        swept = ops.gs_half_sweep(pad1(swept), port.b, STENCILS[st], colour)
    step_x = mdef.step(port, state)[0]
    assert torch.equal(swept, step_x)
    ref_x = rmethods.get_method("gauss_seidel_rb").step(ref, (jnp.asarray(to_np(x)),
                                                              jnp.asarray(0.0)))[0]
    np.testing.assert_allclose(to_np(swept), to_np(ref_x), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("st", STENCIL_NAMES)
def test_cg_nb_lines_from_ops_equal_the_step(x64, st):
    """CG-NB after two iterations: line 4 (``r' = r − α·Ap``) through
    ``axpbypcz``, line 5's ``r'·r'`` through ``axpbypcz_dot``, lines 6–8
    through ``cg_update``; vectors bitwise equal to the port's step, the
    partials within 1e-11, and all within 1e-12 of the reference's step."""
    port, ref, rmethods = _both_ops(st, 15)
    mdef = get_method("cg_nb")
    state = mdef.init(port, torch.zeros(COMPOSE_SHAPE, dtype=torch.float64))
    for _ in range(2):
        state = mdef.step(port, state)
    x, r, p, ap, an, ad = state
    alpha = an / ad
    step = mdef.step(port, state)
    r_new = ops.axpbypcz(1.0, r, -alpha, ap, 0.0, p)
    assert torch.equal(r_new, step[1])
    r_again, an_new = ops.axpbypcz_dot(1.0, r, -alpha, ap, 0.0, p, step[1])
    assert torch.equal(r_again, r_new)
    np.testing.assert_allclose(float(an_new), float(step[4]), rtol=1e-11)
    beta = step[4] / an               # the step's β (its r'·r' sums in another order)
    p_new, ap_new, ad_new = ops.cg_update(beta, r_new, port.matvec(r_new), p, ap)
    assert torch.equal(p_new, step[2]) and torch.equal(ap_new, step[3])
    np.testing.assert_allclose(float(ad_new), float(step[5]), rtol=1e-11)
    rstep = rmethods.get_method("cg_nb").step(
        ref, tuple(jnp.asarray(to_np(v)) for v in state))
    for got, want in ((r_new, rstep[1]), (p_new, rstep[2]), (ap_new, rstep[3])):
        np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-12, atol=1e-12)
    for got, want in ((an_new, rstep[4]), (ad_new, rstep[5])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-11)


def _calls(v, last, colour=0):
    """Each wrapper with ``last`` as its last operand."""
    st = STENCILS["27pt"]
    return {
        "axpbypcz": lambda: ops.axpbypcz(0.5, v, 0.5, v, 0.5, last),
        "axpbypcz_dot": lambda: ops.axpbypcz_dot(0.5, v, 0.5, v, 0.5, v, last),
        "cg_update": lambda: ops.cg_update(0.5, v, v, v, last),
        "gs_half_sweep": lambda: ops.gs_half_sweep(pad1(v), last, st, colour),
    }


@pytest.mark.parametrize("wrapper", ["axpbypcz", "axpbypcz_dot", "cg_update",
                                     "gs_half_sweep"])
@pytest.mark.parametrize("bad", ["dtype", "bfloat16", "shape", "contiguity"])
def test_kernel_api_rejects_bad_inputs(wrapper, bad):
    v = torch.ones((4, 5, 6), dtype=torch.float64)
    last, exc = {
        "dtype": (v.to(torch.int64), TypeError),
        # the kernels take bf16, but not beside a float64 operand
        "bfloat16": (v.to(torch.bfloat16), ValueError),
        "shape": (torch.ones((4, 5, 7), dtype=torch.float64), ValueError),
        "contiguity": (v.transpose(0, 2).contiguous().transpose(0, 2), ValueError),
    }[bad]
    with pytest.raises(exc):
        _calls(v, last)[wrapper]()


@pytest.mark.parametrize("colour", [2, -1])
def test_gs_half_sweep_rejects_colour(colour):
    v = torch.ones((4, 5, 6), dtype=torch.float64)
    with pytest.raises(ValueError, match="colour"):
        _calls(v, v, colour)["gs_half_sweep"]()


def test_kernel_api_counts_no_launches_on_cpu():
    ops.reset_launches()
    v = torch.ones((4, 5, 6), dtype=torch.float64)
    for call in _calls(v, v).values():
        call()
    assert {"fused_axpby", "fused_axpby_dot", "cg_fused_update",
            "rb_gs_half_sweep"} <= set(ops.LAUNCHES)
    assert all(n == 0 for n in ops.LAUNCHES.values())


def test_kernel_api_returns_fresh_tensors():
    """Aliased inputs (``axpbypcz(a, x, b, x, c, x)``, ``cg_update(β, r, r, p,
    p)``) give fresh outputs and leave the inputs as they were."""
    x = torch.from_numpy(seeded((5, 6, 7), 16))
    p = torch.from_numpy(seeded((5, 6, 7), 17))
    x0, p0 = x.clone(), p.clone()
    out = ops.axpbypcz(0.3, x, -1.2, x, 2.0, x)
    pn, apn, _ = ops.cg_update(0.7, x, x, p, p)
    swept = ops.gs_half_sweep(pad1(x), x, STENCILS["7pt"], 1)
    for t in (out, pn, apn, swept):
        assert t.data_ptr() not in (x.data_ptr(), p.data_ptr())
    assert torch.equal(x, x0) and torch.equal(p, p0)
    torch.testing.assert_close(out, (0.3 - 1.2 + 2.0) * x0, rtol=1e-14, atol=1e-14)
