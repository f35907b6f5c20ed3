"""f64's preconditioner sweeps on the plane-ring pass, and z unpadded.

``csrc/precond.cu`` launches ``cheb_fused_step`` and ``block_jacobi_sweep``
in f64 on the plane-ring pass's element stage (``ChebTail<double>``,
``JacobiTail<double>``, one lane or B), in ``apply_point``'s order, so every
f64 output is the plain version's and the old pass's, bit for bit.  Both
sweeps take ``z`` unpadded where the halo is the zero pad
(``ops.cheb_step``/``ops.jacobi_sweep`` with ``zero_halo=True``): the ring
makes the halo in its copies, so no pad pass runs, in every dtype whose
launch takes the ring; a launch the rule keeps on ``stencil_kernel`` has its
``z`` padded by the wrapper first.  Here, on the CPU:

* the rule's Python mirror (``precond.cheb_pass``/``jacobi_pass``) and the
  wrapper's pad decision against ``precond.cu``'s text;
* both wrappers with ``zero_halo=True`` bitwise their padded form in f64,
  f32 and bf16, one lane and B lanes, with Chebyshev's aliased ``d is z``
  first step;
* ``Chebyshev`` and ``BlockJacobi`` reaching the unpadded form on a
  zero-halo operator, and Chebyshev the exchanged padded ``z`` on a base
  with a real halo (the calls recorded through ``kernels.ops``);
* f64 parity with the reference's Pallas kernels (interpret mode) at small
  grids, rtol 1e-12.

The card holds the kernels to the plain version and the old pass
(``python3 chip_smoke.py``; ``-k f64_sweeps`` in ``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import x64  # noqa: F401  (fixture)
from test_torch_harness import ref_module, seeded, to_np

from repro_torch.analysis import lint_kernels as lint
from repro_torch.core.operators import STENCILS, pad1
from repro_torch.core.solvers import LocalOp
from repro_torch.kernels import ops, precond, stencil_spmv
from repro_torch.kernels.kernel_op import KernelOp, has_zero_halo
from repro_torch.precond import BlockJacobi, Chebyshev

#: precond.cu: the rule (f32 at its pair stage; f64 and bf16 on the ring),
#: its launch from either form of z, and stencil_kernel's refusal of an
#: unpadded z
RULE = ("bool on_ring(const T* z, int zero_halo, const Tail& tail, int nz, int npoint) {\n"
        "  if constexpr (std::is_same<T, float>::value)\n"
        "    return repro::pair_stage(repro::ring_tail_stage<T>(tail, nz, zero_halo, z)) &&\n"
        "           (npoint == 27 || !std::is_same<Tail, repro::ChebTail<T>>::value);\n"
        "  else\n"
        "    return true;\n}")
LAUNCH = ("  if (!old_pass && on_ring(z, zero_halo, tail, nz, npoint))\n"
          "    return repro::launch_stencil_ring<T>(z, zero_halo, tail, nullptr, nullptr, nx, "
          "ny, nz,")
REFUSAL = "    if (zero_halo) return (int)cudaErrorInvalidValue;"
MIRRORS = {"cheb_fused_step": precond.cheb_pass, "block_jacobi_sweep": precond.jacobi_pass}
DTYPES = {"float64": torch.float64, "float32": torch.float32, "bfloat16": torch.bfloat16}
SHAPES = [(5, 6, 8), (7, 4, 9)]


def _t(shape, seed, dt):
    return torch.from_numpy(seeded(shape, seed)).to(dt)


def test_f64_rule_mirror_matches_the_source():
    """``precond.cu`` puts every f64 launch of both sweeps on the ring (its
    element stage, the tails' runs of 8), either form of z, and refuses an
    unpadded z on ``stencil_kernel``; the mirrors, the stage mirror and the
    lint's rows say the same."""
    text = (lint.CSRC / "precond.cu").read_text()
    assert RULE in text and LAUNCH in text and REFUSAL in text
    assert torch.float64 in precond.CHEB_RING_DTYPES
    assert torch.float64 in precond.JACOBI_RING_DTYPES
    for kernel, mirror in MIRRORS.items():
        for nz in (7, 8):
            for zp in (0, 8, 12):
                for zero_halo in (False, True):
                    for npoint in (7, 27):
                        assert mirror(torch.float64, nz, zp, (zp + 4,), npoint,
                                      zero_halo=zero_halo) == "ring"
                        assert stencil_spmv.ring_stage(torch.float64, nz, zero_halo, zp,
                                                       kernel=kernel) == "async"
    for name in ("cheb_step", "jacobi_sweep"):
        spec = next(s for s in lint.KERNEL_TABLE if s.name == name)
        assert "float64" in spec.ring_dtypes
        assert lint.ring_stages(spec, "float64") == ("kStageAsync",)
        assert lint.launched_passes(spec) == ["stencil", "ring"]
    assert lint.STENCIL_GEOMETRY["kRingRunCheb"] == lint.STENCIL_GEOMETRY["kRingRunJacobi"] == 8
    sten = (lint.CSRC / "stencil.cuh").read_text()
    assert "Tail<double>> : std::integral_constant" not in sten      # no f64 run of its own


@pytest.mark.parametrize("zero_halo", [False, True])
def test_f32_mirror_reads_the_operand_form(zero_halo):
    """f32's rule asks the pair stage of the form it is given: unpadded, the
    aligned z at nz even takes the unpadded pair stage; an odd nz or a z at
    a 4-byte offset, either form, keeps ``stencil_kernel``, and so does the
    7pt Chebyshev step."""
    f = torch.float32
    for kernel, mirror in MIRRORS.items():
        assert stencil_spmv.ring_stage(f, 8, zero_halo, 256, kernel=kernel) \
            == ("pair_unpadded" if zero_halo else "pair_padded")
        assert mirror(f, 8, 256, (512,), zero_halo=zero_halo) == "ring"
        assert mirror(f, 9, 256, (512,), zero_halo=zero_halo) == "stencil"
        assert mirror(f, 8, 260, (512,), zero_halo=zero_halo) == "stencil"
    assert precond.cheb_pass(f, 8, 256, (512,), 7, zero_halo=zero_halo) == "stencil"
    assert precond.jacobi_pass(f, 8, 256, (512,), 7, zero_halo=zero_halo) == "ring"
    assert precond.cheb_pass(torch.bfloat16, 9, 258, zero_halo=zero_halo) == "ring"


@pytest.mark.parametrize("case", ["f64", "f64_odd", "f32", "f32_odd", "f32_misaligned",
                                  "f32_7pt_cheb", "bf16_odd", "old_pass"])
def test_wrapper_pads_only_a_launch_off_the_ring(case):
    """The wrapper's pad decision (``precond._operand``) for an unpadded z:
    kept unpadded where the launch takes the ring, padded (one ``pad1``)
    where the rule keeps ``stencil_kernel`` or ``old_pass`` asks for it; a
    padded z is never padded again."""
    dt = {"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16,
          "old": torch.float64}[case.split("_")[0]]
    nz = 9 if case.endswith("odd") else 8
    buf = torch.zeros(1 + 4 * 5 * nz, dtype=dt)
    z = (buf[1:] if case == "f32_misaligned" else buf[:-1]).view(4, 5, nz)
    r = torch.zeros((4, 5, nz), dtype=dt)
    npoint = 7 if case == "f32_7pt_cheb" else 27
    padded = case in ("f32_odd", "f32_misaligned", "f32_7pt_cheb", "old_pass")
    got, zh = precond._operand(z, True, case == "old_pass", precond.cheb_pass, npoint,
                               (r, r, r, r))
    assert zh is not padded
    assert tuple(got.shape) == ((6, 7, nz + 2) if padded else (4, 5, nz))
    if padded:
        assert torch.equal(got, pad1(z))
    else:
        assert got is z
    zp = pad1(z)
    assert precond._operand(zp, False, False, precond.cheb_pass, npoint, (r,)) == (zp, False)


@pytest.mark.parametrize("lanes", [None, 3], ids=["one_lane", "lanes3"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("st", ["7pt", "27pt"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_unpadded_form_is_bitwise_the_padded(shape, st, dtype, lanes):
    """``ops.cheb_step`` and ``ops.jacobi_sweep`` with ``zero_halo=True``
    give the padded form's outputs bit for bit, Chebyshev's aliased first
    step (``d is z``) included, one lane and a batch."""
    dt, stencil = DTYPES[dtype], STENCILS[st]
    full = shape if lanes is None else (lanes, *shape)
    z, r, d = (_t(full, s, dt) for s in (1, 2, 3))
    zp = pad1(z)
    for got, want in ((ops.cheb_step(z, r, d, stencil, a=0.37, c=1.21, zero_halo=True),
                       ops.cheb_step(zp, r, d, stencil, a=0.37, c=1.21)),
                      (ops.cheb_step(z, r, z, stencil, a=0.37, c=1.21, zero_halo=True),
                       ops.cheb_step(zp, r, z, stencil, a=0.37, c=1.21)),
                      ((ops.jacobi_sweep(z, r, stencil, omega=0.9, zero_halo=True),),
                       (ops.jacobi_sweep(zp, r, stencil, omega=0.9),))):
        for g, w in zip(got, want):
            assert g.dtype == dt and g.shape == r.shape and torch.equal(g, w)
    if lanes is not None:
        for i in range(lanes):
            one = ops.jacobi_sweep(z[i].contiguous(), r[i], stencil, omega=0.9,
                                   zero_halo=True)
            assert torch.equal(one, ops.jacobi_sweep(z, r, stencil, omega=0.9,
                                                     zero_halo=True)[i])


@pytest.mark.parametrize("kernel", ["cheb_step", "jacobi_sweep"])
def test_unpadded_form_checks_its_operands(kernel):
    """With ``zero_halo`` the operands share one shape; a padded z handed
    as unpadded is refused, and so is an unpadded z without it."""
    st = STENCILS["27pt"]
    z, r = _t((4, 5, 6), 1, torch.float64), _t((4, 5, 6), 2, torch.float64)

    def call(zz, zero_halo):
        if kernel == "cheb_step":
            return ops.cheb_step(zz, r, r, st, a=0.5, c=0.5, zero_halo=zero_halo)
        return ops.jacobi_sweep(zz, r, st, zero_halo=zero_halo)

    call(z, True)
    with pytest.raises(ValueError):
        call(pad1(z), True)
    with pytest.raises(ValueError):
        call(z, False)


class _HaloOp(LocalOp):
    """A base with a real halo: the neighbours' planes, here a constant."""

    def pad_exchange(self, x):
        return torch.nn.functional.pad(x, (1, 1, 1, 1, 1, 1), value=0.25)


def _record(monkeypatch):
    calls = []
    for name in ("cheb_step", "jacobi_sweep"):
        real = getattr(ops, name)

        def rec(zp, *args, _real=real, _name=name, zero_halo=False, **kw):
            calls.append((_name, zero_halo, tuple(zp.shape)))
            return _real(zp, *args, zero_halo=zero_halo, **kw)

        monkeypatch.setattr(ops, name, rec)
    return calls


@pytest.mark.parametrize("lanes", [None, 2], ids=["one_lane", "lanes2"])
@pytest.mark.parametrize("base", ["kernel_op", "local_op", "halo_op"])
@pytest.mark.parametrize("pc", ["chebyshev", "block_jacobi"])
def test_preconditioners_take_the_unpadded_form(monkeypatch, pc, base, lanes):
    """On a zero-halo operator (``KernelOp`` over ``LocalOp``, or
    ``LocalOp`` itself) each Chebyshev step and block-Jacobi sweep hands
    the kernel z unpadded; on a base with a real halo the Chebyshev step
    takes the exchanged padded z and the block-Jacobi sweep (zero-faced by
    construction) still the unpadded one.  The applies equal the plain
    preconditioner's bit for bit where both read the same halo."""
    st = STENCILS["27pt"]
    shape = (5, 6, 8) if lanes is None else (lanes, 5, 6, 8)
    op = {"kernel_op": KernelOp(LocalOp(st)), "local_op": LocalOp(st),
          "halo_op": KernelOp(_HaloOp(st))}[base]
    assert has_zero_halo(op) is (base != "halo_op")
    r = _t(shape, 4, torch.float64)
    plain = {"chebyshev": Chebyshev(degree=4), "block_jacobi": BlockJacobi(sweeps=3)}[pc]
    fused = {"chebyshev": Chebyshev(degree=4, use_kernels=True),
             "block_jacobi": BlockJacobi(sweeps=3, use_kernels=True)}[pc]
    calls = _record(monkeypatch)
    got = fused.apply(fused.setup(op) if pc == "chebyshev" else None, op, r)
    padded = pc == "chebyshev" and base == "halo_op"
    interior = shape[-3:]
    want_shape = (*shape[:-3], *(n + 2 for n in interior)) if padded else shape
    kernel, launches = ("cheb_step", 3) if pc == "chebyshev" else ("jacobi_sweep", 2)
    assert calls == [(kernel, not padded, want_shape)] * launches
    if pc == "chebyshev" or base != "halo_op":
        ref_op = op.base if isinstance(op, KernelOp) else op
        want = plain.apply(plain.setup(ref_op) if pc == "chebyshev" else None, ref_op, r)
        assert torch.equal(got, want)


@pytest.fixture(scope="module")
def jprecond(x64):
    return ref_module("kernels.precond"), ref_module("core.operators").STENCILS


@pytest.mark.parametrize("shape", [(8, 6, 16), (9, 7, 5)], ids=str)
@pytest.mark.parametrize("st", ["7pt", "27pt"])
def test_f64_unpadded_sweeps_match_the_reference_kernels(jprecond, st, shape):
    """f64 ``cheb_step`` and ``jacobi_sweep`` from z unpadded against the
    reference's Pallas ``cheb_fused_step`` and ``block_jacobi_sweep``
    (interpret mode) on z zero-padded, rtol 1e-12."""
    jp, jst = jprecond
    z, r, d = (seeded(shape, s) for s in (11, 12, 13))
    zp = jnp.asarray(np.pad(z, 1))
    zt, rt, dt_ = (torch.from_numpy(v) for v in (z, r, d))
    zn, dn = ops.cheb_step(zt, rt, dt_, STENCILS[st], a=0.37, c=1.21, zero_halo=True)
    znr, dnr = jp.cheb_fused_step(zp, jnp.asarray(r), jnp.asarray(d), stencil=jst[st],
                                  a=0.37, c=1.21, interpret=True)
    np.testing.assert_allclose(to_np(zn), to_np(znr), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(to_np(dn), to_np(dnr), rtol=1e-12, atol=1e-12)
    zs = ops.jacobi_sweep(zt, rt, STENCILS[st], omega=0.9, zero_halo=True)
    zsr = jp.block_jacobi_sweep(zp, jnp.asarray(r), stencil=jst[st], omega=0.9,
                                interpret=True)
    np.testing.assert_allclose(to_np(zs), to_np(zsr), rtol=1e-12, atol=1e-12)
    # the first step's aliased d is z
    za, da = ops.cheb_step(zt, rt, zt, STENCILS[st], a=0.37, c=1.21, zero_halo=True)
    zar, dar = jp.cheb_fused_step(zp, jnp.asarray(r), jnp.asarray(z), stencil=jst[st],
                                  a=0.37, c=1.21, interpret=True)
    np.testing.assert_allclose(to_np(za), to_np(zar), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(to_np(da), to_np(dar), rtol=1e-12, atol=1e-12)


def test_f64_solve_reaches_the_unpadded_form(monkeypatch):
    """A ``kernels=True`` f64 pcg + chebyshev solve and a pcg +
    block_jacobi solve (the plain versions on the CPU) hand every sweep z
    unpadded, and stop on the ``kernels=False`` iteration."""
    from repro_torch.api import SolverOptions, SolverSession
    for pc, kernel in (("chebyshev", "cheb_step"), ("block_jacobi", "jacobi_sweep")):
        calls = _record(monkeypatch)
        res = SolverSession(method="pcg", grid=(8, 8, 10), stencil="27pt", device="cpu",
                            options=SolverOptions(kernels=True, precond=pc)).solve()
        plain = SolverSession(method="pcg", grid=(8, 8, 10), stencil="27pt", device="cpu",
                              options=SolverOptions(kernels=False, precond=pc)).solve()
        assert res.status == 0 and res.iters == plain.iters
        assert calls and all(c == (kernel, True, (8, 8, 10)) for c in calls)
        monkeypatch.undo()
