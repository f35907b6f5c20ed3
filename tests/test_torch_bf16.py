"""The bf16 forms of the solver kernels on the CPU, against the JAX reference.

Every solver wrapper of ``repro_torch.kernels.ops`` (and the three 4-D,
lane-batched forms) takes bfloat16 operands and gives bfloat16 outputs and
float32 partials.  On CPU tensors it runs its plain version; the inputs are
seeded numpy values rounded to bf16, fed to both packages, and every scalar
is a Python float that both sides round to bf16.  Three comparisons:

* against ``repro.kernels.ref``'s oracles called op by op: outputs bitwise
  equal, partials within 1e-5·Σ|a_i·b_i| (the two sum in other orders);
* against the Pallas kernels in interpret mode (``repro.kernels.ops``; the
  lane-batched forms through ``jax.vmap``, as the batched solve calls
  them): stencil outputs within 2⁻⁴·Σ_j|c_j·x_j| at each point, flat
  outputs within 2 bf16 ulps, partials within 2⁻⁷·Σ|a_i·b_i|.  The Pallas
  kernels round more than their own oracle does: they form the stencil sum
  and the dot products on bf16 operands, rounding each product and each
  block sum to bf16 before the f32 accumulator takes it
  (``spmv_dot.py:51-52,106-108``, ``stencil_spmv.py:92``,
  ``fused_bodies.py:62-64``, ``fused_axpby.py:44``), where the oracle and
  the port cast to f32 first; the bounds admit that rounding;
* the scalar rounding alone: ``cheb_step`` with a = 0.3719, c = 0.1137 and
  ``jacobi_sweep`` with ω = 0.8 are bitwise the oracle, and would not be
  with the scalars left in float32.

float32 and float64 outputs of every wrapper are bitwise what the unrounded
scalars give: the rounding changes no bit there.  The solver facade
(``KernelOp``, ``make_problem``) keeps rejecting bf16.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import ref_module, seeded, to_np

from repro_torch.core.operators import STENCILS, Stencil, pad1
from repro_torch.core.problems import make_problem
from repro_torch.core.solvers import LocalOp
from repro_torch.kernels import autotune, ops, ref
from repro_torch.kernels.kernel_op import KernelOp

#: the oracle comparisons' shapes (the second ragged); the Pallas kernels
#: need nz a multiple of their z-block (8) and run at the first
SHAPES = [(8, 8, 16), (9, 7, 5)]
PALLAS_SHAPE = (8, 8, 16)
STENCIL_NAMES = ["7pt", "27pt"]
#: the scalars, Python floats with more bits than bf16 keeps
ALPHA, BETA, OMEGA, C2 = 0.3719, -0.2113, 0.8, 2.0
CHEB_A, CHEB_C = 0.3719, 0.1137
LANES = 3


def _bf16(shape, seed: int):
    """(torch bf16, jax bf16) of one seeded input, the same bits."""
    t = torch.from_numpy(seeded(shape, seed, np.float32)).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _js(c: float):
    """A scalar as the reference takes it: a bf16 0-d array."""
    return jnp.asarray(c, dtype=jnp.bfloat16)


def _f32(a) -> np.ndarray:
    return to_np(a.float()) if isinstance(a, torch.Tensor) else \
        np.asarray(jnp.asarray(a).astype(jnp.float32))


def _abs_sum(pairs) -> float:
    """Σ|a_i·b_i| of a partial's operands, in float64."""
    a, b = pairs
    return float((a.double() * b.double()).abs().sum())


def _stencil_abs(st: Stencil, xp: torch.Tensor) -> np.ndarray:
    """Σ_j |c_j·x_j| at each point of the stencil applied to ``xp``."""
    absst = Stencil("abs", st.offsets, diag=abs(st.diag), off_coeff=abs(st.off_coeff))
    return to_np(absst.matvec_padded(xp.double().abs()))


def _ulp(w: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each value (the smallest subnormal at 0)."""
    w = np.abs(w.astype(np.float64))
    e = np.floor(np.log2(np.where(w == 0, 1.0, w)))
    return np.where(w == 0, 2.0 ** -133, 2.0 ** (e - 7))


@dataclasses.dataclass
class Wrapper:
    """One solver wrapper's bf16 call on the port, its oracle and its Pallas
    kernel; ``kinds`` says what each output is ("S" a stencil output, "F" a
    flat one, "P" a partial), ``pairs`` gives each partial's operands from
    the port's outputs."""

    port: Callable
    oracle: Callable
    pallas: Callable
    kinds: str
    pairs: Callable = lambda out: []


def _flat_outputs(out) -> list:
    """A wrapper's outputs as one flat list (BiCGStab's nine partials
    unpacked)."""
    flat = []
    for o in (out if isinstance(out, tuple) else (out,)):
        flat += list(o) if isinstance(o, tuple) else [o]
    return flat


def wrappers(sname: str, shape) -> dict[str, Wrapper]:
    """The 17 solver wrappers in bf16 at one stencil and shape."""
    st = STENCILS[sname]
    jref, jops = ref_module("kernels.ref"), ref_module("kernels.ops")
    js = ref_module("core.operators").STENCILS[sname]
    (x, xj), (r, rj), (d, dj) = (_bf16(shape, s) for s in (1, 2, 3))
    xp, xpj = pad1(x), jnp.pad(xj, 1)
    vs = [_bf16(shape, 10 + i) for i in range(10)]
    T, J = [t for t, _ in vs], [j for _, j in vs]
    a, b, o, c2 = _js(ALPHA), _js(BETA), _js(OMEGA), _js(C2)
    xin = x.contiguous()

    def body(name, n, kinds):
        return Wrapper(lambda: getattr(ops, name)(ALPHA, BETA, *T[:n]),
                       lambda: getattr(jref, f"fused_{name}_ref")(a, b, *J[:n]),
                       lambda: getattr(jops, name)(a, b, *J[:n]), kinds)

    def bicg_pairs(out):
        v, q, y, _ = out
        rh, t, z, s = T[4], T[5], T[0], T[3]
        return [(q, y), (y, y), (q, q), (rh, q), (rh, y), (rh, t), (rh, v), (rh, z), (rh, s)]

    out = {
        "spmv": Wrapper(lambda: ops.spmv(xp, st), lambda: jref.stencil_spmv_ref(xpj, stencil=js),
                        lambda: jops.spmv(xpj, js), "S"),
        "spmv_dot": Wrapper(lambda: ops.spmv_dot(xin, st, zero_halo=True),
                            lambda: jref.stencil_spmv_dot_ref(xpj, stencil=js),
                            lambda: jops.spmv_dot(xpj, js), "SP",
                            lambda out: [(out[0], x)]),
        "spmv_dots": Wrapper(lambda: ops.spmv_dots(xp, st),
                             lambda: jref.stencil_spmv_dots_ref(xpj, stencil=js),
                             lambda: jops.spmv_dots(xpj, js), "SPP",
                             lambda out: [(out[0], x), (x, x)]),
        "spmv_dots3": Wrapper(lambda: ops.spmv_dots3(xin, r, st, zero_halo=True),
                              lambda: jref.stencil_spmv_dots3_ref(xpj, rj, stencil=js),
                              lambda: jops.spmv_dots3(xpj, rj, js), "SPPP",
                              lambda out: [(out[0], x), (r, x), (r, r)]),
        "cg_body": body("cg_body", 5, "FFFF"),
        "pcg_body": body("pcg_body", 6, "FFFF"),
        "pipe_body": body("pipe_body", 7, "FFFFFF"),
        "ppipe_body": body("ppipe_body", 10, "FFFFFFFF"),
        "fused_dots": Wrapper(lambda: ops.fused_dots(*T[:3]),
                              lambda: jref.fused_dots_ref(*J[:3]),
                              lambda: jops.fused_dots(*J[:3]), "PPP",
                              lambda out: [(T[0], T[1]), (T[2], T[1]), (T[0], T[0])]),
        "bicgstab_update1": Wrapper(
            lambda: ops.bicgstab_update1(ALPHA, OMEGA, *T[:6]),
            lambda: jref.bicgstab_update1_ref(a, o, *J[:6]),
            lambda: jops.bicgstab_update1(a, o, *J[:6]), "FFF"),
        "bicgstab_spmv_dots": Wrapper(
            lambda: ops.bicgstab_spmv_dots(xp, *T[:6], ALPHA, st),
            lambda: jref.bicgstab_spmv_dots_ref(xpj, *J[:6], a, stencil=js),
            lambda: jops.bicgstab_spmv_dots(xpj, *J[:6], a, js), "SFF" + "P" * 9,
            bicg_pairs),
        "bicgstab_spmv_update": Wrapper(
            lambda: ops.bicgstab_spmv_update(xp, *T[:6], OMEGA, BETA, st),
            lambda: jref.bicgstab_spmv_update_ref(xpj, *J[:6], o, b, stencil=js),
            lambda: jops.bicgstab_spmv_update(xpj, *J[:6], o, b, js), "SFFS"),
        "cheb_step": Wrapper(
            lambda: ops.cheb_step(xp, r, d, st, a=CHEB_A, c=CHEB_C),
            lambda: jref.cheb_fused_step_ref(xpj, rj, dj, stencil=js, a=CHEB_A, c=CHEB_C),
            lambda: jops.cheb_step(xpj, rj, dj, js, a=CHEB_A, c=CHEB_C), "SS"),
        "jacobi_sweep": Wrapper(
            lambda: ops.jacobi_sweep(xp, r, st, omega=OMEGA),
            lambda: jref.block_jacobi_sweep_ref(xpj, rj, stencil=js, omega=OMEGA),
            lambda: jops.jacobi_sweep(xpj, rj, js, omega=OMEGA), "S"),
        "axpbypcz": Wrapper(lambda: ops.axpbypcz(ALPHA, T[0], BETA, T[1], C2, T[2]),
                            lambda: jref.fused_axpby_ref(a, J[0], b, J[1], c2, J[2]),
                            lambda: jops.axpbypcz(a, J[0], b, J[1], c2, J[2]), "F"),
        "axpbypcz_dot": Wrapper(
            lambda: ops.axpbypcz_dot(ALPHA, T[0], BETA, T[1], C2, T[2], T[3]),
            lambda: jref.fused_axpby_dot_ref(a, J[0], b, J[1], c2, J[2], J[3]),
            lambda: jops.axpbypcz_dot(a, J[0], b, J[1], c2, J[2], J[3]), "FP",
            lambda out: [(out[0], T[3])]),
        "cg_update": Wrapper(lambda: ops.cg_update(BETA, *T[:4]),
                             lambda: jref.cg_fused_update_ref(b, *J[:4]),
                             lambda: jops.cg_update(b, *J[:4]), "FFP",
                             lambda out: [(out[1], out[0])]),
    }
    for colour in (0, 1):
        out[f"gs_half_sweep/{colour}"] = Wrapper(
            lambda colour=colour: ops.gs_half_sweep(xp, r, st, colour),
            lambda colour=colour: jref.rb_gs_half_sweep_ref(xpj, rj, stencil=js,
                                                            colour=colour),
            lambda colour=colour: jops.gs_half_sweep(xpj, rj, js, colour), "S")
    return out


WRAPPERS = ["spmv", "spmv_dot", "spmv_dots", "spmv_dots3", "cg_body", "pcg_body",
            "pipe_body", "ppipe_body", "fused_dots", "bicgstab_update1",
            "bicgstab_spmv_dots", "bicgstab_spmv_update", "cheb_step", "jacobi_sweep",
            "axpbypcz", "axpbypcz_dot", "cg_update", "gs_half_sweep/0", "gs_half_sweep/1"]


def _check_dtypes(got, kinds):
    assert len(got) == len(kinds)
    for g, kind in zip(got, kinds):
        assert g.dtype == (torch.float32 if kind == "P" else torch.bfloat16)


@pytest.mark.parametrize("wrapper", WRAPPERS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("sname", STENCIL_NAMES)
def test_bf16_wrapper_matches_oracle(sname, shape, wrapper):
    w = wrappers(sname, shape)[wrapper]
    out = w.port()
    got, want = _flat_outputs(out), _flat_outputs(w.oracle())
    _check_dtypes(got, w.kinds)
    pairs = iter(w.pairs(out))
    for g, wv, kind in zip(got, want, w.kinds):
        if kind == "P":
            assert abs(float(g) - float(wv)) <= 1e-5 * _abs_sum(next(pairs))
        else:
            assert np.array_equal(_f32(g), _f32(wv)), wrapper


@pytest.mark.parametrize("wrapper", WRAPPERS)
@pytest.mark.parametrize("sname", STENCIL_NAMES)
def test_bf16_wrapper_within_pallas_bounds(sname, wrapper):
    """The port against the Pallas kernel in interpret mode: the Pallas
    kernels' bf16 products and block sums are admitted by the bounds."""
    w = wrappers(sname, PALLAS_SHAPE)[wrapper]
    out = w.port()
    got, want = _flat_outputs(out), _flat_outputs(w.pallas())
    pairs = iter(w.pairs(out))
    xp = pad1(_bf16(PALLAS_SHAPE, 1)[0])
    for g, wv, kind in zip(got, want, w.kinds):
        err = np.abs(_f32(g).astype(np.float64) - _f32(wv))
        if kind == "P":
            assert float(err) <= 2.0 ** -7 * _abs_sum(next(pairs))
        elif kind == "S":
            assert np.all(err <= 2.0 ** -4 * _stencil_abs(STENCILS[sname], xp))
        else:
            assert np.all(err <= 2 * _ulp(_f32(wv)))


def _lanes(sname: str, shape):
    st = STENCILS[sname]
    js = ref_module("core.operators").STENCILS[sname]
    (x, xj), (r, rj), (d, dj) = (_bf16((LANES, *shape), s) for s in (4, 5, 6))
    xp = pad1(x)
    xpj = jnp.pad(xj, ((0, 0), (1, 1), (1, 1), (1, 1)))
    return st, js, x, xp, xpj, r, rj, d, dj


BATCHED = ["spmv", "spmv_zero_halo", "cheb_step", "jacobi_sweep"]


def _batched_calls(sname: str, shape, form: str):
    """(the port's 4-D call, the oracle on lane i, the vmapped Pallas call)."""
    st, js, x, xp, xpj, r, rj, d, dj = _lanes(sname, shape)
    jref, jops = ref_module("kernels.ref"), ref_module("kernels.ops")
    if form in ("spmv", "spmv_zero_halo"):
        port = (lambda: ops.spmv(xp, st)) if form == "spmv" else \
            (lambda: ops.spmv(x, st, zero_halo=True))
        return (port, lambda i: jref.stencil_spmv_ref(xpj[i], stencil=js),
                lambda: jax.vmap(lambda v: jops.spmv(v, js))(xpj), xp)
    if form == "cheb_step":
        return (lambda: ops.cheb_step(xp, r, d, st, a=CHEB_A, c=CHEB_C),
                lambda i: jref.cheb_fused_step_ref(xpj[i], rj[i], dj[i], stencil=js,
                                                   a=CHEB_A, c=CHEB_C),
                lambda: jax.vmap(lambda v, rr, dd: jops.cheb_step(
                    v, rr, dd, js, a=CHEB_A, c=CHEB_C))(xpj, rj, dj), xp)
    return (lambda: ops.jacobi_sweep(xp, r, st, omega=OMEGA),
            lambda i: jref.block_jacobi_sweep_ref(xpj[i], rj[i], stencil=js, omega=OMEGA),
            lambda: jax.vmap(lambda v, rr: jops.jacobi_sweep(v, rr, js, omega=OMEGA))(
                xpj, rj), xp)


@pytest.mark.parametrize("form", BATCHED)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("sname", STENCIL_NAMES)
def test_bf16_batched_forms_match_oracle(sname, shape, form):
    """The lane-batched forms (``spmv`` in both operand forms,
    ``cheb_step``, ``jacobi_sweep`` on (B, ...) operands): each lane bitwise
    the oracle on it."""
    port, oracle, _, _ = _batched_calls(sname, shape, form)
    got = _flat_outputs(port())
    assert all(g.dtype == torch.bfloat16 and g.shape[0] == LANES for g in got)
    for i in range(LANES):
        for g, wv in zip(got, _flat_outputs(oracle(i))):
            assert np.array_equal(_f32(g[i]), _f32(wv)), (form, i)


@pytest.mark.parametrize("form", BATCHED)
@pytest.mark.parametrize("sname", STENCIL_NAMES)
def test_bf16_batched_forms_within_pallas_bounds(sname, form):
    port, _, pallas, xp = _batched_calls(sname, PALLAS_SHAPE, form)
    bound = np.stack([2.0 ** -4 * _stencil_abs(STENCILS[sname], xp[i]) for i in range(LANES)])
    for g, wv in zip(_flat_outputs(port()), _flat_outputs(pallas())):
        assert np.all(np.abs(_f32(g).astype(np.float64) - _f32(wv)) <= bound)


def _unrounded(monkeypatch):
    """Leave every scalar as the caller gave it: the wrappers' and the plain
    versions' rounding switched off."""
    monkeypatch.setattr(ops, "_scalars", lambda kernel, t, *cs: cs)
    monkeypatch.setattr(ref, "scalars_like", lambda t, *cs: cs)


@pytest.mark.parametrize("sname", STENCIL_NAMES)
def test_bf16_scalar_rounding_alone(sname, monkeypatch):
    """``cheb_step``'s a, c and ``jacobi_sweep``'s ω rounded to bf16 give the
    oracle's bits; left in float32 (PyTorch's math type for a bf16 tensor
    times a Python number) they do not."""
    cases = wrappers(sname, PALLAS_SHAPE)
    for name in ("cheb_step", "jacobi_sweep"):
        got, want = cases[name].port(), cases[name].oracle()
        for g, wv in zip(_flat_outputs(got), _flat_outputs(want)):
            assert np.array_equal(_f32(g), _f32(wv)), name
    _unrounded(monkeypatch)
    for name in ("cheb_step", "jacobi_sweep"):
        got, want = cases[name].port(), cases[name].oracle()
        assert not all(np.array_equal(_f32(g), _f32(wv))
                       for g, wv in zip(_flat_outputs(got), _flat_outputs(want))), name


def _plain_calls(dt, sname: str, shape):
    """Every solver wrapper in ``dt`` with Python-float scalars (0-d tensors
    for the flat bodies' α and β, as the solvers pass them)."""
    st = STENCILS[sname]
    gen = torch.Generator().manual_seed(7)
    x, r, d, *T = (torch.randn(shape, generator=gen, dtype=torch.float64).to(dt)
                   for _ in range(13))
    xp = pad1(x)
    al, be = (torch.tensor(c, dtype=torch.float64) for c in (ALPHA, BETA))
    return {
        "cg_body": lambda: ops.cg_body(al, be, *T[:5]),
        "pcg_body": lambda: ops.pcg_body(ALPHA, BETA, *T[:6]),
        "pipe_body": lambda: ops.pipe_body(al, be, *T[:7]),
        "ppipe_body": lambda: ops.ppipe_body(ALPHA, BETA, *T[:10]),
        "bicgstab_update1": lambda: ops.bicgstab_update1(ALPHA, OMEGA, *T[:6]),
        "bicgstab_spmv_dots": lambda: ops.bicgstab_spmv_dots(xp, *T[:6], al, st),
        "bicgstab_spmv_update": lambda: ops.bicgstab_spmv_update(xp, *T[:6], OMEGA, BETA, st),
        "cheb_step": lambda: ops.cheb_step(xp, r, d, st, a=CHEB_A, c=CHEB_C),
        "jacobi_sweep": lambda: ops.jacobi_sweep(xp, r, st, omega=OMEGA),
        "axpbypcz": lambda: ops.axpbypcz(ALPHA, T[0], be, T[1], C2, T[2]),
        "axpbypcz_dot": lambda: ops.axpbypcz_dot(ALPHA, T[0], BETA, T[1], C2, T[2], T[3]),
        "cg_update": lambda: ops.cg_update(BETA, *T[:4]),
        "cheb_step_batched": lambda: ops.cheb_step(
            torch.stack([xp, xp]), torch.stack([r, d]), torch.stack([d, r]), st,
            a=CHEB_A, c=CHEB_C),
        "jacobi_sweep_batched": lambda: ops.jacobi_sweep(
            torch.stack([xp, xp]), torch.stack([r, d]), st, omega=OMEGA),
    }


SCALAR_WRAPPERS = ["cg_body", "pcg_body", "pipe_body", "ppipe_body", "bicgstab_update1",
                   "bicgstab_spmv_dots", "bicgstab_spmv_update", "cheb_step",
                   "jacobi_sweep", "axpbypcz", "axpbypcz_dot", "cg_update",
                   "cheb_step_batched", "jacobi_sweep_batched"]


@pytest.mark.parametrize("wrapper", SCALAR_WRAPPERS)
@pytest.mark.parametrize("dt", [torch.float64, torch.float32], ids=str)
def test_scalar_rounding_changes_no_f32_f64_bit(dt, wrapper, monkeypatch):
    """In float32 and float64 the wrappers' outputs with the scalars rounded
    to the operands' dtype are bitwise the outputs with them as given."""
    rounded = _flat_outputs(_plain_calls(dt, "27pt", (6, 5, 7))[wrapper]())
    _unrounded(monkeypatch)
    given = _flat_outputs(_plain_calls(dt, "27pt", (6, 5, 7))[wrapper]())
    assert len(rounded) == len(given)
    for a, b in zip(rounded, given):
        assert a.dtype == dt and torch.equal(a, b)


def test_autotune_cli_bfloat16_round_trip(tmp_path, capsys):
    """``--dtype bfloat16`` on the CPU: one plain-only entry keyed
    ``…|bfloat16|cpu``, read back by ``resolve``."""
    path = tmp_path / "tune.json"
    assert autotune.main(["--device", "cpu", "--grid", "4", "4", "4", "--stencil", "27pt",
                          "--dtype", "bfloat16", "--cache", str(path)]) == 0
    key = "27pt|4x4x4|bfloat16|cpu"
    assert key in capsys.readouterr().out
    table = autotune.load_cache(path)
    assert list(table) == [key] and key.endswith("|bfloat16|cpu")
    entry = table[key]
    assert entry["use_kernels"] is False and entry["run"] == autotune.DEFAULT_RUN
    assert entry["timings"]["run"] == {} and entry["timings"]["kernel_s"] is None
    assert entry["timings"]["plain_s"] > 0
    dec = autotune.resolve("27pt", (4, 4, 4), torch.bfloat16, "cpu", path=path)
    assert dec.source == "cache" and not dec.use_kernels


def test_solver_facade_rejects_bf16():
    """The kernels take bf16; a solve does not, as the reference's facade."""
    with pytest.raises(TypeError):
        make_problem((4, 4, 4), "7pt", dtype=torch.bfloat16, device="cpu")
    kop = KernelOp(LocalOp(STENCILS["27pt"]))
    x = torch.ones((4, 4, 4), dtype=torch.bfloat16)
    for call in (lambda: kop.matvec(x), lambda: kop.matvec_local(x),
                 lambda: kop.spmv_dots(x), lambda: kop.cg_body(ALPHA, BETA, x, x, x, x, x)):
        with pytest.raises(TypeError):
            call()


def test_mixed_dtypes_raise():
    v = torch.ones((4, 5, 6), dtype=torch.bfloat16)
    f = v.float()
    for call in (lambda: ops.cg_body(ALPHA, BETA, v, v, v, v, f),
                 lambda: ops.spmv_dots3(pad1(v), f, STENCILS["7pt"]),
                 lambda: ops.cheb_step(pad1(v), v, f, STENCILS["7pt"], a=0.5, c=0.5),
                 lambda: ops.fused_dots(v, f, v)):
        with pytest.raises(ValueError):
            call()
