"""The port's optimizer (``repro_torch.optim.adamw``) and LR schedules
(``repro_torch.optim.schedules``) against the JAX reference on the CPU.

Inputs are made with numpy from a seed and fed to both packages.
Tolerances:

* schedules: ``wsd``, ``constant`` and minicpm's ``for_arch`` (WSD) equal
  the reference's f32 lr bit for bit at every step; ``cosine`` (every other
  arch's ``for_arch``) within 2⁻²⁰ of the reference's lr, relative: XLA's
  f32 ``cos`` and PyTorch's round differently (neither is correctly
  rounded) and XLA contracts the schedule's multiply-adds into FMAs (4 ulps
  apart at most, measured);
* AdamW: every param, m and v within 4 f32 ulps of the array's largest
  magnitude (``ADAM_RTOL`` = 2⁻²¹) after each of 5 steps, the clip idle and
  active; the grad norm within 2⁻²¹ relative.  XLA on the CPU contracts
  ``b1·m + (1 - b1)·g`` into one FMA, PyTorch rounds the product first
  (measured: ≤ 2.9 ulps).  The f64 params get the same bound: the
  reference's update is f32 arithmetic whatever the params' dtype (moments,
  scale, lr and the update all f32, cast back), so f64 params move in f32
  steps on both sides.  bf16 params (f32 moments) within one bf16 ulp of the
  largest param (measured: equal).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from test_torch_harness import ref_module, to_np
from test_torch_harness import x64  # noqa: F401  (fixture)

from repro_torch.models.convert import to_tensor
from repro_torch.optim import adamw as port_adamw
from repro_torch.optim import schedules as port_sched

ref_adamw = ref_module("optim.adamw")
ref_sched = ref_module("optim.schedules")

COS_RTOL = 2.0 ** -20
ADAM_RTOL = 2.0 ** -21
BF16_ULP = 2.0 ** -8

SCHEDULES = {
    "wsd": (lambda m: m.wsd(3e-4, warmup=10, stable=80, decay=20), True),
    "wsd_final": (lambda m: m.wsd(1.0, warmup=0, stable=5, decay=7, final_frac=0.25), True),
    "constant": (lambda m: m.constant(1e-3), True),
    "minicpm": (lambda m: m.for_arch("minicpm-2b", 1e-3, 1000), True),
    "cosine": (lambda m: m.cosine(1e-3, warmup=7, total=100), False),
    "internlm2": (lambda m: m.for_arch("internlm2-1.8b", 1e-3, 1000), False),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_reference(name):
    """Steps 0..1199 (past the schedule's end), the step an int32 tensor."""
    make, exact = SCHEDULES[name]
    f_r, f_p = make(ref_sched), make(port_sched)
    steps = np.arange(1200, dtype=np.int32)
    want = np.asarray(jax.vmap(f_r)(jnp.asarray(steps)), dtype=np.float32)
    got = to_np(f_p(torch.from_numpy(steps)))
    got = np.broadcast_to(got, want.shape)      # constant: one 0-d lr for every step
    assert got.dtype == want.dtype == np.float32
    if exact:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    else:
        np.testing.assert_allclose(got, want, rtol=COS_RTOL, atol=0)


def test_schedule_takes_a_python_step_and_keeps_the_device():
    f = port_sched.for_arch("internlm2-1.8b", 1.0, 100)
    assert f(5).dtype == torch.float32 and f(5).shape == ()
    assert float(f(torch.tensor(5, dtype=torch.int32))) == float(f(5))
    assert port_sched.constant(0.5)(torch.tensor(3)).device.type == "cpu"


def test_minicpm_gets_wsd():
    """The reference's check: mid-run minicpm sits on WSD's plateau where a
    cosine would have decayed."""
    assert abs(float(port_sched.for_arch("minicpm-2b", 1.0, 1000)(500)) - 1.0) < 1e-6
    assert float(port_sched.for_arch("internlm2-1.8b", 1.0, 1000)(500)) < 0.9


def _tree(shapes: dict, rng, scale: float, np_dtype) -> dict:
    return {k: (scale * rng.standard_normal(s)).astype(np.float32).astype(np_dtype)
            for k, s in sorted(shapes.items())}


SHAPES = {"attn.wq": (7, 5), "bias": (13,), "mlp.w": (3, 4, 6), "scalar": ()}


def test_global_norm_matches_reference():
    rng = np.random.default_rng(0)
    tree = _tree(SHAPES, rng, 3.0, np.float32)
    want = float(ref_adamw.global_norm({k: jnp.asarray(v) for k, v in tree.items()}))
    got = port_adamw.global_norm({k: to_tensor(v) for k, v in tree.items()})
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= ADAM_RTOL * want
    five = port_adamw.global_norm({"a": torch.tensor([3.0]), "b": torch.tensor([4.0])})
    assert float(five) == 5.0


def _assert_close(got: torch.Tensor, want, rtol: float) -> None:
    a = to_np(got.float() if got.dtype == torch.bfloat16 else got).astype(np.float64)
    b = np.asarray(want).astype(np.float64)
    assert a.shape == b.shape
    err, scale = np.abs(a - b).max(), np.abs(b).max()
    assert err <= rtol * scale, f"max |Δ| {err:.3e} > {rtol:.3e} × {scale:.3e}"


def _five_steps(np_dtype, clip_active: bool):
    """Five AdamW steps of both packages from the same seeded params and
    grads (clip active: grads ~ N(0, 10²), a global norm ~100 ≫ 1; idle:
    N(0, 0.01²)); yields each step's (port, reference) trees."""
    rng = np.random.default_rng(1)
    params = _tree(SHAPES, rng, 1.0, np_dtype)
    opt_r = ref_adamw.adamw(ref_sched.cosine(1e-2, 2, 10))
    opt_p = port_adamw.adamw(port_sched.cosine(1e-2, 2, 10))
    pr = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: to_tensor(v.copy()) for k, v in params.items()}
    sr, sp = opt_r.init(pr), opt_p.init(pp)
    upd = jax.jit(opt_r.update)
    for _ in range(5):
        g = _tree(SHAPES, rng, 10.0 if clip_active else 0.01, np_dtype)
        pr, sr, mr = upd({k: jnp.asarray(v) for k, v in g.items()}, sr, pr)
        pp, sp, mp = opt_p.update({k: to_tensor(v) for k, v in g.items()}, sp, pp)
        assert (float(mr["grad_norm"]) > 1.0) == clip_active
        yield (pp, sp, mp), (pr, sr, mr)


def _check_step(port, ref, param_rtol: float, dtype: torch.dtype) -> None:
    (pp, sp, mp), (pr, sr, mr) = port, ref
    assert int(sp.step) == int(sr.step)
    assert abs(float(mp["lr"]) - float(mr["lr"])) <= COS_RTOL * float(mr["lr"])
    gn = float(mr["grad_norm"])
    assert abs(float(mp["grad_norm"]) - gn) <= ADAM_RTOL * gn
    for k in SHAPES:
        assert pp[k].dtype == dtype and sp.m[k].dtype == sp.v[k].dtype == torch.float32
        _assert_close(pp[k], pr[k], param_rtol)
        _assert_close(sp.m[k], sr.m[k], ADAM_RTOL)
        _assert_close(sp.v[k], sr.v[k], ADAM_RTOL)


@pytest.mark.parametrize("clip_active", [False, True])
def test_adamw_matches_reference_f32(clip_active):
    for port, ref in _five_steps(np.float32, clip_active):
        _check_step(port, ref, ADAM_RTOL, torch.float32)


@pytest.mark.parametrize("clip_active", [False, True])
def test_adamw_matches_reference_f64(clip_active, x64):
    for port, ref in _five_steps(np.float64, clip_active):
        _check_step(port, ref, ADAM_RTOL, torch.float64)


@pytest.mark.parametrize("clip_active", [False, True])
def test_adamw_f32_moments_over_bf16_params(clip_active):
    for port, ref in _five_steps(ml_dtypes.bfloat16, clip_active):
        _check_step(port, ref, BF16_ULP, torch.bfloat16)


def test_adamw_leaves_its_inputs_and_records_no_graph():
    opt = port_adamw.adamw(port_sched.constant(1e-2))
    p = {"w": torch.nn.Parameter(torch.ones(4))}
    state = opt.init(p)
    g = {"w": torch.full((4,), 0.5)}
    new_p, new_state, _ = opt.update(g, state, p)
    assert torch.equal(p["w"].detach(), torch.ones(4)) and int(state.step) == 0
    assert not torch.equal(new_p["w"], p["w"].detach()) and int(new_state.step) == 1
    assert not new_p["w"].requires_grad and state.step.device.type == "cpu"


def test_adamw_minimises_quadratic():
    """The reference's check: 300 steps of lr 0.05 drive Σw² below 1e-3."""
    opt = port_adamw.adamw(port_sched.constant(0.05), weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0, 1.5])}
    state = opt.init(params)
    for _ in range(300):
        params, state, _ = opt.update({"w": 2 * params["w"]}, state, params)
    assert float(torch.sum(params["w"] ** 2)) < 1e-3


def test_grad_clipping_keeps_the_update_finite():
    opt = port_adamw.adamw(port_sched.constant(1e-3), clip_norm=1.0)
    p2, _, m = opt.update({"w": torch.full((4,), 1e6)}, opt.init({"w": torch.zeros(4)}),
                          {"w": torch.zeros(4)})
    assert float(m["grad_norm"]) > 1e6 and bool(torch.isfinite(p2["w"]).all())
