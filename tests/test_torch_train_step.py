"""The port's training step (``repro_torch.models.steps.make_train_step``),
its trainer (``repro_torch.launch.train``) and the SSD chunk's backward
against the JAX reference on the CPU.

One step of ``make_train_step`` from the same weights (``models.convert``),
the same batch and a fresh AdamW (constant lr 1e-3) against the reference's
jitted step: plain, with ``accum=2`` and with the int8 error-feedback
transform (its scales one a stacked leaf on both sides:
``convert.reference_name``).  Tolerances, in f32: ``loss``, ``ce``, ``aux``
and ``grad_norm`` within 1e-5 relative; m and v within 1e-4 of each leaf's
largest magnitude; the params within the reference's own accumulation bounds
(rtol 2e-4, atol 2e-5, ``tests/test_models.py``), but where the two
gradients differ by more than 1e-3 of themselves (near 0): a first AdamW
step moves p by lr·g/(|g| + eps), which is rounding noise there, so p is
held within 2·lr of the reference's; the params outside rtol/atol are at
most 1 % of all.  Under the int8 transform
a gradient within 1e-6 of a rounding boundary may take the next code on the
other side: at most ``MAX_CODE_FLIPS`` elements of m (and of the carried
error) differ, each by one code, the rest within the bounds above (measured:
one element of the ~100k).

The trainer: a run that fails at step 3 and resumes from its checkpoint
ends on the straight run's loss (rtol 1e-4, the reference's
``tests/test_runtime.py``).  ``ssm._chunk_step``: the forward bitwise the
formula that took ``exp`` before masking; gradients within 1e-4 of the
reference's largest at the reduced widths; finite where the reference's
are NaN.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_harness import ref_module, seeded
from test_torch_models import tt
from test_torch_models import one_thread  # noqa: F401  (fixture)
from test_torch_train import (GRAD_RTOL, LOSS_RTOL, _rel, assert_leaves_close, get_pair,
                              train_batch)

from repro_torch.configs.base import get_config
from repro_torch.distributed import compression as port_comp
from repro_torch.launch import train as port_train
from repro_torch.models import convert, moe, ssm
from repro_torch.models import steps as port_steps
from repro_torch.models import transformer as port_tf
from repro_torch.optim import adamw as port_adamw
from repro_torch.optim import schedules as port_sched
from repro_torch.runtime import elastic

ref_steps = ref_module("models.steps")
ref_adamw = ref_module("optim.adamw")
ref_sched = ref_module("optim.schedules")
ref_comp = ref_module("distributed.compression")
ref_ssm = ref_module("models.ssm")
ref_base = ref_module("configs.base")

PARAM_RTOL, PARAM_ATOL = 2e-4, 2e-5
LR = 1e-3
MAX_CODE_FLIPS = 10
NOISE = 1e-3

CASES = [("internlm2-1.8b", "plain"), ("internlm2-1.8b", "accum"), ("internlm2-1.8b", "int8"),
         ("qwen3-moe-235b-a22b", "plain"), ("qwen2-vl-7b", "accum")]


def _steps(arch: str, mode: str):
    """One step of each package: (port's (opt_state, ef, metrics, model),
    reference's (params, opt_state, ef, metrics))."""
    p = get_pair(arch)
    batch = train_batch(p, 4, 32, seed=11, mask=False)
    accum = 2 if mode == "accum" else 1
    model = convert.params_from_reference(p.cfg, jax.tree.map(np.asarray, p.tree))
    params = dict(model.named_parameters())
    opt_r, opt_p = ref_adamw.adamw(ref_sched.constant(LR)), port_adamw.adamw(
        port_sched.constant(LR))
    gt_r = gt_p = ef_r = ef_p = None
    if mode == "int8":
        gt_r = ref_comp.make_ef_int8_transform()
        gt_p = port_comp.make_ef_int8_transform(
            {k: convert.reference_name(p.cfg, k) for k in params})
        ef_r, ef_p = ref_comp.init_error_feedback(p.tree), port_comp.init_error_feedback(params)
    step_r = jax.jit(ref_steps.make_train_step(p.ctx_r, opt_r, gt_r, accum=accum))
    ref = step_r(p.tree, opt_r.init(p.tree), ef_r, {k: jnp.asarray(v) for k, v in batch.items()})
    step_p = port_steps.make_train_step(model.ctx, opt_p, gt_p, accum=accum)
    port = step_p(model, opt_p.init(params), ef_p, {k: tt(v) for k, v in batch.items()})
    return p, port + (model,), ref


def _flips(cfg, port_named: dict, ref_tree, rtol: float) -> int:
    """Elements outside ``rtol`` of their leaf's largest magnitude."""
    got = convert._flatten(convert.reference_tree(cfg, port_named))
    want = convert._flatten(jax.tree.map(np.asarray, ref_tree))
    return sum(int((np.abs(got[k] - w) > rtol * np.abs(w).max()).sum()) for k, w in want.items())


@pytest.mark.parametrize("arch, mode", CASES)
def test_train_step_matches_reference(arch, mode):
    p, (state, ef, metrics, model), (params_r, state_r, ef_r, metrics_r) = _steps(arch, mode)
    assert set(metrics) == {"loss", "ce", "aux", "grad_norm", "lr"}
    for k in ("loss", "ce", "grad_norm"):
        assert _rel(float(metrics[k]), float(metrics_r[k])) <= LOSS_RTOL, k
    assert abs(float(metrics["aux"]) - float(metrics_r["aux"])) <= LOSS_RTOL * max(
        float(metrics_r["aux"]), 1.0)
    assert float(metrics["lr"]) == float(metrics_r["lr"]) and int(state.step) == 1
    if mode == "accum":          # the reference's quirk: ce is the loss, aux 0
        assert float(metrics["ce"]) == float(metrics["loss"]) and float(metrics["aux"]) == 0
    if mode == "int8":
        flips = _flips(p.cfg, state.m, state_r.m, GRAD_RTOL)
        assert flips <= MAX_CODE_FLIPS
        # one code of a leaf is 1/127 of its largest |m| (m = 0.1·g after one step)
        assert_leaves_close(p.cfg, state.m, state_r.m, 1.01 / 127)
        assert _flips(p.cfg, ef, ef_r, GRAD_RTOL * 127) <= flips
    else:
        assert_leaves_close(p.cfg, state.m, state_r.m, GRAD_RTOL)
        assert_leaves_close(p.cfg, state.v, state_r.v, GRAD_RTOL)
    got = convert._flatten(convert.reference_tree(
        p.cfg, {k: v.detach() for k, v in model.named_parameters()}))
    m_r = convert._flatten(jax.tree.map(np.asarray, state_r.m))
    m_p = convert._flatten(convert.reference_tree(p.cfg, state.m))
    n_bad = n_all = 0
    for k, w in convert._flatten(jax.tree.map(np.asarray, params_r)).items():
        # a first step moves p by lr·g/(|g| + eps): where the two gradients
        # (m = 0.1·clip·g) disagree by more than NOISE of themselves, near 0,
        # that is noise, and p may move either way
        noise = np.abs(m_p[k] - m_r[k]) > NOISE * np.abs(m_r[k])
        diff = np.abs(got[k] - w)
        bad = diff > PARAM_ATOL + PARAM_RTOL * np.abs(w)
        assert not (bad & ~noise).any(), k
        assert (diff[noise] <= 2 * LR + PARAM_ATOL).all(), k
        n_bad, n_all = n_bad + int(bad.sum()), n_all + bad.size
    assert n_bad <= n_all // 100, (n_bad, n_all)


def test_accum_matches_the_full_batch_in_the_port():
    """The reference's own check, in the port: ``accum=2`` against one
    batch of 4 (loss rtol 1e-5, params rtol 2e-4 / atol 2e-5)."""
    p = get_pair("internlm2-1.8b")
    batch = {k: tt(v) for k, v in train_batch(p, 4, 32, seed=12, mask=False).items()}
    out = []
    for accum in (1, 2):
        model = convert.params_from_reference(p.cfg, jax.tree.map(np.asarray, p.tree))
        opt = port_adamw.adamw(port_sched.constant(1e-3))
        _, _, m = port_steps.make_train_step(model.ctx, opt, accum=accum)(
            model, opt.init(dict(model.named_parameters())), None, batch)
        out.append((m, model))
    (m1, a), (m2, b) = out
    assert _rel(float(m2["loss"]), float(m1["loss"])) <= LOSS_RTOL
    for (k, x), y in zip(a.named_parameters(), b.parameters(), strict=True):
        torch.testing.assert_close(y.detach(), x.detach(), rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   msg=k)


def test_split_microbatches_cuts_row_blocks():
    x = torch.arange(24).reshape(4, 6)
    pos3 = torch.arange(3 * 4 * 6).reshape(3, 4, 6)
    parts = port_steps._split_microbatches({"tokens": x, "positions": pos3,
                                            "src_positions": x}, 2)
    assert len(parts) == 2
    assert torch.equal(parts[1]["tokens"], x[2:]) and torch.equal(parts[1]["src_positions"], x[2:])
    assert torch.equal(parts[0]["positions"], pos3[:, :2])
    with pytest.raises(ValueError, match="multiple of accum=3"):
        port_steps._split_microbatches({"tokens": x}, 3)


def test_moe_stats_record_each_forward_once_under_remat():
    """A remat'd MoE layer runs twice (forward, then the recompute for the
    backward); its ``stats`` side channel records the first only."""
    p = get_pair("qwen3-moe-235b-a22b")
    layer = p.model.layers[0]

    class Counted(dict):
        updates = 0

        def update(self, *a, **k):
            Counted.updates += 1
            super().update(*a, **k)

    stats = Counted()
    x = tt(seeded((2, 16, p.cfg.d_model), 1, np.float32)).requires_grad_()
    out = torch.utils.checkpoint.checkpoint(
        lambda y: moe.moe_forward(layer.moe, p.cfg, y, stats=stats)[0], x,
        use_reentrant=False, context_fn=port_tf._remat_contexts)
    out.sum().backward()
    assert Counted.updates == 1 and stats["path"] in ("gather", "dispatch")
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


# =============================================================================
# The trainer
# =============================================================================

COMMON = ["--arch", "internlm2-1.8b", "--reduced", "--device", "cpu", "--steps", "6",
          "--batch", "2", "--seq", "32", "--ckpt-every", "2"]


def test_failure_injection_and_resume_equivalence(tmp_path):
    """The reference's test, ported: 6 steps straight against fail-at-3 and
    a resume from the step-4 checkpoint (written before the failure); the
    same last loss (rtol 1e-4) and the same params (the replay runs the
    same kernels on the same data)."""
    ref = port_train.main(COMMON)
    assert len(ref["losses"]) == 6 and all(math.isfinite(x) for x in ref["losses"])
    assert ref["losses"][-1] < ref["losses"][0]
    d = str(tmp_path / "ck")
    out = port_train.main(COMMON + ["--ckpt-dir", d, "--fail-at", "3"])
    assert out["failed_at"] == 3 and len(out["losses"]) == 4
    resumed = port_train.main(COMMON + ["--ckpt-dir", d])
    assert len(resumed["losses"]) == 2
    np.testing.assert_allclose(resumed["losses"][-1], ref["losses"][-1], rtol=1e-4)
    final = dict(resumed["final_params"].named_parameters())
    for k, v in ref["final_params"].named_parameters():
        torch.testing.assert_close(final[k], v, rtol=1e-4, atol=1e-6, msg=k)


@pytest.mark.parametrize("extra", [["--compress"], ["--accum", "2"], ["--dtype", "bfloat16"]])
def test_trainer_options_run_finite(extra):
    out = port_train.main(COMMON[:5] + ["--steps", "3", "--batch", "2", "--seq", "16"] + extra)
    assert len(out["losses"]) == 3 and all(math.isfinite(x) for x in out["losses"])
    if "--dtype" in extra:
        assert all(p.dtype == torch.bfloat16 for p in out["final_params"].parameters()
                   if p.dtype != torch.float32)


def test_trainer_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    """With no card and no ``--device cpu`` the trainer fails; it never
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        port_train.main(["--arch", "internlm2-1.8b", "--reduced", "--steps", "1"])
    with pytest.raises(ValueError, match="floating dtype"):
        port_train.main(COMMON + ["--dtype", "int32"])


def test_trainer_and_reshard_state_refuse_a_mesh(monkeypatch):
    """The families whose sharded step is not ported (ssm, hybrid, enc-dec)
    refuse a mesh, naming the ROADMAP item, before any group is joined;
    the dense, vlm and moe families take one (``test_torch_train_mesh.py``)."""
    from repro_torch.launch.mesh import Mesh
    monkeypatch.setenv("WORLD_SIZE", "2")
    for arch in ("mamba2-780m", "hymba-1.5b", "seamless-m4t-large-v2"):
        argv = ["--arch", arch] + COMMON[2:]
        with pytest.raises(NotImplementedError, match="item 14d"):
            port_train.main(argv)
        with pytest.raises(NotImplementedError, match="item 14d"):
            elastic.reshard_state({}, None, Mesh.one_rank(("data", "model")),
                                  get_config(arch).reduced())


# =============================================================================
# The SSD chunk's backward
# =============================================================================

def _old_chunk_step(h, xck, Bck, Cck, dtc, A, tri):
    """The chunk step as it took ``exp`` before masking (the yardstick of
    the forward's bits)."""
    a = dtc * A
    cum = torch.cumsum(a, dim=1)
    CB = torch.einsum("bin,bjn->bij", Cck, Bck)
    decay = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])
    M = torch.where(tri[None, :, :, None], CB[..., None] * decay * dtc[:, None, :, :], 0.0)
    y = torch.einsum("bijh,bjhp->bihp", M, xck)
    y = y + torch.einsum("bin,bhpn->bihp", Cck, h) * torch.exp(cum)[..., None]
    a_sum = cum[:, -1]
    carry_decay = torch.exp(a_sum[:, None, :] - cum)
    h_new = (torch.exp(a_sum)[:, :, None, None] * h
             + torch.einsum("bjh,bjn,bjhp->bhpn", carry_decay * dtc, Bck, xck))
    return h_new, y


def _chunk_inputs(Bn: int, Q: int, nH: int, P: int, N: int, dt: float | None, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bn, Q, nH, P)).astype(np.float32)
    Bm = rng.standard_normal((Bn, Q, N)).astype(np.float32)
    Cm = rng.standard_normal((Bn, Q, N)).astype(np.float32)
    dts = (np.full((Bn, Q, nH), dt, np.float32) if dt is not None
           else (0.05 + 0.1 * rng.random((Bn, Q, nH))).astype(np.float32))
    h = (0.1 * rng.standard_normal((Bn, nH, P, N))).astype(np.float32)
    A = -np.arange(1, nH + 1, dtype=np.float32)
    return [tt(v) for v in (h, x, Bm, Cm, dts)] + [tt(A)]


@pytest.mark.parametrize("Q, nH, dt", [(16, 4, None), (32, 8, 0.3), (128, 48, 0.1)])
def test_chunk_step_forward_is_bitwise_the_old_formula(Q, nH, dt):
    h, x, Bm, Cm, dts, A = _chunk_inputs(2, Q, nH, 4, 8, dt, seed=Q)
    tri = torch.ones((Q, Q), dtype=torch.bool).tril()
    with torch.no_grad():
        new = ssm._chunk_step(h, x, Bm, Cm, dts, A, tri)
        old = _old_chunk_step(h, x, Bm, Cm, dts, A, tri)
    for a, b in zip(new, old, strict=True):
        assert torch.equal(a, b)


def test_ssm_forward_grads_match_reference():
    """``ssm_forward`` over 3 chunks of mamba2's reduced block: the
    gradients of Σ out·w against every parameter and x, within 1e-4 of the
    reference's largest."""
    cfg = get_config("mamba2-780m").reduced()
    cfg_r = ref_base.get_config("mamba2-780m").reduced()
    pr = {k: np.asarray(v) for k, v in
          ref_ssm.init_ssm_params(jax.random.PRNGKey(3), cfg_r, jnp.float32).items()}
    block = ssm.SSM(cfg, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for k, v in block.named_parameters():
            v.copy_(tt(pr[k]))
    S = 3 * cfg.ssm_chunk
    x = seeded((2, S, cfg.d_model), 5, np.float32)
    w = seeded((2, S, cfg.d_model), 6, np.float32)

    def ref_loss(q, y):
        return jnp.sum(ref_ssm.ssm_forward(q, cfg_r, y) * w)

    gp_r, gx_r = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(
        {k: jnp.asarray(v) for k, v in pr.items()}, jnp.asarray(x))
    xt = tt(x).requires_grad_()
    (ssm.ssm_forward(block, cfg, xt) * tt(w)).sum().backward()
    pairs = [(xt.grad, gx_r)] + [(v.grad, gp_r[k]) for k, v in block.named_parameters()]
    for got, want in pairs:
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= GRAD_RTOL * np.abs(want).max()


def test_chunk_step_grads_finite_where_the_references_are_not():
    """One chunk at mamba2's widths' exponents: nH = 48, Q = 128, dt = 0.1,
    A = -(1..48), so cum_i - cum_j reaches 48·0.1·127 ≈ 610 above the
    diagonal.  The forward is finite on both sides; the reference's
    gradients of dt, B and C are not, the port's are."""
    nH, Q, P, N = 48, 128, 4, 8
    h, x, Bm, Cm, dts, A = _chunk_inputs(1, Q, nH, P, N, 0.1, seed=7)
    tri = torch.ones((Q, Q), dtype=torch.bool).tril()
    span = float((torch.cumsum(dts * A, 1)[0, 0] - torch.cumsum(dts * A, 1)[0, -1]).max())
    assert span > 600

    def ref_chunk(hh, xx, bb, cc, dd):
        a = dd * jnp.asarray(A.numpy())
        cum = jnp.cumsum(a, axis=1)
        CB = jnp.einsum("bin,bjn->bij", cc, bb)
        decay = jnp.exp(cum[:, :, None, :] - cum[:, None, :, :])
        trj = jnp.tril(jnp.ones((Q, Q), bool))
        M = jnp.where(trj[None, :, :, None], CB[..., None] * decay * dd[:, None, :, :], 0.0)
        y = jnp.einsum("bijh,bjhp->bihp", M, xx)
        y = y + jnp.einsum("bin,bhpn->bihp", cc, hh) * jnp.exp(cum)[..., None]
        return jnp.sum(y)

    grads_r = jax.grad(ref_chunk, argnums=(2, 3, 4))(
        *[jnp.asarray(t.numpy()) for t in (h, x, Bm, Cm, dts)])
    assert not any(bool(np.isfinite(np.asarray(g)).all()) for g in grads_r)

    ins = [t.clone().requires_grad_() for t in (x, Bm, Cm, dts)]
    _, y = ssm._chunk_step(h, *ins, A, tri)
    assert bool(torch.isfinite(y).all())
    y.sum().backward()
    assert all(bool(torch.isfinite(t.grad).all()) for t in ins)


def test_ssm_forward_keeps_its_bits_at_full_span():
    """A reduced mamba2 block at chunk 128 with big steps (the overflowing
    upper triangle): the whole ``ssm_forward`` through the old chunk step
    and the new one, bitwise."""
    cfg = dataclasses.replace(get_config("mamba2-780m").reduced(), ssm_chunk=128)
    block = ssm.init_ssm_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    with torch.no_grad():
        block.dt_bias.fill_(2.0)
    x = tt(seeded((1, 256, cfg.d_model), 4, np.float32))
    with torch.inference_mode():
        new = ssm.ssm_forward(block, cfg, x)
        real = ssm._chunk_step
        ssm._chunk_step = _old_chunk_step
        try:
            old = ssm.ssm_forward(block, cfg, x)
        finally:
            ssm._chunk_step = real
    assert torch.equal(new, old)
