"""The port's loss (``repro_torch.models.steps.lm_loss``) and its gradients
against the JAX reference's on the CPU, for all ten reduced configs; the
layers' remat (``ModelCtx.remat``) against no remat.

The reference's weights reach the port through ``models.convert``
(``test_torch_models.Pair``: the reference's init with seeded norm scales
and biases); the port's gradients go back to the reference's stacked tree
through ``convert.reference_tree`` and are compared leaf by leaf with
``jax.value_and_grad`` of the reference's ``lm_loss``.  Inputs are made with
numpy from a seed: tokens (the VLM's vision embeds and three M-RoPE
streams; the enc-dec model's source frames), targets, and a ``loss_mask``
with about a fifth of the positions off.

Tolerances, in f32: the loss, ``ce`` and ``aux`` within 1e-5 relative
(``LOSS_RTOL``); each gradient leaf within 1e-4 of that leaf's largest
magnitude (``GRAD_RTOL``; measured ≤ 3.8e-6 over the ten configs).  Remat
on and off give the same bits (the recompute runs the same kernels on the
same inputs).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_harness import ref_module
from test_torch_models import ARCHS, Pair, _ref_tree, tt
from test_torch_models import one_thread  # noqa: F401  (fixture)

from repro_torch.models import convert
from repro_torch.models import steps as port_steps
from repro_torch.models import transformer as port_tf

ref_steps = ref_module("models.steps")

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4

_PAIRS: dict[str, Pair] = {}


def get_pair(arch: str) -> Pair:
    if arch not in _PAIRS:
        _PAIRS[arch] = Pair(arch)
    return _PAIRS[arch]


def train_batch(p: Pair, B: int, S: int, seed: int, mask: bool = True) -> dict:
    """``Pair.batch`` (vision embeds for the VLM) plus ``targets`` and, with
    ``mask``, a ``loss_mask`` of about 80 % ones."""
    b = p.batch(B, S, seed, embeds=p.cfg.frontend == "vision")
    rng = np.random.default_rng(seed + 1000)
    b["targets"] = rng.integers(0, p.cfg.vocab_size, (B, S)).astype(np.int32)
    if mask:
        b["loss_mask"] = (rng.random((B, S)) > 0.2).astype(np.float32)
    return b


def ref_value_and_grad(p: Pair, batch: dict):
    fn = jax.jit(jax.value_and_grad(lambda q, b: ref_steps.lm_loss(p.ctx_r, q, b),
                                    has_aux=True))
    (loss, metrics), grads = fn(p.tree, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def port_value_and_grad(ctx, model, batch: dict):
    loss, metrics = port_steps.lm_loss(ctx, model, {k: tt(v) for k, v in batch.items()})
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, dict(zip(names, grads))


def assert_leaves_close(cfg, port_named: dict, ref_tree, rtol: float) -> None:
    """Every leaf of the reference's tree against the port's, carried back
    by ``convert.reference_tree``: max |Δ| ≤ rtol · max |reference|."""
    got = convert._flatten(convert.reference_tree(cfg, port_named))
    want = convert._flatten(jax.tree.map(np.asarray, ref_tree))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        a, b = got[k].astype(np.float64), w.astype(np.float64)
        assert a.shape == b.shape, k
        err, scale = np.abs(a - b).max(), np.abs(b).max()
        assert err <= rtol * scale, f"{k}: max |Δ| {err:.3e} > {rtol:g} × {scale:.3e}"


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_tree_inverts_params_from_reference(arch):
    """``params_from_reference`` then ``reference_tree`` gives the input tree
    back exactly (f32, and the reference's bf16 init for the first config):
    the same nesting, shapes, dtypes and bits; a stack with a layer missing
    raises."""
    p = get_pair(arch)
    trees = [jax.tree.map(np.asarray, p.tree)]
    if arch == ARCHS[0]:
        trees.append(jax.tree.map(np.asarray, _ref_tree(p.cfg_r, jnp.bfloat16)))
    for tree in trees:
        model = convert.params_from_reference(p.cfg, tree)
        back = convert.reference_tree(p.cfg, dict(model.named_parameters()))
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree), strict=True):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    if not port_tf._superlayers(p.cfg):       # llama4's stacks are one layer deep here
        named = dict(model.named_parameters())
        named.pop(next(k for k in named if k.startswith("layers.1.")))
        with pytest.raises(ValueError, match="missing"):
            convert.reference_tree(p.cfg, named)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_reference(arch):
    """B = 2, S = 32 (two SSD chunks of 16), the loss masked."""
    p = get_pair(arch)
    batch = train_batch(p, 2, 32, seed=3)
    loss_r, metrics_r, grads_r = ref_value_and_grad(p, batch)
    loss, metrics, grads = port_value_and_grad(p.ctx, p.model, batch)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert _rel(float(loss), loss_r) <= LOSS_RTOL
    assert _rel(float(metrics["ce"]), metrics_r["ce"]) <= LOSS_RTOL
    assert abs(float(metrics["aux"]) - metrics_r["aux"]) <= LOSS_RTOL * max(metrics_r["aux"], 1.0)
    assert (metrics_r["aux"] > 0) == (p.cfg.family == "moe")
    assert_leaves_close(p.cfg, grads, grads_r, GRAD_RTOL)


def test_lm_loss_chunks_the_head_and_honours_the_mask():
    """S = 600: two head chunks of 300 (``_ce_chunk_size``), against the
    reference; a mask of all zeros but one position gives that position's
    cross entropy; no mask is a mask of ones."""
    assert port_steps._ce_chunk_size(600) == 300 and port_steps._ce_chunk_size(128) == 128
    assert port_steps._ce_chunk_size(1024) == 512
    p = get_pair("internlm2-1.8b")
    batch = train_batch(p, 1, 600, seed=4)
    loss_r, _, grads_r = ref_value_and_grad(p, batch)
    loss, _, grads = port_value_and_grad(p.ctx, p.model, batch)
    assert _rel(float(loss), loss_r) <= LOSS_RTOL
    assert_leaves_close(p.cfg, grads, grads_r, GRAD_RTOL)

    small = train_batch(p, 2, 16, seed=5, mask=False)
    with torch.no_grad():
        plain, _ = port_steps.lm_loss(p.ctx, p.model, {k: tt(v) for k, v in small.items()})
        ones = dict(small, loss_mask=np.ones((2, 16), np.float32))
        assert torch.equal(port_steps.lm_loss(p.ctx, p.model,
                                              {k: tt(v) for k, v in ones.items()})[0], plain)
        one = np.zeros((2, 16), np.float32)
        one[1, 7] = 1.0
        got, _ = port_steps.lm_loss(p.ctx, p.model,
                                    {k: tt(v) for k, v in dict(small, loss_mask=one).items()})
        logits = port_steps.make_forward(p.ctx)(p.model, {k: tt(v) for k, v in small.items()})
        want = torch.nn.functional.cross_entropy(logits[1, 7:8], tt(small["targets"][1, 7:8]).long())
    torch.testing.assert_close(got, want, rtol=LOSS_RTOL, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_give_the_same_bits(arch):
    """The loss and every gradient bitwise with ``remat`` on (each layer,
    llama4's superlayer pair, each encoder layer under
    ``torch.utils.checkpoint``) and off."""
    p = get_pair(arch)
    batch = train_batch(p, 2, 32, seed=6)
    on = port_tf.ModelCtx(cfg=p.cfg, dtype=torch.float32, device="cpu", remat=True)
    off = port_tf.ModelCtx(cfg=p.cfg, dtype=torch.float32, device="cpu", remat=False)
    loss_on, m_on, g_on = port_value_and_grad(on, p.model, batch)
    loss_off, m_off, g_off = port_value_and_grad(off, p.model, batch)
    assert torch.equal(loss_on, loss_off) and torch.equal(m_on["aux"], m_off["aux"])
    for k in g_off:
        assert torch.equal(g_on[k], g_off[k]), k


def test_remat_wraps_each_layer_only_where_autograd_records(monkeypatch):
    """Checkpoint calls: one a layer (llama4: one a dense + MoE pair; the
    enc-dec model: one an encoder layer and one a decoder layer) plus one a
    head chunk in ``lm_loss``; none under ``no_grad``."""
    calls = []
    real = port_tf.checkpoint

    def counted(fn, *a, **k):
        calls.append(fn.__name__)
        return real(fn, *a, **k)

    monkeypatch.setattr(port_tf, "checkpoint", counted)
    for arch, want in (("internlm2-1.8b", 2), ("llama4-maverick-400b-a17b", 1),
                       ("seamless-m4t-large-v2", 4)):
        p = get_pair(arch)
        calls.clear()
        batch = {k: tt(v) for k, v in train_batch(p, 2, 16, seed=7).items()}
        port_tf.forward_hidden(p.ctx, p.model, batch)
        assert len(calls) == want, (arch, calls)
        calls.clear()
        with torch.no_grad():
            port_tf.forward_hidden(p.ctx, p.model, batch)
        assert not calls


def test_train_specs_are_the_references():
    """``input_specs`` of the train cells: the reference's names and shapes
    (``targets`` beside the prefill's inputs), realised by
    ``synthetic_batch`` into a batch ``lm_loss`` takes."""
    for arch in ARCHS:
        p = get_pair(arch)
        spec = port_steps.input_specs(p.cfg, "train_4k", override=(16, 2), dtype=torch.float32)
        ref = ref_steps.input_specs(p.cfg_r, "train_4k", override=(16, 2), dtype=jnp.float32)
        assert {k: tuple(v.shape) for k, v in spec.items()} == {
            k: tuple(v.shape) for k, v in ref.items()}
        assert all(v.device.type == "meta" for v in spec.values())
        batch = port_steps.synthetic_batch(p.cfg, "train_4k", torch.Generator().manual_seed(0),
                                           override=(16, 2), dtype=torch.float32, device="cpu")
        assert int(batch["targets"].max()) < p.cfg.vocab_size
        with torch.no_grad():
            loss, _ = port_steps.lm_loss(p.ctx, p.model, batch)
        assert bool(torch.isfinite(loss))
