"""The port's data pipeline (``repro_torch.data.pipeline``) and int8
gradient compression with error feedback (``repro_torch.distributed.
compression``) against the JAX reference on the CPU.

Tolerances: the pipeline's batches equal the reference's array for array
(values, dtypes and shapes) for every flag combination, step and shard;
the int8 codes, the scales, the dequantised gradients and the carried
error equal the reference's bit for bit over three error-feedback steps
when the reference runs op by op (``torch.round`` and ``jnp.round`` both
round half to even, and ``x / scale`` is one IEEE division on both sides);
under ``jax.jit`` XLA's fusion moves the scale and the error in the last
bit, and they are held within 2⁻²² and 2⁻²¹ of the largest magnitude
(``test_error_feedback_near_the_jitted_references``).
"""

from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_harness import ref_module, to_np

from repro_torch.data import pipeline as port_pipe
from repro_torch.distributed import compression as port_comp

ref_pipe = ref_module("data.pipeline")
ref_comp = ref_module("distributed.compression")

#: (mrope, frontend, enc_dec): text, M-RoPE text, the VLM's vision
#: embeds with M-RoPE, audio embeds, enc-dec over audio, enc-dec alone
FLAGS = [(False, "none", False), (True, "none", False), (True, "vision", False),
         (False, "audio", False), (False, "audio", True), (False, "none", True)]


def _cfg(mod, **kw):
    base = dict(batch_size=4, seq_len=16, n_shards=2, shard=0, seed=7, d_model=8)
    base.update(kw)
    return mod.PipelineConfig(**base)


def _assert_batches_equal(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        assert isinstance(got[k], np.ndarray)
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("mrope, frontend, enc_dec", FLAGS)
def test_make_batch_equals_the_references(mrope, frontend, enc_dec):
    """Steps 0, 1, 5 and 1000 of shards 0 and 1, two seeds."""
    for seed, shard, step in itertools.product((0, 7), (0, 1), (0, 1, 5, 1000)):
        flags = dict(mrope=mrope, frontend=frontend, enc_dec=enc_dec, shard=shard, seed=seed)
        got = port_pipe.make_batch(port_pipe.SyntheticSource(1000, seed),
                                   _cfg(port_pipe, **flags), step)
        want = ref_pipe.make_batch(ref_pipe.SyntheticSource(1000, seed),
                                   _cfg(ref_pipe, **flags), step)
        _assert_batches_equal(got, want)


def test_targets_are_shifted_tokens_and_steps_and_shards_differ():
    src = port_pipe.SyntheticSource(1000, seed=7)
    b = port_pipe.make_batch(src, _cfg(port_pipe), 0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["targets"][:, :-1])
    assert not np.array_equal(b["tokens"], port_pipe.make_batch(src, _cfg(port_pipe), 1)["tokens"])
    assert not np.array_equal(b["tokens"],
                              port_pipe.make_batch(src, _cfg(port_pipe, shard=1), 0)["tokens"])


def test_resume_continuity_and_the_references_stream():
    """``batches(start_step=3)`` is the tail of ``batches(0)``, and both are
    the reference's stream."""
    src, cfg = port_pipe.SyntheticSource(1000, seed=7), _cfg(port_pipe, mrope=True)
    full = list(itertools.islice(port_pipe.batches(src, cfg), 6))
    tail = list(itertools.islice(port_pipe.batches(src, cfg, 3), 3))
    for a, b in zip(full[3:], tail, strict=True):
        _assert_batches_equal(b, a)
    ref = itertools.islice(ref_pipe.batches(ref_pipe.SyntheticSource(1000, seed=7),
                                            _cfg(ref_pipe, mrope=True)), 6)
    for a, b in zip(full, ref, strict=True):
        _assert_batches_equal(a, b)


def test_memmap_source_equals_the_references(tmp_path):
    path = tmp_path / "toks.bin"
    (np.arange(10_000) % 251).astype(np.uint16).tofile(path)
    port = port_pipe.MemmapSource(str(path), vocab_size=251)
    ref = ref_pipe.MemmapSource(str(path), vocab_size=251)
    for step, shard in itertools.product((0, 3, 40), (0, 1)):
        t = port.tokens(step, shard, 64)
        assert t.shape == (64,) and t.dtype == np.int32 and t.max() < 251
        np.testing.assert_array_equal(t, ref.tokens(step, shard, 64))
    cfg = _cfg(port_pipe, batch_size=2, seq_len=8)
    _assert_batches_equal(port_pipe.make_batch(port, cfg, 2),
                          ref_pipe.make_batch(ref, _cfg(ref_pipe, batch_size=2, seq_len=8), 2))


def test_prefetcher_yields_in_order_and_stops():
    src = port_pipe.SyntheticSource(1000, seed=7)
    pre = port_pipe.Prefetcher(port_pipe.batches(src, _cfg(port_pipe)), depth=2)
    direct = port_pipe.batches(src, _cfg(port_pipe))
    for _ in range(4):
        np.testing.assert_array_equal(next(pre)["targets"], next(direct)["targets"])
    pre.close()
    assert not pre.t.is_alive()


# =============================================================================
# int8 compression with error feedback
# =============================================================================

SHAPES = {"attn.wq": (33, 17), "embed": (64, 8), "norm": (17,)}


def _grads(rng, scale: float = 1.0) -> dict[str, np.ndarray]:
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in sorted(SHAPES.items())}


def test_quantize_int8_equals_the_references():
    rng = np.random.default_rng(0)
    for scale in (1e-6, 1.0, 3e4):
        for k, x in _grads(rng, scale).items():
            q, s = port_comp.quantize_int8(torch.from_numpy(x))
            qr, sr = ref_comp.quantize_int8(jnp.asarray(x))
            assert q.dtype == torch.int8 and s.dtype == torch.float32
            np.testing.assert_array_equal(to_np(q), np.asarray(qr))
            assert to_np(s).view(np.int32) == np.asarray(sr).view(np.int32), k
            np.testing.assert_array_equal(
                to_np(port_comp.dequantize_int8(q, s)).view(np.int32),
                np.asarray(ref_comp.dequantize_int8(qr, sr)).view(np.int32))
    zero = port_comp.quantize_int8(torch.zeros(5))
    assert not zero[0].any() and float(zero[1]) > 0


def test_quantize_int8_rounds_half_to_even():
    """x / scale = k + 0.5 exactly: even k up, odd k down, on both sides."""
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 3.5], dtype=np.float32)
    q, _ = port_comp.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(to_np(q), [127, 0, 2, 2, 0, -2, 4])
    np.testing.assert_array_equal(to_np(q), np.asarray(ref_comp.quantize_int8(jnp.asarray(x))[0]))


def _ef_steps(ref_transform):
    """Three steps of ``make_ef_int8_transform`` in both packages, the
    error carried; yields (grads, port's (grads', ef'), reference's)."""
    rng = np.random.default_rng(1)
    port_t = port_comp.make_ef_int8_transform()
    ef = port_comp.init_error_feedback({k: torch.zeros(s) for k, s in SHAPES.items()})
    ef_r = ref_comp.init_error_feedback({k: jnp.zeros(s) for k, s in SHAPES.items()})
    assert all(e.dtype == torch.float32 and not e.any() for e in ef.values())
    for _ in range(3):
        g = _grads(rng)
        gq, ef = port_t({k: torch.from_numpy(v) for k, v in g.items()}, ef)
        gq_r, ef_r = ref_transform({k: jnp.asarray(v) for k, v in g.items()}, ef_r)
        yield g, (gq, ef), (gq_r, ef_r)


def test_error_feedback_equals_the_references():
    """Against the reference's transform run op by op: the transformed
    grads and the carried error bitwise; the error feedback makes the
    applied sum track the true sum (the reference's first-order claim)
    within one quantum of the last step."""
    true_sum = {k: np.zeros(s, np.float64) for k, s in SHAPES.items()}
    applied = {k: np.zeros(s, np.float64) for k, s in SHAPES.items()}
    for g, (gq, ef), (gq_r, ef_r) in _ef_steps(ref_comp.make_ef_int8_transform()):
        for k in SHAPES:
            np.testing.assert_array_equal(to_np(gq[k]).view(np.int32),
                                          np.asarray(gq_r[k]).view(np.int32))
            np.testing.assert_array_equal(to_np(ef[k]).view(np.int32),
                                          np.asarray(ef_r[k]).view(np.int32))
            true_sum[k] += g[k]
            applied[k] += to_np(gq[k])
    for k in SHAPES:
        quantum = np.abs(g[k] + to_np(ef[k])).max() / 127.0 + 1e-6
        assert np.abs(true_sum[k] - applied[k]).max() <= quantum


def test_error_feedback_near_the_jitted_references():
    """Against the reference's transform under ``jax.jit``, as its trainer
    runs it: XLA's fusion turns the divide by 127 into a multiply by its
    reciprocal and contracts ``g32 - q·s`` into an FMA, so the scale and the
    error move in the last bit.  The grads within 2⁻²² of their largest
    magnitude (no code moved: measured 0.65 ulp), the error within 2⁻²¹ of
    the largest gradient (measured 1.5 ulps)."""
    for g, (gq, ef), (gq_r, ef_r) in _ef_steps(jax.jit(ref_comp.make_ef_int8_transform())):
        for k in SHAPES:
            want = np.asarray(gq_r[k])
            assert np.abs(to_np(gq[k]) - want).max() <= 2.0 ** -22 * np.abs(want).max()
            assert np.abs(to_np(ef[k]) - np.asarray(ef_r[k])).max() <= (
                2.0 ** -21 * np.abs(g[k]).max())


def test_grouped_scale_is_one_array_of_the_group():
    """With ``groups``, the tensors of a group share one scale: each one's
    result is that of the concatenated array (the reference's stacked
    leaf), bitwise; an ungrouped tensor keeps its own."""
    rng = np.random.default_rng(2)
    g = {"layers.0.w": rng.standard_normal((5, 3)).astype(np.float32),
         "layers.1.w": 4 * rng.standard_normal((5, 3)).astype(np.float32),
         "embed": rng.standard_normal((7,)).astype(np.float32)}
    groups = {"layers.0.w": "layers.w", "layers.1.w": "layers.w", "embed": "embed"}
    zeros = {k: torch.zeros(v.shape) for k, v in g.items()}
    gq, ef = port_comp.make_ef_int8_transform(groups)(
        {k: torch.from_numpy(v) for k, v in g.items()}, zeros)
    stacked = np.stack([g["layers.0.w"], g["layers.1.w"]])
    gq_r, ef_r = ref_comp.make_ef_int8_transform()(
        {"w": jnp.asarray(stacked), "embed": jnp.asarray(g["embed"])},
        {"w": jnp.zeros(stacked.shape), "embed": jnp.zeros((7,))})
    for i in (0, 1):
        np.testing.assert_array_equal(to_np(gq[f"layers.{i}.w"]), np.asarray(gq_r["w"][i]))
        np.testing.assert_array_equal(to_np(ef[f"layers.{i}.w"]), np.asarray(ef_r["w"][i]))
    np.testing.assert_array_equal(to_np(gq["embed"]), np.asarray(gq_r["embed"]))
