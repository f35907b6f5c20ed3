"""The port's flash attention on the CPU against the JAX package's.

On CPU tensors ``repro_torch.kernels.ops.flash_attention`` runs its plain
PyTorch version (``kernels.ref.flash_attention_ref``); the reference runs its
Pallas kernel in interpret mode (as ``tests/test_kernels.py`` does) and its
own ``flash_attention_ref``.  Both packages get the same seeded numpy inputs.
Tolerances: float32 rtol 1e-4, atol 1e-5 (the reference tests'); bfloat16
rtol = atol = 2⁻⁷, one bf16 ulp, since the two routes round the logits and
the weights at different places.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import ref_module, seeded

from repro_torch.kernels import ops, ref

F32_TOLS = dict(rtol=1e-4, atol=1e-5)
BF16_TOLS = dict(rtol=2.0 ** -7, atol=2.0 ** -7)

#: (B, S, H, hd, bq, bkv, window): the reference tests' cases
#: (tests/test_kernels.py), a ragged S = 100 with windows 1, 7 and S + 5
#: (tiles larger than the window), and a ragged S with tiles that do not
#: divide it
CASES = {
    "ref_causal": (2, 128, 4, 16, 32, 32, 0),
    "ref_window32": (2, 128, 4, 16, 32, 32, 32),
    "sweep_hd8": (1, 64, 2, 8, 16, 32, 0),
    "sweep_hd16": (2, 96, 1, 16, 32, 16, 0),
    "sweep_hd32": (1, 256, 2, 32, 64, 64, 0),
    "ragged": (1, 100, 2, 16, 256, 256, 0),
    "ragged_window1": (1, 100, 2, 16, 256, 256, 1),
    "ragged_window7": (1, 100, 2, 16, 256, 256, 7),
    "ragged_window_past_s": (1, 100, 2, 16, 256, 256, 105),
    "ragged_tiles_window7": (2, 100, 3, 8, 32, 32, 7),
}
#: the cases run again in bfloat16
BF16_CASES = ("ref_causal", "ref_window32", "sweep_hd32", "ragged_window7",
              "ragged_tiles_window7")


@pytest.fixture(scope="module")
def jax_attention():
    return {"pallas": ref_module("kernels.ops").flash_attention,
            "ref": ref_module("kernels.ref").flash_attention_ref}


def _inputs(case, seed=7):
    B, S, H, hd = CASES[case][:4]
    return [seeded((B, S, H, hd), seed + i, np.float32) for i in range(3)]


def _jax(jax_attention, route, arrays, case, dtype):
    bq, bkv, window = CASES[case][4:]
    q, k, v = (jnp.asarray(a).astype(dtype) for a in arrays)
    if route == "pallas":
        out = jax_attention["pallas"](q, k, v, bq=bq, bkv=bkv, window=window)
    else:
        out = jax_attention["ref"](q, k, v, window=window)
    return np.asarray(out.astype(jnp.float32))


def _port(arrays, case, dtype):
    bq, bkv, window = CASES[case][4:]
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
    out = ops.flash_attention(q, k, v, bq=bq, bkv=bkv, window=window)
    assert out.dtype == dtype and out.shape == q.shape
    return out.float().numpy()


@pytest.mark.parametrize("route", ["pallas", "ref"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_f32_matches_reference(jax_attention, case, route):
    arrays = _inputs(case)
    want = _jax(jax_attention, route, arrays, case, jnp.float32)
    got = _port(arrays, case, torch.float32)
    np.testing.assert_allclose(got, want, **F32_TOLS)


@pytest.mark.parametrize("route", ["pallas", "ref"])
@pytest.mark.parametrize("case", BF16_CASES)
def test_flash_attention_bf16_matches_reference(jax_attention, case, route):
    arrays = _inputs(case)
    want = _jax(jax_attention, route, arrays, case, jnp.bfloat16)
    got = _port(arrays, case, torch.bfloat16)
    np.testing.assert_allclose(got, want, **BF16_TOLS)


def test_flash_attention_rows_see_only_their_window():
    """A key outside every row's window changes no output; one inside row
    i's window changes row i."""
    q, k, v = (torch.from_numpy(a) for a in _inputs("ragged_window7"))
    base = ops.flash_attention(q, k, v, window=7)
    v2 = v.clone()
    v2[:, 50] += 10.0                  # key 50: seen by rows 50..56 only
    out = ops.flash_attention(q, k, v2, window=7)
    changed = (out != base).any(dim=(0, 2, 3))
    assert changed.nonzero().flatten().tolist() == list(range(50, 57))


@pytest.mark.parametrize("bq, bkv", [(1, 1), (7, 13), (32, 32), (100, 256), (512, 3)])
def test_flash_attention_tiles_change_no_cpu_result(bq, bkv):
    q, k, v = (torch.from_numpy(a) for a in _inputs("ragged_window7"))
    want = ops.flash_attention(q, k, v, window=7)
    assert torch.equal(ops.flash_attention(q, k, v, bq=bq, bkv=bkv, window=7), want)


def test_flash_attention_counts_no_launches_on_cpu():
    ops.reset_launches()
    q, k, v = (torch.from_numpy(a) for a in _inputs("sweep_hd8"))
    ops.flash_attention(q, k, v)
    assert ops.LAUNCHES["flash_attention"] == 0


def _bad_call(bad):
    q = torch.ones((1, 8, 2, 16))
    args, kw = [q, q.clone(), q.clone()], {}
    exc = ValueError
    if bad == "float64":
        args, exc = [a.double() for a in args], TypeError
    elif bad == "int":
        args, exc = [a.long() for a in args], TypeError
    elif bad == "mixed_dtype":
        args[1] = args[1].to(torch.bfloat16)
    elif bad == "rank":
        args = [a[0] for a in args]
    elif bad == "shape":
        args[2] = torch.ones((1, 8, 2, 8))
    elif bad == "empty":
        args = [torch.ones((1, 0, 2, 16))] * 3
    elif bad == "non_contiguous":
        args[0] = torch.ones((1, 2, 8, 16)).transpose(1, 2)
    elif bad == "device":
        args = [a.to("meta") for a in args]
    else:
        kw = {"bq_zero": dict(bq=0), "bkv_zero": dict(bkv=0),
              "negative_window": dict(window=-1), "float_window": dict(window=2.0),
              }[bad]
    return exc, lambda: ops.flash_attention(*args, **kw)


@pytest.mark.parametrize("bad", ["float64", "int", "mixed_dtype", "rank", "shape", "empty",
                                 "non_contiguous", "device", "bq_zero", "bkv_zero",
                                 "negative_window", "float_window"])
def test_flash_attention_rejects_bad_inputs(bad):
    exc, call = _bad_call(bad)
    with pytest.raises(exc, match="flash_attention"):
        call()


def _bf16_error(out, arrays, window):
    """``ref.attention_bf16_error`` of a bf16 output against the port's plain
    version, in f32 and in bf16, on the bf16-rounded inputs."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    o32 = ref.flash_attention_ref(q.float(), k.float(), v.float(), window=window)
    return ref.attention_bf16_error(out, o32, ref.flash_attention_ref(q, k, v, window=window))


@pytest.mark.parametrize("case", BF16_CASES)
def test_bf16_rule_accepts_the_pallas_kernel(jax_attention, case):
    """The Pallas body rounds p to bf16 before the PV product, as the CUDA
    kernel does; the element-wise rule the card holds that kernel to accepts
    it."""
    arrays = _inputs(case)
    out = torch.tensor(_jax(jax_attention, "pallas", arrays, case, jnp.bfloat16))
    e = _bf16_error(out, arrays, CASES[case][6])
    assert e["ratio"] <= 1 and e["frob"] <= 2 * e["plain_frob"], e


@pytest.mark.parametrize("case", ["ref_window32", "ragged_window7", "ragged_tiles_window7"])
def test_bf16_rule_rejects_a_window_off_by_one(case):
    """An output that also keeps key i − window (the window's lower edge one
    key too far) fails the rule."""
    arrays = _inputs(case)
    window = CASES[case][6]
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    out = ref.flash_attention_ref(q.float(), k.float(), v.float(), window=window + 1)
    e = _bf16_error(out.to(torch.bfloat16), arrays, window)
    assert e["ratio"] > 1 and e["frob"] > 2 * e["plain_frob"], e
