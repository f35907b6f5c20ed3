"""Which body of ``csrc/flash_attention.cu`` serves each (dtype, head width),
and that CPU tensors launch none of them.

``kernels.flash_attention.route`` is the pure mirror of the source's
``flash_attention_body`` (the ``gpu`` test
``test_flash_attention_route_is_the_sources`` holds the two together on the
card): at hd 64 and 128 float32 runs the 3xTF32 ``wgmma`` body and bfloat16
the TMA-fed ``wgmma`` body; at the other widths float32 runs the FFMA body
and bfloat16 the ``mma.sync`` body.  On CPU tensors
``ops.flash_attention`` takes its plain version and counts no launch, on
``ops.LAUNCHES`` or on any body.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

DTYPES = [torch.float32, torch.bfloat16]


def _want(dt, hd):
    if dt == torch.float32:
        return "tf32x3" if hd in (64, 128) else "ffma"
    return "wgmma" if hd in (64, 128) else "mma"


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_route_of_every_width(dt, hd):
    assert fa.route(dt, hd) == _want(dt, hd)
    assert fa.route(dt, hd) in fa.BODIES


@pytest.mark.parametrize("dt, hd, exc", [(torch.float32, 24, ValueError),
                                         (torch.bfloat16, 512, ValueError),
                                         (torch.float64, 64, TypeError),
                                         (torch.float16, 128, TypeError)],
                         ids=["f32_hd24", "bf16_hd512", "f64", "f16"])
def test_route_rejects_what_has_no_kernel(dt, hd, exc):
    with pytest.raises(exc, match="flash_attention"):
        fa.route(dt, hd)


def test_body_counters_are_no_kernel_rows():
    """The bodies are counted beside ``ops.LAUNCHES``, not in it: the four
    are one row of the kernel table."""
    assert set(fa.BODY_LAUNCHES) == set(fa.BODIES) == {"ffma", "wgmma", "mma", "tf32x3"}
    assert not set(fa.BODIES) & set(ops.LAUNCHES)
    assert set(fa.WGMMA_HEAD_DIMS) <= set(fa.HEAD_DIMS)


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("hd", [8, 64, 128, 256])
def test_cpu_tensors_take_the_plain_version_on_no_body(dt, hd):
    rng = np.random.default_rng(hd)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 37, 3, hd), dtype=np.float32)).to(dt)
               for _ in range(3))
    ops.reset_launches()
    fa.reset_body_launches()
    for window in (0, 5):
        out = ops.flash_attention(q, k, v, window=window)
        assert torch.equal(out, ref.flash_attention_ref(q, k, v, window=window))
    assert ops.LAUNCHES["flash_attention"] == 0
    assert fa.BODY_LAUNCHES == dict.fromkeys(fa.BODIES, 0)


def _yardstick_rejects(entry, dt, bad):
    """``entry`` on CPU tensors of ``dt`` raises ValueError; with ``bad``
    "shape", one operand of another shape (ValueError); with ``bad`` a dtype
    name, operands of that dtype (TypeError); no body counts a launch."""
    q = torch.zeros((1, 8, 2, 64), dtype=dt)
    args, exc = [q, q.clone(), q.clone()], ValueError
    if bad == "shape":
        args[2] = torch.zeros((1, 8, 2, 128), dtype=dt)
    elif bad != "cpu":
        args, exc = [a.to(getattr(torch, bad)) for a in args], TypeError
    fa.reset_body_launches()
    with pytest.raises(exc, match="flash_attention"):
        entry(*args)
    assert fa.BODY_LAUNCHES == dict.fromkeys(fa.BODIES, 0)


@pytest.mark.parametrize("bad", ["cpu", "float32", "shape"])
def test_mma_body_takes_only_bf16_cuda_tensors(bad):
    """The yardstick entry has no plain version: a CPU tensor raises."""
    _yardstick_rejects(fa.flash_attention_bf16_mma, torch.bfloat16, bad)


@pytest.mark.parametrize("bad", ["cpu", "bfloat16", "shape"])
def test_ffma_body_takes_only_f32_cuda_tensors(bad):
    """The FFMA body's yardstick entry has no plain version either: a CPU
    tensor, a bf16 one and mismatched shapes raise, and no body counts."""
    _yardstick_rejects(fa.flash_attention_f32_ffma, torch.float32, bad)
