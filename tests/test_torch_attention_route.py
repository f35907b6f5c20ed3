"""Which body of ``csrc/flash_attention.cu`` serves each (dtype, head width),
and that CPU tensors launch none of them.

``kernels.flash_attention.route`` is the pure mirror of the source's
``flash_attention_body`` (the ``gpu`` test
``test_flash_attention_route_is_the_sources`` holds the two together on the
card): float32 runs the FFMA body, bfloat16 the ``wgmma`` body at hd 64 and
128 and the ``mma.sync`` body at the other widths.  On CPU tensors
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
        return "ffma"
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
    """The bodies are counted beside ``ops.LAUNCHES``, not in it: the three
    are one row of the kernel table."""
    assert set(fa.BODY_LAUNCHES) == set(fa.BODIES) == {"ffma", "wgmma", "mma"}
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


@pytest.mark.parametrize("bad", ["cpu", "float32", "shape"])
def test_mma_body_takes_only_bf16_cuda_tensors(bad):
    """The yardstick entry has no plain version: a CPU tensor raises."""
    q = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    args, exc = [q, q.clone(), q.clone()], ValueError
    if bad == "float32":
        args, exc = [a.float() for a in args], TypeError
    elif bad == "shape":
        args[2] = torch.zeros((1, 8, 2, 128), dtype=torch.bfloat16)
    fa.reset_body_launches()
    with pytest.raises(exc, match="flash_attention"):
        fa.flash_attention_bf16_mma(*args)
    assert fa.BODY_LAUNCHES == dict.fromkeys(fa.BODIES, 0)
