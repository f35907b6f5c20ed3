"""CUDA kernel: causal flash attention (online softmax, optional window).

Counterpart of ``repro/kernels/flash_attention.py::flash_attention`` (source:
``csrc/flash_attention.cu``):

    o[b, i, h] = Σ_j softmax_j(q[b, i, h]·k[b, j, h] · hd^-½) · v[b, j, h]

over the keys ``j <= i`` (and ``j > i - window`` when ``window > 0``), with
q, k, v and the output in the reference's (B, S, H, hd) layout, KV already
repeated to H.  float32 runs in full-precision FFMA, bfloat16 on the tensor
cores (bf16 in, f32 accumulate); any S >= 1, head widths :data:`HEAD_DIMS`.
The tiles are the kernel's own.  The output is a fresh tensor.

Call it through ``kernels.ops.flash_attention``, which checks the inputs and
takes the plain version (``kernels.ref``) for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: the head widths the kernel is instantiated for (the C entry points'
#: switches list the same widths)
HEAD_DIMS = (8, 16, 32, 64, 128, 256)
#: B·H is the launch grid's y extent (the source's kMaxGridY)
MAX_BATCH_HEADS = 65535

_P, _I = ctypes.c_void_p, ctypes.c_int
_ATTN = ([_P] * 4 + [_I] * 5 + [ctypes.c_float, _P], ctypes.c_int)
SIGNATURES = {"flash_attention_f32": _ATTN, "flash_attention_bf16": _ATTN}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0) -> torch.Tensor:
    """The (B, S, H, hd) attention output for contiguous CUDA tensors of one
    dtype (float32 or bfloat16) and shape."""
    B, S, H, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head width {hd} has no kernel "
                         f"(instantiated for {HEAD_DIMS})")
    if B * H > MAX_BATCH_HEADS:
        raise ValueError(f"flash_attention: B·H = {B * H} above {MAX_BATCH_HEADS}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be 16-byte aligned")
    lib = _build.load("flash_attention", SIGNATURES)
    out = torch.empty_like(q)
    fn = lib.flash_attention_bf16 if q.dtype == torch.bfloat16 else lib.flash_attention_f32
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H, hd,
             min(window, S), hd ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    return out
