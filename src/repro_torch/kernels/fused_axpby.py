"""CUDA kernels: the paper's ad hoc vector update ``a·x + b·y + c·z``, alone
and with the fused partial ``Σ out·w``.

Counterpart of ``repro/kernels/fused_axpby.py``'s ``fused_axpby`` and
``fused_axpby_dot`` (source: ``csrc/fused_axpby.cu``).  The Pallas kernels
flatten the operands to (rows, 1024) tiles, zero-padded to a multiple of
1024; the CUDA kernel runs one flat grid-stride loop over the contiguous
operands of any shape (no padding, no reshape), the dot form chosen at
compile time.  a, b and c are device scalars of the vectors' dtype read by
the kernel.  The partial goes to per-block slots summed in a fixed order, so
it is bitwise reproducible.  The vectors and scalars are float64, float32 or
bfloat16; a bfloat16 partial is float32.

Call them through ``kernels.ops.axpbypcz``/``axpbypcz_dot``, which check the
inputs and take the plain versions (``kernels.ref``) for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _N = ctypes.c_void_p, ctypes.c_longlong
_AXPBY = ([_P] * 7 + [_N, _P], ctypes.c_int)
_AXPBY_DOT = ([_P] * 10 + [_N, _P], ctypes.c_int)
SIGNATURES = {
    **{f"fused_axpby_{sfx}": _AXPBY for sfx in _build.SUFFIXES},
    "fused_axpby_dot_partials": ([_N], _N),
    **{f"fused_axpby_dot_{sfx}": _AXPBY_DOT for sfx in _build.SUFFIXES},
}


def fused_axpby(a: torch.Tensor, x, b: torch.Tensor, y, c: torch.Tensor, z) -> torch.Tensor:
    """``a·x + b·y + c·z`` for CUDA tensors; ``a``/``b``/``c`` are 0-d tensors
    of the vectors' dtype on the same device."""
    lib = _build.load("fused_axpby", SIGNATURES)
    out = torch.empty_like(x)
    err = getattr(lib, f"fused_axpby_{_build.suffix(x.dtype)}")(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), x.data_ptr(), y.data_ptr(),
        z.data_ptr(), out.data_ptr(), x.numel(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_axpby")
    return out


def fused_axpby_dot(a: torch.Tensor, x, b: torch.Tensor, y, c: torch.Tensor, z, w):
    """``(out, Σ out·w)`` with ``out = a·x + b·y + c·z`` for CUDA tensors; the
    partial is a 0-d tensor on the device (float32 for bfloat16 vectors)."""
    lib = _build.load("fused_axpby", SIGNATURES)
    out = torch.empty_like(x)
    acc = _build.acc_dtype(x.dtype)
    partials = torch.empty(lib.fused_axpby_dot_partials(x.numel()), dtype=acc,
                           device=x.device)
    dot = torch.empty((), dtype=acc, device=x.device)
    err = getattr(lib, f"fused_axpby_dot_{_build.suffix(x.dtype)}")(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), x.data_ptr(), y.data_ptr(),
        z.data_ptr(), w.data_ptr(), out.data_ptr(), partials.data_ptr(),
        dot.data_ptr(), x.numel(), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_axpby_dot")
    return out, dot
