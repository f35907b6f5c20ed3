"""CUDA kernel: causal flash attention (online softmax, optional window).

Counterpart of ``repro/kernels/flash_attention.py::flash_attention`` (source:
``csrc/flash_attention.cu``):

    o[b, i, h] = Σ_j softmax_j(q[b, i, h]·k[b, j, h] · hd^-½) · v[b, j, h]

over the keys ``j <= i`` (and ``j > i - window`` when ``window > 0``), with
q, k, v and the output in the reference's (B, S, H, hd) layout, KV already
repeated to H.  At head widths :data:`WGMMA_HEAD_DIMS` both dtypes run on
Hopper's tensor cores through ``wgmma``: float32 as 3xTF32 (each operand
split into two TF32 parts, three products into one f32 accumulator),
bfloat16 fed by TMA (bf16 in, f32 accumulate).  At the other widths of
:data:`HEAD_DIMS` float32 runs in full-precision FFMA and bfloat16 through
``mma.sync`` (:func:`route`).  Any S >= 1.  The tiles are the kernel's own.
The output is a fresh tensor.

Call it through ``kernels.ops.flash_attention``, which checks the inputs and
takes the plain version (``kernels.ref``) for CPU tensors.
:func:`flash_attention_bf16_mma` launches the ``mma.sync`` body at any width,
as the yardstick of the ``wgmma`` body, and :func:`flash_attention_f32_ffma`
the FFMA body, as the yardstick of the 3xTF32 body; no solver and no ``ops``
path calls them.  :data:`BODY_LAUNCHES` counts the launches of each body.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: the head widths the kernel is instantiated for (the C entry points'
#: switches, and flash_attention_body's, list the same widths)
HEAD_DIMS = (8, 16, 32, 64, 128, 256)
#: the widths the wgmma bodies serve: bf16 (flash_attention_body's answer
#: 1) and f32 in 3xTF32 (its answer 3)
WGMMA_HEAD_DIMS = (64, 128)
#: B·H is the launch grid's y extent (the source's kMaxGridY)
MAX_BATCH_HEADS = 65535
#: the source's bodies, in the order of flash_attention_body's answers
BODIES = ("ffma", "wgmma", "mma", "tf32x3")
#: body -> launches since the last :func:`reset_body_launches` (not a key of
#: ``ops.LAUNCHES``: the four bodies are one kernel row)
BODY_LAUNCHES: dict[str, int] = dict.fromkeys(BODIES, 0)
#: an entry point's return at or above this is the source's kTensorMapError
#: plus the CUresult of cuTensorMapEncodeTiled
TENSOR_MAP_ERROR = 1048576

_P, _I = ctypes.c_void_p, ctypes.c_int
_ATTN = ([_P] * 4 + [_I] * 5 + [ctypes.c_float, _P], ctypes.c_int)
SIGNATURES = {"flash_attention_f32": _ATTN, "flash_attention_bf16": _ATTN,
              "flash_attention_bf16_mma": _ATTN, "flash_attention_f32_ffma": _ATTN,
              "flash_attention_body": ([_I, _I], ctypes.c_int)}


def route(dtype: torch.dtype, hd: int) -> str:
    """The body ``ops.flash_attention`` takes on the card for ``dtype`` and
    head width ``hd``: at :data:`WGMMA_HEAD_DIMS` "tf32x3" (float32) or
    "wgmma" (bfloat16), at the other widths "ffma" (float32) or "mma"
    (bfloat16).  The source's ``flash_attention_body`` gives the same
    answers."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head width {hd} has no kernel "
                         f"(instantiated for {HEAD_DIMS})")
    if dtype == torch.float32:
        return "tf32x3" if hd in WGMMA_HEAD_DIMS else "ffma"
    if dtype == torch.bfloat16:
        return "wgmma" if hd in WGMMA_HEAD_DIMS else "mma"
    raise TypeError(f"flash_attention: dtype {dtype} has no kernel")


def reset_body_launches() -> None:
    for k in BODY_LAUNCHES:
        BODY_LAUNCHES[k] = 0


def source_body(dtype: torch.dtype, hd: int) -> str:
    """The source's own answer to :func:`route` (builds and loads the
    library)."""
    lib = _build.load("flash_attention", SIGNATURES)
    code = lib.flash_attention_body(int(dtype == torch.bfloat16), hd)
    if code < 0:
        raise ValueError(f"flash_attention: head width {hd} has no kernel")
    return BODIES[code]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    B, S, H, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head width {hd} has no kernel "
                         f"(instantiated for {HEAD_DIMS})")
    if B * H > MAX_BATCH_HEADS:
        raise ValueError(f"flash_attention: B·H = {B * H} above {MAX_BATCH_HEADS}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be 16-byte aligned")


def _launch(fn, q, k, v, window: int, body: str) -> torch.Tensor:
    B, S, H, hd = q.shape
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H, hd,
             min(window, S), hd ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if err >= TENSOR_MAP_ERROR:
        raise RuntimeError(f"flash_attention: cuTensorMapEncodeTiled failed "
                           f"(CUresult {err - TENSOR_MAP_ERROR})")
    _build.check(err, "flash_attention")
    BODY_LAUNCHES[body] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0) -> torch.Tensor:
    """The (B, S, H, hd) attention output for contiguous CUDA tensors of one
    dtype (float32 or bfloat16) and shape, on the body :func:`route` names."""
    _check(q, k, v)
    lib = _build.load("flash_attention", SIGNATURES)
    fn = lib.flash_attention_bf16 if q.dtype == torch.bfloat16 else lib.flash_attention_f32
    return _launch(fn, q, k, v, window, route(q.dtype, q.shape[3]))


def _yardstick(q, k, v, window: int, dtype: torch.dtype, body: str) -> torch.Tensor:
    """``body`` at any width of :data:`HEAD_DIMS`, for contiguous CUDA
    tensors of ``dtype`` and one (B, S, H, hd) shape."""
    from repro_torch.kernels import ops
    if q.dim() != 4 or window < 0:
        raise ValueError("flash_attention: need (B, S, H, hd) operands and window >= 0")
    ops._check_same_shape("flash_attention", "q, k, v", q, k, v)
    if not ops._on_card("flash_attention", q, k, v, dtypes=(dtype,)):
        raise ValueError(f"flash_attention: the {body} body takes CUDA tensors only")
    _check(q, k, v)
    lib = _build.load("flash_attention", SIGNATURES)
    fn = lib.flash_attention_bf16_mma if body == "mma" else lib.flash_attention_f32_ffma
    return _launch(fn, q, k, v, window, body)


def flash_attention_bf16_mma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             window: int = 0) -> torch.Tensor:
    """The ``mma.sync`` body at any width of :data:`HEAD_DIMS`, for
    contiguous bfloat16 CUDA tensors of one (B, S, H, hd) shape: the same
    function as :func:`flash_attention`.  It has no plain version, so a CPU
    tensor raises."""
    return _yardstick(q, k, v, window, torch.bfloat16, "mma")


def flash_attention_f32_ffma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             window: int = 0) -> torch.Tensor:
    """The FFMA body at any width of :data:`HEAD_DIMS`, for contiguous
    float32 CUDA tensors of one (B, S, H, hd) shape: the same function as
    :func:`flash_attention`.  It has no plain version, so a CPU tensor
    raises."""
    return _yardstick(q, k, v, window, torch.float32, "ffma")
