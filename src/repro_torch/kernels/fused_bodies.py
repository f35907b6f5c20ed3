"""CUDA kernels: the fused vector passes of merged PCG, the pipelined CGs and
single-reduction BiCGStab.

Counterpart of ``repro/kernels/fused_bodies.py``'s ``fused_pcg_body``,
``fused_pipe_body``, ``fused_ppipe_body``, ``fused_dots`` and
``bicgstab_fused_update1`` (source: ``csrc/fused_bodies.cu``):

    fused_pcg_body    p' = u + β·p,  s' = w + β·s,  x' = x + α·p',  r' = r − α·s'
    fused_pipe_body   z' = n + β·z,  s' = w + β·s,  p' = r + β·p,
                      x' = x + α·p', r' = r − α·s', w' = w − α·z'
    fused_ppipe_body  z' = n + β·z,  q' = m + β·q,  s' = w + β·s,  p' = u + β·p,
                      x' = x + α·p', r' = r − α·s', u' = u − α·q', w' = w − α·z'
    fused_dots        (a·b, c·b, a·a)   (pipelined PCG's (r·u, w·u, r·r))
    bicgstab_fused_update1
                      y' = y + α·p + ω·q,  r' = q − ω·yv,  w' = yv − ω·(t − α·v)

The Pallas kernels reshape the vectors to (rows, 1024) row tiles; the CUDA
kernels run a flat grid-stride loop over the contiguous (nx, ny, nz) arrays.
α, β and ω are device scalars read by the kernel.  ``fused_dots`` writes one
partial slot per block and sums the slots in a fixed order, so its scalars
are bitwise reproducible.  The vectors and scalars are float64, float32 or
bfloat16; bfloat16 partials are float32.

Call them through ``kernels.ops.pcg_body``/``pipe_body``/``ppipe_body``/
``fused_dots``/``bicgstab_update1``, which check the inputs and take the
plain versions (``kernels.ref``) for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _N = ctypes.c_void_p, ctypes.c_longlong
_PCG = ([_P] * 12 + [_N, _P], ctypes.c_int)
_PIPE = ([_P] * 15 + [_N, _P], ctypes.c_int)
_PPIPE = ([_P] * 20 + [_N, _P], ctypes.c_int)
_DOTS = ([_P] * 5 + [_N, _P], ctypes.c_int)
_BICG_U1 = ([_P] * 11 + [_N, _P], ctypes.c_int)
SIGNATURES = {
    **{f"fused_pcg_body_{sfx}": _PCG for sfx in _build.SUFFIXES},
    **{f"fused_pipe_body_{sfx}": _PIPE for sfx in _build.SUFFIXES},
    **{f"fused_ppipe_body_{sfx}": _PPIPE for sfx in _build.SUFFIXES},
    "fused_dots_partials": ([_N], _N),
    **{f"fused_dots_{sfx}": _DOTS for sfx in _build.SUFFIXES},
    **{f"bicgstab_fused_update1_{sfx}": _BICG_U1 for sfx in _build.SUFFIXES},
}


def _body(kernel: str, alpha, beta, ins, n_out: int) -> tuple:
    """Launch ``kernel`` with its two device scalars on the vectors ``ins``
    -> ``n_out`` fresh outputs."""
    lib = _build.load("fused_bodies", SIGNATURES)
    x = ins[0]
    outs = tuple(torch.empty_like(x) for _ in range(n_out))
    fn = getattr(lib, f"{kernel}_{_build.suffix(x.dtype)}")
    err = fn(alpha.data_ptr(), beta.data_ptr(), *(v.data_ptr() for v in ins),
             *(o.data_ptr() for o in outs), x.numel(),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, kernel)
    return outs


def fused_pcg_body(alpha: torch.Tensor, beta: torch.Tensor, x, r, u, p, s, w):
    """``(x', r', p', s')`` for CUDA tensors; ``alpha``/``beta`` are 0-d
    tensors of the vectors' dtype on the same device."""
    return _body("fused_pcg_body", alpha, beta, (x, r, u, p, s, w), 4)


def fused_pipe_body(alpha: torch.Tensor, beta: torch.Tensor, x, r, w, p, s, z, n):
    """``(x', r', w', p', s', z')`` for CUDA tensors (as ``fused_pcg_body``)."""
    return _body("fused_pipe_body", alpha, beta, (x, r, w, p, s, z, n), 6)


def fused_ppipe_body(alpha: torch.Tensor, beta: torch.Tensor, x, r, u, w, p, s,
                     q, z, m, n):
    """``(x', r', u', w', p', s', q', z')`` for CUDA tensors (as
    ``fused_pcg_body``)."""
    return _body("fused_ppipe_body", alpha, beta,
                 (x, r, u, w, p, s, q, z, m, n), 8)


def bicgstab_fused_update1(alpha: torch.Tensor, omega: torch.Tensor, y, p, q, yv,
                           t, v):
    """``(y', r', w')`` for CUDA tensors; ``alpha``/``omega`` are 0-d tensors
    of the vectors' dtype on the same device."""
    return _body("bicgstab_fused_update1", alpha, omega, (y, p, q, yv, t, v), 3)


def fused_dots(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """``(a·b, c·b, a·a)`` for CUDA tensors, as 0-d tensors on the device
    (float32 for bfloat16 operands)."""
    lib = _build.load("fused_bodies", SIGNATURES)
    acc = _build.acc_dtype(a.dtype)
    partials = torch.empty(3 * lib.fused_dots_partials(a.numel()), dtype=acc,
                           device=a.device)
    dots = torch.empty(3, dtype=acc, device=a.device)
    fn = getattr(lib, f"fused_dots_{_build.suffix(a.dtype)}")
    err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), partials.data_ptr(),
             dots.data_ptr(), a.numel(),
             torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "fused_dots")
    return dots[0], dots[1], dots[2]
