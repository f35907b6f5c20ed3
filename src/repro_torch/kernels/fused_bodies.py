"""CUDA kernel: merged PCG's four vector updates in one pass.

Counterpart of ``repro/kernels/fused_bodies.py::fused_pcg_body`` (source:
``csrc/fused_bodies.cu``):

    p' = u + β·p,   s' = w + β·s,   x' = x + α·p',   r' = r − α·s'

6 reads and 4 writes, ``fused_cg_body``'s pattern with the preconditioned
residual ``u`` in place of ``r`` in the direction update.  The Pallas kernel
reshapes the vectors to (rows, 1024) row tiles; the CUDA kernel runs a flat
grid-stride loop over the contiguous (nx, ny, nz) arrays.  α and β are device
scalars read by the kernel.  (The module's other Pallas bodies, for the
pipelined and merged-BiCGStab methods, are not ported yet.)

Call it through ``kernels.ops.pcg_body``, which checks the inputs and takes
the plain version (``kernels.ref``) for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_LAUNCH = ([_P] * 12 + [ctypes.c_longlong, _P], ctypes.c_int)
SIGNATURES = {"fused_pcg_body_f64": _LAUNCH, "fused_pcg_body_f32": _LAUNCH}


def fused_pcg_body(alpha: torch.Tensor, beta: torch.Tensor, x, r, u, p, s, w):
    """``(x', r', p', s')`` for CUDA tensors; ``alpha``/``beta`` are 0-d
    tensors of the vectors' dtype on the same device."""
    lib = _build.load("fused_bodies", SIGNATURES)
    xo, ro, po, so = (torch.empty_like(x) for _ in range(4))
    fn = lib.fused_pcg_body_f64 if x.dtype == torch.float64 else lib.fused_pcg_body_f32
    err = fn(alpha.data_ptr(), beta.data_ptr(), x.data_ptr(), r.data_ptr(),
             u.data_ptr(), p.data_ptr(), s.data_ptr(), w.data_ptr(), xo.data_ptr(),
             ro.data_ptr(), po.data_ptr(), so.data_ptr(), x.numel(),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_pcg_body")
    return xo, ro, po, so
