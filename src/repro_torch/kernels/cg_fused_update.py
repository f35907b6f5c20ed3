"""CUDA kernels: the CG vector updates of ``repro/kernels/cg_fused_update.py``.

Counterparts of ``fused_cg_body`` and ``cg_fused_update`` (source:
``csrc/cg_fused_update.cu``):

    fused_cg_body    p' = r + β·p,  s' = w + β·s,  x' = x + α·p',  r' = r − α·s'
                     (merged CG; 5 reads and 4 writes)
    cg_fused_update  p' = r + β·p,  Ap' = Ar + β·Ap  and  Σ Ap'·p'
                     (CG-NB's Alg. 1 lines 6–8; 4 reads and 2 writes)

The Pallas kernels reshape the vectors to (rows, 1024) row tiles; the CUDA
kernels run a flat grid-stride loop over the contiguous arrays of any shape
and need no reshape.  α and β are device scalars read by the kernels, so
computing them never waits on the host.  ``cg_fused_update``'s partial goes
to per-block slots summed in a fixed order, so it is bitwise reproducible.
The vectors and scalars are float64, float32 or bfloat16; a bfloat16
partial is float32.

Call them through ``kernels.ops.cg_body``/``cg_update``, which check the
inputs and take the plain versions (``kernels.ref``) for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_N = ctypes.c_longlong
_LAUNCH = ([_P] * 11 + [_N, _P], ctypes.c_int)
_UPDATE = ([_P] * 9 + [_N, _P], ctypes.c_int)
SIGNATURES = {**{f"fused_cg_body_{sfx}": _LAUNCH for sfx in _build.SUFFIXES},
              "cg_update_partials": ([_N], _N),
              **{f"cg_update_{sfx}": _UPDATE for sfx in _build.SUFFIXES}}


def fused_cg_body(alpha: torch.Tensor, beta: torch.Tensor, x, r, p, s, w):
    """``(x', r', p', s')`` for CUDA tensors; ``alpha``/``beta`` are 0-d
    tensors of the vectors' dtype on the same device."""
    lib = _build.load("cg_fused_update", SIGNATURES)
    xo, ro, po, so = (torch.empty_like(x) for _ in range(4))
    fn = getattr(lib, f"fused_cg_body_{_build.suffix(x.dtype)}")
    err = fn(alpha.data_ptr(), beta.data_ptr(), x.data_ptr(), r.data_ptr(),
             p.data_ptr(), s.data_ptr(), w.data_ptr(), xo.data_ptr(),
             ro.data_ptr(), po.data_ptr(), so.data_ptr(), x.numel(),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_cg_body")
    return xo, ro, po, so


def cg_fused_update(beta: torch.Tensor, r, ar, p, ap):
    """``(p', Ap', Σ Ap'·p')`` for CUDA tensors; ``beta`` is a 0-d tensor of
    the vectors' dtype on the same device, the partial a 0-d tensor there
    (float32 for bfloat16 vectors)."""
    lib = _build.load("cg_fused_update", SIGNATURES)
    po, apo = torch.empty_like(r), torch.empty_like(r)
    acc = _build.acc_dtype(r.dtype)
    partials = torch.empty(lib.cg_update_partials(r.numel()), dtype=acc, device=r.device)
    dot = torch.empty((), dtype=acc, device=r.device)
    fn = getattr(lib, f"cg_update_{_build.suffix(r.dtype)}")
    err = fn(beta.data_ptr(), r.data_ptr(), ar.data_ptr(), p.data_ptr(), ap.data_ptr(),
             po.data_ptr(), apo.data_ptr(), partials.data_ptr(), dot.data_ptr(),
             r.numel(), torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(err, "cg_fused_update")
    return po, apo, dot
