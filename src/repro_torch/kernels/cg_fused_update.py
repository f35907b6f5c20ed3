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
SIGNATURES = {"fused_cg_body_f64": _LAUNCH, "fused_cg_body_f32": _LAUNCH,
              "cg_update_partials": ([_N], _N),
              "cg_update_f64": _UPDATE, "cg_update_f32": _UPDATE}


def fused_cg_body(alpha: torch.Tensor, beta: torch.Tensor, x, r, p, s, w):
    """``(x', r', p', s')`` for CUDA tensors; ``alpha``/``beta`` are 0-d
    tensors of the vectors' dtype on the same device."""
    lib = _build.load("cg_fused_update", SIGNATURES)
    xo, ro, po, so = (torch.empty_like(x) for _ in range(4))
    fn = lib.fused_cg_body_f64 if x.dtype == torch.float64 else lib.fused_cg_body_f32
    err = fn(alpha.data_ptr(), beta.data_ptr(), x.data_ptr(), r.data_ptr(),
             p.data_ptr(), s.data_ptr(), w.data_ptr(), xo.data_ptr(),
             ro.data_ptr(), po.data_ptr(), so.data_ptr(), x.numel(),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_cg_body")
    return xo, ro, po, so


def cg_fused_update(beta: torch.Tensor, r, ar, p, ap):
    """``(p', Ap', Σ Ap'·p')`` for CUDA tensors; ``beta`` is a 0-d tensor of
    the vectors' dtype on the same device, the partial a 0-d tensor there."""
    lib = _build.load("cg_fused_update", SIGNATURES)
    po, apo = torch.empty_like(r), torch.empty_like(r)
    partials = torch.empty(lib.cg_update_partials(r.numel()), dtype=r.dtype,
                           device=r.device)
    dot = torch.empty((), dtype=r.dtype, device=r.device)
    fn = lib.cg_update_f64 if r.dtype == torch.float64 else lib.cg_update_f32
    err = fn(beta.data_ptr(), r.data_ptr(), ar.data_ptr(), p.data_ptr(), ap.data_ptr(),
             po.data_ptr(), apo.data_ptr(), partials.data_ptr(), dot.data_ptr(),
             r.numel(), torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(err, "cg_fused_update")
    return po, apo, dot
