"""CUDA kernel: stencil SpMV + BOTH merged-CG dot partials, one pass.

Counterpart of ``repro/kernels/spmv_dot.py::stencil_spmv_dots`` (source:
``csrc/spmv_dot.cu``).  Merged CG needs ``w = A r``, ``δ = w·r`` and
``γ = r·r`` per iteration; one pass over the padded ``r`` gives all three.
The Pallas kernel adds both partials into one revisited block, sound only
because TPU grid steps run in order; here each block writes its own partial
slots and a second small kernel sums them in a fixed order, so the scalars are
bitwise reproducible.  (``stencil_spmv_dots3`` is not ported yet.)

Call it through ``kernels.ops.spmv_dots``, which checks the inputs and takes
the plain version (``kernels.ref``) for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.operators import Stencil
from repro_torch.kernels import _build

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_LAUNCH = ([_P, _P, _P, _P, _I, _I, _I, _I, _D, _D, _P], ctypes.c_int)
SIGNATURES = {
    "spmv_dots_partials": ([_I, _I, _I], ctypes.c_longlong),
    "spmv_dots_f64": _LAUNCH,
    "spmv_dots_f32": _LAUNCH,
}


def stencil_spmv_dots(xp: torch.Tensor, *, stencil: Stencil):
    """``y = A·x``, ``y·x`` and ``x·x`` from the padded CUDA ``xp``; the two
    scalars are 0-d tensors on the device."""
    lib = _build.load("spmv_dot", SIGNATURES)
    nx, ny, nz = (int(n) - 2 for n in xp.shape)
    y = torch.empty((nx, ny, nz), dtype=xp.dtype, device=xp.device)
    partials = torch.empty(2 * lib.spmv_dots_partials(nx, ny, nz),
                           dtype=xp.dtype, device=xp.device)
    dots = torch.empty(2, dtype=xp.dtype, device=xp.device)
    fn = lib.spmv_dots_f64 if xp.dtype == torch.float64 else lib.spmv_dots_f32
    err = fn(xp.data_ptr(), y.data_ptr(), partials.data_ptr(), dots.data_ptr(),
             nx, ny, nz, stencil.npoint, float(stencil.diag),
             float(stencil.off_coeff),
             torch.cuda.current_stream(xp.device).cuda_stream)
    _build.check(err, "stencil_spmv_dots")
    return y, dots[0], dots[1]
