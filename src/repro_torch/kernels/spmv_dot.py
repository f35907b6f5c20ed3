"""CUDA kernels: stencil SpMV + the merged methods' dot partials, one pass.

Counterpart of ``repro/kernels/spmv_dot.py::stencil_spmv_dots`` and
``stencil_spmv_dots3`` (source: ``csrc/spmv_dot.cu``).  Merged CG needs
``w = A r``, ``δ = w·r`` and ``γ = r·r`` per iteration; one pass over ``r``
gives all three.  Merged PCG needs ``w = A u``, ``δ = w·u``, ``γ = r·u`` and
the true ``r·r``: one pass over ``u`` with the unpadded ``r`` streamed
beside it.  Both run the plane-ring pass of ``csrc/stencil.cuh`` on the
stencil operand padded, or with ``zero_halo`` unpadded, the kernel making
the zero halo itself, in runs of ``run`` x-planes a block
(``autotune.RUN_CANDIDATES``).  The Pallas kernels add the partials into
one revisited block, sound only because TPU grid steps run in order; here each
block writes its own partial slots and a second small kernel sums them in a
fixed order, so the scalars are bitwise reproducible under one run (the run
sets the block count, so two runs' scalars agree to rounding).  The operands
are float64, float32 or bfloat16; bfloat16 partials are float32.

Call them through ``kernels.ops.spmv_dots``/``spmv_dots3``, which check the
inputs and take the plain versions (``kernels.ref``) for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.operators import Stencil
from repro_torch.kernels import _build, autotune

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_LAUNCH = ([_P, _P, _P, _P, _I, _I, _I, _I, _D, _D, _I, _I, _P], ctypes.c_int)
_LAUNCH3 = ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _D, _D, _I, _I, _P], ctypes.c_int)
SIGNATURES = {
    "spmv_dots_partials": ([_I, _I, _I, _I], ctypes.c_longlong),
    "spmv_dots3_partials": ([_I, _I, _I, _I], ctypes.c_longlong),
    **{f"spmv_dots_{sfx}": _LAUNCH for sfx in _build.SUFFIXES},
    **{f"spmv_dots3_{sfx}": _LAUNCH3 for sfx in _build.SUFFIXES},
}


def stencil_spmv_dots(x: torch.Tensor, *, stencil: Stencil, zero_halo: bool = False,
                      run: int = autotune.DEFAULT_RUN):
    """``y = A·x``, ``y·x`` and ``x·x`` from the CUDA ``x`` (padded, or
    unpadded with ``zero_halo``) in runs of ``run`` x-planes; the two scalars
    are 0-d tensors on the device (float32 for a bfloat16 ``x``)."""
    lib = _build.load("spmv_dot", SIGNATURES)
    nx, ny, nz = (int(n) - (0 if zero_halo else 2) for n in x.shape)
    y = torch.empty((nx, ny, nz), dtype=x.dtype, device=x.device)
    acc = _build.acc_dtype(x.dtype)
    partials = torch.empty(2 * _build.slots(lib.spmv_dots_partials(nx, ny, nz, run),
                                            "stencil_spmv_dots", run),
                           dtype=acc, device=x.device)
    dots = torch.empty(2, dtype=acc, device=x.device)
    fn = getattr(lib, f"spmv_dots_{_build.suffix(x.dtype)}")
    err = fn(x.data_ptr(), y.data_ptr(), partials.data_ptr(), dots.data_ptr(),
             nx, ny, nz, stencil.npoint, float(stencil.diag),
             float(stencil.off_coeff), int(zero_halo), int(run),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "stencil_spmv_dots")
    return y, dots[0], dots[1]


def stencil_spmv_dots3(x: torch.Tensor, r: torch.Tensor, *, stencil: Stencil,
                       zero_halo: bool = False, run: int = autotune.DEFAULT_RUN):
    """``y = A·x``, ``y·x``, ``r·x`` and ``r·r`` from the CUDA ``x`` (padded, or
    unpadded with ``zero_halo``) and the unpadded ``r``, in runs of ``run``
    x-planes; the three scalars are 0-d tensors on the device (float32 for
    bfloat16 operands)."""
    lib = _build.load("spmv_dot", SIGNATURES)
    nx, ny, nz = r.shape
    y = torch.empty_like(r)
    acc = _build.acc_dtype(x.dtype)
    partials = torch.empty(3 * _build.slots(lib.spmv_dots3_partials(nx, ny, nz, run),
                                            "stencil_spmv_dots3", run),
                           dtype=acc, device=x.device)
    dots = torch.empty(3, dtype=acc, device=x.device)
    fn = getattr(lib, f"spmv_dots3_{_build.suffix(x.dtype)}")
    err = fn(x.data_ptr(), r.data_ptr(), y.data_ptr(), partials.data_ptr(),
             dots.data_ptr(), nx, ny, nz, stencil.npoint, float(stencil.diag),
             float(stencil.off_coeff), int(zero_halo), int(run),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "stencil_spmv_dots3")
    return y, dots[0], dots[1], dots[2]
