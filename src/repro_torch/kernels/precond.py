"""CUDA kernels for the preconditioner sweeps: one stencil pass each.

Counterpart of ``repro/kernels/precond.py`` (source: ``csrc/precond.cu``):

  * ``cheb_fused_step``: one Chebyshev step, ``d' = a·d + c·(r − A z)`` and
    ``z' = z + d'``, from the halo-padded ``z``;
  * ``block_jacobi_sweep``: one damped local Jacobi sweep,
    ``z' = z + ω·(r − A z)/diag``, from the zero-padded ``z``.

Both are the stencil pass of ``csrc/stencil.cuh`` with an elementwise tail, so
``A z`` never reaches memory.  The Pallas kernels bake ``a, c`` and ``ω`` in
as compile-time constants; here they are launch arguments (one build serves
every schedule).  The outputs are fresh tensors: Chebyshev's first step passes
``d`` and ``z`` as one tensor.

Call them through ``kernels.ops.cheb_step``/``jacobi_sweep``, which check the
inputs and take the plain versions (``kernels.ref``) for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.operators import Stencil
from repro_torch.kernels import _build

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_CHEB = ([_P] * 5 + [_I] * 4 + [_D] * 4 + [_P], ctypes.c_int)
_JACOBI = ([_P] * 3 + [_I] * 4 + [_D] * 3 + [_P], ctypes.c_int)
SIGNATURES = {
    "cheb_step_f64": _CHEB, "cheb_step_f32": _CHEB,
    "jacobi_sweep_f64": _JACOBI, "jacobi_sweep_f32": _JACOBI,
}


def cheb_fused_step(zp: torch.Tensor, r: torch.Tensor, d: torch.Tensor, *,
                    stencil: Stencil, a: float, c: float):
    """``(z', d')`` for CUDA tensors: ``zp`` padded, ``r`` and ``d`` not."""
    lib = _build.load("precond", SIGNATURES)
    nx, ny, nz = r.shape
    z_new, d_new = torch.empty_like(r), torch.empty_like(r)
    fn = lib.cheb_step_f64 if r.dtype == torch.float64 else lib.cheb_step_f32
    err = fn(zp.data_ptr(), r.data_ptr(), d.data_ptr(), z_new.data_ptr(),
             d_new.data_ptr(), nx, ny, nz, stencil.npoint, float(stencil.diag),
             float(stencil.off_coeff), float(a), float(c),
             torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(err, "cheb_fused_step")
    return z_new, d_new


def block_jacobi_sweep(zp: torch.Tensor, r: torch.Tensor, *, stencil: Stencil,
                       omega: float = 1.0) -> torch.Tensor:
    """``z'`` for CUDA tensors: ``zp`` zero-padded, ``r`` not."""
    lib = _build.load("precond", SIGNATURES)
    nx, ny, nz = r.shape
    z_new = torch.empty_like(r)
    fn = lib.jacobi_sweep_f64 if r.dtype == torch.float64 else lib.jacobi_sweep_f32
    err = fn(zp.data_ptr(), r.data_ptr(), z_new.data_ptr(), nx, ny, nz,
             stencil.npoint, float(stencil.diag), float(stencil.off_coeff),
             float(omega), torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(err, "block_jacobi_sweep")
    return z_new
