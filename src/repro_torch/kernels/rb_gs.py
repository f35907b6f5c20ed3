"""CUDA kernel: one red-black Gauss-Seidel half-sweep.

Counterpart of ``repro/kernels/rb_gs.py::rb_gs_half_sweep`` (source:
``csrc/rb_gs.cu``):

    x[i,j,k] <- (b[i,j,k] − Σ_off c·x[neigh]) / diag   where (i+j+k) % 2 == colour
    x[i,j,k] <- x[i,j,k]                                otherwise

from the halo-padded old iterate.  It is a stencil pass of
``csrc/stencil.cuh`` in its off-diagonal form (centre left out, the offsets
summed from 0 in ``Stencil.offsets`` order) with a per-point tail, so the
off-diagonal sum never reaches memory: the plane-ring pass
(``stencil_ring_kernel``) in float64 27pt and in bfloat16, ``stencil_kernel``
in float64 7pt and float32 (``rb_gs.cu``'s static rule ``on_ring``, mirrored
by :func:`sweep_pass`).  bfloat16 takes the ring's pair stage where the
operands allow it (``stencil_spmv.ring_stage``: nz even, ``xp``, ``b`` and the
output 4-byte aligned), its tail's pair form storing both lanes of a pair at
once.  The Pallas kernel specialises on the colour; here it is a launch
argument.  The output is a fresh tensor.  ``xp`` and ``b`` are float64,
float32 or bfloat16.

Call it through ``kernels.ops.gs_half_sweep``, which checks the inputs and
takes the plain version (``kernels.ref``) for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.operators import Stencil
from repro_torch.kernels import _build

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SWEEP = ([_P] * 3 + [_I] * 4 + [_D] * 2 + [_I, _P], ctypes.c_int)
SIGNATURES = {f"rb_gs_half_sweep_{sfx}": _SWEEP for sfx in _build.SUFFIXES}

#: the dtypes in which ``rb_gs_half_sweep`` runs on the plane-ring pass in
#: both stencils (``csrc/rb_gs.cu``'s ``on_ring``), and the one that runs
#: there in 27pt alone; the others on ``stencil_kernel``
RING_DTYPES = (torch.bfloat16,)
RING_27PT_DTYPES = (torch.float64,)


def sweep_pass(dtype: torch.dtype, npoint: int) -> str:
    """The stencil pass ``rb_gs_half_sweep`` launches for operands of
    ``dtype`` on the ``npoint`` stencil: "ring" (the plane-ring pass) or
    "stencil" (``stencil_kernel``)."""
    on_ring = dtype in RING_DTYPES or (dtype in RING_27PT_DTYPES and npoint == 27)
    return "ring" if on_ring else "stencil"


def rb_gs_half_sweep(xp: torch.Tensor, b: torch.Tensor, *, stencil: Stencil,
                     colour: int) -> torch.Tensor:
    """The swept ``(nx, ny, nz)`` grid for CUDA tensors: ``xp`` padded, ``b``
    not; ``colour`` 0 or 1."""
    lib = _build.load("rb_gs", SIGNATURES)
    nx, ny, nz = b.shape
    x_new = torch.empty_like(b)
    fn = getattr(lib, f"rb_gs_half_sweep_{_build.suffix(b.dtype)}")
    err = fn(xp.data_ptr(), b.data_ptr(), x_new.data_ptr(), nx, ny, nz, stencil.npoint,
             float(stencil.diag), float(stencil.off_coeff), int(colour),
             torch.cuda.current_stream(b.device).cuda_stream)
    _build.check(err, "rb_gs_half_sweep")
    return x_new
