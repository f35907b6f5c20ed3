"""CUDA kernels: single-reduction BiCGStab's two fused stencil passes.

Counterpart of ``repro/kernels/bicgstab_fused.py`` (source:
``csrc/bicgstab_fused.cu``).  With ``kernels.fused_bodies``'s
``bicgstab_fused_update1`` between them they make the merged BiCGStab
iteration three memory passes:

    bicgstab_fused_spmv_dots    v = A·z̃, q = r − α·s, y = w − α·z and the nine
                                partials (q·y, y·y, q·q, r̂·q, r̂·y, r̂·t, r̂·v,
                                r̂·z, r̂·s)
    bicgstab_fused_spmv_update  t' = A·w̃, p' = r + β·(p − ω·s),
                                s' = w + β·(s − ω·z), z' = t' + β·(z − ω·v)

``z̃``/``w̃`` come halo-padded (``M(z)``/``M(w)`` when preconditioned); the
other vectors are unpadded and stream beside them.  α, ω and β are 0-d device
tensors read by the kernel.  The Pallas kernel adds the nine partials into
one revisited block; here each block writes its own slots and a second small
kernel sums them in a fixed order, so the scalars are bitwise reproducible.
The vectors and scalars are float64, float32 or bfloat16; bfloat16 partials
are float32.  Both passes are ``csrc/stencil.cuh``'s ``stencil_kernel`` in
float64 and float32 and its plane-ring pass in bfloat16 (``bicgstab_fused.cu``'s
static rules ``bicgstab_dots_on_ring`` and ``bicgstab_update_on_ring``,
mirrored by :func:`dots_pass` and :func:`update_pass`) from the same padded
``z̃``/``w̃``, on its pair stage where the operands allow it
(``stencil_spmv.ring_stage``: the padded operand and the tail's streams, nine
for the dots pass and ten for the update pass, 4-byte aligned, nz even); the
dots pass's partial slots are then the ring's block count, which
``bicgstab_partials_bf16`` reports.

Call them through ``kernels.ops.bicgstab_spmv_dots``/``bicgstab_spmv_update``,
which check the inputs and take the plain versions (``kernels.ref``) for CPU
tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.operators import Stencil
from repro_torch.kernels import _build

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_LAUNCH = ([_P] * 13 + [_I] * 4 + [_D, _D, _P], ctypes.c_int)
SIGNATURES = {
    **{f"bicgstab_partials_{sfx}": ([_I, _I, _I], ctypes.c_longlong)
       for sfx in _build.SUFFIXES},
    **{f"bicgstab_spmv_{form}_{sfx}": _LAUNCH for form in ("dots", "update")
       for sfx in _build.SUFFIXES},
}

#: the dtypes in which ``bicgstab_fused_spmv_dots`` runs on the plane-ring
#: pass (``csrc/bicgstab_fused.cu``'s ``bicgstab_dots_on_ring``); the others
#: on ``stencil_kernel``
DOTS_RING_DTYPES = (torch.bfloat16,)
#: the dtypes in which ``bicgstab_fused_spmv_update`` runs on the plane-ring
#: pass (``csrc/bicgstab_fused.cu``'s ``bicgstab_update_on_ring``); the
#: others on ``stencil_kernel``
UPDATE_RING_DTYPES = (torch.bfloat16,)


def dots_pass(dtype: torch.dtype) -> str:
    """The stencil pass ``bicgstab_fused_spmv_dots`` launches for vectors of
    ``dtype``: "ring" (the plane-ring pass) or "stencil" (``stencil_kernel``)."""
    return "ring" if dtype in DOTS_RING_DTYPES else "stencil"


def update_pass(dtype: torch.dtype) -> str:
    """The stencil pass ``bicgstab_fused_spmv_update`` launches for vectors
    of ``dtype``: "ring" (the plane-ring pass) or "stencil" (``stencil_kernel``)."""
    return "ring" if dtype in UPDATE_RING_DTYPES else "stencil"


def partial_slots(lib, dtype: torch.dtype, shape) -> int:
    """The partial slots a dot product of the dots pass takes for vectors
    of ``dtype`` and ``shape``: the block count of the pass it launches
    (``bicgstab_partials_<sfx>``)."""
    return int(getattr(lib, f"bicgstab_partials_{_build.suffix(dtype)}")(*shape))


def _launch(kernel: str, fn, xp: torch.Tensor, ptrs, stencil: Stencil) -> None:
    nx, ny, nz = (int(n) - 2 for n in xp.shape)
    err = fn(xp.data_ptr(), *ptrs, nx, ny, nz, stencil.npoint, float(stencil.diag),
             float(stencil.off_coeff), torch.cuda.current_stream(xp.device).cuda_stream)
    _build.check(err, kernel)


def bicgstab_fused_spmv_dots(zp: torch.Tensor, z, r, w, s, rhat, t,
                             alpha: torch.Tensor, *, stencil: Stencil):
    """``(v, q, y, parts)`` for CUDA tensors; ``parts`` is the 9-tuple of 0-d
    tensors on the device (float32 for bfloat16 vectors), ``alpha`` a 0-d
    tensor of the vectors' dtype."""
    lib = _build.load("bicgstab_fused", SIGNATURES)
    v, q, y = (torch.empty_like(z) for _ in range(3))
    acc = _build.acc_dtype(z.dtype)
    partials = torch.empty(9 * partial_slots(lib, z.dtype, z.shape), dtype=acc,
                           device=z.device)
    dots = torch.empty(9, dtype=acc, device=z.device)
    fn = getattr(lib, f"bicgstab_spmv_dots_{_build.suffix(z.dtype)}")
    _launch("bicgstab_fused_spmv_dots", fn, zp,
            [a.data_ptr() for a in (z, r, w, s, rhat, t, alpha, v, q, y, partials, dots)],
            stencil)
    return v, q, y, tuple(dots[k] for k in range(9))


def bicgstab_fused_spmv_update(wp: torch.Tensor, w, r, p, s, z, v,
                               omega: torch.Tensor, beta: torch.Tensor, *,
                               stencil: Stencil):
    """``(t', p', s', z')`` for CUDA tensors; ``omega``/``beta`` are 0-d
    tensors of the vectors' dtype on the same device."""
    lib = _build.load("bicgstab_fused", SIGNATURES)
    outs = tuple(torch.empty_like(w) for _ in range(4))
    fn = getattr(lib, f"bicgstab_spmv_update_{_build.suffix(w.dtype)}")
    _launch("bicgstab_fused_spmv_update", fn, wp,
            [a.data_ptr() for a in (w, r, p, s, z, v, omega, beta, *outs)], stencil)
    return outs
