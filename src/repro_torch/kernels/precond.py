"""CUDA kernels for the preconditioner sweeps: one stencil pass each.

Counterpart of ``repro/kernels/precond.py`` (source: ``csrc/precond.cu``):

  * ``cheb_fused_step``: one Chebyshev step, ``d' = a·d + c·(r − A z)`` and
    ``z' = z + d'``, from the halo-padded ``z``;
  * ``block_jacobi_sweep``: one damped local Jacobi sweep,
    ``z' = z + ω·(r − A z)/diag``, from the zero-padded ``z``.

Both are a stencil pass of ``csrc/stencil.cuh`` with an elementwise tail, so
``A z`` never reaches memory: the plane-ring pass in float64 and bfloat16
and, where it takes the ring's pair stage, in float32 (``precond.cu``'s
static rule ``on_ring``, mirrored by :func:`cheb_pass` and
:func:`jacobi_pass`), ``stencil_kernel`` otherwise.  ``z`` comes padded, or
with ``zero_halo`` unpadded: the ring makes the zero halo in its copies, so
the caller's pad pass goes; a launch the rule keeps on ``stencil_kernel``
needs the padded operand, which the wrapper then makes (one ``pad1``).
float64 copies elements (bitwise the old pass and the plain version);
bfloat16 takes the pair stage where the operands allow it
(``stencil_spmv.ring_stage``; the Chebyshev tail's pair form also needs
``r``, ``d`` and both outputs 4-byte aligned) and the register stage
otherwise; float32 takes it where nz is even and ``z``, ``r`` (``d``) and
the outputs are 8-byte aligned (both tails' pair forms load and store their
streams as float2), two z-outputs a thread, each lane the old pass's scalar
chain (bitwise its outputs), but for the Chebyshev step on the 7pt stencil
(:data:`CHEB_F32_OLD_NPOINTS`, where the pair stage lost), and keeps
``stencil_kernel`` otherwise.  ``old_pass`` launches ``stencil_kernel``
whatever the rule (float64 and float32: the yardstick the ring is timed
against).  The Pallas kernels bake ``a, c`` and ``ω`` in as compile-time
constants; here they are launch arguments (one build serves every
schedule).  The outputs are fresh tensors: Chebyshev's first step passes
``d`` and ``z`` as one tensor.

A 4-D ``r`` (and ``z``, ``d``) is a batch of lanes, (B, ...), swept in one
launch of the same pass (the lane-batched forms ``cheb_step_batched_*`` and
``jacobi_sweep_batched_*``), each lane on its own.

The operands are float64, float32 or bfloat16; ``a``, ``c`` and ``ω`` go to
the kernel as doubles and are rounded to the operands' dtype there (the
wrapper in ``kernels.ops`` has rounded them already).

Call them through ``kernels.ops.cheb_step``/``jacobi_sweep``, which check the
inputs and take the plain versions (``kernels.ref``) for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.operators import Stencil, pad1
from repro_torch.kernels import _build, stencil_spmv

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_CHEB = ([_P] * 5 + [_I] * 4 + [_D] * 4 + [_I, _I, _P], ctypes.c_int)
_JACOBI = ([_P] * 3 + [_I] * 4 + [_D] * 3 + [_I, _I, _P], ctypes.c_int)
_CHEB_BATCHED = ([_P] * 5 + [_I] * 5 + [_D] * 4 + [_I, _I, _P], ctypes.c_int)
_JACOBI_BATCHED = ([_P] * 3 + [_I] * 5 + [_D] * 3 + [_I, _I, _P], ctypes.c_int)
SIGNATURES = {
    f"{name}{form}_{sfx}": sig for sfx in _build.SUFFIXES
    for name, form, sig in (("cheb_step", "", _CHEB), ("jacobi_sweep", "", _JACOBI),
                            ("cheb_step", "_batched", _CHEB_BATCHED),
                            ("jacobi_sweep", "_batched", _JACOBI_BATCHED))
}


#: the dtypes in which ``block_jacobi_sweep`` runs on the plane-ring pass
#: (``csrc/precond.cu``'s ``on_ring``: bfloat16 and float64 always, float32
#: at the pair stage); the others on ``stencil_kernel``
JACOBI_RING_DTYPES = (torch.bfloat16, torch.float32, torch.float64)
#: the dtypes in which ``cheb_fused_step`` runs on the plane-ring pass
#: (``csrc/precond.cu``'s ``on_ring``, as for the block-Jacobi sweep)
CHEB_RING_DTYPES = (torch.bfloat16, torch.float32, torch.float64)
#: the stencils (npoint) on which float32's ``cheb_fused_step`` keeps
#: ``stencil_kernel`` at any alignment: its pair stage lost to the old pass
#: there (``chip_stencil_variants.py --f32``)
CHEB_F32_OLD_NPOINTS = (7,)


def _pass(kernel: str, dtype: torch.dtype, ring_dtypes, nz: int, zp: int,
          streams: tuple[int, ...], zero_halo: bool) -> str:
    if dtype not in ring_dtypes:
        return "stencil"
    if dtype == torch.float32 and not stencil_spmv.ring_stage(
            dtype, nz, zero_halo, zp, streams, kernel=kernel).startswith("pair"):
        return "stencil"
    return "ring"


def jacobi_pass(dtype: torch.dtype, nz: int = 0, zp: int = 0,
                streams: tuple[int, ...] = (), npoint: int = 27,
                zero_halo: bool = False) -> str:
    """The stencil pass ``block_jacobi_sweep`` launches for operands of
    ``dtype``: "ring" (the plane-ring pass) or "stencil" (``stencil_kernel``).
    In float32 it depends on the launch: the ring where it takes the pair
    stage (``nz`` even, z at address ``zp``, padded or with ``zero_halo``
    unpadded, and the ``streams`` ``r`` and ``z'`` 8-byte aligned:
    ``stencil_spmv.ring_stage``), on either stencil; the defaults are such
    operands."""
    return _pass("block_jacobi_sweep", dtype, JACOBI_RING_DTYPES, nz, zp, streams, zero_halo)


def cheb_pass(dtype: torch.dtype, nz: int = 0, zp: int = 0,
              streams: tuple[int, ...] = (), npoint: int = 27,
              zero_halo: bool = False) -> str:
    """The stencil pass ``cheb_fused_step`` launches for operands of
    ``dtype`` on the ``npoint`` stencil, as :func:`jacobi_pass` (its
    ``streams``: ``r``, ``d``, ``z'`` and ``d'``), but float32 keeps
    ``stencil_kernel`` on the stencils of :data:`CHEB_F32_OLD_NPOINTS`."""
    if dtype == torch.float32 and npoint in CHEB_F32_OLD_NPOINTS:
        return "stencil"
    return _pass("cheb_fused_step", dtype, CHEB_RING_DTYPES, nz, zp, streams, zero_halo)


def _entry(lib, name: str, r: torch.Tensor):
    """The C entry point ``name`` in ``r``'s dtype: the lane-batched one for
    a 4-D ``r``, whose shape arguments (lanes, nx, ny, nz) are ``r``'s shape
    as (nx, ny, nz) are a grid's."""
    form = "_batched" if r.dim() == 4 else ""
    return getattr(lib, f"{name}{form}_{_build.suffix(r.dtype)}")


def _operand(z: torch.Tensor, zero_halo: bool, old_pass: bool, mirror, npoint: int,
             streams) -> tuple[torch.Tensor, bool]:
    """``z`` and its form as the launch takes it: an unpadded ``z`` whose
    launch stays on ``stencil_kernel`` (the rule's ``mirror``, or
    ``old_pass``) padded first (one ``pad1``, the one pad pass left)."""
    if zero_halo and (old_pass or mirror(z.dtype, int(z.shape[-1]), z.data_ptr(),
                                         tuple(t.data_ptr() for t in streams), npoint,
                                         zero_halo=True) == "stencil"):
        return pad1(z), False
    return z, zero_halo


def cheb_fused_step(z: torch.Tensor, r: torch.Tensor, d: torch.Tensor, *,
                    stencil: Stencil, a: float, c: float, zero_halo: bool = False,
                    old_pass: bool = False):
    """``(z', d')`` for CUDA tensors: ``z`` padded or, with ``zero_halo``,
    unpadded; ``r`` and ``d`` unpadded.  ``old_pass``: on ``stencil_kernel``
    (float64 and float32)."""
    lib = _build.load("precond", SIGNATURES)
    z_new, d_new = torch.empty_like(r), torch.empty_like(r)
    z, zero_halo = _operand(z, zero_halo, old_pass, cheb_pass, stencil.npoint,
                            (r, d, z_new, d_new))
    fn = _entry(lib, "cheb_step", r)
    err = fn(z.data_ptr(), r.data_ptr(), d.data_ptr(), z_new.data_ptr(),
             d_new.data_ptr(), *r.shape, stencil.npoint, float(stencil.diag),
             float(stencil.off_coeff), float(a), float(c), int(zero_halo), int(old_pass),
             torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(err, "cheb_fused_step")
    return z_new, d_new


def block_jacobi_sweep(z: torch.Tensor, r: torch.Tensor, *, stencil: Stencil,
                       omega: float = 1.0, zero_halo: bool = False,
                       old_pass: bool = False) -> torch.Tensor:
    """``z'`` for CUDA tensors: ``z`` zero-padded or, with ``zero_halo``,
    unpadded; ``r`` unpadded.  ``old_pass``: on ``stencil_kernel`` (float64
    and float32)."""
    lib = _build.load("precond", SIGNATURES)
    z_new = torch.empty_like(r)
    z, zero_halo = _operand(z, zero_halo, old_pass, jacobi_pass, stencil.npoint,
                            (r, z_new))
    fn = _entry(lib, "jacobi_sweep", r)
    err = fn(z.data_ptr(), r.data_ptr(), z_new.data_ptr(), *r.shape,
             stencil.npoint, float(stencil.diag), float(stencil.off_coeff),
             float(omega), int(zero_halo), int(old_pass),
             torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(err, "block_jacobi_sweep")
    return z_new
