"""CUDA kernel: 7/27-point stencil SpMV, optionally with the fused y·x partial.

Counterpart of ``repro/kernels/stencil_spmv.py::stencil_spmv`` (source:
``csrc/stencil_spmv.cu``).  The Pallas kernel streams z-slabs through an
overlapping VMEM window; the CUDA kernel is the plane-ring pass of
``csrc/stencil.cuh``: a block marches a (y, z) tile along x through a ring of
plane tiles in shared memory, and masks the ragged edges itself, so any grid
works.  ``x`` comes padded, (nx+2, ny+2, nz+2) with the caller's halo, or
with ``zero_halo`` unpadded, (nx, ny, nz), the zero halo made in the kernel.
``run`` is the number of x-planes a block marches (``autotune.RUN_CANDIDATES``,
one kernel instance each; the C entry point refuses any other).
The ``fuse_dot`` partial is reduced without atomics (per-block slots, then a
fixed-order pass), so it is bitwise reproducible.  A 4-D ``x`` is a batch of
lanes, (B, ...) in either form, applied in one launch of the same pass (the
lane-batched form, ``stencil_spmv_batched_*``), with no ``fuse_dot`` and in
runs of the default 16 planes.  ``x`` is float64, float32 or bfloat16 (the
``_f64``/``_f32``/``_bf16`` entry points); a bfloat16 ``fuse_dot`` partial is
float32.

The ring pass's stage is a static rule of the source (``ring_stage`` in
``csrc/stencil.cuh``; :func:`ring_stage` mirrors it, and the C entry point
``stencil_ring_stage`` reports it, :func:`card_ring_stage`): float32 and
float64 copy each element by ``cp.async``; bfloat16 copies 4-byte pairs and
sums two z-outputs a thread in bf16x2 (the pair stage, one kernel instance
for each operand form) when nz is even and the operand 4-byte aligned, and
otherwise stages its plane tiles through registers.  Every kernel on the
ring (rows 1, 2, 4, the half-sweep, and in bfloat16 the block-Jacobi sweep,
the Chebyshev step and BiCGStab's two passes) takes the stage its operand
gives; those whose tails load and store their own streams as bf16 pairs (in
bfloat16 all but the block-Jacobi sweep) also need those streams 4-byte
aligned.

Call it through ``kernels.ops.spmv``/``spmv_dot``, which check the inputs and
take the plain version (``kernels.ref``) for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.operators import Stencil
from repro_torch.kernels import _build, autotune

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_LAUNCH = ([_P, _P, _P, _P, _I, _I, _I, _I, _D, _D, _I, _I, _I, _P], ctypes.c_int)
_BATCHED = ([_P, _P, _I, _I, _I, _I, _I, _D, _D, _I, _P], ctypes.c_int)
SIGNATURES = {
    "stencil_ring_stage": ([_I, _I, _I, _P], ctypes.c_int),
    "stencil_spmv_partials": ([_I, _I, _I, _I], ctypes.c_longlong),
    **{f"stencil_spmv_{sfx}": _LAUNCH for sfx in _build.SUFFIXES},
    **{f"stencil_spmv_batched_{sfx}": _BATCHED for sfx in _build.SUFFIXES},
}


#: the ring pass's stages, in the order of ``stencil_ring_stage``'s answers
#: (``kStageAsync``, ``kStageRegister``, ``kStagePairPadded``,
#: ``kStagePairUnpadded`` of ``csrc/stencil.cuh``)
RING_STAGES = ("async", "register", "pair_padded", "pair_unpadded")


def ring_stage(dtype: torch.dtype, nz: int, zero_halo: bool, data_ptr: int,
               streams: tuple[int, ...] = ()) -> str:
    """The stage the ring pass takes for an operand of ``dtype`` at address
    ``data_ptr`` with ``nz`` points along z, unpadded with ``zero_halo``: the
    source's static rule (``ring_stage``), which :func:`card_ring_stage`
    asks the built source for.  ``streams`` are the addresses of the
    unpadded streams of a tail with a pair form (in bfloat16
    ``cheb_fused_step``'s, ``rb_gs_half_sweep``'s and both BiCGStab passes',
    outputs included): it loads and stores them as bf16 pairs, so one at an
    odd element offset sends the launch to the register stage
    (``launch_stencil_ring``)."""
    if dtype != torch.bfloat16:
        return "async"
    if nz % 2 or data_ptr % 4 or any(p % 4 for p in streams):
        return "register"
    return "pair_unpadded" if zero_halo else "pair_padded"


def card_ring_stage(x: torch.Tensor, *, zero_halo: bool = False) -> str:
    """The stage the built source's ring pass takes for the operand ``x``
    (padded, or unpadded with ``zero_halo``; a batch of lanes alike): its
    ``stencil_ring_stage``.  Needs the CUDA toolkit (it builds the
    sources); it launches nothing."""
    lib = _build.load("stencil_spmv", SIGNATURES)
    nz = int(x.shape[-1]) - (0 if zero_halo else 2)
    code = lib.stencil_ring_stage(x.element_size(), nz, int(zero_halo), x.data_ptr())
    if code < 0:
        raise TypeError(f"stencil_spmv: dtype {x.dtype} has no ring pass")
    return RING_STAGES[code]


def stencil_spmv(x: torch.Tensor, *, stencil: Stencil, fuse_dot: bool = False,
                 zero_halo: bool = False, run: int = autotune.DEFAULT_RUN):
    """``y = A·x`` (and ``y·x`` with ``fuse_dot``) from the CUDA ``x``: padded,
    or unpadded with ``zero_halo``, in runs of ``run`` x-planes.

    Returns ``y`` of shape (nx, ny, nz), or ``(y, dot)`` with ``dot`` a 0-d
    tensor on the device (float32 for a bfloat16 ``x``).  A 4-D ``x`` is B lanes, each applied on its own
    in one launch: ``y`` is (B, nx, ny, nz).
    """
    lib = _build.load("stencil_spmv", SIGNATURES)
    if x.dim() == 4:
        if fuse_dot:
            raise ValueError("stencil_spmv: the lane-batched form takes no fuse_dot")
        if run != autotune.DEFAULT_RUN:
            raise ValueError(f"stencil_spmv: the lane-batched form marches runs of "
                             f"{autotune.DEFAULT_RUN} planes, got run={run}")
        return _batched(lib, x, stencil, zero_halo)
    nx, ny, nz = (int(n) - (0 if zero_halo else 2) for n in x.shape)
    y = torch.empty((nx, ny, nz), dtype=x.dtype, device=x.device)
    partials = dot = None
    if fuse_dot:
        acc = _build.acc_dtype(x.dtype)
        partials = torch.empty(_build.slots(lib.stencil_spmv_partials(nx, ny, nz, run),
                                            "stencil_spmv", run),
                               dtype=acc, device=x.device)
        dot = torch.empty(1, dtype=acc, device=x.device)
    fn = getattr(lib, f"stencil_spmv_{_build.suffix(x.dtype)}")
    err = fn(x.data_ptr(), y.data_ptr(),
             None if partials is None else partials.data_ptr(),
             None if dot is None else dot.data_ptr(),
             nx, ny, nz, stencil.npoint, float(stencil.diag),
             float(stencil.off_coeff), int(fuse_dot), int(zero_halo), int(run),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "stencil_spmv")
    if fuse_dot:
        return y, dot[0]
    return y


def _batched(lib, x: torch.Tensor, stencil: Stencil, zero_halo: bool) -> torch.Tensor:
    lanes = int(x.shape[0])
    nx, ny, nz = (int(n) - (0 if zero_halo else 2) for n in x.shape[1:])
    y = torch.empty((lanes, nx, ny, nz), dtype=x.dtype, device=x.device)
    fn = getattr(lib, f"stencil_spmv_batched_{_build.suffix(x.dtype)}")
    err = fn(x.data_ptr(), y.data_ptr(), lanes, nx, ny, nz, stencil.npoint,
             float(stencil.diag), float(stencil.off_coeff), int(zero_halo),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "stencil_spmv (batched)")
    return y
