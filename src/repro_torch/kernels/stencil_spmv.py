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
``stencil_ring_stage`` reports it, :func:`card_ring_stage`), which depends on
the dtype and, in float32, on the kernel's tail: float64 copies each element
by ``cp.async``, and so does float32 for every kernel but the two of
:data:`F32_PAIR_KERNELS`; bfloat16, and float32 under those two, copy
element pairs (4 bytes in bfloat16, 8 in float32) and sum two z-outputs a
thread (the pair stage, one kernel instance for each operand form) when nz
is even and the operand aligned to a pair; otherwise bfloat16 stages its
plane tiles through registers and float32 copies elements (``precond.cu``
then keeps those two kernels on ``stencil_kernel``).  Every kernel on the
ring (rows 1, 2, 4, the half-sweep, the block-Jacobi sweep and the
Chebyshev step, in bfloat16 BiCGStab's two passes) takes the stage its
operand gives; those whose tails load and store
their own streams as pairs (in bfloat16 all but the block-Jacobi sweep, in
float32 both sweeps) also need those streams aligned to a pair.

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
    "stencil_ring_stage": ([_I, _I, _I, _P, _I], ctypes.c_int),
    "stencil_spmv_partials": ([_I, _I, _I, _I], ctypes.c_longlong),
    **{f"stencil_spmv_{sfx}": _LAUNCH for sfx in _build.SUFFIXES},
    **{f"stencil_spmv_batched_{sfx}": _BATCHED for sfx in _build.SUFFIXES},
}


#: the ring pass's stages, in the order of ``stencil_ring_stage``'s answers
#: (``kStageAsync``, ``kStageRegister``, ``kStagePairPadded``,
#: ``kStagePairUnpadded`` of ``csrc/stencil.cuh``)
RING_STAGES = ("async", "register", "pair_padded", "pair_unpadded")


#: the kernels whose ring tails take float32's pair stage (``csrc/stencil.cuh``'s
#: ``f32_pair_tail``: ``ChebTail<float>``, ``JacobiTail<float>``, each with a
#: pair form); every other float32 launch of the ring copies elements
F32_PAIR_KERNELS = ("cheb_fused_step", "block_jacobi_sweep")


def ring_stage(dtype: torch.dtype, nz: int, zero_halo: bool, data_ptr: int,
               streams: tuple[int, ...] = (), kernel: str = "stencil_spmv") -> str:
    """The stage the ring pass takes for ``kernel``'s tail on an operand of
    ``dtype`` at address ``data_ptr`` with ``nz`` points along z, unpadded
    with ``zero_halo``: the source's static rule (``ring_stage``, and
    ``ring_tail_stage`` with the streams), which :func:`card_ring_stage`
    asks the built source for.  bfloat16, and float32 for the kernels of
    :data:`F32_PAIR_KERNELS`, copy pairs when nz is even and the operand is
    aligned to a pair (4 or 8 bytes); otherwise bfloat16 stages through
    registers and float32 copies elements.  ``streams`` are the addresses of
    the unpadded streams of a tail with a pair form (in bfloat16
    ``cheb_fused_step``'s, ``rb_gs_half_sweep``'s and both BiCGStab passes',
    in float32 both sweeps', outputs included): it loads and stores them as
    pairs, so one at an odd element offset sends the launch to the same
    fallback (``launch_stencil_ring``)."""
    if dtype == torch.float32 and kernel in F32_PAIR_KERNELS:
        align, fallback = 8, "async"
    elif dtype == torch.bfloat16:
        align, fallback = 4, "register"
    else:
        return "async"
    if nz % 2 or data_ptr % align or any(p % align for p in streams):
        return fallback
    return "pair_unpadded" if zero_halo else "pair_padded"


def card_ring_stage(x: torch.Tensor, *, zero_halo: bool = False,
                    kernel: str = "stencil_spmv") -> str:
    """The stage the built source's ring pass takes for ``kernel``'s tail on
    the operand ``x`` (padded, or unpadded with ``zero_halo``; a batch of
    lanes alike): its ``stencil_ring_stage``, asked for a tail of float32's
    pair stage when ``kernel`` is one of :data:`F32_PAIR_KERNELS`.  Needs the
    CUDA toolkit (it builds the sources); it launches nothing."""
    lib = _build.load("stencil_spmv", SIGNATURES)
    nz = int(x.shape[-1]) - (0 if zero_halo else 2)
    code = lib.stencil_ring_stage(x.element_size(), nz, int(zero_halo), x.data_ptr(),
                                  int(kernel in F32_PAIR_KERNELS))
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
