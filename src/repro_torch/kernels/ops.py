"""Dispatch wrappers for the kernels (counterpart of ``repro/kernels/ops.py``).

The rule replaces the reference's ``interpret`` switch: a CPU tensor takes the
kernel's plain PyTorch version (``kernels.ref``); a CUDA tensor launches the
hand-written CUDA kernel or raises.  Nothing falls back.  Every wrapper checks
device, dtype (float32/float64), shape and contiguity first.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched it on the
card, so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import torch

from repro_torch.core.operators import STENCIL_7PT, STENCIL_27PT, Stencil
from repro_torch.core.problems import DTYPES
from repro_torch.kernels import ref

#: kernel name -> launches on the card since the last reset
LAUNCHES: dict[str, int] = {
    "stencil_spmv": 0,
    "stencil_spmv_dots": 0,
    "fused_cg_body": 0,
}

#: the offset orders the CUDA stencil kernels hard-code
_KERNEL_OFFSETS = (STENCIL_7PT.offsets, STENCIL_27PT.offsets)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_card(kernel: str, *ts: torch.Tensor) -> bool:
    """Validate ``ts``; True for CUDA tensors (launch), False for CPU ones."""
    t0 = ts[0]
    for t in ts:
        if t.dtype not in DTYPES:
            raise TypeError(f"{kernel}: dtype {t.dtype} not supported "
                            f"(float32 or float64)")
        if t.dtype != t0.dtype or t.device != t0.device:
            raise ValueError(f"{kernel}: operands differ in dtype or device "
                             f"({t.dtype}/{t.device} vs {t0.dtype}/{t0.device})")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: operands must be contiguous")
    if t0.device.type == "cpu":
        return False
    if t0.device.type != "cuda":
        raise ValueError(f"{kernel}: device {t0.device} has no kernel "
                         f"(CUDA launches the kernel, CPU its plain version)")
    if t0.device.index != torch.cuda.current_device():
        raise ValueError(f"{kernel}: operands on {t0.device} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    return True


def _launched(kernel: str, out):
    LAUNCHES[kernel] += 1
    return out


def _check_padded(kernel: str, xp: torch.Tensor, stencil: Stencil) -> None:
    if xp.dim() != 3 or min(xp.shape) < 3:
        raise ValueError(f"{kernel}: need a halo-padded (nx+2, ny+2, nz+2) "
                         f"array with nx, ny, nz >= 1, got {tuple(xp.shape)}")
    if xp.device.type == "cuda" and stencil.offsets not in _KERNEL_OFFSETS:
        raise ValueError(f"{kernel}: the CUDA kernel takes the 7pt and 27pt "
                         f"offset orders only, got stencil {stencil.name!r}")


def spmv(xp: torch.Tensor, stencil: Stencil) -> torch.Tensor:
    """``A·x`` from the halo-padded ``xp``."""
    _check_padded("stencil_spmv", xp, stencil)
    if _on_card("stencil_spmv", xp):
        from repro_torch.kernels.stencil_spmv import stencil_spmv
        return _launched("stencil_spmv", stencil_spmv(xp, stencil=stencil))
    return ref.stencil_spmv_ref(xp, stencil=stencil)


def spmv_dot(xp: torch.Tensor, stencil: Stencil):
    """``(A·x, (A·x)·x)`` in one pass (the ``fuse_dot`` form of the SpMV)."""
    _check_padded("stencil_spmv", xp, stencil)
    if _on_card("stencil_spmv", xp):
        from repro_torch.kernels.stencil_spmv import stencil_spmv
        return _launched("stencil_spmv",
                         stencil_spmv(xp, stencil=stencil, fuse_dot=True))
    return ref.stencil_spmv_dot_ref(xp, stencil=stencil)


def spmv_dots(xp: torch.Tensor, stencil: Stencil):
    """``(A·x, (A·x)·x, x·x)`` in one pass (merged CG's reduction pair)."""
    _check_padded("stencil_spmv_dots", xp, stencil)
    if _on_card("stencil_spmv_dots", xp):
        from repro_torch.kernels.spmv_dot import stencil_spmv_dots
        return _launched("stencil_spmv_dots",
                         stencil_spmv_dots(xp, stencil=stencil))
    return ref.stencil_spmv_dots_ref(xp, stencil=stencil)


def cg_body(alpha, beta, x, r, p, s, w):
    """Merged-CG's four vector updates in one pass -> ``(x', r', p', s')``.

    ``alpha``/``beta`` are 0-d tensors (or numbers, copied to the device)."""
    if any(v.shape != x.shape for v in (r, p, s, w)):
        raise ValueError("fused_cg_body: x, r, p, s, w must share one shape")
    if not _on_card("fused_cg_body", x, r, p, s, w):
        return ref.fused_cg_body_ref(alpha, beta, x, r, p, s, w)
    a, b = (torch.as_tensor(c, dtype=x.dtype, device=x.device) for c in (alpha, beta))
    if a.numel() != 1 or b.numel() != 1:
        raise ValueError("fused_cg_body: alpha and beta must be scalars")
    from repro_torch.kernels.cg_fused_update import fused_cg_body
    return _launched("fused_cg_body", fused_cg_body(a, b, x, r, p, s, w))


def make_matvec_padded(stencil: Stencil):
    """A ``matvec_padded`` hook (for ``LocalOp``) backed by the SpMV kernel."""

    def mv(xp: torch.Tensor) -> torch.Tensor:
        return spmv(xp, stencil)

    return mv
