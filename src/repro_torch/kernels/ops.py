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
    "stencil_spmv_dots3": 0,
    "fused_pcg_body": 0,
    "cheb_fused_step": 0,
    "block_jacobi_sweep": 0,
    "fused_pipe_body": 0,
    "fused_dots": 0,
    "fused_ppipe_body": 0,
    "bicgstab_fused_spmv_dots": 0,
    "bicgstab_fused_update1": 0,
    "bicgstab_fused_spmv_update": 0,
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


def _check_interior(kernel: str, xp: torch.Tensor, *ts: torch.Tensor) -> None:
    """Each unpadded operand in ``ts`` has the shape of ``xp``'s interior."""
    want = tuple(n - 2 for n in xp.shape)
    for t in ts:
        if tuple(t.shape) != want:
            raise ValueError(f"{kernel}: unpadded operand of shape "
                             f"{tuple(t.shape)} for a padded operand of shape "
                             f"{tuple(xp.shape)} (want {want})")


def _check_same_shape(kernel: str, names: str, *vs: torch.Tensor) -> None:
    if any(v.shape != vs[0].shape for v in vs):
        raise ValueError(f"{kernel}: {names} must share one shape")


def _scalars(kernel: str, ref: torch.Tensor, *cs) -> tuple:
    """0-d device tensors of ``ref``'s dtype for the scalar arguments."""
    out = tuple(torch.as_tensor(c, dtype=ref.dtype, device=ref.device) for c in cs)
    if any(c.numel() != 1 for c in out):
        raise ValueError(f"{kernel}: each scalar argument must have one element")
    return out


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
    _check_same_shape("fused_cg_body", "x, r, p, s, w", x, r, p, s, w)
    if not _on_card("fused_cg_body", x, r, p, s, w):
        return ref.fused_cg_body_ref(alpha, beta, x, r, p, s, w)
    a, b = _scalars("fused_cg_body", x, alpha, beta)
    from repro_torch.kernels.cg_fused_update import fused_cg_body
    return _launched("fused_cg_body", fused_cg_body(a, b, x, r, p, s, w))


def spmv_dots3(xp: torch.Tensor, r: torch.Tensor, stencil: Stencil):
    """``(A·x, (A·x)·x, r·x, r·r)`` in one pass (merged PCG's reduction
    triple with ``x = u``); ``r`` is unpadded."""
    _check_padded("stencil_spmv_dots3", xp, stencil)
    _check_interior("stencil_spmv_dots3", xp, r)
    if _on_card("stencil_spmv_dots3", xp, r):
        from repro_torch.kernels.spmv_dot import stencil_spmv_dots3
        return _launched("stencil_spmv_dots3",
                         stencil_spmv_dots3(xp, r, stencil=stencil))
    return ref.stencil_spmv_dots3_ref(xp, r, stencil=stencil)


def pcg_body(alpha, beta, x, r, u, p, s, w):
    """Merged PCG's four vector updates in one pass -> ``(x', r', p', s')``.

    ``alpha``/``beta`` are 0-d tensors (or numbers, copied to the device)."""
    _check_same_shape("fused_pcg_body", "x, r, u, p, s, w", x, r, u, p, s, w)
    if not _on_card("fused_pcg_body", x, r, u, p, s, w):
        return ref.fused_pcg_body_ref(alpha, beta, x, r, u, p, s, w)
    a, b = _scalars("fused_pcg_body", x, alpha, beta)
    from repro_torch.kernels.fused_bodies import fused_pcg_body
    return _launched("fused_pcg_body", fused_pcg_body(a, b, x, r, u, p, s, w))


def pipe_body(alpha, beta, x, r, w, p, s, z, n):
    """Pipelined CG's six recurrences in one pass -> ``(x', r', w', p', s', z')``.

    ``alpha``/``beta`` are 0-d tensors (or numbers, copied to the device)."""
    vecs = (x, r, w, p, s, z, n)
    _check_same_shape("fused_pipe_body", "x, r, w, p, s, z, n", *vecs)
    if not _on_card("fused_pipe_body", *vecs):
        return ref.fused_pipe_body_ref(alpha, beta, *vecs)
    a, b = _scalars("fused_pipe_body", x, alpha, beta)
    from repro_torch.kernels.fused_bodies import fused_pipe_body
    return _launched("fused_pipe_body", fused_pipe_body(a, b, *vecs))


def fused_dots(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """The partials ``(a·b, c·b, a·a)`` in one read pass (pipelined PCG's
    ``(r·u, w·u, r·r)`` with ``(a, b, c) = (r, u, w)``)."""
    _check_same_shape("fused_dots", "a, b, c", a, b, c)
    if not _on_card("fused_dots", a, b, c):
        return ref.fused_dots_ref(a, b, c)
    from repro_torch.kernels.fused_bodies import fused_dots as kernel
    return _launched("fused_dots", kernel(a, b, c))


def ppipe_body(alpha, beta, x, r, u, w, p, s, q, z, m, n):
    """Pipelined PCG's eight recurrences in one pass ->
    ``(x', r', u', w', p', s', q', z')``.

    ``alpha``/``beta`` are 0-d tensors (or numbers, copied to the device)."""
    vecs = (x, r, u, w, p, s, q, z, m, n)
    _check_same_shape("fused_ppipe_body", "x, r, u, w, p, s, q, z, m, n", *vecs)
    if not _on_card("fused_ppipe_body", *vecs):
        return ref.fused_ppipe_body_ref(alpha, beta, *vecs)
    a, b = _scalars("fused_ppipe_body", x, alpha, beta)
    from repro_torch.kernels.fused_bodies import fused_ppipe_body
    return _launched("fused_ppipe_body", fused_ppipe_body(a, b, *vecs))


def bicgstab_spmv_dots(zp: torch.Tensor, z, r, w, s, rhat, t, alpha,
                       stencil: Stencil):
    """Single-reduction BiCGStab's first pass from the halo-padded ``zp``
    (``M(z)`` when preconditioned) -> ``(v, q, y, parts)``: ``v = A·z̃``,
    ``q = r − α·s``, ``y = w − α·z`` and the nine partials ``(q·y, y·y, q·q,
    r̂·q, r̂·y, r̂·t, r̂·v, r̂·z, r̂·s)``; ``alpha`` is a 0-d tensor (or a
    number, copied to the device)."""
    kernel = "bicgstab_fused_spmv_dots"
    vecs = (z, r, w, s, rhat, t)
    _check_padded(kernel, zp, stencil)
    _check_interior(kernel, zp, *vecs)
    if not _on_card(kernel, zp, *vecs):
        return ref.bicgstab_spmv_dots_ref(zp, *vecs, alpha, stencil=stencil)
    (a,) = _scalars(kernel, z, alpha)
    from repro_torch.kernels.bicgstab_fused import bicgstab_fused_spmv_dots
    return _launched(kernel, bicgstab_fused_spmv_dots(zp, *vecs, a, stencil=stencil))


def bicgstab_update1(alpha, omega, y, p, q, yv, t, v):
    """Single-reduction BiCGStab's ω-half in one pass -> ``(y', r', w')``
    with ``y' = y + α·p + ω·q``, ``r' = q − ω·yv``, ``w' = yv − ω·(t − α·v)``;
    ``alpha``/``omega`` are 0-d tensors (or numbers, copied to the device)."""
    kernel = "bicgstab_fused_update1"
    vecs = (y, p, q, yv, t, v)
    _check_same_shape(kernel, "y, p, q, yv, t, v", *vecs)
    if not _on_card(kernel, *vecs):
        return ref.bicgstab_update1_ref(alpha, omega, *vecs)
    a, o = _scalars(kernel, y, alpha, omega)
    from repro_torch.kernels.fused_bodies import bicgstab_fused_update1
    return _launched(kernel, bicgstab_fused_update1(a, o, *vecs))


def bicgstab_spmv_update(wp: torch.Tensor, w, r, p, s, z, v, omega, beta,
                         stencil: Stencil):
    """Single-reduction BiCGStab's last pass from the halo-padded ``wp``
    (``M(w)`` when preconditioned) -> ``(t', p', s', z')``: ``t' = A·w̃`` and
    ``p' = r + β·(p − ω·s)``, ``s' = w + β·(s − ω·z)``, ``z' = t' + β·(z − ω·v)``;
    ``omega``/``beta`` are 0-d tensors (or numbers, copied to the device)."""
    kernel = "bicgstab_fused_spmv_update"
    vecs = (w, r, p, s, z, v)
    _check_padded(kernel, wp, stencil)
    _check_interior(kernel, wp, *vecs)
    if not _on_card(kernel, wp, *vecs):
        return ref.bicgstab_spmv_update_ref(wp, *vecs, omega, beta, stencil=stencil)
    o, b = _scalars(kernel, w, omega, beta)
    from repro_torch.kernels.bicgstab_fused import bicgstab_fused_spmv_update
    return _launched(kernel, bicgstab_fused_spmv_update(wp, *vecs, o, b, stencil=stencil))


def cheb_step(zp: torch.Tensor, r: torch.Tensor, d: torch.Tensor,
              stencil: Stencil, *, a: float, c: float):
    """One Chebyshev step from the halo-padded ``zp`` -> ``(z', d')`` with
    ``d' = a·d + c·(r − A z)`` and ``z' = z + d'``."""
    _check_padded("cheb_fused_step", zp, stencil)
    _check_interior("cheb_fused_step", zp, r, d)
    if _on_card("cheb_fused_step", zp, r, d):
        from repro_torch.kernels.precond import cheb_fused_step
        return _launched("cheb_fused_step",
                         cheb_fused_step(zp, r, d, stencil=stencil, a=a, c=c))
    return ref.cheb_fused_step_ref(zp, r, d, stencil=stencil, a=a, c=c)


def jacobi_sweep(zp: torch.Tensor, r: torch.Tensor, stencil: Stencil, *,
                 omega: float = 1.0) -> torch.Tensor:
    """One damped Jacobi sweep ``z + ω·(r − A z)/diag`` from the zero-padded
    ``zp``."""
    _check_padded("block_jacobi_sweep", zp, stencil)
    _check_interior("block_jacobi_sweep", zp, r)
    if _on_card("block_jacobi_sweep", zp, r):
        from repro_torch.kernels.precond import block_jacobi_sweep
        return _launched("block_jacobi_sweep",
                         block_jacobi_sweep(zp, r, stencil=stencil, omega=omega))
    return ref.block_jacobi_sweep_ref(zp, r, stencil=stencil, omega=omega)


def make_matvec_padded(stencil: Stencil):
    """A ``matvec_padded`` hook (for ``LocalOp``) backed by the SpMV kernel."""

    def mv(xp: torch.Tensor) -> torch.Tensor:
        return spmv(xp, stencil)

    return mv
