"""Dispatch wrappers for the kernels (counterpart of ``repro/kernels/ops.py``).

The rule replaces the reference's ``interpret`` switch: a CPU tensor takes the
kernel's plain PyTorch version (``kernels.ref``); a CUDA tensor launches the
hand-written CUDA kernel or raises.  Nothing falls back.  Every wrapper checks
device, dtype, shape and contiguity first.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched it on the
card, so a run can show that its main path went through the kernels.

``spmv``, ``cheb_step`` and ``jacobi_sweep`` also take a batch of lanes: 4-D
operands, (B, ...) stacked on a leading axis, as the batched solve's
vmapped Pallas calls take them.  On the card that is one launch of the
kernel's lane-batched form, counted under its own key (``<kernel>_batched``);
on the CPU the plain version on the 4-D operands, which acts on each lane on
its own.

The solver kernels take float64, float32 and bfloat16
(:data:`SOLVER_KERNEL_DTYPES`; ``flash_attention`` float32 and bfloat16,
:data:`ATTENTION_DTYPES`), every operand of one call in one dtype (mixed
dtypes raise ``ValueError``).  bfloat16 goes in and comes out; its dot
partials are float32 sums of float32 products, as the reference's
``acc_dtype`` rule has them.  Every scalar argument is rounded to the
operands' dtype before either branch (``_scalars``; ``a``, ``c`` and ``ω``
by ``ref.scalars_like``), as the reference rounds its coefficients (an
``astype`` to the operands' dtype, or JAX's weak typing of a Python
float): PyTorch would multiply a bfloat16 tensor by a float32 scalar.  In
float32 and float64 the rounding changes no bit.  The solver facade (``KernelOp``,
``SolverSession``, ``core.problems.DTYPES``) stays float32/float64.

One launch-geometry knob is an argument (``kernels.autotune`` tunes it):
``run=`` of ``spmv``, ``spmv_dot``, ``spmv_dots`` and ``spmv_dots3``, the
x-planes a block of the plane-ring pass marches, one of
``autotune.RUN_CANDIDATES`` (a batch of lanes takes ``DEFAULT_RUN`` only).
It is validated on every device and changes no output of the plain
versions, which have no tiles; on the card it sets the order in which the
dot partials are summed.
"""

from __future__ import annotations

import torch

from repro_torch.core.operators import STENCIL_7PT, STENCIL_27PT, Stencil, pad1
from repro_torch.kernels import ref
from repro_torch.kernels.autotune import DEFAULT_RUN, RUN_CANDIDATES

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
    "fused_axpby": 0,
    "fused_axpby_dot": 0,
    "cg_fused_update": 0,
    "rb_gs_half_sweep": 0,
    "flash_attention": 0,
    # the lane-batched forms (one launch over B lanes)
    "stencil_spmv_batched": 0,
    "cheb_fused_step_batched": 0,
    "block_jacobi_sweep_batched": 0,
}

#: the dtypes the attention kernel takes (its C entry points: float, bf16)
ATTENTION_DTYPES = (torch.float32, torch.bfloat16)
#: the dtypes the solver kernels take (their ``_f64``/``_f32``/``_bf16`` C
#: entry points)
SOLVER_KERNEL_DTYPES = (torch.float64, torch.float32, torch.bfloat16)

#: the offset orders the CUDA stencil kernels hard-code
_KERNEL_OFFSETS = (STENCIL_7PT.offsets, STENCIL_27PT.offsets)


#: called as ``OBSERVER(kernel, nbytes)`` at each counted launch, with the
#: bytes the launch moves (each tensor operand read once, each output written
#: once: the bytes a kernel row's bound is computed from); set by
#: ``analysis.oplog.OpLog``, which cannot see a kernel's launch otherwise
OBSERVER = None
#: the tensor operands' bytes of the launch ``_on_card`` has just admitted
_operand_bytes = 0


def _tensor_bytes(ts) -> int:
    if isinstance(ts, torch.Tensor):
        return ts.numel() * ts.element_size()
    if isinstance(ts, (tuple, list)):
        return sum(_tensor_bytes(t) for t in ts)
    return 0


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_card(kernel: str, *ts: torch.Tensor, dtypes=SOLVER_KERNEL_DTYPES) -> bool:
    """Validate ``ts`` (each of one of ``dtypes``); True for CUDA tensors
    (launch), False for CPU ones."""
    t0 = ts[0]
    for t in ts:
        if t.dtype not in dtypes:
            raise TypeError(f"{kernel}: dtype {t.dtype} not supported "
                            f"({' or '.join(str(d) for d in dtypes)})")
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
    if OBSERVER is not None:
        global _operand_bytes
        _operand_bytes = _tensor_bytes(ts)
    return True


def _launched(kernel: str, out, xp: torch.Tensor | None = None):
    """Count one launch of ``kernel``, of its lane-batched form when its
    operand ``xp`` is a batch (4-D), and report it to ``OBSERVER``."""
    name = kernel + ("_batched" if xp is not None and xp.dim() == 4 else "")
    LAUNCHES[name] += 1
    if OBSERVER is not None:
        OBSERVER(name, _operand_bytes + _tensor_bytes(out))
    return out


def _check_padded(kernel: str, xp: torch.Tensor, stencil: Stencil,
                  zero_halo: bool = False, lanes: bool = False) -> None:
    """``xp`` is a stencil operand: halo-padded, or unpadded with
    ``zero_halo`` (the kernel makes the zero halo); with ``lanes`` also a
    batch of them, (B, ...) with B >= 1."""
    dims = (3, 4) if lanes else (3,)
    if xp.dim() not in dims or min(xp.shape) < 1 \
            or min(xp.shape[-3:]) < (1 if zero_halo else 3):
        form = "an unpadded (nx, ny, nz)" if zero_halo else "a halo-padded (nx+2, ny+2, nz+2)"
        batch = " or a batch (B, ...) of them" if lanes else ""
        raise ValueError(f"{kernel}: need {form} array{batch} with nx, ny, nz >= 1, "
                         f"got {tuple(xp.shape)}")
    if xp.device.type == "cuda" and stencil.offsets not in _KERNEL_OFFSETS:
        raise ValueError(f"{kernel}: the CUDA kernel takes the 7pt and 27pt "
                         f"offset orders only, got stencil {stencil.name!r}")


def _check_interior(kernel: str, xp: torch.Tensor, *ts: torch.Tensor) -> None:
    """Each unpadded operand in ``ts`` has the shape of ``xp``'s interior
    (with ``xp``'s lanes, if any)."""
    want = tuple(xp.shape[:-3]) + tuple(n - 2 for n in xp.shape[-3:])
    for t in ts:
        if tuple(t.shape) != want:
            raise ValueError(f"{kernel}: unpadded operand of shape "
                             f"{tuple(t.shape)} for a padded operand of shape "
                             f"{tuple(xp.shape)} (want {want})")


def _check_same_shape(kernel: str, names: str, *vs: torch.Tensor) -> None:
    if any(v.shape != vs[0].shape for v in vs):
        raise ValueError(f"{kernel}: {names} must share one shape")


def _check_choice(kernel: str, name: str, value, choices: tuple) -> None:
    """``value`` is one of the launch geometries ``choices`` the kernel has an
    instance for."""
    if isinstance(value, bool) or not isinstance(value, int) or value not in choices:
        raise ValueError(f"{kernel}: {name} must be one of {choices}, got {value!r}")


def _scalars(kernel: str, ref: torch.Tensor, *cs) -> tuple:
    """0-d tensors of ``ref``'s dtype on its device for the scalar arguments
    (numbers or tensors of one element), rounded to that dtype."""
    out = tuple(torch.as_tensor(c, dtype=ref.dtype, device=ref.device) for c in cs)
    if any(c.numel() != 1 for c in out):
        raise ValueError(f"{kernel}: each scalar argument must have one element")
    return out


def spmv(xp: torch.Tensor, stencil: Stencil, *, zero_halo: bool = False,
         run: int = DEFAULT_RUN) -> torch.Tensor:
    """``A·x`` from the halo-padded ``xp`` or, with ``zero_halo``, from ``x``
    unpadded (the kernel makes the zero halo; no pad pass), in runs of
    ``run`` x-planes; a 4-D operand is a batch of lanes, each applied on its
    own in one launch (runs of ``DEFAULT_RUN`` only)."""
    _check_padded("stencil_spmv", xp, stencil, zero_halo, lanes=True)
    _check_choice("stencil_spmv", "run", run,
                  RUN_CANDIDATES if xp.dim() == 3 else (DEFAULT_RUN,))
    if _on_card("stencil_spmv", xp):
        from repro_torch.kernels.stencil_spmv import stencil_spmv
        return _launched("stencil_spmv", stencil_spmv(
            xp, stencil=stencil, zero_halo=zero_halo, run=run), xp)
    return ref.stencil_spmv_ref(pad1(xp) if zero_halo else xp, stencil=stencil)


def spmv_dot(xp: torch.Tensor, stencil: Stencil, *, zero_halo: bool = False,
             run: int = DEFAULT_RUN):
    """``(A·x, (A·x)·x)`` in one pass (the ``fuse_dot`` form of the SpMV), from
    ``xp`` padded or, with ``zero_halo``, unpadded, in runs of ``run``
    x-planes."""
    _check_padded("stencil_spmv", xp, stencil, zero_halo)
    _check_choice("stencil_spmv", "run", run, RUN_CANDIDATES)
    if _on_card("stencil_spmv", xp):
        from repro_torch.kernels.stencil_spmv import stencil_spmv
        return _launched("stencil_spmv", stencil_spmv(
            xp, stencil=stencil, fuse_dot=True, zero_halo=zero_halo, run=run))
    return ref.stencil_spmv_dot_ref(pad1(xp) if zero_halo else xp, stencil=stencil)


def spmv_dots(xp: torch.Tensor, stencil: Stencil, *, zero_halo: bool = False,
              run: int = DEFAULT_RUN):
    """``(A·x, (A·x)·x, x·x)`` in one pass (merged CG's reduction pair) from
    the halo-padded ``xp`` or, with ``zero_halo``, from ``x`` unpadded (the
    kernel makes the zero halo; no pad pass), in runs of ``run`` x-planes."""
    _check_padded("stencil_spmv_dots", xp, stencil, zero_halo)
    _check_choice("stencil_spmv_dots", "run", run, RUN_CANDIDATES)
    if _on_card("stencil_spmv_dots", xp):
        from repro_torch.kernels.spmv_dot import stencil_spmv_dots
        return _launched("stencil_spmv_dots", stencil_spmv_dots(
            xp, stencil=stencil, zero_halo=zero_halo, run=run))
    return ref.stencil_spmv_dots_ref(pad1(xp) if zero_halo else xp, stencil=stencil)


def cg_body(alpha, beta, x, r, p, s, w):
    """Merged-CG's four vector updates in one pass -> ``(x', r', p', s')``.

    ``alpha``/``beta`` are 0-d tensors (or numbers), rounded to the vectors' dtype."""
    _check_same_shape("fused_cg_body", "x, r, p, s, w", x, r, p, s, w)
    on_card = _on_card("fused_cg_body", x, r, p, s, w)
    a, b = _scalars("fused_cg_body", x, alpha, beta)
    if not on_card:
        return ref.fused_cg_body_ref(a, b, x, r, p, s, w)
    from repro_torch.kernels.cg_fused_update import fused_cg_body
    return _launched("fused_cg_body", fused_cg_body(a, b, x, r, p, s, w))


def spmv_dots3(xp: torch.Tensor, r: torch.Tensor, stencil: Stencil, *,
               zero_halo: bool = False, run: int = DEFAULT_RUN):
    """``(A·x, (A·x)·x, r·x, r·r)`` in one pass (merged PCG's reduction
    triple with ``x = u``) from the halo-padded ``xp`` or, with
    ``zero_halo``, from ``x`` unpadded (the kernel makes the zero halo; no
    pad pass), in runs of ``run`` x-planes; ``r`` is unpadded."""
    kernel = "stencil_spmv_dots3"
    _check_padded(kernel, xp, stencil, zero_halo)
    _check_choice(kernel, "run", run, RUN_CANDIDATES)
    if zero_halo:
        _check_same_shape(kernel, "x, r", xp, r)
    else:
        _check_interior(kernel, xp, r)
    if _on_card(kernel, xp, r):
        from repro_torch.kernels.spmv_dot import stencil_spmv_dots3
        return _launched(kernel, stencil_spmv_dots3(xp, r, stencil=stencil,
                                                    zero_halo=zero_halo, run=run))
    return ref.stencil_spmv_dots3_ref(pad1(xp) if zero_halo else xp, r, stencil=stencil)


def pcg_body(alpha, beta, x, r, u, p, s, w):
    """Merged PCG's four vector updates in one pass -> ``(x', r', p', s')``.

    ``alpha``/``beta`` are 0-d tensors (or numbers), rounded to the vectors' dtype."""
    _check_same_shape("fused_pcg_body", "x, r, u, p, s, w", x, r, u, p, s, w)
    on_card = _on_card("fused_pcg_body", x, r, u, p, s, w)
    a, b = _scalars("fused_pcg_body", x, alpha, beta)
    if not on_card:
        return ref.fused_pcg_body_ref(a, b, x, r, u, p, s, w)
    from repro_torch.kernels.fused_bodies import fused_pcg_body
    return _launched("fused_pcg_body", fused_pcg_body(a, b, x, r, u, p, s, w))


def pipe_body(alpha, beta, x, r, w, p, s, z, n):
    """Pipelined CG's six recurrences in one pass -> ``(x', r', w', p', s', z')``.

    ``alpha``/``beta`` are 0-d tensors (or numbers), rounded to the vectors' dtype."""
    vecs = (x, r, w, p, s, z, n)
    _check_same_shape("fused_pipe_body", "x, r, w, p, s, z, n", *vecs)
    on_card = _on_card("fused_pipe_body", *vecs)
    a, b = _scalars("fused_pipe_body", x, alpha, beta)
    if not on_card:
        return ref.fused_pipe_body_ref(a, b, *vecs)
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

    ``alpha``/``beta`` are 0-d tensors (or numbers), rounded to the vectors' dtype."""
    vecs = (x, r, u, w, p, s, q, z, m, n)
    _check_same_shape("fused_ppipe_body", "x, r, u, w, p, s, q, z, m, n", *vecs)
    on_card = _on_card("fused_ppipe_body", *vecs)
    a, b = _scalars("fused_ppipe_body", x, alpha, beta)
    if not on_card:
        return ref.fused_ppipe_body_ref(a, b, *vecs)
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
    on_card = _on_card(kernel, zp, *vecs)
    (a,) = _scalars(kernel, z, alpha)
    if not on_card:
        return ref.bicgstab_spmv_dots_ref(zp, *vecs, a, stencil=stencil)
    from repro_torch.kernels.bicgstab_fused import bicgstab_fused_spmv_dots
    return _launched(kernel, bicgstab_fused_spmv_dots(zp, *vecs, a, stencil=stencil))


def bicgstab_update1(alpha, omega, y, p, q, yv, t, v):
    """Single-reduction BiCGStab's ω-half in one pass -> ``(y', r', w')``
    with ``y' = y + α·p + ω·q``, ``r' = q − ω·yv``, ``w' = yv − ω·(t − α·v)``;
    ``alpha``/``omega`` are 0-d tensors (or numbers), rounded to the vectors' dtype."""
    kernel = "bicgstab_fused_update1"
    vecs = (y, p, q, yv, t, v)
    _check_same_shape(kernel, "y, p, q, yv, t, v", *vecs)
    on_card = _on_card(kernel, *vecs)
    a, o = _scalars(kernel, y, alpha, omega)
    if not on_card:
        return ref.bicgstab_update1_ref(a, o, *vecs)
    from repro_torch.kernels.fused_bodies import bicgstab_fused_update1
    return _launched(kernel, bicgstab_fused_update1(a, o, *vecs))


def bicgstab_spmv_update(wp: torch.Tensor, w, r, p, s, z, v, omega, beta,
                         stencil: Stencil):
    """Single-reduction BiCGStab's last pass from the halo-padded ``wp``
    (``M(w)`` when preconditioned) -> ``(t', p', s', z')``: ``t' = A·w̃`` and
    ``p' = r + β·(p − ω·s)``, ``s' = w + β·(s − ω·z)``, ``z' = t' + β·(z − ω·v)``;
    ``omega``/``beta`` are 0-d tensors (or numbers), rounded to the vectors' dtype."""
    kernel = "bicgstab_fused_spmv_update"
    vecs = (w, r, p, s, z, v)
    _check_padded(kernel, wp, stencil)
    _check_interior(kernel, wp, *vecs)
    on_card = _on_card(kernel, wp, *vecs)
    o, b = _scalars(kernel, w, omega, beta)
    if not on_card:
        return ref.bicgstab_spmv_update_ref(wp, *vecs, o, b, stencil=stencil)
    from repro_torch.kernels.bicgstab_fused import bicgstab_fused_spmv_update
    return _launched(kernel, bicgstab_fused_spmv_update(wp, *vecs, o, b, stencil=stencil))


def cheb_step(zp: torch.Tensor, r: torch.Tensor, d: torch.Tensor,
              stencil: Stencil, *, a: float, c: float, zero_halo: bool = False):
    """One Chebyshev step from the halo-padded ``zp`` or, with ``zero_halo``,
    from ``z`` unpadded (the kernel makes the zero halo; no pad pass where
    the launch takes the ring) -> ``(z', d')`` with ``d' = a·d + c·(r − A z)``
    and ``z' = z + d'``; 4-D operands are a batch of lanes, each stepped on
    its own in one launch."""
    kernel = "cheb_fused_step"
    _check_padded(kernel, zp, stencil, zero_halo, lanes=True)
    if zero_halo:
        _check_same_shape(kernel, "z, r, d", zp, r, d)
    else:
        _check_interior(kernel, zp, r, d)
    on_card = _on_card(kernel, zp, r, d)
    a, c = ref.scalars_like(zp, a, c)
    if on_card:
        from repro_torch.kernels.precond import cheb_fused_step
        return _launched(kernel, cheb_fused_step(zp, r, d, stencil=stencil, a=a, c=c,
                                                 zero_halo=zero_halo), zp)
    return ref.cheb_fused_step_ref(pad1(zp) if zero_halo else zp, r, d, stencil=stencil,
                                   a=a, c=c)


def jacobi_sweep(zp: torch.Tensor, r: torch.Tensor, stencil: Stencil, *,
                 omega: float = 1.0, zero_halo: bool = False) -> torch.Tensor:
    """One damped Jacobi sweep ``z + ω·(r − A z)/diag`` from the zero-padded
    ``zp`` or, with ``zero_halo``, from ``z`` unpadded (the kernel makes the
    zero halo; no pad pass where the launch takes the ring); 4-D operands
    are a batch of lanes, each swept on its own in one launch."""
    kernel = "block_jacobi_sweep"
    _check_padded(kernel, zp, stencil, zero_halo, lanes=True)
    if zero_halo:
        _check_same_shape(kernel, "z, r", zp, r)
    else:
        _check_interior(kernel, zp, r)
    on_card = _on_card(kernel, zp, r)
    (omega,) = ref.scalars_like(zp, omega)
    if on_card:
        from repro_torch.kernels.precond import block_jacobi_sweep
        return _launched(kernel, block_jacobi_sweep(zp, r, stencil=stencil, omega=omega,
                                                    zero_halo=zero_halo), zp)
    return ref.block_jacobi_sweep_ref(pad1(zp) if zero_halo else zp, r, stencil=stencil,
                                      omega=omega)


def axpbypcz(a, x, b, y, c, z) -> torch.Tensor:
    """The paper's ad hoc update ``a·x + b·y + c·z`` for operands of any one
    shape; ``a``/``b``/``c`` are 0-d tensors (or numbers), rounded to the
    vectors' dtype."""
    _check_same_shape("fused_axpby", "x, y, z", x, y, z)
    on_card = _on_card("fused_axpby", x, y, z)
    a, b, c = _scalars("fused_axpby", x, a, b, c)
    if not on_card:
        return ref.fused_axpby_ref(a, x, b, y, c, z)
    from repro_torch.kernels.fused_axpby import fused_axpby
    return _launched("fused_axpby", fused_axpby(a, x, b, y, c, z))


def axpbypcz_dot(a, x, b, y, c, z, w):
    """``(out, Σ out·w)`` with ``out = a·x + b·y + c·z`` in one pass (as
    :func:`axpbypcz`)."""
    _check_same_shape("fused_axpby_dot", "x, y, z, w", x, y, z, w)
    on_card = _on_card("fused_axpby_dot", x, y, z, w)
    a, b, c = _scalars("fused_axpby_dot", x, a, b, c)
    if not on_card:
        return ref.fused_axpby_dot_ref(a, x, b, y, c, z, w)
    from repro_torch.kernels.fused_axpby import fused_axpby_dot
    return _launched("fused_axpby_dot", fused_axpby_dot(a, x, b, y, c, z, w))


def cg_update(beta, r, ar, p, ap):
    """CG-NB's Alg. 1 lines 6–8 in one pass -> ``(p', Ap', Σ Ap'·p')`` with
    ``p' = r + β·p`` and ``Ap' = Ar + β·Ap``; ``beta`` is a 0-d tensor (or a
    number), rounded to the vectors' dtype."""
    _check_same_shape("cg_fused_update", "r, ar, p, ap", r, ar, p, ap)
    on_card = _on_card("cg_fused_update", r, ar, p, ap)
    (b,) = _scalars("cg_fused_update", r, beta)
    if not on_card:
        return ref.cg_fused_update_ref(b, r, ar, p, ap)
    from repro_torch.kernels.cg_fused_update import cg_fused_update
    return _launched("cg_fused_update", cg_fused_update(b, r, ar, p, ap))


def gs_half_sweep(xp: torch.Tensor, b: torch.Tensor, stencil: Stencil,
                  colour: int) -> torch.Tensor:
    """One red-black Gauss-Seidel half-sweep from the halo-padded old iterate
    ``xp``: the points with ``(i + j + k) % 2 == colour`` get
    ``(b − (A − D) x)/diag``, the others keep their value."""
    if colour not in (0, 1):
        raise ValueError(f"rb_gs_half_sweep: colour must be 0 or 1, got {colour!r}")
    _check_padded("rb_gs_half_sweep", xp, stencil)
    _check_interior("rb_gs_half_sweep", xp, b)
    if _on_card("rb_gs_half_sweep", xp, b):
        from repro_torch.kernels.rb_gs import rb_gs_half_sweep
        return _launched("rb_gs_half_sweep",
                         rb_gs_half_sweep(xp, b, stencil=stencil, colour=colour))
    return ref.rb_gs_half_sweep_ref(xp, b, stencil=stencil, colour=colour)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    bq: int = 256, bkv: int = 256, window: int = 0) -> torch.Tensor:
    """Causal softmax attention with an optional sliding window (key j kept
    for query i when ``j <= i`` and, if ``window``, ``j > i - window``);
    ``q``/``k``/``v`` are (B, S, H, hd) with KV already repeated to H, in
    float32 or bfloat16.  ``bq``/``bkv`` are the reference's tile sizes,
    accepted for parity: they change no result, and on the card the kernel's
    tiles are its own."""
    kernel = "flash_attention"
    if q.dim() != 4 or min(q.shape) < 1:
        raise ValueError(f"{kernel}: need q of shape (B, S, H, hd), each >= 1, "
                         f"got {tuple(q.shape)}")
    _check_same_shape(kernel, "q, k, v", q, k, v)
    for name, val, least in (("bq", bq, 1), ("bkv", bkv, 1), ("window", window, 0)):
        if isinstance(val, bool) or not isinstance(val, int) or val < least:
            raise ValueError(f"{kernel}: {name} must be an int >= {least}, got {val!r}")
    if not _on_card(kernel, q, k, v, dtypes=ATTENTION_DTYPES):
        return ref.flash_attention_ref(q, k, v, window=window)
    from repro_torch.kernels.flash_attention import flash_attention as launch
    return _launched(kernel, launch(q, k, v, window=window))


def make_matvec_padded(stencil: Stencil):
    """A ``matvec_padded`` hook (for ``LocalOp``) backed by the SpMV kernel."""

    def mv(xp: torch.Tensor) -> torch.Tensor:
        return spmv(xp, stencil)

    return mv
