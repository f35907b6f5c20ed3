"""Single-source method definitions: each iterative method defined ONCE.

Counterpart of ``repro/core/methods.py`` (whose docstring gives the design
and the paper's barrier structure of every method).  A :class:`MethodDef` is
``init(ops, x0) -> state``, ``step(ops, state) -> state`` and an optional
``finalize(ops, x0, state) -> x``; ``state`` is a flat tuple of the declared
``vectors`` then the declared ``scalars``; ``res_scalar`` names the slot with
the squared-residual estimate that the driver's convergence check, residual
history and ``res_norm`` read.

The JAX ``lax.while_loop`` becomes the Python loop of :func:`run_method`.
Scalars stay 0-d tensors on the device; the loop reads the convergence test
to the host once per iteration, and the reference tests convergence every
iteration too, so both stop on the same iteration.

Ported here: cg, cg_nb, cg_merged (with its fused body), bicgstab,
bicgstab_b1, jacobi, gauss_seidel_rb and gauss_seidel.  The preconditioned,
pipelined and merged-BiCGStab methods, the resilient driver (guards,
residual replacement) and telemetry are ROADMAP queue 1 items 6-8.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

#: typed loop-exit statuses (``SolveResult.status``); the reference's codes
STATUS_CONVERGED = 0    # res_scalar dropped below (tol * norm_ref)^2
STATUS_MAXITER = 1      # iteration budget exhausted, residual still finite
STATUS_BREAKDOWN = 2    # NaN residual scalar
STATUS_DIVERGED = 3     # infinite residual scalar
STATUS_STAGNATED = 4    # set only by the resilient driver (not ported)

STATUS_NAMES = ("converged", "maxiter", "breakdown", "diverged", "stagnated")


def status_name(code) -> str:
    """Human name for a ``SolveResult.status`` code."""
    return STATUS_NAMES[int(code)]


class SolveResult(NamedTuple):
    x: torch.Tensor
    iters: int                # number of completed iterations
    res_norm: torch.Tensor    # final ||r||_2 (method's own residual estimate)
    history: torch.Tensor     # (maxiter+1,) residual-norm history, NaN-padded
    telemetry: torch.Tensor | None = None   # always None (telemetry not ported)
    status: int | None = None               # one of the STATUS_* codes


def _default_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _stacked_dot(A, dot):
    """``dotn(*pairs) -> tuple``: the operator's own stacked reduction when
    the caller passes no foreign ``dot``, else per-pair calls of ``dot``."""
    if dot is None or getattr(dot, "__self__", None) is A:
        dn = getattr(A, "dotn", None)
        if dn is not None:
            return dn
    d = dot or _default_dot

    def dotn(*pairs):
        return tuple(d(a, b) for a, b in pairs)

    return dotn


class Ops:
    """The execution context a :class:`MethodDef` runs against.

    ``dot`` defaults to the operator's own reduction when it has one, else
    :func:`_default_dot`; ``dotn`` stacks dot products (see
    :func:`_stacked_dot`).  ``norm_ref=None`` resolves to ``||b||``; the
    paper's absolute HPCCG criterion is ``norm_ref=1.0``.
    """

    __slots__ = ("A", "b", "dot", "dotn", "norm_ref", "params")

    def __init__(self, A, b, *, dot=None, norm_ref=None,
                 params: dict | None = None):
        self.A = A
        self.b = b
        own = getattr(A, "dot", None)
        self.dot = dot if dot is not None else (own or _default_dot)
        self.dotn = _stacked_dot(A, dot)
        self.params = params or {}
        if norm_ref is None:
            norm_ref = torch.sqrt(self.dot(b, b))
        self.norm_ref = norm_ref

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.A.matvec(x)

    def dot2(self, a, b, c, d) -> tuple:
        """Two dot products in one stacked reduction."""
        return self.dotn((a, b), (c, d))

    @property
    def diag(self):
        return self.A.diag


@dataclasses.dataclass(frozen=True)
class MethodDef:
    """One iterative method, defined once (see the reference's docstring).

    ``fused_init``/``fused_step`` (present iff ``fused_kernels`` is
    non-empty) are the same iteration written against the fused-kernel hooks
    of ``kernels.kernel_op.KernelOp``.  ``guard`` and ``refresh`` are
    declared as in the reference and checked here; the resilient driver that
    calls them is not ported yet (ROADMAP queue 1 item 8).
    """

    name: str
    vectors: tuple[str, ...]
    scalars: tuple[str, ...]
    res_scalar: str
    init: Callable
    step: Callable
    finalize: Callable | None = None
    variant_of: str | None = None
    accepts_precond: bool = False
    stationary: bool = False
    reduce_hide: str = "none"
    params: tuple[str, ...] = ()
    default_maxiter: int = 500
    fused_kernels: tuple[str, ...] = ()
    fused_init: Callable | None = None
    fused_step: Callable | None = None
    guard: Callable | None = None
    refresh: Callable | None = None
    refresh_spmvs: int = 0

    def __post_init__(self):
        if self.res_scalar not in self.scalars:
            raise ValueError(
                f"{self.name!r}: res_scalar {self.res_scalar!r} not in "
                f"declared scalars {self.scalars}")
        if bool(self.fused_kernels) != (self.fused_step is not None):
            raise ValueError(
                f"{self.name!r}: fused_kernels and fused_step must be "
                f"declared together")
        if self.fused_step is not None and self.fused_init is None:
            raise ValueError(f"{self.name!r}: fused_step without fused_init")
        if (self.refresh is None) != (self.refresh_spmvs == 0):
            raise ValueError(
                f"{self.name!r}: refresh and refresh_spmvs must be declared "
                f"together")

    @property
    def res_index(self) -> int:
        """Flat state index of the ``res_scalar`` slot."""
        return len(self.vectors) + self.scalars.index(self.res_scalar)

    @property
    def has_fused_body(self) -> bool:
        return self.fused_step is not None

    @property
    def has_refresh(self) -> bool:
        return self.refresh is not None


METHODS: dict[str, MethodDef] = {}


def register_method(mdef: MethodDef) -> MethodDef:
    if mdef.name in METHODS:
        raise ValueError(f"method {mdef.name!r} already defined")
    if mdef.variant_of is not None and mdef.variant_of not in METHODS:
        raise ValueError(
            f"{mdef.name!r}: unknown baseline {mdef.variant_of!r} "
            f"(define the classical method first)")
    METHODS[mdef.name] = mdef
    return mdef


def get_method(name: str) -> MethodDef:
    """Look up a MethodDef; unknown names raise a ValueError listing the
    known methods."""
    try:
        return METHODS[name]
    except KeyError:
        raise ValueError(
            f"unknown method {name!r}; known methods: "
            f"{sorted(METHODS)}") from None


def method_names() -> list[str]:
    return sorted(METHODS)


# =============================================================================
# The generic driver: MethodDef + Ops -> a whole solve
# =============================================================================

def _status_basic(res2: torch.Tensor, thresh2) -> int:
    """Loop-exit classification from the residual scalar alone."""
    if bool(torch.isnan(res2)):
        return STATUS_BREAKDOWN
    if bool(torch.isinf(res2)):
        return STATUS_DIVERGED
    return STATUS_CONVERGED if bool(res2 < thresh2) else STATUS_MAXITER


def run_method(mdef: MethodDef, ops: Ops, x0: torch.Tensor, *,
               tol: float = 1e-6, maxiter: int | None = None,
               fused: bool = False) -> SolveResult:
    """Run ``mdef`` to convergence: a Python loop around its ``step``.

    The loop condition is the reference's ``res2 >= (tol·norm_ref)² and
    k < maxiter`` (NaN exits, as there), evaluated on the device and read to
    the host once per iteration; the history is written on the device.
    ``fused=True`` selects the fused-kernel body (``ops.A`` must then be a
    ``KernelOp``).
    """
    if maxiter is None:
        maxiter = mdef.default_maxiter
    if fused and not mdef.has_fused_body:
        raise ValueError(f"{mdef.name!r} declares no fused kernels")
    init = mdef.fused_init if fused else mdef.init
    step = mdef.fused_step if fused else mdef.step
    thresh2 = (tol * ops.norm_ref) ** 2
    ridx = mdef.res_index
    state = tuple(init(ops, x0))
    hist = torch.full((maxiter + 1,), float("nan"), dtype=ops.b.dtype,
                      device=ops.b.device)
    hist[0] = torch.sqrt(state[ridx])
    k = 0
    while k < maxiter and bool(state[ridx] >= thresh2):
        state = tuple(step(ops, state))
        hist[k + 1] = torch.sqrt(state[ridx])
        k += 1
    x = mdef.finalize(ops, x0, state) if mdef.finalize else state[0]
    return SolveResult(x=x, iters=k, res_norm=torch.sqrt(state[ridx]),
                       history=hist, status=_status_basic(state[ridx], thresh2))


# =============================================================================
# Krylov methods — conjugate gradients
# =============================================================================

def _rho_underflow_guard(rho_idx: int, rr_idx: int):
    """BiCGStab-family breakdown guard (declared for the resilient driver)."""
    def guard(ops, state, rr0, eps):
        rho, rr = state[rho_idx], state[rr_idx]
        return rho * rho < (eps * eps) * rr0 * rr
    return guard


def _nonpositive_guard(idx: int):
    """CG-family negative-curvature guard (declared for the resilient driver)."""
    def guard(ops, state, rr0, eps):
        return state[idx] <= 0.0
    return guard


def _cg_init(ops, x0):
    r = ops.b - ops.matvec(x0)
    rr = ops.dot(r, r)
    return (x0, r, r, rr)


def _cg_step(ops, state):
    """Classical CG (HPCCG reference): 2 blocking reductions."""
    x, r, p, rr = state
    Ap = ops.matvec(p)
    pAp = ops.dot(p, Ap)
    alpha = rr / pAp
    x = x + alpha * p
    r = r - alpha * Ap
    rr_new = ops.dot(r, r)
    beta = rr_new / rr
    p = r + beta * p
    return (x, r, p, rr_new)


register_method(MethodDef(
    name="cg", vectors=("x", "r", "p"), scalars=("rr",), res_scalar="rr",
    init=_cg_init, step=_cg_step))


def _cg_nb_init(ops, x0):
    r = ops.b - ops.matvec(x0)
    Ap = ops.matvec(r)                # p_0 = r_0
    an = ops.dot(r, r)
    ad = ops.dot(Ap, r)
    return (x0, r, r, Ap, an, ad)


def _cg_nb_step(ops, state):
    """Nonblocking CG (paper Alg. 1, sign-fixed line 9 as in the reference):
    the SpMV is applied to ``r``; ``A·p`` is rebuilt as a vector update."""
    x, r, p, Ap, an, ad = state
    alpha = an / ad
    r_new = r - alpha * Ap
    an_new = ops.dot(r_new, r_new)
    Ar = ops.matvec(r_new)
    beta = an_new / an
    Ap_new = Ar + beta * Ap
    p_new = r_new + beta * p
    ad_new = ops.dot(Ap_new, p_new)
    x = x + alpha * p                 # lagged update with the OLD p
    return (x, r_new, p_new, Ap_new, an_new, ad_new)


def _cg_nb_finalize(ops, x0, state):
    # the x update lags one iteration; apply the final correction term
    x, r, p, Ap, an, ad = state
    return x + (an / ad) * p


register_method(MethodDef(
    name="cg_nb", vectors=("x", "r", "p", "Ap"), scalars=("an", "ad"),
    res_scalar="an", init=_cg_nb_init, step=_cg_nb_step,
    finalize=_cg_nb_finalize, variant_of="cg",
    guard=_nonpositive_guard(5)))


def _cg_merged_scalars(gamma, delta, gamma_prev, alpha_prev):
    """β and the Saad-recurrence α of merged CG; seeding ``γ_prev = inf,
    α_prev = 1`` makes the first pass ``β = 0, α = γ/δ``."""
    beta = gamma / gamma_prev
    alpha = gamma / (delta - beta * gamma / alpha_prev)
    return alpha, beta


def _merged_seed(ref: torch.Tensor):
    inf = torch.full((), float("inf"), dtype=ref.dtype, device=ref.device)
    one = torch.ones((), dtype=ref.dtype, device=ref.device)
    return inf, one


def _cg_merged_init(ops, x0):
    r = ops.b - ops.matvec(x0)
    w = ops.matvec(r)
    gamma, delta = ops.dotn((r, r), (w, r))
    zero = torch.zeros_like(ops.b)
    inf, one = _merged_seed(gamma)
    return (x0, r, zero, zero, w, gamma, delta, inf, one)


def _cg_merged_step(ops, state):
    """Merged-reduction CG (Chronopoulos–Gear): ONE stacked reduction of
    ``γ = r·r`` and ``δ = w·r`` per iteration; ``s = A p`` by recurrence."""
    x, r, p, s, w, gamma, delta, gamma_prev, alpha_prev = state
    alpha, beta = _cg_merged_scalars(gamma, delta, gamma_prev, alpha_prev)
    p = r + beta * p
    s = w + beta * s
    x = x + alpha * p
    r = r - alpha * s
    w = ops.matvec(r)
    gamma_new, delta_new = ops.dotn((r, r), (w, r))
    return (x, r, p, s, w, gamma_new, delta_new, gamma, alpha)


def _cg_merged_fused_init(ops, x0):
    # the initial residual uses the wrapped operator's matvec; the fused
    # kernels take over from the first spmv_dots pass onward
    r = ops.b - ops.A.base.matvec(x0)
    w, delta, gamma = ops.A.spmv_dots(r)
    zero = torch.zeros_like(ops.b)
    inf, one = _merged_seed(gamma)
    return (x0, r, zero, zero, w, gamma, delta, inf, one)


def _cg_merged_fused_step(ops, state):
    """The merged-CG iteration as TWO fused memory passes (``ops.A`` is a
    ``KernelOp``): the four vector updates (``fused_cg_body``), then the
    SpMV with both dot partials (``stencil_spmv_dots``).  α and β stay on
    the device and reach the kernel by pointer."""
    x, r, p, s, w, gamma, delta, gamma_prev, alpha_prev = state
    alpha, beta = _cg_merged_scalars(gamma, delta, gamma_prev, alpha_prev)
    x, r, p, s = ops.A.cg_body(alpha, beta, x, r, p, s, w)     # pass 1
    w, delta_new, gamma_new = ops.A.spmv_dots(r)               # pass 2
    return (x, r, p, s, w, gamma_new, delta_new, gamma, alpha)


def _cg_merged_refresh(ops, x0, state):
    """Residual replacement (declared for the resilient driver): recompute
    the TRUE residual and every recurrence image from the iterate."""
    x, r, p, s, w, gamma, delta, gamma_prev, alpha_prev = state
    r = ops.b - ops.matvec(x)
    s = ops.matvec(p)
    w = ops.matvec(r)
    gamma, delta = ops.dotn((r, r), (w, r))
    return (x, r, p, s, w, gamma, delta, gamma_prev, alpha_prev)


register_method(MethodDef(
    name="cg_merged", vectors=("x", "r", "p", "s", "w"),
    scalars=("gamma", "delta", "gamma_prev", "alpha_prev"),
    res_scalar="gamma", init=_cg_merged_init, step=_cg_merged_step,
    variant_of="cg", reduce_hide="merged",
    fused_kernels=("cg_body", "spmv_dots"),
    fused_init=_cg_merged_fused_init, fused_step=_cg_merged_fused_step,
    guard=_nonpositive_guard(6),
    refresh=_cg_merged_refresh, refresh_spmvs=3))


# =============================================================================
# Krylov methods — BiCGStab family
# =============================================================================

def _bicgstab_init(ops, x0):
    r = ops.b - ops.matvec(x0)
    rho = ops.dot(r, r)               # r̂ = r_0 ⇒ ρ_0 = ‖r_0‖²
    return (x0, r, r, r, rho, rho)


def _bicgstab_step(ops, state):
    """Classical BiCGStab: 3 blocking reduction points per iteration."""
    x, r, rhat, p, rho, rr = state
    v = ops.matvec(p)
    rhat_v = ops.dot(rhat, v)
    alpha = rho / rhat_v
    s = r - alpha * v
    t = ops.matvec(s)
    ts, tt = ops.dot2(t, s, t, t)
    omega = ts / tt
    x = x + alpha * p + omega * s
    r = s - omega * t
    rho_new, rr_new = ops.dot2(rhat, r, r, r)
    beta = (rho_new / rho) * (alpha / omega)
    p = r + beta * (p - omega * v)
    return (x, r, rhat, p, rho_new, rr_new)


register_method(MethodDef(
    name="bicgstab", vectors=("x", "r", "rhat", "p"),
    scalars=("rho", "rr"), res_scalar="rr",
    init=_bicgstab_init, step=_bicgstab_step,
    guard=_rho_underflow_guard(4, 5)))


def _bicgstab_b1_init(ops, x0):
    r = ops.b - ops.matvec(x0)
    beta_rr = ops.dot(r, r)
    rhat = r / torch.sqrt(beta_rr)
    an = ops.dot(r, rhat)
    return (x0, r, r, rhat, an, beta_rr)


def _bicgstab_b1_step(ops, state):
    """BiCGStab one-blocking (paper Alg. 2) with the restart procedure
    (``ε_restart`` from ``ops.params``, default 1e-5, paper §4.1).  The
    reference's ``optimization_barrier``s only pin its schedule; eager
    PyTorch runs the statements in order."""
    x, r, p, rhat, an, beta_rr = state
    restart_thresh = ops.params.get("eps_restart", 1e-5) * ops.norm_ref
    Ap = ops.matvec(p)
    ad = ops.dot(Ap, rhat)
    alpha = an / ad
    s = r - alpha * Ap
    As = ops.matvec(s)
    ts, tt = ops.dot2(As, s, As, As)
    x_half = x + alpha * p
    omega = ts / tt
    x_new = x_half + omega * s
    r_new = s - omega * As
    an_new, beta_rr_new = ops.dot2(r_new, rhat, r_new, r_new)
    p_half = p - omega * Ap
    restart = torch.sqrt(torch.abs(an_new)) < restart_thresh
    p_reg = r_new + (an_new / (ad * omega)) * p_half
    p_new = torch.where(restart, r_new, p_reg)
    rhat_new = torch.where(restart, r_new / torch.sqrt(beta_rr_new), rhat)
    an_next = torch.where(restart, torch.sqrt(beta_rr_new), an_new)
    return (x_new, r_new, p_new, rhat_new, an_next, beta_rr_new)


register_method(MethodDef(
    name="bicgstab_b1", vectors=("x", "r", "p", "rhat"),
    scalars=("an", "beta_rr"), res_scalar="beta_rr",
    init=_bicgstab_b1_init, step=_bicgstab_b1_step,
    variant_of="bicgstab", params=("eps_restart",)))


# =============================================================================
# Stationary methods
# =============================================================================

def _jacobi_init(ops, x0):
    r = ops.b - ops.matvec(x0)
    rr = ops.dot(r, r)
    return (x0, r, rr)


def _jacobi_step(ops, state):
    """Jacobi: x += D⁻¹ r; one SpMV + one reduction per iteration."""
    x, r, rr = state
    x = x + r / ops.diag
    r = ops.b - ops.matvec(x)
    rr = ops.dot(r, r)
    return (x, r, rr)


register_method(MethodDef(
    name="jacobi", vectors=("x", "r"), scalars=("rr",), res_scalar="rr",
    init=_jacobi_init, step=_jacobi_step, stationary=True,
    default_maxiter=1000))


def _plane_sweep(A, b, x, *, forward: bool) -> torch.Tensor:
    """One relaxed Gauss-Seidel sweep: GS-fresh across z-planes, Jacobi
    within a plane.  The reference's ``fori_loop`` over planes is a Python
    loop of whole-plane tensor ops writing into a fresh padded copy."""
    nz = x.shape[2]
    xp = A.pad_exchange(x)
    for i in range(nz):
        k = i if forward else nz - 1 - i
        off = A.stencil.plane_offdiag_apply(xp, k)
        xp[1:-1, 1:-1, k + 1] = (b[:, :, k] - off) / A.diag
    return xp[1:-1, 1:-1, 1:-1]


def _stationary_init(ops, x0):
    r = ops.b - ops.matvec(x0)
    rr = ops.dot(r, r)
    return (x0, rr)


def _gauss_seidel_step(ops, state):
    """Relaxed symmetric GS (paper §3.4 Code 4 adaptation): forward sweep
    (ascending z-planes) then backward sweep (descending)."""
    x, rr = state
    x = _plane_sweep(ops.A, ops.b, x, forward=True)
    x = _plane_sweep(ops.A, ops.b, x, forward=False)
    r = ops.b - ops.matvec(x)
    rr = ops.dot(r, r)
    return (x, rr)


def _colour_mask(shape: tuple[int, int, int], colour: int,
                 device: torch.device) -> torch.Tensor:
    i, j, k = (torch.arange(n, device=device) for n in shape)
    parity = i[:, None, None] + j[None, :, None] + k[None, None, :]
    return (parity % 2) == colour


def _rb_half_sweep(A, b, x, colour_mask) -> torch.Tensor:
    off = A.stencil.offdiag_apply_padded(A.pad_exchange(x))
    return torch.where(colour_mask, (b - off) / A.diag, x)


def _gauss_seidel_rb_step(ops, state):
    """Red-black coloured symmetric GS (paper §3.4): forward = red, black;
    backward = black, red."""
    x, rr = state
    red = _colour_mask(tuple(x.shape), 0, x.device)
    black = _colour_mask(tuple(x.shape), 1, x.device)
    x = _rb_half_sweep(ops.A, ops.b, x, red)
    x = _rb_half_sweep(ops.A, ops.b, x, black)
    x = _rb_half_sweep(ops.A, ops.b, x, black)
    x = _rb_half_sweep(ops.A, ops.b, x, red)
    r = ops.b - ops.matvec(x)
    rr = ops.dot(r, r)
    return (x, rr)


register_method(MethodDef(
    name="gauss_seidel_rb", vectors=("x",), scalars=("rr",),
    res_scalar="rr", init=_stationary_init, step=_gauss_seidel_rb_step,
    stationary=True, default_maxiter=1000))

register_method(MethodDef(
    name="gauss_seidel", vectors=("x",), scalars=("rr",),
    res_scalar="rr", init=_stationary_init, step=_gauss_seidel_step,
    variant_of="gauss_seidel_rb", stationary=True, default_maxiter=1000))
