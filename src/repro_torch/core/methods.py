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

Ported here: every method of the reference — cg, cg_nb, pcg, cg_merged,
pcg_merged, cg_pipe, pcg_pipe, bicgstab_merged and pbicgstab_merged (each
merged and pipelined method with its fused body), bicgstab, pbicgstab,
bicgstab_b1, jacobi, gauss_seidel_rb and gauss_seidel.  The resilient
driver (guards, residual replacement) and telemetry are ROADMAP queue 1
item 8.

The reference pins its schedule with ``lax.optimization_barrier`` in a few
bodies (bicgstab_b1, the pipelined CGs, merged BiCGStab); the barrier is a
scheduling hint with no eager counterpart, so the port runs those
statements in program order.
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


def _identity(v: torch.Tensor) -> torch.Tensor:
    return v


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

    ``M`` is the bound preconditioner apply ``z = M⁻¹ r`` (identity when
    ``None``); ``dot`` defaults to the operator's own reduction when it has one, else
    :func:`_default_dot`; ``dotn`` stacks dot products (see
    :func:`_stacked_dot`).  ``norm_ref=None`` resolves to ``||b||``; the
    paper's absolute HPCCG criterion is ``norm_ref=1.0``.
    """

    __slots__ = ("A", "b", "M", "dot", "dotn", "norm_ref", "params")

    def __init__(self, A, b, *, M=None, dot=None, norm_ref=None,
                 params: dict | None = None):
        self.A = A
        self.b = b
        self.M = M if M is not None else _identity
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


def _pcg_init(ops, x0):
    r = ops.b - ops.matvec(x0)
    z = ops.M(r)
    rz = ops.dot(r, z)
    rr = ops.dot(r, r)
    return (x0, r, z, rz, rr)


def _pcg_step(ops, state):
    """Preconditioned CG; ``M`` must be SPD-preserving.  ``p·Ap`` and ``r·z``
    block (the latter pair-fused with the check-only ``r·r``); the
    convergence check stays on the TRUE residual ``||r||``.  With ``M = I``
    this is arithmetically identical to ``cg``."""
    x, r, p, rz, rr = state
    Ap = ops.matvec(p)
    pAp = ops.dot(p, Ap)
    alpha = rz / pAp
    x = x + alpha * p
    r = r - alpha * Ap
    z = ops.M(r)
    rz_new, rr_new = ops.dot2(r, z, r, r)
    beta = rz_new / rz
    p = z + beta * p
    return (x, r, p, rz_new, rr_new)


register_method(MethodDef(
    name="pcg", vectors=("x", "r", "p"), scalars=("rz", "rr"),
    res_scalar="rr", init=_pcg_init, step=_pcg_step,
    variant_of="cg", accepts_precond=True,
    guard=_nonpositive_guard(3)))


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


def _pcg_merged_init(ops, x0):
    r = ops.b - ops.matvec(x0)
    u = ops.M(r)
    w = ops.matvec(u)
    gamma, delta, rr = ops.dotn((r, u), (w, u), (r, r))
    zero = torch.zeros_like(ops.b)
    inf, one = _merged_seed(gamma)
    return (x0, r, u, zero, zero, w, gamma, delta, rr, inf, one)


def _pcg_merged_step(ops, state):
    """Merged-reduction PCG (Chronopoulos–Gear with ``u = M⁻¹r``); the
    TRUE-residual ``r·r`` rides in the same stacked reduction (3 scalars), so
    stopping matches ``pcg``.  ``M`` must be SPD-preserving."""
    x, r, u, p, s, w, gamma, delta, rr, gamma_prev, alpha_prev = state
    alpha, beta = _cg_merged_scalars(gamma, delta, gamma_prev, alpha_prev)
    p = u + beta * p
    s = w + beta * s
    x = x + alpha * p
    r = r - alpha * s
    u = ops.M(r)
    w = ops.matvec(u)
    gamma_new, delta_new, rr_new = ops.dotn((r, u), (w, u), (r, r))
    return (x, r, u, p, s, w, gamma_new, delta_new, rr_new, gamma, alpha)


def _pcg_merged_guard(ops, state, rr0, eps):
    # gamma = r·u and delta = u·Au must both stay positive when A and M are
    # SPD (declared for the resilient driver)
    return (state[6] <= 0.0) | (state[7] <= 0.0)


def _pcg_merged_refresh(ops, x0, state):
    """Residual replacement (declared for the resilient driver): true r,
    fresh ``u = M⁻¹r`` and recurrence images, all scalars from one stacked
    reduction."""
    x, r, u, p, s, w, gamma, delta, rr, gamma_prev, alpha_prev = state
    r = ops.b - ops.matvec(x)
    u = ops.M(r)
    w = ops.matvec(u)
    s = ops.matvec(p)
    gamma, delta, rr = ops.dotn((r, u), (w, u), (r, r))
    return (x, r, u, p, s, w, gamma, delta, rr, gamma_prev, alpha_prev)


def _pcg_merged_fused_step(ops, state):
    """Merged PCG as fused memory passes (``ops.A`` is a ``KernelOp``): the
    four vector updates (``fused_pcg_body``), the preconditioner apply on its
    own kernels via ``ops.M``, then the SpMV with the whole reduction triple
    ``γ = r·u``, ``δ = w·u``, true ``r·r`` (``stencil_spmv_dots3``).  Same
    recurrence as :func:`_pcg_merged_step`."""
    x, r, u, p, s, w, gamma, delta, rr, gamma_prev, alpha_prev = state
    alpha, beta = _cg_merged_scalars(gamma, delta, gamma_prev, alpha_prev)
    x, r, p, s = ops.A.pcg_body(alpha, beta, x, r, u, p, s, w)     # pass 1
    u = ops.M(r)                                     # precond (own kernels)
    w, delta_new, gamma_new, rr_new = ops.A.spmv_dots3(u, r)       # pass 2
    return (x, r, u, p, s, w, gamma_new, delta_new, rr_new, gamma, alpha)


register_method(MethodDef(
    name="pcg_merged", vectors=("x", "r", "u", "p", "s", "w"),
    scalars=("gamma", "delta", "rr", "gamma_prev", "alpha_prev"),
    res_scalar="rr", init=_pcg_merged_init, step=_pcg_merged_step,
    variant_of="pcg", reduce_hide="merged", accepts_precond=True,
    fused_kernels=("pcg_body", "spmv_dots3"),
    fused_init=_pcg_merged_init, fused_step=_pcg_merged_fused_step,
    guard=_pcg_merged_guard,
    refresh=_pcg_merged_refresh, refresh_spmvs=3))


def _cg_pipe_init(ops, x0):
    r = ops.b - ops.matvec(x0)
    w = ops.matvec(r)
    (rr0,) = ops.dotn((r, r))
    zero = torch.zeros_like(ops.b)
    inf, one = _merged_seed(rr0)
    return (x0, r, w, zero, zero, zero, inf, one, rr0)


def _cg_pipe_step(ops, state):
    """Pipelined CG (Ghysels–Vanroose): ONE stacked reduction at the top of
    the body, and the body's SpMV (``n = A w``, on carried state) does not
    depend on it.  The reference pins the SpMV with an
    ``optimization_barrier`` so the psum can hide behind it; eager PyTorch
    has no such barrier and runs the statements in order (on one device
    there is no collective to hide).  The residual norm the check reads is
    the previous body's, so the method typically reports one more iteration
    than ``cg``; two extra recurrences (``s = A p``, ``z = A s``) pay for
    the hiding."""
    x, r, w, p, s, z, gamma_prev, alpha_prev, rr = state
    gamma, delta = ops.dotn((r, r), (w, r))
    n = ops.matvec(w)
    alpha, beta = _cg_merged_scalars(gamma, delta, gamma_prev, alpha_prev)
    z = n + beta * z                  # z = A s by recurrence
    s = w + beta * s                  # s = A p by recurrence
    p = r + beta * p
    x = x + alpha * p
    r = r - alpha * s
    w = w - alpha * z                 # w = A r by recurrence
    return (x, r, w, p, s, z, gamma, alpha, gamma)


def _cg_pipe_refresh(ops, x0, state):
    """Residual replacement (declared for the resilient driver): the three
    recurrence chains (``w = A r``, ``s = A p``, ``z = A s``) restart from
    the true residual, and the lagged ``rr`` is recomputed."""
    x, r, w, p, s, z, gamma_prev, alpha_prev, rr = state
    r = ops.b - ops.matvec(x)
    w = ops.matvec(r)
    s = ops.matvec(p)
    z = ops.matvec(s)
    (rr,) = ops.dotn((r, r))
    return (x, r, w, p, s, z, gamma_prev, alpha_prev, rr)


def _cg_pipe_fused_step(ops, state):
    """Pipelined CG as TWO fused memory passes (``ops.A`` is a
    ``KernelOp``): the body's SpMV ``n = A w`` with both reduction partials
    (``spmv_dots3`` with ``x = w``; its first partial ``(A w)·w`` is
    unused), then all six vector recurrences (``pipe_body``).  Same
    recurrence as :func:`_cg_pipe_step`."""
    x, r, w, p, s, z, gamma_prev, alpha_prev, rr = state
    n, _nw, delta, gamma = ops.A.spmv_dots3(w, r)                # pass 1
    alpha, beta = _cg_merged_scalars(gamma, delta, gamma_prev, alpha_prev)
    x, r, w, p, s, z = ops.A.pipe_body(
        alpha, beta, x, r, w, p, s, z, n)                        # pass 2
    return (x, r, w, p, s, z, gamma, alpha, gamma)


register_method(MethodDef(
    name="cg_pipe", vectors=("x", "r", "w", "p", "s", "z"),
    scalars=("gamma_prev", "alpha_prev", "rr"), res_scalar="rr",
    init=_cg_pipe_init, step=_cg_pipe_step,
    variant_of="cg", reduce_hide="pipelined",
    fused_kernels=("spmv_dots3", "pipe_body"),
    fused_init=_cg_pipe_init, fused_step=_cg_pipe_fused_step,
    refresh=_cg_pipe_refresh, refresh_spmvs=4))


def _pcg_pipe_init(ops, x0):
    r = ops.b - ops.matvec(x0)
    u = ops.M(r)
    w = ops.matvec(u)
    (rr0,) = ops.dotn((r, r))
    zero = torch.zeros_like(ops.b)
    inf, one = _merged_seed(rr0)
    return (x0, r, u, w, zero, zero, zero, zero, inf, one, rr0)


def _pcg_pipe_step(ops, state):
    """Pipelined PCG (Ghysels–Vanroose Alg. 3): the stacked reduction
    (``γ = r·u``, ``δ = w·u``, TRUE ``r·r``) does not feed the
    preconditioner apply ``m = M⁻¹w`` or the SpMV ``n = A m``, which the
    reference pins behind it with an ``optimization_barrier``; eager
    PyTorch runs them in order.  Four extra recurrences (``s, q, z, u``);
    stopping lags one iteration like the unpreconditioned pipeline."""
    x, r, u, w, p, s, q, z, gamma_prev, alpha_prev, rr = state
    gamma, delta, rr_new = ops.dotn((r, u), (w, u), (r, r))
    m = ops.M(w)
    n = ops.matvec(m)
    alpha, beta = _cg_merged_scalars(gamma, delta, gamma_prev, alpha_prev)
    z = n + beta * z                  # z = A q by recurrence
    q = m + beta * q                  # q = M⁻¹ s by recurrence
    s = w + beta * s                  # s = A p by recurrence
    p = u + beta * p
    x = x + alpha * p
    r = r - alpha * s
    u = u - alpha * q                 # u = M⁻¹ r by recurrence
    w = w - alpha * z                 # w = A u by recurrence
    return (x, r, u, w, p, s, q, z, gamma, alpha, rr_new)


def _pcg_pipe_refresh(ops, x0, state):
    """Residual replacement (declared for the resilient driver): true r,
    fresh preconditioned images ``u = M⁻¹r``/``q = M⁻¹s`` and the SpMV
    images rebuilt from them."""
    x, r, u, w, p, s, q, z, gamma_prev, alpha_prev, rr = state
    r = ops.b - ops.matvec(x)
    u = ops.M(r)
    w = ops.matvec(u)
    s = ops.matvec(p)
    q = ops.M(s)
    z = ops.matvec(q)
    (rr,) = ops.dotn((r, r))
    return (x, r, u, w, p, s, q, z, gamma_prev, alpha_prev, rr)


def _pcg_pipe_fused_step(ops, state):
    """Pipelined PCG as fused memory passes (``ops.A`` is a ``KernelOp``):
    the reduction triple on carried state in one read pass
    (``fused_dots``), the preconditioner apply and the SpMV on their own
    kernels, then all eight vector recurrences in one pass
    (``ppipe_body``).  Same recurrence as :func:`_pcg_pipe_step`."""
    x, r, u, w, p, s, q, z, gamma_prev, alpha_prev, rr = state
    gamma, delta, rr_new = ops.A.fused_dots(r, u, w)             # pass 1
    m = ops.M(w)                                     # precond (own kernels)
    n = ops.A.matvec(m)                                          # SpMV
    alpha, beta = _cg_merged_scalars(gamma, delta, gamma_prev, alpha_prev)
    x, r, u, w, p, s, q, z = ops.A.ppipe_body(
        alpha, beta, x, r, u, w, p, s, q, z, m, n)               # pass 2
    return (x, r, u, w, p, s, q, z, gamma, alpha, rr_new)


register_method(MethodDef(
    name="pcg_pipe", vectors=("x", "r", "u", "w", "p", "s", "q", "z"),
    scalars=("gamma_prev", "alpha_prev", "rr"), res_scalar="rr",
    init=_pcg_pipe_init, step=_pcg_pipe_step,
    variant_of="pcg", reduce_hide="pipelined", accepts_precond=True,
    fused_kernels=("fused_dots", "ppipe_body"),
    fused_init=_pcg_pipe_init, fused_step=_pcg_pipe_fused_step,
    refresh=_pcg_pipe_refresh, refresh_spmvs=4))


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


def _pbicgstab_step(ops, state):
    """Right-preconditioned BiCGStab (``A M⁻¹ y = b``, ``x = M⁻¹ y``): ``r``
    stays the TRUE residual, so stopping is comparable with ``bicgstab``;
    ``M`` need not be SPD-preserving.  3 blocking reduction points, as
    ``bicgstab``."""
    x, r, rhat, p, rho, rr = state
    phat = ops.M(p)
    v = ops.matvec(phat)
    rhat_v = ops.dot(rhat, v)
    alpha = rho / rhat_v
    s = r - alpha * v
    shat = ops.M(s)
    t = ops.matvec(shat)
    ts, tt = ops.dot2(t, s, t, t)
    omega = ts / tt
    x = x + alpha * phat + omega * shat
    r = s - omega * t
    rho_new, rr_new = ops.dot2(rhat, r, r, r)
    beta = (rho_new / rho) * (alpha / omega)
    p = r + beta * (p - omega * v)
    return (x, r, rhat, p, rho_new, rr_new)


register_method(MethodDef(
    name="pbicgstab", vectors=("x", "r", "rhat", "p"),
    scalars=("rho", "rr"), res_scalar="rr",
    init=_bicgstab_init, step=_pbicgstab_step,
    variant_of="bicgstab", accepts_precond=True,
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


def _merged_bicgstab_matvec(ops, preconditioned: bool):
    if not preconditioned:
        return ops.matvec
    return lambda v: ops.matvec(ops.M(v))


def _clamp_nonneg(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0)`` that keeps NaN, as ``jnp.maximum(x, 0.0)`` does (a NaN
    residual must still end the loop as a breakdown)."""
    return torch.clamp(x, min=0.0)


def _make_bicgstab_merged_init(preconditioned: bool):
    def init(ops, x0):
        mv = _merged_bicgstab_matvec(ops, preconditioned)
        r0 = ops.b - ops.matvec(x0)
        y0 = torch.zeros_like(ops.b) if preconditioned else x0
        w = mv(r0)
        t = mv(w)
        rho, rhw = ops.dotn((r0, r0), (r0, w))   # r̂ = r0
        alpha = rho / rhw
        rr = rho                           # r̂ = r0 ⇒ (r̂,r0) = ‖r0‖²
        return (y0, r0, w, t, r0, w, t, r0, rho, alpha, rr)
    return init


def _make_bicgstab_merged_step(preconditioned: bool):
    def step(ops, state):
        """Single-reduction BiCGStab (cf. Cools–Vanroose): the auxiliary
        images ``w = A r``, ``t = A w``, ``s = A p``, ``z = A s`` are kept by
        recurrence, so ω's pair, ρ, the α denominator and ‖r‖² are all
        linear in nine dots of vectors available before ω — ONE stacked
        reduction per iteration, two SpMVs.  The preconditioned form runs the
        same core on ``B = A∘M⁻¹`` with a zero initial guess and recovers
        ``x = x0 + M⁻¹ y`` once at exit (``finalize``); right
        preconditioning leaves the residual unchanged, so stopping stays on
        the true residual.  ``rr`` is the recurrence estimate ``‖q − ωy‖²``
        from pre-update dots, clamped at 0."""
        mv = _merged_bicgstab_matvec(ops, preconditioned)
        y, r, w, t, p, s, z, rhat, rho, alpha, rr = state
        q = r - alpha * s                  # classical s_j
        yv = w - alpha * z                 # = A q
        v = mv(z)                          # SpMV 1
        (qy, yy, qq, rhq, rhy, rht, rhv, rhz, rhs) = ops.dotn(
            (q, yv), (yv, yv), (q, q), (rhat, q), (rhat, yv),
            (rhat, t), (rhat, v), (rhat, z), (rhat, s))
        omega = qy / yy
        y = y + alpha * p + omega * q
        r = q - omega * yv
        rr_new = _clamp_nonneg(qq - 2.0 * omega * qy + omega * omega * yy)
        rho_new = rhq - omega * rhy
        beta = (rho_new / rho) * (alpha / omega)
        w = yv - omega * (t - alpha * v)   # = A r_new
        t = mv(w)                          # SpMV 2
        rhw = rhy - omega * (rht - alpha * rhv)      # (r̂, w_new)
        alpha_new = rho_new / (rhw + beta * (rhs - omega * rhz))
        p = r + beta * (p - omega * s)
        s = w + beta * (s - omega * z)     # = A p_new
        z = t + beta * (z - omega * v)     # = A s_new
        return (y, r, w, t, p, s, z, rhat, rho_new, alpha_new, rr_new)
    return step


def _make_bicgstab_merged_fused_step(preconditioned: bool):
    def fused_step(ops, state):
        """Single-reduction BiCGStab as THREE fused memory passes (``ops.A``
        is a ``KernelOp``): SpMV 1 ``v = A z̃`` with ``q``, ``y`` and all nine
        dot partials (``bicgstab_fused_spmv_dots``), the ω-half y/r/w updates
        (``bicgstab_fused_update1``), then SpMV 2 with the three direction
        recurrences (``bicgstab_fused_spmv_update``).  α, ω and β stay on the
        device and reach the kernels by pointer.  The preconditioned form
        applies ``M`` (on its own kernels) to each SpMV operand.  Same
        recurrence as the unfused step."""
        y, r, w, t, p, s, z, rhat, rho, alpha, rr = state
        zi = ops.M(z) if preconditioned else z
        v, q, yv, parts = ops.A.bicgstab_spmv_dots(
            zi, z, r, w, s, rhat, t, alpha)                      # pass 1
        qy, yy, qq, rhq, rhy, rht, rhv, rhz, rhs = parts
        omega = qy / yy
        rr_new = _clamp_nonneg(qq - 2.0 * omega * qy + omega * omega * yy)
        rho_new = rhq - omega * rhy
        beta = (rho_new / rho) * (alpha / omega)
        y, r, w = ops.A.bicgstab_update1(
            alpha, omega, y, p, q, yv, t, v)                     # pass 2
        wi = ops.M(w) if preconditioned else w
        t, p, s, z = ops.A.bicgstab_spmv_update(
            wi, w, r, p, s, z, v, omega, beta)                   # pass 3
        rhw = rhy - omega * (rht - alpha * rhv)
        alpha_new = rho_new / (rhw + beta * (rhs - omega * rhz))
        return (y, r, w, t, p, s, z, rhat, rho_new, alpha_new, rr_new)
    return fused_step


def _pbicgstab_merged_finalize(ops, x0, state):
    # the loop iterates in the preconditioned ŷ space; recover x once
    return x0 + ops.M(state[0])


def _make_bicgstab_merged_refresh(preconditioned: bool):
    def refresh(ops, x0, state):
        """Residual replacement (declared for the resilient driver): the
        true residual from the iterate (through ``finalize``'s map in the
        preconditioned ŷ space), every recurrence image ``w, t, s, z``
        rebuilt from it, and ρ, α and ‖r‖² from one stacked reduction."""
        mv = _merged_bicgstab_matvec(ops, preconditioned)
        y, r, w, t, p, s, z, rhat, rho, alpha, rr = state
        x = x0 + ops.M(y) if preconditioned else y
        r = ops.b - ops.matvec(x)
        w = mv(r)
        t = mv(w)
        s = mv(p)
        z = mv(s)
        rho, rr, rhs = ops.dotn((rhat, r), (r, r), (rhat, s))
        alpha = rho / rhs                  # α = ρ / r̂·(B p)
        return (y, r, w, t, p, s, z, rhat, rho, alpha, rr)
    return refresh


_BICGSTAB_MERGED_FUSED = ("bicgstab_spmv_dots", "bicgstab_update1",
                          "bicgstab_spmv_update")

register_method(MethodDef(
    name="bicgstab_merged",
    vectors=("x", "r", "w", "t", "p", "s", "z", "rhat"),
    scalars=("rho", "alpha", "rr"), res_scalar="rr",
    init=_make_bicgstab_merged_init(False),
    step=_make_bicgstab_merged_step(False),
    variant_of="bicgstab", reduce_hide="merged",
    fused_kernels=_BICGSTAB_MERGED_FUSED,
    fused_init=_make_bicgstab_merged_init(False),
    fused_step=_make_bicgstab_merged_fused_step(False),
    guard=_rho_underflow_guard(8, 10),
    refresh=_make_bicgstab_merged_refresh(False), refresh_spmvs=5))

register_method(MethodDef(
    name="pbicgstab_merged",
    vectors=("x", "r", "w", "t", "p", "s", "z", "rhat"),
    scalars=("rho", "alpha", "rr"), res_scalar="rr",
    init=_make_bicgstab_merged_init(True),
    step=_make_bicgstab_merged_step(True),
    finalize=_pbicgstab_merged_finalize,
    variant_of="pbicgstab", reduce_hide="merged", accepts_precond=True,
    fused_kernels=_BICGSTAB_MERGED_FUSED,
    fused_init=_make_bicgstab_merged_init(True),
    fused_step=_make_bicgstab_merged_fused_step(True),
    guard=_rho_underflow_guard(8, 10),
    refresh=_make_bicgstab_merged_refresh(True), refresh_spmvs=5))


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
