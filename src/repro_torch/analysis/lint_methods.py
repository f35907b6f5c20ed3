"""AST lint over every registered :class:`MethodDef` body.

Counterpart of ``repro/analysis/lint_methods.py``.  One definition per method
drives every route of the port (the eager loop, the captured CUDA graphs of
the executable cache, both batched loops, the kernels and the plain
operator), so one bad idiom in a definition breaks all of them, and usually
not where it was written.  This pass rejects four idioms at lint time:

* **Host reads of tensor state** (``if rr < tol:``, ``rr.item()``,
  ``float(alpha)``, ``bool(t)`` inside ``init`` or ``step``): the reference's
  "Python branching on traced state".  Eagerly each is a device
  synchronisation in every iteration; inside a CUDA graph capture (the
  executable cache and the guards run every step body in one) it raises
  ``cudaErrorStreamCaptureUnsupported``, and a captured branch would be
  frozen to the way it went at capture.  Control flow on tensor values
  belongs in ``torch.where`` (the drivers own the loop and its one read).

* **Closures over mutable globals**: a list/dict/set captured by a method
  body is invisible re-entrant state: two sessions building the same method
  could observe each other's mutations.  Tuning knobs go through
  ``ops.params`` (declared in ``MethodDef.params``).

* **Calls outside the operator protocol**: a body may touch only the
  declared ``Ops``/operator surface (``OPS_PROTOCOL``/``OPERATOR_PROTOCOL``
  in ``repro_torch.core.methods``).  Anything else couples the definition to
  one backend.

* **State-layout mismatches**: the declared ``vectors``/``scalars`` must be
  exactly what ``init`` produces and ``step`` preserves (shape and dtype: the
  executable's static state sets are allocated from them once and every
  captured step writes into them).  Where the reference evaluates shapes
  abstractly (``jax.eval_shape``), the port runs ``init`` and one ``step`` on
  a 4×4×4 CPU problem, unfused on ``LocalOp`` and fused on ``KernelOp`` (the
  kernels' plain versions: no card needed).

Scope: the lint sees the registered functions' own ASTs (factory-made
closures included), not the helpers they call; the helpers are shared across
methods and covered by the routes' parity tests.
"""

from __future__ import annotations

import ast
import inspect
import textwrap

from repro_torch.analysis.violation import Violation
from repro_torch.core.methods import (
    METHODS,
    OPERATOR_PROTOCOL,
    OPS_PROTOCOL,
    MethodDef,
    Ops,
)

PASS = "lint_methods"

#: dict-protocol attrs allowed on ``ops.params`` (a plain dict of knobs)
_PARAMS_ATTRS = frozenset({"get", "items", "keys", "values"})

_MUTABLE_TYPES = (list, dict, set, bytearray)

_FN_KINDS = ("init", "step", "finalize", "fused_init", "fused_step",
             "guard", "refresh")

#: tensor methods that copy a value to the host (a device synchronisation)
_HOST_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
#: builtins that read a tensor's value on the host
_HOST_BUILTINS = frozenset({"bool", "float", "int", "complex"})

#: why a host read is refused, in every finding's ``expected``
_HOST_READ = ("device-side control flow (torch.where): a host read syncs every "
              "eager iteration and breaks CUDA graph capture "
              "(cudaErrorStreamCaptureUnsupported)")


def _method_functions(mdef: MethodDef):
    for kind in _FN_KINDS:
        fn = getattr(mdef, kind)
        if fn is not None:
            yield kind, fn


def _function_node(fn) -> ast.FunctionDef:
    src = textwrap.dedent(inspect.getsource(fn))
    tree = ast.parse(src)
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            return node
    raise ValueError(f"no function definition found in source of {fn!r}")


def _names(node: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _attr_chain(node: ast.Attribute) -> list[str] | None:
    """``ops.A.base.matvec`` -> ["ops", "A", "base", "matvec"]; None when the
    chain is not rooted at a plain name (e.g. a subscript)."""
    parts: list[str] = []
    cur: ast.AST = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return parts[::-1]
    return None


def _where(mdef_name: str, kind: str, fn, node: ast.AST) -> str:
    line = fn.__code__.co_firstlineno + getattr(node, "lineno", 1) - 1
    return f"{fn.__code__.co_filename}:{line} ({mdef_name}.{kind})"


def _assign_targets(stmt: ast.AST) -> list[ast.AST]:
    if isinstance(stmt, ast.Assign):
        return list(stmt.targets)
    if isinstance(stmt, (ast.AugAssign, ast.AnnAssign, ast.For)):
        return [stmt.target]
    return []


def _rhs(stmt: ast.AST) -> ast.AST | None:
    if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
        return stmt.value
    if isinstance(stmt, ast.For):
        return stmt.iter
    return None


def _ops_rooted_value(node: ast.AST, ops_name: str) -> bool:
    """Does the expression read the ops context (anything but ``ops.params``)?

    Every such read (``ops.b``, ``ops.matvec(p)``, ``ops.dotn(...)``) yields
    a tensor on the device, so it taints its targets.  Only the knob dict
    ``ops.params`` is exempt."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute):
            chain = _attr_chain(sub)
            if chain and chain[0] == ops_name and chain[1:2] != ["params"]:
                return True
    return False


def _tainted_names(fdef: ast.FunctionDef, ops_name: str) -> set[str]:
    """Names carrying device values: the non-ops parameters (state, x0) plus
    everything transitively assigned from them or from ops reads."""
    tainted = {a.arg for a in fdef.args.args if a.arg != ops_name}
    changed = True
    while changed:
        changed = False
        for stmt in ast.walk(fdef):
            rhs = _rhs(stmt)
            if rhs is None:
                continue
            if _names(rhs) & tainted or _ops_rooted_value(rhs, ops_name):
                for tgt in _assign_targets(stmt):
                    new = _names(tgt) - tainted
                    if new:
                        tainted |= new
                        changed = True
    return tainted


def _hot(node: ast.AST, tainted: set[str], ops_name: str) -> bool:
    return bool(_names(node) & tainted) or _ops_rooted_value(node, ops_name)


def _host_read_violations(mdef_name, kind, fn, fdef, ops_name) -> list[Violation]:
    """Branches on tensor values and explicit copies of them to the host."""
    tainted = _tainted_names(fdef, ops_name)
    out = []

    def flag(node, actual):
        out.append(Violation(PASS, f"method:{mdef_name}", "host_read", _HOST_READ,
                             actual, _where(mdef_name, kind, fn, node)))

    for node in ast.walk(fdef):
        if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            if _hot(node.test, tainted, ops_name):
                flag(node, f"Python {type(node).__name__} on tensor value(s) "
                           f"{sorted(_names(node.test) & tainted)}")
        elif isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _HOST_METHODS \
                    and _hot(f.value, tainted, ops_name):
                flag(node, f".{f.attr}() on tensor value(s) "
                           f"{sorted(_names(f.value) & tainted)}")
            elif isinstance(f, ast.Name) and f.id in _HOST_BUILTINS and node.args \
                    and _hot(node.args[0], tainted, ops_name):
                flag(node, f"{f.id}() of tensor value(s) "
                           f"{sorted(_names(node.args[0]) & tainted)}")
    return out


def _closure_violations(mdef_name, kind, fn) -> list[Violation]:
    out = []
    if fn.__closure__:
        for var, cell in zip(fn.__code__.co_freevars, fn.__closure__):
            try:
                val = cell.cell_contents
            except ValueError:      # unfilled cell
                continue
            if isinstance(val, _MUTABLE_TYPES):
                out.append(Violation(
                    PASS, f"method:{mdef_name}", "mutable_closure",
                    expected="immutable captures (pass knobs via ops.params)",
                    actual=f"closure over {type(val).__name__} {var!r}",
                    detail=f"{fn.__code__.co_filename} ({mdef_name}.{kind})"))
    g = fn.__globals__
    for name in fn.__code__.co_names:
        if name in g and isinstance(g[name], _MUTABLE_TYPES):
            out.append(Violation(
                PASS, f"method:{mdef_name}", "mutable_global",
                expected="immutable globals (pass knobs via ops.params)",
                actual=f"reads mutable global {name!r} ({type(g[name]).__name__})",
                detail=f"{fn.__code__.co_filename} ({mdef_name}.{kind})"))
    return out


def _protocol_violations(mdef_name, kind, fn, fdef, ops_name) -> list[Violation]:
    out = []
    seen: set[tuple] = set()
    for node in ast.walk(fdef):
        if not isinstance(node, ast.Attribute):
            continue
        chain = _attr_chain(node)
        if not chain or chain[0] != ops_name or len(chain) < 2:
            continue
        attr, allowed, depth = None, None, None
        if len(chain) == 2:
            attr, allowed, depth = chain[1], OPS_PROTOCOL, "ops"
        elif chain[1] == "A" and len(chain) >= 3:
            # ops.A.x and ops.A.base.x are both operator-protocol surface
            i = 3 if chain[2] == "base" and len(chain) >= 4 else 2
            attr, allowed, depth = chain[i], OPERATOR_PROTOCOL, "ops.A"
        elif chain[1] == "params" and len(chain) >= 3:
            attr, allowed, depth = chain[2], _PARAMS_ATTRS, "ops.params"
        if attr is not None and attr not in allowed and (depth, attr) not in seen:
            seen.add((depth, attr))
            out.append(Violation(
                PASS, f"method:{mdef_name}", "protocol_escape",
                expected=f"{depth}.<attr> with attr in the declared protocol",
                actual=f"{depth}.{attr}",
                detail=_where(mdef_name, kind, fn, node)))
    return out


# --- state layout ------------------------------------------------------------

LAYOUT_GRID = (4, 4, 4)


def _layout_ops(fused: bool) -> Ops:
    """The ``Ops`` of a 4×4×4 7pt f64 problem on the CPU: ``LocalOp``, or
    the ``KernelOp`` around it (its hooks run the kernels' plain versions)."""
    import torch

    from repro_torch.core.operators import STENCILS
    from repro_torch.core.solvers import LocalOp

    A = LocalOp(STENCILS["7pt"])
    if fused:
        from repro_torch.kernels.kernel_op import KernelOp
        A = KernelOp(A)
    return Ops(A, torch.ones(LAYOUT_GRID, dtype=torch.float64), norm_ref=1.0)


def _layout(state) -> list:
    """(shape, dtype) of each slot; a slot that is no tensor by its type."""
    import torch

    return [(tuple(t.shape), str(t.dtype)) if isinstance(t, torch.Tensor)
            else type(t).__name__ for t in state]


def _layout_violations(mdef: MethodDef) -> list[Violation]:
    """Declared ``vectors``/``scalars`` against what ``init`` and one ``step``
    produce on a 4×4×4 CPU problem."""
    import torch

    out = []
    nv, ns = len(mdef.vectors), len(mdef.scalars)
    want = [(LAYOUT_GRID if i < nv else (), str(torch.float64)) for i in range(nv + ns)]
    for fused in (False, True):
        if fused and not mdef.has_fused_body:
            continue
        init = mdef.fused_init if fused else mdef.init
        step = mdef.fused_step if fused else mdef.step
        tag = f"method:{mdef.name}" + ("|kernels" if fused else "")
        ops = _layout_ops(fused)
        x0 = torch.zeros(LAYOUT_GRID, dtype=torch.float64)
        try:
            state = tuple(init(ops, x0))
        except Exception as e:  # noqa: BLE001 -- any failure to run IS the finding
            out.append(Violation(PASS, tag, "state_layout",
                                 expected="init runs on a 4x4x4 CPU problem",
                                 actual=f"{type(e).__name__}: {e}"))
            continue
        if len(state) != nv + ns:
            out.append(Violation(PASS, tag, "state_layout",
                                 expected=f"{nv} vectors + {ns} scalars "
                                          f"({mdef.vectors} + {mdef.scalars})",
                                 actual=f"init produced {len(state)} slots"))
            continue
        bad = [(slot, w, g) for slot, w, g in zip(mdef.vectors + mdef.scalars, want,
                                                   _layout(state)) if g != w]
        for slot, w, g in bad:
            out.append(Violation(PASS, tag, "state_layout",
                                 expected=f"slot {slot!r} of shape and dtype {w}",
                                 actual=f"{g}"))
        if bad:
            continue
        try:
            stepped = tuple(step(ops, state))
        except Exception as e:  # noqa: BLE001
            out.append(Violation(PASS, tag, "state_layout",
                                 expected="step runs on a 4x4x4 CPU problem",
                                 actual=f"{type(e).__name__}: {e}"))
            continue
        if _layout(stepped) != want:
            out.append(Violation(
                PASS, tag, "state_layout",
                expected="step preserves the init state layout (the static "
                         "state sets every captured step writes into)",
                actual=f"init {want} vs step {_layout(stepped)}"))
    return out


def check_method(mdef: MethodDef, *, layout: bool = True) -> list[Violation]:
    """All lint findings for one MethodDef."""
    out: list[Violation] = []
    for kind, fn in _method_functions(mdef):
        try:
            fdef = _function_node(fn)
        except (OSError, TypeError, ValueError) as e:
            out.append(Violation(PASS, f"method:{mdef.name}", "source",
                                 expected="inspectable Python source for every body",
                                 actual=f"{type(e).__name__}: {e}", detail=kind))
            continue
        ops_name = fdef.args.args[0].arg if fdef.args.args else "ops"
        out += _host_read_violations(mdef.name, kind, fn, fdef, ops_name)
        out += _closure_violations(mdef.name, kind, fn)
        out += _protocol_violations(mdef.name, kind, fn, fdef, ops_name)
    if layout:
        out += _layout_violations(mdef)
    return out


def check_methods(methods: dict[str, MethodDef] | None = None, *,
                  layout: bool = True) -> list[Violation]:
    """Lint every registered MethodDef (or an injected table, for tests)."""
    methods = METHODS if methods is None else methods
    out: list[Violation] = []
    for name in sorted(methods):
        out += check_method(methods[name], layout=layout)
    return out
