"""The port's MethodDef lint (``repro_torch.analysis.lint_methods``) and
``python -m repro_torch.analysis`` (counterparts of ``tests/test_audit.py``'s
lint cases): clean on the real ``METHODS`` table; each of the four rules
flags a deliberately bad injected ``MethodDef``, and only that rule; the
registry sweep is clean; ``--lint-only`` exits 0 and the full audit raises
naming ROADMAP item 13."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import __main__ as analysis_main
from repro_torch.analysis.lint_methods import check_method, check_methods
from repro_torch.analysis.violation import format_violations
from repro_torch.api.registry import REGISTRY, SolverSpec, method_field_diff
from repro_torch.core.methods import METHODS, MethodDef

REPO = Path(__file__).resolve().parents[1]


def _init(ops, x0):
    r = ops.b - ops.matvec(x0)
    return (x0, ops.dot(r, r))


def _fields(found) -> set[str]:
    return {v.field for v in found}


# -----------------------------------------------------------------------------
# rule 1: host reads of tensor state (the reference's traced branch)
# -----------------------------------------------------------------------------

def _branchy_step(ops, state):
    x, res = state
    if res > 1e-3:          # Python branch on a tensor: the injection
        x = x + 1.0
    return (x, res * 0.5)


def _item_step(ops, state):
    x, res = state
    alpha = res.item()      # a copy to the host: the injection
    return (x + alpha, res * 0.5)


def _float_step(ops, state):
    x, res = state
    r = ops.b - ops.matvec(x)
    scale = float(ops.dot(r, r))     # a host read of an ops value: the injection
    return (x * scale, res * 0.5)


def _mdef(name, step, init=_init, **kw):
    return MethodDef(name=name, vectors=("x",), scalars=("res2",), res_scalar="res2",
                     init=init, step=step, **kw)


@pytest.mark.parametrize("step, what", [(_branchy_step, "Python If"),
                                        (_item_step, ".item()"),
                                        (_float_step, "float()")])
def test_host_read_in_step_is_flagged(step, what):
    found = check_method(_mdef("_lint_host_read", step))
    assert _fields(found) == {"host_read"}, format_violations(found)
    (v,) = found
    assert v.pass_name == "lint_methods" and what in str(v.actual)
    assert "CUDA graph capture" in v.expected
    assert "test_torch_lint_methods.py" in v.detail and "_lint_host_read.step" in v.detail


def test_a_host_read_runs_on_the_cpu_so_only_the_lint_sees_it():
    """Unlike the reference's traced branch, which also fails to trace under
    ``eval_shape``, a host read runs eagerly on the CPU: the layout pass
    finds nothing, and the lint is the one place it is caught before a card
    refuses the graph capture."""
    found = check_method(_mdef("_lint_host_read", _branchy_step))
    assert "state_layout" not in _fields(found)


def test_host_read_in_init_is_flagged():
    def init(ops, x0):
        r = ops.b - ops.matvec(x0)
        rr = ops.dot(r, r)
        assert bool(rr >= 0)          # two host reads: the assert and bool()
        return (x0, rr)

    found = check_method(_mdef("_lint_init_read", _item_step, init=init), layout=False)
    assert sorted((v.detail.rsplit(".", 1)[-1], str(v.actual).split(" ")[0])
                  for v in found) == [("init)", "Python"), ("init)", "bool()"),
                                      ("step)", ".item()")]


# -----------------------------------------------------------------------------
# rule 2: closures over mutable state
# -----------------------------------------------------------------------------

_SEEN: list = []


def _global_step(ops, state):
    x, res = state
    _SEEN.append(1)         # a mutable module global: the injection
    return (x, res * 0.5)


def _closure_step_factory():
    knobs = {"omega": 0.5}  # a mutable closure: the injection

    def step(ops, state):
        x, res = state
        return (x * knobs["omega"], res * 0.5)
    return step


@pytest.mark.parametrize("step, field", [(_global_step, "mutable_global"),
                                         (_closure_step_factory(), "mutable_closure")])
def test_mutable_captures_are_flagged(step, field):
    found = check_method(_mdef("_lint_mutable", step))
    assert _fields(found) == {field}, format_violations(found)


# -----------------------------------------------------------------------------
# rule 3: calls outside the protocol
# -----------------------------------------------------------------------------

def _escape_step(ops, state):
    x, res = state
    st = ops.A.stencil.offsets       # the protocol's ``stencil``: allowed
    return (ops.A.base.matvec(x) * len(st) + ops.A.apply_halo(x), res * 0.5)


def test_protocol_escape_is_flagged():
    found = check_method(_mdef("_lint_escape", _escape_step), layout=False)
    assert [(v.field, v.actual) for v in found] == [("protocol_escape", "ops.A.apply_halo")]


def test_ops_and_params_escapes_are_flagged():
    def step(ops, state):
        x, res = state
        w = ops.params.setdefault("w", 1.0)     # only the dict's read side
        return (ops.precond(x) * w, res * 0.5)

    found = check_method(_mdef("_lint_escape_ops", step), layout=False)
    assert sorted(v.actual for v in found) == ["ops.params.setdefault", "ops.precond"]


# -----------------------------------------------------------------------------
# rule 4: the state layout
# -----------------------------------------------------------------------------

def _three_slots_init(ops, x0):
    r = ops.b - ops.matvec(x0)
    return (x0, r, ops.dot(r, r))


def _f32_step(ops, state):
    x, res = state
    return (x.to(torch.float32), res * 0.5)


def _vector_scalar_init(ops, x0):
    r = ops.b - ops.matvec(x0)
    return (x0, r * r)


def _raising_step(ops, state):
    x, res = state
    return (ops.matvec(x[0]), res)


@pytest.mark.parametrize("init, step, says", [
    (_three_slots_init, _item_step, "init produced 3 slots"),
    (_init, _f32_step, "step ["),
    (_vector_scalar_init, _item_step, "(4, 4, 4), 'torch.float64')"),
    (_init, _raising_step, "step runs on a 4x4x4 CPU problem"),
])
def test_state_layout_mismatch_is_flagged(init, step, says):
    found = [v for v in check_method(_mdef("_lint_layout", step, init=init))
             if v.field != "host_read"]
    assert _fields(found) == {"state_layout"}, format_violations(found)
    assert any(says in f"{v.expected} {v.actual}" for v in found), format_violations(found)


def test_fused_layout_runs_on_the_kernel_op():
    """A fused body is run on ``KernelOp`` (the kernels' plain versions on
    the CPU) and tagged ``|kernels``."""
    mdef = METHODS["cg_merged"]
    bad = MethodDef(name="_lint_fused", vectors=mdef.vectors, scalars=mdef.scalars,
                    res_scalar=mdef.res_scalar, init=mdef.init, step=mdef.step,
                    fused_kernels=mdef.fused_kernels, fused_init=_three_slots_init,
                    fused_step=mdef.fused_step)
    found = check_method(bad)
    assert [(v.subject, v.field) for v in found] == [("method:_lint_fused|kernels",
                                                       "state_layout")]


# -----------------------------------------------------------------------------
# the real table, the registry sweep and the CLI
# -----------------------------------------------------------------------------

def test_real_methods_lint_clean():
    assert check_methods(layout=False) == []


def test_real_methods_layout_clean():
    found = check_methods()
    assert found == [], format_violations(found)
    assert len(METHODS) == 15


def test_registry_sweep_is_clean_and_catches_drift():
    assert analysis_main._registry_violations() == []
    spec = REGISTRY["cg"]
    drifted = SolverSpec(**{**{f: getattr(spec, f) for f in spec.__dataclass_fields__
                               if f != "method_def"}, "stationary": True})
    diff = method_field_diff(drifted, METHODS["cg"])
    assert [(d.field, d.registry_value, d.derived_value) for d in diff] == [
        ("stationary", True, False)]


def test_lint_only_exits_zero(capsys):
    assert analysis_main.main(["--lint-only"]) == 0
    out = capsys.readouterr().out
    assert "[2/3] MethodDef AST + state-layout lint" in out and "OK" in out


def test_lint_only_module_entry_point():
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--lint-only"],
                          cwd=REPO, env={"PYTHONPATH": str(REPO / "src"),
                                         "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("OK: all contracts hold")


@pytest.mark.parametrize("argv", [["--check", "AUDIT.json"], ["--write", "x.json"], []])
def test_full_audit_raises_naming_item_13(argv):
    with pytest.raises(NotImplementedError, match="item 13"):
        analysis_main.main(argv)
