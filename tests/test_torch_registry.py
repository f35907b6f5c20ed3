"""The port's registry drift report and facade exports against the reference's.

The reference's ``tests/test_audit.py`` holds its ``RegistryConsistencyError``
to an aligned expected-vs-actual table and its ``FieldDiff`` rows to
"registry declares … derived says …"; the same assertions run here on
``repro_torch.api.registry``, with ``fused_capability_diff`` checked against
``KernelOp``'s hooks (where the reference checks ``PallasOp``'s).  The
facade exports ``timed``, ``HALO_MODES`` and ``resolve_halo_mode`` as the
reference's does.
"""

from __future__ import annotations

import dataclasses

import pytest

from test_torch_harness import ref_api, ref_module

import repro_torch.api as api
from repro_torch.api import SolverOptions
from repro_torch.api.registry import (REGISTRY, FieldDiff, RegistryConsistencyError,
                                      SolverSpec, format_field_diffs,
                                      fused_capability_diff, method_field_diff,
                                      register_solver)
from repro_torch.core.methods import METHODS, MethodDef


def _toy_init(ops, x0):
    r = ops.b - ops.matvec(x0)
    return (x0, ops.dot(r, r))


def test_registry_consistency_error_prints_field_diff():
    toy = MethodDef(name="_audit_toy", vectors=("x",), scalars=("res2",),
                    res_scalar="res2", init=_toy_init,
                    step=lambda ops, state: (state[0], state[1] * 0.5))
    METHODS[toy.name] = toy
    try:
        with pytest.raises(RegistryConsistencyError) as exc:
            register_solver(SolverSpec(
                name=toy.name, fn=lambda *a, **k: None,
                reduction_hides=("none",), spmvs_per_iter=1,
                stationary=True, accepts_precond=True))   # mdef says False/False
        msg = str(exc.value)
        assert "drifted from its MethodDef" in msg
        # the aligned table: header row + one row per mismatched field
        assert "registry" in msg and "derived" in msg
        assert "stationary" in msg and "accepts_precond" in msg
        assert "True" in msg and "False" in msg
        assert toy.name not in REGISTRY          # rejected, not registered
    finally:
        METHODS.pop(toy.name, None)
        REGISTRY.pop(toy.name, None)


def test_method_field_diff_rows():
    spec = REGISTRY["cg"]
    assert method_field_diff(spec, METHODS["cg"]) == []
    diffs = method_field_diff(spec, METHODS["cg_merged"])
    assert any(d.field == "reduce_hide" for d in diffs)
    d = next(d for d in diffs if d.field == "reduce_hide")
    assert "registry declares" in str(d) and "derived says" in str(d)
    assert str(d) == "cg.reduce_hide: registry declares 'none', derived says 'merged'"
    assert dataclasses.is_dataclass(d) and d.method == "cg"
    with pytest.raises(dataclasses.FrozenInstanceError):
        d.method = "cg_merged"


def test_field_diff_str_matches_the_reference():
    rreg = ref_module("api.registry")
    args = ("cg", "stationary", True, False)
    assert str(FieldDiff(*args)) == str(rreg.FieldDiff(*args))
    rows = [FieldDiff(*args), FieldDiff("cg_merged", "fused_kernels", (), ("cg_body",))]
    assert format_field_diffs(rows) == rreg.format_field_diffs(
        [rreg.FieldDiff(*dataclasses.astuple(r)) for r in rows])


def test_format_field_diffs_header():
    table = format_field_diffs([FieldDiff("cg", "stationary", True, False)])
    head, rule, row = table.splitlines()
    assert head.split() == ["method", "field", "registry", "derived"]
    assert set(rule.replace(" ", "")) == {"-"}
    assert row.split() == ["cg", "stationary", "True", "False"]
    # the columns line up: each cell starts where its header does
    assert row.index("stationary") == head.index("field")
    assert row.index("True") == head.index("registry")


def test_fused_capability_diff_names_a_missing_kernelop_hook():
    spec = REGISTRY["cg_merged"]
    assert fused_capability_diff(spec, METHODS["cg_merged"]) == []
    bad = dataclasses.replace(spec, fused_kernels=("cg_body", "no_such_hook"))
    (d,) = fused_capability_diff(bad, METHODS["cg_merged"])
    assert d.method == "cg_merged" and d.field == "fused_kernels"
    assert "KernelOp" in str(d) and "no_such_hook" in str(d)
    assert "cg_body" not in d.derived_value
    # a capability on a MethodDef without a fused body
    (d,) = fused_capability_diff(dataclasses.replace(REGISTRY["cg"], fused_kernels=(
        "cg_body",)), METHODS["cg"])
    assert "no fused body" in d.derived_value
    assert fused_capability_diff(REGISTRY["cg"], METHODS["cg"]) == []


def test_registration_reports_a_missing_hook():
    """``register_solver`` runs the capability check: a drifted hook name is
    a row of the table, not a silent fallback to the unfused path."""
    spec = dataclasses.replace(REGISTRY["cg_merged"], name="_toy_merged",
                               fused_kernels=("cg_body", "spmv_dotz"))
    METHODS["_toy_merged"] = dataclasses.replace(METHODS["cg_merged"], name="_toy_merged",
                                                 fused_kernels=("cg_body", "spmv_dotz"))
    try:
        with pytest.raises(RegistryConsistencyError) as exc:
            register_solver(spec)
        msg = str(exc.value)
        assert "method" in msg.splitlines()[1] and "spmv_dotz" in msg
        assert "_toy_merged" not in REGISTRY
    finally:
        METHODS.pop("_toy_merged", None)
        REGISTRY.pop("_toy_merged", None)


def test_api_exports_match_the_reference():
    rapi = ref_api()
    assert set(rapi.__all__) <= set(api.__all__)
    for name in ("timed", "HALO_MODES", "resolve_halo_mode"):
        assert name in api.__all__ and hasattr(api, name)
    assert api.HALO_MODES == rapi.HALO_MODES
    for mode in api.HALO_MODES:
        for kernels in (False, True):
            opts = SolverOptions(halo_mode=mode, kernels=kernels)
            want = rapi.resolve_halo_mode(rapi.SolverOptions(halo_mode=mode, pallas=kernels))
            assert api.resolve_halo_mode(opts) == want
    calls = []
    stats = api.timed(lambda: calls.append(1), repeats=4, warmup=2)
    assert len(calls) == 6
    assert set(stats) == {"median", "q1", "q3", "min", "mean"}
    assert 0 <= stats["min"] <= stats["median"] <= stats["q3"]
