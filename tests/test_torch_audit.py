"""The port's collective and donation audit (``repro_torch.analysis.audit``).

The comparator cases of the reference's ``tests/test_audit.py`` on synthetic
records (``compare`` is pure, so they are fast), the job matrix against the
reference's, and one measurement on 8 spawned gloo ranks (~15 s) held to
the registry, to the committed ``AUDIT_torch.json`` and, for every job key
the two share, to the reference's own ``AUDIT.json`` counts: the
``all_gather`` count to its ``all-reduce`` count, twice the ``exchange``
count (one swap of one split dim, both directions) to its
``collective-permute`` count.  The reference's file is read here only; this
module imports nothing of ``repro``.
"""

from __future__ import annotations

import copy
import dataclasses
import json
from pathlib import Path

import pytest

from repro_torch.analysis import __main__ as analysis_main
from repro_torch.analysis import audit
from repro_torch.analysis.audit import (comms_jobs, compare, compare_baseline,
                                        expected_comms, reference_key)
from repro_torch.api import REGISTRY
from repro_torch.core.overlap import collective_hides, meets_hide

REPO = Path(__file__).resolve().parents[1]


def _reference_comms() -> dict:
    return json.loads((REPO / "AUDIT.json").read_text())["measured"]["comms"]


def _fake_measured(registry, mesh="1d", halo="concat"):
    """Records exactly matching the registry's expectations."""
    comms = {}
    for name, spec in registry.items():
        want = expected_comms(spec, mesh)
        comms[f"{name}|{mesh}|{halo}|xla|none"] = {
            "counts": {op: n for op, n in want.items() if n}, "bytes": 1000}
    return {"comms": comms}


# -- the comparator on synthetic records -----------------------------------------------

def test_clean_registry_compares_clean():
    assert compare(_fake_measured(REGISTRY)) == []


def test_wrong_allreduce_count_flagged():
    bad_cg = dataclasses.replace(REGISTRY["cg"], allreduces_per_iter=1)
    registry = dict(REGISTRY, cg=bad_cg)
    found = compare(_fake_measured({"cg": REGISTRY["cg"]}), registry=registry)
    assert [(v.pass_name, v.field, v.expected, v.actual) for v in found] == [
        ("comms", "all_gather", 1, 2)]


def test_unexpected_collective_flagged():
    measured = _fake_measured({"cg": REGISTRY["cg"]})
    key = next(iter(measured["comms"]))
    measured["comms"][key]["counts"]["broadcast"] = 1
    measured["comms"][key]["counts"]["all_to_all"] = 1
    found = compare(measured)
    assert sorted((v.field, v.expected, v.actual) for v in found) == [
        ("all_to_all", 0, 1), ("broadcast", 0, 1)]


def test_donation_violations_flagged():
    measured = {"donate_mesh": {"cg|1d": {"on": 0, "off": 0}},
                "local": {"cg": {"on": 1, "off": 1}}}
    found = compare(measured)
    assert sorted((v.pass_name, v.subject, v.field) for v in found) == [
        ("donation", "cg|1d", "on"), ("donation", "cg|local", "off")]


def test_guard_invariance_violation_flagged():
    measured = {"guard_invariance": {"cg|1d": {"plain": {"all_gather": 11},
                                               "guarded": {"all_gather": 12}}}}
    assert [v.pass_name for v in compare(measured)] == ["guard_invariance"]


def test_baseline_drift_flagged():
    key = "cg|1d|concat|xla|none"
    rec = {"counts": {"all_gather": 2, "exchange": 1}, "bytes": 1616}
    drifted = {"counts": {"all_gather": 2, "exchange": 1}, "bytes": 3232}
    base = {"measured": {"comms": {key: rec}}}
    assert compare_baseline({"comms": {key: rec}}, base) == []
    assert [v.field for v in compare_baseline({"comms": {key: drifted}}, base)] == ["drift"]
    assert [v.field for v in compare_baseline({"comms": {}}, base)] == ["coverage"]
    new = compare_baseline({"comms": {key: rec, "cg|3d|auto|xla|none": rec}}, base)
    assert [v.field for v in new] == ["coverage"]


def test_precond_configs_add_expected_traffic():
    plain = expected_comms(REGISTRY["pcg"], "2d")
    withp = expected_comms(REGISTRY["pcg"], "2d", precond="jacobi")
    assert withp["all_gather"] == plain["all_gather"]        # Jacobi: no extra reduction
    assert withp["exchange"] == plain["exchange"] + 2        # one halo matvec x 2 split dims


def test_window_and_halo_violations_flagged():
    """A hard reduction where the registry declares a window, a window where
    it declares none, a never-waited collective and a blocking swap that
    carries work are each flagged."""
    V, spmv = 1000, 30000
    measured = _fake_measured({"cg": REGISTRY["cg"]})
    key = "cg|1d|concat|xla|none"
    measured["windows"] = {key: {"reductions": [[0, 200], [0, 0]], "halos": [[0, 900, 800]],
                                 "unwaited": 1, "vector_bytes": V, "spmv_bytes": spmv}}
    fields = sorted(v.field for v in compare(measured))
    assert fields == ["halo[0]", "reduction[0]", "reduction[1]", "unwaited"]
    measured["windows"][key] = {"reductions": [[0, 0], [5 * V, 5 * V]],
                                "halos": [[0, 0, 800]], "unwaited": 0,
                                "vector_bytes": V, "spmv_bytes": spmv}
    assert compare(measured) == []


def test_hide_classes_of_the_collectives():
    assert collective_hides(("none", "vec"), 2) == ("none", "vec")
    # pcg stacks (r·z, r·r) into one collective, which shares r·r's window
    assert collective_hides(REGISTRY["pcg"].reduction_hides, 2) == ("none", "vec")
    assert collective_hides(("pipe",), 1) == ("pipe",)
    assert meets_hide("none", 124, vector_bytes=1000, spmv=0)
    assert not meets_hide("none", 125, vector_bytes=1000, spmv=0)
    assert meets_hide("vec", 1000, vector_bytes=1000, spmv=0)
    assert not meets_hide("spmv", 999, vector_bytes=10, spmv=1000)
    with pytest.raises(ValueError, match="unknown reduction hide"):
        meets_hide("merged", 0, vector_bytes=1, spmv=1)


def test_job_matrix_covers_the_reference_keys():
    """The port's job keys are the reference's, ``kernels`` for its
    ``pallas``: 82 shared keys."""
    keys = {reference_key(j["key"]) for j in comms_jobs()}
    assert keys == set(_reference_comms())
    assert len(keys) == 82
    assert reference_key("cg_merged|2d|auto|kernels|none") == "cg_merged|2d|auto|pallas|none"


# -- the measurement on 8 gloo ranks ----------------------------------------------------

@pytest.fixture(scope="module")
def measured():
    return audit.run_measurements()


def test_measurement_holds_every_contract(measured):
    baseline = json.loads((REPO / "AUDIT_torch.json").read_text())
    found = compare(measured, baseline=baseline)
    assert found == [], "\n".join(map(str, found))
    assert len(measured["comms"]) == len(measured["windows"]) == 82


def test_counts_agree_with_the_reference_audit(measured):
    ref = _reference_comms()
    for key, rec in measured["comms"].items():
        want = ref[reference_key(key)]["counts"]
        got = rec["counts"]
        assert got.get("all_gather", 0) == want.get("all-reduce", 0), key
        assert 2 * got.get("exchange", 0) == want.get("collective-permute", 0), key
        assert set(got) <= {"all_gather", "exchange"}, key


def test_every_unfused_window_meets_its_class(measured):
    """Each unfused step's reductions against ``reduction_hides``, read
    straight off the windows: the hard barriers are the registry's."""
    for key, win in measured["windows"].items():
        method, _mesh, _halo, route, _prec = key.split("|")
        if route != "xla":
            continue
        spec = REGISTRY[method]
        hides = collective_hides(spec.reduction_hides, len(win["reductions"]))
        hard = sum(1 for lo, hi in win["reductions"] if hi < win["vector_bytes"] / 8)
        assert hard == sum(1 for h in hides if h == "none"), (key, win)


def test_mesh_solves_donate(measured):
    """Every method's mesh solve hands back the caller's x0 block under
    ``donate`` and leaves it alone without (both meshes), as the local
    solve does."""
    assert len(measured["donate_mesh"]) == 2 * len(REGISTRY)
    assert len(measured["local"]) == len(REGISTRY)
    for rec in [*measured["donate_mesh"].values(), *measured["local"].values()]:
        assert rec == {"on": 1, "off": 0}


def _check_exit(monkeypatch, capsys, measured, baseline: dict, tmp_path) -> int:
    monkeypatch.setattr(audit, "run_measurements", lambda methods=None: measured)
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps(baseline))
    rc = analysis_main.main(["--check", str(path)])
    capsys.readouterr()
    return rc


def test_check_exits_one_on_a_planted_fault(measured, monkeypatch, capsys, tmp_path):
    """``--check`` exits 0 on the committed baseline and 1 on a planted
    wrong count, an extra collective or byte drift."""
    baseline = json.loads((REPO / "AUDIT_torch.json").read_text())
    assert _check_exit(monkeypatch, capsys, measured, baseline, tmp_path) == 0
    key = "cg|2d|auto|xla|none"
    wrong = copy.deepcopy(measured)
    wrong["comms"][key]["counts"]["all_gather"] += 1
    extra = copy.deepcopy(measured)
    extra["comms"][key]["counts"]["broadcast"] = 1
    drift = copy.deepcopy(baseline)
    drift["measured"]["comms"][key]["bytes"] += 8
    assert _check_exit(monkeypatch, capsys, wrong, baseline, tmp_path) == 1
    assert _check_exit(monkeypatch, capsys, extra, baseline, tmp_path) == 1
    assert _check_exit(monkeypatch, capsys, measured, drift, tmp_path) == 1
