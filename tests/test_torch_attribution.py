"""The port's cost attribution (``repro_torch.obs.attribution``, ``python -m
repro_torch.obs attribute``) against the reference's
(``repro/obs/attribution.py``): on one rank its three chains compute what
the reference's compute (the step chain's state and the reduction within
rtol 1e-12, the halo chain bitwise its input), 27pt and 7pt at 8×8×16 f64
from seeded numpy inputs; its counts are the reference registry's for every
method; ``format_table`` and ``rows_from_trace`` give the reference's
strings and rows; a trace the reference wrote re-renders through the port's
CLI; a one-rank report's phases sum to ``t_iter``; and on two gloo ranks
(``test_torch_distributed_ranks.attrib2``) both ranks get the same row.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
from test_torch_distributed_ranks import CELLS_GRID, spawn

from test_torch_harness import x64  # noqa: F401  (fixture)
from test_torch_harness import ref_module, seeded, to_np

from repro_torch.core.problems import from_reference
from repro_torch.core.solvers import SOLVERS
from repro_torch.launch.mesh import Mesh
from repro_torch.obs import attribution
from repro_torch.obs import trace as obs
from repro_torch.obs.__main__ import main

GRID = (8, 8, 16)
CHAIN_METHODS = ("cg", "cg_merged", "cg_pipe", "bicgstab")
INNER = 3
TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture()
def tracer_path(tmp_path):
    """An enabled tracer for the test body, torn down unconditionally."""
    path = str(tmp_path / "trace.jsonl")
    obs.enable(path)
    yield path
    obs.disable()


def _problems(stencil: str, seed: int = 0):
    """The reference's problem and the port's, the port's b and x0 seeded
    (numpy), and the same b and x0 for the reference's state."""
    import jax.numpy as jnp
    jprob = ref_module("core.problems").make_problem(GRID, stencil, dtype=jnp.float64)
    b, x0 = seeded(GRID, seed), seeded(GRID, seed + 1)
    prob = from_reference(stencil, GRID, np.dtype(np.float64), b=b, x0=x0, device="cpu")
    return jprob, prob, b, x0


def _port_problem():
    """The port's 27pt problem of seeded b and x0."""
    b, x0 = seeded(GRID, 0), seeded(GRID, 1)
    return from_reference("27pt", GRID, np.dtype(np.float64), b=b, x0=x0, device="cpu"), b, x0


def _ref_chains(jprob, method: str, halo_mode: str = "concat"):
    mesh = ref_module("launch.mesh").make_solver_mesh(1)
    return ref_module("obs.attribution")._phase_fns(jprob, method, mesh,
                                                    halo_mode=halo_mode, inner=INNER)


@pytest.mark.parametrize("stencil", ["27pt", "7pt"])
@pytest.mark.parametrize("method", CHAIN_METHODS)
def test_chains_match_the_reference(x64, method, stencil):
    """``step_chain``'s state within rtol 1e-12 of the reference's from the
    same seeded b and x0 (each entry, or 1e-12 of the slot's largest
    magnitude where a cancelling entry is small); ``halo_chain`` bitwise its input (one rank: the
    zero halo, cut off again); ``reduce_chain``'s sum within rtol 1e-12."""
    import jax.numpy as jnp
    jprob, prob, b, x0 = _problems(stencil)
    r_step, r_halo, r_red, _, _ = _ref_chains(jprob, method)
    step, halo, red, layout, state0 = attribution._phase_fns(
        prob, method, Mesh.one_rank(), halo_mode="concat", inner=INNER)
    assert layout.dim_axes == (None, None, "cells")
    dist = ref_module("core.distributed")
    jstate = dist.init_step_state(method, ref_module("core.solvers").LocalOp(jprob.stencil),
                                  jnp.asarray(b), jnp.asarray(x0))
    got, want = step(*state0), r_step(*jstate)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = to_np(w)
        np.testing.assert_allclose(to_np(g), w, rtol=1e-12,
                                   atol=1e-12 * float(np.max(np.abs(w), initial=1.0)))
    x = torch.as_tensor(seeded(GRID, 7))
    out = halo(x)
    assert torch.equal(out, x)
    np.testing.assert_array_equal(to_np(r_halo(jnp.asarray(to_np(x)))), to_np(x))
    np.testing.assert_allclose(to_np(red(x)), to_np(r_red(jnp.asarray(to_np(x)))), **TOL)
    np.testing.assert_allclose(float(red(x)), INNER * float(torch.dot(x.reshape(-1),
                                                                        x.reshape(-1))),
                               rtol=1e-12)


@pytest.mark.parametrize("halo_mode", ["concat", "scatter", "overlap"])
def test_halo_chain_every_mode_is_its_input(halo_mode):
    """On one rank every halo mode's chain gives back its input bitwise."""
    prob, _, _ = _port_problem()
    _, halo, _, _, _ = attribution._phase_fns(prob, "cg", Mesh.one_rank(),
                                              halo_mode=halo_mode, inner=INNER)
    x = torch.as_tensor(seeded(GRID, 3))
    assert torch.equal(halo(x), x)


@pytest.mark.parametrize("method", sorted(SOLVERS))
def test_counts_are_the_reference_registry(method):
    """A row's counts are the reference registry's halo exchanges and
    allreduces a step, for every method; its prediction and drift empty."""
    prob, _, _ = _port_problem()
    row = attribution.measure_phase_split(prob, method, Mesh.one_rank(), inner=1, repeats=1)
    spec = ref_module("api.registry").get_solver(method)
    assert row["counts"] == {"halo_exchanges": spec.halo_exchanges_per_iter,
                             "allreduces": spec.allreduces_per_iter}
    assert set(row["predicted"]) == {"t_mem", "t_halo", "t_precond", "t_reduce", "t_rr",
                                     "total"}
    assert all(v is None for v in row["predicted"].values())
    assert row["drift"] == {"total": None, "halo": None, "reduce": None}


def _fixed_rows() -> list[dict]:
    measured = {"t_iter": 1.25e-3, "t_halo": 2.5e-4, "t_reduce": 1.0e-4, "t_compute": 9.0e-4}
    mesh = {"axes": ["cells"], "shape": [4], "devices": 4}
    empty = {"predicted": dict.fromkeys(attribution.PREDICTED_KEYS),
             "drift": {"total": None, "halo": None, "reduce": None}}
    priced = {"predicted": {"t_mem": 5e-4, "t_halo": 1e-4, "t_precond": 0.0,
                            "t_reduce": 5e-5, "t_rr": 0.0, "total": 6.5e-4},
              "drift": {"total": 1.923, "halo": 2.5, "reduce": 2.0}}
    return [dict(method=m, halo_mode=h, grid=[8, 8, 32], mesh=mesh,
                 counts={"halo_exchanges": 1, "allreduces": 2}, measured=measured, **extra)
            for m, h, extra in (("cg", "concat", empty), ("cg_merged", "overlap", priced),
                                ("pbicgstab_merged", "scatter", empty))]


def test_format_table_and_rows_from_trace_are_the_reference(tmp_path):
    """The same fixed rows, ``None`` predictions included, give the
    reference's table string, and the same records its rows."""
    ref = ref_module("obs.attribution")
    rows = _fixed_rows()
    assert attribution.format_table(rows) == ref.format_table(rows)
    assert attribution.format_table(rows).splitlines()[2].rstrip().endswith("-")
    records = [obs.make_metric("obs.attribution", **r) for r in rows]
    records += [obs.make_metric("other", x=1), obs.make_event("obs.attribution", x=2)]
    assert attribution.rows_from_trace(records) == ref.rows_from_trace(records) == rows


def test_reference_trace_rerenders_through_the_cli(x64, tmp_path, capsys):
    """A trace the reference's ``measure_phase_split`` wrote (one device,
    its v5e prediction filled) re-renders through ``python -m
    repro_torch.obs attribute TRACE`` as the reference's table; a trace
    with no such record exits 1."""
    ref_trace = ref_module("obs.trace")
    ref = ref_module("obs.attribution")
    path = str(tmp_path / "ref.jsonl")
    jprob, _, _, _ = _problems("27pt")
    mesh = ref_module("launch.mesh").make_solver_mesh(1)
    ref_trace.enable(path)
    try:
        rows = [ref.measure_phase_split(jprob, "cg", mesh, inner=1, repeats=1)]
    finally:
        ref_trace.disable()
    assert rows[0]["predicted"]["total"] is not None
    capsys.readouterr()
    assert main(["attribute", path, "--json"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "\n".join(out[:-1]) == ref.format_table(rows)
    assert json.loads(out[-1])["rows"] == json.loads(json.dumps(rows))
    empty = tmp_path / "empty.jsonl"
    empty.write_text(json.dumps(obs.make_metric("other", x=1)) + "\n")
    assert main(["attribute", str(empty)]) == 1


@pytest.mark.parametrize("f64", [True, False])
def test_one_rank_report(tracer_path, f64):
    """A one-rank report on the CPU: the phases sum to ``t_iter`` within
    1e-12, every time > 0, cg_merged prices fewer allreduces than cg, and
    every record it emits validates and gives the rows back."""
    rows = attribution.attribution_report(["cg", "cg_merged"], (8, 8, 8), Mesh.one_rank(),
                                          inner=2, repeats=2, device="cpu", f64=f64)
    for row in rows:
        m = row["measured"]
        assert m["t_iter"] == pytest.approx(m["t_halo"] + m["t_reduce"] + m["t_compute"],
                                            abs=1e-12)
        assert all(v > 0 for v in m.values()), m
        assert row["mesh"] == {"axes": ["cells"], "shape": [1], "devices": 1}
        assert row["grid"] == [8, 8, 8]
    by = {r["method"]: r for r in rows}
    assert by["cg_merged"]["counts"]["allreduces"] < by["cg"]["counts"]["allreduces"]
    assert obs.validate_stream(tracer_path) == []
    records = obs.read_trace(tracer_path)
    assert attribution.rows_from_trace(records) == json.loads(json.dumps(rows))
    spans = [r for r in records if r["kind"] == "span"]
    assert [s["attrs"]["method"] for s in spans] == ["cg", "cg_merged"]
    assert {s["name"] for s in spans} == {"attribute.measure"}


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    prob, _, _ = _port_problem()
    attribution.measure_phase_split(prob, "cg", Mesh.one_rank(), inner=1, repeats=1,
                                    profile_dir=str(tmp_path / "prof"))
    (path,) = (tmp_path / "prof").iterdir()
    assert path.name == "attribute.cg.concat.rank0.json"
    assert json.loads(path.read_text())["traceEvents"]


def test_cli_in_process(tracer_path, capsys):
    """``main(["attribute", ..., "--device", "cpu", "--json"])`` prints the
    table and the rows; re-rendering from its trace gives the same table."""
    argv = ["attribute", "--device", "cpu", "--grid", "8", "8", "8", "--methods", "cg",
            "cg_merged", "--inner", "2", "--repeats", "2", "--json"]
    assert main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    rows = json.loads(out[-1])["rows"]
    assert [r["method"] for r in rows] == ["cg", "cg_merged"]
    assert "\n".join(out[:-1]) == attribution.format_table(rows)
    assert len(out) == 2 + len(rows) + 1
    assert main(["attribute", tracer_path]) == 0
    assert capsys.readouterr().out.splitlines() == out[:-1]


# -- two gloo ranks ----------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("attrib2")
    path = str(tmp_path_factory.mktemp("attrib2_trace") / "cli.jsonl")
    prev = os.environ.get("ATTRIB_TRACE")
    os.environ["ATTRIB_TRACE"] = path
    try:
        recs = spawn(2, "attrib2", tmp)
    finally:
        if prev is None:
            os.environ.pop("ATTRIB_TRACE")
        else:
            os.environ["ATTRIB_TRACE"] = prev
    return recs, path


def test_two_ranks_get_the_same_row(ranks2):
    recs, _ = ranks2
    assert recs[0]["rows"] == recs[1]["rows"]
    for row in recs[0]["rows"]:
        m = row["measured"]
        assert row["mesh"] == {"axes": ["cells"], "shape": [2], "devices": 2}
        assert row["grid"] == list(CELLS_GRID)
        assert m["t_halo"] > 0 and m["t_reduce"] > 0 and m["t_iter"] > 0
        assert m["t_iter"] == pytest.approx(m["t_halo"] + m["t_reduce"] + m["t_compute"],
                                            abs=1e-12)


def test_two_ranks_step_trip_is_the_rows_counts(ranks2):
    """One trip of the step chain on two ranks runs the row's collectives
    and halo swaps (one split dim: one swap an exchange)."""
    recs, _ = ranks2
    for rec in recs:
        for row in rec["rows"]:
            trip = rec[("trip", row["method"])]
            assert trip["all_gather"] == row["counts"]["allreduces"]
            assert trip["exchange"] == row["counts"]["halo_exchanges"]


def test_two_ranks_cli_trace(ranks2, capsys):
    """The CLI on both ranks (the mesh of 2, then of rank 0 alone): rank 0
    alone writes each row, and the trace re-renders them."""
    recs, path = ranks2
    assert [rec["cli"] for rec in recs] == [[0, 0], [0, 0]]
    assert obs.validate_stream(path) == []
    rows = attribution.rows_from_trace(obs.read_trace(path))
    assert [r["mesh"]["devices"] for r in rows] == [2, 1]
    capsys.readouterr()
    assert main(["attribute", path]) == 0
    assert capsys.readouterr().out.strip() == attribution.format_table(rows)
