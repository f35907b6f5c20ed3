"""The port's kernel lint (``repro_torch.analysis.lint_kernels``).

Clean on the real table; each deliberately bad injected row, and each bad
ptxas report, is flagged by its own check and by no other; the table names
exactly the reference's ``KERNEL_TABLE`` rows (imported through the
harness's shim), in its order, with the same modules and plain versions.
"""

import dataclasses
from pathlib import Path

import pytest

from test_torch_harness import ref_module

from repro_torch.analysis import lint_kernels as lint
from repro_torch.analysis.violation import Violation, format_violations
from repro_torch.kernels import ops

#: a ptxas report of one clean kernel, as ``_build.py``'s ``-Xptxas -v`` writes it
CLEAN_REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelPKdPdl' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelPKdPdl
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 64 bytes smem
"""
#: a clean report of one kernel instance (``name`` its mangled name)
INSTANCE_REPORT = """\
ptxas info    : Compiling entry function '{name}' for 'sm_90a'
ptxas info    : Function properties for {name}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 21120 bytes smem
"""
#: the plane-ring pass instantiated at each run a launch may pick, in each
#: dtype the kernels take, at each stage of that dtype, f32's pair stage
#: included (``{t}``: the dtype's mangled name, ``{stage}`` the stage's code)
RING_NAME = ("_ZN5repro19stencil_ring_kernelI{t}Li27ENS_8SpmvTailIS1_Li0EEELb0ELi{stage}"
             "ELi{run}EEEvPKT_iT1_")


def _ring_report(skip=()) -> str:
    """Clean reports of every (dtype, stage, run) instance but those in
    ``skip``, whose entries are (dtype, run) (every stage of it) or (dtype,
    stage, run)."""
    return "".join(
        INSTANCE_REPORT.format(name=RING_NAME.format(
            t=t, stage=lint.RING_STAGE_CODES[stage], run=run))
        for dtype, t in lint.RING_DTYPES.items() for stage in _stages(dtype)
        for run in lint.STENCIL_CHOICES["RingRuns"]
        if (dtype, run) not in skip and (dtype, stage, run) not in skip)


def _stages(dtype: str) -> tuple[str, ...]:
    """Every stage some row's launches in ``dtype`` may take."""
    extra = lint.F32_PAIR_STAGES if dtype == "float32" else ()
    return tuple(dict.fromkeys(lint.DTYPE_STAGES[dtype] + extra))


RING_REPORT = _ring_report()


def _row(name: str) -> lint.KernelSpec:
    return next(s for s in lint.KERNEL_TABLE if s.name == name)


def _fields(found: list[Violation]) -> set[str]:
    return {v.field for v in found}


def test_lint_is_clean_on_the_real_table():
    found = lint.check_kernels()
    assert found == [], format_violations(found)


#: (row, change, the one check that must flag it)
INJECTED = {
    "missing_wrapper": ("axpbypcz", dict(name="no_such_wrapper"), "wrapper"),
    "missing_plain": ("cg_update", dict(ref="no_such_ref"), "plain"),
    "missing_source": ("gs_half_sweep", dict(source="no_such.cu"), "source"),
    "2048_threads": ("axpbypcz_dot", dict(threads=2048), "threads"),
    "shared_memory": ("fused_dots", dict(ndots=200), "static_smem"),
    "missing_counter": ("spmv", dict(kernel="no_such_counter"), "launch_counter"),
    "to_port_with_wrapper": ("cg_body", dict(status="to_port"), "status"),
    "attention_threads": ("flash_attention", dict(threads=2048), "threads"),
    "attention_dynamic_smem": ("flash_attention", dict(dynamic_smem=228 * 1024),
                               "dynamic_smem"),
    "wrong_pass": ("axpbypcz", dict(geometry="ring"), "pass"),
    "missing_batched_counter": ("cheb_step", dict(batched="no_such_counter"),
                                "launch_counter"),
}


@pytest.mark.parametrize("case", sorted(INJECTED))
def test_injected_row_is_flagged_by_its_own_check(case):
    name, change, field = INJECTED[case]
    bad = dataclasses.replace(_row(name), **change)
    found = lint.check_kernels((bad,))
    assert _fields(found) == {field}, format_violations(found)
    assert all(v.pass_name == "lint_kernels" for v in found)
    # the unchanged row is clean
    assert lint.check_kernels((_row(name),)) == []


def test_grid_limit_is_checked(monkeypatch):
    """A stencil pass whose grid outgrows ``grid.y``/``grid.z`` at the
    socket block is flagged (the CUDA kernels mask ragged edges, so this
    replaces the reference's z-block divisibility check)."""
    monkeypatch.setattr(lint, "GRIDS", ((128, 65535 * 4 + 1, 128),))
    found = lint.check_kernels((_row("gs_half_sweep"), _row("axpbypcz")))
    assert _fields(found) == {"grid"}
    assert {v.subject for v in found} == {"kernel:gs_half_sweep"}


def test_ring_rows_use_the_ring_grid(monkeypatch):
    """The rows on the plane-ring pass are held to its grid in every run a
    launch may pick (``RingRuns``: 8, 16 and 32 x-planes a block), the others
    to ``stencil_kernel``'s (kPlanesX)."""
    rows = [_row(n) for n in ("spmv", "spmv_dots3", "cheb_step", "jacobi_sweep")]
    nx = 8 * 65535 + 1            # stencil_kernel's grid.z overflows, and the ring's
    monkeypatch.setattr(lint, "GRIDS", ((nx, 128, 128),))   # in runs of 8 only
    found = lint.check_kernels(rows)
    assert _fields(found) == {"grid"} and len({v.subject for v in found}) == 4
    assert {v.detail for v in found if v.subject in ("kernel:spmv", "kernel:spmv_dots3")} \
        == {f"ring grid of the {(nx, 128, 128)} block in runs of 8"}
    monkeypatch.setitem(lint.STENCIL_CHOICES, "RingRuns", (16, 32))
    assert {v.subject for v in lint.check_kernels(rows)} == {
        "kernel:cheb_step", "kernel:jacobi_sweep"}
    monkeypatch.setattr(lint, "GRIDS", ((2 * nx, 128, 128),))
    found = lint.check_kernels(rows)
    assert _fields(found) == {"grid"} and len({v.subject for v in found}) == 4


def test_a_row_is_held_to_every_pass_its_source_launches(monkeypatch):
    """``rb_gs_half_sweep``'s row is on the ring pass, in runs of
    kRingRunRbGs x-planes, but ``rb_gs.cu`` keeps f64 7pt and f32 on
    ``stencil_kernel`` by a static rule, so the row is held to both grids,
    as ``bicgstab_fused_spmv_update``'s, whose bf16 form runs on the ring.
    A row whose source launches one pass is held to that one only."""
    assert lint.launched_passes(_row("gs_half_sweep")) == ["stencil", "ring"]
    assert lint.launched_passes(_row("spmv_dots3")) == ["ring"]
    assert lint.launched_passes(_row("bicgstab_spmv_update")) == ["stencil", "ring"]
    assert lint.launched_passes(_row("axpbypcz")) == []
    assert lint.stencil_ring_grid((128, 128, 128),
                                  run=lint.STENCIL_GEOMETRY["kRingRunRbGs"]) == (2, 32, 16)
    assert lint.choices(_row("gs_half_sweep").runs) == (8,)
    rows = (_row("gs_half_sweep"), _row("spmv_dots3"))
    monkeypatch.setitem(lint.STENCIL_CHOICES, "RingRuns", (16, 32))   # spmv_dots3 fits
    monkeypatch.setattr(lint, "GRIDS", ((8 * 65535 + 1, 128, 128),))
    found = lint.check_kernels(rows)
    assert {(v.subject, v.field) for v in found} == {("kernel:gs_half_sweep", "grid")}
    assert sorted(v.detail.split()[0] for v in found) == ["ring", "stencil"]
    monkeypatch.setitem(lint.STENCIL_GEOMETRY, "kRingRunRbGs", 16)   # the ring's fits
    found = lint.check_kernels(rows)
    assert [(v.subject, v.detail.split()[0]) for v in found] == [
        ("kernel:gs_half_sweep", "stencil")]


def test_batched_rows_fit_their_lanes(monkeypatch):
    """The three rows with a lane-batched form (the batched solve's kernels)
    count it under its own key and are also held to the grid of
    ``BATCHED_GRIDS``'s lanes, which fold into grid.z; the other rows are
    not."""
    assert {s.name: s.batched for s in lint.KERNEL_TABLE if s.batched} == {
        "spmv": "stencil_spmv_batched", "cheb_step": "cheb_fused_step_batched",
        "jacobi_sweep": "block_jacobi_sweep_batched"}
    assert lint.stencil_ring_grid((128, 128, 128), 8) == (2, 32, 64)
    assert lint.stencil_grid((128, 128, 3072), 4) == (48, 32, 64)
    rows = [_row(n) for n in ("spmv", "spmv_dots3", "jacobi_sweep", "gs_half_sweep")]
    nx = 16 * 8192 + 1            # one lane fits both passes, eight lanes neither
    monkeypatch.setattr(lint, "BATCHED_GRIDS", ((8, (nx, 128, 128)),))
    found = lint.check_kernels(rows)
    assert _fields(found) == {"grid"}
    assert {v.subject for v in found} == {"kernel:spmv", "kernel:jacobi_sweep"}
    monkeypatch.setattr(lint, "BATCHED_GRIDS", ((1, (nx, 128, 128)),))
    assert lint.check_kernels(rows) == []


def test_batched_counter_without_a_row_is_flagged(monkeypatch):
    """A lane-batched launch counter that no row claims is flagged."""
    table = tuple(dataclasses.replace(s, batched=None) if s.name == "spmv" else s
                  for s in lint.KERNEL_TABLE)
    monkeypatch.setattr(lint, "KERNEL_TABLE", table)
    found = lint.check_kernels()
    assert [(v.subject, v.field) for v in found] == [
        ("counter:stencil_spmv_batched", "table_row")]


def test_moved_rows_run_the_ring_pass():
    """``stencil_spmv`` (both rows), ``stencil_spmv_dots``,
    ``stencil_spmv_dots3`` and ``rb_gs_half_sweep`` run the plane-ring pass;
    the four other stencil rows keep ``stencil_kernel``; each row's source
    launches the pass its row names."""
    assert {s.name for s in lint.KERNEL_TABLE if s.geometry == "ring"} == {
        "spmv", "spmv_dot", "spmv_dots", "spmv_dots3", "gs_half_sweep"}
    assert {s.name for s in lint.KERNEL_TABLE if s.geometry == "stencil"} == {
        "cheb_step", "jacobi_sweep", "bicgstab_spmv_dots", "bicgstab_spmv_update"}
    for spec in lint.KERNEL_TABLE:
        if spec.geometry in lint.PASS_LAUNCH:
            assert spec.threads == (lint.RING_THREADS if spec.geometry == "ring"
                                    else lint.STENCIL_THREADS)
            assert lint.PASS_LAUNCH[spec.geometry] in lint._source_text(spec.source)


def test_ring_shared_memory_is_checked(monkeypatch):
    """The ring's plane tiles are static shared memory: a ring too deep for
    48 KiB is flagged on the rows that launch the ring pass (block-Jacobi's,
    Chebyshev's and BiCGStab's update pass for their bf16 forms), and only
    there: not on a flat pass."""
    assert lint.ring_smem_bytes() == 8 * 6 * 66 * 8
    assert lint.static_smem_bytes(_row("spmv_dots3")) == lint.ring_smem_bytes() + 3 * 8 * 8
    assert lint.static_smem_bytes(_row("spmv_dots")) == lint.ring_smem_bytes() + 2 * 8 * 8
    assert lint.static_smem_bytes(_row("jacobi_sweep")) == lint.ring_smem_bytes()
    assert lint.static_smem_bytes(_row("cheb_step")) == lint.ring_smem_bytes()
    assert lint.static_smem_bytes(_row("bicgstab_spmv_update")) == lint.ring_smem_bytes()
    assert lint.static_smem_bytes(_row("axpbypcz")) == 0
    monkeypatch.setitem(lint.STENCIL_GEOMETRY, "kRingDepth", 16)
    found = lint.check_kernels((_row("spmv"), _row("jacobi_sweep"), _row("cheb_step"),
                                _row("bicgstab_spmv_update"), _row("axpbypcz")))
    assert [(v.subject, v.field) for v in found] == [
        ("kernel:spmv", "static_smem"), ("kernel:jacobi_sweep", "static_smem"),
        ("kernel:cheb_step", "static_smem"), ("kernel:bicgstab_spmv_update", "static_smem")]


def test_ring_shared_memory_covers_the_pair_tile(monkeypatch):
    """The pair stage keeps (kRingY + 2) rows of kRingZ / 2 + 2 words a
    plane (kRingZ + 4 values, the unpadded form's tile), each word an
    element pair: f32's float2 (8 bytes) bound bf16's 32-bit words, a half
    of the f64 element tile's bytes and a little more than the f32 element
    tile's; the ring's static shared memory is the larger, and a pair tile
    that outgrew the f64 one would be counted."""
    assert lint.ring_pair_smem_bytes() == 8 * 6 * 34 * 8
    assert lint.ring_smem_bytes() == 8 * 6 * 66 * 8 > lint.ring_pair_smem_bytes()
    assert lint.ring_pair_smem_bytes() > 8 * 6 * 66 * 4 > 8 * 6 * 34 * 4
    monkeypatch.setattr(lint, "_ITEMSIZE", 1)
    assert lint.ring_smem_bytes() == lint.ring_pair_smem_bytes()


@pytest.mark.parametrize("name", ["kRingZ", "kRingY", "kRingRun", "kRingRunRbGs",
                                  "kRingRunJacobi", "kRingRunCheb", "kRingRunBicgDots",
                                  "kRingRunBicgUpdate",
                                  "kRingDepth", "kRingPairLanes", "kRingPairPacked",
                                  "kRingPairTail"])
def test_ring_geometry_drift_from_the_header_is_flagged(monkeypatch, name):
    monkeypatch.setitem(lint.STENCIL_GEOMETRY, name, lint.STENCIL_GEOMETRY[name] + 1)
    found = lint.check_kernels()
    assert [(v.subject, v.field) for v in found] == [(f"source:stencil.cuh:{name}", "geometry")]


def test_public_wrapper_without_a_row_is_flagged(monkeypatch):
    def new_kernel(x):
        return x

    new_kernel.__module__ = ops.__name__
    monkeypatch.setattr(ops, "new_kernel", new_kernel, raising=False)
    found = lint.check_kernels()
    assert [(v.subject, v.field) for v in found] == [("kernel:new_kernel", "table_row")]


def test_geometry_drift_from_the_header_is_flagged(monkeypatch):
    monkeypatch.setitem(lint.STENCIL_GEOMETRY, "kBlockZ", 32)
    found = lint.check_kernels()
    assert [(v.subject, v.field) for v in found] == [
        ("source:stencil.cuh:kBlockZ", "geometry")]


@pytest.mark.parametrize("name", ["kAttnBlockQ", "kAttnThreadsBf16", "kAttnPadF32",
                                  "kAttnWgBlockQ", "kAttnWgBlockKV", "kAttnWgStages",
                                  "kAttnWgThreads", "kAttnTfBlockQ", "kAttnTfBlockKV",
                                  "kAttnTfStages", "kAttnTfThreads", "kAttnTfPanel"])
def test_attention_geometry_drift_from_the_source_is_flagged(monkeypatch, name):
    """The attention row's threads and shared memory are computed from
    ``ATTENTION_GEOMETRY``; a constant that differs from the source's
    ``constexpr`` is flagged, and only it."""
    monkeypatch.setitem(lint.ATTENTION_GEOMETRY, name,
                        lint.ATTENTION_GEOMETRY[name] * 2)
    found = lint.check_kernels()
    assert [(v.subject, v.field) for v in found] == [
        (f"source:flash_attention.cu:{name}", "geometry")]


def test_attention_shared_memory_fits_every_head_width():
    """The largest instantiation (f32, hd = 256) is the row's dynamic shared
    memory, above the 48 KiB static limit and within Hopper's 227 KiB; the
    row's threads are the largest block, the 3xTF32 body's three
    warpgroups."""
    row = _row("flash_attention")
    assert (row.geometry, row.threads) == ("attention", 384)
    assert row.dynamic_smem == lint.attention_smem_bytes(256, "float32") == 216064
    assert lint.MAX_STATIC_SMEM < row.dynamic_smem <= lint.MAX_DYNAMIC_SMEM


#: an edit of the wgmma or 3xTF32 body's shared-memory assert -> the
#: subject flagged
SMEM_ASSERT_EDITS = {
    "hd128_clause_gone": (("&&\n                  smem_bf16_wgmma<128>() + kSmemAlign <= "
                           "kMaxDynamicSmem", ""), "smem_bf16_wgmma<128>"),
    "tf32x3_hd64_clause_gone": (("smem_f32_tf32x3<64>() + kSmemAlign <= kMaxDynamicSmem &&"
                                 "\n                  ", ""), "smem_f32_tf32x3<64>"),
    "tf32x3_hd128_clause_gone": ((" &&\n                  smem_f32_tf32x3<128>() + kSmemAlign "
                                  "<= kMaxDynamicSmem", ""), "smem_f32_tf32x3<128>"),
    "limit_not_hoppers": (("kMaxDynamicSmem = 232448;", "kMaxDynamicSmem = 262144;"),
                          "kMaxDynamicSmem"),
}


@pytest.mark.parametrize("case", sorted(SMEM_ASSERT_EDITS))
def test_wgmma_shared_memory_assert_is_required(monkeypatch, case):
    """The wgmma and 3xTF32 bodies' layouts have no mirror in the lint: the
    source's ``static_assert`` holds each to 227 KiB at each of its widths,
    and the lint flags a source without it, or with a limit other than
    Hopper's."""
    (old, new), subject = SMEM_ASSERT_EDITS[case]
    real = lint._source_text

    def edited(source):
        text = real(source)
        if source == "flash_attention.cu":
            assert old in text
            text = text.replace(old, new)
        return text

    monkeypatch.setattr(lint, "_source_text", edited)
    found = lint.check_kernels()
    assert [(v.subject, v.field) for v in found] == [
        (f"source:flash_attention.cu:{subject}", "smem_assert")]


def _write_logs(tmp_path, table, bad_stem=None, bad_text=""):
    for stem in {s.source.removesuffix(".cu") for s in table if s.status == "ported"}:
        (tmp_path / f"{stem}.log").write_text(
            bad_text if stem == bad_stem else CLEAN_REPORT + RING_REPORT)


#: a bad ptxas report of fused_axpby's source -> the check that flags it
BAD_REPORTS = {
    "spill": (CLEAN_REPORT.replace("0 bytes spill stores, 0 bytes spill loads",
                                   "24 bytes spill stores, 32 bytes spill loads"),
              "ptxas_spill"),
    "registers": (CLEAN_REPORT.replace("Used 40 registers", "Used 256 registers"),
                  "ptxas_registers"),
    "shared_memory": (CLEAN_REPORT.replace("64 bytes smem", "65536 bytes smem"),
                      "ptxas_smem"),
    "no_report": ("ptxas info    : 0 bytes gmem\n", "ptxas_log"),
}


def test_clean_ptxas_reports_pass(tmp_path):
    _write_logs(tmp_path, lint.KERNEL_TABLE)
    assert lint.check_kernels(build_dir=tmp_path) == []


@pytest.mark.parametrize("case", sorted(BAD_REPORTS))
def test_bad_ptxas_report_is_flagged_by_its_own_check(tmp_path, case):
    text, field = BAD_REPORTS[case]
    _write_logs(tmp_path, lint.KERNEL_TABLE, "fused_axpby", text)
    found = lint.check_kernels(build_dir=tmp_path)
    assert _fields(found) == {field}, format_violations(found)
    assert all(v.subject.startswith("ptxas:fused_axpby") for v in found)


def test_ring_source_without_a_ring_report_is_flagged(tmp_path):
    """A source whose rows run the plane-ring pass (``spmv_dot.cu``,
    ``rb_gs.cu``) must report its instantiations; one that reports only other
    kernels is flagged, once for each dtype.  ``precond.cu`` runs its two
    sweeps' f64, f32 and bf16 forms on the ring (all in runs of 8), so it is
    flagged once for each of those three, and ``bicgstab_fused.cu`` only its
    dots pass's bf16 form, so it is flagged once, for bf16.  A source with
    no stencil pass (``cg_fused_update.cu``) is not."""
    for stem in ("spmv_dot", "rb_gs"):
        _write_logs(tmp_path, lint.KERNEL_TABLE, stem, CLEAN_REPORT)
        found = lint.check_kernels(build_dir=tmp_path)
        assert [(v.subject, v.field) for v in found] == \
            [(f"ptxas:{stem}", "ptxas_ring")] * len(lint.RING_DTYPES)
        assert [d for d in lint.RING_DTYPES if any(d in v.expected for v in found)] == \
            list(lint.RING_DTYPES)
    for stem, dtypes in (("precond", ("float64", "float32", "bfloat16")),
                         ("bicgstab_fused", ("bfloat16",))):
        _write_logs(tmp_path, lint.KERNEL_TABLE, stem, CLEAN_REPORT)
        found = lint.check_kernels(build_dir=tmp_path)
        assert [(v.subject, v.field, v.actual) for v in found] == [
            (f"ptxas:{stem}", "ptxas_ring", "none at [8]")] * len(dtypes)
        assert [d for v, d in zip(found, dtypes) if d in v.expected] == list(dtypes)
    _write_logs(tmp_path, lint.KERNEL_TABLE, "cg_fused_update", CLEAN_REPORT)
    assert lint.check_kernels(build_dir=tmp_path) == []


def test_a_missing_instance_is_flagged(tmp_path):
    """Each run a ring row may pick has its own instance in the report, in
    each dtype the kernels take: a report without the bf16 run of 32 is
    flagged by its own check, naming what is missing."""
    no_32 = CLEAN_REPORT + _ring_report(skip={("bfloat16", 32)})
    _write_logs(tmp_path, lint.KERNEL_TABLE, "stencil_spmv", no_32)
    found = lint.check_kernels(build_dir=tmp_path)
    assert [(v.subject, v.field, v.actual) for v in found] == [
        ("ptxas:stencil_spmv", "ptxas_ring", "none at [32]")]
    assert "bfloat16" in found[0].expected
    assert lint.instances(_row("spmv_dots")) == (8, 16, 32)
    assert lint.instances(_row("gs_half_sweep")) == (8,)
    assert lint.instances(_row("cg_body")) == ()
    assert lint.instances(_row("axpbypcz")) == ()


def test_a_missing_stage_is_flagged(tmp_path):
    """A bf16 launch may take the register stage or either form of the
    pair stage (``ring_stage``), each its own instance: a report of
    ``precond.cu`` (block-Jacobi's bf16 form, runs of kRingRunJacobi) without the
    unpadded pair stage, or ``stencil_spmv.cu``'s without the register
    stage at run 8, is flagged by the stage check alone; f64 and f32 need
    only the element stage."""
    assert lint.DTYPE_STAGES["bfloat16"] == ("kStageRegister", "kStagePairPadded",
                                            "kStagePairUnpadded")
    assert lint.DTYPE_STAGES["float64"] == lint.DTYPE_STAGES["float32"] == ("kStageAsync",)
    for stem, skip, want in (
            ("precond", ("bfloat16", "kStagePairUnpadded", 8), "none at [8]"),
            ("stencil_spmv", ("bfloat16", "kStageRegister", 8), "none at [8]")):
        _write_logs(tmp_path, lint.KERNEL_TABLE)
        _write_logs(tmp_path, [s for s in lint.KERNEL_TABLE if s.source == f"{stem}.cu"],
                    stem, CLEAN_REPORT + _ring_report(skip={skip}))
        found = lint.check_kernels(build_dir=tmp_path)
        assert [(v.subject, v.field, v.actual) for v in found] == [
            (f"ptxas:{stem}", "ptxas_stage", want)], format_violations(found)
        assert skip[1] in found[0].expected and "bfloat16" in found[0].expected


def test_f32_pair_rows_need_their_pair_stages(tmp_path):
    """``precond.cu``'s two sweeps take f32's pair stage (``f32_pairs``):
    their f32 instances are the pair stage's two forms, which a report must
    hold (one without the unpadded form is flagged by the stage check
    alone), and no f32 element-stage instance, which their launches never
    take; ``stencil_spmv.cu``'s f32 rows keep needing the element stage."""
    assert lint.F32_PAIR_STAGES == ("kStagePairPadded", "kStagePairUnpadded")
    assert [s.name for s in lint.KERNEL_TABLE if s.f32_pairs] == ["cheb_step", "jacobi_sweep"]
    assert lint.ring_stages(_row("spmv"), "float32") == ("kStageAsync",)
    assert lint.ring_stages(_row("cheb_step"), "bfloat16") == lint.DTYPE_STAGES["bfloat16"]
    rows = [s for s in lint.KERNEL_TABLE if s.source == "precond.cu"]
    _write_logs(tmp_path, lint.KERNEL_TABLE)
    _write_logs(tmp_path, rows, "precond", CLEAN_REPORT + _ring_report(
        skip={("float32", "kStageAsync", 8)}))
    assert lint.check_kernels(build_dir=tmp_path) == []
    _write_logs(tmp_path, rows, "precond", CLEAN_REPORT + _ring_report(
        skip={("float32", "kStagePairUnpadded", 8)}))
    found = lint.check_kernels(build_dir=tmp_path)
    assert [(v.subject, v.field, v.actual) for v in found] == [
        ("ptxas:precond", "ptxas_stage", "none at [8]")], format_violations(found)
    assert "kStagePairUnpadded" in found[0].expected and "float32" in found[0].expected
    _write_logs(tmp_path, lint.KERNEL_TABLE)
    _write_logs(tmp_path, [_row("spmv")], "stencil_spmv", CLEAN_REPORT + _ring_report(
        skip={("float32", "kStageAsync", 16)}))
    found = lint.check_kernels(build_dir=tmp_path)
    assert [(v.subject, v.field) for v in found] == [("ptxas:stencil_spmv", "ptxas_stage")]


def test_jacobi_row_names_both_passes(monkeypatch):
    """``block_jacobi_sweep`` runs f64 and bf16 on the plane ring and f32
    on the ring's pair stage where its operands allow it, on
    ``stencil_kernel`` otherwise (``precond.cu``'s ``on_ring``, mirrored by
    ``kernels.precond.JACOBI_RING_DTYPES`` and ``jacobi_pass``): its row
    names both passes, bf16, f32 and f64 as its ring dtypes (f32 at the pair
    stage alone, ``f32_pairs``), in runs of kRingRunJacobi, and is held to
    both grids; a ``precond.cu`` that no longer launches the ring is flagged
    on it and on ``cheb_fused_step``, whose forms share the rule's pass."""
    import torch

    from repro_torch.kernels import precond
    spec = _row("jacobi_sweep")
    assert lint.launched_passes(spec) == ["stencil", "ring"]
    assert spec.ring_dtypes == tuple(str(d)[6:] for d in precond.JACOBI_RING_DTYPES)
    assert spec.f32_pairs and lint.ring_stages(spec, "float32") == lint.F32_PAIR_STAGES
    assert lint.instances(spec) == (lint.STENCIL_GEOMETRY["kRingRunJacobi"],) == (8,)
    assert precond.jacobi_pass(torch.bfloat16) == precond.jacobi_pass(torch.float32) \
        == precond.jacobi_pass(torch.float64) == precond.jacobi_pass(torch.float64, nz=7) \
        == "ring"
    assert precond.jacobi_pass(torch.float32, nz=7) == "stencil"
    text = lint._source_text
    monkeypatch.setattr(lint, "_source_text", lambda source: text(source).replace(
        "launch_stencil_ring<", "launch_stencil<") if source == "precond.cu" else text(source))
    found = lint.check_kernels()
    assert [(v.subject, v.field) for v in found] == [("kernel:cheb_step", "pass"),
                                                     ("kernel:jacobi_sweep", "pass")]
    assert all("launch_stencil_ring<" in v.expected for v in found)


@pytest.mark.parametrize("row, rule, run", [
    ("cheb_step", "CHEB_RING_DTYPES", "kRingRunCheb"),
    ("bicgstab_spmv_dots", "DOTS_RING_DTYPES", "kRingRunBicgDots"),
    ("bicgstab_spmv_update", "UPDATE_RING_DTYPES", "kRingRunBicgUpdate")])
def test_bf16_ring_rows_name_both_passes(monkeypatch, row, rule, run):
    """``cheb_fused_step`` and BiCGStab's two passes run bf16 on the plane
    ring, and f32 on the old pass but for the Chebyshev step's launches that
    take the ring's pair stage; f64 on the ring for the Chebyshev step and on
    ``stencil_kernel`` for BiCGStab (the static rules ``on_ring``,
    ``bicgstab_dots_on_ring`` and ``bicgstab_update_on_ring``, mirrored in
    ``kernels.precond`` and ``kernels.bicgstab_fused``): each row names both
    passes, its ring dtypes (bf16, and f32 and f64 for the Chebyshev step),
    in runs of its own constant,
    with the ring's shared memory (and the dots row's nine partials), and a
    source that no longer launches the ring is flagged on it."""
    from repro_torch.kernels import bicgstab_fused, precond
    spec = _row(row)
    mirror = precond if row == "cheb_step" else bicgstab_fused
    assert lint.launched_passes(spec) == ["stencil", "ring"]
    assert spec.ring_dtypes == tuple(str(d)[6:] for d in getattr(mirror, rule)) \
        == (("bfloat16", "float32", "float64") if row == "cheb_step" else ("bfloat16",))
    assert spec.f32_pairs == (row == "cheb_step")
    assert lint.instances(spec) == (lint.STENCIL_GEOMETRY[run],)
    assert lint.static_smem_bytes(spec) == max(
        lint.ring_smem_bytes() + spec.ndots * spec.threads // 32 * 8,
        spec.ndots * lint.REDUCE_THREADS // 32 * 8) if spec.ndots else lint.ring_smem_bytes()
    text = lint._source_text
    monkeypatch.setattr(lint, "_source_text", lambda source: text(source).replace(
        "launch_stencil_ring<", "launch_stencil<") if source == spec.source
        else text(source))
    found = lint.check_kernels((spec,))
    assert [(v.subject, v.field) for v in found] == [(f"kernel:{row}", "pass")]


@pytest.mark.parametrize("name", sorted(lint.RING_STAGE_CODES))
def test_ring_stage_code_drift_from_the_header_is_flagged(monkeypatch, name):
    """The stage codes the ptxas check reads from an instance's mangled name
    are held against ``csrc/stencil.cuh``'s constants."""
    monkeypatch.setitem(lint.RING_STAGE_CODES, name, lint.RING_STAGE_CODES[name] + 4)
    found = lint.check_kernels()
    assert [(v.subject, v.field) for v in found] == [(f"source:stencil.cuh:{name}", "stage")]


def test_launch_choices_drift_from_the_header_is_flagged(monkeypatch):
    """``STENCIL_CHOICES`` is held against ``csrc/stencil.cuh``'s
    ``std::integer_sequence`` sets, and against ``kernels.autotune``'s
    candidates."""
    from repro_torch.kernels import autotune
    assert lint.STENCIL_CHOICES == {"RingRuns": autotune.RUN_CANDIDATES}
    for name in lint.STENCIL_CHOICES:
        monkeypatch.setitem(lint.STENCIL_CHOICES, name, (8, 16))
        found = lint.check_kernels()
        assert [(v.subject, v.field) for v in found] == [
            (f"source:stencil.cuh:{name}", "geometry")]
        monkeypatch.undo()


def test_missing_ptxas_log_is_flagged(tmp_path):
    _write_logs(tmp_path, lint.KERNEL_TABLE)
    (tmp_path / "rb_gs.log").unlink()
    found = lint.check_ptxas(tmp_path)
    assert [(v.subject, v.field) for v in found] == [("ptxas:rb_gs", "ptxas_log")]


def test_table_names_exactly_the_reference_rows():
    """Row for row, in order: the reference's wrapper, module and oracle
    names; every row is ported, no row is left ``to_port``."""
    jrows = ref_module("analysis.lint_kernels").KERNEL_TABLE
    assert len(lint.KERNEL_TABLE) == len(jrows) == 19
    assert [(s.name, s.module, s.ref) for s in lint.KERNEL_TABLE] == [
        (s.name, s.module, s.ref) for s in jrows]
    assert [s.name for s in lint.KERNEL_TABLE if s.status != "ported"] == []
    # 18 pallas_call functions: spmv and spmv_dot share one
    assert len({s.kernel for s in lint.KERNEL_TABLE if s.status == "ported"}) == 18


def test_every_reference_kernel_module_has_a_ported_source():
    """Every module of the reference's kernel layer holding a ``pallas_call``
    is the module of some row; every row, flash_attention's included, is
    ported to a CUDA source that exists."""
    kernels_dir = Path(ref_module("kernels").__file__).parent
    modules = {p.stem for p in kernels_dir.glob("*.py")
               if p.name != "__init__.py" and "pallas_call" in p.read_text()}
    assert modules == {s.module for s in lint.KERNEL_TABLE}
    for spec in lint.KERNEL_TABLE:
        assert spec.status == "ported" and (lint.CSRC / spec.source).is_file()
