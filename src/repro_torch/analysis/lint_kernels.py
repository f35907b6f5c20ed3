"""Static checks over the port's CUDA kernel layer (no kernel executes).

Counterpart of ``repro/analysis/lint_kernels.py``, with Hopper's launch
limits in place of the TPU's 16 MiB VMEM budget.  Four families of checks:

* **Completeness**: one table row per row of the reference's
  ``KERNEL_TABLE`` (19 rows, 18 ``pallas_call`` functions).  Each ported row's
  wrapper exists in ``repro_torch.kernels.ops``, its plain version in
  ``repro_torch.kernels.ref``, its CUDA source under ``kernels/csrc/``, its
  launch counter in ``ops.LAUNCHES`` (and its lane-batched form's, where it
  has one), and some ``tests/test_torch_*.py``
  references ``ops.<name>``.  On the real table also: every public wrapper in
  ``ops`` has a row, every ``fused_kernels`` hook a ``MethodDef`` declares is
  a ported row, every source and every launch counter belongs to a row, and
  the launch geometries below are the ones ``csrc/stencil.cuh`` and
  ``csrc/flash_attention.cu`` fix.

* **Launch limits**: a row's threads per block are at most 1024, its static
  shared memory per block (``block_sum``'s per-warp partials, in its own
  kernel and in ``reduce_partials``) at most 48 KiB, and its dynamic shared
  memory per block (the attention kernel's staged tiles, at the largest
  instantiation of its FFMA and mma.sync bodies) at most Hopper's 227 KiB;
  the wgmma and 3xTF32 bodies' layouts are bounded by ``static_assert``
  in their source, whose presence is checked.  The plane-ring pass's static
  shared memory is its ring of plane tiles (f64 elements, or on its pair
  stage element pairs: bf16's in 32-bit words, f32's in 8-byte float2,
  whichever is larger) plus ``block_sum``'s partials.
  The reference's z-block divisibility check has no counterpart (the CUDA
  kernels mask ragged edges); in its place the grid of each stencil pass a
  row launches (the pass its row names, and any other its source launches)
  must fit (``grid.y`` and ``grid.z`` at most 65535) at the rank block 128³
  and the socket block 128×128×3072, in every run its source instantiates
  (``STENCIL_CHOICES``), for a row with a lane-batched form also at 4 and 8
  lanes of each (the lanes fold into ``grid.z``; that form marches
  ``kRingRun``, or the row's own run), and a row's source must launch every
  pass its row names
  (``passes``: a row whose source's static rule sends some dtypes or
  stencils to the other pass names both: ``rb_gs.cu``'s half-sweep,
  ``precond.cu``'s two sweeps (bf16 and f64 on the ring, f32 on either) and
  the bf16 forms of ``bicgstab_fused.cu``'s two passes).

* **The build's ptxas reports** (given a build directory): each
  ``<source>.log`` that ``kernels/_build.py`` writes must report every
  kernel with no spill store or load, at most 255 registers and at most
  48 KiB of static shared memory (every instance of a kernel reports on its
  own, so every run and every dtype is checked, the bf16 instances
  included), and a source must report an instance of each run its rows on
  the plane-ring pass may pick (``stencil_ring_kernel``) in each dtype its
  rows take there (:data:`RING_DTYPES`, or the row's ``ring_dtypes``), at
  each stage that dtype's launches may take (:data:`DTYPE_STAGES`: bf16's
  register stage and both forms of its pair stage; in f32 a row whose tail
  takes f32's pair stage, ``f32_pairs``, the pair stage's two forms in place
  of the element stage, :data:`F32_PAIR_STAGES`).

The table is declarative so tests can inject a deliberately bad row and
assert that its own check, and only that one, flags it.  Nothing here
imports ``repro``.
"""

from __future__ import annotations

import dataclasses
import inspect
import math
import re
from pathlib import Path

from repro_torch.analysis.violation import Violation

PASS = "lint_kernels"

#: Hopper's limits (CUDA C++ programming guide, compute capability 9.0)
MAX_THREADS = 1024
MAX_STATIC_SMEM = 48 * 1024
MAX_DYNAMIC_SMEM = 227 * 1024
MAX_GRID_YZ = 65535
MAX_REGISTERS = 255

#: the launch geometry of ``csrc/stencil.cuh`` (held against the header):
#: the stencil pass's block is kBlockZ × kBlockY threads, each walking
#: kPlanesX x-planes; the plane-ring pass's block is kRingZ × kRingY threads
#: marching kRingRun x-planes by default (kRingRunRbGs for the half-sweep's
#: tail, and in bf16 kRingRunJacobi for the block-Jacobi tail, kRingRunCheb
#: for the Chebyshev tail, kRingRunBicgDots and kRingRunBicgUpdate for
#: BiCGStab's dots and update tails; the same runs for f32's and f64's two
#: sweeps)
#: through a ring of kRingDepth plane tiles of (kRingY + 2) × (kRingZ + 2)
#: elements, or on the pair stage (bf16's, and f32's for the two sweeps)
#: kRingZ / kRingPairLanes × kRingY threads, each summing kRingPairLanes
#: z-outputs (bf16 in bf16x2 when kRingPairPacked, f32 as scalar chains) and
#: handing both to a tail with a pair form in one call (kRingPairTail),
#: through tiles of (kRingY + 2) rows of kRingZ / kRingPairLanes + 2 words of
#: an element pair each (32-bit in bf16, 8-byte float2 in f32); flat passes
#: and ``reduce_partials`` are 1-D blocks
STENCIL_GEOMETRY = {"kBlockZ": 64, "kBlockY": 4, "kPlanesX": 8,
                    "kRingZ": 64, "kRingY": 4, "kRingRun": 16, "kRingRunRbGs": 8,
                    "kRingRunJacobi": 8, "kRingRunCheb": 8, "kRingRunBicgDots": 8,
                    "kRingRunBicgUpdate": 8, "kRingDepth": 8, "kRingPairLanes": 2,
                    "kRingPairPacked": 1, "kRingPairTail": 1, "kFlatThreads": 256,
                    "kReduceThreads": 1024}
#: the launch geometries a launch may pick at run time (``kernels.autotune``
#: tunes them), held against the ``std::integer_sequence`` of each name in
#: ``csrc/stencil.cuh``: the runs of the ring pass under ``stencil_spmv``,
#: ``stencil_spmv_dots`` and ``stencil_spmv_dots3`` (one instance each)
STENCIL_CHOICES = {"RingRuns": (8, 16, 32)}
STENCIL_THREADS = STENCIL_GEOMETRY["kBlockZ"] * STENCIL_GEOMETRY["kBlockY"]
RING_THREADS = STENCIL_GEOMETRY["kRingZ"] * STENCIL_GEOMETRY["kRingY"]
FLAT_THREADS = STENCIL_GEOMETRY["kFlatThreads"]
REDUCE_THREADS = STENCIL_GEOMETRY["kReduceThreads"]
#: the grids the stencil pass must launch on: the paper's per-rank block
#: and its per-socket hybrid block
GRIDS = ((128, 128, 128), (128, 128, 3072))
#: the (lanes, grid) pairs a row's lane-batched form must launch at: the
#: serve layer's largest batch (4) and 8, of each of GRIDS
BATCHED_GRIDS = tuple((lanes, grid) for lanes in (4, 8) for grid in GRIDS)
#: bytes of one partial or ring element in shared memory (the f64
#: instantiation, the widest: f32 and bf16 partials take 4 bytes, their ring
#: elements 4 and 2, so the f64 figure bounds every instance)
_ITEMSIZE = 8
#: bytes of one word of the pair stage's tile: an element pair, the widest
#: f32's (a float2; bf16's pair is a 32-bit word)
_PAIR_WORD = 8
#: the dtypes the solver kernels are instantiated in, each with its
#: first template argument in the Itanium mangling of an instance
RING_DTYPES = {"float64": "d", "float32": "f", "bfloat16": "13__nv_bfloat16"}
#: the ring pass's stage codes (its STAGE template argument), held against
#: ``csrc/stencil.cuh``
RING_STAGE_CODES = {"kStageAsync": 0, "kStageRegister": 1, "kStagePairPadded": 2,
                    "kStagePairUnpadded": 3}
#: the stages a launch of the ring pass may take in each dtype (its
#: ``ring_stages``): f32 and f64 copy elements; bf16 stages through registers
#: or copies pairs from either operand form
DTYPE_STAGES = {"float64": ("kStageAsync",), "float32": ("kStageAsync",),
               "bfloat16": ("kStageRegister", "kStagePairPadded", "kStagePairUnpadded")}
#: the stages of an f32 tail that takes f32's pair stage (``f32_pair_tail``,
#: a row's ``f32_pairs``): the pair stage's two forms, its only instances (an
#: f32 launch it does not take stays on ``stencil_kernel``)
F32_PAIR_STAGES = ("kStagePairPadded", "kStagePairUnpadded")

#: the launch geometry of ``csrc/flash_attention.cu`` (held against the
#: source).  The FFMA and mma.sync bodies: a block owns kAttnBlockQ query
#: rows and stages kAttnBlockKV keys a tile (kAttnBlockKVWide for bf16 at
#: hd = 256) in dynamic shared memory, rows padded by kAttnPadF32 floats or
#: kAttnPadBf16 bf16 values.  The wgmma body: kAttnWgThreads threads (two
#: warpgroups) own kAttnWgBlockQ query rows, with a ring of kAttnWgStages
#: tiles of kAttnWgBlockKV keys.  The 3xTF32 body: kAttnTfThreads threads
#: (two consumer warpgroups and a producer) own kAttnTfBlockQ query rows, with
#: a ring of kAttnTfStages tiles of kAttnTfBlockKV keys in panels of
#: kAttnTfPanel f32 columns
ATTENTION_GEOMETRY = {"kAttnBlockQ": 64, "kAttnBlockKV": 64, "kAttnBlockKVWide": 32,
                      "kAttnThreadsF32": 256, "kAttnThreadsBf16": 128,
                      "kAttnPadF32": 4, "kAttnPadBf16": 8,
                      "kAttnWgBlockQ": 128, "kAttnWgBlockKV": 128, "kAttnWgStages": 2,
                      "kAttnWgThreads": 256,
                      "kAttnTfBlockQ": 128, "kAttnTfBlockKV": 32, "kAttnTfStages": 2,
                      "kAttnTfThreads": 384, "kAttnTfPanel": 32}
ATTENTION_THREADS = max(ATTENTION_GEOMETRY["kAttnThreadsF32"],
                        ATTENTION_GEOMETRY["kAttnThreadsBf16"],
                        ATTENTION_GEOMETRY["kAttnWgThreads"],
                        ATTENTION_GEOMETRY["kAttnTfThreads"])

KERNELS_DIR = Path(__file__).resolve().parents[1] / "kernels"
CSRC = KERNELS_DIR / "csrc"
TESTS_DIR = Path(__file__).resolve().parents[3] / "tests"


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One audited kernel: its wrapper, the TPU kernel it replaces, its plain
    version, and the static facts the checks run on."""

    name: str                     # public wrapper in repro_torch.kernels.ops
    module: str                   # repro/kernels/<module>.py with the pallas_call
    ref: str                      # plain version in repro_torch.kernels.ref
    kernel: str | None = None     # its key in ops.LAUNCHES
    source: str | None = None     # its CUDA source under kernels/csrc/
    geometry: str = "flat"        # "stencil" (stencil.cuh's stencil_kernel),
                                  # "ring" (its stencil_ring_kernel), "flat"
                                  # or "attention" (flash_attention.cu)
    threads: int = FLAT_THREADS   # threads per block of its own kernel
    ndots: int = 0                # partials (a reduce_partials launch when > 0)
    status: str = "ported"        # "ported" or "to_port"
    dynamic_smem: int = 0         # bytes of dynamic shared memory per block
    batched: str | None = None    # the key in ops.LAUNCHES of its lane-batched
                                  # form (one launch over B lanes), if any
    runs: str = "RingRuns"        # its runs of x-planes on the ring pass: a
                                  # STENCIL_CHOICES set or a STENCIL_GEOMETRY
                                  # constant
    entry: str | None = None      # the __global__ whose instances (one a run)
                                  # its ptxas report must list
    passes: tuple[str, ...] | None = None   # the stencil passes it launches
                                  # when not its geometry's alone (its
                                  # source's static rule), in PASS_LAUNCH order
    ring_dtypes: tuple[str, ...] | None = None   # the dtypes it runs on the
                                  # plane-ring pass when not all of RING_DTYPES
    f32_pairs: bool = False       # its f32 tail takes f32's pair stage
                                  # (stencil.cuh's f32_pair_tail)


def _stencil(name, module, ref, kernel, source, ndots=0, batched=None,
             ring_dtypes=None, runs="kRingRun", f32_pairs=False) -> KernelSpec:
    """A row on ``stencil_kernel``; with ``ring_dtypes`` its source's static
    rule puts those dtypes on the plane-ring pass, in runs of ``runs`` (f32
    at the pair stage alone with ``f32_pairs``)."""
    if ring_dtypes is None:
        return KernelSpec(name, module, ref, kernel, source, "stencil", STENCIL_THREADS,
                          ndots, batched=batched)
    return KernelSpec(name, module, ref, kernel, source, "stencil",
                      max(STENCIL_THREADS, RING_THREADS), ndots, batched=batched,
                      runs=runs, entry="stencil_ring_kernel",
                      passes=("stencil", "ring"), ring_dtypes=ring_dtypes,
                      f32_pairs=f32_pairs)


def _ring(name, module, ref, kernel, source, ndots=0, batched=None,
          runs="RingRuns", passes=None) -> KernelSpec:
    return KernelSpec(name, module, ref, kernel, source, "ring", RING_THREADS, ndots,
                      batched=batched, runs=runs, entry="stencil_ring_kernel",
                      passes=passes)


def _flat(name, module, ref, kernel, source, ndots=0) -> KernelSpec:
    return KernelSpec(name, module, ref, kernel, source, "flat", FLAT_THREADS, ndots)


def choices(name: str) -> tuple[int, ...]:
    """The values of a ``STENCIL_CHOICES`` set, or of one
    ``STENCIL_GEOMETRY`` constant."""
    return STENCIL_CHOICES[name] if name in STENCIL_CHOICES else (STENCIL_GEOMETRY[name],)


def instances(spec: KernelSpec) -> tuple[int, ...]:
    """The runs of the row's ``entry`` its source must instantiate."""
    return choices(spec.runs) if spec.entry else ()


def attention_smem_bytes(hd: int, dtype: str) -> int:
    """Dynamic shared memory of one block of the FFMA and mma.sync bodies of
    ``csrc/flash_attention.cu`` (its ``smem_f32``/``smem_bf16``, which this
    mirrors: the lint is the one check of them against the limit) at head
    width ``hd``: f32 stages Q and K in padded rows, V, and p in padded rows;
    bf16 stages Q and K in padded rows of hd (at least 16, the mma's depth)
    and Vᵀ in padded rows.  The wgmma and 3xTF32 bodies' layouts have no
    mirror here: ``static_assert`` lines in the source hold them
    (:func:`check_wgmma_smem_assert`)."""
    g = ATTENTION_GEOMETRY
    bq = g["kAttnBlockQ"]
    if dtype == "float32":
        bkv, pad = g["kAttnBlockKV"], g["kAttnPadF32"]
        return ((bq + bkv) * (hd + pad) + bkv * hd + bq * (bkv + pad)) * 4
    bkv = g["kAttnBlockKVWide"] if hd == 256 else g["kAttnBlockKV"]
    pad = g["kAttnPadBf16"]
    return ((bq + bkv) * (max(hd, 16) + pad) + hd * (bkv + pad)) * 2


def _attention(name, module, ref, kernel, source) -> KernelSpec:
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    smem = max(attention_smem_bytes(hd, dt) for hd in HEAD_DIMS
               for dt in ("float32", "bfloat16"))
    return KernelSpec(name, module, ref, kernel, source, "attention", ATTENTION_THREADS,
                      dynamic_smem=smem)


#: one row per row of the reference's KERNEL_TABLE, in its order
KERNEL_TABLE: tuple[KernelSpec, ...] = (
    _ring("spmv", "stencil_spmv", "stencil_spmv_ref", "stencil_spmv", "stencil_spmv.cu",
          batched="stencil_spmv_batched"),
    _ring("spmv_dot", "stencil_spmv", "stencil_spmv_dot_ref", "stencil_spmv",
          "stencil_spmv.cu", ndots=1),
    _ring("spmv_dots", "spmv_dot", "stencil_spmv_dots_ref", "stencil_spmv_dots",
          "spmv_dot.cu", ndots=2),
    _flat("cg_update", "cg_fused_update", "cg_fused_update_ref", "cg_fused_update",
          "cg_fused_update.cu", ndots=1),
    _flat("cg_body", "cg_fused_update", "fused_cg_body_ref", "fused_cg_body",
          "cg_fused_update.cu"),
    _flat("axpbypcz", "fused_axpby", "fused_axpby_ref", "fused_axpby", "fused_axpby.cu"),
    _flat("axpbypcz_dot", "fused_axpby", "fused_axpby_dot_ref", "fused_axpby_dot",
          "fused_axpby.cu", ndots=1),
    # f64 27pt and bf16 (both stencils) on the ring, f64 7pt and f32 on
    # stencil_kernel (rb_gs.cu's on_ring)
    _ring("gs_half_sweep", "rb_gs", "rb_gs_half_sweep_ref", "rb_gs_half_sweep",
          "rb_gs.cu", runs="kRingRunRbGs", passes=("stencil", "ring")),
    # bf16 and f64 on the ring, f32 on the ring's pair stage where the
    # operands allow it and on stencil_kernel otherwise (precond.cu's
    # on_ring; stencil_kernel also the old_pass yardstick in f64)
    _stencil("cheb_step", "precond", "cheb_fused_step_ref", "cheb_fused_step",
             "precond.cu", batched="cheb_fused_step_batched",
             ring_dtypes=("bfloat16", "float32", "float64"), runs="kRingRunCheb",
             f32_pairs=True),
    # the same rule (precond.cu's on_ring)
    _stencil("jacobi_sweep", "precond", "block_jacobi_sweep_ref", "block_jacobi_sweep",
             "precond.cu", batched="block_jacobi_sweep_batched",
             ring_dtypes=("bfloat16", "float32", "float64"), runs="kRingRunJacobi",
             f32_pairs=True),
    _attention("flash_attention", "flash_attention", "flash_attention_ref",
               "flash_attention", "flash_attention.cu"),
    _ring("spmv_dots3", "spmv_dot", "stencil_spmv_dots3_ref", "stencil_spmv_dots3",
          "spmv_dot.cu", ndots=3),
    _flat("fused_dots", "fused_bodies", "fused_dots_ref", "fused_dots", "fused_bodies.cu",
          ndots=3),
    _flat("pipe_body", "fused_bodies", "fused_pipe_body_ref", "fused_pipe_body",
          "fused_bodies.cu"),
    _flat("pcg_body", "fused_bodies", "fused_pcg_body_ref", "fused_pcg_body",
          "fused_bodies.cu"),
    _flat("ppipe_body", "fused_bodies", "fused_ppipe_body_ref", "fused_ppipe_body",
          "fused_bodies.cu"),
    _flat("bicgstab_update1", "fused_bodies", "bicgstab_update1_ref",
          "bicgstab_fused_update1", "fused_bodies.cu"),
    # f64 and f32 on stencil_kernel, bf16 on the ring (bicgstab_fused.cu's
    # bicgstab_dots_on_ring)
    _stencil("bicgstab_spmv_dots", "bicgstab_fused", "bicgstab_spmv_dots_ref",
             "bicgstab_fused_spmv_dots", "bicgstab_fused.cu", ndots=9,
             ring_dtypes=("bfloat16",), runs="kRingRunBicgDots"),
    # f64 and f32 on stencil_kernel, bf16 on the ring (bicgstab_fused.cu's
    # bicgstab_update_on_ring)
    _stencil("bicgstab_spmv_update", "bicgstab_fused", "bicgstab_spmv_update_ref",
             "bicgstab_fused_spmv_update", "bicgstab_fused.cu",
             ring_dtypes=("bfloat16",), runs="kRingRunBicgUpdate"),
)

#: public names in kernels.ops that are no kernel wrapper
_EXEMPT_WRAPPERS = {
    "make_matvec_padded",   # a factory closing over `spmv` (tabled)
    "reset_launches",       # the launch counters' reset
}


def ring_pair_smem_bytes() -> int:
    """The pair stage's ring: kRingDepth plane tiles of (kRingY + 2) rows of
    kRingZ / kRingPairLanes + 2 words of an element pair (kRingZ + 4
    values), in f32's float2 words (which bound bf16's 32-bit ones)."""
    g = STENCIL_GEOMETRY
    return (g["kRingDepth"] * (g["kRingY"] + 2) * (g["kRingZ"] // g["kRingPairLanes"] + 2)
            * _PAIR_WORD)


def ring_smem_bytes() -> int:
    """The plane-ring pass's ring: kRingDepth plane tiles of (kRingY + 2) ×
    (kRingZ + 2) elements in the f64 instantiation (which bounds the f32
    element stage's and bf16's register stage's), or the pair stage's
    tiles, whichever is larger."""
    g = STENCIL_GEOMETRY
    element = g["kRingDepth"] * (g["kRingY"] + 2) * (g["kRingZ"] + 2) * _ITEMSIZE
    return max(element, ring_pair_smem_bytes())


def static_smem_bytes(spec: KernelSpec) -> int:
    """Static shared memory of the row's largest block: ``block_sum`` keeps
    one partial per warp and dot, in the row's own kernel and in
    ``reduce_partials``; a row on the plane-ring pass adds its ring."""
    ring = ring_smem_bytes() if "ring" in launched_passes(spec) else 0
    if not spec.ndots:
        return ring
    own = ring + spec.ndots * spec.threads // 32 * _ITEMSIZE
    return max(own, spec.ndots * REDUCE_THREADS // 32 * _ITEMSIZE)


def stencil_grid(shape, lanes: int = 1) -> tuple[int, int, int]:
    """``stencil_grid`` of ``csrc/stencil.cuh`` for ``lanes`` stacked
    (nx, ny, nz) blocks (the lanes fold into grid.z)."""
    nx, ny, nz = shape
    g = STENCIL_GEOMETRY
    return (math.ceil(nz / g["kBlockZ"]), math.ceil(ny / g["kBlockY"]),
            lanes * math.ceil(nx / g["kPlanesX"]))


def stencil_ring_grid(shape, lanes: int = 1,
                      run: int = STENCIL_GEOMETRY["kRingRun"]) -> tuple[int, int, int]:
    """``stencil_ring_grid`` of ``csrc/stencil.cuh`` for ``lanes`` stacked
    (nx, ny, nz) blocks (the lanes fold into grid.z) in runs of ``run``
    x-planes."""
    nx, ny, nz = shape
    g = STENCIL_GEOMETRY
    return (math.ceil(nz / g["kRingZ"]), math.ceil(ny / g["kRingY"]),
            lanes * math.ceil(nx / run))


#: the call that launches each stencil pass, as its sources write it
PASS_LAUNCH = {"stencil": "launch_stencil<", "ring": "launch_stencil_ring<"}


def _v(subject: str, field: str, expected, actual, detail: str = "") -> Violation:
    return Violation(PASS, subject, field, expected, actual, detail)


def _check_limits(spec: KernelSpec) -> list[Violation]:
    subj = f"kernel:{spec.name}"
    out = []
    for what, threads in (("its kernel", spec.threads),
                          ("reduce_partials", REDUCE_THREADS if spec.ndots else 0)):
        if threads > MAX_THREADS:
            out.append(_v(subj, "threads", f"<= {MAX_THREADS} per block", threads,
                          f"{what} would be refused at launch"))
    smem = static_smem_bytes(spec)
    if smem > MAX_STATIC_SMEM:
        out.append(_v(subj, "static_smem", f"<= {MAX_STATIC_SMEM} bytes per block", smem,
                      "static shared memory above 48 KiB does not link"))
    if spec.dynamic_smem > MAX_DYNAMIC_SMEM:
        out.append(_v(subj, "dynamic_smem", f"<= {MAX_DYNAMIC_SMEM} bytes per block",
                      spec.dynamic_smem, "the launch would be refused"))
    # (lanes, grid, run): one lane in every run the row may pick, lanes in
    # the lane-batched form's run (kRingRun, or the row's own)
    cases = [(1, shape, run) for shape in GRIDS for run in choices(spec.runs)]
    if spec.batched:
        run = STENCIL_GEOMETRY["kRingRun"] if spec.runs == "RingRuns" else choices(spec.runs)[0]
        cases += [(lanes, shape, run) for lanes, shape in BATCHED_GRIDS]
    for geometry in launched_passes(spec):
        for lanes, shape, run in cases:
            gy, gz = (stencil_grid(shape, lanes) if geometry == "stencil"
                      else stencil_ring_grid(shape, lanes, run))[1:]
            if gy > MAX_GRID_YZ or gz > MAX_GRID_YZ:
                of = f"{lanes} lanes of the {shape} block" if lanes > 1 else f"the {shape} block"
                if geometry == "ring":
                    of += f" in runs of {run}"
                out.append(_v(subj, "grid", f"grid.y, grid.z <= {MAX_GRID_YZ}",
                              (gy, gz), f"{geometry} grid of {of}"))
    return out


def launched_passes(spec: KernelSpec) -> list[str]:
    """The stencil passes a row launches: its ``passes`` (``rb_gs.cu`` keeps
    some (dtype, stencil) pairs on the old pass; ``precond.cu`` puts bf16's
    block-Jacobi sweep and Chebyshev step, and f32's at the pair stage, on
    the ring and
    ``bicgstab_fused.cu`` bf16's two passes, each by a static rule), else
    the one its geometry names."""
    if spec.geometry not in PASS_LAUNCH:
        return []
    return list(spec.passes or (spec.geometry,))


def _tests_source() -> str | None:
    files = sorted(TESTS_DIR.glob("test_torch_*.py"))
    if not files:
        return None
    return "\n".join(f.read_text() for f in files)


def _check_row(spec: KernelSpec, ops_mod, ref_mod, tests_src: str | None) -> list[Violation]:
    subj = f"kernel:{spec.name}"
    wrapper = callable(getattr(ops_mod, spec.name, None))
    if spec.status == "to_port":
        if wrapper:
            return [_v(subj, "status", "no wrapper while to_port",
                       f"repro_torch.kernels.ops.{spec.name} exists",
                       "mark the row ported")]
        return []
    if spec.status != "ported":
        return [_v(subj, "status", "'ported' or 'to_port'", spec.status)]
    out = []
    if not wrapper:
        out.append(_v(subj, "wrapper", f"repro_torch.kernels.ops.{spec.name}", "missing"))
    elif tests_src is not None and not re.search(rf"\bops\.{spec.name}\b", tests_src):
        out.append(_v(subj, "test_row", f"'ops.{spec.name}' in tests/test_torch_*.py",
                      "no reference",
                      "the wrapper has no test against the reference or its plain version"))
    if not callable(getattr(ref_mod, spec.ref, None)):
        out.append(_v(subj, "plain", f"repro_torch.kernels.ref.{spec.ref}", "missing",
                      "every kernel needs a plain PyTorch version"))
    if spec.source is None or not (CSRC / spec.source).is_file():
        out.append(_v(subj, "source", f"kernels/csrc/{spec.source}", "missing"))
    if spec.batched is not None and spec.batched not in ops_mod.LAUNCHES:
        out.append(_v(subj, "launch_counter", f"ops.LAUNCHES[{spec.batched!r}]", "missing",
                      "the row's lane-batched form has no counter"))
    if spec.kernel not in ops_mod.LAUNCHES:
        out.append(_v(subj, "launch_counter", f"ops.LAUNCHES[{spec.kernel!r}]", "missing"))
    elif (CSRC / spec.source).is_file():
        for geometry in launched_passes(spec):
            if PASS_LAUNCH[geometry] not in _source_text(spec.source):
                out.append(_v(subj, "pass", f"{PASS_LAUNCH[geometry]}...> in {spec.source}",
                              "missing", f"the row names the {geometry} pass"))
    return out


def _source_text(source: str) -> str:
    return (CSRC / source).read_text()


def _source_constants(source: str) -> dict[str, int]:
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr\s+int(?:64_t)?\s+(k\w+)\s*=\s*(\d+)\s*;", _source_text(source))}


def _source_choices(source: str) -> dict[str, tuple[int, ...]]:
    """``using Name = std::integer_sequence<int, a, b, ...>;`` lines."""
    return {m.group(1): tuple(int(v) for v in m.group(2).split(",")) for m in re.finditer(
        r"using\s+(\w+)\s*=\s*std::integer_sequence<\s*int\s*,\s*([\d,\s]+)>\s*;",
        _source_text(source))}


#: the bodies whose shared memory their source holds: the layout function
#: a ``static_assert`` must bound at each width of ``WGMMA_HEAD_DIMS``
SMEM_ASSERTED = ("smem_bf16_wgmma", "smem_f32_tf32x3")


def check_wgmma_smem_assert() -> list[Violation]:
    """The wgmma and 3xTF32 bodies' shared memory is their source's to
    hold: a ``static_assert`` in ``csrc/flash_attention.cu`` bounds
    ``<layout><hd>() + kSmemAlign`` by ``kMaxDynamicSmem`` for each layout of
    :data:`SMEM_ASSERTED` at each width of ``WGMMA_HEAD_DIMS``, and
    ``kMaxDynamicSmem`` is Hopper's :data:`MAX_DYNAMIC_SMEM`."""
    from repro_torch.kernels.flash_attention import WGMMA_HEAD_DIMS
    source = "flash_attention.cu"
    text = _source_text(source)
    asserts = [re.sub(r"\s+", "", m.group(1))
               for m in re.finditer(r"static_assert\((.*?)\);", text, re.S)]
    out = []
    for layout in SMEM_ASSERTED:
        for hd in WGMMA_HEAD_DIMS:
            clause = f"{layout}<{hd}>()+kSmemAlign<=kMaxDynamicSmem"
            if not any(clause in a for a in asserts):
                out.append(_v(f"source:{source}:{layout}<{hd}>", "smem_assert",
                              f"static_assert({clause})", "missing",
                              "the body's layout is held to 227 KiB by its source"))
    found = _source_constants(source).get("kMaxDynamicSmem")
    if found != MAX_DYNAMIC_SMEM:
        out.append(_v(f"source:{source}:kMaxDynamicSmem", "smem_assert", MAX_DYNAMIC_SMEM,
                      found, "the static_assert's limit is not Hopper's"))
    return out


def _check_layer(table, ops_mod) -> list[Violation]:
    """Checks of the whole kernel layer against the real table."""
    out = []
    ported = [s for s in table if s.status == "ported"]
    tabled = {s.name for s in table} | _EXEMPT_WRAPPERS
    for name, fn in inspect.getmembers(ops_mod, inspect.isfunction):
        if not name.startswith("_") and fn.__module__ == ops_mod.__name__ \
                and name not in tabled:
            out.append(_v(f"kernel:{name}", "table_row",
                          "a KERNEL_TABLE row per public kernel wrapper",
                          "wrapper not covered"))
    from repro_torch.core.methods import METHODS
    ported_names = {s.name for s in ported}
    for mname, mdef in sorted(METHODS.items()):
        for hook in mdef.fused_kernels:
            if hook not in ported_names:
                out.append(_v(f"kernel:{hook}", "fused_coverage",
                              f"a ported KERNEL_TABLE row for fused hook {hook!r} "
                              f"(declared by {mname!r})", "hook not a ported row"))
    sources = {s.source for s in ported}
    for src in sorted(CSRC.glob("*.cu")):
        if src.name not in sources:
            out.append(_v(f"source:{src.name}", "table_row",
                          "a ported KERNEL_TABLE row per CUDA source", "source not covered"))
    counted = {s.kernel for s in ported} | {s.batched for s in ported if s.batched}
    for key in ops_mod.LAUNCHES:
        if key not in counted:
            out.append(_v(f"counter:{key}", "table_row",
                          "a ported KERNEL_TABLE row per launch counter",
                          "counter not covered"))
    for source, geometry in (("stencil.cuh", STENCIL_GEOMETRY),
                             ("flash_attention.cu", ATTENTION_GEOMETRY)):
        found = _source_constants(source)
        for name, want in geometry.items():
            if found.get(name) != want:
                out.append(_v(f"source:{source}:{name}", "geometry", want, found.get(name),
                              "the table's launch geometry drifted from the source"))
    found = _source_constants("stencil.cuh")
    for name, want in RING_STAGE_CODES.items():
        if found.get(name) != want:
            out.append(_v(f"source:stencil.cuh:{name}", "stage", want, found.get(name),
                          "the table's ring stage codes drifted from the source"))
    found = _source_choices("stencil.cuh")
    for name, want in STENCIL_CHOICES.items():
        if found.get(name) != want:
            out.append(_v(f"source:stencil.cuh:{name}", "geometry", want, found.get(name),
                          "the launch geometries a launch may pick drifted from the "
                          "source"))
    return out + check_wgmma_smem_assert()


_ENTRY = re.compile(r"(?:Compiling entry function '|Function properties for )([^' ]+)")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def check_ptxas(build_dir, table: tuple[KernelSpec, ...] | None = None) -> list[Violation]:
    """The ptxas reports (``-Xptxas -v``) in ``build_dir``: one ``<source>.log``
    per ported row's source, each reporting its kernels' registers, with no
    spill store or load, at most :data:`MAX_REGISTERS` registers and at most
    :data:`MAX_STATIC_SMEM` bytes of static shared memory."""
    table = KERNEL_TABLE if table is None else table
    out = []
    for src in sorted({s.source for s in table if s.status == "ported" and s.source}):
        stem = Path(src).stem
        log = Path(build_dir) / f"{stem}.log"
        subj = f"ptxas:{stem}"
        if not log.is_file():
            out.append(_v(subj, "ptxas_log", str(log), "missing"))
            continue
        fn, n_reports, entries = "?", 0, set()
        for line in log.read_text().splitlines():
            if m := _ENTRY.search(line):
                fn = m.group(1)
                entries.add(fn)
            if m := _SPILL.search(line):
                if int(m.group(1)) or int(m.group(2)):
                    out.append(_v(f"{subj}:{fn}", "ptxas_spill", "0 bytes spilled",
                                  f"{m.group(1)} stores, {m.group(2)} loads"))
            if m := _REGS.search(line):
                n_reports += 1
                if int(m.group(1)) > MAX_REGISTERS:
                    out.append(_v(f"{subj}:{fn}", "ptxas_registers",
                                  f"<= {MAX_REGISTERS}", int(m.group(1))))
            if (m := _SMEM.search(line)) and int(m.group(1)) > MAX_STATIC_SMEM:
                out.append(_v(f"{subj}:{fn}", "ptxas_smem",
                              f"<= {MAX_STATIC_SMEM} bytes", int(m.group(1))))
        if not n_reports:
            out.append(_v(subj, "ptxas_log", "a register report per kernel",
                          "no report", "was the source built with -Xptxas -v?"))
        else:
            out += _missing_instances(subj, [t for t in table if t.source == src], entries)
    return out


def _instance_values(entry: str, names: set[str],
                     dtype: str = "float64") -> set[tuple[int, int]]:
    """The last two integer template arguments (the stage and the run) of
    each reported instance of ``entry`` in ``dtype`` (its first template
    argument): ``..stencil_ring_kernelIdLi27E..Lb0ELi0ELi16EEEv..`` in the
    Itanium mangling (``Lb0E``: the fma flag, before them)."""
    pat = re.compile(rf"{entry}I{RING_DTYPES[dtype]}Li\w*?Li(\d+)ELi(\d+)EEEv")
    return {(int(m.group(1)), int(m.group(2))) for n in names if (m := pat.search(n))}


def ring_stages(spec: KernelSpec, dtype: str) -> tuple[str, ...]:
    """The stages a row's launches on the ring may take in ``dtype``: the
    dtype's :data:`DTYPE_STAGES`, or in f32 :data:`F32_PAIR_STAGES` for a
    row whose tail takes f32's pair stage."""
    return F32_PAIR_STAGES if dtype == "float32" and spec.f32_pairs else DTYPE_STAGES[dtype]


def _missing_instances(subj: str, rows, entries: set[str]) -> list[Violation]:
    """For each ``entry`` of ``rows`` and dtype its rows take on it (every
    one of :data:`RING_DTYPES`, or a row's ``ring_dtypes``): one finding if
    the report lacks every instance of a run the rows may pick at launch,
    and one if a run it has lacks a stage the rows may take there
    (:func:`ring_stages`)."""
    want: dict[tuple[str, str], set[int]] = {}
    stages: dict[tuple[str, str], list[str]] = {}
    for spec in rows:
        if spec.status == "ported" and spec.entry:
            for dtype in spec.ring_dtypes or RING_DTYPES:
                want.setdefault((spec.entry, dtype), set()).update(instances(spec))
                have = stages.setdefault((spec.entry, dtype), [])
                have += [s for s in ring_stages(spec, dtype) if s not in have]
    out = []
    for (entry, dtype), values in sorted(want.items(), key=lambda kv: (
            kv[0][0], list(RING_DTYPES).index(kv[0][1]))):
        found = _instance_values(entry, entries, dtype)
        runs = {run for _, run in found}
        missing = sorted(values - runs)
        if missing:
            out.append(_v(subj, "ptxas_ring",
                          f"a report of {entry} in {dtype} at each of {sorted(values)}",
                          f"none at {missing}",
                          "the source's rows pick these runs on the plane-ring pass "
                          "at launch, in every dtype the kernels take"))
        for stage in stages[(entry, dtype)]:
            lacking = sorted(run for run in values & runs
                             if (RING_STAGE_CODES[stage], run) not in found)
            if lacking:
                out.append(_v(subj, "ptxas_stage",
                              f"a report of {entry} in {dtype} at {stage} at each of "
                              f"{sorted(values & runs)}", f"none at {lacking}",
                              "a launch in this dtype may take this stage (ring_stage)"))
    return out


def check_kernels(table: tuple[KernelSpec, ...] | None = None, *,
                  build_dir=None) -> list[Violation]:
    """Run every kernel check; returns the (possibly empty) findings.  The
    checks of the whole layer run on the real table only (an injected table
    is deliberately partial); the ptxas reports are read when ``build_dir``
    is given."""
    real = table is None or table is KERNEL_TABLE
    table = KERNEL_TABLE if table is None else table
    from repro_torch.kernels import ops as ops_mod, ref as ref_mod
    tests_src = _tests_source()
    out = []
    if tests_src is None:
        out.append(_v("kernel:*", "test_row", f"tests/test_torch_*.py under {TESTS_DIR}",
                      "missing", "cannot verify the per-kernel tests"))
    for spec in table:
        out += _check_limits(spec)
        out += _check_row(spec, ops_mod, ref_mod, tests_src)
    if real:
        out += _check_layer(table, ops_mod)
    if build_dir is not None:
        out += check_ptxas(build_dir, table)
    return out
