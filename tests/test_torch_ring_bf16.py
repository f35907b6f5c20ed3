"""bf16's pair stage of the plane-ring pass, emulated on the CPU.

The ring pass (``csrc/stencil.cuh``) runs bf16 on its pair stage when nz is
even and the operand 4-byte aligned (``ring_stage``): each plane tile is
copied as 4-byte pairs (``cp.async`` with src-size 0 outside the operand),
each thread owns two z-outputs and reads its neighbourhood as nine bf16
pairs, built from aligned 32-bit words by ``__byte_perm`` where a pair
starts at an odd tile column, and sums both lanes at once in bf16x2
(``ring_first``, ``ring_last``).  Here, in numpy and torch on the CPU:

* the copy plan for nz even and odd, both operand forms, ragged ny and nx,
  one and three lanes: where the rule takes the pair stage every copy is
  4-byte aligned, no pair straddles the operand's z edge, and the tiles
  the copies assemble are the zero-padded plane tiles; where it does not
  (odd nz, an odd element offset) the plan would break one of these;
* the byte permute that builds a pair at an odd column, exactly;
* the Python mirrors of the stage rule (``stencil_spmv.ring_stage``) and of
  ``precond.cu``'s rule that puts bf16's block-Jacobi sweep on the ring
  (``precond.jacobi_pass``), held to the sources' text;
* the whole pass emulated from the assembled tiles through the pair reads,
  each lane's ``ring_first``/``ring_last`` order computed with torch CPU
  bf16 one operation at a time: bitwise ``kernels.ref``'s SpMV and
  block-Jacobi sweep and the reference's oracles at small ragged shapes;
* the fma a neighbour term takes where off is ±1 (``ring_term``'s UNIT):
  bitwise the multiply and the add it replaces.

The card holds the kernel itself to these plain versions (``-k bf16`` in
``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import ref_module, seeded, to_np

from repro_torch.analysis import lint_kernels as lint
from repro_torch.core.operators import STENCILS, pad1
from repro_torch.kernels import precond, ref, stencil_spmv

G = lint.STENCIL_GEOMETRY
RING_Z, RING_Y, PAIR_LANES = G["kRingZ"], G["kRingY"], G["kRingPairLanes"]
#: threads along z on the pair stage, and the 32-bit words of a tile row
PAIR_Z = RING_Z // PAIR_LANES
ROW_WORDS = PAIR_Z + 2
#: byte_perm's selector for the pair between two words (stencil.cuh's kPairOdd)
PAIR_ODD = 0x5432
#: ragged shapes, nz even and odd (the first two even, as 128³ is)
SHAPES = [(5, 7, 6), (9, 13, 70), (3, 5, 130), (4, 6, 5), (6, 3, 67)]
FORMS = ["padded", "zero_halo"]
STENCIL_NAMES = ["7pt", "27pt"]


def byte_perm(x, y, s: int):
    """CUDA's ``__byte_perm(x, y, s)`` on uint32 arrays: byte n of the
    result is byte (s >> 4n) & 7 of the eight bytes y:x (x the low four)."""
    x, y = np.asarray(x, np.uint64), np.asarray(y, np.uint64)
    both = x | (y << np.uint64(32))
    out = np.zeros(np.broadcast(x, y).shape, np.uint64)
    for n in range(4):
        sel = np.uint64((s >> (4 * n)) & 7)
        out |= ((both >> (np.uint64(8) * sel)) & np.uint64(0xFF)) << np.uint64(8 * n)
    return out.astype(np.uint32)


def operand(shape, lanes: int, zero_halo: bool, seed: int):
    """Seeded bf16 operands: the grid x (lanes, nx, ny, nz), its padded form,
    and the operand the pass reads (unpadded x, or the padded one)."""
    x = torch.from_numpy(seeded((lanes, *shape), seed, np.float32)).to(torch.bfloat16)
    xp = pad1(x)
    return x, xp, (x if zero_halo else xp)


def bits(t: torch.Tensor) -> np.ndarray:
    """A bf16 tensor's 16-bit patterns, flat."""
    return to_np(t.contiguous().view(torch.int16)).astype(np.uint16).reshape(-1)


def copy_plan(shape, lo: int, lanes: int, run: int, block):
    """The copies of one block (bx, by, bz) on the pair stage
    (``ring_pair_pass``): its lane, first plane i0, and per tile word c the
    slot word it fills, the element offset of its pair in the operand's
    x-plane (from the lane's base), and whether the pair lies in it."""
    nx, ny, nz = shape
    bx, by, bz = block
    runs = math.ceil(nx / run)
    lane, i0 = bz // runs, (bz % runs) * run
    k0, j0 = bx * RING_Z, by * RING_Y
    row_words = PAIR_Z + 1 + lo
    c = np.arange((RING_Y + 2) * row_words)
    row, wc = divmod(c, row_words)
    oy, oz = j0 + row - lo, k0 - 2 * lo + 2 * wc
    sy = nz + 2 - 2 * lo
    ok = (oy >= 0) & (oy < ny + 2 - 2 * lo) & (oz >= 0) & (oz < nz + 2 - 2 * lo)
    return lane, i0, row * ROW_WORDS + wc, oy * sy + oz, ok, oz


def plane_tile(flat: np.ndarray, shape, lo: int, lane: int, i0: int, q: int, plan):
    """The slot words the copies of padded plane i0 + q fill (0 where a
    copy writes zeros), from the operand's 16-bit patterns ``flat``."""
    nx, ny, nz = shape
    _, _, dst, off, ok, _ = plan
    sy = nz + 2 - 2 * lo
    sx = (ny + 2 - 2 * lo) * sy
    base = lane * (nx + 2 - 2 * lo) * sx
    words = np.zeros((RING_Y + 2) * ROW_WORDS, np.uint32)
    pi = i0 + q
    if lo <= pi < nx + 2 - lo:
        src = base + (pi - lo) * sx + off[ok]
        words[dst[ok]] = flat[src].astype(np.uint32) | (flat[src + 1].astype(np.uint32) << 16)
    return words


def blocks(shape, lanes: int, run: int):
    nx, ny, nz = shape
    return [(bx, by, bz) for bz in range(lanes * math.ceil(nx / run))
            for by in range(math.ceil(ny / RING_Y)) for bx in range(math.ceil(nz / RING_Z))]


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_pair_copy_plan(shape, form, lanes):
    """Where the rule takes the pair stage (nz even, the operand 4-byte
    aligned), every copy starts at an even element of the (lane-stacked)
    operand, no pair crosses its z edge, and each plane's slot, read back as
    bf16 values, is the zero-padded plane tile around the block (tile
    column 0 at padded pk = k0 − lo); with nz odd some pair is misaligned
    or straddles the edge, so the rule stages through registers."""
    lo = int(form == "zero_halo")
    nx, ny, nz = shape
    x, xp, xin = operand(shape, lanes, bool(lo), seed=nz)
    flat = bits(xin)
    padded = bits(xp).reshape(lanes, nx + 2, ny + 2, nz + 2)
    sy = nz + 2 - 2 * lo
    plane = (ny + 2 - 2 * lo) * sy
    lane_stride = (nx + 2 - 2 * lo) * plane
    pairs_ok = True
    for block in blocks(shape, lanes, run=G["kRingRun"]):
        plan = copy_plan(shape, lo, lanes, G["kRingRun"], block)
        lane, i0, dst, off, ok, oz = plan
        extent = nz + 2 - 2 * lo
        whole = (oz + 1 < extent) == (oz < extent)         # no pair across the z edge
        # the copy of plane p reads from lane·lane_stride + p·plane + off
        even = ((lane * lane_stride + off) % 2 == 0) & (plane % 2 == 0)
        pairs_ok &= bool(np.all(whole[ok]) and np.all(even[ok]))
        if nz % 2:
            continue
        assert np.all(whole) and np.all(even[ok])
        k0, j0 = block[0] * RING_Z, block[1] * RING_Y
        cols = 2 * (PAIR_Z + 1 + lo)
        for q in range(min(G["kRingRun"], nx - i0) + 2):
            words = plane_tile(flat, shape, lo, lane, i0, q, plan)
            got = np.stack([words & 0xFFFF, words >> 16], -1).reshape(RING_Y + 2, -1)[:, :cols]
            want = np.zeros((RING_Y + 2, cols), np.uint32)
            pk = np.arange(k0 - lo, k0 - lo + cols)
            pj = np.arange(j0, j0 + RING_Y + 2)
            inside = (pk < nz + 2)[None, :] & (pj < ny + 2)[:, None]
            if i0 + q < nx + 2:
                sub = padded[lane, i0 + q][np.ix_(np.clip(pj, 0, ny + 1),
                                                  np.clip(pk, 0, nz + 1))]
                want = np.where(inside & (pk >= 0)[None, :], sub, 0)
            np.testing.assert_array_equal(got, want)
    assert pairs_ok == (nz % 2 == 0)
    assert stencil_spmv.ring_stage(torch.bfloat16, nz, bool(lo), xin.data_ptr()).startswith(
        "pair" if nz % 2 == 0 and xin.data_ptr() % 4 == 0 else "register")


def test_byte_perm_builds_the_odd_pairs():
    """The selector kPairOdd takes the high half of the first word and the
    low half of the second: the pair starting at the odd column between
    them, exactly, for every bit pattern tried; the even pairs are the
    words themselves."""
    rng = np.random.default_rng(5)
    w0, w1 = rng.integers(0, 2 ** 32, (2, 4096), dtype=np.uint64).astype(np.uint32)
    got = byte_perm(w0, w1, PAIR_ODD)
    np.testing.assert_array_equal(got, (w0 >> 16) | ((w1 & 0xFFFF) << 16))
    np.testing.assert_array_equal(byte_perm(w0, w1, 0x3210), w0)
    np.testing.assert_array_equal(byte_perm(w0, w1, 0x7654), w1)
    assert PAIR_ODD == int(re.search(r"constexpr unsigned kPairOdd = (0x[0-9a-fA-F]+)u;",
                                     (lint.CSRC / "stencil.cuh").read_text()).group(1), 16)


def pair_reads(words: np.ndarray, lo: int):
    """Every thread's 3 × 3 neighbourhood of one plane as uint32 pairs,
    (RING_Y, PAIR_Z, 9), as ``ring_pair_pass``'s ``read_plane`` builds it:
    padded (lo = 0) the centre pair from two words, unpadded the left and
    right pairs from three."""
    ty, tz = np.meshgrid(np.arange(RING_Y), np.arange(PAIR_Z), indexing="ij")
    out = np.zeros((RING_Y, PAIR_Z, 9), np.uint32)
    for a in range(3):
        w = [words[(ty + a) * ROW_WORDS + tz + i] for i in range(3)]
        if lo == 0:
            pair = (w[0], byte_perm(w[0], w[1], PAIR_ODD), w[1])
        else:
            pair = (byte_perm(w[0], w[1], PAIR_ODD), w[1], byte_perm(w[1], w[2], PAIR_ODD))
        for b in range(3):
            out[..., 3 * a + b] = pair[b]
    return out


def lanes_of(pairs: np.ndarray) -> torch.Tensor:
    """uint32 pairs -> bf16 (..., 2): lane 0 the low half (output k), lane 1
    the high half (output k + 1)."""
    halves = np.stack([pairs & 0xFFFF, pairs >> 16], -1).astype(np.uint16)
    return torch.from_numpy(halves.view(np.int16)).view(torch.bfloat16)


#: ring_first's and ring_last's terms after the centre's diag·c[4] (27pt:
#: b's nine, c's eight; a's nine.  7pt: b[4]; a[4], c[1], c[7], c[3], c[5])
RING_ORDER = {
    "27pt": ([("b", q) for q in range(9)] + [("c", q) for q in range(9) if q != 4],
             [("a", q) for q in range(9)]),
    "7pt": ([("b", 4)], [("a", 4), ("c", 1), ("c", 7), ("c", 3), ("c", 5)]),
}


def ring_pair_spmv(xin: torch.Tensor, shape, lanes: int, lo: int, st: str,
                   run: int) -> torch.Tensor:
    """y = A x as the pair stage computes it: per block, the slot tiles the
    copy plan assembles, each thread's pairs read through ``pair_reads``,
    both lanes summed at once (bf16 tensors of (..., 2), one rounding an
    operation: torch's CPU bf16 rounds each multiply and add once) in
    ``ring_first``/``ring_last``'s order, each output ended on the plane
    after its centre plane; (lanes, nx, ny, nz)."""
    nx, ny, nz = shape
    stencil = STENCILS[st]
    diag, off = (torch.tensor(v, dtype=torch.bfloat16) for v in (stencil.diag,
                                                                 stencil.off_coeff))
    first, last = RING_ORDER[st]
    flat = bits(xin)
    y = torch.zeros((lanes, nx, ny, nz + 2 * PAIR_Z), dtype=torch.bfloat16)
    for block in blocks(shape, lanes, run):
        plan = copy_plan(shape, lo, lanes, run, block)
        lane, i0 = plan[:2]
        nrun = min(run, nx - i0)
        hood = [lanes_of(pair_reads(plane_tile(flat, shape, lo, lane, i0, q, plan), lo))
                for q in range(nrun + 2)]
        k0, j0 = block[0] * RING_Z, block[1] * RING_Y
        for s in range(nrun):
            planes = {"b": hood[s], "c": hood[s + 1], "a": hood[s + 2]}
            acc = diag * planes["c"][..., 4, :]
            for terms in (first, last):
                for name, q in terms:
                    acc = acc + off * planes[name][..., q, :]
            rows = min(RING_Y, ny - j0)
            y[lane, i0 + s, j0:j0 + rows, k0:k0 + RING_Z] = acc[:rows].reshape(rows, RING_Z)
    return y[..., :nz]


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("shape", [s for s in SHAPES if s[2] % 2 == 0], ids=str)
@pytest.mark.parametrize("st", STENCIL_NAMES)
def test_pair_pass_spmv_is_the_plain_version(st, shape, form, lanes):
    """The emulated pair stage's y is bitwise ``kernels.ref``'s SpMV (the
    plain version on the padded operand) and the reference's oracle, lane by
    lane, in both operand forms, in runs of 8 planes (a ragged last run) and
    kRingRun."""
    lo = int(form == "zero_halo")
    x, xp, xin = operand(shape, lanes, bool(lo), seed=3 * lanes + lo)
    want = ref.stencil_spmv_ref(xp, stencil=STENCILS[st])
    for run in (8, G["kRingRun"]):
        got = ring_pair_spmv(xin, shape, lanes, lo, st, run)
        assert torch.equal(got, want), float((got.float() - want.float()).abs().max())
    jref = ref_module("kernels.ref")
    jst = ref_module("core.operators").STENCILS[st]
    for i in range(lanes):
        jy = jref.stencil_spmv_ref(jnp.asarray(xp[i].float().numpy()).astype(jnp.bfloat16),
                                   stencil=jst)
        np.testing.assert_array_equal(np.asarray(jy.astype(jnp.float32)),
                                      to_np(want[i].float()))


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("shape", [s for s in SHAPES if s[2] % 2 == 0], ids=str)
@pytest.mark.parametrize("st", STENCIL_NAMES)
def test_pair_pass_jacobi_is_the_plain_version(st, shape, lanes):
    """bf16's block-Jacobi sweep on the ring (``precond.cu``'s
    ``jacobi_on_ring``): padded z, A z from the emulated pair stage in runs
    of kRingRunJacobi, then
    the plain version's tail z + ω·(r − A z)/diag (the CPU's division; on
    the card both sides multiply by the f32 reciprocal): bitwise
    ``kernels.ref``'s sweep and, lane by lane, the reference's oracle."""
    omega = float(torch.tensor(0.8, dtype=torch.bfloat16))
    z, zp, _ = operand(shape, lanes, False, seed=11)
    r = torch.from_numpy(seeded((lanes, *shape), 12, np.float32)).to(torch.bfloat16)
    stencil = STENCILS[st]
    az = ring_pair_spmv(zp, shape, lanes, 0, st, G["kRingRunJacobi"])
    got = z + omega * (r - az) / stencil.diag
    want = ref.block_jacobi_sweep_ref(zp, r, stencil=stencil, omega=omega)
    assert torch.equal(got, want)
    jref = ref_module("kernels.ref")
    jst = ref_module("core.operators").STENCILS[st]
    for i in range(lanes):
        jz = jref.block_jacobi_sweep_ref(
            jnp.asarray(zp[i].float().numpy()).astype(jnp.bfloat16),
            jnp.asarray(r[i].float().numpy()).astype(jnp.bfloat16), stencil=jst,
            omega=omega)
        np.testing.assert_array_equal(np.asarray(jz.astype(jnp.float32)), to_np(got[i].float()))


#: the stage rule as ``csrc/stencil.cuh``'s ``ring_stage`` writes it, and the
#: stages ``ring_stages`` instantiates for bf16
STAGE_RULE = ("  if (sizeof(T) >= 4) return kStageAsync;\n"
              "  const bool pairs = nz % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;\n"
              "  if (!pairs) return kStageRegister;\n"
              "  return zero_halo ? kStagePairUnpadded : kStagePairPadded;\n")
BF16_STAGES = ("std::integer_sequence<int, kStageRegister, kStagePairPadded, "
               "kStagePairUnpadded>")
#: precond.cu's rule for block_jacobi_sweep, and its launch under it
JACOBI_RULE = ("constexpr bool jacobi_on_ring() {\n"
               "  return std::is_same<T, __nv_bfloat16>::value;\n}")
JACOBI_LAUNCH = ("  if constexpr (jacobi_on_ring<T>())\n"
                 "    return repro::launch_stencil_ring<T>(z, 0, tail,")


def test_stage_rule_mirror_matches_the_source():
    """``stencil_spmv.ring_stage`` is the source's rule: the rule's text is
    in ``stencil.cuh`` as the mirror reads it, bf16 instantiates the three
    stages the lint requires, and the mirror answers each (dtype, nz parity,
    alignment, form) as the rule does."""
    text = " ".join((lint.CSRC / "stencil.cuh").read_text().split())
    assert " ".join(STAGE_RULE.split()) in text
    assert " ".join(BF16_STAGES.split()) in text
    assert stencil_spmv.RING_STAGES == ("async", "register", "pair_padded", "pair_unpadded")
    assert [lint.RING_STAGE_CODES[s] for s in lint.DTYPE_STAGES["bfloat16"]] == [1, 2, 3]
    for dt in (torch.float64, torch.float32):
        assert {stencil_spmv.ring_stage(dt, nz, zh, p) for nz in (6, 7) for zh in (0, 1)
                for p in (0, 2, 4)} == {"async"}
    bf = torch.bfloat16
    assert stencil_spmv.ring_stage(bf, 128, False, 256) == "pair_padded"
    assert stencil_spmv.ring_stage(bf, 128, True, 256) == "pair_unpadded"
    assert stencil_spmv.ring_stage(bf, 129, True, 256) == "register"
    assert stencil_spmv.ring_stage(bf, 128, True, 258) == "register"
    assert stencil_spmv.ring_stage(bf, 130, False, 1028) == "pair_padded"


def test_misaligned_view_takes_the_register_stage():
    """A contiguous view at an odd element offset (a bf16 tensor 2 bytes
    past a 4-byte boundary) is taken through registers, whatever nz."""
    buf = torch.zeros(1 + 4 * 6 * 8, dtype=torch.bfloat16)
    view = buf[1:].view(4, 6, 8)
    assert view.is_contiguous() and view.data_ptr() % 4 == 2
    assert stencil_spmv.ring_stage(torch.bfloat16, 8, True, view.data_ptr()) == "register"
    assert stencil_spmv.ring_stage(torch.bfloat16, 8, True, buf[:-1].data_ptr()) \
        == "pair_unpadded"


def test_jacobi_ring_rule_mirror_matches_the_source():
    """``precond.jacobi_pass`` is ``precond.cu``'s rule: bf16's sweep (one
    lane or a batch) launches the ring pass from the padded z, f64 and f32
    keep ``stencil_kernel``; the lint's row names the same dtype."""
    text = (lint.CSRC / "precond.cu").read_text()
    assert JACOBI_RULE in text and JACOBI_LAUNCH in text
    assert precond.JACOBI_RING_DTYPES == (torch.bfloat16,)
    assert [precond.jacobi_pass(d) for d in (torch.float64, torch.float32, torch.bfloat16)] \
        == ["stencil", "stencil", "ring"]
    spec = next(s for s in lint.KERNEL_TABLE if s.name == "jacobi_sweep")
    assert spec.ring_dtypes == ("bfloat16",) and lint.launched_passes(spec) == ["stencil",
                                                                               "ring"]


def test_unit_fma_is_the_multiply_and_add():
    """Where off is ±1 the pair stage takes each neighbour term as one
    fma.rn.bf16x2 (``ring_term``'s UNIT): off·x is then exact, so the fma's
    one rounding of off·x + acc is add_rn(acc, mul_rn(off, x)).  Checked on
    every bf16 bit pattern of x against seeded and special accumulators
    (zeros of both signs, subnormals, the largest finite values, infinities),
    the fma emulated as off·x + acc in float64, rounded to bf16."""
    xs = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    xs = xs[~torch.isnan(xs)]
    special = torch.tensor([0.0, -0.0, 1e-40, -1e-40, 3.3e38, -3.3e38, float("inf"),
                            float("-inf"), 1.0, -1.5], dtype=torch.float32)
    accs = torch.cat([special, torch.from_numpy(seeded((54,), 8, np.float32)) * 100])
    for off in (-1.0, 1.0):
        o = torch.tensor(off, dtype=torch.bfloat16)
        for acc in accs.to(torch.bfloat16):
            want = acc + o * xs
            fma = (acc.double() + off * xs.double()).to(torch.bfloat16)
            same = torch.isnan(want) & torch.isnan(fma)
            assert bool(torch.all((want.view(torch.int16) == fma.view(torch.int16)) | same)), \
                float(acc)
    rule = " ".join((lint.CSRC / "stencil.cuh").read_text().split())
    assert "const bool unit = off == 1.0 || off == -1.0;" in rule
