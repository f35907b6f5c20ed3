"""f32's pair stage of the plane-ring pass, emulated on the CPU.

The ring pass (``csrc/stencil.cuh``) runs f32's Chebyshev step and
block-Jacobi sweep (``ChebTail<float>``, ``JacobiTail<float>``: the tails of
``f32_pair_tail``) on its pair stage when nz is even and the padded z, the
tail's streams and its outputs are 8-byte aligned (``ring_stage``,
``ring_tail_stage``; ``precond.cu``'s ``on_ring`` keeps every other f32
launch on ``stencil_kernel``): each plane tile is copied as 8-byte float2
pairs (``cp.async`` with src-size 0 outside the operand), each thread owns
two z-outputs and reads a row of its neighbourhood as the four floats
pk = k … k + 3 (two aligned float2 in the padded form, three in the
unpadded form), and sums each lane as its own scalar chain in
``ring_first``/``ring_last``'s order, a neighbour term one ``fmaf`` where off
is ±1.  Here, in numpy and torch on the CPU:

* the 8-byte copy plan for nz even and odd, both operand forms, ragged ny
  and nx, one and three lanes: where the rule takes the pair stage every
  copy starts at an even element (8-byte aligned), no pair straddles the
  operand's z edge, and the tiles the copies assemble are the zero-padded
  plane tiles; where it does not (odd nz) the plan would break one of these;
* the two-output reads of both forms: each thread's nine pairs are the
  zero-padded neighbourhoods of its outputs k and k + 1;
* the whole pass from the assembled tiles through those reads, each lane's
  sum computed with torch CPU float32 one operation at a time: bitwise
  ``kernels.ref``'s SpMV, and, with the tails' pair forms on both lanes of
  each pair at once, bitwise ``kernels.ref``'s Chebyshev step (d and z
  aliased and not) and block-Jacobi sweep (the CPU's division; the card's
  reciprocal multiply within an ulp a point of its update), one lane and B
  lanes, and the reference's oracles;
* the fma a neighbour term takes where off is ±1 (``ring_term``'s UNIT):
  bitwise the multiply and the add it replaces, signed zeros included;
* the Python mirrors of the per-tail stage rule (``stencil_spmv.ring_stage``
  with ``kernel=``, ``precond.cheb_pass``/``jacobi_pass``) and the sources'
  pair forms, held to their text.

The card holds the kernel itself to the old pass (``-k f32_pair`` in
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
#: threads along z on the pair stage, and the float2 words of a tile row
PAIR_Z = RING_Z // PAIR_LANES
ROW_WORDS = PAIR_Z + 2
#: ragged shapes, nz even and odd (the first three even, as 128³ is)
SHAPES = [(5, 7, 6), (9, 13, 70), (3, 5, 130), (4, 6, 5), (6, 3, 67)]
EVEN = [s for s in SHAPES if s[2] % 2 == 0]
FORMS = ["padded", "zero_halo"]
STENCIL_NAMES = ["7pt", "27pt"]
#: ring_first's and ring_last's terms after the centre's diag·c[4] (27pt:
#: b's nine, c's eight; a's nine.  7pt: b[4]; a[4], c[1], c[7], c[3], c[5])
RING_ORDER = {
    "27pt": ([("b", q) for q in range(9)] + [("c", q) for q in range(9) if q != 4],
             [("a", q) for q in range(9)]),
    "7pt": ([("b", 4)], [("a", 4), ("c", 1), ("c", 7), ("c", 3), ("c", 5)]),
}


def f32(seed: int, shape) -> torch.Tensor:
    """A seeded float32 tensor of ``shape``."""
    return torch.from_numpy(seeded(shape, seed, np.float32))


def f32_scalar(v: float) -> float:
    """``v`` rounded to float32, kept a Python float (``ref.scalars_like``)."""
    return float(torch.tensor(v, dtype=torch.float32))


def operand(shape, lanes: int, zero_halo: bool, seed: int):
    """Seeded float32 operands: the grid x (lanes, nx, ny, nz), its padded
    form, and the operand the pass reads (unpadded x, or the padded one)."""
    x = f32(seed, (lanes, *shape))
    xp = pad1(x)
    return x, xp, (x if zero_halo else xp)


def blocks(shape, lanes: int, run: int):
    nx, ny, nz = shape
    return [(bx, by, bz) for bz in range(lanes * math.ceil(nx / run))
            for by in range(math.ceil(ny / RING_Y)) for bx in range(math.ceil(nz / RING_Z))]


def copy_plan(shape, lo: int, run: int, block):
    """The copies of one block (bx, by, bz) on the pair stage
    (``ring_pair_pass``): its lane, first plane i0, and per tile word c the
    slot word it fills, the element offset of its pair in the operand's
    x-plane (from the lane's base), whether the pair lies in it, and its z
    index in the operand."""
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
    """The slot's float2 words (ROW_WORDS · (kRingY + 2), 2) the copies of
    padded plane i0 + q fill (0 where a copy writes zeros), from the
    operand's float32 values ``flat``."""
    nx, ny, nz = shape
    _, _, dst, off, ok, _ = plan
    sy = nz + 2 - 2 * lo
    sx = (ny + 2 - 2 * lo) * sy
    base = lane * (nx + 2 - 2 * lo) * sx
    words = np.zeros(((RING_Y + 2) * ROW_WORDS, 2), np.float32)
    pi = i0 + q
    if lo <= pi < nx + 2 - lo:
        src = base + (pi - lo) * sx + off[ok]
        words[dst[ok]] = np.stack([flat[src], flat[src + 1]], -1)
    return words


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_f32_pair_copy_plan(shape, form, lanes):
    """Where the rule takes the pair stage (nz even, the operand 8-byte
    aligned), every copy starts at an even element of the (lane-stacked)
    operand, so at an 8-byte boundary, no pair crosses its z edge, and each
    plane's slot, read back as float32 values, is the zero-padded plane tile
    around the block (tile column 0 at padded pk = k0 − lo); with nz odd
    some pair is misaligned or straddles the edge, so the rule copies
    elements (and ``precond.cu`` takes ``stencil_kernel``)."""
    lo = int(form == "zero_halo")
    nx, ny, nz = shape
    x, xp, xin = operand(shape, lanes, bool(lo), seed=nz)
    flat = to_np(xin).reshape(-1)
    padded = to_np(xp)
    sy = nz + 2 - 2 * lo
    plane = (ny + 2 - 2 * lo) * sy
    lane_stride = (nx + 2 - 2 * lo) * plane
    pairs_ok = True
    run = G["kRingRunCheb"]
    for block in blocks(shape, lanes, run):
        plan = copy_plan(shape, lo, run, block)
        lane, i0, dst, off, ok, oz = plan
        extent = nz + 2 - 2 * lo
        whole = (oz + 1 < extent) == (oz < extent)         # no pair across the z edge
        even = ((lane * lane_stride + off) % 2 == 0) & (plane % 2 == 0)
        pairs_ok &= bool(np.all(whole[ok]) and np.all(even[ok]))
        if nz % 2:
            continue
        assert np.all(whole) and np.all(even[ok])
        k0, j0 = block[0] * RING_Z, block[1] * RING_Y
        cols = 2 * (PAIR_Z + 1 + lo)
        for q in range(min(run, nx - i0) + 2):
            words = plane_tile(flat, shape, lo, lane, i0, q, plan)
            got = words.reshape(RING_Y + 2, -1)[:, :cols]
            want = np.zeros((RING_Y + 2, cols), np.float32)
            pk = np.arange(k0 - lo, k0 - lo + cols)
            pj = np.arange(j0, j0 + RING_Y + 2)
            inside = (pk < nz + 2)[None, :] & (pj < ny + 2)[:, None] & (pk >= 0)[None, :]
            if i0 + q < nx + 2:
                sub = padded[lane, i0 + q][np.ix_(np.clip(pj, 0, ny + 1),
                                                  np.clip(pk, 0, nz + 1))]
                want = np.where(inside, sub, 0)
            np.testing.assert_array_equal(got, want)
    assert pairs_ok == (nz % 2 == 0)
    for kernel in stencil_spmv.F32_PAIR_KERNELS:
        assert stencil_spmv.ring_stage(torch.float32, nz, bool(lo), xin.data_ptr(),
                                       kernel=kernel).startswith(
            "pair" if nz % 2 == 0 and xin.data_ptr() % 8 == 0 else "async")


def pair_reads(words: np.ndarray, lo: int) -> np.ndarray:
    """Every thread's 3 × 3 neighbourhood of one plane as float32 pairs,
    (RING_Y, PAIR_Z, 9, 2), as ``ring_pair_pass``'s ``read_plane`` builds it
    (``row_pairs``): a row is the four floats pk = k … k + 3, from the
    aligned float2 words tz and tz + 1 (padded), or the halves of words tz
    and tz + 2 and all of tz + 1 (unpadded: its row starts at an odd
    column); the pairs at pk = k, k + 1, k + 2 take the lanes (k, k + 1)."""
    ty, tz = np.meshgrid(np.arange(RING_Y), np.arange(PAIR_Z), indexing="ij")
    out = np.zeros((RING_Y, PAIR_Z, 9, 2), np.float32)
    for a in range(3):
        w = [words[(ty + a) * ROW_WORDS + tz + i] for i in range(3)]
        if lo == 0:
            row = np.concatenate([w[0], w[1]], -1)            # pk = k … k + 3
        else:
            row = np.concatenate([w[0][..., 1:], w[1], w[2][..., :1]], -1)
        for b in range(3):
            out[..., 3 * a + b, :] = row[..., b:b + 2]
    return out


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("shape", EVEN, ids=str)
def test_f32_two_output_reads_are_the_neighbourhoods(shape, form):
    """Each thread's nine pairs, read from the assembled tiles, are the
    zero-padded 3 × 3 neighbourhoods of its two outputs (k, k + 1) on every
    plane of every block: lane l's value q = 3·(dy + 1) + (dz + 1) is
    padded[pi, j + 1 + dy, k + l + 1 + dz]; padded, the centre pair
    straddles the two words, unpadded the left and right pairs do."""
    lo = int(form == "zero_halo")
    nx, ny, nz = shape
    _, xp, xin = operand(shape, 1, bool(lo), seed=5 + lo)
    flat = to_np(xin).reshape(-1)
    padded = np.pad(to_np(xp)[0], ((0, 0), (0, RING_Y + 2), (0, RING_Z + 4)))
    run = G["kRingRunJacobi"]
    ty, tz = np.meshgrid(np.arange(RING_Y), np.arange(PAIR_Z), indexing="ij")
    for block in blocks(shape, 1, run):
        plan = copy_plan(shape, lo, run, block)
        lane, i0 = plan[:2]
        k0, j0 = block[0] * RING_Z, block[1] * RING_Y
        for q in range(min(run, nx - i0) + 2):
            got = pair_reads(plane_tile(flat, shape, lo, lane, i0, q, plan), lo)
            for qq in range(9):
                dy, dz = divmod(qq, 3)
                for ln in range(PAIR_LANES):
                    want = padded[i0 + q][j0 + ty + dy, k0 + PAIR_LANES * tz + ln + dz]
                    np.testing.assert_array_equal(got[..., qq, ln], want)


def ring_pair_spmv(xin: torch.Tensor, shape, lanes: int, lo: int, st: str,
                   run: int) -> torch.Tensor:
    """y = A x as f32's pair stage computes it: per block, the slot tiles the
    copy plan assembles, each thread's pairs read through
    :func:`pair_reads`, each lane's sum (torch float32 tensors of (..., 2),
    one rounding an operation) in ``ring_first``/``ring_last``'s order, each
    output ended on the plane after its centre plane; (lanes, nx, ny, nz).
    A neighbour term is acc + off·x: the fma's bits where off is ±1 (off·x
    exact: :func:`test_f32_unit_fma_is_the_multiply_and_add`), the multiply
    and add's otherwise."""
    nx, ny, nz = shape
    stencil = STENCILS[st]
    diag, off = (f32_scalar(v) for v in (stencil.diag, stencil.off_coeff))
    first, last = RING_ORDER[st]
    flat = to_np(xin).reshape(-1)
    y = torch.zeros((lanes, nx, ny, nz + 2 * PAIR_Z), dtype=torch.float32)
    for block in blocks(shape, lanes, run):
        plan = copy_plan(shape, lo, run, block)
        lane, i0 = plan[:2]
        nrun = min(run, nx - i0)
        hood = [torch.from_numpy(pair_reads(plane_tile(flat, shape, lo, lane, i0, q, plan), lo))
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


def pairs_of(*ts: torch.Tensor):
    """Each tensor's last axis as (…, nz / 2, 2): the pairs (k, k + 1) a
    thread's pair form loads and stores."""
    return [t.reshape(*t.shape[:-1], -1, PAIR_LANES) for t in ts]


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("shape", EVEN, ids=str)
@pytest.mark.parametrize("st", STENCIL_NAMES)
def test_f32_pair_pass_spmv_is_the_plain_version(st, shape, form, lanes):
    """The emulated pair stage's y is bitwise ``kernels.ref``'s SpMV (the
    plain version on the padded operand, the old pass's order), lane by
    lane, in both operand forms (the unpadded one is what an f32 SpMV on the
    pair stage would read), in runs of 8 planes (a ragged last run) and
    kRingRun."""
    lo = int(form == "zero_halo")
    _, xp, xin = operand(shape, lanes, bool(lo), seed=3 * lanes + lo)
    want = ref.stencil_spmv_ref(xp, stencil=STENCILS[st])
    for run in (8, G["kRingRun"]):
        got = ring_pair_spmv(xin, shape, lanes, lo, st, run)
        assert torch.equal(got, want), float((got - want).abs().max())


def within_an_ulp(got: np.ndarray, want: np.ndarray) -> bool:
    """|got − want| at most one float32 ulp of want at every point."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return bool(np.all(np.abs(got.astype(np.float64) - want) <= np.spacing(np.abs(want))))


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("shape", EVEN, ids=str)
@pytest.mark.parametrize("st", STENCIL_NAMES)
def test_f32_pair_pass_jacobi_is_the_plain_version(st, shape, lanes):
    """f32's block-Jacobi sweep on the ring: padded z, A z from the emulated
    pair stage in runs of kRingRunJacobi, then ``JacobiTail<float>``'s pair
    form on both lanes of each pair at once: z + (ω·(r − A z))/diag with the
    CPU's division is bitwise ``kernels.ref``'s sweep and, lane by lane, the
    reference's oracle; the card's form multiplies by the float32
    reciprocal (as eager PyTorch divides on CUDA), its update within an ulp
    a point of the division's, and adds it to z the same way."""
    omega = f32_scalar(0.8)
    z, zp, _ = operand(shape, lanes, False, seed=11)
    r = f32(12, (lanes, *shape))
    stencil = STENCILS[st]
    az = ring_pair_spmv(zp, shape, lanes, 0, st, G["kRingRunJacobi"])
    zq, rq, azq = pairs_of(z, r, az)
    step = omega * (rq - azq)
    divided = step / stencil.diag
    inv = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(stencil.diag,
                                                                dtype=torch.float32)
    assert within_an_ulp(to_np(step * inv), to_np(divided))
    plain = (zq + divided).reshape(lanes, *shape)
    want = ref.block_jacobi_sweep_ref(zp, r, stencil=stencil, omega=omega)
    assert torch.equal(plain, want)
    jref = ref_module("kernels.ref")
    jst = ref_module("core.operators").STENCILS[st]
    for i in range(lanes):
        jz = jref.block_jacobi_sweep_ref(jnp.asarray(to_np(zp[i])), jnp.asarray(to_np(r[i])),
                                         stencil=jst, omega=omega)
        assert np.asarray(jz).dtype == np.float32
        np.testing.assert_array_equal(np.asarray(jz), to_np(plain[i]))


@pytest.mark.parametrize("aliased", [False, True], ids=["d", "d_is_z"])
@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("shape", EVEN, ids=str)
@pytest.mark.parametrize("st", STENCIL_NAMES)
def test_f32_pair_pass_cheb_is_the_plain_version(st, shape, lanes, aliased):
    """f32's Chebyshev step on the ring: padded z, A z from the emulated
    pair stage in runs of kRingRunCheb, then ``ChebTail<float>``'s pair form
    on both lanes of each pair at once (float32 tensors, one rounding an
    operation, in the plain version's order): d' = a·d + c·(r − A z) and
    z' = z + d' bitwise ``kernels.ref``'s step and, lane by lane, the
    reference's oracle, with d the same tensor as z (the first step of an
    apply) too."""
    a, c = f32_scalar(0.3719), f32_scalar(0.1137)
    z, zp, _ = operand(shape, lanes, False, seed=13)
    r = f32(14, (lanes, *shape))
    d = z if aliased else f32(15, (lanes, *shape))
    stencil = STENCILS[st]
    az = ring_pair_spmv(zp, shape, lanes, 0, st, G["kRingRunCheb"])
    zq, rq, dq, azq = pairs_of(z, r, d, az)
    dn = a * dq + c * (rq - azq)
    zn = zq + dn
    got = [t.reshape(lanes, *shape) for t in (zn, dn)]
    want = ref.cheb_fused_step_ref(zp, r, d, stencil=stencil, a=a, c=c)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    jref = ref_module("kernels.ref")
    jst = ref_module("core.operators").STENCILS[st]
    for i in range(lanes):
        jz, jd = jref.cheb_fused_step_ref(*(jnp.asarray(to_np(t[i])) for t in (zp, r, d)),
                                          stencil=jst, a=a, c=c)
        np.testing.assert_array_equal(np.asarray(jz), to_np(got[0][i]))
        np.testing.assert_array_equal(np.asarray(jd), to_np(got[1][i]))


def test_f32_unit_fma_is_the_multiply_and_add():
    """Where off is ±1 f32's pair stage takes each neighbour term as one
    fmaf (``ring_term``'s UNIT): off·x is then exact, so the fma's one
    rounding of off·x + acc is add_rn(acc, mul_rn(off, x)).  Checked on
    seeded float32 bit patterns of x (every exponent) and the special ones
    against seeded and special accumulators (zeros of both signs,
    subnormals, the largest finite values, infinities), the fma taken as
    off·x + acc in float64 rounded to float32 (exact: an addend more than 29
    binades below the other leaves the float32 sum unchanged, and otherwise
    the float64 sum is exact)."""
    rng = np.random.default_rng(35)
    bits = rng.integers(0, 2 ** 32, 1 << 16, dtype=np.uint64).astype(np.uint32)
    special = np.array([0.0, -0.0, 1e-45, -1e-45, 1.1754942e-38, 3.4028235e38, -3.4028235e38,
                        np.inf, -np.inf, 1.0, -1.0, 2.0 ** -24, 1.5], np.float32)
    xs = torch.from_numpy(np.concatenate([bits.view(np.float32), special]))
    xs = xs[~torch.isnan(xs)]
    accs = torch.cat([torch.from_numpy(special), f32(8, (40,)) * 100,
                      torch.from_numpy(rng.integers(0, 2 ** 32, 40, dtype=np.uint64)
                                       .astype(np.uint32).view(np.float32))])
    accs = accs[~torch.isnan(accs)]
    for off in (-1.0, 1.0):
        for acc in accs:
            want = acc + off * xs
            fma = (acc.double() + off * xs.double()).to(torch.float32)
            same = torch.isnan(want) & torch.isnan(fma)
            assert bool(torch.all((want.view(torch.int32) == fma.view(torch.int32)) | same)), \
                float(acc)
    sten = " ".join((lint.CSRC / "stencil.cuh").read_text().split())
    assert ("float2 fma_rn(float2 a, float2 b, float2 c) { return make_float2(__fmaf_rn(a.x, "
            "b.x, c.x), __fmaf_rn(a.y, b.y, c.y)); }") in sten
    assert "const bool unit = off == 1.0 || off == -1.0;" in sten


#: stencil.cuh: the per-tail rule of f32's pair stage, its pair forms and
#: the alignment they need
F32_PAIR_TAILS = ("template <> struct f32_pair_tail<ChebTail<float>> : std::true_type {}; "
                  "template <> struct f32_pair_tail<JacobiTail<float>> : std::true_type {};")
JACOBI_PAIR = ("store_pair(z_out, e, add_rn(zc, scale_rn(mul_rn(w2, sub_rn(load_pair(r, e), "
               "az)), inv_diag)));")
F32_STAGES = "std::integer_sequence<int, kStagePairPadded, kStagePairUnpadded>"


def test_f32_stage_rule_mirror_matches_the_source():
    """``stencil_spmv.ring_stage`` with ``kernel=`` is the source's per-tail
    rule: f32's Chebyshev and block-Jacobi tails (``f32_pair_tail``) copy
    8-byte pairs where nz is even and the operand (and every stream)
    8-byte aligned, and copy elements otherwise; every other f32 kernel
    copies elements at any alignment; the pair tails' instances are the
    pair stage's two forms alone, and ``precond``'s mirrors send the
    launches without the pair stage to ``stencil_kernel``."""
    sten = " ".join((lint.CSRC / "stencil.cuh").read_text().split())
    assert F32_PAIR_TAILS in sten and F32_STAGES in sten
    assert stencil_spmv.F32_PAIR_KERNELS == ("cheb_fused_step", "block_jacobi_sweep")
    f = torch.float32
    for kernel in stencil_spmv.F32_PAIR_KERNELS:
        assert stencil_spmv.ring_stage(f, 128, False, 256, kernel=kernel) == "pair_padded"
        assert stencil_spmv.ring_stage(f, 128, True, 256, kernel=kernel) == "pair_unpadded"
        assert stencil_spmv.ring_stage(f, 129, False, 256, kernel=kernel) == "async"
        assert stencil_spmv.ring_stage(f, 128, False, 260, kernel=kernel) == "async"
        assert stencil_spmv.ring_stage(f, 128, False, 256, (512, 1028), kernel=kernel) \
            == "async"
        assert stencil_spmv.ring_stage(f, 128, False, 256, (512, 1032), kernel=kernel) \
            == "pair_padded"
    for kernel in ("stencil_spmv", "bicgstab_fused_spmv_dots", "rb_gs_half_sweep"):
        assert {stencil_spmv.ring_stage(f, nz, zh, p, kernel=kernel) for nz in (6, 7)
                for zh in (False, True) for p in (0, 4, 8)} == {"async"}
    # bf16's rule is the kernel's whatever the kernel (4-byte pairs)
    assert stencil_spmv.ring_stage(torch.bfloat16, 128, False, 260,
                                   kernel="block_jacobi_sweep") == "pair_padded"
    for mirror, kernel in ((precond.cheb_pass, "cheb_fused_step"),
                           (precond.jacobi_pass, "block_jacobi_sweep")):
        assert mirror(f, 128, 256, (512,)) == "ring"
        assert mirror(f, 129, 256, (512,)) == mirror(f, 128, 260) == "stencil"
        assert mirror(f, 128, 256, (516,)) == "stencil"
        assert mirror(torch.float64, 128, 256) == "ring"
        assert mirror(torch.bfloat16, 129, 258) == "ring"


def test_f32_misaligned_view_takes_the_old_pass():
    """A contiguous float32 view one element past an 8-byte boundary is
    4-byte aligned but not 8: its sweeps copy elements, so ``precond.cu``
    keeps them on ``stencil_kernel``; a misaligned ``r`` alone does the
    same."""
    buf = torch.zeros(1 + 6 * 8 * 10, dtype=torch.float32)
    view = buf[1:].view(6, 8, 10)
    assert view.is_contiguous() and view.data_ptr() % 8 == 4
    aligned = buf[:-1].view(6, 8, 10)
    r = torch.zeros((4, 6, 8), dtype=torch.float32)
    for kernel, mirror in (("cheb_fused_step", precond.cheb_pass),
                           ("block_jacobi_sweep", precond.jacobi_pass)):
        assert stencil_spmv.ring_stage(torch.float32, 8, False, view.data_ptr(),
                                       kernel=kernel) == "async"
        assert mirror(torch.float32, 8, view.data_ptr(), (r.data_ptr(),)) == "stencil"
        assert mirror(torch.float32, 8, aligned.data_ptr(), (r.data_ptr(),)) == "ring"
        assert mirror(torch.float32, 8, aligned.data_ptr(),
                      (buf[1:].data_ptr(),)) == "stencil"


def test_f32_pair_forms_are_the_scalar_forms():
    """``ChebTail`` and ``JacobiTail`` take a pair form in f32 (one call for
    a thread's two outputs, r (and d) loaded and z' (and d') stored as
    float2, 8-byte aligned: ``pairs_aligned``), whose float2 operations
    round each lane as the scalar form rounds it, in its order; bf16's
    Jacobi tail keeps its two scalar calls."""
    sten = " ".join((lint.CSRC / "stencil.cuh").read_text().split())
    assert JACOBI_PAIR in sten
    assert "z_out[e] = add_rn(zc, scale_rn(mul_rn(omega, sub_rn(r[e], az)), inv_diag));" in sten
    assert "bool pairs_aligned() const { return repro::pairs_aligned(r, z_out); }" in sten
    assert "% (2 * sizeof(P)) == 0" in sten
    for op, intr in (("mul_rn", "__fmul_rn"), ("add_rn", "__fadd_rn"), ("sub_rn", "__fsub_rn")):
        assert (f"float2 {op}(float2 a, float2 b) {{ return make_float2({intr}(a.x, b.x), "
                f"{intr}(a.y, b.y)); }}") in sten
    assert "float2 scale_rn(float2 v, float s) {" in sten
    assert re.search(r"struct pair_tail<JacobiTail<__nv_bfloat16>> : std::false_type", sten)
