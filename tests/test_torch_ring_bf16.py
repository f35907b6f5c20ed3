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
  bf16 one operation at a time: bitwise ``kernels.ref``'s SpMV,
  block-Jacobi sweep, Chebyshev step, red-black half-sweep (the ring's
  off-diagonal form, both colours) and BiCGStab's two passes and the
  reference's oracles at small ragged shapes (the tails with a pair form
  take both lanes of a pair at once, each lane rounded on its own; the
  half-sweep's two lanes have opposite parities, so one takes the update
  and the other keeps its centre value);
  the dots pass's nine partials summed as the card sums them (each thread's
  outputs in turn, ``block_sum``'s trees, ``reduce_partials``' slots) over
  ``ring_tail_num_blocks`` slots, within 1e-5·Σ|a_i·b_i| of the oracles';
* the Python mirrors of ``precond.cu``'s Chebyshev rule, ``rb_gs.cu``'s
  rule (``rb_gs.sweep_pass``) and ``bicgstab_fused.cu``'s two rules and
  slot count, and of the rule that sends a pair tail with a misaligned
  stream to the register stage;
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
from repro_torch.kernels import bicgstab_fused, precond, rb_gs, ref, stencil_spmv

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
                   run: int, offdiag: bool = False) -> torch.Tensor:
    """y = A x as the pair stage computes it: per block, the slot tiles the
    copy plan assembles, each thread's pairs read through ``pair_reads``,
    both lanes summed at once (bf16 tensors of (..., 2), one rounding an
    operation: torch's CPU bf16 rounds each multiply and add once) in
    ``ring_first``/``ring_last``'s order, each output ended on the plane
    after its centre plane; (lanes, nx, ny, nz).  With ``offdiag`` the
    off-diagonal sum (A − D) x instead: the sum starts from +0 in place of
    diag·c[4], the terms the same (a tail that declares ``kOffDiag``)."""
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
            acc = (torch.zeros_like(planes["c"][..., 4, :]) if offdiag
                   else diag * planes["c"][..., 4, :])
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


def bf16_of(seed: int, shape) -> torch.Tensor:
    """A seeded bf16 tensor of ``shape``."""
    return torch.from_numpy(seeded(shape, seed, np.float32)).to(torch.bfloat16)


def jx(t: torch.Tensor):
    """A bf16 tensor as a JAX bf16 array."""
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def bf16_scalar(v: float) -> float:
    """``v`` rounded to bf16, kept a Python float (``ref.scalars_like``)."""
    return float(torch.tensor(v, dtype=torch.bfloat16))


@pytest.mark.parametrize("aliased", [False, True], ids=["d", "d_is_z"])
@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("shape", [s for s in SHAPES if s[2] % 2 == 0], ids=str)
@pytest.mark.parametrize("st", STENCIL_NAMES)
def test_pair_pass_cheb_is_the_plain_version(st, shape, lanes, aliased):
    """bf16's Chebyshev step on the ring (``precond.cu``'s ``cheb_on_ring``):
    padded z, A z from the emulated pair stage in runs of kRingRunCheb, then
    the pair form of ``ChebTail`` on both lanes of each pair at once (bf16
    tensors, one rounding an operation, in the plain version's order):
    d' = a·d + c·(r − A z) and z' = z + d' bitwise ``kernels.ref``'s step
    and, lane by lane, the reference's oracle; with d the same tensor as z
    (the first step of an apply) too."""
    a, c = bf16_scalar(0.3719), bf16_scalar(0.1137)
    z, zp, _ = operand(shape, lanes, False, seed=13)
    r = bf16_of(14, (lanes, *shape))
    d = z if aliased else bf16_of(15, (lanes, *shape))
    stencil = STENCILS[st]
    az = ring_pair_spmv(zp, shape, lanes, 0, st, G["kRingRunCheb"])
    pairs = [t.reshape(*t.shape[:-1], -1, PAIR_LANES) for t in (z, r, d, az)]
    zq, rq, dq, azq = pairs
    dn = a * dq + c * (rq - azq)
    zn = zq + dn
    got = [t.reshape(lanes, *shape) for t in (zn, dn)]
    want = ref.cheb_fused_step_ref(zp, r, d, stencil=stencil, a=a, c=c)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    jref = ref_module("kernels.ref")
    jst = ref_module("core.operators").STENCILS[st]
    for i in range(lanes):
        jz, jd = jref.cheb_fused_step_ref(jx(zp[i]), jx(r[i]), jx(d[i]), stencil=jst, a=a, c=c)
        np.testing.assert_array_equal(np.asarray(jz.astype(jnp.float32)), to_np(got[0][i].float()))
        np.testing.assert_array_equal(np.asarray(jd.astype(jnp.float32)), to_np(got[1][i].float()))


def tree_sum(v: np.ndarray) -> np.float32:
    """``block_sum``'s sum in float32 of one block's values, one a thread
    in thread order: each warp's shuffle tree (lane i adds lane i + o for o
    = 16, 8, 4, 2, 1), then the same tree over the warps' sums."""
    def warp(w):
        w = np.array(w, np.float32)
        for o in (16, 8, 4, 2, 1):
            w[:o] = w[:o] + w[o:2 * o]
        return w[0]

    sums = [warp(v[i:i + 32]) for i in range(0, len(v), 32)]
    return warp(np.concatenate([np.array(sums, np.float32),
                                np.zeros(32 - len(sums), np.float32)]))


def ring_pair_partials(terms, shape, run: int) -> np.ndarray:
    """The dots pass's partials as the ring sums them (one lane): each
    thread (ty, tz) of a block adds the float32 products of its outputs
    (s, k), (s, k + 1), (s + 1, k), ... in turn (the pair form: lane k
    first), the block sums its threads (:func:`tree_sum`) into its slot,
    and ``reduce_partials`` sums the slots (thread t takes slots t, t +
    1024, ..., then the block's tree); ``terms`` are the (a, b) operands of
    each dot."""
    nx, ny, nz = shape
    prods = [np.asarray((a.float() * b.float()).numpy(), np.float32) for a, b in terms]
    slots = np.zeros((len(terms), len(blocks(shape, 1, run))), np.float32)
    for b, (bx, by, bz) in enumerate(blocks(shape, 1, run)):
        i0, k0, j0 = bz * run, bx * RING_Z, by * RING_Y
        acc = np.zeros((len(terms), RING_Y, PAIR_Z), np.float32)
        for s in range(min(run, nx - i0)):
            for lane in range(PAIR_LANES):
                for d, pr in enumerate(prods):
                    tile = np.zeros((RING_Y, PAIR_Z), np.float32)
                    ks = k0 + PAIR_LANES * np.arange(PAIR_Z) + lane
                    js = j0 + np.arange(RING_Y)
                    inside = (js < ny)[:, None] & (ks < nz)[None, :]
                    tile[inside] = pr[i0 + s][np.ix_(js[js < ny], ks[ks < nz])].reshape(-1)
                    acc[d] = acc[d] + tile
        for d in range(len(terms)):
            slots[d, b] = tree_sum(acc[d].reshape(-1))
    out = np.zeros(len(terms), np.float32)
    threads = lint.STENCIL_GEOMETRY["kReduceThreads"]
    for d in range(len(terms)):
        v = np.zeros(threads, np.float32)
        for first in range(0, slots.shape[1], threads):
            chunk = slots[d, first:first + threads]
            v[:len(chunk)] = v[:len(chunk)] + chunk
        out[d] = tree_sum(v)
    return out


@pytest.mark.parametrize("aliased", [False, True], ids=["distinct", "first_iteration"])
@pytest.mark.parametrize("shape", [s for s in SHAPES if s[2] % 2 == 0], ids=str)
@pytest.mark.parametrize("st", STENCIL_NAMES)
def test_pair_pass_bicgstab_dots_is_the_plain_version(st, shape, aliased):
    """bf16's BiCGStab dots pass on the ring (``bicgstab_fused.cu``'s
    ``bicgstab_dots_on_ring``): v = A z̃ from the emulated pair stage in runs
    of kRingRunBicgDots (z̃ is not z: the centre is not used), q = r − α s and
    y = w − α z on both lanes of each pair at once: bitwise ``kernels.ref``'s
    pass and the reference's oracle; the nine partials summed in the ring's
    order over ``ring_tail_num_blocks`` slots within 1e-5·Σ|a_i·b_i| of both
    oracles'.  ``first_iteration``: one tensor in several slots (r̂ = r,
    s = w, t = z), as BiCGStab's first iteration passes them."""
    run = G["kRingRunBicgDots"]
    alpha = bf16_scalar(0.3719)
    _, zp, _ = operand(shape, 1, False, seed=21)
    z, r, w, s, rhat, t = (bf16_of(30 + i, shape) for i in range(6))
    if aliased:
        rhat, s, t = r, w, z
    v = ring_pair_spmv(zp, shape, 1, 0, st, run)[0]
    zq, rq, wq, sq = (x.reshape(*shape[:-1], -1, PAIR_LANES) for x in (z, r, w, s))
    q = (rq - alpha * sq).reshape(shape)
    y = (wq - alpha * zq).reshape(shape)
    terms = [(q, y), (y, y), (q, q), (rhat, q), (rhat, y), (rhat, t), (rhat, v), (rhat, z),
             (rhat, s)]
    parts = ring_pair_partials(terms, shape, run)
    assert len(blocks(shape, 1, run)) == math.prod(lint.stencil_ring_grid(shape, 1, run))
    stencil = STENCILS[st]
    vr, qr, yr, pr = ref.bicgstab_spmv_dots_ref(zp[0], z, r, w, s, rhat, t,
                                                torch.tensor(alpha, dtype=torch.bfloat16),
                                                stencil=stencil)
    assert torch.equal(v, vr) and torch.equal(q, qr) and torch.equal(y, yr)
    jref = ref_module("kernels.ref")
    jst = ref_module("core.operators").STENCILS[st]
    jv, jq, jy, jp = jref.bicgstab_spmv_dots_ref(
        jx(zp[0]), *(jx(x) for x in (z, r, w, s, rhat, t)), jnp.bfloat16(alpha), stencil=jst)
    for jo, o in ((jv, v), (jq, q), (jy, y)):
        np.testing.assert_array_equal(np.asarray(jo.astype(jnp.float32)), to_np(o.float()))
    for got, mine, theirs, (a, b) in zip(parts, pr, jp, terms):
        bound = 1e-5 * float((a.double() * b.double()).abs().sum())
        assert mine.dtype == torch.float32
        assert abs(float(got) - float(mine)) <= bound
        assert abs(float(got) - float(theirs)) <= bound


@pytest.mark.parametrize("colour", [0, 1])
@pytest.mark.parametrize("shape", [s for s in SHAPES if s[2] % 2 == 0], ids=str)
@pytest.mark.parametrize("st", STENCIL_NAMES)
def test_pair_pass_rb_gs_is_the_plain_version(st, shape, colour):
    """bf16's red-black half-sweep on the ring (``rb_gs.cu``'s ``on_ring``):
    the off-diagonal sum from the emulated pair stage in runs of
    kRingRunRbGs (from +0, the centre left out), then ``RbGsTail``'s pair
    form on both lanes of each pair: b − off on the pair, each lane's
    parity (i + j + k) & 1 with lane k even, so the two lanes of a pair
    have opposite parities and exactly one takes the update (b − off)/diag
    (the CPU's division; on the card both sides multiply by the f32
    reciprocal) while the other keeps its centre value: bitwise
    ``kernels.ref``'s half-sweep and the reference's oracle, in both
    colours."""
    _, xp, _ = operand(shape, 1, False, seed=41 + colour)
    b = bf16_of(42, shape)
    stencil = STENCILS[st]
    off = ring_pair_spmv(xp, shape, 1, 0, st, G["kRingRunRbGs"], offdiag=True)[0]
    xc = xp[0, 1:-1, 1:-1, 1:-1]
    oq, bq, xq = (v.reshape(*shape[:-1], -1, PAIR_LANES) for v in (off, b, xc))
    upd = (bq - oq) / stencil.diag
    i, j, k = np.indices(xq.shape[:-1])
    parity = (i + j + PAIR_LANES * k) % 2                   # lane k's; k even
    lanes = np.stack([parity, parity ^ 1], -1) == colour
    assert np.all(lanes.sum(-1) == 1)                       # one lane of each pair
    got = torch.where(torch.from_numpy(lanes), upd, xq).reshape(shape)
    want = ref.rb_gs_half_sweep_ref(xp[0], b, stencil=stencil, colour=colour)
    assert torch.equal(got, want)
    kept = torch.from_numpy(~lanes.reshape(shape))
    assert torch.equal(got[kept], xc[kept])
    jref = ref_module("kernels.ref")
    jst = ref_module("core.operators").STENCILS[st]
    jg = jref.rb_gs_half_sweep_ref(jx(xp[0]), jx(b), stencil=jst, colour=colour)
    np.testing.assert_array_equal(np.asarray(jg.astype(jnp.float32)), to_np(got.float()))


@pytest.mark.parametrize("aliased", [False, True], ids=["distinct", "first_iteration"])
@pytest.mark.parametrize("shape", [s for s in SHAPES if s[2] % 2 == 0], ids=str)
@pytest.mark.parametrize("st", STENCIL_NAMES)
def test_pair_pass_bicgstab_update_is_the_plain_version(st, shape, aliased):
    """bf16's BiCGStab update pass on the ring (``bicgstab_fused.cu``'s
    ``bicgstab_update_on_ring``): t' = A w̃ from the emulated pair stage in
    runs of kRingRunBicgUpdate (w̃ is not w: the centre is not used), then
    ``BicgUpdateTail``'s pair form on both lanes of each pair at once,
    p' = r + β(p − ω s), s' = w + β(s − ω z), z' = t' + β(z − ω v), each
    lane rounded as the scalar form: bitwise ``kernels.ref``'s pass and the
    reference's oracle.  ``first_iteration``: one tensor in several slots
    (p = r, s = w): inputs are only read, the outputs fresh."""
    run = G["kRingRunBicgUpdate"]
    omega, beta = (torch.tensor(bf16_scalar(c), dtype=torch.bfloat16)
                   for c in (1.3, -0.41))
    _, wp, _ = operand(shape, 1, False, seed=51)
    w, r, p, s, z, v = (bf16_of(60 + i, shape) for i in range(6))
    if aliased:
        p, s = r, w
    tn = ring_pair_spmv(wp, shape, 1, 0, st, run)[0]
    wq, rq, pq, sq, zq, vq, tq = (x.reshape(*shape[:-1], -1, PAIR_LANES)
                                  for x in (w, r, p, s, z, v, tn))
    got = (tn, (rq + beta * (pq - omega * sq)).reshape(shape),
           (wq + beta * (sq - omega * zq)).reshape(shape),
           (tq + beta * (zq - omega * vq)).reshape(shape))
    stencil = STENCILS[st]
    want = ref.bicgstab_spmv_update_ref(wp[0], w, r, p, s, z, v, omega, beta, stencil=stencil)
    assert all(torch.equal(g, x) for g, x in zip(got, want))
    jref = ref_module("kernels.ref")
    jst = ref_module("core.operators").STENCILS[st]
    jo = jref.bicgstab_spmv_update_ref(jx(wp[0]), *(jx(x) for x in (w, r, p, s, z, v)),
                                       jnp.bfloat16(float(omega)), jnp.bfloat16(float(beta)),
                                       stencil=jst)
    for a, g in zip(jo, got):
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)), to_np(g.float()))


#: the stage rule as ``csrc/stencil.cuh``'s ``ring_stage`` writes it (bf16
#: always copies pairs where it can, f32 with the tails of f32_pair_tail), and
#: the stages ``ring_stages`` instantiates for bf16
STAGE_RULE = ("  if (!ring_pairs<T, Tail>()) return kStageAsync;\n"
              "  const bool pairs = nz % 2 == 0 && reinterpret_cast<uintptr_t>(x) % "
              "(2 * sizeof(T)) == 0;\n"
              "  if (!pairs) return sizeof(T) == 2 ? kStageRegister : kStageAsync;\n"
              "  return zero_halo ? kStagePairUnpadded : kStagePairPadded;\n")
BF16_STAGES = ("std::integer_sequence<int, kStageRegister, kStagePairPadded, "
               "kStagePairUnpadded>")
#: precond.cu's rule for both sweeps (block_jacobi_sweep, cheb_fused_step:
#: bf16 and f64 always on the ring, f32 at its pair stage), and their launch
#: under it
PRECOND_RULE = ("bool on_ring(const T* z, int zero_halo, const Tail& tail, int nz, "
                "int npoint) {\n"
                "  if constexpr (std::is_same<T, float>::value)\n"
                "    return repro::pair_stage(repro::ring_tail_stage<T>(tail, nz, zero_halo, "
                "z)) &&\n"
                "           (npoint == 27 || !std::is_same<Tail, repro::ChebTail<T>>::value);\n"
                "  else\n"
                "    return true;\n}")
PRECOND_LAUNCH = ("  if (!old_pass && on_ring(z, zero_halo, tail, nz, npoint))\n"
                  "    return repro::launch_stencil_ring<T>(z, zero_halo, tail, nullptr, nullptr, "
                  "nx, ny, nz,")


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
    """``precond.jacobi_pass`` is ``precond.cu``'s rule: bf16's and f64's
    sweep (one lane or a batch) launch the ring pass, and so does f32's
    where it takes the pair stage (nz even, operands 8-byte aligned; else
    ``stencil_kernel``); the lint's row names the same dtypes."""
    text = (lint.CSRC / "precond.cu").read_text()
    assert PRECOND_RULE in text and PRECOND_LAUNCH in text
    assert precond.JACOBI_RING_DTYPES == (torch.bfloat16, torch.float32, torch.float64)
    assert [precond.jacobi_pass(d) for d in (torch.float64, torch.float32, torch.bfloat16)] \
        == ["ring", "ring", "ring"]
    assert [precond.jacobi_pass(d, 7) for d in (torch.float64, torch.float32, torch.bfloat16)] \
        == ["ring", "stencil", "ring"]
    spec = next(s for s in lint.KERNEL_TABLE if s.name == "jacobi_sweep")
    assert spec.ring_dtypes == ("bfloat16", "float32", "float64")
    assert lint.launched_passes(spec) == ["stencil", "ring"]


#: bicgstab_fused.cu's rule for the dots pass, its launch, and the partial
#: slots it reports under the rule
DOTS_RULE = ("constexpr bool bicgstab_dots_on_ring() {\n"
             "  return std::is_same<T, __nv_bfloat16>::value;\n}")
DOTS_LAUNCH = ("  if constexpr (bicgstab_dots_on_ring<T>())\n"
               "    return repro::launch_stencil_ring<T>(x, 0, tail, parts, out,")
DOTS_SLOTS = ("  if constexpr (bicgstab_dots_on_ring<T>())\n"
              "    return repro::ring_tail_num_blocks<BicgDotsTail<T>>(nx, ny, nz);\n"
              "  else\n"
              "    return repro::stencil_num_blocks(nx, ny, nz);")
DOTS_RUN = ("struct ring_run<BicgDotsTail<T>> : std::integral_constant<int, kRingRunBicgDots> {\n"
            "  using choices = std::integer_sequence<int, kRingRunBicgDots>;")
CHEB_RUN = ("struct ring_run<ChebTail<T>> : std::integral_constant<int, kRingRunCheb> {\n"
            "  using choices = std::integer_sequence<int, kRingRunCheb>;")
#: stencil.cuh: the slot count of a tail with a run of its own, the pair
#: form's call, and the stage a pair tail with a misaligned stream takes
TAIL_SLOTS = ("inline long long ring_tail_num_blocks(int nx, int ny, int nz) {\n"
              "  const dim3 g = stencil_ring_grid(nx, ny, nz, 1, ring_run<Tail>::value);")
PAIR_CALL = ("} else if constexpr (kRingPairTail && pair_tail<Tail>::value) {\n"
             "        tail.pair(e, prev[4], yv, v);")
#: the off-diagonal form's pair call (RbGsTail): lane e's parity with it
PAIR_CALL_OFFDIAG = ("        const int parity = (i0 + s + j + k) & 1;\n"
                     "        if constexpr (kRingPairTail && pair_tail<Tail>::value) {\n"
                     "          tail.pair(e, prev[4], yv, v, parity);\n"
                     "        } else {\n"
                     "          tail(e, prev[4].x, yv.x, v, parity);\n"
                     "          tail(e + 1, prev[4].y, yv.y, v, parity ^ 1);")
PAIR_STAGE = ("  if constexpr (pair_tail<Tail>::value) {\n"
              "    if (pair_stage(stage) && !tail.pairs_aligned())\n"
              "      return sizeof(T) == 2 ? kStageRegister : kStageAsync;")


def test_cheb_ring_rule_mirror_matches_the_source():
    """``precond.cheb_pass`` is ``precond.cu``'s rule (the block-Jacobi
    sweep's): bf16's and f64's Chebyshev step (one lane or a batch) launch
    the ring pass, in runs of ``kRingRunCheb``, and so does f32's at its
    pair stage on the 27pt stencil (on 7pt it lost to the old pass); the
    lint's row names the same dtypes and run."""
    assert PRECOND_RULE in (lint.CSRC / "precond.cu").read_text()
    assert PRECOND_LAUNCH in (lint.CSRC / "precond.cu").read_text()
    assert CHEB_RUN in (lint.CSRC / "stencil.cuh").read_text()
    assert precond.CHEB_RING_DTYPES == (torch.bfloat16, torch.float32, torch.float64)
    assert [precond.cheb_pass(d) for d in (torch.float64, torch.float32, torch.bfloat16)] \
        == ["ring", "ring", "ring"]
    assert precond.cheb_pass(torch.float32, 8, 4) == "stencil"     # z at an odd offset
    assert precond.cheb_pass(torch.float32, npoint=7) == "stencil"  # lost on 7pt
    assert precond.cheb_pass(torch.bfloat16, npoint=7) == "ring"
    spec = next(s for s in lint.KERNEL_TABLE if s.name == "cheb_step")
    assert spec.ring_dtypes == ("bfloat16", "float32", "float64") \
        and spec.runs == "kRingRunCheb"
    assert lint.launched_passes(spec) == ["stencil", "ring"]


def test_bicgstab_dots_ring_rule_mirror_matches_the_source():
    """``bicgstab_fused.dots_pass`` is ``bicgstab_fused.cu``'s rule: bf16's
    dots pass launches the ring pass from the padded z̃ in runs of
    ``kRingRunBicgDots``, f64 and f32 keep ``stencil_kernel``, and so does
    the update pass (its own rule, below).  The partial slots it reports follow the
    rule: the ring's block count at its run in bf16 (``ring_tail_num_blocks``,
    the emulated pass's blocks), the old pass's otherwise; the wrapper sizes
    its scratch from the dtype's entry point."""
    text = (lint.CSRC / "bicgstab_fused.cu").read_text()
    assert DOTS_RULE in text and DOTS_LAUNCH in text and DOTS_SLOTS in text
    assert DOTS_RUN in text
    assert text.count("launch_stencil_ring<") == 2
    assert TAIL_SLOTS in (lint.CSRC / "stencil.cuh").read_text()
    assert bicgstab_fused.DOTS_RING_DTYPES == (torch.bfloat16,)
    assert [bicgstab_fused.dots_pass(d) for d in (torch.float64, torch.float32,
                                                  torch.bfloat16)] \
        == ["stencil", "stencil", "ring"]
    assert set(bicgstab_fused.SIGNATURES) >= {f"bicgstab_partials_{s}"
                                              for s in ("f64", "f32", "bf16")}
    run = G["kRingRunBicgDots"]
    for shape in SHAPES + [(128, 128, 128), (128, 128, 3072)]:
        assert math.prod(lint.stencil_ring_grid(shape, 1, run)) == len(blocks(shape, 1, run))
    spec = next(s for s in lint.KERNEL_TABLE if s.name == "bicgstab_spmv_dots")
    assert spec.ring_dtypes == ("bfloat16",) and spec.runs == "kRingRunBicgDots"
    update = next(s for s in lint.KERNEL_TABLE if s.name == "bicgstab_spmv_update")
    assert lint.launched_passes(update) == ["stencil", "ring"]


#: rb_gs.cu's rule for the half-sweep and its launch under it
RB_GS_RULE = ("constexpr bool on_ring(int npoint) {\n"
              "  return (std::is_same<T, double>::value && npoint == 27) ||\n"
              "         std::is_same<T, __nv_bfloat16>::value;\n}")
RB_GS_LAUNCH = ("  if (on_ring<T>(npoint))\n"
                "    return repro::launch_stencil_ring<T>(x, 0, tail, nullptr, nullptr,")
#: bicgstab_fused.cu's rule for the update pass, its launch and its run
UPDATE_RULE = ("constexpr bool bicgstab_update_on_ring() {\n"
               "  return std::is_same<T, __nv_bfloat16>::value;\n}")
UPDATE_LAUNCH = ("  if constexpr (bicgstab_update_on_ring<T>())\n"
                 "    return repro::launch_stencil_ring<T>(x, 0, tail, nullptr, nullptr,")
UPDATE_RUN = ("struct ring_run<BicgUpdateTail<T>> : std::integral_constant<int, "
              "kRingRunBicgUpdate> {\n"
              "  using choices = std::integer_sequence<int, kRingRunBicgUpdate>;")


def test_rb_gs_ring_rule_mirror_matches_the_source():
    """``rb_gs.sweep_pass`` is ``rb_gs.cu``'s rule: the half-sweep launches
    the ring pass from the padded operand in f64 27pt and in bf16 (both
    stencils), ``stencil_kernel`` in f64 7pt and f32, in runs of
    ``kRingRunRbGs``; the lint's row names both passes."""
    text = (lint.CSRC / "rb_gs.cu").read_text()
    assert RB_GS_RULE in text and RB_GS_LAUNCH in text
    assert rb_gs.RING_DTYPES == (torch.bfloat16,) and rb_gs.RING_27PT_DTYPES == (torch.float64,)
    got = {(str(d)[6:], n): rb_gs.sweep_pass(d, n)
           for d in (torch.float64, torch.float32, torch.bfloat16) for n in (7, 27)}
    assert got == {("float64", 7): "stencil", ("float64", 27): "ring",
                   ("float32", 7): "stencil", ("float32", 27): "stencil",
                   ("bfloat16", 7): "ring", ("bfloat16", 27): "ring"}
    spec = next(s for s in lint.KERNEL_TABLE if s.name == "gs_half_sweep")
    assert spec.runs == "kRingRunRbGs" and lint.launched_passes(spec) == ["stencil", "ring"]


def test_bicgstab_update_ring_rule_mirror_matches_the_source():
    """``bicgstab_fused.update_pass`` is ``bicgstab_fused.cu``'s rule:
    bf16's update pass launches the ring pass from the padded w̃ in runs of
    ``kRingRunBicgUpdate``, f64 and f32 keep ``stencil_kernel``; the lint's
    row names the same dtype and run."""
    text = (lint.CSRC / "bicgstab_fused.cu").read_text()
    assert UPDATE_RULE in text and UPDATE_LAUNCH in text and UPDATE_RUN in text
    assert bicgstab_fused.UPDATE_RING_DTYPES == (torch.bfloat16,)
    assert [bicgstab_fused.update_pass(d) for d in (torch.float64, torch.float32,
                                                    torch.bfloat16)] \
        == ["stencil", "stencil", "ring"]
    spec = next(s for s in lint.KERNEL_TABLE if s.name == "bicgstab_spmv_update")
    assert spec.ring_dtypes == ("bfloat16",) and spec.runs == "kRingRunBicgUpdate"
    assert lint.launched_passes(spec) == ["stencil", "ring"]


def test_bicgstab_slots_follow_the_dtype():
    """``bicgstab_fused.partial_slots`` asks the entry point of the vectors'
    dtype (``bicgstab_partials_<sfx>``), whose count follows the pass that
    dtype launches (the source's text above; the built library's answers:
    ``-k bicgstab_partials`` in ``tests/test_torch_cuda.py``), so a bf16
    scratch holds the ring's slots."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *shape: calls.append((name, shape)) or len(calls)

    shape = (9, 13, 70)
    got = [bicgstab_fused.partial_slots(Lib(), dt, shape)
           for dt in (torch.float64, torch.float32, torch.bfloat16)]
    assert got == [1, 2, 3]
    assert calls == [(f"bicgstab_partials_{s}", shape) for s in ("f64", "f32", "bf16")]


def test_pair_tails_and_their_stage_rule():
    """``ChebTail``, ``RbGsTail`` and both BiCGStab tails have a pair form,
    called once for a thread's two outputs on the pair stage
    (``kRingPairTail``; the half-sweep's with lane e's parity, the two
    scalar calls with opposite parities otherwise), which loads and stores
    their unpadded streams as bf16 pairs; a pair tail whose streams are not
    all 4-byte aligned sends the launch to the register stage, as
    ``stencil_spmv.ring_stage(streams=...)`` mirrors (the half-sweep's b,
    the update pass's ten streams); the other tails keep the scalar calls
    in bf16, ``JacobiTail`` among them (its pair form is f32's:
    ``tests/test_torch_ring_f32.py``)."""
    sten = " ".join((lint.CSRC / "stencil.cuh").read_text().split())
    bicg = " ".join((lint.CSRC / "bicgstab_fused.cu").read_text().split())
    assert " ".join(PAIR_CALL.split()) in sten and " ".join(PAIR_STAGE.split()) in sten
    assert " ".join(PAIR_CALL_OFFDIAG.split()) in sten
    assert "bool pairs_aligned() const { return repro::pairs_aligned(r, d, z_out, d_out); }" \
        in sten
    assert "bool pairs_aligned() const { return repro::pairs_aligned(b, x_out); }" in sten
    assert ("return repro::pairs_aligned(z, r, w, s, rhat, t, v_out, q_out, y_out);"
            in bicg)
    assert ("return repro::pairs_aligned(w, r, p, s, z, v, t_out, p_out, s_out, z_out);"
            in bicg)
    assert len(re.findall(r"void pair\(int64_t e,", sten + bicg)) == 5
    assert "struct pair_tail<JacobiTail<__nv_bfloat16>> : std::false_type {};" in sten
    bf = torch.bfloat16
    assert stencil_spmv.ring_stage(bf, 128, False, 256, streams=(512, 1024)) == "pair_padded"
    assert stencil_spmv.ring_stage(bf, 128, False, 256, streams=(512, 1026)) == "register"
    assert stencil_spmv.ring_stage(bf, 129, False, 256, streams=(512,)) == "register"
    assert stencil_spmv.ring_stage(torch.float32, 128, False, 256, streams=(2,)) == "async"
    buf = torch.zeros(1 + 4 * 6 * 8, dtype=bf)
    r = buf[1:].view(4, 6, 8)
    assert stencil_spmv.ring_stage(bf, 8, False, buf[:-1].data_ptr(),
                                   streams=(r.data_ptr(),)) == "register"
    # the half-sweep's and the update pass's streams: one misaligned sends
    # the launch to the register stage, an aligned set keeps the pair stage
    xp = torch.zeros((6, 8, 10), dtype=bf)
    b, out = torch.zeros((4, 6, 8), dtype=bf), torch.zeros((4, 6, 8), dtype=bf)
    assert stencil_spmv.ring_stage(bf, 8, False, xp.data_ptr(),
                                   streams=(b.data_ptr(), out.data_ptr())) == "pair_padded"
    assert stencil_spmv.ring_stage(bf, 8, False, xp.data_ptr(),
                                   streams=(r.data_ptr(), out.data_ptr())) == "register"
    ten = [torch.zeros((4, 6, 8), dtype=bf).data_ptr() for _ in range(10)]
    assert stencil_spmv.ring_stage(bf, 8, False, xp.data_ptr(), streams=ten) == "pair_padded"
    assert stencil_spmv.ring_stage(bf, 8, False, xp.data_ptr(),
                                   streams=ten[:9] + [r.data_ptr()]) == "register"


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
