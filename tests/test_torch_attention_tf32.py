"""The arithmetic of the 3xTF32 attention body, emulated on the CPU in numpy.

``csrc/flash_attention.cu``'s ``flash_f32_tf32x3_kernel`` (float32 at hd 64
and 128 on the card) runs both products of attention on the tensor cores in
TF32, which keeps 10 mantissa bits.  It splits each operand x into
hi = tf32(x) and lo = tf32(x − hi), rounding to nearest with ties away from
zero (``cvt.rna.tf32.f32``), and sums hi·hi + hi·lo + lo·hi into one f32
accumulator.  The kernel runs only on the card, so this file emulates its
arithmetic tile by tile: 64 query rows a consumer warpgroup (which visits
the 32-key tiles a 64-row block would), 32 keys a tile, the online
softmax in base 2, the products as f32 matrix products of TF32 values
(exact products, f32 sums), and the PV product with the keys of each group
of 8 permuted as the producer stages Vᵀ and the consumer forms p's A
fragments from its score registers.

At internlm2-1.8b's and hymba-1.5b's attention widths (16 heads of 128, 25
heads of 64), S = 256, causal and with a window of 64, on seeded inputs:
three products meet the f32 tolerance of the reference tests (rtol 1e-4,
atol 1e-5) against the JAX package's ``flash_attention_ref``, one product
does not, and the permutation changes no result beyond f32 rounding
(a few ulps of the PV product's terms).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_harness import ref_module, seeded

F32_TOLS = dict(rtol=1e-4, atol=1e-5)
BQ, BKV = 64, 32                     # query rows a consumer warpgroup, keys a tile
NEG_INF = np.float32(-2.3819763e38)  # the source's kNegInf
LOG2E = np.float32(1.4426950408889634)

#: (H, hd, window) at S = 256: the attention widths of
#: src/repro/configs/internlm2_1_8b.py and src/repro/configs/hymba_1_5b.py
CASES = {"internlm2_causal": (16, 128, 0), "internlm2_window64": (16, 128, 64),
         "hymba_causal": (25, 64, 0), "hymba_window64": (25, 64, 64)}
S = 256


def tf32(x: np.ndarray) -> np.ndarray:
    """float32 rounded to TF32 by bit operations: add half a unit of the
    13th bit and clear the low 13 bits (to nearest, ties away from zero,
    as ``cvt.rna.tf32.f32``)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(a: np.ndarray, b: np.ndarray, passes: int) -> np.ndarray:
    """a @ b from TF32 parts, accumulated in f32: hi·hi alone (1 pass), or
    lo·hi + hi·lo + hi·hi as the body issues them (3 passes)."""
    ah, al = split(a)
    bh, bl = split(b)
    if passes == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


def stage_vt(v: np.ndarray) -> np.ndarray:
    """The producer's Vᵀ of one (32, hd) tile: 16-byte chunk kc of each row
    of hd holds keys 8·(kc // 2) + kc % 2 + 0, 2, 4, 6, so row κ of each
    8-key group of the B operand is key 2κ (κ < 4) or 2(κ − 4) + 1."""
    vt = np.empty((v.shape[1], BKV), np.float32)
    for kc in range(8):
        for i in range(4):
            vt[:, 4 * kc + i] = v[8 * (kc // 2) + kc % 2 + 2 * i]
    return vt


def p_fragments(p: np.ndarray) -> np.ndarray:
    """The (64, 32) A operand of the PV product as the consumer forms it:
    lane (g, t) of warp w holds the S accumulator's d[4n + e] at row
    16w + g + 8·(e >= 2), key 8n + 2t + e % 2, and hands d[4n], d[4n + 2],
    d[4n + 1], d[4n + 3] on as the TF32 A fragment of k-step n, whose
    registers sit at (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4)."""
    a = np.empty_like(p)
    for w in range(4):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            r0, r1 = 16 * w + g, 16 * w + g + 8
            for n in range(BKV // 8):
                d = [p[r0, 8 * n + 2 * t], p[r0, 8 * n + 2 * t + 1],
                     p[r1, 8 * n + 2 * t], p[r1, 8 * n + 2 * t + 1]]
                frag = (d[0], d[2], d[1], d[3])
                for reg, (r, kk) in zip(frag, ((r0, t), (r1, t), (r0, t + 4), (r1, t + 4))):
                    a[r, 8 * n + kk] = reg
    return a


def kept(qi: np.ndarray, kj: np.ndarray, window: int) -> np.ndarray:
    keep = kj <= qi
    return keep & (kj > qi - window) if window else keep


def _tile(x: np.ndarray, start: int, rows: int) -> np.ndarray:
    """Rows start … start + rows − 1 of (S, hd) x, zero past S."""
    out = np.zeros((rows, x.shape[1]), np.float32)
    part = x[start:start + rows]
    out[:len(part)] = part
    return out


def body(q, k, v, window: int, passes: int = 3, permute: bool = True) -> np.ndarray:
    """The 3xTF32 body on (B, S, H, hd) float32 arrays, 64 rows and one
    tile at a time as each consumer warpgroup of the kernel runs them."""
    B, S_, H, hd = q.shape
    scale_log2 = np.float32(np.float32(hd ** -0.5) * LOG2E)
    out = np.zeros_like(q)
    for b in range(B):
        for h in range(H):
            for q0 in range(0, S_, BQ):
                qt = _tile(q[b, :, h], q0, BQ)
                rows = q0 + np.arange(BQ)[:, None]
                m = np.full(BQ, -np.inf, np.float32)
                l = np.zeros(BQ, np.float32)
                acc = np.zeros((BQ, hd), np.float32)
                k_first = max(0, q0 - window + 1) if window else 0
                for k0 in range(k_first // BKV * BKV, min(q0 + BQ, S_), BKV):
                    kt, vt = _tile(k[b, :, h], k0, BKV), _tile(v[b, :, h], k0, BKV)
                    s = product(qt, kt.T, passes)
                    keep = kept(rows, k0 + np.arange(BKV)[None, :], window)
                    s = np.where(keep, s * scale_log2, NEG_INF).astype(np.float32)
                    mn = np.maximum(m, s.max(axis=1))
                    alpha = np.exp2(m - mn)
                    p = np.exp2(s - mn[:, None]).astype(np.float32)
                    l = (l * alpha + p.sum(axis=1)).astype(np.float32)
                    m = mn
                    acc *= alpha[:, None]
                    if permute:
                        acc += product(p_fragments(p), stage_vt(vt).T, passes)
                    else:
                        acc += product(p, vt, passes)
                n = min(BQ, S_ - q0)
                out[b, q0:q0 + n, h] = (acc / np.maximum(l, np.float32(1e-30))[:, None])[:n]
    return out


@pytest.fixture(scope="module")
def outputs():
    """Per case: the seeded inputs, the JAX package's flash_attention_ref,
    and the emulated body with 3 passes, 1 pass, and 3 passes unpermuted."""
    jref = ref_module("kernels.ref").flash_attention_ref
    res = {}
    for case, (H, hd, window) in CASES.items():
        q, k, v = (seeded((1, S, H, hd), 11 + i, np.float32) for i in range(3))
        want = np.asarray(jref(*(jnp.asarray(a) for a in (q, k, v)), window=window))
        res[case] = dict(want=want, three=body(q, k, v, window),
                         one=body(q, k, v, window, passes=1),
                         unpermuted=body(q, k, v, window, permute=False))
    return res


def test_tf32_rounds_to_nearest_ties_away():
    x = np.array([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                  1.0 + 2.0 ** -12, 3.0 + 2.0 ** -9 - 2.0 ** -20], np.float32)
    want = np.array([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, -(1.0 + 2.0 ** -10), 1.0,
                     3.0 + 2.0 ** -9], np.float32)
    assert np.array_equal(tf32(x), want)
    hi, lo = split(np.float32([np.pi, -1e-3, 12345.678]))
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()


def test_permuted_fragments_times_staged_vt_is_pv():
    """Each A fragment register holds the score its k position names once
    Vᵀ's keys are permuted: on small integers (exact in f32) the permuted
    product equals p @ v, and the unpermuted Vᵀ does not."""
    rng = np.random.default_rng(5)
    p = rng.integers(-4, 5, (BQ, BKV)).astype(np.float32)
    v = rng.integers(-4, 5, (BKV, 64)).astype(np.float32)
    a, vt = p_fragments(p), stage_vt(v)
    assert np.array_equal(a @ vt.T, p @ v)
    assert not np.array_equal(a @ v, p @ v)
    perm = [8 * g + j for g in range(4) for j in (0, 2, 4, 6, 1, 3, 5, 7)]
    assert np.array_equal(a, p[:, perm]) and np.array_equal(vt.T, v[perm])


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_products_meet_the_f32_tolerance(outputs, case):
    o = outputs[case]
    np.testing.assert_allclose(o["three"], o["want"], **F32_TOLS)


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_product_misses_the_f32_tolerance(outputs, case):
    o = outputs[case]
    assert not np.allclose(o["one"], o["want"], **F32_TOLS)
    assert np.abs(o["one"] - o["want"]).max() > 10 * np.abs(o["three"] - o["want"]).max()


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_key_permutation_changes_no_result(outputs, case):
    """Only the order of the PV product's f32 sums differs: a few ulps of
    its O(1) terms (atol 1e-6, ten times below the f32 tolerance's)."""
    o = outputs[case]
    np.testing.assert_allclose(o["three"], o["unpermuted"], rtol=1e-6, atol=1e-6)
