// Kernel 18: causal softmax attention with an online softmax and an optional
// sliding window, in float32 and in bfloat16:
//
//   o[b, i, h, :] = Σ_j softmax_j(q[b, i, h, :]·k[b, j, h, :] · hd^-½) v[b, j, h, :]
//
// over the keys j with j <= i and, when window > 0, j > i − window.
//
// Replaces: src/repro/kernels/flash_attention.py, function flash_attention (a
// Pallas TPU kernel on a (B·H, S/bq, S/bkv) grid whose kv dimension runs in
// order on one core, so its f32 running max, denominator and (bq × hd)
// accumulator carry across the kv blocks in VMEM scratch).
//
// Bound on the H100: operations.  QKᵀ and PV are 4·hd operations for every
// kept (i, j) pair, about 2·S²·hd per head under the causal mask and fewer
// under a window, against 4·S·hd elements moved per head; at S = 4096 that is
// about 2000 operations per element, far above the card's balance point in
// either dtype.
//
// Design: one block owns kAttnBlockQ query rows of one (b, h) and loops over
// the kv tiles itself (the loop takes the place of the TPU's sequential kv
// grid dimension), so the running max m, denominator l and accumulator stay
// in registers and the (S × S) scores never reach memory.  q, k and v are
// read in place in the (B, S, H, hd) layout (row stride H·hd); each tile of
// K and V is staged in dynamic shared memory (above the 48 KiB static limit
// at hd = 128 in f32), zero-filled past S.  The tile loop starts at the first
// tile holding a key inside the window and ends at the diagonal: tiles wholly
// above the diagonal or wholly below the window are skipped (the reference
// computes the latter and discards them exactly).  Blocks are issued longest
// rows first.
//
// Masking follows the reference: a masked score is the finite kNegInf and m
// starts at −inf.  A row whose first visited tile is wholly masked (rows near
// a tile's top at the window's lower edge) gets p = 1 junk there; its own
// diagonal arrives in a later tile and its α = exp(kNegInf − m) = 0 wipes the
// junk exactly, with no NaN (exp(−inf − (−inf)) never occurs, since m_new is
// at least kNegInf).  Rows past a ragged S compute on zeros and are not
// written; keys past S lie above every real row's diagonal.
//
// float32: full-precision FFMA (no TF32).  256 threads as 16 × 16; a thread
// computes a 4 × 4 block of scores (rows ty + 16·i, keys tx + 16·j) from
// float4 reads of Q and K in shared memory (rows padded by kAttnPadF32 floats:
// no bank conflicts), the row max and sum by shuffles within the 16 lanes of
// its row group, then writes p to shared memory and accumulates 4 rows ×
// hd/16 output columns of p·V.
//
// bfloat16: bf16 in, f32 accumulate on the tensor cores with
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 for both products.  Four warps,
// 16 query rows each; the score fragments of two adjacent n-tiles, rounded to
// bf16, are the A fragment of the PV product (p rounded before PV, l summed
// from the f32 p, as the Pallas body does).  V is staged transposed (pairs of
// keys, 32-bit writes) so that its B fragments are 32-bit reads; hd = 8 is
// zero-padded to the mma's depth of 16.  hd = 256 stages kAttnBlockKVWide
// keys a tile, so that its 128 accumulator registers leave room without
// spilling.
//
// Each output element is written by exactly one thread with no atomics, so
// outputs are bitwise equal from run to run.  The output is a fresh buffer.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kAttnBlockQ = 64;         // query rows a block owns
constexpr int kAttnBlockKV = 64;        // keys a tile stages
constexpr int kAttnBlockKVWide = 32;    // keys a tile stages: bf16, hd = 256
constexpr int kAttnThreadsF32 = 256;    // 16 × 16 threads, 4 × 4 scores each
constexpr int kAttnThreadsBf16 = 128;   // 4 warps, 16 query rows each
constexpr int kAttnPadF32 = 4;          // floats of padding per Q/K/P row
constexpr int kAttnPadBf16 = 8;         // bf16 of padding per Q/K/Vᵀ row
constexpr int kMaxGridY = 65535;        // B·H, the grid's y extent
constexpr float kNegInf = -2.3819763e38f;

static_assert(kAttnThreadsF32 == 256 && kAttnBlockQ == 64 && kAttnBlockKV == 64,
              "the f32 kernel maps 16 x 16 threads onto a 64 x 64 score tile");
static_assert(kAttnThreadsBf16 == 32 * (kAttnBlockQ / 16),
              "the bf16 kernel gives each warp 16 query rows");

// Dynamic shared memory a block: src/repro_torch/analysis/lint_kernels.py
// (attention_smem_bytes) holds the same sizes against Hopper's 227 KiB.
// Qs, Ks (padded rows), Vs, Ps (padded rows)
template <int HD>
__host__ __device__ constexpr int smem_f32() {
  return ((kAttnBlockQ + kAttnBlockKV) * (HD + kAttnPadF32) + kAttnBlockKV * HD +
          kAttnBlockQ * (kAttnBlockKV + kAttnPadF32)) * 4;
}

template <int HD>
__host__ __device__ constexpr int kv_rows_bf16() {
  return HD == 256 ? kAttnBlockKVWide : kAttnBlockKV;
}

// hd padded to the mma's k depth
template <int HD>
__host__ __device__ constexpr int depth_bf16() {
  return HD < 16 ? 16 : HD;
}

// Qs, Ks (padded rows), Vᵀ (padded rows)
template <int HD>
__host__ __device__ constexpr int smem_bf16() {
  return ((kAttnBlockQ + kv_rows_bf16<HD>()) * (depth_bf16<HD>() + kAttnPadBf16) +
          HD * (kv_rows_bf16<HD>() + kAttnPadBf16)) * 2;
}

__device__ __forceinline__ bool kept(int qi, int kj, int window) {
  return kj <= qi && (window == 0 || kj > qi - window);
}

__device__ __forceinline__ float lane_of(const float4& x, int c) {
  return c == 0 ? x.x : c == 1 ? x.y : c == 2 ? x.z : x.w;
}

// One block an SM at hd = 128 (its shared memory), so the register budget is
// the thread's 255: without the minimum of 1, ptxas held hd = 128 to 128
// registers and spilled.
template <int HD>
__global__ void __launch_bounds__(kAttnThreadsF32, 1)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S, int H,
                 int window, float scale) {
  constexpr int BQ = kAttnBlockQ, BKV = kAttnBlockKV;
  constexpr int SQ = HD + kAttnPadF32;     // row stride of Qs and Ks
  constexpr int SP = BKV + kAttnPadF32;    // row stride of Ps
  constexpr int D4 = HD / 4;               // float4s per row
  constexpr int VEC = HD >= 64 ? 4 : 1;    // output columns in a run
  constexpr int NC = HD >= 16 ? HD / 16 : 1;   // output columns per thread
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);
  float* Ks = Qs + BQ * SQ;
  float* Vs = Ks + BKV * SQ;
  float* Ps = Vs + BKV * HD;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int cx = HD >= 16 ? tx : (tx & (HD - 1));   // hd = 8: lanes 8-15 repeat 0-7
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int64_t rs = (int64_t)H * HD;
  const int64_t base = ((int64_t)b * S * H + h) * HD;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int e = tid; e < BQ * D4; e += kAttnThreadsF32) {
    const int r = e / D4, c = (e % D4) * 4;
    const float4 x = q0 + r < S ? *reinterpret_cast<const float4*>(qb + (q0 + r) * rs + c)
                                : zero;
    *reinterpret_cast<float4*>(Qs + r * SQ + c) = x;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = k_first / BKV * BKV; k0 <= q_last; k0 += BKV) {
    __syncthreads();   // the last tile's readers are done
    for (int e = tid; e < BKV * D4; e += kAttnThreadsF32) {
      const int r = e / D4, c = (e % D4) * 4;
      float4 kx = zero, vx = zero;
      if (k0 + r < S) {
        kx = *reinterpret_cast<const float4*>(kb + (k0 + r) * rs + c);
        vx = *reinterpret_cast<const float4*>(vb + (k0 + r) * rs + c);
      }
      *reinterpret_cast<float4*>(Ks + r * SQ + c) = kx;
      *reinterpret_cast<float4*>(Vs + r * HD + c) = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * SQ + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * SQ + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = kept(qi, k0 + tx + 16 * j, window) ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        ps += s[i][j];
        Ps[(ty + 16 * i) * SP + tx + 16 * j] = s[i][j];
      }
#pragma unroll
      for (int off = 8; off; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < BKV; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * SP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = Vs + (c + cc) * HD;
        float vv[NC];
        if constexpr (VEC == 4) {
#pragma unroll
          for (int u = 0; u < NC / 4; ++u) {
            const float4 x = *reinterpret_cast<const float4*>(vrow + u * 64 + tx * 4);
            vv[4 * u] = x.x;
            vv[4 * u + 1] = x.y;
            vv[4 * u + 2] = x.z;
            vv[4 * u + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < NC; ++j) vv[j] = vrow[j * 16 + cx];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = lane_of(pv[i], cc);
#pragma unroll
          for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
        }
      }
    }
  }

  float* ob = o + base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = ob + qi * rs;
    if constexpr (VEC == 4) {
#pragma unroll
      for (int u = 0; u < NC / 4; ++u)
        *reinterpret_cast<float4*>(orow + u * 64 + tx * 4) =
            make_float4(acc[i][4 * u] / den, acc[i][4 * u + 1] / den,
                        acc[i][4 * u + 2] / den, acc[i][4 * u + 3] / den);
    } else if (HD >= 16 || tx < HD) {
#pragma unroll
      for (int j = 0; j < NC; ++j) orow[j * 16 + cx] = acc[i][j] / den;
    }
  }
}

__device__ __forceinline__ uint32_t ld_b32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// d += A·B on the tensor cores: A 16×16 bf16 (row), B 16×8 bf16 (col), d 16×8 f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Fragment layouts (PTX ISA, mma.m16n8k16): with g = lane / 4 and t = lane % 4,
// A's registers hold rows (g, g + 8, g, g + 8) at columns (2t, 2t, 2t + 8,
// 2t + 8) and the next; B's hold k = 2t and 2t + 8 (and the next) at n = g;
// d holds rows g (d[0], d[1]) and g + 8 (d[2], d[3]) at columns 2t, 2t + 1.
template <int HD>
__global__ void __launch_bounds__(kAttnThreadsBf16)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                  int S, int H, int window, float scale) {
  constexpr int BQ = kAttnBlockQ, BKV = kv_rows_bf16<HD>();
  constexpr int KD = depth_bf16<HD>();
  constexpr int SQ = KD + kAttnPadBf16;    // row stride of Qs and Ks
  constexpr int SV = BKV + kAttnPadBf16;   // row stride of Vᵀ
  constexpr int NT = BKV / 8;              // score n-tiles
  constexpr int ND = HD / 8;               // output n-tiles
  constexpr int QC = KD / 8;               // 16-byte chunks per staged Q/K row
  constexpr int VC = HD / 8;               // 16-byte chunks per V row
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* Ks = Qs + BQ * SQ;
  __nv_bfloat16* Vt = Ks + BKV * SQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int64_t rs = (int64_t)H * HD;
  const int64_t base = ((int64_t)b * S * H + h) * HD;
  const __nv_bfloat16* qb = q + base;
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int e = tid; e < BQ * QC; e += kAttnThreadsBf16) {
    const int r = e / QC, c = (e % QC) * 8;
    const uint4 x = q0 + r < S && c < HD
                        ? *reinterpret_cast<const uint4*>(qb + (q0 + r) * rs + c) : zero;
    *reinterpret_cast<uint4*>(Qs + r * SQ + c) = x;
  }

  const int wr = 16 * warp;   // the warp's first row in the block's tile
  const int qi0 = q0 + wr + g, qi1 = qi0 + 8;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = k_first / BKV * BKV; k0 <= q_last; k0 += BKV) {
    __syncthreads();   // the last tile's readers are done
    for (int e = tid; e < BKV * QC; e += kAttnThreadsBf16) {
      const int r = e / QC, c = (e % QC) * 8;
      const uint4 x = k0 + r < S && c < HD
                          ? *reinterpret_cast<const uint4*>(kb + (k0 + r) * rs + c) : zero;
      *reinterpret_cast<uint4*>(Ks + r * SQ + c) = x;
    }
    // Vᵀ: a thread takes two adjacent keys of one 8-column chunk and writes
    // 32-bit pairs, so the lanes of a warp write 32 consecutive words
    for (int e = tid; e < BKV / 2 * VC; e += kAttnThreadsBf16) {
      const int r = 2 * (e % (BKV / 2)), c = (e / (BKV / 2)) * 8;
      const uint4 x0 = k0 + r < S
                           ? *reinterpret_cast<const uint4*>(vb + (k0 + r) * rs + c) : zero;
      const uint4 x1 = k0 + r + 1 < S
                           ? *reinterpret_cast<const uint4*>(vb + (k0 + r + 1) * rs + c) : zero;
      const __nv_bfloat16* v0 = reinterpret_cast<const __nv_bfloat16*>(&x0);
      const __nv_bfloat16* v1 = reinterpret_cast<const __nv_bfloat16*>(&x1);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        __nv_bfloat162 pair;
        pair.x = v0[u];
        pair.y = v1[u];
        *reinterpret_cast<__nv_bfloat162*>(Vt + (c + u) * SV + r) = pair;
      }
    }
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; kk += 16) {
      const __nv_bfloat16* qa = Qs + (wr + g) * SQ + kk + t2;
      const uint32_t a0 = ld_b32(qa), a1 = ld_b32(qa + 8 * SQ);
      const uint32_t a2 = ld_b32(qa + 8), a3 = ld_b32(qa + 8 * SQ + 8);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* kp = Ks + (8 * n + g) * SQ + kk + t2;
        mma_bf16(s[n], a0, a1, a2, a3, ld_b32(kp), ld_b32(kp + 8));
      }
    }

    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + 8 * n + t2 + (e & 1);
        const bool keep = kept(e < 2 ? qi0 : qi1, kj, window);
        s[n][e] = keep ? s[n][e] * scale : kNegInf;
        if (e < 2) mx0 = fmaxf(mx0, s[n][e]);
        else mx1 = fmaxf(mx1, s[n][e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;   // this thread's share of the row sums
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = expf(s[n][0] - mn0);
      s[n][1] = expf(s[n][1] - mn0);
      s[n][2] = expf(s[n][2] - mn1);
      s[n][3] = expf(s[n][3] - mn1);
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }

#pragma unroll
    for (int kt = 0; kt < BKV / 16; ++kt) {
      const uint32_t a0 = pack_bf16(s[2 * kt][0], s[2 * kt][1]);
      const uint32_t a1 = pack_bf16(s[2 * kt][2], s[2 * kt][3]);
      const uint32_t a2 = pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* vp = Vt + (8 * n + g) * SV + 16 * kt + t2;
        mma_bf16(acc[n], a0, a1, a2, a3, ld_b32(vp), ld_b32(vp + 8));
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = o + base;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    if (qi0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + qi0 * rs + 8 * n + t2) =
          __floats2bfloat162_rn(acc[n][0] / den0, acc[n][1] / den0);
    if (qi1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + qi1 * rs + 8 * n + t2) =
          __floats2bfloat162_rn(acc[n][2] / den1, acc[n][3] / den1);
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
               int window, float scale, cudaStream_t st) {
  constexpr int smem = smem_f32<HD>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kAttnBlockQ - 1) / kAttnBlockQ, B * H);
  flash_f32_kernel<HD><<<grid, kAttnThreadsF32, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, window, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                int window, float scale, cudaStream_t st) {
  constexpr int smem = smem_bf16<HD>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kAttnBlockQ - 1) / kAttnBlockQ, B * H);
  flash_bf16_kernel<HD><<<grid, kAttnThreadsBf16, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, H, window,
      scale);
  return (int)cudaGetLastError();
}

bool valid_shape(int B, int S, int H, int window) {
  return B >= 1 && S >= 1 && H >= 1 && window >= 0 && (long long)B * H <= kMaxGridY;
}

}  // namespace

extern "C" {

int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int B, int S,
                        int H, int hd, int window, float scale, void* stream) {
  if (!valid_shape(B, S, H, window)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8: return launch_f32<8>(q, k, v, o, B, S, H, window, scale, st);
    case 16: return launch_f32<16>(q, k, v, o, B, S, H, window, scale, st);
    case 32: return launch_f32<32>(q, k, v, o, B, S, H, window, scale, st);
    case 64: return launch_f32<64>(q, k, v, o, B, S, H, window, scale, st);
    case 128: return launch_f32<128>(q, k, v, o, B, S, H, window, scale, st);
    case 256: return launch_f32<256>(q, k, v, o, B, S, H, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int B, int S,
                         int H, int hd, int window, float scale, void* stream) {
  if (!valid_shape(B, S, H, window)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8: return launch_bf16<8>(q, k, v, o, B, S, H, window, scale, st);
    case 16: return launch_bf16<16>(q, k, v, o, B, S, H, window, scale, st);
    case 32: return launch_bf16<32>(q, k, v, o, B, S, H, window, scale, st);
    case 64: return launch_bf16<64>(q, k, v, o, B, S, H, window, scale, st);
    case 128: return launch_bf16<128>(q, k, v, o, B, S, H, window, scale, st);
    case 256: return launch_bf16<256>(q, k, v, o, B, S, H, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
