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
// Design: one block owns a run of query rows of one (b, h) and loops over
// the kv tiles itself (the loop takes the place of the TPU's sequential kv
// grid dimension), so the running max m, denominator l and accumulator stay
// in registers and the (S × S) scores never reach memory.  q, k and v are
// read in place in the (B, S, H, hd) layout (row stride H·hd); each tile of
// K and V is staged in dynamic shared memory (above the 48 KiB static limit),
// zero past S.  The tile loop starts at the first
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
// float32 has two bodies; flash_attention_body says which width takes which.
//
// At hd = 64 and 128, flash_f32_tf32x3_kernel: both products on Hopper's
// tensor cores as 3xTF32 wgmma.  Bound: operations at the TF32 rate, three
// products for each f32 one (0.4170 ms at internlm2-1.8b's widths, 2.5×
// below the FFMA rate's bound).  Each operand x is split once into
// hi = tf32(x) and lo = tf32(x − hi), rounded to nearest (hopper::tf32_rna;
// nothing is left to what the tensor core does with the low 13 bits of an
// f32), and lo·hi + hi·lo + hi·hi go into one f32 accumulator: within the f32
// tolerance where one TF32 product is not.  TF32 wgmma takes only K-major
// operands, so S = QKᵀ reads Q and K as they lie (hd contiguous) and the PV
// product needs Vᵀ (keys contiguous), which threads stage.  A block owns
// kAttnTfBlockQ = 128 query rows of one (b, h) and has three warpgroups.
// Each of two consumers owns 64 rows and keeps their Q hi in registers as
// TF32 A fragments: S is wgmma m64n32k8 with Q lo from shared memory (SS)
// and Q hi from registers (RS), the online softmax runs in registers, and
// O += PV is RS wgmma m64n{hd}k8 with p's hi and lo split in registers; a
// consumer skips the products of a tile none of its rows keeps.  The
// producer loads the next tile into registers (16-byte loads, zero past S)
// while the consumers compute, then splits it and writes K and Vᵀ, swizzled
// 128B as the descriptors name, into the free stage of a kAttnTfStages ring;
// named barriers hand each stage over, and setmaxnreg moves registers from
// the producer to the consumers.  The S accumulator gives a thread keys 2t
// and 2t + 1 of each n8 tile where the TF32 A fragment wants k = t and
// t + 4, so the producer permutes the keys of each group of 8 in Vᵀ (row κ
// is key 2κ for κ < 4, key 2(κ − 4) + 1 for κ >= 4) and p goes to the PV
// product without a shuffle.  Shared memory is the design's limit: with Q
// hi in registers, Q lo and a two-stage ring of K's and Vᵀ's hi and lo take
// 192 KiB at hd = 128.  The softmax is the wgmma bf16 body's (base 2,
// ex2.approx.ftz); p is not rounded beyond its split.
//
// At hd = 8, 16, 32 and 256, flash_f32_kernel: full-precision FFMA (no
// TF32).  256 threads as 16 × 16; a thread computes a 4 × 4 block of scores
// (rows ty + 16·i, keys tx + 16·j) from float4 reads of Q and K in shared
// memory (rows padded by kAttnPadF32 floats: no bank conflicts), the row max
// and sum by shuffles within the 16 lanes of its row group, then writes p to
// shared memory and accumulates 4 rows × hd/16 output columns of p·V.
// flash_attention_f32_ffma launches it at any width, as the yardstick of the
// 3xTF32 body.
//
// bfloat16 has two bodies; flash_attention_body says which width takes which.
//
// At hd = 64 and 128, flash_bf16_wgmma_kernel: Hopper's wgmma fed by a TMA
// ring (the PTX wrappers of hopper.cuh, written by hand; no CUTLASS header).
// A block owns kAttnWgBlockQ = 128 query rows of one (b, h): two warpgroups
// of 64 rows, wgmma's M.  Q, K and V are read in place through 4-D tensor
// maps over (B, S, H, hd) with dims {hd, H, S, B} and boxes {64, 1, rows, 1}
// (one 128-byte row of hd a key, hence two 64-wide panels at hd = 128),
// swizzled 128B; rows past S come back as zeros, and a box never crosses into
// the next batch or head.  Q is loaded once; K and V go through a ring of
// kAttnWgStages stages of kAttnWgBlockKV keys, one "full" mbarrier a stage
// armed with the stage's bytes.  Thread 0 issues tile j + 1's loads before the
// block computes tile j, and a named barrier over the 256 threads at the end
// of each tile frees its stage.  S = QKᵀ is wgmma m64n128k16 with Q and K
// from shared memory, both K-major; O += PV is wgmma with P from registers
// (the S accumulator's layout is mma.sync's, so two adjacent n-tiles rounded
// to bf16 are one A fragment) and V from shared memory as an MN-major operand
// (the transpose bit: no thread transposes V).  The kept() test runs only on
// tiles that reach past the diagonal or below the window's lower edge of the
// warpgroup's rows; scores are kept in the base-2 domain (hd^-½·log2 e folded
// into the scale, ex2.approx.ftz), which changes no kept pair; each thread
// keeps four partial maxima and sums a row, so their chains overlap.
//
// At hd = 8, 16, 32 and 256, flash_bf16_kernel: bf16 in, f32 accumulate on
// the tensor cores with mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 for both
// products.  Four warps, 16 query rows each; the score fragments of two
// adjacent n-tiles, rounded to bf16, are the A fragment of the PV product.
// V is staged transposed (pairs of keys, 32-bit writes) so that its B
// fragments are 32-bit reads; hd = 8 is zero-padded to the mma's depth of 16.
// hd = 256 stages kAttnBlockKVWide keys a tile, so that its 128 accumulator
// registers leave room without spilling.  flash_attention_bf16_mma launches
// it at any width, as the yardstick of the wgmma body.
//
// Both bf16 bodies round p to bf16 before the PV product and sum l from the
// f32 p, as the Pallas body does.
//
// Each output element is written by exactly one thread with no atomics, so
// outputs are bitwise equal from run to run.  The output is a fresh buffer.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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

// the wgmma body (bf16, hd 64 and 128)
constexpr int kAttnWgBlockQ = 128;      // query rows a block owns
constexpr int kAttnWgBlockKV = 128;     // keys a tile
constexpr int kAttnWgStages = 2;        // K/V tiles in the ring
constexpr int kAttnWgThreads = 256;     // two warpgroups, 64 query rows each
constexpr int kAttnWgPanel = 64;        // hd columns a TMA box: one 128-byte row
constexpr int kSmemAlign = 1024;        // the 128B swizzle's atom: 8 rows of 128 B
constexpr int kMaxDynamicSmem = 232448; // Hopper's 227 KiB a block
constexpr int kTensorMapError = 1048576;   // + CUresult: cuTensorMapEncodeTiled failed
constexpr float kLog2e = 1.4426950408889634f;

// the 3xTF32 body (f32, hd 64 and 128)
constexpr int kAttnTfBlockQ = 128;      // query rows a block owns: two of wgmma's M
constexpr int kAttnTfBlockKV = 32;      // keys a tile: one 128-byte row of Vᵀ
constexpr int kAttnTfStages = 2;        // K/Vᵀ tiles in the ring
constexpr int kAttnTfThreads = 384;     // two consumer warpgroups and a producer
constexpr int kAttnTfConsumerRegs = 208;   // registers a consumer thread, after setmaxnreg
constexpr int kAttnTfProducerRegs = 88;    // ... and a producer thread: 384 × 168 in all
constexpr int kAttnTfPanel = 32;        // f32 columns of one 128-byte row
constexpr int kBarFull = 1;             // named barriers kBarFull + stage: tile staged
constexpr int kBarEmpty = 3;            // kBarEmpty + stage: tile read

// which body serves (dtype, hd): flash_attention_body's answers
constexpr int kBodyFfma = 0;            // f32, hd 8, 16, 32 and 256
constexpr int kBodyWgmma = 1;           // bf16, hd 64 and 128
constexpr int kBodyMma = 2;             // bf16, hd 8, 16, 32 and 256
constexpr int kBodyTf32x3 = 3;          // f32, hd 64 and 128

static_assert(kAttnThreadsF32 == 256 && kAttnBlockQ == 64 && kAttnBlockKV == 64,
              "the f32 kernel maps 16 x 16 threads onto a 64 x 64 score tile");
static_assert(kAttnThreadsBf16 == 32 * (kAttnBlockQ / 16),
              "the mma.sync kernel gives each warp 16 query rows");

// Dynamic shared memory a block of the FFMA and mma.sync bodies:
// src/repro_torch/analysis/lint_kernels.py (attention_smem_bytes) holds the
// same sizes against Hopper's 227 KiB (the wgmma and 3xTF32 bodies'
// static_asserts below hold their own).
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

// Dynamic shared memory of the wgmma body, past its 1024-byte alignment: Q,
// then K and V of each stage, each a [rows][64] bf16 panel per 64 columns of hd
template <int HD>
__host__ __device__ constexpr int smem_bf16_wgmma() {
  return (kAttnWgBlockQ + 2 * kAttnWgStages * kAttnWgBlockKV) * HD * 2;
}
static_assert(smem_bf16_wgmma<64>() + kSmemAlign <= kMaxDynamicSmem &&
                  smem_bf16_wgmma<128>() + kSmemAlign <= kMaxDynamicSmem,
              "the wgmma body's Q and K/V ring must fit Hopper's 227 KiB a block");
static_assert(kAttnWgThreads == 2 * 128 && kAttnWgBlockQ == 2 * 64,
              "the wgmma body gives each of its two warpgroups 64 query rows");
static_assert(kAttnWgBlockKV == 128 && kAttnWgStages == 2,
              "the wgmma body's S product is m64n128 and its ring alternates two stages");

// Dynamic shared memory of the 3xTF32 body, past its 1024-byte alignment:
// Q's lo (its hi lives in the consumers' registers), then per stage K's hi
// and lo and Vᵀ's hi and lo, each a [rows][32] f32 panel per 32 columns (Vᵀ:
// one [hd][32] panel of 32 keys)
template <int HD>
__host__ __device__ constexpr int smem_f32_tf32x3() {
  return (kAttnTfBlockQ * HD + kAttnTfStages * 4 * kAttnTfBlockKV * HD) * 4;
}
static_assert(smem_f32_tf32x3<64>() + kSmemAlign <= kMaxDynamicSmem &&
                  smem_f32_tf32x3<128>() + kSmemAlign <= kMaxDynamicSmem,
              "the 3xTF32 body's Q and K/Vt ring must fit Hopper's 227 KiB a block");
static_assert(kAttnTfThreads == 3 * 128 && kAttnTfBlockQ == 2 * 64,
              "the 3xTF32 body gives each of its two consumer warpgroups 64 query rows");
static_assert(2 * 128 * kAttnTfConsumerRegs + 128 * kAttnTfProducerRegs <=
                  kAttnTfThreads * (65536 / kAttnTfThreads / 8 * 8),
              "setmaxnreg moves registers between the warpgroups, it adds none");
static_assert(kAttnTfBlockKV == kAttnTfPanel && kAttnTfStages == 2,
              "a tile's keys are one 128-byte row of Vt, and its ring alternates two stages");

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

// 2^x on the special function unit, subnormal results flushed to zero
// (exp2f without -ftz wraps the same instruction in a rescale for them)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The wgmma body.  Thread t of the block is lane t % 32 of warp (t / 32) % 4
// of warpgroup t / 128; warpgroup wg owns the block's query rows
// 64·wg … 64·wg + 63, and its warp w rows 16w + g and 16w + g + 8 of those.
// Shared memory (1024-byte aligned): Q as NP panels of [128 rows][64], then
// K of stage 0 and 1, then V of stage 0 and 1, NP panels each; every panel
// is 16 KiB and keeps TMA's 128B swizzle, which is what the descriptors name.
template <int HD>
__global__ void __launch_bounds__(kAttnWgThreads, 1)
flash_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                        int S, int H, int window, float scale_log2) {
  constexpr int BQ = kAttnWgBlockQ, BKV = kAttnWgBlockKV, ST = kAttnWgStages;
  constexpr int NP = HD / kAttnWgPanel;          // 64-wide panels of hd
  constexpr uint32_t kRow = kAttnWgPanel * 2;    // bytes of one panel row
  constexpr uint32_t kQPanel = BQ * kRow, kKVPanel = BKV * kRow;
  constexpr uint32_t kStageBytes = 2 * NP * kKVPanel;   // K and V of one tile
  constexpr int NT = BKV / 8;                    // score n-tiles
  constexpr int ND = HD / 8;                     // output n-tiles
  static_assert(HD % kAttnWgPanel == 0, "hd is a whole number of 64-wide panels");
  __shared__ __align__(8) uint64_t bars[1 + ST];   // Q's, then each stage's "full"
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((kSmemAlign - (hopper::smem_addr(smem_raw) & (kSmemAlign - 1))) &
                              (kSmemAlign - 1));
  uint8_t* Qs = smem;
  uint8_t* Ks = Qs + NP * kQPanel;
  uint8_t* Vs = Ks + ST * NP * kKVPanel;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int j0 = k_first / BKV, n_tiles = q0 / BKV - j0 + 1;

  // thread 0 only: arm a stage's barrier and load tile j's K and V into it
  auto load_kv = [&](int j, int stage) {
    uint64_t* bar = &bars[1 + stage];
    hopper::mbar_arrive_expect_tx(bar, kStageBytes);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      hopper::tma_load_4d(Ks + (stage * NP + p) * kKVPanel, &tk, bar, p * kAttnWgPanel, h,
                          j * BKV, b);
      hopper::tma_load_4d(Vs + (stage * NP + p) * kKVPanel, &tv, bar, p * kAttnWgPanel, h,
                          j * BKV, b);
    }
  };
  if (tid == 0) {
    hopper::prefetch_tensor_map(&tq);
    hopper::prefetch_tensor_map(&tk);
    hopper::prefetch_tensor_map(&tv);
#pragma unroll
    for (int i = 0; i < 1 + ST; ++i) hopper::mbar_init(&bars[i], 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_arrive_expect_tx(&bars[0], NP * kQPanel);
#pragma unroll
    for (int p = 0; p < NP; ++p)
      hopper::tma_load_4d(Qs + p * kQPanel, &tq, &bars[0], p * kAttnWgPanel, h, q0, b);
    load_kv(j0, 0);
  }

  const int qlo = q0 + 64 * wg, qhi = qlo + 63;   // the warpgroup's rows
  const int qi0 = qlo + 16 * warp + g, qi1 = qi0 + 8;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[ND * 4];
#pragma unroll
  for (int i = 0; i < ND * 4; ++i) acc[i] = 0.f;
  const uint32_t q_addr = hopper::smem_addr(Qs) + wg * 64 * kRow;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1, k0 = (j0 + it) * BKV;
    // the other stage was freed by the last tile's closing barrier
    if (tid == 0 && it + 1 < n_tiles) load_kv(j0 + it + 1, stage ^ 1);
    if (it == 0) hopper::mbar_wait(&bars[0], 0);
    hopper::mbar_wait(&bars[1 + stage], (it >> 1) & 1);   // stage's (it/2)-th fill
    __syncwarp();

    // S = Q Kᵀ: hd/16 k-steps, 32 B along a swizzled row each, the next
    // panel every 4
    const uint32_t k_addr = hopper::smem_addr(Ks + stage * NP * kKVPanel);
    float s[NT * 4];
#pragma unroll
    for (int i = 0; i < NT * 4; ++i) s[i] = 0.f;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      hopper::wgmma_m64n128k16_ss(
          s, hopper::desc_sw128(q_addr + (kk / 4) * kQPanel + off, 16, 8 * kRow),
          hopper::desc_sw128(k_addr + (kk / 4) * kKVPanel + off, 16, 8 * kRow), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(s);

    // the mask only where some pair of the warpgroup's rows is not kept
    const bool masked = k0 + BKV - 1 > qlo || (window > 0 && k0 <= qhi - window);
    // partial maxima and sums [n & 1][e] (e < 2: row g, else row g + 8):
    // four independent chains a row
    float mx[8], ps[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      mx[i] = kNegInf;
      ps[i] = 0.f;
    }
    if (masked) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + 8 * n + t2 + (e & 1);
          float& x = s[4 * n + e];
          x = kept(e < 2 ? qi0 : qi1, kj, window) ? x * scale_log2 : kNegInf;
          mx[4 * (n & 1) + e] = fmaxf(mx[4 * (n & 1) + e], x);
        }
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& x = s[4 * n + e];
          x *= scale_log2;
          mx[4 * (n & 1) + e] = fmaxf(mx[4 * (n & 1) + e], x);
        }
    }
    float mx0 = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[4], mx[5]));
    float mx1 = fmaxf(fmaxf(mx[2], mx[3]), fmaxf(mx[6], mx[7]));
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2_ftz(m0 - mn0), al1 = exp2_ftz(m1 - mn1);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = s[4 * n + e];
        x = exp2_ftz(x - (e < 2 ? mn0 : mn1));
        ps[4 * (n & 1) + e] += x;
      }
    // this thread's share of the row sums
    const float ps0 = (ps[0] + ps[1]) + (ps[4] + ps[5]);
    const float ps1 = (ps[2] + ps[3]) + (ps[6] + ps[7]);
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[4 * n] *= al0;
      acc[4 * n + 1] *= al0;
      acc[4 * n + 2] *= al1;
      acc[4 * n + 3] *= al1;
    }

    // O += P V: P's A fragment for keys 16kt … 16kt + 15 is score n-tiles
    // 2kt and 2kt + 1 rounded to bf16; V's k16 step is 16 rows of 128 B, its
    // second panel (hd = 128) kKVPanel bytes on
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int kt = 0; kt < BKV / 16; ++kt) {
      pa[kt][0] = pack_bf16(s[8 * kt], s[8 * kt + 1]);
      pa[kt][1] = pack_bf16(s[8 * kt + 2], s[8 * kt + 3]);
      pa[kt][2] = pack_bf16(s[8 * kt + 4], s[8 * kt + 5]);
      pa[kt][3] = pack_bf16(s[8 * kt + 6], s[8 * kt + 7]);
    }
    const uint32_t v_addr = hopper::smem_addr(Vs + stage * NP * kKVPanel);
    hopper::wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < BKV / 16; ++kt) {
      const uint64_t dv = hopper::desc_sw128(v_addr + kt * 16 * kRow, kKVPanel, 8 * kRow);
      if constexpr (HD == 64) hopper::wgmma_m64n64k16_rs_tb(acc, pa[kt], dv, 1);
      else hopper::wgmma_m64n128k16_rs_tb(acc, pa[kt], dv, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(acc);
    hopper::named_barrier_sync(1, kAttnWgThreads);   // this stage is free again
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  const int64_t rs = (int64_t)H * HD;
  __nv_bfloat16* ob = o + ((int64_t)b * S * H + h) * HD;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    if (qi0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + qi0 * rs + 8 * n + t2) =
          __floats2bfloat162_rn(acc[4 * n] / den0, acc[4 * n + 1] / den0);
    if (qi1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + qi1 * rs + 8 * n + t2) =
          __floats2bfloat162_rn(acc[4 * n + 2] / den1, acc[4 * n + 3] / den1);
  }
}

// x split into hi = tf32(x) and lo = tf32(x − hi), as TF32 bit patterns
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = hopper::tf32_rna(x);
  lo = hopper::tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split_tf32(const float4& x, uint4& hi, uint4& lo) {
  split_tf32(x.x, hi.x, lo.x);
  split_tf32(x.y, hi.y, lo.y);
  split_tf32(x.z, hi.z, lo.z);
  split_tf32(x.w, hi.w, lo.w);
}

// byte offset of 16-byte chunk c (0 … 7) of row r in a panel of 128-byte rows
// with the 128B swizzle (the chunk index XORed with the row's index in its
// 8-row atom), the layout the wgmma descriptors name
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// The 3xTF32 body.  Threads 0-255 are two consumer warpgroups: warpgroup
// cw owns the block's query rows 64cw … 64cw + 63 and its warp w rows
// 16w + g and 16w + g + 8 of those, whose Q hi it holds in registers as the
// S product's A fragments.  Threads 256-383 are the producer warpgroup: it
// loads tile it + 1 into registers while the consumers compute tile it, and
// stages it when a stage is free.  Shared memory (1024-byte aligned): Q lo
// (hd/32 panels of [128][32]), then per stage K hi, K lo (hd/32 panels of
// [32][32]) and Vᵀ hi, Vᵀ lo (one panel of [hd][32]).
template <int HD>
__global__ void __launch_bounds__(kAttnTfThreads, 1)
flash_f32_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o, int S, int H,
                        int window, float scale_log2) {
  constexpr int BQ = kAttnTfBlockQ, BKV = kAttnTfBlockKV, ST = kAttnTfStages;
  constexpr int NP = HD / kAttnTfPanel;        // 32-wide panels of hd (Q and K)
  constexpr int D4 = HD / 4;                   // float4s in a row of hd
  constexpr uint32_t kQPanel = BQ * 128, kKPanel = BKV * 128;
  constexpr uint32_t kQ = NP * kQPanel;        // bytes of Q lo
  constexpr uint32_t kK = NP * kKPanel;        // bytes of K hi (and of K lo) a stage
  constexpr uint32_t kV = HD * 128;            // bytes of Vᵀ hi (and of Vᵀ lo) a stage
  constexpr uint32_t kStage = 2 * (kK + kV);
  constexpr int NT = BKV / 8;                  // score n-tiles, PV k-steps
  constexpr int ND = HD / 8;                   // output n-tiles
  constexpr int KLOADS = BKV * D4 / 128;       // K float4s a producer thread loads
  constexpr int VUNITS = 8 * D4 / 128;         // Vᵀ units (4 keys × 4 columns) a thread
  static_assert(HD % kAttnTfPanel == 0 && KLOADS * 128 == BKV * D4 && VUNITS * 128 == 8 * D4,
                "hd is a whole number of 32-wide panels and a tile splits evenly");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((kSmemAlign - (hopper::smem_addr(smem_raw) & (kSmemAlign - 1))) &
                              (kSmemAlign - 1));

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int64_t rs = (int64_t)H * HD;
  const int64_t base = ((int64_t)b * S * H + h) * HD;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int j0 = k_first / BKV, n_tiles = (min(q0 + BQ, S) - 1) / BKV - j0 + 1;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  // Q's lo, by all threads; zero past S
  for (int e = tid; e < BQ * D4; e += kAttnTfThreads) {
    const int r = e / D4, c = e % D4;
    const float4 x = q0 + r < S ? *reinterpret_cast<const float4*>(q + base + (q0 + r) * rs +
                                                                   4 * c)
                                : zero;
    uint4 hi, lo;
    split_tf32(x, hi, lo);
    *reinterpret_cast<uint4*>(smem + (c / 8) * kQPanel + sw128(r, c % 8)) = lo;
  }
  hopper::fence_proxy_async();
  __syncthreads();

  // one if/else over the warpgroups, so that ptxas sees each side's budget
  if (tid >= 256) {
    hopper::setmaxnreg_dec<kAttnTfProducerRegs>();
    // The producer.  K: a warp reads whole rows of hd (16-byte loads), each
    // float4 is one swizzled chunk.  Vᵀ: B row κ of each 8-key group holds
    // key 2κ (κ < 4) or 2(κ − 4) + 1 (κ >= 4), the k order of the P
    // fragments the consumers make from their score registers, so 16-byte
    // chunk kc of a Vᵀ row holds keys 8·(kc/2) + kc%2 + 0, 2, 4, 6.  A unit
    // is one chunk kc of four adjacent Vᵀ rows (hd columns 4cq … 4cq + 3):
    // lane l takes kc = l % 8, so the 8 lanes of a column group write one
    // whole 128-byte row and a warp's stores are free of bank conflicts.
    const int p = tid - 256, lane = p & 31, pw = p >> 5, kc = lane & 7;
    const float* kb = k + base;
    const float* vb = v + base;
    for (int it = 0; it < n_tiles; ++it) {
      const int stage = it % ST, k0 = (j0 + it) * BKV;
      float4 kx[KLOADS], vx[VUNITS][4];
#pragma unroll
      for (int i = 0; i < KLOADS; ++i) {
        const int e = p + 128 * i, r = e / D4, c = e % D4;
        kx[i] = k0 + r < S ? *reinterpret_cast<const float4*>(kb + (k0 + r) * rs + 4 * c)
                           : zero;
      }
#pragma unroll
      for (int i = 0; i < VUNITS; ++i) {
        const int cq = (lane >> 3) + 4 * pw + 16 * i;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = 8 * (kc >> 1) + (kc & 1) + 2 * u;
          vx[i][u] = k0 + r < S
                         ? *reinterpret_cast<const float4*>(vb + (k0 + r) * rs + 4 * cq)
                         : zero;
        }
      }
      if (it >= ST) hopper::named_barrier_sync(kBarEmpty + stage, kAttnTfThreads);
      uint8_t* kst = smem + kQ + stage * kStage;
      uint8_t* vst = kst + 2 * kK;
#pragma unroll
      for (int i = 0; i < KLOADS; ++i) {
        const int e = p + 128 * i, r = e / D4, c = e % D4;
        uint4 hi, lo;
        split_tf32(kx[i], hi, lo);
        const uint32_t off = (c / 8) * kKPanel + sw128(r, c % 8);
        *reinterpret_cast<uint4*>(kst + off) = hi;
        *reinterpret_cast<uint4*>(kst + kK + off) = lo;
      }
#pragma unroll
      for (int i = 0; i < VUNITS; ++i) {
        const int cq = (lane >> 3) + 4 * pw + 16 * i;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          uint4 hi, lo;
          split_tf32(make_float4(lane_of(vx[i][0], u), lane_of(vx[i][1], u),
                                 lane_of(vx[i][2], u), lane_of(vx[i][3], u)),
                     hi, lo);
          const uint32_t off = sw128(4 * cq + u, kc);
          *reinterpret_cast<uint4*>(vst + off) = hi;
          *reinterpret_cast<uint4*>(vst + kV + off) = lo;
        }
      }
      hopper::fence_proxy_async();
      hopper::named_barrier_arrive(kBarFull + stage, kAttnTfThreads);
    }
  } else {
    hopper::setmaxnreg_inc<kAttnTfConsumerRegs>();
    // The consumers.  A warpgroup skips the products of a tile none of its
    // rows keeps (above its diagonal, below its window) but keeps the handoff.
    const int cw = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t2 = 2 * (lane & 3);
    const int qlo = q0 + 64 * cw, qhi = qlo + 63;
    const int kf = window > 0 ? max(0, qlo - window + 1) : 0;   // its first kept key
    const int qi0 = qlo + 16 * warp + g, qi1 = qi0 + 8;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    float acc[ND * 4];
#pragma unroll
    for (int i = 0; i < ND * 4; ++i) acc[i] = 0.f;
    const uint32_t q_lo = hopper::smem_addr(smem) + cw * 64 * 128;
    // Q hi of rows qi0 and qi1 as TF32 A fragments: k-step kk holds columns
    // 8kk + t (registers 0, 1) and 8kk + t + 4 (2, 3) of rows qi0, qi1, qi0, qi1
    uint32_t qh[HD / 8][4];
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = j & 1 ? qi1 : qi0, col = 8 * kk + t2 / 2 + 4 * (j >> 1);
        qh[kk][j] = hopper::tf32_rna(qi < S ? q[base + qi * rs + col] : 0.f);
      }

    for (int it = 0; it < n_tiles; ++it) {
      const int stage = it % ST, k0 = (j0 + it) * BKV;
      hopper::named_barrier_sync(kBarFull + stage, kAttnTfThreads);
      if (k0 <= qhi && k0 + BKV > kf) {
        const uint32_t k_hi = hopper::smem_addr(smem + kQ + stage * kStage),
                       k_lo = k_hi + kK;
        const uint32_t v_hi = k_hi + 2 * kK, v_lo = v_hi + kV;

        // S = Q Kᵀ in 3xTF32: per k8 step (32 B along a swizzled row, the next
        // panel every 4) lo·hi from shared memory, then hi·lo and hi·hi with Q
        // hi from registers, into one f32 accumulator
        float s[NT * 4];
#pragma unroll
        for (int i = 0; i < NT * 4; ++i) s[i] = 0.f;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 8; ++kk) {
          const uint32_t qo = (kk / 4) * kQPanel + (kk % 4) * 32;
          const uint32_t ko = (kk / 4) * kKPanel + (kk % 4) * 32;
          const uint64_t al = hopper::desc_sw128(q_lo + qo, 16, 1024);
          const uint64_t bh = hopper::desc_sw128(k_hi + ko, 16, 1024);
          const uint64_t bl = hopper::desc_sw128(k_lo + ko, 16, 1024);
          hopper::wgmma_m64n32k8_tf32_ss(s, al, bh, 1);
          hopper::wgmma_m64n32k8_tf32_rs(s, qh[kk], bl, 1);
          hopper::wgmma_m64n32k8_tf32_rs(s, qh[kk], bh, 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operands(s);

        // the mask only where some pair of the warpgroup's rows is not kept
        const bool masked = k0 + BKV - 1 > qlo || (window > 0 && k0 <= qhi - window);
        // partial maxima and sums [n & 1][e] (e < 2: row g, else row g + 8)
        float mx[8], ps[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          mx[i] = kNegInf;
          ps[i] = 0.f;
        }
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& x = s[4 * n + e];
            const int kj = k0 + 8 * n + t2 + (e & 1);
            x = !masked || kept(e < 2 ? qi0 : qi1, kj, window) ? x * scale_log2 : kNegInf;
            mx[4 * (n & 1) + e] = fmaxf(mx[4 * (n & 1) + e], x);
          }
        float mx0 = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[4], mx[5]));
        float mx1 = fmaxf(fmaxf(mx[2], mx[3]), fmaxf(mx[6], mx[7]));
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float al0 = exp2_ftz(m0 - mn0), al1 = exp2_ftz(m1 - mn1);
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& x = s[4 * n + e];
            x = exp2_ftz(x - (e < 2 ? mn0 : mn1));
            ps[4 * (n & 1) + e] += x;
          }
        l0 = l0 * al0 + ((ps[0] + ps[1]) + (ps[4] + ps[5]));
        l1 = l1 * al1 + ((ps[2] + ps[3]) + (ps[6] + ps[7]));
        m0 = mn0;
        m1 = mn1;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          acc[4 * n] *= al0;
          acc[4 * n + 1] *= al0;
          acc[4 * n + 2] *= al1;
          acc[4 * n + 3] *= al1;
        }

        // O += P V in 3xTF32.  The A fragment of k-step kt wants keys t and
        // t + 4 of n-tile kt where this thread holds keys 2t and 2t + 1: Vᵀ's
        // key order (the producer's) makes s[4kt], s[4kt + 2], s[4kt + 1],
        // s[4kt + 3] that fragment as they are.
        uint32_t ph[NT][4], pl[NT][4];
#pragma unroll
        for (int kt = 0; kt < NT; ++kt) {
          split_tf32(s[4 * kt], ph[kt][0], pl[kt][0]);
          split_tf32(s[4 * kt + 2], ph[kt][1], pl[kt][1]);
          split_tf32(s[4 * kt + 1], ph[kt][2], pl[kt][2]);
          split_tf32(s[4 * kt + 3], ph[kt][3], pl[kt][3]);
        }
        hopper::wgmma_fence();
#pragma unroll
        for (int kt = 0; kt < NT; ++kt) {
          const uint64_t bh = hopper::desc_sw128(v_hi + kt * 32, 16, 1024);
          const uint64_t bl = hopper::desc_sw128(v_lo + kt * 32, 16, 1024);
          if constexpr (HD == 64) {
            hopper::wgmma_m64n64k8_tf32_rs(acc, pl[kt], bh, 1);
            hopper::wgmma_m64n64k8_tf32_rs(acc, ph[kt], bl, 1);
            hopper::wgmma_m64n64k8_tf32_rs(acc, ph[kt], bh, 1);
          } else {
            hopper::wgmma_m64n128k8_tf32_rs(acc, pl[kt], bh, 1);
            hopper::wgmma_m64n128k8_tf32_rs(acc, ph[kt], bl, 1);
            hopper::wgmma_m64n128k8_tf32_rs(acc, ph[kt], bh, 1);
          }
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operands(acc);
      }
      // this stage is free again, if the producer will fill it
      if (it + ST < n_tiles) hopper::named_barrier_arrive(kBarEmpty + stage, kAttnTfThreads);
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
    float* ob = o + base;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      if (qi0 < S)
        *reinterpret_cast<float2*>(ob + qi0 * rs + 8 * n + t2) =
            make_float2(acc[4 * n] / den0, acc[4 * n + 1] / den0);
      if (qi1 < S)
        *reinterpret_cast<float2*>(ob + qi1 * rs + 8 * n + t2) =
            make_float2(acc[4 * n + 2] / den1, acc[4 * n + 3] / den1);
    }
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
int launch_f32_tf32x3(const void* q, const void* k, const void* v, void* o, int B, int S,
                      int H, int window, float scale, cudaStream_t st) {
  constexpr int smem = smem_f32_tf32x3<HD>() + kSmemAlign;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_f32_tf32x3_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kAttnTfBlockQ - 1) / kAttnTfBlockQ, B * H);
  flash_f32_tf32x3_kernel<HD><<<grid, kAttnTfThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, window, scale * kLog2e);
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

// cuTensorMapEncodeTiled, found through the runtime (nothing links -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A 4-D tensor map over one of q, k, v in the (B, S, H, hd) layout: dims
// {hd, H, S, B}, box {64, 1, rows, 1}, 128B swizzle, zeros past each extent.
// Returns 0, a cudaError_t of the entry-point lookup, or kTensorMapError plus
// the encode's CUresult.
int encode_qkv(CUtensorMap* map, const void* ptr, int B, int S, int H, int hd, int rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * hd, 2ull * H * hd, 2ull * S * H * hd};
  const cuuint32_t box[4] = {(cuuint32_t)kAttnWgPanel, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + (int)r;
}

template <int HD>
int launch_bf16_wgmma(const void* q, const void* k, const void* v, void* o, int B, int S,
                      int H, int window, float scale, cudaStream_t st) {
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  const int rows[3] = {kAttnWgBlockQ, kAttnWgBlockKV, kAttnWgBlockKV};
  for (int i = 0; i < 3; ++i) {
    const int err = encode_qkv(&maps[i], ptrs[i], B, S, H, HD, rows[i]);
    if (err) return err;
  }
  constexpr int smem = smem_bf16_wgmma<HD>() + kSmemAlign;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kAttnWgBlockQ - 1) / kAttnWgBlockQ, B * H);
  flash_bf16_wgmma_kernel<HD><<<grid, kAttnWgThreads, smem, st>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), S, H, window,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

bool valid_shape(int B, int S, int H, int window) {
  return B >= 1 && S >= 1 && H >= 1 && window >= 0 && (long long)B * H <= kMaxGridY;
}

}  // namespace

extern "C" {

// the FFMA body at any width
int flash_attention_f32_ffma(const void* q, const void* k, const void* v, void* o, int B,
                             int S, int H, int hd, int window, float scale, void* stream) {
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

// 0 (FFMA), 1 (wgmma), 2 (mma.sync) or 3 (3xTF32): the body
// flash_attention_f32 (bf16 = 0) or flash_attention_bf16 (bf16 = 1) launches
// at head width hd; -1 for a width with no kernel
int flash_attention_body(int bf16, int hd) {
  switch (hd) {
    case 8: case 16: case 32: case 256: return bf16 ? kBodyMma : kBodyFfma;
    case 64: case 128: return bf16 ? kBodyWgmma : kBodyTf32x3;
    default: return -1;
  }
}

int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int B, int S,
                        int H, int hd, int window, float scale, void* stream) {
  if (!valid_shape(B, S, H, window)) return (int)cudaErrorInvalidValue;
  if (flash_attention_body(0, hd) != kBodyTf32x3)
    return flash_attention_f32_ffma(q, k, v, o, B, S, H, hd, window, scale, stream);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return hd == 64 ? launch_f32_tf32x3<64>(q, k, v, o, B, S, H, window, scale, st)
                  : launch_f32_tf32x3<128>(q, k, v, o, B, S, H, window, scale, st);
}

// the mma.sync body at any width
int flash_attention_bf16_mma(const void* q, const void* k, const void* v, void* o, int B,
                             int S, int H, int hd, int window, float scale, void* stream) {
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

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int B, int S,
                         int H, int hd, int window, float scale, void* stream) {
  if (!valid_shape(B, S, H, window)) return (int)cudaErrorInvalidValue;
  if (flash_attention_body(1, hd) != kBodyWgmma)
    return flash_attention_bf16_mma(q, k, v, o, B, S, H, hd, window, scale, stream);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return hd == 64 ? launch_bf16_wgmma<64>(q, k, v, o, B, S, H, window, scale, st)
                  : launch_bf16_wgmma<128>(q, k, v, o, B, S, H, window, scale, st);
}

}  // extern "C"
