// Shared device code of the stencil kernels (stencil_spmv.cu, spmv_dot.cu,
// precond.cu, bicgstab_fused.cu, rb_gs.cu) and of the flat vector passes
// (cg_fused_update.cu, fused_bodies.cu, fused_axpby.cu).
//
// Layout: the halo-padded operand xp is (nx+2, ny+2, nz+2) row-major, z
// contiguous; every unpadded operand and output is (nx, ny, nz).  A block is
// kBlockZ threads along z (coalesced loads and stores) by kBlockY rows along
// y; each thread walks kPlanesX consecutive x-planes, so the two neighbour
// planes it reads for one output are the planes it reads for the next, and
// they come from L1/L2.  The kernel masks the ragged edges itself, so any
// (nx, ny, nz) works.
//
// Two kernels compute y = A x at each point and hand (flat unpadded index e,
// centre value x[e], y) to a Tail, which stores y or the elementwise update
// built on it and adds to the block's dot partials; the Tail's operands are
// indexed with the unpadded index e.
//
// * stencil_kernel (above): xp is indexed with the padded strides, one
//   output per thread and 27 (or 7) global loads per output.  It serves
//   ChebTail and JacobiTail in the f32 launches the ring's pair stage does
//   not take, both BiCGStab tails in f64 and f32 (the static rules of
//   precond.cu and bicgstab_fused.cu) and RbGsTail in f64 7pt and f32
//   (rb_gs.cu's static rule); it is also the yardstick the ring pass is
//   timed against (precond.cu's old_pass).
// * stencil_ring_kernel (below), the Hopper pass: 2.5-D blocking through a
//   ring of plane tiles in shared memory, fed by cp.async (on its pair
//   stage bf16 as 4-byte and f32 as 8-byte pairs, two outputs a thread),
//   with the zero halo made in the kernel when the operand comes unpadded.
//   It serves stencil_spmv (SpmvTail<T, 0> and <T, 1>), stencil_spmv_dots
//   (SpmvTail<T, 2>), stencil_spmv_dots3 (Dots3Tail), from either operand
//   form block_jacobi_sweep (JacobiTail) and cheb_fused_step (ChebTail) in
//   f64 and bf16 and in f32 at its pair stage (f32_pair_tail, precond.cu's
//   rule), and, from the padded operand, rb_gs_half_sweep in f64 27pt and
//   bf16 (RbGsTail) and in bf16 both BiCGStab passes (BicgDotsTail,
//   BicgUpdateTail); on the pair stage all but bf16's JacobiTail take a
//   thread's two outputs in one call of their pair form, their unpadded
//   streams read and written as pairs (pair_tail).
//
// A batch of lanes: both passes take B operands stacked on a leading axis,
// (B, nx+2, ny+2, nz+2) padded or (B, nx, ny, nz) unpadded, and B outputs
// likewise, in one launch.  The lane is folded into blockIdx.z (lane × the
// x-runs of one lane): a block finds its lane and its run in it, offsets x by
// the lane's stride, and hands the tail the flat index of the point in the
// (B, nx, ny, nz) stack, so a lane's output is the one-lane pass's on it,
// bit for bit.  Only a tail without partials takes lanes (the launchers
// refuse the others): a block's partials would mix no lanes, but one sum
// over all blocks would.
//
// Arithmetic: centre term first, then the offsets in Stencil.offsets order,
// with one rounding per multiply and per add (no FMA contraction), which is
// exactly what the plain PyTorch version computes.  The tails round each
// operation on its own too, in the plain version's order.  A tail that
// declares kOffDiag = true (RbGsTail) gets the off-diagonal sum (A − D) x
// instead, summed from 0 in the same offset order with the centre skipped
// (Stencil.offdiag_apply_padded), and the parity of i + j + k as a fifth
// argument, on both passes.
//
// Dot partials: each block writes its sums to its own slot of a scratch
// buffer, and reduce_partials sums the slots in a fixed order.  No atomics,
// so two runs on the same input give bitwise-equal scalars.
//
// Types: every pass has float, double and __nv_bfloat16 instances.  The
// partials, their slots and the dots are acc_t<T>: T, or float for bf16
// (each product formed in float from the widened operands), the
// reference's acc_dtype rule.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>
#include <utility>

namespace repro {

constexpr int kBlockZ = 64;
constexpr int kBlockY = 4;
constexpr int kThreads = kBlockZ * kBlockY;
constexpr int kPlanesX = 8;
constexpr int kReduceThreads = 1024;

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
// bf16: sm_90's native add/sub/mul.rn.bf16, each correctly rounded and never
// contracted into an FMA.  PyTorch computes a bf16 op in f32 and rounds the
// result to bf16; for +, − and × that double rounding equals the one correct
// rounding (24 ≥ 2·8 + 2 bits), so both give the same bits.
__device__ __forceinline__ __nv_bfloat16 mul_rn(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __hmul_rn(a, b);
}
__device__ __forceinline__ __nv_bfloat16 add_rn(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __hadd_rn(a, b);
}
__device__ __forceinline__ __nv_bfloat16 sub_rn(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __hsub_rn(a, b);
}
// bf16 pairs, one output's value a lane: add/sub/mul.rn.bf16x2 round each
// lane once and are never contracted, so a lane's bits are the scalar
// mul_rn/add_rn/sub_rn's.
__device__ __forceinline__ __nv_bfloat162 mul_rn(__nv_bfloat162 a, __nv_bfloat162 b) {
  return __hmul2_rn(a, b);
}
__device__ __forceinline__ __nv_bfloat162 add_rn(__nv_bfloat162 a, __nv_bfloat162 b) {
  return __hadd2_rn(a, b);
}
__device__ __forceinline__ __nv_bfloat162 sub_rn(__nv_bfloat162 a, __nv_bfloat162 b) {
  uint32_t ua, ub, ur;
  memcpy(&ua, &a, sizeof(ua));
  memcpy(&ub, &b, sizeof(ub));
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(ur) : "r"(ua), "r"(ub));
  __nv_bfloat162 r;
  memcpy(&r, &ur, sizeof(r));
  return r;
}

// f32 pairs, one output's value a lane: sm_90 has no packed f32 add or
// multiply, so each lane is its own scalar operation, rounded once and never
// contracted, and a lane's bits are the scalar mul_rn/add_rn/sub_rn's.
__device__ __forceinline__ float2 mul_rn(float2 a, float2 b) {
  return make_float2(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y));
}
__device__ __forceinline__ float2 add_rn(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}
__device__ __forceinline__ float2 sub_rn(float2 a, float2 b) {
  return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
}

// The type of two neighbouring z-values (k, k + 1) of T: a thread's outputs
// on the ring's pair stage, or a pair tail's stream pair at an even index.
template <typename T>
struct pair_type {
  using type = double2;
};
template <>
struct pair_type<float> {
  using type = float2;
};
template <>
struct pair_type<__nv_bfloat16> {
  using type = __nv_bfloat162;
};
template <typename T>
using pair_t = typename pair_type<T>::type;

// v in both lanes of a pair
__device__ __forceinline__ __nv_bfloat162 splat(__nv_bfloat16 v) {
  return __bfloat162bfloat162(v);
}
__device__ __forceinline__ float2 splat(float v) { return make_float2(v, v); }

// The pair (p[e], p[e + 1]) as one load (4 bytes in bf16, 8 in f32), and
// its store: e even and p aligned to the pair (pairs_aligned).
template <typename T>
__device__ __forceinline__ pair_t<T> load_pair(const T* __restrict__ p, int64_t e) {
  return *reinterpret_cast<const pair_t<T>*>(p + e);
}
template <typename T>
__device__ __forceinline__ void store_pair(T* __restrict__ p, int64_t e, pair_t<T> v) {
  *reinterpret_cast<pair_t<T>*>(p + e) = v;
}

// Whether every stream is aligned to a pair of its elements (4 bytes in
// bf16, 8 in f32), so that the pair at an even index of each is one aligned
// word (a pair tail's streams).
template <typename... P>
inline bool pairs_aligned(const P*... ps) {
  return ((reinterpret_cast<uintptr_t>(ps) % (2 * sizeof(P)) == 0) && ...);
}

// The type a kernel in T accumulates its dot partials in: T itself, float
// for bf16 (the reference's acc_dtype), so bf16 partials are f32 sums of f32
// products (exact: two 8-bit significands fit in 24 bits).
template <typename T>
struct acc_type {
  using type = T;
};
template <>
struct acc_type<__nv_bfloat16> {
  using type = float;
};
template <typename T>
using acc_t = typename acc_type<T>::type;

__device__ __forceinline__ double to_acc(double a) { return a; }
__device__ __forceinline__ float to_acc(float a) { return a; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 a) { return __bfloat162float(a); }

// v · s rounded once into T, with s in acc_t<T>: what eager PyTorch computes
// on CUDA for a tensor divided by a Python number (a multiply by the
// reciprocal, formed in the op's math type: f32 for bf16).
__device__ __forceinline__ double scale_rn(double v, double s) { return __dmul_rn(v, s); }
__device__ __forceinline__ float scale_rn(float v, float s) { return __fmul_rn(v, s); }
__device__ __forceinline__ float2 scale_rn(float2 v, float s) {
  return make_float2(__fmul_rn(v.x, s), __fmul_rn(v.y, s));
}
__device__ __forceinline__ __nv_bfloat16 scale_rn(__nv_bfloat16 v, float s) {
  return __float2bfloat16_rn(__fmul_rn(__bfloat162float(v), s));
}

// --- flat vector passes ------------------------------------------------------

// A flat pass is a grid-stride loop over the n elements of contiguous
// vectors, kFlatThreads threads a block, neighbouring threads on neighbouring
// elements of every stream.
constexpr int kFlatThreads = 256;
constexpr int64_t kFlatMaxBlocks = 1 << 20;
// A flat pass with partials takes at most kFlatDotsBlocks blocks: its block
// count, and so its number of partial slots, is a function of n alone, and
// the same input gives the same sum order on every run.
constexpr int64_t kFlatDotsBlocks = 1024;

inline int64_t flat_blocks(int64_t n, int64_t cap) {
  const int64_t blocks = (n + kFlatThreads - 1) / kFlatThreads;
  return blocks < cap ? blocks : cap;
}

// Call f(std::integral_constant<int, V>{}) for the V of VS equal to v (one
// kernel instance a V); false, and no call, when v is none of them.
template <int... VS, typename F>
bool pick(std::integer_sequence<int, VS...>, int v, F&& f) {
  return ((v == VS && (f(std::integral_constant<int, VS>{}), true)) || ...);
}

template <int... VS>
constexpr bool one_of(std::integer_sequence<int, VS...>, int v) {
  return ((v == VS) || ...);
}

// --- the stencil pass --------------------------------------------------------

// The grid of the stencil pass over ``lanes`` stacked operands (blockIdx.z
// = lane × runs + run); its block count is the number of partial slots per
// dot product.
inline dim3 stencil_grid(int nx, int ny, int nz, int lanes = 1) {
  return dim3((nz + kBlockZ - 1) / kBlockZ, (ny + kBlockY - 1) / kBlockY,
              (unsigned)lanes * ((nx + kPlanesX - 1) / kPlanesX));
}

inline bool stencil_grid_ok(int nx, int ny, int nz, int lanes = 1) {
  if (nx <= 0 || ny <= 0 || nz <= 0 || lanes <= 0) return false;
  const long long gz = (long long)lanes * ((nx + kPlanesX - 1) / kPlanesX);
  return (ny + kBlockY - 1) / kBlockY <= 65535 && gz <= 65535;
}

inline long long stencil_num_blocks(int nx, int ny, int nz) {
  dim3 g = stencil_grid(nx, ny, nz);
  return (long long)g.x * g.y * g.z;
}

// y at one interior point; c is the centre's flat index in xp, sx and sy its
// x and y strides.  With OFFDIAG the centre term is left out and the sum
// starts from 0.
template <typename T, int NPT, bool OFFDIAG = false>
__device__ __forceinline__ T apply_point(const T* __restrict__ xp, int64_t c,
                                         int64_t sx, int64_t sy, T diag, T off) {
  T acc = OFFDIAG ? T(0.0f) : mul_rn(diag, xp[c]);
  if constexpr (NPT == 7) {
    acc = add_rn(acc, mul_rn(off, xp[c - sx]));
    acc = add_rn(acc, mul_rn(off, xp[c + sx]));
    acc = add_rn(acc, mul_rn(off, xp[c - sy]));
    acc = add_rn(acc, mul_rn(off, xp[c + sy]));
    acc = add_rn(acc, mul_rn(off, xp[c - 1]));
    acc = add_rn(acc, mul_rn(off, xp[c + 1]));
  } else {
    static_assert(NPT == 27, "the stencils are 7pt and 27pt");
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
        for (int dz = -1; dz <= 1; ++dz) {
          if (dx == 0 && dy == 0 && dz == 0) continue;
          acc = add_rn(acc, mul_rn(off, xp[c + dx * sx + dy * sy + dz]));
        }
      }
    }
  }
  return acc;
}

// --- tails: what the pass does with y at each point -------------------------

// y = A x; with NDOT = 1 also the partial of y·x, with NDOT = 2 the partials
// of y·x and x·x.  A tail's partials v are in acc_t<T>, each product formed
// there from the operands widened.
template <typename T, int NDOT>
struct SpmvTail {
  static constexpr int kDots = NDOT;
  T* __restrict__ y;
  __device__ __forceinline__ void operator()(int64_t e, T xc, T yv, acc_t<T>* v) const {
    y[e] = yv;
    if constexpr (NDOT >= 1) v[0] = add_rn(v[0], mul_rn(to_acc(yv), to_acc(xc)));
    if constexpr (NDOT >= 2) v[1] = add_rn(v[1], mul_rn(to_acc(xc), to_acc(xc)));
  }
};

// y = A x and the partials of y·x, r·x and r·r, with r unpadded.  On the
// ring pass, prefetch(e) asks for r[e] a step before the tail reads it.
template <typename T>
struct Dots3Tail {
  static constexpr int kDots = 3;
  T* __restrict__ y;
  const T* __restrict__ r;
  __device__ __forceinline__ void prefetch(int64_t e) const {
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(r + e));
  }
  __device__ __forceinline__ void operator()(int64_t e, T xc, T yv, acc_t<T>* v) const {
    const acc_t<T> re = to_acc(r[e]), xa = to_acc(xc);
    y[e] = yv;
    v[0] = add_rn(v[0], mul_rn(to_acc(yv), xa));
    v[1] = add_rn(v[1], mul_rn(re, xa));
    v[2] = add_rn(v[2], mul_rn(re, re));
  }
};

// One Chebyshev step: d' = a·d + c·(r − A z), z' = z + d' (x is z here).
// On the ring pass, prefetch(e) asks for r[e] and d[e] a step before the
// tail reads them; on its pair stage (bf16, f32) pair(e, ...) takes the
// outputs (e, e + 1) at once, each stream loaded and stored as one pair and
// each lane rounded as the scalar form rounds it.
template <typename T>
struct ChebTail {
  static constexpr int kDots = 0;
  const T* __restrict__ r;
  const T* __restrict__ d;
  T* __restrict__ z_out;
  T* __restrict__ d_out;
  T a, c;
  __device__ __forceinline__ void prefetch(int64_t e) const {
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(r + e));
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(d + e));
  }
  __device__ __forceinline__ void operator()(int64_t e, T zc, T az, acc_t<T>*) const {
    const T dn = add_rn(mul_rn(a, d[e]), mul_rn(c, sub_rn(r[e], az)));
    d_out[e] = dn;
    z_out[e] = add_rn(zc, dn);
  }
  __device__ __forceinline__ void pair(int64_t e, pair_t<T> zc, pair_t<T> az,
                                       acc_t<T>*) const {
    const pair_t<T> a2 = splat(a), c2 = splat(c);
    const pair_t<T> dn =
        add_rn(mul_rn(a2, load_pair(d, e)), mul_rn(c2, sub_rn(load_pair(r, e), az)));
    store_pair(d_out, e, dn);
    store_pair(z_out, e, add_rn(zc, dn));
  }
  bool pairs_aligned() const { return repro::pairs_aligned(r, d, z_out, d_out); }
};

// One damped Jacobi sweep: z' = z + (ω·(r − A z))·(1/diag) (x is z here).
// The division by diag is a multiply by its reciprocal (formed in acc_t<T>),
// rounded in T: what eager PyTorch does on CUDA for a tensor divided by a
// Python number (scale_rn).  On the ring pass, prefetch(e) asks for r[e] a
// step before the tail reads it; on f32's pair stage pair(e, ...) takes the
// outputs (e, e + 1) at once, r loaded and z' stored as one float2 and each
// lane rounded as the scalar form rounds it (bf16's pair stage calls the
// scalar form twice: pair_tail below).
template <typename T>
struct JacobiTail {
  static constexpr int kDots = 0;
  const T* __restrict__ r;
  T* __restrict__ z_out;
  T omega;
  acc_t<T> inv_diag;
  __device__ __forceinline__ void prefetch(int64_t e) const {
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(r + e));
  }
  __device__ __forceinline__ void operator()(int64_t e, T zc, T az, acc_t<T>*) const {
    z_out[e] = add_rn(zc, scale_rn(mul_rn(omega, sub_rn(r[e], az)), inv_diag));
  }
  __device__ __forceinline__ void pair(int64_t e, pair_t<T> zc, pair_t<T> az,
                                       acc_t<T>*) const {
    const pair_t<T> w2 = splat(omega);
    store_pair(z_out, e, add_rn(zc, scale_rn(mul_rn(w2, sub_rn(load_pair(r, e), az)),
                                             inv_diag)));
  }
  bool pairs_aligned() const { return repro::pairs_aligned(r, z_out); }
};

// One red-black Gauss-Seidel half-sweep (x is the old iterate here, off the
// off-diagonal sum): x' = (b − off)·(1/diag) where (i + j + k) mod 2 ==
// colour, x' = x elsewhere.  The division by diag is a multiply by its
// reciprocal, rounded in T, as in JacobiTail.  On the ring pass,
// prefetch(e) asks for b[e] a step before the tail reads it; on its pair
// stage (bf16) pair(e, ...) takes the outputs (e, e + 1) at once, b loaded
// and x' stored as one bf16 pair.  The two lanes' points differ by one in
// k, so their parities differ: exactly one lane takes the update, rounded
// as the scalar form rounds it (b − off in bf16, then the product with the
// f32 reciprocal rounded once), and the other keeps its centre value.
template <typename T>
struct RbGsTail {
  static constexpr int kDots = 0;
  static constexpr bool kOffDiag = true;
  const T* __restrict__ b;
  T* __restrict__ x_out;
  acc_t<T> inv_diag;
  int colour;
  __device__ __forceinline__ void prefetch(int64_t e) const {
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(b + e));
  }
  __device__ __forceinline__ void operator()(int64_t e, T xc, T off, acc_t<T>*,
                                             int parity) const {
    x_out[e] = parity == colour ? scale_rn(sub_rn(b[e], off), inv_diag) : xc;
  }
  // parity is lane e's; lane e + 1's is its opposite
  __device__ __forceinline__ void pair(int64_t e, __nv_bfloat162 xc, __nv_bfloat162 off,
                                       float*, int parity) const {
    const __nv_bfloat162 d = sub_rn(load_pair(b, e), off);
    if (parity == colour)
      store_pair(x_out, e, __halves2bfloat162(scale_rn(d.x, inv_diag), xc.y));
    else
      store_pair(x_out, e, __halves2bfloat162(xc.x, scale_rn(d.y, inv_diag)));
  }
  bool pairs_aligned() const { return repro::pairs_aligned(b, x_out); }
};

// Whether a tail has a prefetch(e) for its unpadded operands at point e,
// which the ring pass calls a step ahead.
template <typename Tail, typename = void>
struct prefetch_tail : std::false_type {};
template <typename Tail>
struct prefetch_tail<Tail, std::void_t<decltype(&Tail::prefetch)>> : std::true_type {};

// Whether a tail has a pair form, pair(e, xc, y, v) (RbGsTail's also takes
// lane e's parity): on the ring's pair stage
// it takes the step's two outputs (e, e + 1) of a thread at once (e even),
// its unpadded streams loaded and stored as pairs (each aligned to a pair:
// Tail::pairs_aligned(), else the launch takes T's element stage,
// ring_tail_stage), its partials added lane e before lane e + 1.  The other
// tails take the two outputs in two scalar calls, and so does bf16's
// JacobiTail (the pair form is f32's; bf16's sweep keeps its instance).
template <typename Tail, typename = void>
struct pair_tail : std::false_type {};
template <typename Tail>
struct pair_tail<Tail, std::void_t<decltype(&Tail::pair)>> : std::true_type {};
template <>
struct pair_tail<JacobiTail<__nv_bfloat16>> : std::false_type {};

// Whether a tail in f32 takes the ring's pair stage where the operands allow
// it (the f32 pair stage's per-tail rule): ChebTail and JacobiTail, which
// also have a pair form.  f32's other tails copy elements (kStageAsync).
template <typename Tail>
struct f32_pair_tail : std::false_type {};
template <>
struct f32_pair_tail<ChebTail<float>> : std::true_type {};
template <>
struct f32_pair_tail<JacobiTail<float>> : std::true_type {};

// Whether a tail takes the off-diagonal sum (Tail::kOffDiag, false when the
// tail does not declare it).
template <typename Tail, typename = void>
struct off_diag_tail : std::false_type {};
template <typename Tail>
struct off_diag_tail<Tail, std::void_t<decltype(Tail::kOffDiag)>>
    : std::integral_constant<bool, Tail::kOffDiag> {};

// Sum v over the block in a fixed tree order; thread 0 ends with the totals.
template <typename T, int NDOT, int NTHREADS>
__device__ __forceinline__ void block_sum(T (&v)[NDOT], int tid) {
  static_assert(NTHREADS % 32 == 0 && NTHREADS <= 1024, "whole warps");
  constexpr int kWarps = NTHREADS / 32;
  __shared__ T sh[NDOT][kWarps];
#pragma unroll
  for (int d = 0; d < NDOT; ++d) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[d] += __shfl_down_sync(0xffffffffu, v[d], o);
  }
  if ((tid & 31) == 0) {
#pragma unroll
    for (int d = 0; d < NDOT; ++d) sh[d][tid >> 5] = v[d];
  }
  __syncthreads();
  if (tid < 32) {
#pragma unroll
    for (int d = 0; d < NDOT; ++d) {
      T t = tid < kWarps ? sh[d][tid] : T(0);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(0xffffffffu, t, o);
      v[d] = t;
    }
  }
}

// The epilogue of a flat pass with NDOT partials: sum each over the block
// and store it at partials[d * gridDim.x + block].
template <typename T, int NDOT>
__device__ __forceinline__ void store_flat_partials(T (&v)[NDOT], T* __restrict__ partials) {
  block_sum<T, NDOT, kFlatThreads>(v, threadIdx.x);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int d = 0; d < NDOT; ++d) partials[d * gridDim.x + blockIdx.x] = v[d];
  }
}

// The stencil pass: y = A x from the padded x at every point, handed to the
// tail; the tail's Tail::kDots partials are stored at
// partials[d * nblocks + block].
template <typename T, int NPT, typename Tail>
__global__ void __launch_bounds__(kThreads)
stencil_kernel(const T* __restrict__ xp, Tail tail, acc_t<T>* __restrict__ partials,
               int nx, int ny, int nz, T diag, T off) {
  constexpr int NDOT = Tail::kDots;
  constexpr bool OFFDIAG = off_diag_tail<Tail>::value;
  const int k = blockIdx.x * kBlockZ + threadIdx.x;
  const int j = blockIdx.y * kBlockY + threadIdx.y;
  const int runs = (nx + kPlanesX - 1) / kPlanesX;
  const int lane = blockIdx.z / runs;
  const int i0 = (blockIdx.z - lane * runs) * kPlanesX;
  const int64_t sy = nz + 2;
  const int64_t sx = (int64_t)(ny + 2) * sy;
  xp += (int64_t)lane * (nx + 2) * sx;
  acc_t<T> v[NDOT > 0 ? NDOT : 1];
#pragma unroll
  for (int d = 0; d < (NDOT > 0 ? NDOT : 1); ++d) v[d] = acc_t<T>(0);
  if (k < nz && j < ny) {
    const int i1 = min(i0 + kPlanesX, nx);
    for (int i = i0; i < i1; ++i) {
      const int64_t c = (int64_t)(i + 1) * sx + (int64_t)(j + 1) * sy + (k + 1);
      const T yv = apply_point<T, NPT, OFFDIAG>(xp, c, sx, sy, diag, off);
      const int64_t e = (((int64_t)lane * nx + i) * ny + j) * nz + k;
      if constexpr (OFFDIAG)
        tail(e, xp[c], yv, v, (i + j + k) & 1);
      else
        tail(e, xp[c], yv, v);
    }
  }
  if constexpr (NDOT > 0) {
    // every thread of the block takes part, in range or not
    const int tid = threadIdx.y * kBlockZ + threadIdx.x;
    block_sum<acc_t<T>, NDOT, kThreads>(v, tid);
    if (tid == 0) {
      const int64_t nb = (int64_t)gridDim.x * gridDim.y * gridDim.z;
      const int64_t b = ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
#pragma unroll
      for (int d = 0; d < NDOT; ++d) partials[d * nb + b] = v[d];
    }
  }
}

// out[d] = sum of partials[d * nblocks + b] over b, in a fixed order: thread t
// sums slots t, t + 1024, ... in turn, then the block sums the threads.  (One
// loop over the slots for all NDOT sums: with a loop per sum ptxas held
// reduce_partials<double, 9> to 32 registers and spilled.)
template <typename T, int NDOT>
__global__ void __launch_bounds__(kReduceThreads)
reduce_partials(const T* __restrict__ partials, int64_t nblocks, T* __restrict__ out) {
  const int tid = threadIdx.x;
  T v[NDOT];
#pragma unroll
  for (int d = 0; d < NDOT; ++d) v[d] = T(0);
  for (int64_t b = tid; b < nblocks; b += kReduceThreads) {
#pragma unroll
    for (int d = 0; d < NDOT; ++d) v[d] += partials[d * nblocks + b];
  }
  block_sum<T, NDOT, kReduceThreads>(v, tid);
  if (tid == 0) {
#pragma unroll
    for (int d = 0; d < NDOT; ++d) out[d] = v[d];
  }
}

// Launch the stencil pass with ``tail`` over ``lanes`` stacked operands and,
// when the tail has partials (one lane only), the fixed-order reduction of
// them into dots[0..Tail::kDots), both in acc_t<T>.  diag and off are
// rounded to T.  Returns cudaGetLastError().
template <typename T, typename Tail>
int launch_stencil(const T* xp, Tail tail, acc_t<T>* partials, acc_t<T>* dots, int nx, int ny,
                   int nz, int npoint, double diag, double off, cudaStream_t stream,
                   int lanes = 1) {
  if (!stencil_grid_ok(nx, ny, nz, lanes) || (npoint != 7 && npoint != 27) ||
      (Tail::kDots > 0 && lanes != 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid = stencil_grid(nx, ny, nz, lanes);
  const dim3 block(kBlockZ, kBlockY);
  if (npoint == 7)
    stencil_kernel<T, 7, Tail><<<grid, block, 0, stream>>>(xp, tail, partials, nx, ny, nz,
                                                           (T)diag, (T)off);
  else
    stencil_kernel<T, 27, Tail><<<grid, block, 0, stream>>>(xp, tail, partials, nx, ny, nz,
                                                            (T)diag, (T)off);
  if constexpr (Tail::kDots > 0) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    reduce_partials<acc_t<T>, Tail::kDots><<<1, kReduceThreads, 0, stream>>>(
        partials, (int64_t)stencil_num_blocks(nx, ny, nz), dots);
  }
  return (int)cudaGetLastError();
}

// --- the plane-ring stencil pass (Hopper) -----------------------------------
//
// A block owns a kRingY × kRingZ tile of the (y, z) plane (one output column
// per thread, threads along z) and marches along x over a run of output
// planes (64 × 4, with a ring of 8: four blocks an SM; the tile measured by
// chip_stencil_variants.py).  The run is a template argument, picked at
// launch from RingRuns (kernels/autotune.py tunes it per grid; kRingRun = 16
// is the default and the lane-batched form's, 512 blocks at 128³); RbGsTail
// marches kRingRunRbGs alone, JacobiTail kRingRunJacobi, ChebTail
// kRingRunCheb, BicgDotsTail kRingRunBicgDots and BicgUpdateTail
// kRingRunBicgUpdate.  Each input
// plane's (kRingY + 2) × (kRingZ + 2) tile, halo included, is copied into a
// ring of kRingDepth slots in shared memory by
// cp.async (one 4- or 8-byte copy per element, all threads taking part),
// kRingDepth − 2 planes ahead of the plane being read; a copy whose element
// lies outside the operand has src-size 0 and writes zeros, which is the
// zero halo.  A tail with a prefetch(e) has its own operands asked for a
// step ahead.  Each thread reads the 3 × 3 neighbourhood of its (j, k) from
// the newest plane once and keeps it and the plane before in registers: 9
// shared-memory reads per output in 27pt (5 in 7pt) instead of 27 (7)
// global loads.  The arithmetic is apply_point's: centre first, then the
// offsets in Stencil.offsets order, one rounding per multiply and per add.
// Each output's sum is split at a plane boundary (ring_first, ring_last),
// so a step ends one output and starts the next: two independent chains of
// dependent adds a thread instead of one.
//
// The operand x comes in one of two forms, read by the same code with other
// strides and an origin offset lo: padded, (nx+2, ny+2, nz+2) with the halo
// supplied by the caller (lo = 0), or unpadded, (nx, ny, nz) (lo = 1), whose
// halo the zero-filled copies make.  Padded index (pi, pj, pk), each in
// [0, n + 2), is x[(pi − lo)·sx + (pj − lo)·sy + pk − lo] when every index
// lies in [lo, n + 2 − lo), and 0 otherwise.
//
// The stage (the kernel's STAGE argument, ring_stage's static rule, which
// depends on the dtype and, in f32, on the tail; the C entry point
// stencil_ring_stage reports it):
// * kStageAsync, f64, and f32 but for the tails of f32_pair_tail: the
//   element copies above.
// * kStagePairPadded / kStagePairUnpadded, bf16 (2-byte elements, which
//   cp.async cannot copy one by one), and f32 with ChebTail or JacobiTail
//   (f32_pair_tail), when nz is even and x aligned to a pair (4 bytes in
//   bf16, 8 in f32): cp.async copies of element pairs (4 or 8 bytes),
//   kRingDepth − 2 planes ahead as above.  The tile's z origin is the even
//   operand index k0 − 2·lo (padded pk = k0, or unpadded k0 − 2), so every
//   pair is aligned, and since a row of either form holds an even number of
//   elements (nz + 2 or nz) a pair lies wholly inside the operand or wholly
//   outside it, where its copy writes zeros; a tile row is kRingZ + 2
//   (padded) or kRingZ + 4 elements.  Each thread owns kRingPairLanes = 2
//   neighbouring z-outputs (k, k + 1), kRingZ / 2 threads along z, and keeps
//   its neighbourhood as nine pairs (left, centre, right: the pairs at pk =
//   k, k + 1, k + 2), each lane one output's value; a row of them is the
//   four elements pk = k … k + 3, read as two aligned words (padded) or
//   three (unpadded, whose row starts at an odd column), a pair at an odd
//   column built from the two words around it (bf16: one byte permute; f32:
//   the halves of two float2).
//   bf16's arithmetic is packed: ring_first and ring_last run on the pairs
//   with add.rn/mul.rn.bf16x2, each lane rounded once and never contracted,
//   so each lane's bits are the scalar order's; kRingPairPacked = 0
//   computes the lanes one at a time instead (scalar mul.rn/add.rn.bf16, no
//   fma: the yardstick chip_stencil_variants.py times).  sm_90 has no packed
//   f32 add or FMA, so f32's pairs are two scalar chains in the same order
//   (float2's mul_rn/add_rn), four independent chains a thread.  When off
//   is ±1 (both HPCG stencils) a neighbour term is one fma (UNIT:
//   fma.rn.bf16x2, or fmaf on each f32 lane): off·x is exact, so the fma's
//   one rounding is the add's.  The tail takes each lane in turn (k, then
//   k + 1), or a tail with a pair form both at once (kRingPairTail; its
//   streams as pairs, which needs each aligned to a pair: else the launch
//   takes T's element stage, ring_tail_stage).  The step keeps its own work
//   to the copies, the shared reads, the permutes, the sums and the tail
//   (sources and indices advance by a plane, and two steps alternate the
//   neighbourhood registers).
// * kStageRegister, bf16 otherwise (odd nz, or x at an odd element offset):
//   each step loads the new plane's elements into registers before its
//   arithmetic and stores them into the slot after it (a load outside the
//   operand gives 0), so one plane is in flight; one output a thread.
// An f32 launch whose tail takes the pair stage but whose operands do not
// allow it (odd nz, x or a stream at an odd element offset) is left to its
// launcher: precond.cu keeps it on stencil_kernel.
constexpr int kRingZ = 64;
constexpr int kRingY = 4;
constexpr int kRingRun = 16;
// The runs a launch of the ring pass may pick for the tails of stencil_spmv,
// stencil_spmv_dots and stencil_spmv_dots3 (one instance each).  The run sets
// the block count, and so the order in which the partials are summed: each
// run's scalars are bitwise reproducible, two runs' agree to rounding.
using RingRuns = std::integer_sequence<int, 8, 16, 32>;
// RbGsTail's run (rb_gs.cu): 8 planes, faster for it than 16 at both 128³
// and 128×128×3072 (chip_stencil_variants.py, gs_run16), and in bf16 than
// 4 and 16 at both (gs_run4, gs_run16)
constexpr int kRingRunRbGs = 8;
// JacobiTail's run (precond.cu, bf16): 8 planes, faster for it than 16 at
// 128³, at 8 lanes of it and at 128×128×3072 (chip_stencil_variants.py,
// jacobi_run16); in f64 too, but 16 is 4 % faster on the 7pt stencil at one
// lane of 128³ (--f64: jacobi_run16, jacobi_run32)
constexpr int kRingRunJacobi = 8;
// ChebTail's run (precond.cu, bf16): 8 planes, faster for it than 4 and 16
// at 128³, at 8 lanes of it and at 128×128×3072 (chip_stencil_variants.py,
// cheb_run4, cheb_run16); in f64, 16 is 2–4 % faster at one lane of 128³
// and 2–4 % slower at 4 and 8 lanes, 32 slower (--f64: cheb_run16,
// cheb_run32), so f64 keeps 8
constexpr int kRingRunCheb = 8;
// BicgDotsTail's run (bicgstab_fused.cu, bf16): 8 planes, faster for it than
// 4 and 16 at 128³ (16 is 2 % faster at 128×128×3072; bicg_run4, bicg_run16)
constexpr int kRingRunBicgDots = 8;
// BicgUpdateTail's run (bicgstab_fused.cu, bf16): 8 planes, faster for it
// than 16 at 128³ and within 1 % of 4 (4 is 3 % faster at 128×128×3072;
// bicg_update_run4, bicg_update_run16)
constexpr int kRingRunBicgUpdate = 8;
constexpr int kRingDepth = 8;
constexpr int kRingThreads = kRingZ * kRingY;
constexpr int kRingTileZ = kRingZ + 2;
constexpr int kRingTile = (kRingY + 2) * kRingTileZ;
// the plane-tile elements each thread copies (the last round partly)
constexpr int kRingCopies = (kRingTile + kRingThreads - 1) / kRingThreads;
static_assert(kRingDepth >= 3, "a step refills plane s's slot while it reads plane s + 2");

// The stages (STAGE) of the ring pass, as stencil_ring_stage reports them.
constexpr int kStageAsync = 0;
constexpr int kStageRegister = 1;
constexpr int kStagePairPadded = 2;
constexpr int kStagePairUnpadded = 3;
// The pair stage: kRingPairLanes z-outputs a thread, whose bf16 sums run in
// bf16x2 when kRingPairPacked is 1; a tile row of kRingPairRowWords words of
// an element pair each (kRingZ + 4 values, the unpadded form's; the padded
// form copies one word less): 32-bit words in bf16, float2 in f32.
constexpr int kRingPairLanes = 2;
constexpr int kRingPairPacked = 1;
// kRingPairTail = 1: a tail with a pair form (pair_tail) takes a thread's two
// outputs in one call, its streams as pairs; 0 calls it once an output
// instead (the yardstick chip_stencil_variants.py times, pair_tail_off:
// 17–25 % slower at 128³ in bf16)
constexpr int kRingPairTail = 1;
constexpr int kRingPairZ = kRingZ / kRingPairLanes;
constexpr int kRingPairThreads = kRingPairZ * kRingY;
constexpr int kRingPairRowWords = kRingPairZ + 2;
constexpr int kRingPairTile = (kRingY + 2) * kRingPairRowWords;
static_assert(kRingZ % kRingPairLanes == 0 && kRingPairThreads % 32 == 0,
              "the pair stage's block is whole warps of thread pairs");
// byte_perm's selector for the pair that starts at the odd column between
// two words: the high half of the first, the low half of the second
constexpr unsigned kPairOdd = 0x5432u;

__host__ __device__ constexpr bool pair_stage(int stage) {
  return stage == kStagePairPadded || stage == kStagePairUnpadded;
}

// The threads a block of the ring pass has at a stage.
__host__ __device__ constexpr int ring_threads(int stage) {
  return pair_stage(stage) ? kRingPairThreads : kRingThreads;
}

// Whether a launch of the ring pass with Tail in T may take a pair stage:
// bf16 always, f32 with the tails of f32_pair_tail, f64 never.
template <typename T, typename Tail>
__host__ __device__ constexpr bool ring_pairs() {
  return std::is_same<T, __nv_bfloat16>::value ||
         (std::is_same<T, float>::value && f32_pair_tail<Tail>::value);
}

// The stage a launch of the ring pass with Tail in T takes on x (a static
// rule): T copies pairs (ring_pairs) when nz is even and x is aligned to a
// pair (every pair of either form then aligned and wholly inside or outside
// the operand, the lanes of a batch too), else bf16 stages through
// registers and f32 copies elements; f64, and f32's other tails, copy
// elements.
template <typename T, typename Tail>
inline int ring_stage(int nz, int zero_halo, const void* x) {
  if (!ring_pairs<T, Tail>()) return kStageAsync;
  const bool pairs = nz % 2 == 0 && reinterpret_cast<uintptr_t>(x) % (2 * sizeof(T)) == 0;
  if (!pairs) return sizeof(T) == 2 ? kStageRegister : kStageAsync;
  return zero_halo ? kStagePairUnpadded : kStagePairPadded;
}

// The stages ring_stage may pick for Tail in T (one kernel instance each):
// f32's pair tails only the pair stage's two forms (precond.cu launches
// them on the ring at no other).
template <typename T, typename Tail>
using ring_stages = std::conditional_t<
    !ring_pairs<T, Tail>(), std::integer_sequence<int, kStageAsync>,
    std::conditional_t<(sizeof(T) == 2),
                       std::integer_sequence<int, kStageRegister, kStagePairPadded,
                                             kStagePairUnpadded>,
                       std::integer_sequence<int, kStagePairPadded, kStagePairUnpadded>>>;

// The run of x-planes a block of the ring pass marches with a tail by
// default (kRingRun, or the tail's own), and the runs a launch may pick
// (RingRuns, or the tail's own alone).
template <typename Tail>
struct ring_run : std::integral_constant<int, kRingRun> {
  using choices = RingRuns;
};
template <typename T>
struct ring_run<RbGsTail<T>> : std::integral_constant<int, kRingRunRbGs> {
  using choices = std::integer_sequence<int, kRingRunRbGs>;
};
template <typename T>
struct ring_run<JacobiTail<T>> : std::integral_constant<int, kRingRunJacobi> {
  using choices = std::integer_sequence<int, kRingRunJacobi>;
};
template <typename T>
struct ring_run<ChebTail<T>> : std::integral_constant<int, kRingRunCheb> {
  using choices = std::integer_sequence<int, kRingRunCheb>;
};

template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(gmem),
               "n"(BYTES), "r"(valid ? BYTES : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The grid of the ring pass over ``lanes`` stacked operands, runs of ``run``
// x-planes (blockIdx.z = lane × runs + run); its block count is the number
// of partial slots per dot product.  Every stage covers the same tile.
inline dim3 stencil_ring_grid(int nx, int ny, int nz, int lanes, int run) {
  return dim3((nz + kRingZ - 1) / kRingZ, (ny + kRingY - 1) / kRingY,
              (unsigned)lanes * ((nx + run - 1) / run));
}

inline bool stencil_ring_grid_ok(int nx, int ny, int nz, int lanes, int run) {
  if (nx <= 0 || ny <= 0 || nz <= 0 || lanes <= 0) return false;
  const long long gz = (long long)lanes * ((nx + run - 1) / run);
  return (ny + kRingY - 1) / kRingY <= 65535 && gz <= 65535;
}

// The block count of the ring pass in runs of ``run`` planes (one lane):
// the partial slots per dot product; -1 when ``run`` is not in RingRuns.
inline long long stencil_ring_num_blocks(int nx, int ny, int nz, int run) {
  if (!one_of(RingRuns{}, run)) return -1;
  const dim3 g = stencil_ring_grid(nx, ny, nz, 1, run);
  return (long long)g.x * g.y * g.z;
}

// The block count of the ring pass with a tail that marches a run of its own
// (ring_run<Tail>, one lane): the partial slots per dot product of its launch.
template <typename Tail>
inline long long ring_tail_num_blocks(int nx, int ny, int nz) {
  const dim3 g = stencil_ring_grid(nx, ny, nz, 1, ring_run<Tail>::value);
  return (long long)g.x * g.y * g.z;
}

// Whether the 3 × 3 neighbourhood's element q = 3·(dy + 1) + (dz + 1) of a
// plane is read in NPT: all nine in 27pt, the cross in 7pt.
template <int NPT>
__device__ __forceinline__ constexpr bool ring_reads(int q) {
  return NPT == 27 || q == 1 || q == 3 || q == 4 || q == 5 || q == 7;
}

// One bf16 value whose mul_rn/add_rn are single scalar mul.rn/add.rn.bf16
// instructions the compiler cannot pack into bf16x2 ones: the pair stage's
// scalar yardstick (kRingPairPacked = 0), the same bits as the pairs'.
struct Bf16Lane {
  __nv_bfloat16 v;
  Bf16Lane() = default;
  __device__ explicit Bf16Lane(float f) : v(__float2bfloat16_rn(f)) {}
  __device__ Bf16Lane(__nv_bfloat16 b) : v(b) {}
};
__device__ __forceinline__ Bf16Lane mul_rn(Bf16Lane a, Bf16Lane b) {
  unsigned short r;
  asm("mul.rn.bf16 %0, %1, %2;"
      : "=h"(r)
      : "h"(__bfloat16_as_ushort(a.v)), "h"(__bfloat16_as_ushort(b.v)));
  return Bf16Lane(__ushort_as_bfloat16(r));
}
__device__ __forceinline__ Bf16Lane add_rn(Bf16Lane a, Bf16Lane b) {
  unsigned short r;
  asm("add.rn.bf16 %0, %1, %2;"
      : "=h"(r)
      : "h"(__bfloat16_as_ushort(a.v)), "h"(__bfloat16_as_ushort(b.v)));
  return Bf16Lane(__ushort_as_bfloat16(r));
}

// +0 in T (both lanes of a pair)
template <typename T>
__device__ __forceinline__ T zero_of() {
  return T(0.0f);
}
template <>
__device__ __forceinline__ __nv_bfloat162 zero_of<__nv_bfloat162>() {
  return __float2bfloat162_rn(0.0f);
}
template <>
__device__ __forceinline__ float2 zero_of<float2>() {
  return make_float2(0.0f, 0.0f);
}

// round(a·b + c) once: fma.rn.bf16x2 on a bf16 pair, fmaf on each lane of
// an f32 pair
__device__ __forceinline__ __nv_bfloat162 fma_rn(__nv_bfloat162 a, __nv_bfloat162 b,
                                                 __nv_bfloat162 c) {
  return __hfma2(a, b, c);
}
__device__ __forceinline__ float2 fma_rn(float2 a, float2 b, float2 c) {
  return make_float2(__fmaf_rn(a.x, b.x, c.x), __fmaf_rn(a.y, b.y, c.y));
}

// One neighbour term of a stencil sum, acc + off·x, as add_rn(acc,
// mul_rn(off, x)).  With UNIT (a bf16 or f32 pair whose off is ±1, so off·x
// is exact) it is one fma a lane: round(off·x + acc) is then
// round(acc + mul_rn(off, x)), the same bits, signed zeros included.
template <typename T, bool UNIT>
__device__ __forceinline__ T ring_term(T acc, T off, T x) {
  if constexpr (UNIT)
    return fma_rn(off, x, acc);
  else
    return add_rn(acc, mul_rn(off, x));
}

// apply_point's sum for one output, split in two at a plane boundary so
// that each half needs only the two newest planes: ring_first starts it
// when its centre plane c arrives (b is the plane before), ring_last ends
// it when the plane after arrives (a); the operations and their order are
// apply_point's.  27pt: diag·c[4], then b's nine, c's eight, a's nine.
// 7pt: diag·c[4], b[4]; then a[4], c[1], c[7], c[3], c[5] (c is then the
// plane before a).  With OFFDIAG the sum starts from 0 in place of
// diag·c[4] (0 + (−0.0) is +0.0, as in the plain version's sum from zeros),
// and the rest is the same.  T is a scalar, or a bf16 or f32 pair (two
// outputs, each lane its own chain; UNIT: ring_term's fma).
template <typename T, int NPT, bool OFFDIAG = false, bool UNIT = false>
__device__ __forceinline__ T ring_first(const T (&b)[9], const T (&c)[9], T diag, T off) {
  T acc = OFFDIAG ? zero_of<T>() : mul_rn(diag, c[4]);
  if constexpr (NPT == 7) {
    acc = ring_term<T, UNIT>(acc, off, b[4]);
  } else {
    static_assert(NPT == 27, "the stencils are 7pt and 27pt");
#pragma unroll
    for (int q = 0; q < 9; ++q) acc = ring_term<T, UNIT>(acc, off, b[q]);
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      if (q != 4) acc = ring_term<T, UNIT>(acc, off, c[q]);
    }
  }
  return acc;
}

template <typename T, int NPT, bool UNIT = false>
__device__ __forceinline__ T ring_last(T acc, const T (&c)[9], const T (&a)[9], T off) {
  if constexpr (NPT == 7) {
    acc = ring_term<T, UNIT>(acc, off, a[4]);
    acc = ring_term<T, UNIT>(acc, off, c[1]);
    acc = ring_term<T, UNIT>(acc, off, c[7]);
    acc = ring_term<T, UNIT>(acc, off, c[3]);
    acc = ring_term<T, UNIT>(acc, off, c[5]);
  } else {
#pragma unroll
    for (int q = 0; q < 9; ++q) acc = ring_term<T, UNIT>(acc, off, a[q]);
  }
  return acc;
}

// One lane of a neighbourhood of bf16 pairs.
__device__ __forceinline__ void pair_lane(const __nv_bfloat162 (&p)[9], int lane,
                                          Bf16Lane (&dst)[9]) {
#pragma unroll
  for (int q = 0; q < 9; ++q) dst[q] = Bf16Lane(lane ? p[q].y : p[q].x);
}

// ring_first and ring_last on the pair stage: packed (kRingPairPacked),
// or one lane at a time in scalar bf16 with no fma (the yardstick); the
// same bits.
template <int NPT, bool OFFDIAG, bool UNIT>
__device__ __forceinline__ __nv_bfloat162 pair_first(const __nv_bfloat162 (&b)[9],
                                                     const __nv_bfloat162 (&c)[9],
                                                     __nv_bfloat162 diag, __nv_bfloat162 off) {
  if constexpr (kRingPairPacked) {
    return ring_first<__nv_bfloat162, NPT, OFFDIAG, UNIT>(b, c, diag, off);
  } else {
    Bf16Lane bl[9], cl[9], out[2];
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      pair_lane(b, l, bl);
      pair_lane(c, l, cl);
      out[l] = ring_first<Bf16Lane, NPT, OFFDIAG>(bl, cl, Bf16Lane(diag.x), Bf16Lane(off.x));
    }
    return __halves2bfloat162(out[0].v, out[1].v);
  }
}

template <int NPT, bool UNIT>
__device__ __forceinline__ __nv_bfloat162 pair_last(__nv_bfloat162 acc,
                                                    const __nv_bfloat162 (&c)[9],
                                                    const __nv_bfloat162 (&a)[9],
                                                    __nv_bfloat162 off) {
  if constexpr (kRingPairPacked) {
    return ring_last<__nv_bfloat162, NPT, UNIT>(acc, c, a, off);
  } else {
    Bf16Lane cl[9], al[9], out[2];
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      pair_lane(c, l, cl);
      pair_lane(a, l, al);
      out[l] = ring_last<Bf16Lane, NPT>(Bf16Lane(l ? acc.y : acc.x), cl, al, Bf16Lane(off.x));
    }
    return __halves2bfloat162(out[0].v, out[1].v);
  }
}

// f32's pair stage: each lane its own scalar chain (float2's operations), in
// ring_first's and ring_last's order.
template <int NPT, bool OFFDIAG, bool UNIT>
__device__ __forceinline__ float2 pair_first(const float2 (&b)[9], const float2 (&c)[9],
                                             float2 diag, float2 off) {
  return ring_first<float2, NPT, OFFDIAG, UNIT>(b, c, diag, off);
}

template <int NPT, bool UNIT>
__device__ __forceinline__ float2 pair_last(float2 acc, const float2 (&c)[9],
                                            const float2 (&a)[9], float2 off) {
  return ring_last<float2, NPT, UNIT>(acc, c, a, off);
}

__device__ __forceinline__ __nv_bfloat162 as_pair(uint32_t w) {
  __nv_bfloat162 p;
  memcpy(&p, &w, sizeof(p));
  return p;
}

// A thread's pairs at pk = k, k + 1, k + 2 of one tile row (its outputs
// (k, k + 1)) from the row's words at its column: padded (LO = 0) w[0] and
// w[1] hold pk = k … k + 3 and the centre pair straddles them; unpadded the
// row starts at an odd column, w[0] … w[2] hold pk = k − 1 … k + 4 and the
// left and right pairs straddle two words.  bf16 builds a straddling pair
// with one byte permute, f32 from the halves of two float2.
template <int LO>
__device__ __forceinline__ void row_pairs(const uint32_t* w, __nv_bfloat162 (&pair)[3]) {
  if constexpr (LO == 0) {
    const uint32_t w0 = w[0], w1 = w[1];
    pair[0] = as_pair(w0);
    pair[1] = as_pair(__byte_perm(w0, w1, kPairOdd));
    pair[2] = as_pair(w1);
  } else {
    const uint32_t w0 = w[0], w1 = w[1], w2 = w[2];
    pair[0] = as_pair(__byte_perm(w0, w1, kPairOdd));
    pair[1] = as_pair(w1);
    pair[2] = as_pair(__byte_perm(w1, w2, kPairOdd));
  }
}
template <int LO>
__device__ __forceinline__ void row_pairs(const float2* w, float2 (&pair)[3]) {
  if constexpr (LO == 0) {
    const float2 w0 = w[0], w1 = w[1];
    pair[0] = w0;
    pair[1] = make_float2(w0.y, w1.x);
    pair[2] = w1;
  } else {
    const float2 w0 = w[0], w1 = w[1], w2 = w[2];
    pair[0] = make_float2(w0.y, w1.x);
    pair[1] = w1;
    pair[2] = make_float2(w1.y, w2.x);
  }
}

// The element stages (kStageAsync: cp.async of each element; the register
// stage) in runs of RUN x-planes, one output a thread: y = A x at every
// point (the off-diagonal sum and the parity of i + j + k for a tail that
// declares kOffDiag), handed to the tail; the tail's Tail::kDots partials
// are stored at partials[d * nblocks + block].
template <typename T, int NPT, typename Tail, bool ASYNC, int RUN>
__device__ __forceinline__ void ring_element_pass(const T* __restrict__ x, int lo, Tail tail,
                                                  acc_t<T>* __restrict__ partials, int nx,
                                                  int ny, int nz, T diag, T off) {
  constexpr int NDOT = Tail::kDots;
  constexpr bool OFFDIAG = off_diag_tail<Tail>::value;
  __shared__ T ring[kRingDepth][kRingTile];
  const int tz = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kRingZ + tz;
  const int k0 = blockIdx.x * kRingZ, j0 = blockIdx.y * kRingY;
  const int runs = (nx + RUN - 1) / RUN;
  const int lane = blockIdx.z / runs;
  const int i0 = (blockIdx.z - lane * runs) * RUN;
  const int nrun = min(RUN, nx - i0);
  const int64_t sy = nz + 2 - 2 * lo;
  const int64_t sx = (int64_t)(ny + 2 - 2 * lo) * sy;
  x += (int64_t)lane * (nx + 2 - 2 * lo) * sx;
  const int j = j0 + ty, k = k0 + tz;
  const bool active = j < ny && k < nz;
  // the flat unpadded index of output s of the run in the stack of lanes
  auto point = [&](int s) { return (((int64_t)lane * nx + i0 + s) * ny + j) * nz + k; };

  // this thread's copies: tile element c = tid + r·kRingThreads, at padded
  // (pj, pk) = (j0 + c / kRingTileZ, k0 + c % kRingTileZ); its offset within
  // an x-plane of the operand, and whether (pj, pk) lies in it
  int64_t coff[kRingCopies];
  bool cok[kRingCopies];
#pragma unroll
  for (int r = 0; r < kRingCopies; ++r) {
    const int c = tid + r * kRingThreads;
    const int pj = j0 + c / kRingTileZ, pk = k0 + c % kRingTileZ;
    cok[r] = c < kRingTile && pj >= lo && pj < ny + 2 - lo && pk >= lo && pk < nz + 2 - lo;
    coff[r] = cok[r] ? (int64_t)(pj - lo) * sy + (pk - lo) : 0;
  }
  // copy padded plane i0 + q into slot q % kRingDepth (a copy outside the
  // operand writes 0), then commit one group, empty past the run's planes
  auto copy_plane = [&](int q) {
    if (q < nrun + 2) {
      const int pi = i0 + q;
      const bool iok = pi >= lo && pi < nx + 2 - lo;
      const T* plane = x + (iok ? (int64_t)(pi - lo) * sx : 0);
      T* slot = ring[q % kRingDepth];
#pragma unroll
      for (int r = 0; r < kRingCopies; ++r) {
        const int c = tid + r * kRingThreads;
        if (c < kRingTile) cp_async_zfill<ASYNC ? (int)sizeof(T) : 4>(
            slot + c, plane + coff[r], iok && cok[r]);
      }
    }
    cp_async_commit();
  };
  // the register stage: load this thread's elements of padded plane i0 + q
  // (0 outside the operand), and store them into slot q % kRingDepth;
  // neither does anything past the run's planes
  auto load_plane = [&](int q, T (&dst)[kRingCopies]) {
    if (q < nrun + 2) {
      const int pi = i0 + q;
      const bool iok = pi >= lo && pi < nx + 2 - lo;
      const T* plane = x + (iok ? (int64_t)(pi - lo) * sx : 0);
#pragma unroll
      for (int r = 0; r < kRingCopies; ++r) dst[r] = iok && cok[r] ? plane[coff[r]] : T(0.0f);
    }
  };
  auto store_plane = [&](int q, const T (&src)[kRingCopies]) {
    if (q < nrun + 2) {
      T* slot = ring[q % kRingDepth];
#pragma unroll
      for (int r = 0; r < kRingCopies; ++r) {
        const int c = tid + r * kRingThreads;
        if (c < kRingTile) slot[c] = src[r];
      }
    }
  };
  // this thread's 3 × 3 neighbourhood of padded plane q
  auto read_plane = [&](int q, T (&dst)[9]) {
    const T* slot = ring[q % kRingDepth] + ty * kRingTileZ + tz;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        if (ring_reads<NPT>(3 * a + b)) dst[3 * a + b] = slot[a * kRingTileZ + b];
      }
    }
  };

  if constexpr (ASYNC) {
#pragma unroll
    for (int q = 0; q < kRingDepth; ++q) copy_plane(q);
  } else {
    T stage[kRingDepth][kRingCopies];
#pragma unroll
    for (int q = 0; q < kRingDepth; ++q) load_plane(q, stage[q]);
#pragma unroll
    for (int q = 0; q < kRingDepth; ++q) store_plane(q, stage[q]);
  }
  if constexpr (prefetch_tail<Tail>::value) {
    if (active) tail.prefetch(point(0));
  }
  if constexpr (ASYNC) cp_async_wait<kRingDepth - 2>();      // planes 0 and 1 have landed
  __syncthreads();
  T prev[9], cur[9];
  read_plane(0, prev);
  read_plane(1, cur);
  T part = ring_first<T, NPT, OFFDIAG>(prev, cur, diag, off);   // output 0's first half
#pragma unroll
  for (int q = 0; q < 9; ++q) prev[q] = cur[q];

  acc_t<T> v[NDOT > 0 ? NDOT : 1];
#pragma unroll
  for (int d = 0; d < (NDOT > 0 ? NDOT : 1); ++d) v[d] = acc_t<T>(0);
  for (int s = 0; s < nrun; ++s) {
    // plane s + 2 has landed for every thread, and every thread is done
    // reading plane s (at step s − 2, or before the loop), whose slot the
    // next copy takes (the register stage's store, at the end of this step)
    if constexpr (ASYNC) cp_async_wait<kRingDepth - 3>();
    __syncthreads();
    T stage[kRingCopies];
    if constexpr (ASYNC)
      copy_plane(s + kRingDepth);
    else
      load_plane(s + kRingDepth, stage);
    if constexpr (prefetch_tail<Tail>::value) {
      if (active && s + 1 < nrun) tail.prefetch(point(s + 1));
    }
    read_plane(s + 2, cur);
    // output s ends on plane s + 2; output s + 1 starts on it (prev is
    // plane s + 1, output s's centre plane)
    const T yv = ring_last<T, NPT>(part, prev, cur, off);
    if (active) {
      if constexpr (OFFDIAG)
        tail(point(s), prev[4], yv, v, (i0 + s + j + k) & 1);
      else
        tail(point(s), prev[4], yv, v);
    }
    if (s + 1 < nrun) part = ring_first<T, NPT, OFFDIAG>(prev, cur, diag, off);
#pragma unroll
    for (int q = 0; q < 9; ++q) prev[q] = cur[q];
    if constexpr (!ASYNC) store_plane(s + kRingDepth, stage);
  }
  if constexpr (NDOT > 0) {
    // every thread of the block takes part, in range or not
    block_sum<acc_t<T>, NDOT, kRingThreads>(v, tid);
    if (tid == 0) {
      const int64_t nb = (int64_t)gridDim.x * gridDim.y * gridDim.z;
      const int64_t b = ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
#pragma unroll
      for (int d = 0; d < NDOT; ++d) partials[d * nb + b] = v[d];
    }
  }
}

// The pair stage (bf16, or f32 with a tail of f32_pair_tail; nz even, x
// aligned to a pair; LO = 1 the unpadded form) in runs of RUN x-planes: as
// ring_element_pass, with the plane tiles copied as element pairs (4 bytes
// in bf16, 8 in f32) kRingDepth − 2 planes ahead and two z-outputs (k,
// k + 1) a thread summed as pairs (UNIT: off is ±1, ring_term's fma).  A
// thread's partials add its outputs in the order (s, k), (s, k + 1),
// (s + 1, k), ...  Each copy's source advances by a plane and each output's
// flat index by ny·nz a step, and two steps alternate the neighbourhood
// registers, so the step's own work is its copies, the shared reads (and
// bf16's byte permutes), the sums and the tail.
template <typename T, int NPT, typename Tail, int LO, bool UNIT, int RUN>
__device__ __forceinline__ void ring_pair_pass(const T* __restrict__ x, Tail tail,
                                               acc_t<T>* __restrict__ partials, int nx, int ny,
                                               int nz, T diag, T off) {
  using P = pair_t<T>;
  // a tile word: one element pair, a 32-bit word in bf16 (row_pairs permutes
  // its bytes), a float2 in f32
  using W = std::conditional_t<std::is_same<T, float>::value, float2, uint32_t>;
  static_assert(sizeof(W) == 2 * sizeof(T), "a tile word is one element pair");
  constexpr int NDOT = Tail::kDots;
  constexpr bool OFFDIAG = off_diag_tail<Tail>::value;
  // the words a tile row copies (kRingZ + 2 or + 4 elements), and the tile's
  constexpr int kRow = kRingPairZ + 1 + LO;
  constexpr int kWords = (kRingY + 2) * kRow;
  constexpr int kCopies = (kWords + kRingPairThreads - 1) / kRingPairThreads;
  constexpr unsigned kSlotBytes = kRingPairTile * sizeof(W);
  __shared__ W ring[kRingDepth][kRingPairTile];
  const int tz = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kRingPairZ + tz;
  const int k0 = blockIdx.x * kRingZ, j0 = blockIdx.y * kRingY;
  const int runs = (nx + RUN - 1) / RUN;
  const int lane = blockIdx.z / runs;
  const int i0 = (blockIdx.z - lane * runs) * RUN;
  const int nrun = min(RUN, nx - i0);
  const int64_t sy = nz + 2 - 2 * LO;
  const int64_t sx = (int64_t)(ny + 2 - 2 * LO) * sy;
  x += (int64_t)lane * (nx + 2 - 2 * LO) * sx;
  // this thread's outputs (j, k) and (j, k + 1); nz is even, so both are in
  // range or neither
  const int j = j0 + ty, k = k0 + kRingPairLanes * tz;
  const bool active = j < ny && k < nz;
  // the flat unpadded index of output (i0, j, k) in the stack of lanes; a
  // step adds ny·nz
  int64_t e = (((int64_t)lane * nx + i0) * ny + j) * nz + k;
  const int64_t plane_out = (int64_t)ny * nz;

  // this thread's copies: tile word c = tid + r·kRingPairThreads, row
  // c / kRow (operand row j0 + row − LO), the pair at operand z
  // k0 − 2·LO + 2·(c % kRow): whether the copy exists (c within the tile),
  // whether its pair lies in the operand's x-plane, its byte in the slot,
  // and its source in the next plane to copy (first operand plane i0 − LO,
  // advanced by a plane at each copy; a copy outside the operand has
  // src-size 0 and reads nothing)
  bool cok[kCopies], chas[kCopies];
  unsigned cdst[kCopies];
  const T* src[kCopies];
#pragma unroll
  for (int r = 0; r < kCopies; ++r) {
    const int c = tid + r * kRingPairThreads;
    const int row = c / kRow, wc = c - row * kRow;
    const int oy = j0 + row - LO, oz = k0 - 2 * LO + 2 * wc;
    chas[r] = c < kWords;
    cok[r] = chas[r] && oy >= 0 && oy < ny + 2 - 2 * LO && oz >= 0 && oz < nz + 2 - 2 * LO;
    src[r] = x + (int64_t)(i0 - LO) * sx + (cok[r] ? (int64_t)oy * sy + oz : 0);
    cdst[r] = (unsigned)(row * kRingPairRowWords + wc) * (unsigned)sizeof(W);
  }
  const unsigned ring0 = static_cast<unsigned>(__cvta_generic_to_shared(&ring[0][0]));
  // copy padded plane i0 + q, q the count of earlier calls, into slot
  // q % kRingDepth (a copy outside the operand writes 0), then commit one
  // group, empty past the run's planes
  int next = 0;
  auto copy_plane = [&]() {
    const int q = next++;
    if (q < nrun + 2) {
      const int pi = i0 + q;
      const bool iok = pi >= LO && pi < nx + 2 - LO;
      const unsigned slot = ring0 + (unsigned)(q % kRingDepth) * kSlotBytes;
#pragma unroll
      for (int r = 0; r < kCopies; ++r) {
        if (chas[r]) {
          asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(slot + cdst[r]),
                       "l"(src[r]), "n"((int)sizeof(W)), "r"(iok && cok[r] ? (int)sizeof(W) : 0)
                       : "memory");
        }
        src[r] += sx;
      }
    }
    cp_async_commit();
  };
  // this thread's 3 × 3 neighbourhood of padded plane q as pairs: at each
  // row the pairs at pk = k, k + 1, k + 2 (row_pairs), from tile word tz on
  const W* mine = &ring[0][0] + ty * kRingPairRowWords + tz;
  auto read_plane = [&](int q, P (&dst)[9]) {
    const W* slot = mine + (q % kRingDepth) * kRingPairTile;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      P pair[3];
      row_pairs<LO>(slot + a * kRingPairRowWords, pair);
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        if (ring_reads<NPT>(3 * a + b)) dst[3 * a + b] = pair[b];
      }
    }
  };

  const P diag2 = splat(diag), off2 = splat(off);
  acc_t<T> v[NDOT > 0 ? NDOT : 1];
#pragma unroll
  for (int d = 0; d < (NDOT > 0 ? NDOT : 1); ++d) v[d] = acc_t<T>(0);
  P part;
  // step s: prev holds plane s + 1 (output s's centre plane); cur gets
  // plane s + 2, on which output s ends and output s + 1 starts
  auto step = [&](int s, const P (&prev)[9], P (&cur)[9]) {
    // plane s + 2 has landed for every thread, and every thread is done
    // reading plane s (at step s − 2, or before the loop), whose slot the
    // next copy takes
    cp_async_wait<kRingDepth - 3>();
    __syncthreads();
    copy_plane();                         // plane s + kRingDepth
    if constexpr (prefetch_tail<Tail>::value) {
      if (active && s + 1 < nrun) tail.prefetch(e + plane_out);
    }
    read_plane(s + 2, cur);
    const P yv = pair_last<NPT, UNIT>(part, prev, cur, off2);
    if (active) {
      if constexpr (OFFDIAG) {
        const int parity = (i0 + s + j + k) & 1;
        if constexpr (kRingPairTail && pair_tail<Tail>::value) {
          tail.pair(e, prev[4], yv, v, parity);
        } else {
          tail(e, prev[4].x, yv.x, v, parity);
          tail(e + 1, prev[4].y, yv.y, v, parity ^ 1);
        }
      } else if constexpr (kRingPairTail && pair_tail<Tail>::value) {
        tail.pair(e, prev[4], yv, v);
      } else {
        tail(e, prev[4].x, yv.x, v);
        tail(e + 1, prev[4].y, yv.y, v);
      }
    }
    if (s + 1 < nrun) part = pair_first<NPT, OFFDIAG, UNIT>(prev, cur, diag2, off2);
    e += plane_out;
  };

#pragma unroll
  for (int q = 0; q < kRingDepth; ++q) copy_plane();
  if constexpr (prefetch_tail<Tail>::value) {
    if (active) tail.prefetch(e);
  }
  cp_async_wait<kRingDepth - 2>();      // planes 0 and 1 have landed
  __syncthreads();
  P nb0[9], nb1[9], nb2[9];
  read_plane(0, nb0);
  read_plane(1, nb1);
  part = pair_first<NPT, OFFDIAG, UNIT>(nb0, nb1, diag2, off2);   // output 0's first half
  // two steps a turn, the plane s + 1 array and the plane s + 2 array
  // trading places
  for (int s = 0; s < nrun; s += 2) {
    step(s, nb1, nb2);
    if (s + 1 < nrun) step(s + 1, nb2, nb1);
  }
  if constexpr (NDOT > 0) {
    // every thread of the block takes part, in range or not
    block_sum<acc_t<T>, NDOT, kRingPairThreads>(v, tid);
    if (tid == 0) {
      const int64_t nb = (int64_t)gridDim.x * gridDim.y * gridDim.z;
      const int64_t b = ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
#pragma unroll
      for (int d = 0; d < NDOT; ++d) partials[d * nb + b] = v[d];
    }
  }
}

// The ring pass at stage STAGE in runs of RUN x-planes (the pair stages in
// bf16, and in f32 for the tails of f32_pair_tail; UNIT, on a pair stage,
// when off is ±1).
template <typename T, int NPT, typename Tail, bool UNIT, int STAGE, int RUN>
__global__ void __launch_bounds__(ring_threads(STAGE))
stencil_ring_kernel(const T* __restrict__ x, int lo, Tail tail,
                    acc_t<T>* __restrict__ partials, int nx, int ny, int nz, T diag, T off) {
  if constexpr (pair_stage(STAGE)) {
    static_assert(ring_pairs<T, Tail>(), "the pair stage is bf16's and f32's pair tails'");
    ring_pair_pass<T, NPT, Tail, STAGE == kStagePairUnpadded ? 1 : 0, UNIT, RUN>(
        x, tail, partials, nx, ny, nz, diag, off);
  } else {
    static_assert(!UNIT, "the element stages multiply and add");
    ring_element_pass<T, NPT, Tail, STAGE == kStageAsync, RUN>(x, lo, tail, partials, nx, ny,
                                                               nz, diag, off);
  }
}

// The stage a launch of the ring pass with ``tail`` in T takes on x:
// ring_stage's, but a pair tail loads and stores its own streams as pairs,
// so one of them at an odd element offset sends the launch to T's element
// stage (bf16's register stage; f32's element copies, which precond.cu
// leaves to stencil_kernel).
template <typename T, typename Tail>
inline int ring_tail_stage(const Tail& tail, int nz, int zero_halo, const void* x) {
  const int stage = ring_stage<T, Tail>(nz, zero_halo, x);
  if constexpr (pair_tail<Tail>::value) {
    if (pair_stage(stage) && !tail.pairs_aligned())
      return sizeof(T) == 2 ? kStageRegister : kStageAsync;
  }
  return stage;
}

// Launch the ring pass on x (zero_halo = 0: padded (nx+2, ny+2, nz+2);
// 1: unpadded (nx, ny, nz), the halo made in the kernel; ``lanes`` of them
// stacked) with ``tail`` in runs of ``run`` planes (one of the tail's
// ring_run choices), at the stage ring_tail_stage picks (on a pair stage,
// ring_term's fma when off is ±1: off·x is then exact), and, when the tail
// has partials (one lane only), their fixed-order reduction into
// dots[0..Tail::kDots), both in acc_t<T>.  Another run, or a stage with no
// instance for the tail (ring_stages: an f32 pair tail's element stage),
// launches nothing and returns cudaErrorInvalidValue.  Returns
// cudaGetLastError().
template <typename T, typename Tail>
int launch_stencil_ring(const T* x, int zero_halo, Tail tail, acc_t<T>* partials,
                        acc_t<T>* dots, int nx, int ny, int nz, int npoint, double diag,
                        double off, cudaStream_t stream, int lanes = 1,
                        int run = ring_run<Tail>::value) {
  if (!one_of(typename ring_run<Tail>::choices{}, run) ||
      !stencil_ring_grid_ok(nx, ny, nz, lanes, run) || (npoint != 7 && npoint != 27) ||
      (zero_halo != 0 && zero_halo != 1) || (Tail::kDots > 0 && lanes != 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid = stencil_ring_grid(nx, ny, nz, lanes, run);
  const int stage = ring_tail_stage<T>(tail, nz, zero_halo, x);
  if (!one_of(ring_stages<T, Tail>{}, stage)) return (int)cudaErrorInvalidValue;
  const bool unit = off == 1.0 || off == -1.0;
  pick(typename ring_run<Tail>::choices{}, run, [&](auto r) {
    constexpr int RUN = decltype(r)::value;
    auto go = [&](auto st) {
      constexpr int STAGE = decltype(st)::value;
      const dim3 block(ring_threads(STAGE) / kRingY, kRingY);
      auto launch = [&](auto u) {
        constexpr bool UNIT = decltype(u)::value;
        if (npoint == 7)
          stencil_ring_kernel<T, 7, Tail, UNIT, STAGE, RUN><<<grid, block, 0, stream>>>(
              x, zero_halo, tail, partials, nx, ny, nz, (T)diag, (T)off);
        else
          stencil_ring_kernel<T, 27, Tail, UNIT, STAGE, RUN><<<grid, block, 0, stream>>>(
              x, zero_halo, tail, partials, nx, ny, nz, (T)diag, (T)off);
      };
      if constexpr (pair_stage(STAGE)) {
        if (unit)
          launch(std::true_type{});
        else
          launch(std::false_type{});
      } else {
        launch(std::false_type{});
      }
    };
    pick(ring_stages<T, Tail>{}, stage, go);
  });
  if constexpr (Tail::kDots > 0) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    reduce_partials<acc_t<T>, Tail::kDots><<<1, kReduceThreads, 0, stream>>>(
        partials, (int64_t)grid.x * grid.y * grid.z, dots);
  }
  return (int)cudaGetLastError();
}

}  // namespace repro
