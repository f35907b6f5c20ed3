// Kernels 13 and 14: single-reduction BiCGStab's two stencil passes, each
// one pass of stencil.cuh with its own tail:
//   bicgstab_fused_spmv_dots    v = A z̃,  q = r − α s,  y = w − α z  and the
//     nine partials (q·y, y·y, q·q, r̂·q, r̂·y, r̂·t, r̂·v, r̂·z, r̂·s)
//   bicgstab_fused_spmv_update  t' = A w̃,  p' = r + β(p − ω s),
//     s' = w + β(s − ω z),  z' = t' + β(z − ω v)
// z̃ and w̃ are the halo-padded stencil operands: M(z) and M(w) in the
// right-preconditioned form, z and w themselves otherwise.
//
// Replaces: src/repro/kernels/bicgstab_fused.py, functions
// bicgstab_fused_spmv_dots and bicgstab_fused_spmv_update (Pallas TPU kernels
// on the stencil_spmv z-slab window, the nine partials added into one
// revisited (1, 9) block, sound there only because TPU grid steps run in
// order).
//
// Bound on the H100: memory bytes.  The dots pass reads the padded z̃ and six
// unpadded vectors once and writes three (npad + 9n elements); the update
// pass reads the padded w̃ and six vectors and writes four (npad + 10n).  The
// 22 and 12 operations per point on top of the stencil are far below the
// card's arithmetic rate.
//
// Design: the stencil pass of stencil.cuh (threads along z, 8 x-planes per
// thread) with BicgDotsTail / BicgUpdateTail as the per-point epilogue; in
// bf16 both passes run on the plane-ring pass instead (static rules,
// bicgstab_dots_on_ring and bicgstab_update_on_ring) from the padded z̃ (w̃)
// in runs of kRingRunBicgDots (kRingRunBicgUpdate) planes, on bf16's pair
// stage where the operands allow it: z̃ is read once from global memory
// (4-byte cp.async of bf16 pairs) where the old pass issues 27 (7) 2-byte
// loads a point, and each tail's pair form takes a thread's two z-outputs
// in one call, its streams loaded and stored as bf16 pairs (the dots pass
// six in and three out, the update pass six in and four out; stencil.cuh's
// pair_tail; a stream at an odd element offset sends the launch to the
// register stage), the partials lane k before lane k + 1.  The dots pass's
// partial slots are the ring's block count then (bicgstab_partials_bf16).
// The stencil's centre value is z̃[e], which in the preconditioned form is
// not z[e]: the tails read every vector from its own unpadded stream and
// never use it.  α, ω and β are device scalars read by the kernel, so the host
// never waits for them.  Each product and sum is rounded on its own, in the
// plain version's order, so the vector outputs equal it bitwise.  The nine
// partials go to per-block slots summed by reduce_partials in a fixed order:
// no atomics, bitwise reproducible.  The first iteration passes one tensor
// in several slots (r = p = r̂, s = w, z = t): inputs are only read, and the
// outputs are always fresh buffers.
//
// bf16 (the _bf16 entry points): vectors and the device scalars α, ω and β
// in bf16 (the wrapper rounds them), each operation rounded to bf16 as the
// plain version's; the nine partials are f32 sums of f32 products (float
// slots and dots), as the reference's oracle computes them.  Bound: bytes at
// 2 B an element, 4 B a partial.  Both passes run on the ring (above).
#include "stencil.cuh"

// The tails live in a named namespace: the stencil kernel is a __global__
// template instantiated with them.
namespace repro {

// v = A z̃, q = r − α s, y = w − α z and the nine partials at point e (the
// centre value z̃[e] is not z[e] when preconditioned, so it is not used).
// On the ring pass, prefetch(e) asks for the six streams a step before the
// tail reads them; on its pair stage (bf16) pair(e, ...) takes the outputs
// (e, e + 1) at once, each stream loaded and stored as one bf16 pair, each
// lane rounded as the scalar form rounds it and its partials added lane e
// first.
template <typename T>
struct BicgDotsTail {
  static constexpr int kDots = 9;
  const T* __restrict__ alpha;
  const T* __restrict__ z;
  const T* __restrict__ r;
  const T* __restrict__ w;
  const T* __restrict__ s;
  const T* __restrict__ rhat;
  const T* __restrict__ t;
  T* __restrict__ v_out;
  T* __restrict__ q_out;
  T* __restrict__ y_out;
  __device__ __forceinline__ void prefetch(int64_t e) const {
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(z + e));
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(r + e));
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(w + e));
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(s + e));
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(rhat + e));
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(t + e));
  }
  __device__ __forceinline__ void operator()(int64_t e, T, T yv, acc_t<T>* acc) const {
    const T a = *alpha;
    const T ze = z[e];
    const T se = s[e];
    const acc_t<T> rh = to_acc(rhat[e]);
    const T q = sub_rn(r[e], mul_rn(a, se));
    const T y = sub_rn(w[e], mul_rn(a, ze));
    v_out[e] = yv;
    q_out[e] = q;
    y_out[e] = y;
    // the partials in acc_t<T>, from the operands widened
    const acc_t<T> qa = to_acc(q), ya = to_acc(y);
    acc[0] = add_rn(acc[0], mul_rn(qa, ya));
    acc[1] = add_rn(acc[1], mul_rn(ya, ya));
    acc[2] = add_rn(acc[2], mul_rn(qa, qa));
    acc[3] = add_rn(acc[3], mul_rn(rh, qa));
    acc[4] = add_rn(acc[4], mul_rn(rh, ya));
    acc[5] = add_rn(acc[5], mul_rn(rh, to_acc(t[e])));
    acc[6] = add_rn(acc[6], mul_rn(rh, to_acc(yv)));
    acc[7] = add_rn(acc[7], mul_rn(rh, to_acc(ze)));
    acc[8] = add_rn(acc[8], mul_rn(rh, to_acc(se)));
  }
  __device__ __forceinline__ void pair(int64_t e, __nv_bfloat162, __nv_bfloat162 yv,
                                       float* acc) const {
    using P = __nv_bfloat162;
    const P a2 = __bfloat162bfloat162(*alpha);
    const P z2 = load_pair(z, e), s2 = load_pair(s, e);
    const P rh2 = load_pair(rhat, e), t2 = load_pair(t, e);
    const P q2 = sub_rn(load_pair(r, e), mul_rn(a2, s2));
    const P y2 = sub_rn(load_pair(w, e), mul_rn(a2, z2));
    store_pair(v_out, e, yv);
    store_pair(q_out, e, q2);
    store_pair(y_out, e, y2);
    // the partials as operator() adds them, lane e first
    auto lane = [acc](float qa, float ya, float rh, float ta, float va, float za, float sa) {
      acc[0] = add_rn(acc[0], mul_rn(qa, ya));
      acc[1] = add_rn(acc[1], mul_rn(ya, ya));
      acc[2] = add_rn(acc[2], mul_rn(qa, qa));
      acc[3] = add_rn(acc[3], mul_rn(rh, qa));
      acc[4] = add_rn(acc[4], mul_rn(rh, ya));
      acc[5] = add_rn(acc[5], mul_rn(rh, ta));
      acc[6] = add_rn(acc[6], mul_rn(rh, va));
      acc[7] = add_rn(acc[7], mul_rn(rh, za));
      acc[8] = add_rn(acc[8], mul_rn(rh, sa));
    };
    lane(to_acc(q2.x), to_acc(y2.x), to_acc(rh2.x), to_acc(t2.x), to_acc(yv.x), to_acc(z2.x),
         to_acc(s2.x));
    lane(to_acc(q2.y), to_acc(y2.y), to_acc(rh2.y), to_acc(t2.y), to_acc(yv.y), to_acc(z2.y),
         to_acc(s2.y));
  }
  bool pairs_aligned() const {
    return repro::pairs_aligned(z, r, w, s, rhat, t, v_out, q_out, y_out);
  }
};

// BicgDotsTail's run on the ring pass (bf16)
template <typename T>
struct ring_run<BicgDotsTail<T>> : std::integral_constant<int, kRingRunBicgDots> {
  using choices = std::integer_sequence<int, kRingRunBicgDots>;
};

// t' = A w̃, p' = r + β(p − ω s), s' = w + β(s − ω z), z' = t' + β(z − ω v)
// at point e (the centre value w̃[e] is not w[e] when preconditioned, so it
// is not used).  On the ring pass, prefetch(e) asks for the six streams a
// step before the tail reads them; on its pair stage (bf16) pair(e, ...)
// takes the outputs (e, e + 1) at once, each stream loaded and stored as
// one bf16 pair and each lane rounded as the scalar form rounds it (the six
// loads first: interleaved with the stores, ptxas spilled 8 bytes in the
// unpadded 7pt instance).
template <typename T>
struct BicgUpdateTail {
  static constexpr int kDots = 0;
  const T* __restrict__ omega;
  const T* __restrict__ beta;
  const T* __restrict__ w;
  const T* __restrict__ r;
  const T* __restrict__ p;
  const T* __restrict__ s;
  const T* __restrict__ z;
  const T* __restrict__ v;
  T* __restrict__ t_out;
  T* __restrict__ p_out;
  T* __restrict__ s_out;
  T* __restrict__ z_out;
  __device__ __forceinline__ void operator()(int64_t e, T, T tn, acc_t<T>*) const {
    const T om = *omega;
    const T be = *beta;
    const T se = s[e];
    const T ze = z[e];
    t_out[e] = tn;
    p_out[e] = add_rn(r[e], mul_rn(be, sub_rn(p[e], mul_rn(om, se))));
    s_out[e] = add_rn(w[e], mul_rn(be, sub_rn(se, mul_rn(om, ze))));
    z_out[e] = add_rn(tn, mul_rn(be, sub_rn(ze, mul_rn(om, v[e]))));
  }
  __device__ __forceinline__ void prefetch(int64_t e) const {
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(w + e));
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(r + e));
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p + e));
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(s + e));
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(z + e));
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(v + e));
  }
  __device__ __forceinline__ void pair(int64_t e, __nv_bfloat162, __nv_bfloat162 tn,
                                       float*) const {
    using P = __nv_bfloat162;
    const P w2 = load_pair(w, e), r2 = load_pair(r, e), p2 = load_pair(p, e);
    const P s2 = load_pair(s, e), z2 = load_pair(z, e), v2 = load_pair(v, e);
    const P om = __bfloat162bfloat162(*omega), be = __bfloat162bfloat162(*beta);
    store_pair(t_out, e, tn);
    store_pair(p_out, e, add_rn(r2, mul_rn(be, sub_rn(p2, mul_rn(om, s2)))));
    store_pair(s_out, e, add_rn(w2, mul_rn(be, sub_rn(s2, mul_rn(om, z2)))));
    store_pair(z_out, e, add_rn(tn, mul_rn(be, sub_rn(z2, mul_rn(om, v2)))));
  }
  bool pairs_aligned() const {
    return repro::pairs_aligned(w, r, p, s, z, v, t_out, p_out, s_out, z_out);
  }
};

// BicgUpdateTail's run on the ring pass (bf16)
template <typename T>
struct ring_run<BicgUpdateTail<T>> : std::integral_constant<int, kRingRunBicgUpdate> {
  using choices = std::integer_sequence<int, kRingRunBicgUpdate>;
};

}  // namespace repro

namespace {

using repro::acc_t;
using repro::BicgDotsTail;
using repro::BicgUpdateTail;

// Whether bicgstab_fused_spmv_dots in T runs on the plane-ring pass (else on
// stencil_kernel): bf16 only.
template <typename T>
constexpr bool bicgstab_dots_on_ring() {
  return std::is_same<T, __nv_bfloat16>::value;
}

// Whether bicgstab_fused_spmv_update in T runs on the plane-ring pass (else
// on stencil_kernel): bf16 only.
template <typename T>
constexpr bool bicgstab_update_on_ring() {
  return std::is_same<T, __nv_bfloat16>::value;
}

// The partial slots per dot product of the dots pass in T: the block count
// of the pass it launches.
template <typename T>
long long dots_partials(int nx, int ny, int nz) {
  if constexpr (bicgstab_dots_on_ring<T>())
    return repro::ring_tail_num_blocks<BicgDotsTail<T>>(nx, ny, nz);
  else
    return repro::stencil_num_blocks(nx, ny, nz);
}

template <typename T>
int spmv_dots(const void* zp, const void* z, const void* r, const void* w, const void* s,
              const void* rhat, const void* t, const void* alpha, void* v, void* q, void* y,
              void* partials, void* dots, int nx, int ny, int nz, int npoint, double diag,
              double off, void* stream) {
  const BicgDotsTail<T> tail{static_cast<const T*>(alpha), static_cast<const T*>(z),
                             static_cast<const T*>(r),     static_cast<const T*>(w),
                             static_cast<const T*>(s),     static_cast<const T*>(rhat),
                             static_cast<const T*>(t),     static_cast<T*>(v),
                             static_cast<T*>(q),           static_cast<T*>(y)};
  const T* x = static_cast<const T*>(zp);
  acc_t<T>* parts = static_cast<acc_t<T>*>(partials);
  acc_t<T>* out = static_cast<acc_t<T>*>(dots);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (bicgstab_dots_on_ring<T>())
    return repro::launch_stencil_ring<T>(x, 0, tail, parts, out, nx, ny, nz, npoint, diag, off,
                                         st);
  else
    return repro::launch_stencil<T>(x, tail, parts, out, nx, ny, nz, npoint, diag, off, st);
}

template <typename T>
int spmv_update(const void* wp, const void* w, const void* r, const void* p, const void* s,
                const void* z, const void* v, const void* omega, const void* beta,
                void* t_out, void* p_out, void* s_out, void* z_out, int nx, int ny, int nz,
                int npoint, double diag, double off, void* stream) {
  const BicgUpdateTail<T> tail{static_cast<const T*>(omega), static_cast<const T*>(beta),
                               static_cast<const T*>(w),     static_cast<const T*>(r),
                               static_cast<const T*>(p),     static_cast<const T*>(s),
                               static_cast<const T*>(z),     static_cast<const T*>(v),
                               static_cast<T*>(t_out),       static_cast<T*>(p_out),
                               static_cast<T*>(s_out),       static_cast<T*>(z_out)};
  const T* x = static_cast<const T*>(wp);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (bicgstab_update_on_ring<T>())
    return repro::launch_stencil_ring<T>(x, 0, tail, nullptr, nullptr, nx, ny, nz, npoint, diag,
                                         off, st);
  else
    return repro::launch_stencil<T>(x, tail, nullptr, nullptr, nx, ny, nz, npoint, diag, off,
                                    st);
}

}  // namespace

extern "C" {

// Number of partial slots per dot product of the dots pass in each dtype
// (the block count of the pass it launches); the scratch holds nine of them.
long long bicgstab_partials_f64(int nx, int ny, int nz) {
  return dots_partials<double>(nx, ny, nz);
}

long long bicgstab_partials_f32(int nx, int ny, int nz) {
  return dots_partials<float>(nx, ny, nz);
}

long long bicgstab_partials_bf16(int nx, int ny, int nz) {
  return dots_partials<__nv_bfloat16>(nx, ny, nz);
}

// dots[0..9) = (q·y, y·y, q·q, r̂·q, r̂·y, r̂·t, r̂·v, r̂·z, r̂·s); zp is
// (nx+2, ny+2, nz+2), every other vector (nx, ny, nz); alpha a device scalar.
int bicgstab_spmv_dots_f64(const void* zp, const void* z, const void* r, const void* w,
                           const void* s, const void* rhat, const void* t, const void* alpha,
                           void* v, void* q, void* y, void* partials, void* dots, int nx,
                           int ny, int nz, int npoint, double diag, double off,
                           void* stream) {
  return spmv_dots<double>(zp, z, r, w, s, rhat, t, alpha, v, q, y, partials, dots, nx, ny,
                           nz, npoint, diag, off, stream);
}

int bicgstab_spmv_dots_f32(const void* zp, const void* z, const void* r, const void* w,
                           const void* s, const void* rhat, const void* t, const void* alpha,
                           void* v, void* q, void* y, void* partials, void* dots, int nx,
                           int ny, int nz, int npoint, double diag, double off,
                           void* stream) {
  return spmv_dots<float>(zp, z, r, w, s, rhat, t, alpha, v, q, y, partials, dots, nx, ny,
                          nz, npoint, diag, off, stream);
}

// bf16 vectors and alpha; partials and dots are float.
int bicgstab_spmv_dots_bf16(const void* zp, const void* z, const void* r, const void* w,
                            const void* s, const void* rhat, const void* t, const void* alpha,
                            void* v, void* q, void* y, void* partials, void* dots, int nx,
                            int ny, int nz, int npoint, double diag, double off,
                            void* stream) {
  return spmv_dots<__nv_bfloat16>(zp, z, r, w, s, rhat, t, alpha, v, q, y, partials, dots,
                                  nx, ny, nz, npoint, diag, off, stream);
}

// (t', p', s', z') from the padded wp and the unpadded w, r, p, s, z, v;
// omega and beta device scalars.
int bicgstab_spmv_update_f64(const void* wp, const void* w, const void* r, const void* p,
                             const void* s, const void* z, const void* v, const void* omega,
                             const void* beta, void* t_out, void* p_out, void* s_out,
                             void* z_out, int nx, int ny, int nz, int npoint, double diag,
                             double off, void* stream) {
  return spmv_update<double>(wp, w, r, p, s, z, v, omega, beta, t_out, p_out, s_out, z_out,
                             nx, ny, nz, npoint, diag, off, stream);
}

int bicgstab_spmv_update_f32(const void* wp, const void* w, const void* r, const void* p,
                             const void* s, const void* z, const void* v, const void* omega,
                             const void* beta, void* t_out, void* p_out, void* s_out,
                             void* z_out, int nx, int ny, int nz, int npoint, double diag,
                             double off, void* stream) {
  return spmv_update<float>(wp, w, r, p, s, z, v, omega, beta, t_out, p_out, s_out, z_out,
                            nx, ny, nz, npoint, diag, off, stream);
}

int bicgstab_spmv_update_bf16(const void* wp, const void* w, const void* r, const void* p,
                              const void* s, const void* z, const void* v, const void* omega,
                              const void* beta, void* t_out, void* p_out, void* s_out,
                              void* z_out, int nx, int ny, int nz, int npoint, double diag,
                              double off, void* stream) {
  return spmv_update<__nv_bfloat16>(wp, w, r, p, s, z, v, omega, beta, t_out, p_out, s_out,
                                    z_out, nx, ny, nz, npoint, diag, off, stream);
}

}  // extern "C"
