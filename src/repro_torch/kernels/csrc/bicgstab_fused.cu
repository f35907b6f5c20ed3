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
// thread) with BicgDotsTail / BicgUpdateTail as the per-point epilogue.  The
// stencil's centre value is z̃[e], which in the preconditioned form is not
// z[e]: the tails read every vector from its own unpadded stream and never
// use it.  α, ω and β are device scalars read by the kernel, so the host
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
// 2 B an element, 4 B a partial.
#include "stencil.cuh"

// The tails live in a named namespace: the stencil kernel is a __global__
// template instantiated with them.
namespace repro {

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
};

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
};

}  // namespace repro

namespace {

using repro::acc_t;
using repro::BicgDotsTail;
using repro::BicgUpdateTail;

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
  return repro::launch_stencil<T>(static_cast<const T*>(zp), tail,
                                  static_cast<acc_t<T>*>(partials),
                                  static_cast<acc_t<T>*>(dots), nx, ny, nz, npoint, diag, off,
                                  static_cast<cudaStream_t>(stream));
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
  return repro::launch_stencil<T>(static_cast<const T*>(wp), tail, nullptr, nullptr, nx, ny,
                                  nz, npoint, diag, off, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// Number of partial slots per dot product; the scratch holds nine of them.
long long bicgstab_partials(int nx, int ny, int nz) {
  return repro::stencil_num_blocks(nx, ny, nz);
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
