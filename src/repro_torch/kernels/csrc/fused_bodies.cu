// The fused vector passes of the merged and pipelined CG family, each one
// flat pass over the n elements of the (nx, ny, nz) grid:
//
//   Kernel 10, fused_pcg_body: merged PCG's four vector updates,
//     p' = u + beta p,  s' = w + beta s,  x' = x + alpha p',  r' = r - alpha s'
//   Kernel 9, fused_pipe_body: pipelined CG's six recurrences,
//     z' = n + beta z,  s' = w + beta s,  p' = r + beta p,
//     x' = x + alpha p',  r' = r - alpha s',  w' = w - alpha z'
//   Kernel 11, fused_ppipe_body: pipelined PCG's eight recurrences,
//     z' = n + beta z,  q' = m + beta q,  s' = w + beta s,  p' = u + beta p,
//     x' = x + alpha p',  r' = r - alpha s',  u' = u - alpha q',  w' = w - alpha z'
//   Kernel 8, fused_dots: pipelined PCG's reduction triple on carried state,
//     (a·b, c·b, a·a) = (r·u, w·u, r·r) for (a, b, c) = (r, u, w)
//   Kernel 12, bicgstab_fused_update1: single-reduction BiCGStab's ω-half,
//     y' = (y + α p) + ω q,  r' = q − ω yv,  w' = yv − ω (t − α v)
//
// Replaces: src/repro/kernels/fused_bodies.py, functions fused_pcg_body,
// fused_pipe_body, fused_ppipe_body, fused_dots and bicgstab_fused_update1
// (Pallas TPU kernels over (rows, 1024) row tiles; fused_dots adds into one
// revisited (1, 3) block, sound there only because TPU grid steps run in
// order).
//
// Bound on the H100: memory bytes.  Each vector is read or written once:
// fused_pcg_body 6 reads + 4 writes, fused_pipe_body 7 + 6, fused_ppipe_body
// 10 + 8, fused_dots 3 reads, bicgstab_fused_update1 6 + 3.  A few
// operations per element are far below the card's arithmetic rate.
//
// Design: a flat grid-stride loop; neighbouring threads touch neighbouring
// elements of every stream, so every access coalesces.  The scalars (alpha
// and beta, or alpha and omega) are read from device scalars, so the host
// never waits for them.  Each product
// and sum is rounded on its own (no FMA contraction), in the plain PyTorch
// version's order, so the vector outputs agree with it bitwise.  The bodies
// always write fresh outputs: the caller passes live state.  fused_dots
// writes one partial slot per block and reduce_partials (stencil.cuh) sums
// the slots in a fixed order: no atomics, bitwise reproducible.
//
// bf16 (the _bf16 entry points): vectors and the device scalars in bf16 (the
// wrapper rounds them), each operation rounded to bf16 as the plain
// version's; fused_dots's partials are f32 sums of f32 products (float slots
// and dots), as the reference's oracle computes them.  Bound: bytes at 2 B
// an element, 4 B a partial.
#include "stencil.cuh"

namespace {

using repro::acc_t;
using repro::add_rn;
using repro::flat_blocks;
using repro::kFlatDotsBlocks;
using repro::kFlatMaxBlocks;
using repro::kFlatThreads;
using repro::mul_rn;
using repro::sub_rn;

template <typename T>
__global__ void __launch_bounds__(kFlatThreads)
fused_pcg_body_kernel(const T* __restrict__ alpha_p, const T* __restrict__ beta_p,
                      const T* __restrict__ x, const T* __restrict__ r,
                      const T* __restrict__ u, const T* __restrict__ p,
                      const T* __restrict__ s, const T* __restrict__ w,
                      T* __restrict__ xo, T* __restrict__ ro, T* __restrict__ po,
                      T* __restrict__ so, int64_t n) {
  const T alpha = *alpha_p;
  const T beta = *beta_p;
  const int64_t stride = (int64_t)gridDim.x * kFlatThreads;
  for (int64_t e = (int64_t)blockIdx.x * kFlatThreads + threadIdx.x; e < n; e += stride) {
    const T pn = add_rn(u[e], mul_rn(beta, p[e]));
    const T sn = add_rn(w[e], mul_rn(beta, s[e]));
    po[e] = pn;
    so[e] = sn;
    xo[e] = add_rn(x[e], mul_rn(alpha, pn));
    ro[e] = sub_rn(r[e], mul_rn(alpha, sn));
  }
}

template <typename T>
__global__ void __launch_bounds__(kFlatThreads)
fused_pipe_body_kernel(const T* __restrict__ alpha_p, const T* __restrict__ beta_p,
                       const T* __restrict__ x, const T* __restrict__ r,
                       const T* __restrict__ w, const T* __restrict__ p,
                       const T* __restrict__ s, const T* __restrict__ z,
                       const T* __restrict__ nv, T* __restrict__ xo, T* __restrict__ ro,
                       T* __restrict__ wo, T* __restrict__ po, T* __restrict__ so,
                       T* __restrict__ zo, int64_t n) {
  const T alpha = *alpha_p;
  const T beta = *beta_p;
  const int64_t stride = (int64_t)gridDim.x * kFlatThreads;
  for (int64_t e = (int64_t)blockIdx.x * kFlatThreads + threadIdx.x; e < n; e += stride) {
    const T re = r[e];
    const T we = w[e];
    const T zn = add_rn(nv[e], mul_rn(beta, z[e]));
    const T sn = add_rn(we, mul_rn(beta, s[e]));
    const T pn = add_rn(re, mul_rn(beta, p[e]));
    zo[e] = zn;
    so[e] = sn;
    po[e] = pn;
    xo[e] = add_rn(x[e], mul_rn(alpha, pn));
    ro[e] = sub_rn(re, mul_rn(alpha, sn));
    wo[e] = sub_rn(we, mul_rn(alpha, zn));
  }
}

template <typename T>
__global__ void __launch_bounds__(kFlatThreads)
fused_ppipe_body_kernel(const T* __restrict__ alpha_p, const T* __restrict__ beta_p,
                        const T* __restrict__ x, const T* __restrict__ r,
                        const T* __restrict__ u, const T* __restrict__ w,
                        const T* __restrict__ p, const T* __restrict__ s,
                        const T* __restrict__ q, const T* __restrict__ z,
                        const T* __restrict__ m, const T* __restrict__ nv,
                        T* __restrict__ xo, T* __restrict__ ro, T* __restrict__ uo,
                        T* __restrict__ wo, T* __restrict__ po, T* __restrict__ so,
                        T* __restrict__ qo, T* __restrict__ zo, int64_t n) {
  const T alpha = *alpha_p;
  const T beta = *beta_p;
  const int64_t stride = (int64_t)gridDim.x * kFlatThreads;
  for (int64_t e = (int64_t)blockIdx.x * kFlatThreads + threadIdx.x; e < n; e += stride) {
    const T ue = u[e];
    const T we = w[e];
    const T zn = add_rn(nv[e], mul_rn(beta, z[e]));
    const T qn = add_rn(m[e], mul_rn(beta, q[e]));
    const T sn = add_rn(we, mul_rn(beta, s[e]));
    const T pn = add_rn(ue, mul_rn(beta, p[e]));
    zo[e] = zn;
    qo[e] = qn;
    so[e] = sn;
    po[e] = pn;
    xo[e] = add_rn(x[e], mul_rn(alpha, pn));
    ro[e] = sub_rn(r[e], mul_rn(alpha, sn));
    uo[e] = sub_rn(ue, mul_rn(alpha, qn));
    wo[e] = sub_rn(we, mul_rn(alpha, zn));
  }
}

template <typename T>
__global__ void __launch_bounds__(kFlatThreads)
bicgstab_update1_kernel(const T* __restrict__ alpha_p, const T* __restrict__ omega_p,
                        const T* __restrict__ y, const T* __restrict__ p,
                        const T* __restrict__ q, const T* __restrict__ yv,
                        const T* __restrict__ t, const T* __restrict__ v,
                        T* __restrict__ yo, T* __restrict__ ro, T* __restrict__ wo,
                        int64_t n) {
  const T alpha = *alpha_p;
  const T omega = *omega_p;
  const int64_t stride = (int64_t)gridDim.x * kFlatThreads;
  for (int64_t e = (int64_t)blockIdx.x * kFlatThreads + threadIdx.x; e < n; e += stride) {
    const T qe = q[e];
    const T ye = yv[e];
    yo[e] = add_rn(add_rn(y[e], mul_rn(alpha, p[e])), mul_rn(omega, qe));
    ro[e] = sub_rn(qe, mul_rn(omega, ye));
    wo[e] = sub_rn(ye, mul_rn(omega, sub_rn(t[e], mul_rn(alpha, v[e]))));
  }
}

// Per-block partials of a·b, c·b and a·a, stored at partials[d * gridDim.x + block].
template <typename T>
__global__ void __launch_bounds__(kFlatThreads)
fused_dots_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const T* __restrict__ c, acc_t<T>* __restrict__ partials, int64_t n) {
  acc_t<T> v[3] = {acc_t<T>(0), acc_t<T>(0), acc_t<T>(0)};
  const int64_t stride = (int64_t)gridDim.x * kFlatThreads;
  for (int64_t e = (int64_t)blockIdx.x * kFlatThreads + threadIdx.x; e < n; e += stride) {
    const acc_t<T> ae = repro::to_acc(a[e]);
    const acc_t<T> be = repro::to_acc(b[e]);
    v[0] = add_rn(v[0], mul_rn(ae, be));
    v[1] = add_rn(v[1], mul_rn(repro::to_acc(c[e]), be));
    v[2] = add_rn(v[2], mul_rn(ae, ae));
  }
  repro::store_flat_partials<acc_t<T>, 3>(v, partials);
}

template <typename T>
int launch_pcg_body(const void* alpha, const void* beta, const void* x, const void* r,
                    const void* u, const void* p, const void* s, const void* w, void* xo,
                    void* ro, void* po, void* so, long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  fused_pcg_body_kernel<T><<<(unsigned)flat_blocks(n, kFlatMaxBlocks), kFlatThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(alpha), static_cast<const T*>(beta), static_cast<const T*>(x),
      static_cast<const T*>(r), static_cast<const T*>(u), static_cast<const T*>(p),
      static_cast<const T*>(s), static_cast<const T*>(w), static_cast<T*>(xo),
      static_cast<T*>(ro), static_cast<T*>(po), static_cast<T*>(so), (int64_t)n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pipe_body(const void* alpha, const void* beta, const void* x, const void* r,
                     const void* w, const void* p, const void* s, const void* z,
                     const void* nv, void* xo, void* ro, void* wo, void* po, void* so,
                     void* zo, long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  fused_pipe_body_kernel<T><<<(unsigned)flat_blocks(n, kFlatMaxBlocks), kFlatThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(alpha), static_cast<const T*>(beta), static_cast<const T*>(x),
      static_cast<const T*>(r), static_cast<const T*>(w), static_cast<const T*>(p),
      static_cast<const T*>(s), static_cast<const T*>(z), static_cast<const T*>(nv),
      static_cast<T*>(xo), static_cast<T*>(ro), static_cast<T*>(wo), static_cast<T*>(po),
      static_cast<T*>(so), static_cast<T*>(zo), (int64_t)n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ppipe_body(const void* alpha, const void* beta, const void* x, const void* r,
                      const void* u, const void* w, const void* p, const void* s,
                      const void* q, const void* z, const void* m, const void* nv, void* xo,
                      void* ro, void* uo, void* wo, void* po, void* so, void* qo, void* zo,
                      long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  fused_ppipe_body_kernel<T><<<(unsigned)flat_blocks(n, kFlatMaxBlocks), kFlatThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(alpha), static_cast<const T*>(beta), static_cast<const T*>(x),
      static_cast<const T*>(r), static_cast<const T*>(u), static_cast<const T*>(w),
      static_cast<const T*>(p), static_cast<const T*>(s), static_cast<const T*>(q),
      static_cast<const T*>(z), static_cast<const T*>(m), static_cast<const T*>(nv),
      static_cast<T*>(xo), static_cast<T*>(ro), static_cast<T*>(uo), static_cast<T*>(wo),
      static_cast<T*>(po), static_cast<T*>(so), static_cast<T*>(qo), static_cast<T*>(zo),
      (int64_t)n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bicgstab_update1(const void* alpha, const void* omega, const void* y,
                            const void* p, const void* q, const void* yv, const void* t,
                            const void* v, void* yo, void* ro, void* wo, long long n,
                            void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  bicgstab_update1_kernel<T><<<(unsigned)flat_blocks(n, kFlatMaxBlocks), kFlatThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(alpha), static_cast<const T*>(omega), static_cast<const T*>(y),
      static_cast<const T*>(p), static_cast<const T*>(q), static_cast<const T*>(yv),
      static_cast<const T*>(t), static_cast<const T*>(v), static_cast<T*>(yo),
      static_cast<T*>(ro), static_cast<T*>(wo), (int64_t)n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dots(const void* a, const void* b, const void* c, void* partials, void* dots,
                long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = flat_blocks(n, kFlatDotsBlocks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  fused_dots_kernel<T><<<(unsigned)blocks, kFlatThreads, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<acc_t<T>*>(partials), (int64_t)n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  repro::reduce_partials<acc_t<T>, 3><<<1, repro::kReduceThreads, 0, st>>>(
      static_cast<const acc_t<T>*>(partials), blocks, static_cast<acc_t<T>*>(dots));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_pcg_body_f64(const void* alpha, const void* beta, const void* x, const void* r,
                       const void* u, const void* p, const void* s, const void* w, void* xo,
                       void* ro, void* po, void* so, long long n, void* stream) {
  return launch_pcg_body<double>(alpha, beta, x, r, u, p, s, w, xo, ro, po, so, n, stream);
}

int fused_pcg_body_f32(const void* alpha, const void* beta, const void* x, const void* r,
                       const void* u, const void* p, const void* s, const void* w, void* xo,
                       void* ro, void* po, void* so, long long n, void* stream) {
  return launch_pcg_body<float>(alpha, beta, x, r, u, p, s, w, xo, ro, po, so, n, stream);
}

int fused_pcg_body_bf16(const void* alpha, const void* beta, const void* x, const void* r,
                        const void* u, const void* p, const void* s, const void* w,
                        void* xo, void* ro, void* po, void* so, long long n, void* stream) {
  return launch_pcg_body<__nv_bfloat16>(alpha, beta, x, r, u, p, s, w, xo, ro, po, so, n,
                                        stream);
}

int fused_pipe_body_f64(const void* alpha, const void* beta, const void* x, const void* r,
                        const void* w, const void* p, const void* s, const void* z,
                        const void* nv, void* xo, void* ro, void* wo, void* po, void* so,
                        void* zo, long long n, void* stream) {
  return launch_pipe_body<double>(alpha, beta, x, r, w, p, s, z, nv, xo, ro, wo, po, so,
                                  zo, n, stream);
}

int fused_pipe_body_f32(const void* alpha, const void* beta, const void* x, const void* r,
                        const void* w, const void* p, const void* s, const void* z,
                        const void* nv, void* xo, void* ro, void* wo, void* po, void* so,
                        void* zo, long long n, void* stream) {
  return launch_pipe_body<float>(alpha, beta, x, r, w, p, s, z, nv, xo, ro, wo, po, so,
                                 zo, n, stream);
}

int fused_pipe_body_bf16(const void* alpha, const void* beta, const void* x, const void* r,
                         const void* w, const void* p, const void* s, const void* z,
                         const void* nv, void* xo, void* ro, void* wo, void* po, void* so,
                         void* zo, long long n, void* stream) {
  return launch_pipe_body<__nv_bfloat16>(alpha, beta, x, r, w, p, s, z, nv, xo, ro, wo, po,
                                         so, zo, n, stream);
}

int fused_ppipe_body_f64(const void* alpha, const void* beta, const void* x, const void* r,
                         const void* u, const void* w, const void* p, const void* s,
                         const void* q, const void* z, const void* m, const void* nv,
                         void* xo, void* ro, void* uo, void* wo, void* po, void* so,
                         void* qo, void* zo, long long n, void* stream) {
  return launch_ppipe_body<double>(alpha, beta, x, r, u, w, p, s, q, z, m, nv, xo, ro, uo,
                                   wo, po, so, qo, zo, n, stream);
}

int fused_ppipe_body_f32(const void* alpha, const void* beta, const void* x, const void* r,
                         const void* u, const void* w, const void* p, const void* s,
                         const void* q, const void* z, const void* m, const void* nv,
                         void* xo, void* ro, void* uo, void* wo, void* po, void* so,
                         void* qo, void* zo, long long n, void* stream) {
  return launch_ppipe_body<float>(alpha, beta, x, r, u, w, p, s, q, z, m, nv, xo, ro, uo,
                                  wo, po, so, qo, zo, n, stream);
}

int fused_ppipe_body_bf16(const void* alpha, const void* beta, const void* x, const void* r,
                          const void* u, const void* w, const void* p, const void* s,
                          const void* q, const void* z, const void* m, const void* nv,
                          void* xo, void* ro, void* uo, void* wo, void* po, void* so,
                          void* qo, void* zo, long long n, void* stream) {
  return launch_ppipe_body<__nv_bfloat16>(alpha, beta, x, r, u, w, p, s, q, z, m, nv, xo, ro,
                                          uo, wo, po, so, qo, zo, n, stream);
}

// (y', r', w') = (y + α p + ω q, q − ω yv, yv − ω (t − α v)).
int bicgstab_fused_update1_f64(const void* alpha, const void* omega, const void* y,
                               const void* p, const void* q, const void* yv, const void* t,
                               const void* v, void* yo, void* ro, void* wo, long long n,
                               void* stream) {
  return launch_bicgstab_update1<double>(alpha, omega, y, p, q, yv, t, v, yo, ro, wo, n,
                                         stream);
}

int bicgstab_fused_update1_f32(const void* alpha, const void* omega, const void* y,
                               const void* p, const void* q, const void* yv, const void* t,
                               const void* v, void* yo, void* ro, void* wo, long long n,
                               void* stream) {
  return launch_bicgstab_update1<float>(alpha, omega, y, p, q, yv, t, v, yo, ro, wo, n,
                                        stream);
}

int bicgstab_fused_update1_bf16(const void* alpha, const void* omega, const void* y,
                                const void* p, const void* q, const void* yv, const void* t,
                                const void* v, void* yo, void* ro, void* wo, long long n,
                                void* stream) {
  return launch_bicgstab_update1<__nv_bfloat16>(alpha, omega, y, p, q, yv, t, v, yo, ro, wo,
                                                n, stream);
}

// Number of partial slots per dot product of fused_dots for n elements; the
// scratch holds three of them.
long long fused_dots_partials(long long n) {
  return n > 0 ? flat_blocks(n, kFlatDotsBlocks) : 0;
}

// dots[0] = a·b, dots[1] = c·b, dots[2] = a·a over n elements.
int fused_dots_f64(const void* a, const void* b, const void* c, void* partials, void* dots,
                   long long n, void* stream) {
  return launch_dots<double>(a, b, c, partials, dots, n, stream);
}

int fused_dots_f32(const void* a, const void* b, const void* c, void* partials, void* dots,
                   long long n, void* stream) {
  return launch_dots<float>(a, b, c, partials, dots, n, stream);
}

// bf16 a, b and c; partials and dots are float.
int fused_dots_bf16(const void* a, const void* b, const void* c, void* partials, void* dots,
                    long long n, void* stream) {
  return launch_dots<__nv_bfloat16>(a, b, c, partials, dots, n, stream);
}

}  // extern "C"
