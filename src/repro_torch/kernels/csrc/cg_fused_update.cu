// Kernels 3 and 5, the CG vector updates of src/repro/kernels/cg_fused_update.py,
// each one flat pass over the n elements:
//
//   Kernel 3, fused_cg_body: merged CG's four vector updates,
//     p' = r + beta p,  s' = w + beta s,  x' = x + alpha p',  r' = r - alpha s'
//   Kernel 5, cg_fused_update: CG-NB's Tk1&2 (Alg. 1 lines 6-8),
//     p' = r + beta p,  Ap' = Ar + beta Ap  and the partial of Ap'·p'
//
// Replaces: src/repro/kernels/cg_fused_update.py, functions fused_cg_body and
// cg_fused_update (Pallas TPU kernels over (rows, 1024) row tiles;
// cg_fused_update adds its partial into one revisited (1, 1) block, sound
// there only because TPU grid steps run in order).
//
// Bound on the H100: memory bytes: fused_cg_body reads 5 vectors and writes
// 4, cg_fused_update reads 4 and writes 2, each once; 8 and 6 operations per
// element are far below the card's arithmetic rate.
//
// Design: a flat grid-stride loop over the contiguous vectors (stencil.cuh's
// flat pass, any n, no padding); neighbouring threads touch neighbouring
// elements of every stream, so every access coalesces.  alpha and beta are
// read from device scalars, so the host never waits for them.  Written in
// CUDA C++ rather than Triton to keep one build route (nvcc + ctypes) for
// every kernel of the port.  Each product and sum is rounded on its own (no
// FMA contraction), as in the plain PyTorch version, so the outputs agree
// with it bitwise.  cg_fused_update writes one partial slot per block (at
// most kFlatDotsBlocks, a function of n alone) and reduce_partials sums the
// slots in a fixed order: no atomics, bitwise reproducible.
//
// bf16 (fused_cg_body_bf16, cg_update_bf16): vectors and the device scalars
// alpha and beta in bf16 (the wrapper rounds them), each operation rounded
// to bf16 as the plain version's; cg_fused_update's partial is an f32 sum of
// f32 products (float slots and dot), as the reference's oracle computes it.
// Bound: bytes at 2 B an element, 4 B the partial.
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
fused_cg_body_kernel(const T* __restrict__ alpha_p, const T* __restrict__ beta_p,
                     const T* __restrict__ x, const T* __restrict__ r,
                     const T* __restrict__ p, const T* __restrict__ s,
                     const T* __restrict__ w, T* __restrict__ xo, T* __restrict__ ro,
                     T* __restrict__ po, T* __restrict__ so, int64_t n) {
  const T alpha = *alpha_p;
  const T beta = *beta_p;
  const int64_t stride = (int64_t)gridDim.x * kFlatThreads;
  for (int64_t e = (int64_t)blockIdx.x * kFlatThreads + threadIdx.x; e < n; e += stride) {
    const T re = r[e];
    const T pn = add_rn(re, mul_rn(beta, p[e]));
    const T sn = add_rn(w[e], mul_rn(beta, s[e]));
    po[e] = pn;
    so[e] = sn;
    xo[e] = add_rn(x[e], mul_rn(alpha, pn));
    ro[e] = sub_rn(re, mul_rn(alpha, sn));
  }
}

// p' = r + beta p, Ap' = Ar + beta Ap, and the block's partial of Ap'·p' at
// partials[block].
template <typename T>
__global__ void __launch_bounds__(kFlatThreads)
cg_update_kernel(const T* __restrict__ beta_p, const T* __restrict__ r,
                 const T* __restrict__ ar, const T* __restrict__ p,
                 const T* __restrict__ ap, T* __restrict__ po, T* __restrict__ apo,
                 acc_t<T>* __restrict__ partials, int64_t n) {
  const T beta = *beta_p;
  acc_t<T> v[1] = {acc_t<T>(0)};
  const int64_t stride = (int64_t)gridDim.x * kFlatThreads;
  for (int64_t e = (int64_t)blockIdx.x * kFlatThreads + threadIdx.x; e < n; e += stride) {
    const T pn = add_rn(r[e], mul_rn(beta, p[e]));
    const T apn = add_rn(ar[e], mul_rn(beta, ap[e]));
    po[e] = pn;
    apo[e] = apn;
    v[0] = add_rn(v[0], mul_rn(repro::to_acc(apn), repro::to_acc(pn)));
  }
  repro::store_flat_partials<acc_t<T>, 1>(v, partials);
}

template <typename T>
int launch_cg_body(const void* alpha, const void* beta, const void* x, const void* r,
                   const void* p, const void* s, const void* w, void* xo, void* ro,
                   void* po, void* so, long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  fused_cg_body_kernel<T><<<(unsigned)flat_blocks(n, kFlatMaxBlocks), kFlatThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(alpha), static_cast<const T*>(beta), static_cast<const T*>(x),
      static_cast<const T*>(r), static_cast<const T*>(p), static_cast<const T*>(s),
      static_cast<const T*>(w), static_cast<T*>(xo), static_cast<T*>(ro),
      static_cast<T*>(po), static_cast<T*>(so), (int64_t)n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cg_update(const void* beta, const void* r, const void* ar, const void* p,
                     const void* ap, void* po, void* apo, void* partials, void* dot,
                     long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = flat_blocks(n, kFlatDotsBlocks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cg_update_kernel<T><<<(unsigned)blocks, kFlatThreads, 0, st>>>(
      static_cast<const T*>(beta), static_cast<const T*>(r), static_cast<const T*>(ar),
      static_cast<const T*>(p), static_cast<const T*>(ap), static_cast<T*>(po),
      static_cast<T*>(apo), static_cast<acc_t<T>*>(partials), (int64_t)n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  repro::reduce_partials<acc_t<T>, 1><<<1, repro::kReduceThreads, 0, st>>>(
      static_cast<const acc_t<T>*>(partials), blocks, static_cast<acc_t<T>*>(dot));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_cg_body_f64(const void* alpha, const void* beta, const void* x, const void* r,
                      const void* p, const void* s, const void* w, void* xo, void* ro,
                      void* po, void* so, long long n, void* stream) {
  return launch_cg_body<double>(alpha, beta, x, r, p, s, w, xo, ro, po, so, n, stream);
}

int fused_cg_body_f32(const void* alpha, const void* beta, const void* x, const void* r,
                      const void* p, const void* s, const void* w, void* xo, void* ro,
                      void* po, void* so, long long n, void* stream) {
  return launch_cg_body<float>(alpha, beta, x, r, p, s, w, xo, ro, po, so, n, stream);
}

int fused_cg_body_bf16(const void* alpha, const void* beta, const void* x, const void* r,
                       const void* p, const void* s, const void* w, void* xo, void* ro,
                       void* po, void* so, long long n, void* stream) {
  return launch_cg_body<__nv_bfloat16>(alpha, beta, x, r, p, s, w, xo, ro, po, so, n,
                                       stream);
}

// Number of partial slots of cg_fused_update for n elements.
long long cg_update_partials(long long n) {
  return n > 0 ? flat_blocks(n, kFlatDotsBlocks) : 0;
}

// (p', Ap') = (r + beta p, Ar + beta Ap) and dot[0] = Ap'·p' over n elements.
int cg_update_f64(const void* beta, const void* r, const void* ar, const void* p,
                  const void* ap, void* po, void* apo, void* partials, void* dot,
                  long long n, void* stream) {
  return launch_cg_update<double>(beta, r, ar, p, ap, po, apo, partials, dot, n, stream);
}

int cg_update_f32(const void* beta, const void* r, const void* ar, const void* p,
                  const void* ap, void* po, void* apo, void* partials, void* dot,
                  long long n, void* stream) {
  return launch_cg_update<float>(beta, r, ar, p, ap, po, apo, partials, dot, n, stream);
}

// bf16 vectors and beta; partials and dot are float.
int cg_update_bf16(const void* beta, const void* r, const void* ar, const void* p,
                   const void* ap, void* po, void* apo, void* partials, void* dot,
                   long long n, void* stream) {
  return launch_cg_update<__nv_bfloat16>(beta, r, ar, p, ap, po, apo, partials, dot, n,
                                         stream);
}

}  // extern "C"
