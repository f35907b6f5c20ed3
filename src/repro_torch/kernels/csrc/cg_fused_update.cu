// Kernel 3: merged CG's four vector updates in one pass,
//   p' = r + beta p,  s' = w + beta s,  x' = x + alpha p',  r' = r - alpha s'.
//
// Replaces: src/repro/kernels/cg_fused_update.py, function fused_cg_body (the
// Pallas TPU kernel over (rows, 1024) row tiles).
//
// Bound on the H100: memory bytes: 5 vectors read and 4 written once each;
// 8 operations per element are far below the card's arithmetic rate.
//
// Design: a flat grid-stride loop over the n elements of the (nx, ny, nz)
// grid; neighbouring threads touch neighbouring elements of all nine streams,
// so every access coalesces.  alpha and beta are read from device scalars, so
// the host never waits for them.  Written in CUDA C++ rather than Triton to
// keep one build route (nvcc + ctypes) for every kernel of the port.  Each
// product and sum is rounded on its own (no FMA contraction), as in the plain
// PyTorch version, so the outputs agree with it bitwise.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_cg_body_kernel(const T* __restrict__ alpha_p, const T* __restrict__ beta_p,
                     const T* __restrict__ x, const T* __restrict__ r,
                     const T* __restrict__ p, const T* __restrict__ s,
                     const T* __restrict__ w, T* __restrict__ xo, T* __restrict__ ro,
                     T* __restrict__ po, T* __restrict__ so, int64_t n) {
  const T alpha = *alpha_p;
  const T beta = *beta_p;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x; e < n; e += stride) {
    const T re = r[e];
    const T pn = add_rn(re, mul_rn(beta, p[e]));
    const T sn = add_rn(w[e], mul_rn(beta, s[e]));
    po[e] = pn;
    so[e] = sn;
    xo[e] = add_rn(x[e], mul_rn(alpha, pn));
    ro[e] = sub_rn(re, mul_rn(alpha, sn));
  }
}

template <typename T>
int launch(const void* alpha, const void* beta, const void* x, const void* r,
           const void* p, const void* s, const void* w, void* xo, void* ro, void* po,
           void* so, long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  fused_cg_body_kernel<T><<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(alpha), static_cast<const T*>(beta), static_cast<const T*>(x),
      static_cast<const T*>(r), static_cast<const T*>(p), static_cast<const T*>(s),
      static_cast<const T*>(w), static_cast<T*>(xo), static_cast<T*>(ro),
      static_cast<T*>(po), static_cast<T*>(so), (int64_t)n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_cg_body_f64(const void* alpha, const void* beta, const void* x, const void* r,
                      const void* p, const void* s, const void* w, void* xo, void* ro,
                      void* po, void* so, long long n, void* stream) {
  return launch<double>(alpha, beta, x, r, p, s, w, xo, ro, po, so, n, stream);
}

int fused_cg_body_f32(const void* alpha, const void* beta, const void* x, const void* r,
                      const void* p, const void* s, const void* w, void* xo, void* ro,
                      void* po, void* so, long long n, void* stream) {
  return launch<float>(alpha, beta, x, r, p, s, w, xo, ro, po, so, n, stream);
}

}  // extern "C"
