// Kernels 6 and 7: the paper's ad hoc vector update (§3.1) in one flat pass
// over the n elements of any matching shapes:
//
//   Kernel 6, fused_axpby:      out = a x + b y + c z
//   Kernel 7, fused_axpby_dot:  the same and the partial of out·w
//
// Replaces: src/repro/kernels/fused_axpby.py, functions fused_axpby and
// fused_axpby_dot (Pallas TPU kernels over (rows, 1024) row tiles, the
// operands zero-padded to a multiple of 1024; fused_axpby_dot adds its
// partial into one revisited (1, 1) block, sound there only because TPU grid
// steps run in order).
//
// Bound on the H100: memory bytes: fused_axpby reads 3 vectors and writes 1,
// fused_axpby_dot reads 4 and writes 1, each once; 5 and 7 operations per
// element are far below the card's arithmetic rate.
//
// Design: stencil.cuh's flat pass, one grid-stride loop over the contiguous
// vectors (any n, no padding, no reshape), with a compile-time flag for the
// dot form.  a, b and c are read from device scalars of the vectors' dtype,
// so the host never waits for them.  The arithmetic is ((a x) + (b y)) +
// (c z), each product and sum rounded on its own (no FMA contraction), the
// plain PyTorch version's order, so the output equals it bitwise.  The dot
// form writes one partial slot per block (at most kFlatDotsBlocks, a function
// of n alone) and reduce_partials sums the slots in a fixed order: no
// atomics, bitwise reproducible.  Inputs may alias one another; the output is
// always a fresh buffer.
//
// bf16 (fused_axpby_bf16, fused_axpby_dot_bf16): vectors and the device
// scalars a, b and c in bf16 (the wrapper rounds them), each operation
// rounded to bf16 as the plain version's; the dot form's partial is an f32
// sum of f32 products (float slots and dot), as the reference's oracle
// computes it.  Bound: bytes at 2 B an element, 4 B the partial.
#include "stencil.cuh"

namespace {

using repro::acc_t;
using repro::add_rn;
using repro::flat_blocks;
using repro::kFlatDotsBlocks;
using repro::kFlatMaxBlocks;
using repro::kFlatThreads;
using repro::mul_rn;

// out = a x + b y + c z; with DOT also the block's partial of out·w at
// partials[block].  At least 6 blocks an SM, i.e. up to 40 registers a
// thread, which the f64 dot form takes without spilling: with the thread
// count alone ptxas held it to 32 registers and spilled (and with 8 blocks).
template <typename T, bool DOT>
__global__ void __launch_bounds__(kFlatThreads, 6)
axpby_kernel(const T* __restrict__ a_p, const T* __restrict__ b_p,
             const T* __restrict__ c_p, const T* __restrict__ x, const T* __restrict__ y,
             const T* __restrict__ z, const T* __restrict__ w, T* __restrict__ out,
             acc_t<T>* __restrict__ partials, int64_t n) {
  const T a = *a_p;
  const T b = *b_p;
  const T c = *c_p;
  acc_t<T> v[1] = {acc_t<T>(0)};
  const int64_t stride = (int64_t)gridDim.x * kFlatThreads;
  for (int64_t e = (int64_t)blockIdx.x * kFlatThreads + threadIdx.x; e < n; e += stride) {
    const T o = add_rn(add_rn(mul_rn(a, x[e]), mul_rn(b, y[e])), mul_rn(c, z[e]));
    out[e] = o;
    if constexpr (DOT) v[0] = add_rn(v[0], mul_rn(repro::to_acc(o), repro::to_acc(w[e])));
  }
  if constexpr (DOT) repro::store_flat_partials<acc_t<T>, 1>(v, partials);
}

template <typename T>
int launch_axpby(const void* a, const void* b, const void* c, const void* x, const void* y,
                 const void* z, void* out, long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  axpby_kernel<T, false><<<(unsigned)flat_blocks(n, kFlatMaxBlocks), kFlatThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(z), nullptr,
      static_cast<T*>(out), nullptr, (int64_t)n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_axpby_dot(const void* a, const void* b, const void* c, const void* x,
                     const void* y, const void* z, const void* w, void* out, void* partials,
                     void* dot, long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = flat_blocks(n, kFlatDotsBlocks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  axpby_kernel<T, true><<<(unsigned)blocks, kFlatThreads, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(z),
      static_cast<const T*>(w), static_cast<T*>(out), static_cast<acc_t<T>*>(partials),
      (int64_t)n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  repro::reduce_partials<acc_t<T>, 1><<<1, repro::kReduceThreads, 0, st>>>(
      static_cast<const acc_t<T>*>(partials), blocks, static_cast<acc_t<T>*>(dot));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_axpby_f64(const void* a, const void* b, const void* c, const void* x,
                    const void* y, const void* z, void* out, long long n, void* stream) {
  return launch_axpby<double>(a, b, c, x, y, z, out, n, stream);
}

int fused_axpby_f32(const void* a, const void* b, const void* c, const void* x,
                    const void* y, const void* z, void* out, long long n, void* stream) {
  return launch_axpby<float>(a, b, c, x, y, z, out, n, stream);
}

int fused_axpby_bf16(const void* a, const void* b, const void* c, const void* x,
                     const void* y, const void* z, void* out, long long n, void* stream) {
  return launch_axpby<__nv_bfloat16>(a, b, c, x, y, z, out, n, stream);
}

// Number of partial slots of fused_axpby_dot for n elements.
long long fused_axpby_dot_partials(long long n) {
  return n > 0 ? flat_blocks(n, kFlatDotsBlocks) : 0;
}

// out = a x + b y + c z and dot[0] = out·w over n elements.
int fused_axpby_dot_f64(const void* a, const void* b, const void* c, const void* x,
                        const void* y, const void* z, const void* w, void* out,
                        void* partials, void* dot, long long n, void* stream) {
  return launch_axpby_dot<double>(a, b, c, x, y, z, w, out, partials, dot, n, stream);
}

int fused_axpby_dot_f32(const void* a, const void* b, const void* c, const void* x,
                        const void* y, const void* z, const void* w, void* out,
                        void* partials, void* dot, long long n, void* stream) {
  return launch_axpby_dot<float>(a, b, c, x, y, z, w, out, partials, dot, n, stream);
}

// bf16 vectors and scalars; partials and dot are float.
int fused_axpby_dot_bf16(const void* a, const void* b, const void* c, const void* x,
                         const void* y, const void* z, const void* w, void* out,
                         void* partials, void* dot, long long n, void* stream) {
  return launch_axpby_dot<__nv_bfloat16>(a, b, c, x, y, z, w, out, partials, dot, n, stream);
}

}  // extern "C"
