// Shared device code of the stencil kernels (stencil_spmv.cu, spmv_dot.cu,
// precond.cu).
//
// Layout: the halo-padded operand xp is (nx+2, ny+2, nz+2) row-major, z
// contiguous; every unpadded operand and output is (nx, ny, nz).  A block is
// kBlockZ threads along z (coalesced loads and stores) by kBlockY rows along
// y; each thread walks kPlanesX consecutive x-planes, so the two neighbour
// planes it reads for one output are the planes it reads for the next, and
// they come from L1/L2.  The kernel masks the ragged edges itself, so any
// (nx, ny, nz) works.
//
// One kernel, stencil_kernel, serves every stencil pass: it computes y = A x
// at each point and hands (flat unpadded index e, centre value x[e], y) to a
// Tail, which stores y or the elementwise update built on it and adds to the
// block's dot partials.  xp is indexed with the padded strides, the Tail's
// operands with the unpadded index e.
//
// Arithmetic: centre term first, then the offsets in Stencil.offsets order,
// with one rounding per multiply and per add (no FMA contraction), which is
// exactly what the plain PyTorch version computes.  The tails round each
// operation on its own too, in the plain version's order.
//
// Dot partials: each block writes its sums to its own slot of a scratch
// buffer, and reduce_partials sums the slots in a fixed order.  No atomics,
// so two runs on the same input give bitwise-equal scalars.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

// The grid of the stencil pass; its block count is the number of partial
// slots per dot product.
inline dim3 stencil_grid(int nx, int ny, int nz) {
  return dim3((nz + kBlockZ - 1) / kBlockZ, (ny + kBlockY - 1) / kBlockY,
              (nx + kPlanesX - 1) / kPlanesX);
}

inline bool stencil_grid_ok(int nx, int ny, int nz) {
  dim3 g = stencil_grid(nx, ny, nz);
  return nx > 0 && ny > 0 && nz > 0 && g.y <= 65535u && g.z <= 65535u;
}

inline long long stencil_num_blocks(int nx, int ny, int nz) {
  dim3 g = stencil_grid(nx, ny, nz);
  return (long long)g.x * g.y * g.z;
}

// y at one interior point; c is the centre's flat index in xp, sx and sy its
// x and y strides.
template <typename T, int NPT>
__device__ __forceinline__ T apply_point(const T* __restrict__ xp, int64_t c,
                                         int64_t sx, int64_t sy, T diag, T off) {
  T acc = mul_rn(diag, xp[c]);
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
// of y·x and x·x.
template <typename T, int NDOT>
struct SpmvTail {
  static constexpr int kDots = NDOT;
  T* __restrict__ y;
  __device__ __forceinline__ void operator()(int64_t e, T xc, T yv, T* v) const {
    y[e] = yv;
    if constexpr (NDOT >= 1) v[0] = add_rn(v[0], mul_rn(yv, xc));
    if constexpr (NDOT >= 2) v[1] = add_rn(v[1], mul_rn(xc, xc));
  }
};

// y = A x and the partials of y·x, r·x and r·r, with r unpadded.
template <typename T>
struct Dots3Tail {
  static constexpr int kDots = 3;
  T* __restrict__ y;
  const T* __restrict__ r;
  __device__ __forceinline__ void operator()(int64_t e, T xc, T yv, T* v) const {
    const T re = r[e];
    y[e] = yv;
    v[0] = add_rn(v[0], mul_rn(yv, xc));
    v[1] = add_rn(v[1], mul_rn(re, xc));
    v[2] = add_rn(v[2], mul_rn(re, re));
  }
};

// One Chebyshev step: d' = a·d + c·(r − A z), z' = z + d' (x is z here).
template <typename T>
struct ChebTail {
  static constexpr int kDots = 0;
  const T* __restrict__ r;
  const T* __restrict__ d;
  T* __restrict__ z_out;
  T* __restrict__ d_out;
  T a, c;
  __device__ __forceinline__ void operator()(int64_t e, T zc, T az, T*) const {
    const T dn = add_rn(mul_rn(a, d[e]), mul_rn(c, sub_rn(r[e], az)));
    d_out[e] = dn;
    z_out[e] = add_rn(zc, dn);
  }
};

// One damped Jacobi sweep: z' = z + (ω·(r − A z))·(1/diag) (x is z here).
// The division by diag is a multiply by its reciprocal, rounded in T: what
// eager PyTorch does on CUDA for a tensor divided by a Python number.
template <typename T>
struct JacobiTail {
  static constexpr int kDots = 0;
  const T* __restrict__ r;
  T* __restrict__ z_out;
  T omega, inv_diag;
  __device__ __forceinline__ void operator()(int64_t e, T zc, T az, T*) const {
    z_out[e] = add_rn(zc, mul_rn(mul_rn(omega, sub_rn(r[e], az)), inv_diag));
  }
};

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

// The stencil pass: y = A x from the padded x at every point, handed to the
// tail; the tail's Tail::kDots partials are stored at
// partials[d * nblocks + block].
template <typename T, int NPT, typename Tail>
__global__ void __launch_bounds__(kThreads)
stencil_kernel(const T* __restrict__ xp, Tail tail, T* __restrict__ partials,
               int nx, int ny, int nz, T diag, T off) {
  constexpr int NDOT = Tail::kDots;
  const int k = blockIdx.x * kBlockZ + threadIdx.x;
  const int j = blockIdx.y * kBlockY + threadIdx.y;
  const int i0 = blockIdx.z * kPlanesX;
  const int64_t sy = nz + 2;
  const int64_t sx = (int64_t)(ny + 2) * sy;
  T v[NDOT > 0 ? NDOT : 1];
#pragma unroll
  for (int d = 0; d < (NDOT > 0 ? NDOT : 1); ++d) v[d] = T(0);
  if (k < nz && j < ny) {
    const int i1 = min(i0 + kPlanesX, nx);
    for (int i = i0; i < i1; ++i) {
      const int64_t c = (int64_t)(i + 1) * sx + (int64_t)(j + 1) * sy + (k + 1);
      const T yv = apply_point<T, NPT>(xp, c, sx, sy, diag, off);
      tail(((int64_t)i * ny + j) * nz + k, xp[c], yv, v);
    }
  }
  if constexpr (NDOT > 0) {
    // every thread of the block takes part, in range or not
    const int tid = threadIdx.y * kBlockZ + threadIdx.x;
    block_sum<T, NDOT, kThreads>(v, tid);
    if (tid == 0) {
      const int64_t nb = (int64_t)gridDim.x * gridDim.y * gridDim.z;
      const int64_t b = ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
#pragma unroll
      for (int d = 0; d < NDOT; ++d) partials[d * nb + b] = v[d];
    }
  }
}

// out[d] = sum of partials[d * nblocks + b] over b, in a fixed order: thread t
// sums slots t, t + 1024, ... in turn, then the block sums the threads.
template <typename T, int NDOT>
__global__ void __launch_bounds__(kReduceThreads)
reduce_partials(const T* __restrict__ partials, int64_t nblocks, T* __restrict__ out) {
  const int tid = threadIdx.x;
  T v[NDOT];
#pragma unroll
  for (int d = 0; d < NDOT; ++d) {
    v[d] = T(0);
    for (int64_t b = tid; b < nblocks; b += kReduceThreads) v[d] += partials[d * nblocks + b];
  }
  block_sum<T, NDOT, kReduceThreads>(v, tid);
  if (tid == 0) {
#pragma unroll
    for (int d = 0; d < NDOT; ++d) out[d] = v[d];
  }
}

// Launch the stencil pass with ``tail`` and, when the tail has partials, the
// fixed-order reduction of them into dots[0..Tail::kDots).  Returns
// cudaGetLastError().
template <typename T, typename Tail>
int launch_stencil(const T* xp, Tail tail, T* partials, T* dots, int nx, int ny, int nz,
                   int npoint, double diag, double off, cudaStream_t stream) {
  if (!stencil_grid_ok(nx, ny, nz) || (npoint != 7 && npoint != 27))
    return (int)cudaErrorInvalidValue;
  const dim3 grid = stencil_grid(nx, ny, nz);
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
    reduce_partials<T, Tail::kDots><<<1, kReduceThreads, 0, stream>>>(
        partials, (int64_t)stencil_num_blocks(nx, ny, nz), dots);
  }
  return (int)cudaGetLastError();
}

}  // namespace repro
