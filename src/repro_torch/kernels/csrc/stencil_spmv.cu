// Kernel 1: y = A x for the 7- or 27-point HPCG stencil, optionally with the
// dot partial y·x in the same pass (fuse_dot).
//
// Replaces: src/repro/kernels/stencil_spmv.py, function stencil_spmv (the
// Pallas TPU kernel streaming z-slabs through an overlapping VMEM window).
//
// Bound on the H100: memory bytes.  One pass reads x once and writes y once.
// The arithmetic is not far below that: each of the 2·npoint − 1 operations
// a point is rounded on its own (no FMA), so they issue at the FP64 (FP32)
// instruction rate, half the FLOP/s peak; in f64 27pt that is about 64 % of
// the bytes bound.
//
// Design: the plane-ring pass of stencil.cuh (stencil_ring_kernel): a block
// marches a 64 × 4 (z, y) tile along x, in runs of ``run`` planes (8, 16 or
// 32: a launch argument, one kernel instance each, chosen per grid by
// kernels/autotune.py; another run launches nothing and returns
// cudaErrorInvalidValue), through a ring of plane tiles in shared memory
// filled by cp.async, so each output costs 9 shared-memory reads (5 in 7pt)
// instead of 27 (7) global loads.  x comes padded
// (zero_halo = 0, the reference's signature) or unpadded (zero_halo = 1),
// whose zero halo the kernel's zero-filled copies make, so the caller's pad
// pass goes.  With fuse_dot the y·x partial of each block goes to a scratch
// slot and a second one-block kernel sums the slots in a fixed order: no
// atomics, bitwise reproducible.
//
// The lane-batched form (stencil_spmv_batched_*, the vmapped Pallas call of
// the batched solve): B operands stacked on a leading axis, padded or
// unpadded, in one launch of the same pass, the lane folded into blockIdx.z
// (stencil.cuh); each lane's y is the one-lane launch's on it, bit for bit.
// It takes no fuse_dot (the batched solve's dots are per lane) and no run:
// it marches kRingRun planes.
//
// bf16 (stencil_spmv_bf16, stencil_spmv_batched_bf16): x and y in bf16, each
// operation rounded to bf16 as the plain version's; the fuse_dot partial is
// an f32 sum of f32 products (float partial slots and dot), as the
// reference's oracle computes it.  The ring copies the plane tiles as 4-byte
// bf16 pairs and sums two z-outputs a thread in bf16x2 (its pair stage) when
// nz is even and x 4-byte aligned, and stages them through registers
// otherwise (stencil_ring_stage says which).  Bound: bytes at 2 B an
// element, 4 B the partial.  f32 copies elements (kStageAsync): f32's pair
// stage serves precond.cu's two tails, not this source's.
#include "stencil.cuh"

namespace {

using repro::acc_t;

template <typename T>
int launch(const void* x, void* y, void* partials, void* dot, int nx, int ny, int nz,
           int npoint, double diag, double off, int fuse_dot, int zero_halo, int run,
           cudaStream_t s, int lanes = 1) {
  const T* xi = static_cast<const T*>(x);
  T* yo = static_cast<T*>(y);
  if (fuse_dot)
    return repro::launch_stencil_ring<T>(xi, zero_halo, repro::SpmvTail<T, 1>{yo},
                                         static_cast<acc_t<T>*>(partials),
                                         static_cast<acc_t<T>*>(dot), nx, ny, nz, npoint,
                                         diag, off, s, 1, run);
  return repro::launch_stencil_ring<T>(xi, zero_halo, repro::SpmvTail<T, 0>{yo}, nullptr,
                                       nullptr, nx, ny, nz, npoint, diag, off, s, lanes, run);
}

}  // namespace

extern "C" {

// The stage the ring pass takes (ring_stage in stencil.cuh) for an operand
// of ``elem_bytes``-byte elements (8, 4 or 2) at ``x`` with nz points along
// z, padded (zero_halo = 0) or not, with a tail that takes f32's pair stage
// (pair_tail = 1: ChebTail, JacobiTail, f32_pair_tail) or not (0: every
// other tail, this source's among them): kStageAsync (0), kStageRegister
// (1), kStagePairPadded (2) or kStagePairUnpadded (3); -1 for another
// element size.  A pair tail's own streams may move it further
// (ring_tail_stage).
int stencil_ring_stage(int elem_bytes, int nz, int zero_halo, const void* x, int pair_tail) {
  switch (elem_bytes) {
    case 8:
      return repro::ring_stage<double, repro::SpmvTail<double, 0>>(nz, zero_halo, x);
    case 4:
      return pair_tail ? repro::ring_stage<float, repro::JacobiTail<float>>(nz, zero_halo, x)
                       : repro::ring_stage<float, repro::SpmvTail<float, 0>>(nz, zero_halo, x);
    case 2:
      return repro::ring_stage<__nv_bfloat16, repro::SpmvTail<__nv_bfloat16, 0>>(nz, zero_halo,
                                                                                x);
    default:
      return -1;
  }
}

// Number of partial slots the fused-dot form needs in its scratch buffer in
// runs of ``run`` planes; -1 for a run with no instance.
long long stencil_spmv_partials(int nx, int ny, int nz, int run) {
  return repro::stencil_ring_num_blocks(nx, ny, nz, run);
}

int stencil_spmv_f64(const void* x, void* y, void* partials, void* dot, int nx, int ny,
                     int nz, int npoint, double diag, double off, int fuse_dot,
                     int zero_halo, int run, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return launch<double>(x, y, partials, dot, nx, ny, nz, npoint, diag, off, fuse_dot,
                        zero_halo, run, s);
}

int stencil_spmv_f32(const void* x, void* y, void* partials, void* dot, int nx, int ny,
                     int nz, int npoint, double diag, double off, int fuse_dot,
                     int zero_halo, int run, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return launch<float>(x, y, partials, dot, nx, ny, nz, npoint, diag, off, fuse_dot,
                       zero_halo, run, s);
}

// bf16 x and y; partials and dot are float.
int stencil_spmv_bf16(const void* x, void* y, void* partials, void* dot, int nx, int ny,
                      int nz, int npoint, double diag, double off, int fuse_dot,
                      int zero_halo, int run, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return launch<__nv_bfloat16>(x, y, partials, dot, nx, ny, nz, npoint, diag, off, fuse_dot,
                               zero_halo, run, s);
}

// y = A x on each of ``lanes`` stacked operands: x is (lanes, nx+2, ny+2,
// nz+2) padded or, with zero_halo, (lanes, nx, ny, nz); y is (lanes, nx, ny,
// nz).  A grid beyond the launch limits returns cudaErrorInvalidValue.
int stencil_spmv_batched_f64(const void* x, void* y, int lanes, int nx, int ny, int nz,
                             int npoint, double diag, double off, int zero_halo,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return launch<double>(x, y, nullptr, nullptr, nx, ny, nz, npoint, diag, off, 0, zero_halo,
                        repro::kRingRun, s, lanes);
}

int stencil_spmv_batched_f32(const void* x, void* y, int lanes, int nx, int ny, int nz,
                             int npoint, double diag, double off, int zero_halo,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return launch<float>(x, y, nullptr, nullptr, nx, ny, nz, npoint, diag, off, 0, zero_halo,
                       repro::kRingRun, s, lanes);
}

int stencil_spmv_batched_bf16(const void* x, void* y, int lanes, int nx, int ny, int nz,
                              int npoint, double diag, double off, int zero_halo,
                              void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return launch<__nv_bfloat16>(x, y, nullptr, nullptr, nx, ny, nz, npoint, diag, off, 0,
                               zero_halo, repro::kRingRun, s, lanes);
}

}  // extern "C"
