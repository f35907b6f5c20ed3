// Kernel 1: y = A x for the 7- or 27-point HPCG stencil, optionally with the
// dot partial y·x in the same pass (fuse_dot).
//
// Replaces: src/repro/kernels/stencil_spmv.py, function stencil_spmv (the
// Pallas TPU kernel streaming z-slabs through an overlapping VMEM window).
//
// Bound on the H100: memory bytes.  One pass reads the padded x once and
// writes y once; the arithmetic (2 operations per stencil point) is far below
// the card's rate for either type.
//
// Design: threads run along z, the contiguous axis, so every warp loads and
// stores 32 consecutive elements; a thread walks 8 x-planes so its neighbour
// planes are reused from cache instead of read again from memory.  No shared
// memory tiling yet (the simple correct form first).  With fuse_dot the y·x
// partial of each block goes to a scratch slot and a second one-block kernel
// sums the slots in a fixed order: no atomics, bitwise reproducible.  See
// stencil.cuh.
#include "stencil.cuh"

extern "C" {

// Number of partial slots the fused-dot form needs in its scratch buffer.
long long stencil_spmv_partials(int nx, int ny, int nz) {
  return repro::stencil_num_blocks(nx, ny, nz);
}

int stencil_spmv_f64(const void* xp, void* y, void* partials, void* dot, int nx,
                     int ny, int nz, int npoint, double diag, double off,
                     int fuse_dot, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (fuse_dot)
    return repro::launch_stencil<double, 1>(
        static_cast<const double*>(xp), static_cast<double*>(y),
        static_cast<double*>(partials), static_cast<double*>(dot), nx, ny, nz,
        npoint, diag, off, s);
  return repro::launch_stencil<double, 0>(static_cast<const double*>(xp),
                                          static_cast<double*>(y), nullptr, nullptr,
                                          nx, ny, nz, npoint, diag, off, s);
}

int stencil_spmv_f32(const void* xp, void* y, void* partials, void* dot, int nx,
                     int ny, int nz, int npoint, double diag, double off,
                     int fuse_dot, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (fuse_dot)
    return repro::launch_stencil<float, 1>(
        static_cast<const float*>(xp), static_cast<float*>(y),
        static_cast<float*>(partials), static_cast<float*>(dot), nx, ny, nz,
        npoint, diag, off, s);
  return repro::launch_stencil<float, 0>(static_cast<const float*>(xp),
                                         static_cast<float*>(y), nullptr, nullptr,
                                         nx, ny, nz, npoint, diag, off, s);
}

}  // extern "C"
