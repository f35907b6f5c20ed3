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

namespace {

template <typename T>
int launch(const void* xp, void* y, void* partials, void* dot, int nx, int ny, int nz,
           int npoint, double diag, double off, int fuse_dot, cudaStream_t s) {
  const T* x = static_cast<const T*>(xp);
  T* yo = static_cast<T*>(y);
  if (fuse_dot)
    return repro::launch_stencil<T>(x, repro::SpmvTail<T, 1>{yo}, static_cast<T*>(partials),
                                    static_cast<T*>(dot), nx, ny, nz, npoint, diag, off, s);
  return repro::launch_stencil<T>(x, repro::SpmvTail<T, 0>{yo}, nullptr, nullptr, nx, ny, nz,
                                  npoint, diag, off, s);
}

}  // namespace

extern "C" {

// Number of partial slots the fused-dot form needs in its scratch buffer.
long long stencil_spmv_partials(int nx, int ny, int nz) {
  return repro::stencil_num_blocks(nx, ny, nz);
}

int stencil_spmv_f64(const void* xp, void* y, void* partials, void* dot, int nx,
                     int ny, int nz, int npoint, double diag, double off,
                     int fuse_dot, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return launch<double>(xp, y, partials, dot, nx, ny, nz, npoint, diag, off, fuse_dot, s);
}

int stencil_spmv_f32(const void* xp, void* y, void* partials, void* dot, int nx,
                     int ny, int nz, int npoint, double diag, double off,
                     int fuse_dot, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return launch<float>(xp, y, partials, dot, nx, ny, nz, npoint, diag, off, fuse_dot, s);
}

}  // extern "C"
