// Kernel 2: merged CG's SpMV with both dot partials in one pass,
// (A x, (A x)·x, x·x).
//
// Replaces: src/repro/kernels/spmv_dot.py, function stencil_spmv_dots (the
// Pallas TPU kernel that accumulates both partials into one revisited block,
// sound there only because TPU grid steps run in order).
//
// Bound on the H100: memory bytes.  It moves the same bytes as kernel 1 (the
// padded x read once, y written once); the two extra products per point are
// far below the card's arithmetic rate.
//
// Design: kernel 1's pass (threads along z, 8 x-planes per thread) with two
// per-block partials written to scratch slots, then a one-block kernel sums
// the slots in a fixed order.  GPU blocks run in no order, so the partials
// never share an accumulator: no atomics, bitwise reproducible.  See
// stencil.cuh.
#include "stencil.cuh"

extern "C" {

// Number of partial slots per dot product; the scratch holds two of them.
long long spmv_dots_partials(int nx, int ny, int nz) {
  return repro::stencil_num_blocks(nx, ny, nz);
}

// dots[0] = (A x)·x, dots[1] = x·x.
int spmv_dots_f64(const void* xp, void* y, void* partials, void* dots, int nx, int ny,
                  int nz, int npoint, double diag, double off, void* stream) {
  return repro::launch_stencil<double, 2>(
      static_cast<const double*>(xp), static_cast<double*>(y),
      static_cast<double*>(partials), static_cast<double*>(dots), nx, ny, nz, npoint,
      diag, off, static_cast<cudaStream_t>(stream));
}

int spmv_dots_f32(const void* xp, void* y, void* partials, void* dots, int nx, int ny,
                  int nz, int npoint, double diag, double off, void* stream) {
  return repro::launch_stencil<float, 2>(
      static_cast<const float*>(xp), static_cast<float*>(y),
      static_cast<float*>(partials), static_cast<float*>(dots), nx, ny, nz, npoint,
      diag, off, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
