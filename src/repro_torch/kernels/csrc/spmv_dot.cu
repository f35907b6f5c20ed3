// Kernels 2 and 4: the SpMV with the merged methods' dot partials in the
// same pass:
//   stencil_spmv_dots   (A x, (A x)·x, x·x)          merged CG
//   stencil_spmv_dots3  (A x, (A x)·x, r·x, r·r)     merged PCG (x = u = M⁻¹r)
//
// Replaces: src/repro/kernels/spmv_dot.py, functions stencil_spmv_dots and
// stencil_spmv_dots3 (the Pallas TPU kernels that accumulate the partials
// into one revisited block, sound there only because TPU grid steps run in
// order).
//
// Bound on the H100: memory bytes.  stencil_spmv_dots moves the bytes of
// kernel 1 (the padded x read once, y written once); stencil_spmv_dots3 also
// reads the unpadded r once.  The extra products per point are far below the
// card's arithmetic rate.
//
// Design: kernel 1's pass (threads along z, 8 x-planes per thread) with the
// per-block partials written to scratch slots, then a one-block kernel sums
// the slots in a fixed order.  GPU blocks run in no order, so the partials
// never share an accumulator: no atomics, bitwise reproducible.  r is read
// at the unpadded index of the point, xp at the padded one (see stencil.cuh).
#include "stencil.cuh"

extern "C" {

// Number of partial slots per dot product; the scratch holds two (dots) or
// three (dots3) of them.
long long spmv_dots_partials(int nx, int ny, int nz) {
  return repro::stencil_num_blocks(nx, ny, nz);
}

// dots[0] = (A x)·x, dots[1] = x·x.
int spmv_dots_f64(const void* xp, void* y, void* partials, void* dots, int nx, int ny,
                  int nz, int npoint, double diag, double off, void* stream) {
  return repro::launch_stencil<double>(
      static_cast<const double*>(xp), repro::SpmvTail<double, 2>{static_cast<double*>(y)},
      static_cast<double*>(partials), static_cast<double*>(dots), nx, ny, nz, npoint,
      diag, off, static_cast<cudaStream_t>(stream));
}

int spmv_dots_f32(const void* xp, void* y, void* partials, void* dots, int nx, int ny,
                  int nz, int npoint, double diag, double off, void* stream) {
  return repro::launch_stencil<float>(
      static_cast<const float*>(xp), repro::SpmvTail<float, 2>{static_cast<float*>(y)},
      static_cast<float*>(partials), static_cast<float*>(dots), nx, ny, nz, npoint,
      diag, off, static_cast<cudaStream_t>(stream));
}

// dots[0] = (A x)·x, dots[1] = r·x, dots[2] = r·r; r is (nx, ny, nz).
int spmv_dots3_f64(const void* xp, const void* r, void* y, void* partials, void* dots,
                   int nx, int ny, int nz, int npoint, double diag, double off,
                   void* stream) {
  return repro::launch_stencil<double>(
      static_cast<const double*>(xp),
      repro::Dots3Tail<double>{static_cast<double*>(y), static_cast<const double*>(r)},
      static_cast<double*>(partials), static_cast<double*>(dots), nx, ny, nz, npoint,
      diag, off, static_cast<cudaStream_t>(stream));
}

int spmv_dots3_f32(const void* xp, const void* r, void* y, void* partials, void* dots,
                   int nx, int ny, int nz, int npoint, double diag, double off,
                   void* stream) {
  return repro::launch_stencil<float>(
      static_cast<const float*>(xp),
      repro::Dots3Tail<float>{static_cast<float*>(y), static_cast<const float*>(r)},
      static_cast<float*>(partials), static_cast<float*>(dots), nx, ny, nz, npoint,
      diag, off, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
