// Kernels 16 and 17: the preconditioner sweeps, each one stencil pass with an
// elementwise tail and no partials:
//   cheb_fused_step     d' = a·d + c·(r − A z),  z' = z + d'
//   block_jacobi_sweep  z' = z + ω·(r − A z)/diag
// both from the halo-padded z (zero-padded for block-Jacobi).
//
// Replaces: src/repro/kernels/precond.py, functions cheb_fused_step and
// block_jacobi_sweep (Pallas TPU kernels on the stencil_spmv z-slab window,
// with a, c and ω baked in as compile-time constants).
//
// Bound on the H100: memory bytes.  cheb_fused_step reads the padded z and
// the unpadded r and d once and writes z' and d' once; block_jacobi_sweep
// reads the padded z and r and writes z'.  The few operations per point on
// top of the stencil are far below the card's arithmetic rate.
//
// Design: the stencil pass of stencil.cuh (threads along z, 8 x-planes per
// thread) with ChebTail / JacobiTail as the per-point epilogue, so A z never
// goes to memory.  a, c and ω are launch arguments rather than constants
// (one build serves every Chebyshev schedule); each is cast to T first, so a
// float32 solve multiplies in float32 as eager PyTorch does.  Outputs are
// always fresh buffers: Chebyshev's first step is called with d and z the
// same tensor, so nothing is written in place over an input.
//
// The division by diag: eager PyTorch on CUDA computes a tensor divided by a
// Python number as a multiply by the reciprocal (rounded in T), while on the
// CPU it divides.  This kernel takes the CUDA form, 1/diag computed in T on
// the host, so it follows the plain version on the card; against the CPU's
// division it differs by at most an ulp per point (the tolerance of the
// tests).
#include "stencil.cuh"

namespace {

template <typename T>
int cheb(const void* zp, const void* r, const void* d, void* z_out, void* d_out, int nx,
         int ny, int nz, int npoint, double diag, double off, double a, double c,
         void* stream) {
  const repro::ChebTail<T> tail{static_cast<const T*>(r), static_cast<const T*>(d),
                                static_cast<T*>(z_out), static_cast<T*>(d_out),
                                static_cast<T>(a), static_cast<T>(c)};
  return repro::launch_stencil<T>(static_cast<const T*>(zp), tail, nullptr, nullptr, nx, ny,
                                  nz, npoint, diag, off, static_cast<cudaStream_t>(stream));
}

template <typename T>
int jacobi(const void* zp, const void* r, void* z_out, int nx, int ny, int nz, int npoint,
           double diag, double off, double omega, void* stream) {
  const T inv_diag = T(1) / static_cast<T>(diag);
  const repro::JacobiTail<T> tail{static_cast<const T*>(r), static_cast<T*>(z_out),
                                  static_cast<T>(omega), inv_diag};
  return repro::launch_stencil<T>(static_cast<const T*>(zp), tail, nullptr, nullptr, nx, ny,
                                  nz, npoint, diag, off, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

int cheb_step_f64(const void* zp, const void* r, const void* d, void* z_out, void* d_out,
                  int nx, int ny, int nz, int npoint, double diag, double off, double a,
                  double c, void* stream) {
  return cheb<double>(zp, r, d, z_out, d_out, nx, ny, nz, npoint, diag, off, a, c, stream);
}

int cheb_step_f32(const void* zp, const void* r, const void* d, void* z_out, void* d_out,
                  int nx, int ny, int nz, int npoint, double diag, double off, double a,
                  double c, void* stream) {
  return cheb<float>(zp, r, d, z_out, d_out, nx, ny, nz, npoint, diag, off, a, c, stream);
}

int jacobi_sweep_f64(const void* zp, const void* r, void* z_out, int nx, int ny, int nz,
                     int npoint, double diag, double off, double omega, void* stream) {
  return jacobi<double>(zp, r, z_out, nx, ny, nz, npoint, diag, off, omega, stream);
}

int jacobi_sweep_f32(const void* zp, const void* r, void* z_out, int nx, int ny, int nz,
                     int npoint, double diag, double off, double omega, void* stream) {
  return jacobi<float>(zp, r, z_out, nx, ny, nz, npoint, diag, off, omega, stream);
}

}  // extern "C"
