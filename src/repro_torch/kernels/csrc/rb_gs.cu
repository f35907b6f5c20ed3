// Kernel 15: one red-black Gauss-Seidel half-sweep (paper §3.4), one stencil
// pass from the halo-padded old iterate xp:
//   x'[i,j,k] = (b − (A − D) x)[i,j,k] / diag   where (i + j + k) mod 2 == colour
//   x'[i,j,k] = x[i,j,k]                         elsewhere
// with i, j, k global interior indices.
//
// Replaces: src/repro/kernels/rb_gs.py, function rb_gs_half_sweep (a Pallas
// TPU kernel on the stencil_spmv z-slab window, its parity mask built from
// iotas plus the grid step's z offset, the colour a static specialisation).
//
// Bound on the H100: memory bytes.  It reads the padded xp and b once and
// writes x' once (npad + 2n elements); the 2·npoint operations per point are
// far below the card's arithmetic rate.
//
// Design: the stencil pass of stencil.cuh (threads along z, 8 x-planes per
// thread) in its off-diagonal form, apply_point with the centre left out and
// the offsets summed from 0 in Stencil.offsets order (what
// Stencil.offdiag_apply_padded computes; A·x − diag·x would round
// differently), with RbGsTail as the per-point epilogue.  The kernel knows
// each point's global (i, j, k), so the parity needs no mask array.  The
// colour is a launch argument (0 or 1, checked).  The division by diag is a
// multiply by its reciprocal computed in T on the host: what eager PyTorch
// does on CUDA for a tensor divided by a Python number, so the output equals
// the plain version's bitwise on the card; against the CPU's true division it
// differs by at most an ulp per updated point.  The output is a fresh buffer.
#include "stencil.cuh"

namespace {

template <typename T>
int half_sweep(const void* xp, const void* b, void* x_out, int nx, int ny, int nz,
               int npoint, double diag, double off, int colour, void* stream) {
  if (colour != 0 && colour != 1) return (int)cudaErrorInvalidValue;
  const repro::RbGsTail<T> tail{static_cast<const T*>(b), static_cast<T*>(x_out),
                                T(1) / static_cast<T>(diag), colour};
  return repro::launch_stencil<T>(static_cast<const T*>(xp), tail, nullptr, nullptr, nx, ny,
                                  nz, npoint, diag, off, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

int rb_gs_half_sweep_f64(const void* xp, const void* b, void* x_out, int nx, int ny, int nz,
                         int npoint, double diag, double off, int colour, void* stream) {
  return half_sweep<double>(xp, b, x_out, nx, ny, nz, npoint, diag, off, colour, stream);
}

int rb_gs_half_sweep_f32(const void* xp, const void* b, void* x_out, int nx, int ny, int nz,
                         int npoint, double diag, double off, int colour, void* stream) {
  return half_sweep<float>(xp, b, x_out, nx, ny, nz, npoint, diag, off, colour, stream);
}

}  // extern "C"
