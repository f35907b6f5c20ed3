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
// Design: in f64 27pt and in bf16 (both stencils), the plane-ring pass of
// stencil.cuh (stencil_ring_kernel: a 64 × 4 (z, y) tile marched along x
// through a cp.async ring of plane tiles in shared memory; 9 shared-memory
// reads an output in place of 27 global loads) in its off-diagonal form, in
// runs of kRingRunRbGs = 8 planes (16 for the ring's SpMV tails: 8 measured
// faster for this one at both 128³ and 128×128×3072),
// from the padded operand only (zero_halo = 0, the reference API's
// contract): each output's sum starts from 0 and runs over the offsets in
// Stencil.offsets order with the centre left out, split at a plane boundary
// (ring_first, ring_last), which is what Stencil.offdiag_apply_padded
// computes (A·x − diag·x would round differently).  RbGsTail is the
// per-point epilogue; the ring knows each point's global (i, j, k) =
// (i0 + s, j, k), so the parity needs no mask array, and the centre x it
// keeps is the ring's own centre value (no extra read); b is prefetched a
// step ahead.  No partials, one lane, no atomics.  bf16 runs on the ring's
// pair stage where xp, b and the output allow it (nz even, each 4-byte
// aligned; else its register stage): xp copied as 4-byte bf16 pairs, two
// z-outputs a thread summed in bf16x2, and RbGsTail's pair form takes both
// in one call, b loaded and x' stored as one pair; the two lanes have
// opposite parities, so one takes the update and the other keeps x.
//
// A static rule, not a runtime choice (on_ring): f64 7pt and both f32
// stencils stay on the old pass, stencil_kernel (one output per thread, the
// same off-diagonal sum from apply_point<T, NPT, true>), where the ring lost
// at both 128³ and 128×128×3072 (chip_stencil_variants.py; PERF.md §6).
//
// The colour is a launch argument (0 or 1, checked).  The division by diag
// is a multiply by its reciprocal computed in T on the host: what eager
// PyTorch does on CUDA for a tensor divided by a Python number, so the
// output equals the plain version's bitwise on the card; against the CPU's
// true division it differs by at most an ulp per updated point.  The output
// is a fresh buffer.
//
// bf16 (rb_gs_half_sweep_bf16): xp, b and the output in bf16, each operation
// rounded to bf16 as the plain version's; the reciprocal of diag is formed
// in f32 and the product rounded once to bf16 (scale_rn), as eager PyTorch
// divides a bf16 tensor by a Python number on CUDA.  bf16 runs on the ring
// (on_ring, above).  Bound: bytes at 2 B an element.
#include "stencil.cuh"

namespace {

// Whether the (T, npoint) pair runs on the ring pass (else on stencil_kernel):
// f64 27pt, and bf16 in both stencils.
template <typename T>
constexpr bool on_ring(int npoint) {
  return (std::is_same<T, double>::value && npoint == 27) ||
         std::is_same<T, __nv_bfloat16>::value;
}

template <typename T>
int half_sweep(const void* xp, const void* b, void* x_out, int nx, int ny, int nz,
               int npoint, double diag, double off, int colour, void* stream) {
  if (colour != 0 && colour != 1) return (int)cudaErrorInvalidValue;
  using A = repro::acc_t<T>;
  const repro::RbGsTail<T> tail{static_cast<const T*>(b), static_cast<T*>(x_out),
                                A(1) / static_cast<A>(diag), colour};
  const T* x = static_cast<const T*>(xp);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (on_ring<T>(npoint))
    return repro::launch_stencil_ring<T>(x, 0, tail, nullptr, nullptr, nx, ny, nz, npoint, diag,
                                         off, s);
  return repro::launch_stencil<T>(x, tail, nullptr, nullptr, nx, ny, nz, npoint, diag, off, s);
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

int rb_gs_half_sweep_bf16(const void* xp, const void* b, void* x_out, int nx, int ny, int nz,
                          int npoint, double diag, double off, int colour, void* stream) {
  return half_sweep<__nv_bfloat16>(xp, b, x_out, nx, ny, nz, npoint, diag, off, colour,
                                   stream);
}

}  // extern "C"
