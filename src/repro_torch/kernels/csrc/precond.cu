// Kernels 16 and 17: the preconditioner sweeps, each one stencil pass with an
// elementwise tail and no partials:
//   cheb_fused_step     d' = a·d + c·(r − A z),  z' = z + d'
//   block_jacobi_sweep  z' = z + ω·(r − A z)/diag
// both from z, halo-padded (zero-padded for block-Jacobi) or, where the halo
// is the zero pad, unpadded (zero_halo = 1: the kernel makes the halo, so the
// caller's pad pass goes).
//
// Replaces: src/repro/kernels/precond.py, functions cheb_fused_step and
// block_jacobi_sweep (Pallas TPU kernels on the stencil_spmv z-slab window,
// with a, c and ω baked in as compile-time constants).
//
// Bound on the H100: memory bytes.  cheb_fused_step reads z and the
// unpadded r and d once and writes z' and d' once; block_jacobi_sweep reads
// z and r and writes z' (z padded or not: the padded form reads the halo
// too).  The operations are not far below that: each is rounded on its own
// (no FMA), so they issue at the FP64 (FP32) instruction rate, half the
// FLOP/s peak; in f64 27pt that is about 28 % (cheb_fused_step) and 46 %
// (block_jacobi_sweep) of the bytes bound.
//
// Design: the plane-ring pass of stencil.cuh with ChebTail / JacobiTail as
// the per-point epilogue, so A z never goes to memory, in runs of
// kRingRunCheb and kRingRunJacobi planes (each chosen from the runs
// chip_stencil_variants.py times for it), one lane or B in one launch, from
// z padded (zero_halo = 0; on a mesh its halo holds the neighbours' planes,
// read as they are) or unpadded (zero_halo = 1; the zero-filled copies make
// the halo).  The ring reads each element of z once from global memory where
// the old pass (stencil_kernel: threads along z, 8 x-planes per thread, 27
// (7) loads a point) issues a load a term; r (and d) are prefetched a step
// ahead.  f64 copies elements (kStageAsync: 8-byte cp.async, kRingDepth − 2
// planes ahead, one output a thread, apply_point's order, so every f64
// output is the plain version's and the old pass's, bit for bit).  bf16 and
// f32 take the ring's pair stage: cp.async of element pairs (4 bytes in
// bf16, 8 in f32), two z-outputs a thread (bf16x2 sums in bf16, two scalar
// chains a lane in f32, an fma a term where off is ±1), the tails' pair
// forms loading r (and d) and storing z' (and d') as pairs, both outputs of
// a thread in one call (stencil.cuh's pair_tail; in bf16 the Chebyshev
// tail's alone, bf16's Jacobi tail takes them in two scalar calls).  bf16
// takes the ring at every shape (its register stage where nz is odd or a
// stream at an odd element offset); f32 only at the pair stage (nz even, z,
// r, d and the outputs 8-byte aligned) and, for the Chebyshev step, on the
// 27pt stencil, and keeps stencil_kernel, its code and its bits, otherwise
// (the rule on_ring).  A launch on stencil_kernel takes a padded z alone: the
// wrapper pads an unpadded one first.
// a, c and ω are launch arguments rather than constants
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
//
// The lane-batched forms (cheb_step_batched_*, jacobi_sweep_batched_*, the
// vmapped Pallas calls of the batched solve): B stacked operands, z (B,
// nx+2, ny+2, nz+2) padded or (B, nx, ny, nz) unpadded and (B, nx, ny, nz)
// r, d and outputs, in one launch of the same pass, the lane folded into
// blockIdx.z (stencil.cuh); each lane's outputs are the one-lane launch's on
// it, bit for bit.
//
// bf16 (the _bf16 entry points, the lane-batched ones included): z, r, d and
// the outputs in bf16, each operation rounded to bf16 as the plain
// version's.  a, c and ω arrive as double and are rounded to bf16 here (the
// wrapper has rounded them already, as the reference's weakly typed Python
// floats are); 1/diag is formed in f32 and each product with it rounded once
// to bf16 (scale_rn), as eager PyTorch divides a bf16 tensor by a Python
// number on CUDA.  Bound: bytes at 2 B an element.  The bf16 forms of both
// kernels are on the ring pass (above).
//
// f32 (the _f32 entry points, the lane-batched ones included): on the ring's
// pair stage where on_ring says so, each lane of a pair a scalar f32 chain in
// the old pass's order (fmaf where off is ±1: off·x exact, the same bits), so
// every f32 output is the old pass's, bit for bit.
#include "stencil.cuh"

namespace {

// Whether a launch of cheb_fused_step or block_jacobi_sweep with ``tail`` in
// T on z (padded, or unpadded with zero_halo) runs on the plane-ring pass
// (else on stencil_kernel): bf16 and f64 always; f32 where it takes the
// ring's pair stage (ring_tail_stage: nz even, z and the tail's streams
// 8-byte aligned), but not the Chebyshev step on the 7pt stencil, where the
// pair stage lost to the old pass at 128³ and at 128×128×3072
// (chip_stencil_variants.py --f32), so that every other f32 launch keeps the
// old pass's code and bits.  f64 on its element stage from z unpadded took
// 0.0319 / 0.0264 ms (Chebyshev / Jacobi, 27pt, 128³) where the old pass
// behind its pad took 0.0536 / 0.0467, 40 % less in every case timed (both
// stencils, 128³ and 128×128×3072, one lane and B = 4, 8;
// chip_stencil_variants.py --f64); from the padded z it is within 1 % of
// the old pass or faster everywhere but the one-lane 7pt Chebyshev step at
// 128³ (6 % slower) and the one-lane 27pt Jacobi sweep at 128×128×3072 (3 %;
// no solve launches that form), neither slower at both sizes, so every f64
// launch takes the ring.
template <typename T, typename Tail>
bool on_ring(const T* z, int zero_halo, const Tail& tail, int nz, int npoint) {
  if constexpr (std::is_same<T, float>::value)
    return repro::pair_stage(repro::ring_tail_stage<T>(tail, nz, zero_halo, z)) &&
           (npoint == 27 || !std::is_same<Tail, repro::ChebTail<T>>::value);
  else
    return true;
}

// The launch of a sweep with ``tail`` in T on z (zero_halo = 0: padded; 1:
// unpadded): the ring pass where on_ring says so, else stencil_kernel, which
// reads a padded z alone (an unpadded one returns cudaErrorInvalidValue: the
// wrapper pads it first).  old_pass = 1 launches stencil_kernel whatever the
// rule, the yardstick the ring is timed against (bf16 has no instance of it
// and refuses).
template <typename T, typename Tail>
int sweep(const T* z, int zero_halo, int old_pass, const Tail& tail, int nx, int ny, int nz,
          int npoint, double diag, double off, cudaStream_t s, int lanes) {
  if (zero_halo != 0 && zero_halo != 1) return (int)cudaErrorInvalidValue;
  if (!old_pass && on_ring(z, zero_halo, tail, nz, npoint))
    return repro::launch_stencil_ring<T>(z, zero_halo, tail, nullptr, nullptr, nx, ny, nz,
                                         npoint, diag, off, s, lanes);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (zero_halo) return (int)cudaErrorInvalidValue;
    return repro::launch_stencil<T>(z, tail, nullptr, nullptr, nx, ny, nz, npoint, diag, off,
                                    s, lanes);
  }
}

template <typename T>
int cheb(const void* z, const void* r, const void* d, void* z_out, void* d_out, int nx,
         int ny, int nz, int npoint, double diag, double off, double a, double c,
         int zero_halo, int old_pass, void* stream, int lanes = 1) {
  const repro::ChebTail<T> tail{static_cast<const T*>(r), static_cast<const T*>(d),
                                static_cast<T*>(z_out), static_cast<T*>(d_out),
                                static_cast<T>(a), static_cast<T>(c)};
  return sweep<T>(static_cast<const T*>(z), zero_halo, old_pass, tail, nx, ny, nz, npoint,
                  diag, off, static_cast<cudaStream_t>(stream), lanes);
}

template <typename T>
int jacobi(const void* z, const void* r, void* z_out, int nx, int ny, int nz, int npoint,
           double diag, double off, double omega, int zero_halo, int old_pass, void* stream,
           int lanes = 1) {
  using A = repro::acc_t<T>;
  const A inv_diag = A(1) / static_cast<A>(diag);
  const repro::JacobiTail<T> tail{static_cast<const T*>(r), static_cast<T*>(z_out),
                                  static_cast<T>(omega), inv_diag};
  return sweep<T>(static_cast<const T*>(z), zero_halo, old_pass, tail, nx, ny, nz, npoint,
                  diag, off, static_cast<cudaStream_t>(stream), lanes);
}

}  // namespace

extern "C" {

// Every entry point: z padded, (nx+2, ny+2, nz+2), with zero_halo = 0, or
// unpadded, (nx, ny, nz), with zero_halo = 1; old_pass as sweep's.
int cheb_step_f64(const void* z, const void* r, const void* d, void* z_out, void* d_out,
                  int nx, int ny, int nz, int npoint, double diag, double off, double a,
                  double c, int zero_halo, int old_pass, void* stream) {
  return cheb<double>(z, r, d, z_out, d_out, nx, ny, nz, npoint, diag, off, a, c, zero_halo,
                      old_pass, stream);
}

int cheb_step_f32(const void* z, const void* r, const void* d, void* z_out, void* d_out,
                  int nx, int ny, int nz, int npoint, double diag, double off, double a,
                  double c, int zero_halo, int old_pass, void* stream) {
  return cheb<float>(z, r, d, z_out, d_out, nx, ny, nz, npoint, diag, off, a, c, zero_halo,
                     old_pass, stream);
}

int cheb_step_bf16(const void* z, const void* r, const void* d, void* z_out, void* d_out,
                   int nx, int ny, int nz, int npoint, double diag, double off, double a,
                   double c, int zero_halo, int old_pass, void* stream) {
  return cheb<__nv_bfloat16>(z, r, d, z_out, d_out, nx, ny, nz, npoint, diag, off, a, c,
                             zero_halo, old_pass, stream);
}

int jacobi_sweep_f64(const void* z, const void* r, void* z_out, int nx, int ny, int nz,
                     int npoint, double diag, double off, double omega, int zero_halo,
                     int old_pass, void* stream) {
  return jacobi<double>(z, r, z_out, nx, ny, nz, npoint, diag, off, omega, zero_halo, old_pass,
                        stream);
}

int jacobi_sweep_f32(const void* z, const void* r, void* z_out, int nx, int ny, int nz,
                     int npoint, double diag, double off, double omega, int zero_halo,
                     int old_pass, void* stream) {
  return jacobi<float>(z, r, z_out, nx, ny, nz, npoint, diag, off, omega, zero_halo, old_pass,
                       stream);
}

int jacobi_sweep_bf16(const void* z, const void* r, void* z_out, int nx, int ny, int nz,
                      int npoint, double diag, double off, double omega, int zero_halo,
                      int old_pass, void* stream) {
  return jacobi<__nv_bfloat16>(z, r, z_out, nx, ny, nz, npoint, diag, off, omega, zero_halo,
                               old_pass, stream);
}

// The lane-batched forms: z is (lanes, nx+2, ny+2, nz+2) padded or (lanes,
// nx, ny, nz) unpadded, every other operand (lanes, nx, ny, nz).  A grid
// beyond the launch limits returns cudaErrorInvalidValue.
int cheb_step_batched_f64(const void* z, const void* r, const void* d, void* z_out,
                          void* d_out, int lanes, int nx, int ny, int nz, int npoint,
                          double diag, double off, double a, double c, int zero_halo,
                          int old_pass, void* stream) {
  return cheb<double>(z, r, d, z_out, d_out, nx, ny, nz, npoint, diag, off, a, c, zero_halo,
                      old_pass, stream, lanes);
}

int cheb_step_batched_f32(const void* z, const void* r, const void* d, void* z_out,
                          void* d_out, int lanes, int nx, int ny, int nz, int npoint,
                          double diag, double off, double a, double c, int zero_halo,
                          int old_pass, void* stream) {
  return cheb<float>(z, r, d, z_out, d_out, nx, ny, nz, npoint, diag, off, a, c, zero_halo,
                     old_pass, stream, lanes);
}

int cheb_step_batched_bf16(const void* z, const void* r, const void* d, void* z_out,
                           void* d_out, int lanes, int nx, int ny, int nz, int npoint,
                           double diag, double off, double a, double c, int zero_halo,
                           int old_pass, void* stream) {
  return cheb<__nv_bfloat16>(z, r, d, z_out, d_out, nx, ny, nz, npoint, diag, off, a, c,
                             zero_halo, old_pass, stream, lanes);
}

int jacobi_sweep_batched_f64(const void* z, const void* r, void* z_out, int lanes, int nx,
                             int ny, int nz, int npoint, double diag, double off,
                             double omega, int zero_halo, int old_pass, void* stream) {
  return jacobi<double>(z, r, z_out, nx, ny, nz, npoint, diag, off, omega, zero_halo, old_pass,
                        stream, lanes);
}

int jacobi_sweep_batched_f32(const void* z, const void* r, void* z_out, int lanes, int nx,
                             int ny, int nz, int npoint, double diag, double off,
                             double omega, int zero_halo, int old_pass, void* stream) {
  return jacobi<float>(z, r, z_out, nx, ny, nz, npoint, diag, off, omega, zero_halo, old_pass,
                       stream, lanes);
}

int jacobi_sweep_batched_bf16(const void* z, const void* r, void* z_out, int lanes, int nx,
                              int ny, int nz, int npoint, double diag, double off,
                              double omega, int zero_halo, int old_pass, void* stream) {
  return jacobi<__nv_bfloat16>(z, r, z_out, nx, ny, nz, npoint, diag, off, omega, zero_halo,
                               old_pass, stream, lanes);
}

}  // extern "C"
