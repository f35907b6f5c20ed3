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
// kernel 1 (x read once, y written once); stencil_spmv_dots3 also reads the
// unpadded r once.  The operations are not far below that: each is rounded
// on its own (no FMA), so they issue at the FP64 (FP32) instruction rate,
// half the FLOP/s peak; in f64 27pt about 69 % (dots) and 48 % (dots3) of
// the bytes bound.
//
// Design: both run the plane-ring pass of stencil.cuh (stencil_ring_kernel:
// a 64 × 4 tile marched along x in runs of ``run`` planes, 8, 16 or 32, a
// launch argument chosen per grid by kernels/autotune.py, through a cp.async
// ring of plane tiles in shared memory; dots3's r prefetched a step ahead;
// another run launches nothing and returns cudaErrorInvalidValue), from x padded
// (zero_halo = 0, the reference's signature) or unpadded (zero_halo = 1, the
// zero halo made in the kernel).  The per-block partials go to scratch
// slots, then a one-block kernel sums the slots in a fixed order.  GPU
// blocks run in no order, so the partials never share an accumulator: no
// atomics, bitwise reproducible under one run (the run sets the block count,
// and so the order of the sum: two runs agree to rounding).  r is read at
// the unpadded index of the point.
//
// bf16 (spmv_dots_bf16, spmv_dots3_bf16): x, r and y in bf16, each operation
// of y rounded to bf16 as the plain version's; every partial is an f32 sum
// of f32 products (float partial slots and dots), as the reference's oracle
// computes it.  The ring's plane tiles are copied as 4-byte bf16 pairs and
// two z-outputs a thread summed in bf16x2 (its pair stage) when nz is even
// and x 4-byte aligned, else staged through registers.  Bound: bytes at 2 B
// an element, 4 B a partial.
#include "stencil.cuh"

namespace {

using repro::acc_t;

// dots[0] = (A x)·x, dots[1] = x·x; x padded or, with zero_halo, unpadded.
template <typename T>
int launch_dots(const void* x, void* y, void* partials, void* dots, int nx, int ny, int nz,
                int npoint, double diag, double off, int zero_halo, int run, void* stream) {
  return repro::launch_stencil_ring<T>(static_cast<const T*>(x), zero_halo,
                                       repro::SpmvTail<T, 2>{static_cast<T*>(y)},
                                       static_cast<acc_t<T>*>(partials),
                                       static_cast<acc_t<T>*>(dots), nx, ny, nz, npoint, diag,
                                       off, static_cast<cudaStream_t>(stream), 1, run);
}

// dots[0] = (A x)·x, dots[1] = r·x, dots[2] = r·r; r is (nx, ny, nz), x
// padded or, with zero_halo, unpadded.
template <typename T>
int launch_dots3(const void* x, const void* r, void* y, void* partials, void* dots, int nx,
                 int ny, int nz, int npoint, double diag, double off, int zero_halo, int run,
                 void* stream) {
  return repro::launch_stencil_ring<T>(
      static_cast<const T*>(x), zero_halo,
      repro::Dots3Tail<T>{static_cast<T*>(y), static_cast<const T*>(r)},
      static_cast<acc_t<T>*>(partials), static_cast<acc_t<T>*>(dots), nx, ny, nz, npoint,
      diag, off, static_cast<cudaStream_t>(stream), 1, run);
}

}  // namespace

extern "C" {

// Number of partial slots per dot product of stencil_spmv_dots (its scratch
// holds two of them) and of stencil_spmv_dots3 (three) in runs of ``run``
// planes; -1 for a run with no instance.
long long spmv_dots_partials(int nx, int ny, int nz, int run) {
  return repro::stencil_ring_num_blocks(nx, ny, nz, run);
}

long long spmv_dots3_partials(int nx, int ny, int nz, int run) {
  return repro::stencil_ring_num_blocks(nx, ny, nz, run);
}

int spmv_dots_f64(const void* x, void* y, void* partials, void* dots, int nx, int ny,
                  int nz, int npoint, double diag, double off, int zero_halo, int run,
                  void* stream) {
  return launch_dots<double>(x, y, partials, dots, nx, ny, nz, npoint, diag, off, zero_halo,
                             run, stream);
}

int spmv_dots_f32(const void* x, void* y, void* partials, void* dots, int nx, int ny,
                  int nz, int npoint, double diag, double off, int zero_halo, int run,
                  void* stream) {
  return launch_dots<float>(x, y, partials, dots, nx, ny, nz, npoint, diag, off, zero_halo,
                            run, stream);
}

// bf16 x and y; partials and dots are float.
int spmv_dots_bf16(const void* x, void* y, void* partials, void* dots, int nx, int ny,
                   int nz, int npoint, double diag, double off, int zero_halo, int run,
                   void* stream) {
  return launch_dots<__nv_bfloat16>(x, y, partials, dots, nx, ny, nz, npoint, diag, off,
                                    zero_halo, run, stream);
}

// dots[0] = (A x)·x, dots[1] = r·x, dots[2] = r·r; r is (nx, ny, nz), x
// padded or, with zero_halo, unpadded.
int spmv_dots3_f64(const void* x, const void* r, void* y, void* partials, void* dots,
                   int nx, int ny, int nz, int npoint, double diag, double off,
                   int zero_halo, int run, void* stream) {
  return launch_dots3<double>(x, r, y, partials, dots, nx, ny, nz, npoint, diag, off,
                              zero_halo, run, stream);
}

int spmv_dots3_f32(const void* x, const void* r, void* y, void* partials, void* dots,
                   int nx, int ny, int nz, int npoint, double diag, double off,
                   int zero_halo, int run, void* stream) {
  return launch_dots3<float>(x, r, y, partials, dots, nx, ny, nz, npoint, diag, off,
                             zero_halo, run, stream);
}

// bf16 x, r and y; partials and dots are float.
int spmv_dots3_bf16(const void* x, const void* r, void* y, void* partials, void* dots,
                    int nx, int ny, int nz, int npoint, double diag, double off,
                    int zero_halo, int run, void* stream) {
  return launch_dots3<__nv_bfloat16>(x, r, y, partials, dots, nx, ny, nz, npoint, diag, off,
                                     zero_halo, run, stream);
}

}  // extern "C"
