// Block-ELL SpMV  y = A x  for NVIDIA Hopper (sm_90a).
//
// Replaces shakti_tpu/ops/spmv_pallas.py:bell_matvec_pallas, the TPU's
// Pallas kernel for the same product; computes exactly what
// shakti_tpu/fem/bell.py:bell_matvec computes:
//
//   y[r*B + i] = sum_k sum_j vals[r, k, i, j] * x[nbr[r, k]*B + j],   r*B + i < n
//
// with vals (NB, KB, B, B) dense blocks and nbr (NB, KB) neighbour-block ids.
// x is read unpadded (columns >= n are skipped) and rows >= n of the ragged
// last block row are not written, so the TPU wrapper's per-call pad /
// swapaxes prologue has no counterpart here.
//
// Bound: memory bandwidth.  Every matvec streams vals once (at the Cook_E2
// bench shape NB=96, KB=11, B=128 that is 96*11*128*128 values, 69 MB in
// f32) for 2 flops per 4-byte value, about 0.5 flop/byte.  The design
// keeps that stream coalesced: one warp per output row, the warp's lanes
// striding the B contiguous values of vals[r, k, i, :] (128-byte loads per
// warp in f32), the matching x slice read by the same lanes.  The k loop is
// outer and runs in a fixed order, each lane keeps its own partial sum, and
// the warp reduces with a fixed shuffle tree, so the result is bitwise
// reproducible from run to run (no atomics).
//
// The dense 128 x 128 blocks hold ~7 real nonzeros per row, so most of the
// streamed bytes are zeros; a later format change can remove them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;   // 8 warps = 256 threads per block

template <typename T>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
bell_spmv_kernel(const T* __restrict__ vals, const int64_t* __restrict__ nbr,
                 const T* __restrict__ x, T* __restrict__ y,
                 int KB, int B, int n) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  // the whole warp shares `row`, so it leaves together and the full-mask
  // shuffles below never wait on an exited lane
  if (row >= n) return;
  const int64_t r = row / B;
  const int64_t i = row % B;
  T acc = T(0);
  for (int k = 0; k < KB; ++k) {
    const int64_t col0 = __ldg(nbr + r * KB + k) * B;
    const T* a = vals + ((r * KB + k) * B + i) * B;
    for (int j = lane; j < B; j += kWarp) {
      const int64_t col = col0 + j;
      if (col < n) acc += __ldg(a + j) * __ldg(x + col);
    }
  }
  for (int off = kWarp / 2; off > 0; off /= 2)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) y[row] = acc;
}

template <typename T>
int launch(const T* vals, const int64_t* nbr, const T* x, T* y, int KB, int B,
           int n, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  bell_spmv_kernel<T><<<blocks, kWarp * kRowsPerBlock, 0, stream>>>(
      vals, nbr, x, y, KB, B, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns the cudaError_t of the
// launch; 0 on success.  Launches on `stream`, does not synchronise and
// allocates nothing: the caller owns y.
extern "C" int bell_spmv_f32(const float* vals, const int64_t* nbr,
                             const float* x, float* y, int KB, int B, int n,
                             void* stream) {
  return launch<float>(vals, nbr, x, y, KB, B, n,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int bell_spmv_f64(const double* vals, const int64_t* nbr,
                             const double* x, double* y, int KB, int B, int n,
                             void* stream) {
  return launch<double>(vals, nbr, x, y, KB, B, n,
                        static_cast<cudaStream_t>(stream));
}
