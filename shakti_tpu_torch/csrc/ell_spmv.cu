// Scalar-ELL operator matvec with its Dirichlet / diagonal-floor epilogue,
// for NVIDIA Hopper (sm_90a).  One kernel serves the scalar-ELL operator
// and the block-CSR operator, which both store their structural entries
// alone (fem/ell.py):
//
//   xm = d ? 0 : x;   y0 = d ? x : A xm;   y = y0 + extra * x
//
// with d an optional Dirichlet mask (bool bytes) and extra an optional
// per-row increment.
//
// Not a port of a TPU kernel: the JAX package computes these two products
// in XLA (shakti_tpu/fem/ell.py:ell_matvec, shakti_tpu/fem/bcsr.py:
// bcsr_matvec) together with the epilogue of shakti_tpu/physics/
// residual.py:operator_from_values and the diagonal floor of
// solve/newton.py, over dense layouts ((n, K) rows, (nnzb, B, B) blocks).
//
// What it reads: svals (W, n) and col (W, n) int32, column-major in the
// order of fem/ell.py:scalar_view.  svals[m*n + i] is row i's m-th
// structural entry and col[m*n + i] its column; a padding slot holds the
// value 0 and the row's own index.  The fold writes svals in this order
// (fem/ell.py:fold_structural), so nothing stands between the fold and the
// matvec: no position table, no dense blocks.
//
// Bound: memory.  The kernel moves W*n values and W*n 4-byte columns, x, y,
// extra and the mask once: at 1,002,001 nodes (W 9) 89 MB in float32, 27 us
// at 3.35 TB/s, for 2 flops per slot.  What the design does about it:
//   - one thread per row and the storage column-major, so a warp's m-th
//     value loads and m-th column loads are each one run of consecutive
//     addresses (128 bytes in float32): no sector is fetched for one value;
//   - a value's address depends on no other load: the only dependent round
//     is column -> x;
//   - svals and col are read once per launch: streaming loads (__ldcs,
//     evict-first) keep them from displacing x, which every row's
//     neighbours gather and which fits the L2 many times over; x, the mask
//     and extra go through the read-only path (__ldg);
//   - W is a template parameter: all W value and column loads of a thread
//     are in flight before the first use, then all W gathers of x;
//   - 256 threads per CTA, one row per thread.  Measured on an H100 (700 W)
//     over 32..512 threads per CTA: 1.7-2.0 us at 12,270 rows and 26.3-27.1
//     us at 1,002,001 rows in float32 (41.8-44.0 us in float64), where the
//     kernel moves 3.2 TB/s: the launch shape hardly matters (two rows per
//     thread, tried, cost 15-25 % at both sizes), so it is a constant.
//
// Determinism: __fmul_rn / __fadd_rn (no FMA contraction), the sum runs in
// m order from the m = 0 term (a padding term is 0 * xm[row]), and the
// epilogue follows the PyTorch composition's order.  So the result is
// bitwise equal to the PyTorch mirror over the same storage
// (ops/spmv_cuda.py:ell_operator_plain) and from run to run.  No atomics.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWMax = 16;        // the largest row count the view may have
constexpr int kThreads = 256;    // threads (rows) per CTA

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
ell_spmv_kernel(const T* __restrict__ svals, const int32_t* __restrict__ col,
                int n, const T* __restrict__ x,
                const uint8_t* __restrict__ mask, const T* __restrict__ extra,
                T* __restrict__ y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T v[W];
  int32_t c[W];
#pragma unroll
  for (int m = 0; m < W; ++m) {
    v[m] = __ldcs(svals + (m * n + i));  // W * n < 2^31 (checked at launch)
    c[m] = __ldcs(col + (m * n + i));
  }
  T xv[W];
#pragma unroll
  for (int m = 0; m < W; ++m) {
    const T xc = __ldg(x + c[m]);
    xv[m] = (mask != nullptr && __ldg(mask + c[m])) ? T(0) : xc;
  }
  T acc = mul_rn(v[0], xv[0]);
#pragma unroll
  for (int m = 1; m < W; ++m) acc = add_rn(acc, mul_rn(v[m], xv[m]));
  const T xi = __ldg(x + i);
  T out = (mask != nullptr && __ldg(mask + i)) ? xi : acc;
  if (extra != nullptr) out = add_rn(out, mul_rn(__ldg(extra + i), xi));
  y[i] = out;
}

template <typename T>
int launch(const T* svals, const int32_t* col, int W, int n, const T* x,
           const uint8_t* mask, const T* extra, T* y, int device,
           cudaStream_t stream) {
  if (n <= 0) return 0;
  if (W < 1 || W > kWMax ||
      static_cast<int64_t>(W) * n >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  const int blocks = (n + kThreads - 1) / kThreads;
  switch (W) {
#define SHAKTI_ELL_CASE(w)                                                  \
  case w:                                                                   \
    ell_spmv_kernel<T, w><<<blocks, kThreads, 0, stream>>>(                 \
        svals, col, n, x, mask, extra, y);                                  \
    break;
    SHAKTI_ELL_CASE(1) SHAKTI_ELL_CASE(2) SHAKTI_ELL_CASE(3) SHAKTI_ELL_CASE(4)
    SHAKTI_ELL_CASE(5) SHAKTI_ELL_CASE(6) SHAKTI_ELL_CASE(7) SHAKTI_ELL_CASE(8)
    SHAKTI_ELL_CASE(9) SHAKTI_ELL_CASE(10) SHAKTI_ELL_CASE(11)
    SHAKTI_ELL_CASE(12) SHAKTI_ELL_CASE(13) SHAKTI_ELL_CASE(14)
    SHAKTI_ELL_CASE(15) SHAKTI_ELL_CASE(16)
#undef SHAKTI_ELL_CASE
  }
  err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

}  // namespace

// Plain C interface (loaded with ctypes).  svals and col are the (W, n)
// structural storage; mask (one byte per row, 0 or 1) and extra may be null
// (no Dirichlet rows, no increment).  Launches on `stream` of `device`,
// does not synchronise and allocates nothing: the caller owns y.  Returns
// the cudaError_t of the launch (cudaErrorInvalidValue for W outside
// [1, kWMax] or W * n >= 2^31); 0 on success.
extern "C" int ell_spmv_f32(const float* svals, const int32_t* col, int W,
                            int n, const float* x, const uint8_t* mask,
                            const float* extra, float* y, int device,
                            void* stream) {
  return launch<float>(svals, col, W, n, x, mask, extra, y, device,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int ell_spmv_f64(const double* svals, const int32_t* col, int W,
                            int n, const double* x, const uint8_t* mask,
                            const double* extra, double* y, int device,
                            void* stream) {
  return launch<double>(svals, col, W, n, x, mask, extra, y, device,
                        static_cast<cudaStream_t>(stream));
}
