// Scalar-ELL operator matvec with its Dirichlet / diagonal-floor epilogue,
// for NVIDIA Hopper (sm_90a).  One kernel serves the scalar-ELL operator
// (fem/ell.py) and the block-CSR operator (fem/bcsr.py):
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
// solve/newton.py.  It exists because of the bytes: at 1,002,001 nodes in
// block-CSR with B = 32 the stored values are ~273k dense 32 x 32 blocks
// (1.1 GB in f32) holding ~7M structural nonzeros.  The plain product
// (gather, batched matmul, row sum) streams all of them on every Krylov
// matvec; this kernel reads only the structural entries.
//
// What it reads: a scalar-ELL view built once per mesh (fem/ell.py:
// scalar_view), column-major (W, n): pos[m, i] the flat position in vals of
// row i's m-th structural entry (-1 pads), col[m, i] its column.
//   - ELL:  pos = i*K + m, col = ell_cols[i, m];
//   - BCSR: pos = (blk*B + i%B)*B + j, col = bcol[blk]*B + j, in (blk, j)
//     order.
//
// Bound: memory.  Per call the function needs each nonzero's value and two
// indices (12 bytes in f32, 16 in f64), x, y and extra once, the mask: at
// 1M nodes ~7M nonzeros, ~0.1 GB, ~30 us at 3.35 TB/s, for 2 flops per
// nonzero.  At the 12k-node bench size the kernel is bound by load latency,
// so it keeps two rounds of dependent loads with many loads in flight in
// each:
//   - one thread per row; the view is column-major, so the m-th loads of a
//     warp are coalesced;
//   - round 1: all W position and column loads (unrolled to kWMax);
//   - round 2: all W value, x and mask gathers.
//
// Determinism: __fmul_rn / __fadd_rn (no FMA contraction), the sum runs in
// m order from the m = 0 term (a padding term is +0 * +0), and the epilogue
// follows the PyTorch composition's order.  So the result is bitwise equal
// to the PyTorch mirror over the same view (ops/spmv_cuda.py:
// ell_operator_structural) and from run to run.  No atomics.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWMax = 16;     // the largest row count the view may have
constexpr int kThreads = 64;  // threads (rows) per CTA

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
ell_spmv_kernel(const T* __restrict__ vals, const int32_t* __restrict__ pos,
                const int32_t* __restrict__ col, int W, int n,
                const T* __restrict__ x, const uint8_t* __restrict__ mask,
                const T* __restrict__ extra, T* __restrict__ y) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  int32_t p[kWMax], c[kWMax];
#pragma unroll
  for (int m = 0; m < kWMax; ++m) {
    if (m < W) {
      const int64_t at = static_cast<int64_t>(m) * n + i;
      p[m] = __ldg(pos + at);
      c[m] = __ldg(col + at);
    }
  }
  T v[kWMax], xv[kWMax];
#pragma unroll
  for (int m = 0; m < kWMax; ++m) {
    if (m < W) {
      v[m] = T(0);
      xv[m] = T(0);
      if (p[m] >= 0) {
        v[m] = __ldg(vals + p[m]);
        const T xc = __ldg(x + c[m]);
        xv[m] = (mask != nullptr && __ldg(mask + c[m])) ? T(0) : xc;
      }
    }
  }
  T acc = mul_rn(v[0], xv[0]);
#pragma unroll
  for (int m = 1; m < kWMax; ++m)
    if (m < W) acc = add_rn(acc, mul_rn(v[m], xv[m]));
  const T xi = __ldg(x + i);
  T out = (mask != nullptr && __ldg(mask + i)) ? xi : acc;
  if (extra != nullptr) out = add_rn(out, mul_rn(__ldg(extra + i), xi));
  y[i] = out;
}

template <typename T>
int launch(const T* vals, const int32_t* pos, const int32_t* col, int W,
           int n, const T* x, const uint8_t* mask, const T* extra, T* y,
           int device, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (W < 1 || W > kWMax) return static_cast<int>(cudaErrorInvalidValue);
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  const int blocks = (n + kThreads - 1) / kThreads;
  ell_spmv_kernel<T><<<blocks, kThreads, 0, stream>>>(vals, pos, col, W, n, x,
                                                     mask, extra, y);
  err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

}  // namespace

// Plain C interface (loaded with ctypes).  pos and col are the (W, n) int32
// view; mask (one byte per row, 0 or 1) and extra may be null (no Dirichlet
// rows, no increment).  Launches on `stream` of `device`, does not
// synchronise and allocates nothing: the caller owns y.  Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for W outside
// [1, kWMax]); 0 on success.
extern "C" int ell_spmv_f32(const float* vals, const int32_t* pos,
                            const int32_t* col, int W, int n, const float* x,
                            const uint8_t* mask, const float* extra, float* y,
                            int device, void* stream) {
  return launch<float>(vals, pos, col, W, n, x, mask, extra, y, device,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int ell_spmv_f64(const double* vals, const int32_t* pos,
                            const int32_t* col, int W, int n, const double* x,
                            const uint8_t* mask, const double* extra,
                            double* y, int device, void* stream) {
  return launch<double>(vals, pos, col, W, n, x, mask, extra, y, device,
                        static_cast<cudaStream_t>(stream));
}
