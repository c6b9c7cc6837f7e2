// Block-ELL operator matvec with its Dirichlet / diagonal-floor epilogue,
// for NVIDIA Hopper (sm_90a).
//
// Replaces shakti_tpu/ops/spmv_pallas.py:bell_matvec_pallas, the TPU's
// Pallas kernel for y = A x with A in block-ELL form (vals (NB, KB, B, B),
// nbr (NB, KB); shakti_tpu/fem/bell.py:bell_matvec), and fuses the
// operator epilogue around it (shakti_tpu/physics/residual.py:
// operator_from_values and the diagonal floor of solve/newton.py):
//
//   xm = d ? 0 : x;   y0 = d ? x : A xm;   y = y0 + extra * x
//
// with d an optional Dirichlet mask (bool bytes) and extra an optional per-row
// increment.
//
// Why it reads what it reads.  The TPU multiplied whole 128 x 128 tiles
// because its matrix unit takes nothing smaller, so it streamed every
// stored value.  Those tiles are almost empty: on the Cook_E2 bench mesh
// (n = 12,270, NB 96, KB 11, B 128) the 17.3 M stored values hold 84,788
// structural nonzeros (0.49 %), at most 10 per row.  Hopper's SIMT units
// gain nothing from dense tiles, so this kernel reads only the structural
// entries, through a scalar-ELL view built once per mesh
// (fem/bell.py:structural_view): nz_pos (W, n), the flat positions in vals
// of row i's entries in (k, j) order, padded with -1.  A position is
// ((r KB + k) B + i') B + j, so it names its column too: nbr[r, k] B + j.
//
// Bound: memory.  Per call at the bench shape the function needs each
// nonzero's value and one index (84,788 x 8 bytes in f32, x 12 in f64),
// one length per row (0.05 MB), x, y and extra (0.15 / 0.29 MB) and the
// mask (0.01 MB): 0.89 MB in f32, 0.27 us at 3.35 TB/s (1.37 MB, 0.41 us
// in f64), for 2 flops per nonzero.  (The dense stream of vals was
// 69.2 MB, 20.7 us.)  At this size the kernel is bound by load latency, so
// the design keeps the rounds of dependent loads to two and many loads in
// flight in each:
//   - one thread per row; the view is column-major, so the m-th position
//     loads of a warp are coalesced;
//   - round 1: each thread issues all W position loads (unrolled to kWMax),
//     while the CTA copies the nbr rows of its row blocks (KB entries
//     each) into shared memory;
//   - round 2: all W value, x and mask gathers, each column worked out
//     from its position and the shared copy of nbr (B is a power of two:
//     shifts and masks);
//   - 64-thread CTAs: 192 CTAs for n = 12,270 spread over the 132 SMs
//     (256-thread CTAs would fill 48 of them).
//
// Determinism: products and sums use __fmul_rn / __fadd_rn (no FMA
// contraction) and the sum runs in m order from the m = 0 term (a padding
// term is +0 * +0); the epilogue follows the PyTorch composition's order.
// So the result is bitwise equal to the plain twin that does the same
// operations (ops/spmv_cuda.py:bell_operator_structural) and from run to
// run.  No atomics.
//
// Assumes vals is zero outside nz_pos: fem/bell.py:plan_sum writes only the
// fold's slots into a zeroed array, and the lag carry starts at zeros.
//
// The member-batched launch (an ensemble's M operators on one mesh: vals
// (M, NB, KB, B, B), x, extra and y (M, n)) runs the same rows for every
// member along the grid's second axis, sharing the view, nbr and the mask.
// One launch replaces M: at the bench shape a single launch is bound by
// load latency, not bytes, so M members in one grid fill the SMs that one
// member leaves idle (192 CTAs on 132 SMs).  Its bytes bound is M times the
// values, x, y and extra, plus the view, the lengths and the mask once.

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
__device__ __forceinline__ void
bell_spmv_rows(const T* __restrict__ vals, const int32_t* __restrict__ nz_pos,
               const int64_t* __restrict__ nbr, int KB, int log2B, int W,
               int n, const T* __restrict__ x,
               const uint8_t* __restrict__ mask, const T* __restrict__ extra,
               T* __restrict__ y) {
  extern __shared__ int32_t nbr_s[];  // nbr rows r0 .. r1 of this CTA
  const int i0 = blockIdx.x * kThreads;
  const int i = i0 + threadIdx.x;
  const int r0 = i0 >> log2B;
  const int r1 = (min(i0 + kThreads, n) - 1) >> log2B;
  int32_t pos[kWMax];
  if (i < n) {
#pragma unroll
    for (int m = 0; m < kWMax; ++m)
      if (m < W) pos[m] = __ldg(nz_pos + static_cast<int64_t>(m) * n + i);
  }
  for (int t = threadIdx.x; t < (r1 - r0 + 1) * KB; t += kThreads)
    nbr_s[t] = static_cast<int32_t>(__ldg(nbr + static_cast<int64_t>(r0) * KB + t));
  __syncthreads();
  if (i >= n) return;
  const uint32_t base = static_cast<uint32_t>(r0 * KB);
  const uint32_t jmask = (1u << log2B) - 1u;
  T v[kWMax], xv[kWMax];
#pragma unroll
  for (int m = 0; m < kWMax; ++m) {
    if (m < W) {
      v[m] = T(0);
      xv[m] = T(0);
      if (pos[m] >= 0) {
        const uint32_t p = static_cast<uint32_t>(pos[m]);
        v[m] = __ldg(vals + p);
        const int64_t c =
            (static_cast<int64_t>(nbr_s[(p >> (2 * log2B)) - base]) << log2B)
            | (p & jmask);
        const T xc = __ldg(x + c);
        xv[m] = (mask != nullptr && __ldg(mask + c)) ? T(0) : xc;
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
__global__ void __launch_bounds__(kThreads)
bell_spmv_kernel(const T* __restrict__ vals,
                 const int32_t* __restrict__ nz_pos,
                 const int64_t* __restrict__ nbr, int KB, int log2B, int W,
                 int n, const T* __restrict__ x,
                 const uint8_t* __restrict__ mask,
                 const T* __restrict__ extra, T* __restrict__ y) {
  bell_spmv_rows<T>(vals, nz_pos, nbr, KB, log2B, W, n, x, mask, extra, y);
}

// The member-batched launch: member m = blockIdx.y reads its own values at
// vals + m * stride and its own x, extra and y rows (m * n); the structure
// (nz_pos, nbr) and the mask are shared.  Each member does the single
// launch's operations in its order, so it is bitwise equal to a single
// launch on its slice.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bell_spmv_batched_kernel(const T* __restrict__ vals, int64_t stride,
                         const int32_t* __restrict__ nz_pos,
                         const int64_t* __restrict__ nbr, int KB, int log2B,
                         int W, int n, const T* __restrict__ x,
                         const uint8_t* __restrict__ mask,
                         const T* __restrict__ extra, T* __restrict__ y) {
  const int64_t m = blockIdx.y;
  bell_spmv_rows<T>(vals + m * stride, nz_pos, nbr, KB, log2B, W, n,
                    x + m * n, mask, extra == nullptr ? nullptr : extra + m * n,
                    y + m * n);
}

template <typename T>
int launch(const T* vals, int64_t stride, int members, const int32_t* nz_pos,
           const int64_t* nbr, int KB, int B, int W, int n, const T* x,
           const uint8_t* mask, const T* extra, T* y, int device,
           cudaStream_t stream) {
  if (n <= 0) return 0;
  // the nbr rows one CTA of kThreads rows can touch
  const size_t smem = sizeof(int32_t) * KB * ((kThreads - 1) / B + 2);
  if (W < 1 || W > kWMax || KB < 1 || B < 1 || (B & (B - 1)) != 0
      || smem > 48 * 1024 || members < 1 || members > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int log2B = __builtin_ctz(static_cast<unsigned>(B));
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  const int blocks = (n + kThreads - 1) / kThreads;
  if (stride == 0)  // the single launch
    bell_spmv_kernel<T><<<blocks, kThreads, smem, stream>>>(
        vals, nz_pos, nbr, KB, log2B, W, n, x, mask, extra, y);
  else
    bell_spmv_batched_kernel<T><<<dim3(blocks, members), kThreads, smem,
                                  stream>>>(
        vals, stride, nz_pos, nbr, KB, log2B, W, n, x, mask, extra, y);
  err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

}  // namespace

// Plain C interface (loaded with ctypes).  nbr is the (NB, KB) int64
// neighbour-block table of vals (NB, KB, B, B), B a power of two; mask (one
// byte per row, 0 or 1) and extra may be null (no Dirichlet rows, no
// increment).  Launches on `stream` of `device`, does not synchronise and
// allocates nothing: the caller owns y.  Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for W outside [1, kWMax], or a B that is not
// a power of two); 0 on success.
extern "C" int bell_spmv_f32(const float* vals, const int32_t* nz_pos,
                             const int64_t* nbr, int KB, int B, int W,
                             int n, const float* x, const uint8_t* mask,
                             const float* extra, float* y, int device,
                             void* stream) {
  return launch<float>(vals, 0, 1, nz_pos, nbr, KB, B, W, n, x, mask, extra,
                       y, device, static_cast<cudaStream_t>(stream));
}

extern "C" int bell_spmv_f64(const double* vals, const int32_t* nz_pos,
                             const int64_t* nbr, int KB, int B, int W,
                             int n, const double* x, const uint8_t* mask,
                             const double* extra, double* y, int device,
                             void* stream) {
  return launch<double>(vals, 0, 1, nz_pos, nbr, KB, B, W, n, x, mask, extra,
                        y, device, static_cast<cudaStream_t>(stream));
}

// The member-batched launch: vals (M, NB, KB, B, B) with `stride` = NB KB B B
// elements between members, x, extra and y (M, n); one launch for all M
// members (1 <= M <= 65535, the grid's second axis).
extern "C" int bell_spmv_batched_f32(const float* vals, int64_t stride, int M,
                                     const int32_t* nz_pos,
                                     const int64_t* nbr, int KB, int B, int W,
                                     int n, const float* x,
                                     const uint8_t* mask, const float* extra,
                                     float* y, int device, void* stream) {
  if (stride < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float>(vals, stride, M, nz_pos, nbr, KB, B, W, n, x, mask,
                       extra, y, device, static_cast<cudaStream_t>(stream));
}

extern "C" int bell_spmv_batched_f64(const double* vals, int64_t stride, int M,
                                     const int32_t* nz_pos,
                                     const int64_t* nbr, int KB, int B, int W,
                                     int n, const double* x,
                                     const uint8_t* mask, const double* extra,
                                     double* y, int device, void* stream) {
  if (stride < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch<double>(vals, stride, M, nz_pos, nbr, KB, B, W, n, x, mask,
                        extra, y, device, static_cast<cudaStream_t>(stream));
}
