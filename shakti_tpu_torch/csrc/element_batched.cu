// The ensemble's element residual and element Jacobian in closed form, and
// the two-level preconditioner's coarse operators built from that
// Jacobian, for NVIDIA Hopper (sm_90a), batched over the members of an
// ensemble.
//
// Replaces no TPU kernel.  The JAX package computes all of it in XLA: the
// residual and Jacobian as jax.vmap of
// shakti_tpu/physics/residual.py:corner_residual_multi and of its
// forward-AD element_jacobian; the port's batched Newton solve
// (solve/newton.py:newton_solve_batched) did the same with torch.func.vmap
// and torch.func.jvp, which writes (M, c, nq, 3, 2, k) intermediates for the
// primal and again for the tangent in ~290 PyTorch launches a step.  Here
// each is one pass over the cells that reads each input once:
//
//   element_jacobian_batched  J (M, c, 3, 3), per member m and cell c
//     J_ij = w [ -(Tbar / (rho_w g)) (g_i . gt_j)
//                + sum_q w_q phi_qi ( c_m / L_h (q_q . gt_j) - r_q phi_qj ) ]
//     r_q  = n A b_q |N_q|^(n-1) + s_q / (rho_w g dt)
//   with Tbar = sum_q w_q T_q, w = area * cell_valid, g_i the cell's basis
//   gradients and gt_j = g_j - (g_0 + g_1 + g_2) / 3, the derivative of the
//   mean-centred gradient (fem/ops.py:center; equal to g_j in exact
//   arithmetic).
//
//   element_residual_batched  corner contributions (M, c, 3, k) of k <= 3
//   stacked states per member
//     F_i = w [ Tbar (grad h . g_i) + sum_q (w_q phi_qi) src_q ]
//     grad h = gb0 - grad N / (rho_w g)   (grad N from mean-centred corners)
//     src_q  = c_m m_q - C_q - lake_q - inputs_q,  as corner_residual_multi.
//   Each column runs the same instructions in a loop that is not unrolled,
//   so a column of a k = 3 launch is bitwise a k = 1 launch.
//
//   node_sum_batched  the nodal sums (M, n, k) of the corner contributions
//   over the node -> (cell, corner) incidence map, slot by slot in the
//   map's order from the first slot (the sentinel 3c reads 0): the adds of
//   fem/ops.py:scatter_add_cells' fixed_sum, so bitwise equal to it.  With
//   a mask, masked rows are written as 0 (the Newton solve's Dirichlet
//   rows).
//
// The per-member fields of the step's frozen data (physics/residual.StepPre:
// T_q, q_q, b_q, mdiff_q, N_n at the quadrature points) are read in place
// through their strides; a field all members share (G_q, inputs_q,
// storage_q, gb0, dt, phi, w_q) has member stride 0 and is read once from
// device memory, from the caches after.  Nothing is copied M times.
//
// Bound: memory.  At the benchmark's shape (Cook_E2: c = 23,990 cells,
// n = 12,270 nodes, nq = 6, M = 128, f32) the Jacobian needs, per member
// and cell, T_q, q_q and b_q (24 values) read and the 9 entries written:
// 132 B, 0.405 GB, plus N (M n) and the shared fields and geometry once:
// ~0.41 GB, 0.12 ms at 3.35 TB/s.  One residual column needs T_q, q_q,
// b_q, mdiff_q and N_n (36 values, 144 B per member and cell), N and F
// (M n each): ~0.46 GB, 0.14 ms; the two passes also write and read back
// the corner contributions (12 B per member, cell and column).  The work
// is ~200 flops per member and cell, far below the memory's line.  So the
// design reads each byte once and keeps loads coalesced:
//   - one thread per cell, neighbouring threads on neighbouring cells
//     (the fields are cell-major: a warp's loads of one field at one
//     quadrature point span a few cache lines that the next points reuse);
//   - each CTA takes kThreads cells and kMembers members (the grid's second
//     axis covers the rest): the cell's geometry (corners, gradients, area)
//     is loaded once into registers and reused across the CTA's members;
//   - no shared memory, no atomics: every output is written by one thread.
//
// Arithmetic: plain expressions, which nvcc contracts into FMAs; the plain
// twin (ops/element_cuda.py) does the same operations in the same order
// without contraction, so the two agree to rounding (chip_smoke.py's
// phase `element` holds them to 1e-12 in f64 and 1e-5 in f32 of the
// largest entry).  The node sum has no products: it is bitwise the twin's.
//
//   coarse_batched  the Galerkin coarse operators A_c (M, m, m) of the
//   two-level preconditioner, m = ceil(n / block), from the element
//   Jacobian J (M, c, 3, 3):
//     A_c[mb, slot] = sum_k -J[mb, pos_k] * (free[row(pos_k)] free[col(pos_k)])
//   over the positions (flat indices into the 9c entries) of the aggregate
//   pair `slot` in the host plan's order, summed left to right in one
//   thread; every slot of no pair is 0.  The plan (ops/element_cuda.
//   coarse_plan) lists each pair's positions in the order of
//   fem/ops.py:gather_plan over the keys agg_row * m + agg_col, the plan of
//   solve/precond.py:coarse_inverse; a pair shorter than the longest gets
//   one more + 0, as the padded plan's sum adds its padding zeros.  Products
//   and sums are __fmul_rn / __fadd_rn (never contracted), so A_c is
//   bitwise the twin's (coarse_inverse's sum before its inverse, for all
//   members at once).  In the ensemble it takes the place of the vmapped
//   solve/precond.py:coarse_from_values (jax.vmap of the JAX package's,
//   in XLA): masked products over the dense block-ELL values, 0.49 % of
//   whose slots are structural on Cook_E2.
//   Bound: memory.  At the benchmark's shape (c = 23,990, aggregates of
//   128 nodes: m = 96, 740 pairs; M = 128, f32) it reads the 9c entries of
//   J once per member (110.5 MB) and writes A_c (4.7 MB); the plan
//   (215,910 positions), cells and mask are read once: ~0.12 GB, 35 us at
//   3.35 TB/s.  The sums are serial (up to 2,108 entries a pair), so the
//   design keeps the loads ahead of the adds and the warps uniform:
//   - a warp takes one pair for 2 members, 32 entries at a time: lane t
//     loads position t and its free mask once and gathers that entry of
//     both members (a member's 32 entries lie in a few cells, so a load
//     instruction touches a few lines; with a lane per member it touched
//     32), the (2, 32) tile goes through shared memory, and lanes 0 and 1
//     add their member's row in order, 16 bytes a read, while the next
//     chunk's gathers are in flight.  One sum a member keeps every chain
//     as short as the pair, and two members a warp halve the index work
//     (measured on the H100 at M = 128 on Cook_E2, aggregates of 128:
//     a lane per member 0.28 ms, one member a warp 0.17, two 0.12, four
//     0.13, eight 0.19);
//   - the pairs run longest first, so the long diagonal pairs start in
//     the first wave and the short ones fill in behind them;
//   - the slots of no pair are zeroed by the grid's last CTAs, one slot a
//     thread for every member (coalesced): one launch in all, no atomics,
//     no memset.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kQMax = 6;        // quadrature points per cell (degree 4)
constexpr int kKMax = 3;        // stacked residual columns
constexpr int kSMax = 16;       // incidence slots per node
constexpr int kThreads = 128;   // cells (nodes) per CTA
constexpr int kMembers = 8;     // members per CTA
constexpr int kFields = 12;
// coarse_batched: a chunk of a pair's entries is kLanes, one a lane; a
// warp sums kRows members (2 measured best on the benchmark's shape, of 1
// to 16), kWarps warps a CTA; a tile row is padded to kRow so that the
// rows' 16-byte reads fall in distinct banks
constexpr int kLanes = 32;
constexpr int kRows = 2;
constexpr int kWarps = 4;
constexpr int kRow = kLanes + 4;

// the fields of the step's frozen data, in ops/element_cuda.FIELDS order
enum Field { kTq, kQq, kBq, kMdiff, kGq, kInq, kStq, kNnq, kGb0, kDt, kPhi,
             kWq };

// a pointer per field and its strides in elements: the member's, then
// those of the field's own axes (cell, quadrature point, component; phi:
// point, corner; w_q: point), 0 past the field's rank
template <typename T>
struct Fields {
  const T* p[kFields];
  int64_t s[kFields][4];
};

// physical constants as PhysicalParams gives them (host doubles)
struct Consts {
  double rwg;   // rho_w g
  double c_m;   // 1 / rho_i - 1 / rho_w
  double Lh;    // latent heat
  double A;     // creep constant
  double n;     // Glen exponent
};

template <typename T>
__device__ __forceinline__ const T* member_base(const Fields<T>& f, int k,
                                                int64_t m) {
  return f.p[k] + m * f.s[k][0];
}

// |N|^(n-1): a square for the standard n = 3, as PyTorch's pow does
template <typename T>
__device__ __forceinline__ T pow_abs(T x, T e) {
  const T a = x < T(0) ? -x : x;
  return e == T(2) ? a * a : pow(a, e);
}

// the geometry of cell c, loaded once per CTA
template <typename T>
struct Cell {
  int64_t v[3];
  T gx[3], gy[3];
  T w;
};

template <typename T>
__device__ __forceinline__ Cell<T> load_cell(
    int64_t c, const int64_t* __restrict__ cells,
    const T* __restrict__ grads, const T* __restrict__ area,
    const T* __restrict__ valid) {
  Cell<T> g;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    g.v[j] = __ldg(cells + 3 * c + j);
    g.gx[j] = __ldg(grads + 6 * c + 2 * j);
    g.gy[j] = __ldg(grads + 6 * c + 2 * j + 1);
  }
  g.w = __ldg(area + c) * __ldg(valid + c);
  return g;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
jacobian_kernel(Fields<T> f, Consts k, const int64_t* __restrict__ cells,
                const T* __restrict__ grads, const T* __restrict__ area,
                const T* __restrict__ valid, int nq, int nc, int M,
                int64_t n, const T* __restrict__ N, T* __restrict__ J) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= nc) return;
  const int m0 = blockIdx.y * kMembers;
  const int m1 = min(m0 + kMembers, M);
  const Cell<T> g = load_cell<T>(c, cells, grads, area, valid);
  const T sx = (g.gx[0] + g.gx[1]) + g.gx[2];
  const T sy = (g.gy[0] + g.gy[1]) + g.gy[2];
  T tx[3], ty[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    tx[j] = g.gx[j] - sx / T(3);
    ty[j] = g.gy[j] - sy / T(3);
  }
  const T rwg = T(k.rwg), cmL = T(k.c_m / k.Lh), nA = T(k.A * k.n);
  const T nm1 = T(k.n - 1.0);
  for (int m = m0; m < m1; ++m) {
    const T* Tq = member_base(f, kTq, m) + c * f.s[kTq][1];
    const T* qq = member_base(f, kQq, m) + c * f.s[kQq][1];
    const T* bq = member_base(f, kBq, m) + c * f.s[kBq][1];
    const T* st = member_base(f, kStq, m) + c * f.s[kStq][1];
    const T* phi = member_base(f, kPhi, m);
    const T* wq = member_base(f, kWq, m);
    const T dt = __ldg(member_base(f, kDt, m));
    const T* Nm = N + static_cast<int64_t>(m) * n;
    const T N0 = __ldg(Nm + g.v[0]), N1 = __ldg(Nm + g.v[1]),
            N2 = __ldg(Nm + g.v[2]);
    T tbar = T(0);
    T acc[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) acc[i][j] = T(0);
#pragma unroll
    for (int q = 0; q < kQMax; ++q) {
      if (q < nq) {
        T p[3];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          p[i] = __ldg(phi + q * f.s[kPhi][1] + i * f.s[kPhi][2]);
        const T w_q = __ldg(wq + q * f.s[kWq][1]);
        const T qx = __ldg(qq + q * f.s[kQq][2]);
        const T qy = __ldg(qq + q * f.s[kQq][2] + f.s[kQq][3]);
        tbar += w_q * __ldg(Tq + q * f.s[kTq][2]);
        const T Nq = (p[0] * N0 + p[1] * N1) + p[2] * N2;
        const T r = nA * __ldg(bq + q * f.s[kBq][2]) * pow_abs(Nq, nm1)
                    + __ldg(st + q * f.s[kStq][2]) / (rwg * dt);
        T adv[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) adv[j] = cmL * (qx * tx[j] + qy * ty[j]);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const T wp = w_q * p[i];
#pragma unroll
          for (int j = 0; j < 3; ++j) acc[i][j] += wp * (adv[j] - r * p[j]);
        }
      }
    }
    const T tr = tbar / rwg;
    T* out = J + (static_cast<int64_t>(m) * nc + c) * 9;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        out[3 * i + j] =
            g.w * (acc[i][j] - tr * (g.gx[i] * tx[j] + g.gy[i] * ty[j]));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
residual_kernel(Fields<T> f, Consts k, const int64_t* __restrict__ cells,
                const T* __restrict__ grads, const T* __restrict__ area,
                const T* __restrict__ valid, int nq, int nc, int M,
                int64_t n, int kc, const T* __restrict__ X,
                T* __restrict__ corner) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= nc) return;
  const int m0 = blockIdx.y * kMembers;
  const int m1 = min(m0 + kMembers, M);
  const Cell<T> g = load_cell<T>(c, cells, grads, area, valid);
  const T rwg = T(k.rwg), c_m = T(k.c_m), Lh = T(k.Lh), A = T(k.A);
  const T nm1 = T(k.n - 1.0);
  for (int m = m0; m < m1; ++m) {
    const T* Tq = member_base(f, kTq, m) + c * f.s[kTq][1];
    const T* qq = member_base(f, kQq, m) + c * f.s[kQq][1];
    const T* bq = member_base(f, kBq, m) + c * f.s[kBq][1];
    const T* md = member_base(f, kMdiff, m) + c * f.s[kMdiff][1];
    const T* Gq = member_base(f, kGq, m) + c * f.s[kGq][1];
    const T* iq = member_base(f, kInq, m) + c * f.s[kInq][1];
    const T* st = member_base(f, kStq, m) + c * f.s[kStq][1];
    const T* Nn = member_base(f, kNnq, m) + c * f.s[kNnq][1];
    const T* gb = member_base(f, kGb0, m) + c * f.s[kGb0][1];
    const T* phi = member_base(f, kPhi, m);
    const T* wq = member_base(f, kWq, m);
    const T dt = __ldg(member_base(f, kDt, m));
    const T gbx = __ldg(gb), gby = __ldg(gb + f.s[kGb0][2]);
    const T* Xm = X + static_cast<int64_t>(m) * n * kc;
    T* out = corner + (static_cast<int64_t>(m) * nc + c) * 3 * kc;
    // one column at a time, the same instructions for every column
#pragma unroll 1
    for (int col = 0; col < kc; ++col) {
      const T N0 = __ldg(Xm + g.v[0] * kc + col);
      const T N1 = __ldg(Xm + g.v[1] * kc + col);
      const T N2 = __ldg(Xm + g.v[2] * kc + col);
      const T mean = ((N0 + N1) + N2) / T(3);
      const T d0 = N0 - mean, d1 = N1 - mean, d2 = N2 - mean;
      const T gNx = (d0 * g.gx[0] + d1 * g.gx[1]) + d2 * g.gx[2];
      const T gNy = (d0 * g.gy[0] + d1 * g.gy[1]) + d2 * g.gy[2];
      const T ghx = gbx - gNx / rwg;
      const T ghy = gby - gNy / rwg;
      T tbar = T(0), src[3] = {T(0), T(0), T(0)};
#pragma unroll
      for (int q = 0; q < kQMax; ++q) {
        if (q < nq) {
          T p[3];
#pragma unroll
          for (int i = 0; i < 3; ++i)
            p[i] = __ldg(phi + q * f.s[kPhi][1] + i * f.s[kPhi][2]);
          const T w_q = __ldg(wq + q * f.s[kWq][1]);
          const T qx = __ldg(qq + q * f.s[kQq][2]);
          const T qy = __ldg(qq + q * f.s[kQq][2] + f.s[kQq][3]);
          tbar += w_q * __ldg(Tq + q * f.s[kTq][2]);
          const T qdgh = qx * ghx + qy * ghy;
          const T mq = (__ldg(Gq + q * f.s[kGq][2]) - rwg * qdgh) / Lh
                       + __ldg(md + q * f.s[kMdiff][2]);
          const T Nq = (p[0] * N0 + p[1] * N1) + p[2] * N2;
          const T C = A * __ldg(bq + q * f.s[kBq][2]) * Nq * pow_abs(Nq, nm1);
          const T lake = __ldg(st + q * f.s[kStq][2])
                         * (Nq - __ldg(Nn + q * f.s[kNnq][2])) / (rwg * dt);
          const T s = ((c_m * mq - C) - lake) - __ldg(iq + q * f.s[kInq][2]);
#pragma unroll
          for (int i = 0; i < 3; ++i) src[i] += (w_q * p[i]) * s;
        }
      }
#pragma unroll
      for (int i = 0; i < 3; ++i)
        out[i * kc + col] =
            g.w * (tbar * (ghx * g.gx[i] + ghy * g.gy[i]) + src[i]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
node_sum_kernel(const T* __restrict__ corner, int64_t slots,
                const int64_t* __restrict__ inc, int S, int64_t n, int M,
                int kc, const uint8_t* __restrict__ mask, T* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int m0 = blockIdx.y * kMembers;
  const int m1 = min(m0 + kMembers, M);
  int64_t sl[kSMax];
#pragma unroll
  for (int s = 0; s < kSMax; ++s)
    if (s < S) sl[s] = __ldg(inc + i * S + s);
  const bool d = mask != nullptr && __ldg(mask + i);
  for (int m = m0; m < m1; ++m) {
    const T* cm = corner + static_cast<int64_t>(m) * slots * kc;
    T* om = out + (static_cast<int64_t>(m) * n + i) * kc;
    for (int col = 0; col < kc; ++col) {
      T acc = sl[0] < slots ? __ldg(cm + sl[0] * kc + col) : T(0);
#pragma unroll
      for (int s = 1; s < kSMax; ++s)
        if (s < S) acc = acc + (sl[s] < slots ? __ldg(cm + sl[s] * kc + col)
                                              : T(0));
      om[col] = d ? T(0) : acc;
    }
  }
}

// products and sums rounded one at a time, never contracted into FMAs
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// the free mask of entry pos = 9 cell + 3 i + j: free[row] * free[col]
template <typename T>
__device__ __forceinline__ T entry_weight(int pos,
                                          const int64_t* __restrict__ cells,
                                          const uint8_t* __restrict__ fixed) {
  const int cell = pos / 9;
  const int e = pos - 9 * cell;
  const int i = e / 3;
  const int j = e - 3 * i;
  const T fr = __ldg(fixed + __ldg(cells + 3 * cell + i)) ? T(0) : T(1);
  const T fc = __ldg(fixed + __ldg(cells + 3 * cell + j)) ? T(0) : T(1);
  return mul_rn(fr, fc);
}

// lane t's entry of the chunk at k for each of a warp's members: x[r] =
// -J[m0 + r, pos] * w, 0 past the pair's end or the members
template <typename T>
__device__ __forceinline__ void load_chunk(
    T (&x)[kRows], const T* __restrict__ J, int64_t sJ, int m0, int members,
    const int* __restrict__ positions, int k, int k1,
    const int64_t* __restrict__ cells, const uint8_t* __restrict__ fixed) {
  const bool in = k + static_cast<int>(threadIdx.x) < k1;
  int pos = 0;
  T w = T(0);
  if (in) {
    pos = __ldg(positions + k + threadIdx.x);
    w = entry_weight<T>(pos, cells, fixed);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    x[r] = in && r < members
               ? mul_rn(-__ldg(J + static_cast<int64_t>(m0 + r) * sJ + pos), w)
               : T(0);
}

// acc + row[0] + ... + row[n - 1] left to right, the row read 16 bytes at
// a time
__device__ __forceinline__ float add_row(float acc, const float* row, int n) {
  const float4* q = reinterpret_cast<const float4*>(row);
  int t = 0;
  for (; t + 4 <= n; t += 4) {
    const float4 a = q[t / 4];
    acc = add_rn(add_rn(add_rn(add_rn(acc, a.x), a.y), a.z), a.w);
  }
  for (; t < n; ++t) acc = add_rn(acc, row[t]);
  return acc;
}
__device__ __forceinline__ double add_row(double acc, const double* row,
                                          int n) {
  const double2* q = reinterpret_cast<const double2*>(row);
  int t = 0;
  for (; t + 2 <= n; t += 2) {
    const double2 a = q[t / 2];
    acc = add_rn(add_rn(acc, a.x), a.y);
  }
  if (t < n) acc = add_rn(acc, row[t]);
  return acc;
}

// CTAs [0, pair_ctas): the CTAs of a pair are consecutive, warp y of CTA b
// takes kRows members of pair b / (CTAs a pair); the rest zero the slots
// of no pair, kLanes * kWarps slots a CTA for every member.  A warp takes
// its pair's entries kLanes at a time: lane t loads position t and its
// free mask and gathers that entry of each of its members (a coalesced
// load of the few cells a chunk spans), the (member, entry) tile goes
// through shared memory, and lane r adds member r's row in order while the
// next chunk's gathers are in flight.
template <typename T>
__global__ void __launch_bounds__(kLanes * kWarps)
coarse_kernel(const T* __restrict__ J, int64_t sJ,
              const uint8_t* __restrict__ fixed,
              const int64_t* __restrict__ cells,
              const int64_t* __restrict__ slots,
              const int* __restrict__ offsets,
              const int* __restrict__ positions, int maxlen,
              const uint8_t* __restrict__ filled, int64_t mm, int M,
              int64_t pair_ctas, T* __restrict__ out) {
  __shared__ __align__(16) T tile[kWarps][kRows][kRow];
  const int lane = threadIdx.x;
  const int64_t b = blockIdx.x;
  if (b < pair_ctas) {
    const int64_t per_pair = ((M + kRows - 1) / kRows + kWarps - 1) / kWarps;
    const int64_t u = b / per_pair;
    const int m0 =
        static_cast<int>((b % per_pair) * kWarps + threadIdx.y) * kRows;
    if (m0 >= M) return;                      // the whole warp
    const int members = min(kRows, M - m0);
    T(*rows)[kRow] = tile[threadIdx.y];
    const int k0 = __ldg(offsets + u), k1 = __ldg(offsets + u + 1);
    T v[kRows], next[kRows] = {};
    load_chunk(v, J, sJ, m0, members, positions, k0, k1, cells, fixed);
    T acc = T(-0.0);                          // -0 + x == x for every x
    for (int k = k0; k < k1; k += kLanes) {
      if (k + kLanes < k1)
        load_chunk(next, J, sJ, m0, members, positions, k + kLanes, k1,
                   cells, fixed);
#pragma unroll
      for (int r = 0; r < kRows; ++r) rows[r][lane] = v[r];
      __syncwarp();
      if (lane < members) acc = add_row(acc, rows[lane], min(kLanes, k1 - k));
      __syncwarp();
#pragma unroll
      for (int r = 0; r < kRows; ++r) v[r] = next[r];
    }
    // the padded plan adds zeros after a shorter pair's entries: -0 -> +0
    if (k1 - k0 < maxlen) acc = add_rn(acc, T(0));
    if (lane < members)
      out[static_cast<int64_t>(m0 + lane) * mm + __ldg(slots + u)] = acc;
  } else {
    const int64_t s = (b - pair_ctas) * (kLanes * kWarps)
                      + threadIdx.y * kLanes + lane;
    if (s >= mm || __ldg(filled + s)) return;
    for (int mb = 0; mb < M; ++mb)
      out[static_cast<int64_t>(mb) * mm + s] = T(0);
  }
}

template <typename T>
Fields<T> fields_of(const void* const* ptrs, const int64_t* strides) {
  Fields<T> f;
  for (int k = 0; k < kFields; ++k) {
    f.p[k] = static_cast<const T*>(ptrs[k]);
    for (int a = 0; a < 4; ++a) f.s[k][a] = strides[4 * k + a];
  }
  return f;
}

// Switch to `device` for the launch; `prev` holds the device to restore.
cudaError_t enter(int device, int* prev) {
  cudaError_t err = cudaGetDevice(prev);
  if (err == cudaSuccess && *prev != device) err = cudaSetDevice(device);
  return err;
}

cudaError_t leave(int device, int prev) {
  const cudaError_t err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return err;
}

dim3 grid(int64_t rows, int M) {
  return dim3(static_cast<unsigned>((rows + kThreads - 1) / kThreads),
              static_cast<unsigned>((M + kMembers - 1) / kMembers));
}

bool shape_ok(int nq, int nc, int M) {
  return nq >= 1 && nq <= kQMax && nc >= 0 && M >= 1
         && (M + kMembers - 1) / kMembers <= 65535;
}

template <typename T>
int jacobian(const void* const* ptrs, const int64_t* strides,
             const double* consts, const int64_t* cells, const T* grads,
             const T* area, const T* valid, int nq, int nc, int M, int64_t n,
             const T* N, T* J, int device, void* stream) {
  if (!shape_ok(nq, nc, M)) return static_cast<int>(cudaErrorInvalidValue);
  if (nc == 0) return 0;
  int prev = -1;
  cudaError_t err = enter(device, &prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Consts k{consts[0], consts[1], consts[2], consts[3], consts[4]};
  jacobian_kernel<T><<<grid(nc, M), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      fields_of<T>(ptrs, strides), k, cells, grads, area, valid, nq, nc, M, n,
      N, J);
  return static_cast<int>(leave(device, prev));
}

template <typename T>
int residual(const void* const* ptrs, const int64_t* strides,
             const double* consts, const int64_t* cells, const T* grads,
             const T* area, const T* valid, int nq, int nc, int M, int64_t n,
             int kc, const T* X, T* corner, int device, void* stream) {
  if (!shape_ok(nq, nc, M) || kc < 1 || kc > kKMax)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nc == 0) return 0;
  int prev = -1;
  cudaError_t err = enter(device, &prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Consts k{consts[0], consts[1], consts[2], consts[3], consts[4]};
  residual_kernel<T><<<grid(nc, M), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      fields_of<T>(ptrs, strides), k, cells, grads, area, valid, nq, nc, M, n,
      kc, X, corner);
  return static_cast<int>(leave(device, prev));
}

template <typename T>
int node_sum(const T* corner, int nc, const int64_t* inc, int S, int64_t n,
             int M, int kc, const uint8_t* mask, T* out, int device,
             void* stream) {
  if (S < 1 || S > kSMax || kc < 1 || kc > kKMax || !shape_ok(1, nc, M))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  int prev = -1;
  cudaError_t err = enter(device, &prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  node_sum_kernel<T><<<grid(n, M), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      corner, 3 * static_cast<int64_t>(nc), inc, S, n, M, kc, mask, out);
  return static_cast<int>(leave(device, prev));
}

template <typename T>
int coarse(const T* J, int64_t sJ, const uint8_t* fixed, const int64_t* cells,
           const int64_t* slots, const int* offsets, const int* positions,
           int U, int maxlen, const uint8_t* filled, int64_t mm, int M, T* out,
           int device, void* stream) {
  if (M < 1 || U < 0 || U > mm || maxlen < (U > 0 ? 1 : 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per_pair = ((M + kRows - 1) / kRows + kWarps - 1) / kWarps;
  const int64_t pair_ctas = U * per_pair;
  const int64_t fill_ctas = (mm + kLanes * kWarps - 1) / (kLanes * kWarps);
  const int64_t ctas = pair_ctas + fill_ctas;
  if (ctas > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (ctas == 0) return 0;
  int prev = -1;
  cudaError_t err = enter(device, &prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  coarse_kernel<T><<<static_cast<unsigned>(ctas), dim3(kLanes, kWarps), 0,
                     static_cast<cudaStream_t>(stream)>>>(
      J, sJ, fixed, cells, slots, offsets, positions, maxlen, filled, mm, M,
      pair_ctas, out);
  return static_cast<int>(leave(device, prev));
}

}  // namespace

// Plain C interface (loaded with ctypes).  `ptrs` and `strides` are host
// arrays: the 12 fields' device pointers in ops/element_cuda.FIELDS order
// and 4 strides each (elements: the member's, then the field's own axes).
// `consts` is a host array (rho_w g, c_m, L_h, A, n).  cells (c, 3) int64,
// grads (c, 3, 2), area and cell_valid (c,); N (M, n), X (M, n, k) and the
// outputs are contiguous.  Launches on `stream` of `device`, does not
// synchronise and allocates nothing.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for nq outside [1, 6], k outside [1, 3], S outside
// [1, 16], or more than 65535 * 8 members); 0 on success.
// coarse_batched: J (M, c, 3, 3) with member stride sJ (elements) and the
// rest contiguous, the Dirichlet mask `fixed` (n,) bool, cells (c, 3)
// int64, the plan of ops/element_cuda.coarse_plan (slots (U,) int64,
// offsets (U + 1,) and positions int32, the longest pair's length maxlen,
// filled (m m,) bool), out (M, m, m) contiguous, mm = m m.
#define ELEMENT_ENTRIES(T, SUFFIX)                                            \
  extern "C" int element_jacobian_batched_##SUFFIX(                          \
      const void* const* ptrs, const int64_t* strides, const double* consts, \
      const int64_t* cells, const T* grads, const T* area, const T* valid,   \
      int nq, int nc, int M, int64_t n, const T* N, T* J, int device,        \
      void* stream) {                                                         \
    return jacobian<T>(ptrs, strides, consts, cells, grads, area, valid, nq, \
                       nc, M, n, N, J, device, stream);                       \
  }                                                                           \
  extern "C" int element_residual_batched_##SUFFIX(                          \
      const void* const* ptrs, const int64_t* strides, const double* consts, \
      const int64_t* cells, const T* grads, const T* area, const T* valid,   \
      int nq, int nc, int M, int64_t n, int kc, const T* X, T* corner,       \
      int device, void* stream) {                                             \
    return residual<T>(ptrs, strides, consts, cells, grads, area, valid, nq, \
                       nc, M, n, kc, X, corner, device, stream);              \
  }                                                                           \
  extern "C" int node_sum_batched_##SUFFIX(                                   \
      const T* corner, int nc, const int64_t* inc, int S, int64_t n, int M,  \
      int kc, const uint8_t* mask, T* out, int device, void* stream) {        \
    return node_sum<T>(corner, nc, inc, S, n, M, kc, mask, out, device,      \
                       stream);                                               \
  }                                                                           \
  extern "C" int coarse_batched_##SUFFIX(                                     \
      const T* J, int64_t sJ, const uint8_t* fixed, const int64_t* cells,    \
      const int64_t* slots, const int* offsets, const int* positions, int U, \
      int maxlen, const uint8_t* filled, int64_t mm, int M, T* out,         \
      int device, void* stream) {                                             \
    return coarse<T>(J, sJ, fixed, cells, slots, offsets, positions, U,      \
                     maxlen, filled, mm, M, out, device, stream);             \
  }

ELEMENT_ENTRIES(float, f32)
ELEMENT_ENTRIES(double, f64)
