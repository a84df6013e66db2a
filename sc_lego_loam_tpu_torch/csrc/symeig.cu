// Batched eigendecomposition of small symmetric matrices (n <= 8) by
// parallel-ordered Jacobi, one warp per matrix, for NVIDIA Hopper (sm_90a).
// Plain C interface, loaded with ctypes by ops/symeig.py; built into one
// library with knn.cu.
//
// Replaces: jnp.linalg.eigh inside the JAX package's jitted steps
// (sc_lego_loam_tpu/ops/solver.py:156, the degeneracy guard of both LM
// solves) and, through Horn's quaternion method, jnp.linalg.svd in the ICP
// rigid fit (sc_lego_loam_tpu/utils/se3.py:195,221).  Those are XLA code,
// not Pallas kernels.  On the card torch.linalg.eigh and torch.linalg.svd
// read their status on the host, which stalls the stream and cannot be
// captured in a CUDA graph; this kernel reads nothing back.
//
// Contract, for each of B matrices (row-major n x n fp32, back to back):
// the lower triangle is read (torch.linalg.eigh's default); w gets the n
// eigenvalues ascending, V (n x n, row-major) the unit eigenvectors as
// columns, V[i][j] = component i of the vector of w[j].  Everything is
// accumulated in fp64 registers; outputs are rounded to fp32 once.  The
// sweep count is data dependent but capped (kMaxSweeps) and decided on the
// device: a sweep runs while the off-diagonal mass exceeds kTol^2 of the
// matrix's squared Frobenius norm (a NaN fails that test and stops at
// once).  `sweeps` (may be null) receives the sweeps each matrix took.
// Nothing is allocated here; one kernel goes to the caller's stream with a
// static grid, so a call can be captured.  The order of every shuffle and
// sum is fixed, so two launches are bit-equal.
//
// What bounds it on the H100: neither bytes nor operations.  A 6x6 matrix
// is 144 bytes in, 168 out, and ~5 sweeps of ~2,000 fp64 operations:
// nanoseconds at the card's rates.  A call at B=1 costs its launch plus a
// chain of dependent steps, and the chain is what the design shortens.
// A thread per matrix walks the cyclic order alone: 15 strictly serial
// rotations a sweep at n=6, each a chain of fp64 divisions and square
// roots (~330 ns a rotation, 0.030 ms a call on the card).  Here (0.009 ms
// at n=6; a round ~0.3 us, PERF.md):
// - A warp per matrix (kWarps matrices a block): lane j holds column j of
//   A, lane 8 + j column j of V (n <= 8; lanes 16-31 hold zeros), so one
//   instruction updates both.  The grid is ceil(B / kWarps) blocks, so
//   B = 3 to 16 take B=1's time and B=4096 spreads over the 132 SMs.
// - Parallel (round-robin, circle-method) ordering: with M = n rounded up
//   to even (index n is a dummy row and column of zeros when n is odd), a
//   sweep is M-1 rounds of M/2 disjoint rotations, so a round's rotations
//   commute and run at once: at n=6, 5 rounds of 3 in place of 15 serial
//   rotations.  Round r pairs M-1 with r and (r+k) with (r-k), mod M-1.
//   The schedule is constant per template N and fully unrolled: every
//   register index is a compile-time constant (a run-time index would move
//   the arrays to local memory); a lane's own row is picked by predicated
//   selects, its partner lane computed from r.
// - A round: the partner's column comes by shuffle (issued first, off the
//   angle's chain); every lane of a pair, A's and V's, takes a_pp, a_qq and
//   lane p's a_pq (one canonical copy) from the two A lanes, so all compute
//   bit-equal angles; the columns rotate (A J, V J in one pass); the A
//   lanes take each pair's (c, s) from its lower lane and rotate their rows
//   (J^T A); and the pair's 2x2 diagonal block is set exactly
//   (a_pp - t a_pq, a_qq + t a_pq, 0).  Computing every pair's angle in
//   every lane instead saves that shuffle but costs more fp64 issue than
//   it saves: slower on the card (0.0128 against 0.0107 ms at n=6).
// - A short angle chain: two fp64 reciprocal square roots and no division
//   or square root.  With h = a_qq - a_pp, g = 2 a_pq, rho = rsqrt(h^2+g^2),
//   the smaller rotation has cos 2phi = |h| rho, so c^2 = (1 + |h| rho)/2;
//   ic = rsqrt(c^2) gives c = c^2 ic, s = sign(h) g rho ic / 2 and
//   t = s ic, with no cancellation (1 + |h| rho >= 1).  The updates are
//   c x - s y in fp64: the tau form (Golub & Van Loan 8.5.2) guards
//   against rounding that fp64 makes ~1e-14 over a call, far below the
//   fp32 outputs, and it would cost a division.
// - The stopping test is warp-uniform: the A lanes' off-diagonal squares
//   summed by an xor butterfly (a + b == b + a in IEEE, so every lane holds
//   the same bits) and taken from lane 0.  All lanes leave together.
// - Ascending order without a network: each lane gathers the n diagonal
//   values by shuffle and counts those that come before its column's
//   (value, then index; a NaN after every number); A's lane writes the
//   eigenvalue and V's lane the eigenvector straight to that rank.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxSweeps = 20;
constexpr double kTol = 1e-15;
constexpr int kWarps = 4;                 // matrices (warps) per block
constexpr unsigned kFull = 0xffffffffu;
constexpr double kMinNormal = 2.2250738585072014e-308;

// The pairs of round r over M (even) indices: pair 0 is (r, M-1), pair k
// is ((r+k) mod (M-1), (r-k) mod (M-1)), lower index first.
template <int M>
__device__ __forceinline__ constexpr int pair_a(int r, int k) {
  return k == 0 ? r : (r + k) % (M - 1);
}
template <int M>
__device__ __forceinline__ constexpr int pair_b(int r, int k) {
  return k == 0 ? M - 1 : (r - k + M - 1) % (M - 1);
}
template <int M>
__device__ __forceinline__ constexpr int pair_p(int r, int k) {
  return pair_a<M>(r, k) < pair_b<M>(r, k) ? pair_a<M>(r, k)
                                           : pair_b<M>(r, k);
}
template <int M>
__device__ __forceinline__ constexpr int pair_q(int r, int k) {
  return pair_a<M>(r, k) < pair_b<M>(r, k) ? pair_b<M>(r, k)
                                           : pair_a<M>(r, k);
}

// Lane j's partner in round r (a lane >= M has none: itself).
template <int M>
__device__ __forceinline__ int partner(int r, int j) {
  if (j >= M) return j;
  if (j == M - 1) return r;
  if (j == r) return M - 1;
  int x = 2 * r - j;
  x += x < 0 ? M - 1 : 0;
  x -= x >= M - 1 ? M - 1 : 0;
  return x;
}

// 1 / sqrt(x) for a normal x > 0: the hardware's approximation (~2^-22)
// and one Newton step in fp64, y <- y + y (1 - x y^2) / 2, to ~2^-43.
// That is the rotations' orthogonality a step, ~1e-11 over a call, far
// under the fp32 outputs.  The library's rsqrt(double) adds a second step
// and a path for other inputs; the callers here pass only normal numbers,
// and select away what a zero would give.
__device__ __forceinline__ double rsqrt_nr(double x) {
  double y;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
  return fma(0.5 * y, fma(-x * y, y, 1.0), y);
}

// x summed over the warp: an xor butterfly over the lanes that can hold
// a value (the others hold 0), then lane 0's sum, so every lane has the
// same bits.
template <int N>
__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int o = N > 4 ? 4 : (N > 2 ? 2 : 1); o > 0; o >>= 1)
    x += __shfl_xor_sync(kFull, x, o);
  return __shfl_sync(kFull, x, 0);
}

// One round of M/2 disjoint rotations.  Lane `lane` holds column `col` =
// lane & 7 of A (lanes 0-7) or of V (lanes 8-15) in x (rows 0..N-1; the
// dummy row is 0 and never stored); lanes 16-31 hold zeros.
template <int N>
__device__ __forceinline__ void jacobi_round(const int r, const int lane,
                                             double (&x)[N]) {
  constexpr int M = N + (N & 1);
  const int col = lane & 7;
  const bool is_a = lane < 8;
  const int pc = partner<M>(r, col);      // the partner column

  // The partner's column in this lane's group: not on the angle's chain.
  double xo[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
    xo[i] = __shfl_sync(kFull, x[i], (lane & ~7) | pc);

  // A's diagonal entry and the entry in the partner's row (meant in the A
  // lanes; the others select garbage and never use it).
  double d = 0.0, o = 0.0;
#pragma unroll
  for (int k = 0; k < M / 2; ++k) {
    const int p = pair_p<M>(r, k), q = pair_q<M>(r, k);
    if (q < N) {
      if (col == p) { d = x[p]; o = x[q]; }
      if (col == q) { d = x[q]; o = x[p]; }
    } else if (col == p) {
      d = x[p];                           // paired with the dummy: o = 0
    }
  }
  // Both A lanes of the pair, and their V lanes, take a_pp, a_qq and lane
  // p's a_pq from the A lanes: bit-equal angles everywhere.
  const double d_me = __shfl_sync(kFull, d, col);
  const double o_me = __shfl_sync(kFull, o, col);
  const double d_pt = __shfl_sync(kFull, d, pc);
  const double o_pt = __shfl_sync(kFull, o, pc);
  const bool is_p = col < pc;
  const double app = is_p ? d_me : d_pt;
  const double aqq = is_p ? d_pt : d_me;
  const double apq = is_p ? o_me : o_pt;

  // The rotation that zeroes (p, q), the smaller of the two.
  const double h = aqq - app;
  const double g = 2.0 * apq;
  const double r2 = fma(h, h, g * g);
  const double rho = rsqrt_nr(r2);
  const double c2 = fma(0.5 * fabs(h), rho, 0.5);   // in [1/2, 1]
  const double ic = rsqrt_nr(c2);
  // r2 below the smallest normal needs |a_pq| < 1e-154, far under the
  // stopping limit of any fp32 input (norm^2 >= 1e-90): left unturned.
  const bool rot = g != 0.0 && r2 >= kMinNormal;
  const double c = rot ? c2 * ic : 1.0;
  const double s = rot ? copysign(0.5, h) * g * rho * ic : 0.0;
  const double t = rot ? s * ic : 0.0;

  // Columns: A J and V J in one pass over both groups.
  const double sig = is_p ? -s : s;
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = fma(c, x[i], sig * xo[i]);
  // Rows: J^T (A J), every pair's (c, s) from its lower A lane; V's lanes
  // take the identity.
#pragma unroll
  for (int k = 0; k < M / 2; ++k) {
    const int p = pair_p<M>(r, k), q = pair_q<M>(r, k);
    if (q < N) {                          // a dummy pair turns nothing
      const double cp = __shfl_sync(kFull, c, p);   // every lane shuffles
      const double sp = __shfl_sync(kFull, s, p);
      const double ck = is_a ? cp : 1.0;
      const double sk = is_a ? sp : 0.0;
      const double xp = x[p], xq = x[q];
      x[p] = fma(ck, xp, -sk * xq);
      x[q] = fma(sk, xp, ck * xq);
    }
  }
  // The pair's 2x2 diagonal block of A, exactly.
#pragma unroll
  for (int k = 0; k < M / 2; ++k) {
    const int p = pair_p<M>(r, k), q = pair_q<M>(r, k);
    if (q < N) {
      if (lane == p) { x[p] = fma(-t, apq, app); x[q] = 0.0; }
      if (lane == q) { x[q] = fma(t, apq, aqq); x[p] = 0.0; }
    }
  }
}

// At least one block an SM is all the bounds ask: without the 1, ptxas
// spilled the loop-carried limit and sweep count at n = 4 and 6 (12-16
// bytes) at 56-72 registers; with it, 0 spills.
template <int N>
__global__ void __launch_bounds__(kWarps * 32, 1)
    symeig_kernel(const float* __restrict__ A, float* __restrict__ w,
                  float* __restrict__ V, int* __restrict__ sweeps, int B) {
  constexpr int M = N + (N & 1);
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;                     // the whole warp
  const int lane = threadIdx.x & 31;
  const int col = lane & 7;               // this lane's column of A or V
  const bool live = lane < 16 && col < N;
  const float* in = A + static_cast<int64_t>(b) * N * N;

  double x[N];
  double sq = 0.0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    // A's (i, col) from the lower triangle: row max(i, col), column
    // min(i, col); V starts as I.
    const double e =
        lane < 8 ? static_cast<double>(
                       in[i >= col ? i * N + col : col * N + i])
                 : (i == col ? 1.0 : 0.0);
    x[i] = live ? e : 0.0;
    sq = fma(x[i], x[i], sq);
  }
  // Sums over lanes 0-7 (A's columns).  Both triangles count in `off`
  // below, so the limit is twice the triangle's.
  const double stop = 2.0 * kTol * kTol * warp_sum<N>(sq);

  int sweep = 0;
  for (; sweep < kMaxSweeps; ++sweep) {
    double off = 0.0;
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i != col) off = fma(x[i], x[i], off);
    off = warp_sum<N>(off);
    if (!(off > stop)) break;             // converged (or NaN: nothing to gain)
#pragma unroll
    for (int r = 0; r < M - 1; ++r) jacobi_round<N>(r, lane, x);
  }

  // Ascending: the rank of column col's eigenvalue among the n (value,
  // then index; a NaN after every number), where its outputs go: A's lane
  // writes w, V's lane the eigenvector.
  double dj = 0.0;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (col == i) dj = x[i];
  dj = __shfl_sync(kFull, dj, col);       // A's diagonal, in V's lanes too
  const bool nan_j = isnan(dj);
  int rank = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const double di = __shfl_sync(kFull, dj, i);
    const bool nan_i = isnan(di);
    const bool before =
        nan_i != nan_j
            ? nan_j
            : (nan_i ? i < col : (di < dj || (di == dj && i < col)));
    rank += before ? 1 : 0;
  }
  if (live && lane < 8) {
    w[static_cast<int64_t>(b) * N + rank] = static_cast<float>(dj);
  } else if (live) {
    float* vo = V + static_cast<int64_t>(b) * N * N;
#pragma unroll
    for (int i = 0; i < N; ++i) vo[i * N + rank] = static_cast<float>(x[i]);
  }
  if (lane == 0 && sweeps != nullptr) sweeps[b] = sweep;
}

__global__ void symeig_empty_kernel() {}

template <int N>
int launch(const float* A, float* w, float* V, int* sweeps, int B,
           cudaStream_t stream) {
  const int blocks = (B + kWarps - 1) / kWarps;
  symeig_kernel<N><<<blocks, kWarps * 32, 0, stream>>>(A, w, V, sweeps, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B matrices A (B,n,n) f32 -> w (B,n) f32, V (B,n,n) f32, sweeps (B,) i32
// or null; all device pointers.  One kernel on `stream`.
extern "C" int symeig_launch(const void* A, void* w, void* V, void* sweeps,
                             int B, int n, void* stream) {
  if (B == 0) return 0;
  if (B < 0 || n < 1 || n > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* a = static_cast<const float*>(A);
  float* wo = static_cast<float*>(w);
  float* vo = static_cast<float*>(V);
  int* sw = static_cast<int*>(sweeps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1: return launch<1>(a, wo, vo, sw, B, s);
    case 2: return launch<2>(a, wo, vo, sw, B, s);
    case 3: return launch<3>(a, wo, vo, sw, B, s);
    case 4: return launch<4>(a, wo, vo, sw, B, s);
    case 5: return launch<5>(a, wo, vo, sw, B, s);
    case 6: return launch<6>(a, wo, vo, sw, B, s);
    case 7: return launch<7>(a, wo, vo, sw, B, s);
    default: return launch<8>(a, wo, vo, sw, B, s);
  }
}

// An empty kernel with the same block shape, launched on `stream`: its
// time in a graph is the launch floor a symeig call cannot go under.
extern "C" int symeig_empty_launch(void* stream) {
  symeig_empty_kernel<<<1, kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
