// Batched eigendecomposition of small symmetric matrices (n <= 8) by cyclic
// Jacobi, for NVIDIA Hopper (sm_90a).  Plain C interface, loaded with
// ctypes by ops/symeig.py; built into one library with knn.cu.
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
// matrix's squared Frobenius norm.  `sweeps` (may be null) receives the
// sweeps each matrix took.  Nothing is allocated here; one kernel goes to
// the caller's stream with a static grid, so a call can be captured.
//
// What bounds it on the H100: neither bytes nor operations.  A 6x6 matrix
// is 144 bytes in, 168 out, and ~6 sweeps of 15 rotations of ~100 fp64
// operations: nanoseconds at the card's rates.  At B=1 a call costs its
// launch plus one thread's chain of dependent fp64 divisions and square
// roots (0.030 ms at n=6 on the card, PERF.md).  The design keeps the whole
// matrix in one thread's registers (one matrix per thread, fully unrolled
// over compile-time n, no shared memory, no synchronisation), the layout
// that lets a batch of thousands of matrices fill the card.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxSweeps = 20;
constexpr double kTol = 1e-15;
constexpr int kThreads = 64;

// Offset of (i, j) in the packed upper triangle of an n x n matrix.
template <int N>
__device__ __forceinline__ constexpr int tri(int i, int j) {
  return i <= j ? i * (2 * N - i + 1) / 2 + (j - i)
                : j * (2 * N - j + 1) / 2 + (i - j);
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    symeig_kernel(const float* __restrict__ A, float* __restrict__ w,
                  float* __restrict__ V, int* __restrict__ sweeps, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* in = A + static_cast<int64_t>(b) * N * N;
  double a[N * (N + 1) / 2];
  double v[N * N];
  double norm2 = 0.0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = i; j < N; ++j) {
      const double x = static_cast<double>(in[j * N + i]);  // lower triangle
      a[tri<N>(i, j)] = x;
      norm2 += (i == j ? 1.0 : 2.0) * x * x;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) v[i * N + j] = i == j ? 1.0 : 0.0;
  }
  const double stop = kTol * kTol * norm2;

  int sweep = 0;
  for (; sweep < kMaxSweeps; ++sweep) {
    double off = 0.0;
#pragma unroll
    for (int p = 0; p < N; ++p)
#pragma unroll
      for (int q = p + 1; q < N; ++q) off += a[tri<N>(p, q)] * a[tri<N>(p, q)];
    if (!(off > stop)) break;  // converged (or NaN: nothing to gain)
#pragma unroll
    for (int p = 0; p < N; ++p) {
#pragma unroll
      for (int q = p + 1; q < N; ++q) {
        const double apq = a[tri<N>(p, q)];
        if (apq == 0.0) continue;
        const double app = a[tri<N>(p, p)];
        const double aqq = a[tri<N>(q, q)];
        // The rotation that zeroes (p, q) (Golub & Van Loan 8.5.2), with
        // the smaller angle; tau = s / (1 + c) keeps the update stable.
        const double theta = (aqq - app) / (2.0 * apq);
        const double at = fabs(theta);
        double t = at > 1e150 ? 0.5 / at : 1.0 / (at + sqrt(1.0 + at * at));
        if (theta < 0.0) t = -t;
        const double c = rsqrt(1.0 + t * t);
        const double s = t * c;
        const double tau = s / (1.0 + c);
        a[tri<N>(p, p)] = app - t * apq;
        a[tri<N>(q, q)] = aqq + t * apq;
        a[tri<N>(p, q)] = 0.0;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          if (k == p || k == q) continue;
          const double akp = a[tri<N>(k, p)];
          const double akq = a[tri<N>(k, q)];
          a[tri<N>(k, p)] = akp - s * (akq + tau * akp);
          a[tri<N>(k, q)] = akq + s * (akp - tau * akq);
        }
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const double vkp = v[k * N + p];
          const double vkq = v[k * N + q];
          v[k * N + p] = vkp - s * (vkq + tau * vkp);
          v[k * N + q] = vkq + s * (vkp - tau * vkq);
        }
      }
    }
  }

  // Ascending order: a bubble network of compare-exchanges on constant
  // indices (a data-dependent index would move the arrays to local
  // memory).  A NaN compares false and stays where it is.
  double d[N];
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = a[tri<N>(i, i)];
#pragma unroll
  for (int pass = 0; pass < N - 1; ++pass) {
#pragma unroll
    for (int i = 0; i < N - 1 - pass; ++i) {
      const bool swap = d[i] > d[i + 1];
      const double lo = swap ? d[i + 1] : d[i];
      const double hi = swap ? d[i] : d[i + 1];
      d[i] = lo;
      d[i + 1] = hi;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const double x = v[k * N + i];
        const double y = v[k * N + i + 1];
        v[k * N + i] = swap ? y : x;
        v[k * N + i + 1] = swap ? x : y;
      }
    }
  }

  float* wo = w + static_cast<int64_t>(b) * N;
  float* vo = V + static_cast<int64_t>(b) * N * N;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    wo[i] = static_cast<float>(d[i]);
#pragma unroll
    for (int j = 0; j < N; ++j) vo[i * N + j] = static_cast<float>(v[i * N + j]);
  }
  if (sweeps != nullptr) sweeps[b] = sweep;
}

template <int N>
int launch(const float* A, float* w, float* V, int* sweeps, int B,
           cudaStream_t stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  symeig_kernel<N><<<blocks, kThreads, 0, stream>>>(A, w, V, sweeps, B);
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
