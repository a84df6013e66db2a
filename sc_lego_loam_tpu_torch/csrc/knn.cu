// Exact k-nearest-neighbour search over a prefix-compacted target set, for
// NVIDIA Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// ops/cuda_knn.py.
//
// Replaces: sc_lego_loam_tpu/ops/pallas_knn.py::_kernel and
// knn_pallas_prepared (the fused chunk-min Pallas kNN of the scan-to-map
// 5-NN and of the ICP 1-NN).  It computes what that kernel computes, not
// its layout: no (8,T) transposed pad, no strided 128-lane chunks, no int32
// key packing and no quantization, so the result is exact.
//
// Contract (same as the plain version, ops/knn.py):
//   for each query row q < qcnt: the K nearest targets t < tcnt with
//   d = (q-t)^2 < max_sq, ascending, ties to the lower target index;
//   idx is mapped back to the caller's original target index through perm.
//   Empty slots (fewer than K targets in range, or q >= qcnt) get
//   sqd = max_sq and idx = 0.
// Both counts are read from device memory, so a caller never syncs.
//
// What bounds it on the H100: at 12288 live queries x 65536 target slots
// (half valid) one call is ~0.4 G pair distances, each 3 FSUB + 3 FMA + 1
// compare, plus rare top-K inserts: FP32-ALU bound, with the targets read
// from L2 once per block through shared memory.  The design skips past both
// counts (whole blocks past qcnt exit at once, the target loop stops at
// tcnt), uses (q-t)^2 in fp32 instead of the norm expansion, which loses
// digits at 80 m coordinates, and no tensor cores (the contraction is 3
// wide).  One thread per query: at Q <= 12288 that is < 100 blocks of 128
// threads on 132 SMs, so occupancy is low; splitting T over blocks with a
// merge pass is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 2048;   // targets per shared-memory tile (24 KB)

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ query, const float* __restrict__ tgt,
           const int64_t* __restrict__ perm, const int* __restrict__ tcnt_ptr,
           const int* __restrict__ qcnt_ptr, int Q, float max_sq,
           int64_t* __restrict__ out_idx, float* __restrict__ out_sqd) {
  __shared__ float s_t[kTile * 3];
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const int qcnt = min(*qcnt_ptr, Q);
  const int tcnt = *tcnt_ptr;

  float bd[K];
  int bi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = max_sq;
    bi[j] = -1;
  }

  // Whole block past the live queries: write empties and leave together
  // (before any barrier, so no thread waits on one that left).
  if (blockIdx.x * kThreads < qcnt) {
    const bool live = q < qcnt;
    float qx = 0.f, qy = 0.f, qz = 0.f;
    if (live) {
      qx = query[3 * q + 0];
      qy = query[3 * q + 1];
      qz = query[3 * q + 2];
    }
    for (int base = 0; base < tcnt; base += kTile) {
      const int n = min(kTile, tcnt - base);
      for (int e = threadIdx.x; e < 3 * n; e += kThreads)
        s_t[e] = tgt[3 * (int64_t)base + e];
      __syncthreads();
      if (live) {
        for (int t = 0; t < n; ++t) {
          const float dx = qx - s_t[3 * t + 0];
          const float dy = qy - s_t[3 * t + 1];
          const float dz = qz - s_t[3 * t + 2];
          const float d = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
          if (d < bd[K - 1]) {
            // Sorted insert; an equal distance stays behind the earlier
            // (lower-index) entry.
            const int ti = base + t;
#pragma unroll
            for (int j = K - 1; j >= 0; --j) {
              if (j > 0 && d < bd[j - 1]) {
                bd[j] = bd[j - 1];
                bi[j] = bi[j - 1];
              } else if (d < bd[j]) {
                bd[j] = d;
                bi[j] = ti;
              }
            }
          }
        }
      }
      __syncthreads();
    }
  }
  if (q < Q) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const bool found = bi[j] >= 0;
      out_idx[(int64_t)q * K + j] = found ? perm[bi[j]] : 0;
      out_sqd[(int64_t)q * K + j] = found ? bd[j] : max_sq;
    }
  }
}

template <int K>
cudaError_t launch(const float* query, const float* tgt, const int64_t* perm,
                   const int* tcnt, const int* qcnt, int Q, float max_sq,
                   int64_t* out_idx, float* out_sqd, cudaStream_t stream) {
  const int blocks = (Q + kThreads - 1) / kThreads;
  knn_kernel<K><<<blocks, kThreads, 0, stream>>>(
      query, tgt, perm, tcnt, qcnt, Q, max_sq, out_idx, out_sqd);
  return cudaGetLastError();
}

}  // namespace

extern "C" int knn_launch(const void* query, const void* tgt,
                          const void* perm, const void* tcnt,
                          const void* qcnt, int Q, int k, float max_sq,
                          void* out_idx, void* out_sqd, void* stream) {
  if (Q <= 0) return 0;
  const float* q = static_cast<const float*>(query);
  const float* t = static_cast<const float*>(tgt);
  const int64_t* p = static_cast<const int64_t*>(perm);
  const int* tc = static_cast<const int*>(tcnt);
  const int* qc = static_cast<const int*>(qcnt);
  int64_t* oi = static_cast<int64_t*>(out_idx);
  float* od = static_cast<float*>(out_sqd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(q, t, p, tc, qc, Q, max_sq, oi, od, s);
    case 5: return launch<5>(q, t, p, tc, qc, Q, max_sq, oi, od, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* knn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
