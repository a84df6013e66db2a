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
// Contract (same as the plain version, ops/knn.py), for each of B items
// (the batch axis a vmapped caller adds; every pointer below holds B
// items back to back and the grid's z axis picks the item):
//   for each query row q < qcnt: the K nearest targets t < tcnt with
//   d = fmaf(dz,dz,fmaf(dy,dy,dx*dx)) < max_sq in fp32, ascending, ties to
//   the lower compacted slot; idx is mapped back to the caller's original
//   target index through perm.  Empty slots (fewer than K targets in range,
//   or q >= qcnt) get sqd = max_sq and idx = 0.  A NaN distance is never
//   inserted.  Both counts are read from device memory, so a caller never
//   syncs; nothing is allocated here (the wrapper hands in the outputs and
//   the scratch), both kernels go to the caller's stream with a static
//   grid, so a call can be captured in a CUDA graph.
//
// What bounds it on the H100: fp32 instruction slots, not bytes.  At the
// scan-to-map surf shape (11059 live queries x 32984 valid targets) a call
// is 3.6e8 pair distances: 0.0007 ms of bytes against 0.049 ms of
// operations (9 flop a pair at 67 TFLOP/s).  A pair costs six fp32-pipe
// instructions (3 FADD, 1 FMUL, 2 FFMA) plus one compare, and every warp
// instruction takes a scheduler slot, so no exact kernel can pass ~0.6-0.75 of
// that bound.  No tensor cores and no norm expansion: the contraction is 3
// wide, and |q|^2 - 2qt + |t|^2 loses the digits that decide a neighbour
// at 80 m coordinates.
//
// What the design does about it:
//  1. A 2-D grid, query tiles x target splits.  Q is at most 12288, too
//     few threads for 132 SMs x 4 schedulers, so the compacted targets are
//     cut into S contiguous ranges, computed here from the device count
//     (split s covers [s*ceil(tcnt/S), (s+1)*ceil(tcnt/S))): every launched
//     split has live work whatever the valid share is.  Query tiles past
//     qcnt leave at once.  The wrapper picks S from the static shapes.
//  2. Register-tiled queries: a thread holds R queries and their R sorted
//     top-K lists in registers and reads each target once for all of them.
//  3. Targets are 16-byte records (x, y, z, 0) in shared memory: one
//     broadcast LDS.128 per target per warp.  That load still costs the
//     SM's shared-memory pipe 4 cycles a warp, which is why R = 1 loses.
//  4. Asynchronous target tiles: one thread brings each tile in with a 1-D
//     bulk copy (cp.async.bulk) that completes on an mbarrier, into a ring
//     of kStages tiles, so the copy of tile n+1 runs under the arithmetic
//     of tile n.
//  5. No loop-carried branch: the distances of U targets x R queries are
//     computed unconditionally and one flag (any d below its query's
//     current K-th best) is all the loop keeps of them.  At K=5 a flagged
//     batch is only noted and the warp works its noted batches off
//     together (see knn_partial); at K=1, where an insert is two selects,
//     it is rechecked and inserted on the spot.  Either way each pair is
//     rechecked with `<` in slot order, so ties and NaN behave as in a
//     one-by-one scan.
//  6. An exact merge: each block writes its R x K partial lists (distance,
//     compacted slot) to scratch laid out (B, S, K, Q); knn_merge inserts the
//     live splits' lists in split order with the same strict `<`, which is
//     the lexicographic order by (distance, slot) because split s holds
//     lower slots than split s+1; then it maps through perm, fills empties
//     and writes idx (int64) and sqd.
// What is left between it and the bound is in PERF.md: the inserts (most
// in-range pairs are inserted once every split keeps its own list), the
// shared-memory pipe, and two dependent launches at the small shapes.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

// Tunables: defaults as measured on one H100 by tools/knn_tune.py, which
// rebuilds this file with -DKNN_<name>=<value> (the sweep is in PERF.md).
#ifndef KNN_K5_R
#define KNN_K5_R 2          // queries per thread at K=5
#endif
#ifndef KNN_K5_U
#define KNN_K5_U 4          // targets per guarded batch at K=5
#endif
#ifndef KNN_K5_THREADS
#define KNN_K5_THREADS 128
#endif
#ifndef KNN_K5_MINB
#define KNN_K5_MINB 8       // blocks per SM the register budget allows
#endif
#ifndef KNN_K1_R
#define KNN_K1_R 2
#endif
#ifndef KNN_K1_U
#define KNN_K1_U 4
#endif
#ifndef KNN_K1_THREADS
#define KNN_K1_THREADS 128
#endif
#ifndef KNN_K1_MINB
#define KNN_K1_MINB 8
#endif
#ifndef KNN_TILE
#define KNN_TILE 512        // targets per shared-memory tile (16 B each)
#endif
#ifndef KNN_STAGES
#define KNN_STAGES 2        // tiles in the ring
#endif
#ifndef KNN_K5_BUF
#define KNN_K5_BUF 16       // batches a lane can note (0: insert in place)
#endif
#ifndef KNN_K1_BUF
#define KNN_K1_BUF 0
#endif
#ifndef KNN_MERGE_WARPS
#define KNN_MERGE_WARPS 8   // warps that share the splits of 32 queries
#endif
#ifndef KNN_MERGE_BATCH
#define KNN_MERGE_BATCH 4   // splits whose lists a merge warp loads at once
#endif

namespace {

constexpr int kTile = KNN_TILE;
constexpr int kStages = KNN_STAGES;
constexpr int kMergeWarps = KNN_MERGE_WARPS;
constexpr int kMergeBatch = KNN_MERGE_BATCH;
constexpr size_t kRingBytes =
    (size_t)kStages * kTile * sizeof(float4) + kStages * sizeof(uint64_t);

template <int K> struct Tune;
template <> struct Tune<5> {
  static constexpr int R = KNN_K5_R, U = KNN_K5_U, B = KNN_K5_BUF,
                       threads = KNN_K5_THREADS, minb = KNN_K5_MINB;
};
template <> struct Tune<1> {
  static constexpr int R = KNN_K1_R, U = KNN_K1_U, B = KNN_K1_BUF,
                       threads = KNN_K1_THREADS, minb = KNN_K1_MINB;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// 1-D bulk copy global -> shared; `bytes` and both addresses are multiples
// of 16.  Completion is counted on `bar` in bytes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Sorted insert of (d, ti) into an ascending list; an equal distance stays
// behind the entries already there (which have lower slots).
template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float d,
                                       int ti) {
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

// The range of compacted slots that split s of S covers.
__device__ __forceinline__ int split_len(int tcnt, int S) {
  return (tcnt + S - 1) / S;
}

// Partial top-K of one query tile over one target split of item
// blockIdx.z.  part_d / part_i are (B, S, K, Q): row (b, s, j) holds slot j
// of every query's list for split s of item b.
//
// With B > 0 a pair that beats its query's K-th best is not inserted where
// it is found.  An insert executed for one lane costs the warp as much as
// one executed for all 32, and at the surf shape some lane of a warp has a
// hit in most batches.  So a lane that has a hit only notes the batch (one
// predicated store of its offset into the lane's B-deep queue in shared
// memory), and the warp works its queues off together, when a lane's
// queue is full and before the tile is given up: each lane recomputes its
// noted batches' distances and inserts with `<` in slot order.  The K-th
// best is stale between two such rounds, so batches are noted that a
// one-by-one scan would have passed over; the recheck refuses their pairs,
// and the lists come out the same.
template <int K, int R, int U, int B, int THREADS, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
knn_partial(const float* __restrict__ query, const float4* __restrict__ tgt,
            const int* __restrict__ tcnt_ptr, const int* __restrict__ qcnt_ptr,
            int Q, int T, float max_sq, float* __restrict__ part_d,
            int* __restrict__ part_i) {
  static_assert(kTile % U == 0, "a tile holds whole batches");
  static_assert(THREADS >= U && THREADS % 32 == 0, "whole warps");
  extern __shared__ __align__(128) unsigned char smem[];
  float4* tiles = reinterpret_cast<float4*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + (size_t)kStages * kTile * sizeof(float4));
  // Noted batches, [depth][thread]: a warp's lanes hit 32 banks.
  int* noted = reinterpret_cast<int*>(smem + kRingBytes) + threadIdx.x;

  const int item = blockIdx.z;
  query += (size_t)item * Q * 3;
  tgt += (size_t)item * T;
  tcnt_ptr += item;
  qcnt_ptr += item;
  part_d += (size_t)item * gridDim.y * K * Q;
  part_i += (size_t)item * gridDim.y * K * Q;
  const int qcnt = min(*qcnt_ptr, Q);
  const int q0 = blockIdx.x * (THREADS * R);
  if (q0 >= qcnt) return;                       // whole tile past the count
  const int tcnt = min(*tcnt_ptr, T);
  const int S = gridDim.y, s = blockIdx.y;
  const int len = split_len(tcnt, S);
  const int begin = s * len;
  if (begin >= tcnt) return;                    // split past the count
  const int end = min(begin + len, tcnt);
  const int ntiles = (end - begin + kTile - 1) / kTile;

  // A dead row (past qcnt inside a live tile) searches with NaN
  // coordinates: every distance is NaN and nothing is inserted.
  float qx[R], qy[R], qz[R], bd[R][K];
  int bi[R][K];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int q = q0 + r * THREADS + threadIdx.x;
    const bool live = q < qcnt;
    qx[r] = live ? query[3 * q + 0] : CUDART_NAN_F;
    qy[r] = live ? query[3 * q + 1] : CUDART_NAN_F;
    qz[r] = live ? query[3 * q + 2] : CUDART_NAN_F;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      bd[r][j] = max_sq;
      bi[r][j] = -1;
    }
  }

  auto fetch = [&](int n) {                     // thread 0 only
    const int slot = n % kStages;
    const int cnt = min(kTile, end - begin - n * kTile);
    const uint32_t bytes = (uint32_t)cnt * sizeof(float4);
    mbar_expect_tx(&full[slot], bytes);
    bulk_load(tiles + slot * kTile, tgt + begin + n * kTile, bytes,
              &full[slot]);
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) mbar_init(&full[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int n = 0; n < min(kStages, ntiles); ++n) fetch(n);

  for (int n = 0; n < ntiles; ++n) {
    const int slot = n % kStages;
    const int cnt = min(kTile, end - begin - n * kTile);
    const int padded = (cnt + U - 1) / U * U;
    float4* tp = tiles + slot * kTile;
    mbar_wait(&full[slot], (n / kStages) & 1);
    if (padded != cnt) {
      // The split's last tile: fill its last batch with records at
      // infinity, whose distance is never below anything.
      if ((int)threadIdx.x < padded - cnt)
        tp[cnt + threadIdx.x] =
            make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, 0.f);
      __syncthreads();
    }
    const int base = begin + n * kTile;

    // The distances of batch t to the lane's R queries; true if any of
    // them is below its query's K-th best.
    auto distances = [&](int t, float (&d)[R][U]) {
      bool any = false;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float4 tv = tp[t + u];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float dx = qx[r] - tv.x;
          const float dy = qy[r] - tv.y;
          const float dz = qz[r] - tv.z;
          d[r][u] = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
          any |= d[r][u] < bd[r][K - 1];
        }
      }
      return any;
    };
    // A noted batch, worked off: its distances again, and each pair that
    // beats its query's K-th best inserted, in slot order.  The lanes of a
    // warp are here for different batches and their hits sit at different
    // (r, u), so there is one insert per query, not one per pair: it takes
    // the query's first hit among the U pairs and is revisited while hits
    // are left (rarely: a second hit in one batch).
    auto scan_batch = [&](int t) {
      float d[R][U];
      distances(t, d);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        for (;;) {
          float dsel = 0.f;
          int usel = -1;
#pragma unroll
          for (int u = U - 1; u >= 0; --u) {
            if (d[r][u] < bd[r][K - 1]) {
              dsel = d[r][u];
              usel = u;
            }
          }
          if (usel < 0) break;
          insert<K>(bd[r], bi[r], dsel, base + t + usel);
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (u == usel) d[r][u] = CUDART_INF_F;
        }
      }
    };
    int held = 0;                               // batches the lane has noted
    auto work_off = [&]() {
      for (int e = 0; e < held; ++e) scan_batch(noted[e * THREADS]);
      held = 0;
    };

    for (int t = 0; t < padded; t += U) {
      float d[R][U];
      const bool any = distances(t, d);
      if constexpr (B == 0) {
        if (any) {
          // Recheck each pair in slot order and insert where it stands.
#pragma unroll
          for (int u = 0; u < U; ++u) {
#pragma unroll
            for (int r = 0; r < R; ++r) {
              if (d[r][u] < bd[r][K - 1])
                insert<K>(bd[r], bi[r], d[r][u], base + t + u);
            }
          }
        }
      } else {
        if (any) {
          noted[held * THREADS] = t;
          ++held;
        }
        // Work off when a lane's queue is full, and before the tile is
        // given up.  The trip count is the block's, so every lane votes.
        if (t + U >= padded || __any_sync(0xffffffffu, held == B)) work_off();
      }
    }
    // Everyone is done with this slot before its next tile is asked for.
    __syncthreads();
    if (threadIdx.x == 0 && n + kStages < ntiles) fetch(n + kStages);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int q = q0 + r * THREADS + threadIdx.x;
    if (q < qcnt) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const size_t at = ((size_t)s * K + j) * Q + q;
        part_d[at] = bd[r][j];
        part_i[at] = bi[r][j];
      }
    }
  }
}

// Merge the live splits' sorted lists, map through perm, fill empties and
// write the outputs of item blockIdx.y.  A block takes 32 queries; each of its kMergeWarps
// warps merges a contiguous share of the splits for them (coalesced loads,
// the lists of kMergeBatch splits in flight together), in split order with
// the strict `<`; warp 0 then merges the warps' lists in warp order.  A
// lower warp holds lower slots, as a lower split does, so an equal distance
// stays behind the lower slot throughout.
template <int K>
__global__ void __launch_bounds__(32 * kMergeWarps)
knn_merge(const float* __restrict__ part_d, const int* __restrict__ part_i,
          const int64_t* __restrict__ perm, const int* __restrict__ tcnt_ptr,
          const int* __restrict__ qcnt_ptr, int Q, int T, int S, float max_sq,
          int64_t* __restrict__ out_idx, float* __restrict__ out_sqd) {
  __shared__ float warp_d[kMergeWarps][K][32];
  __shared__ int warp_i[kMergeWarps][K][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int q = blockIdx.x * 32 + lane;
  const int item = blockIdx.y;
  part_d += (size_t)item * S * K * Q;
  part_i += (size_t)item * S * K * Q;
  perm += (size_t)item * T;
  tcnt_ptr += item;
  qcnt_ptr += item;
  out_idx += (size_t)item * Q * K;
  out_sqd += (size_t)item * Q * K;
  float bd[K];
  int bi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = max_sq;
    bi[j] = -1;
  }
  if (q < min(*qcnt_ptr, Q)) {
    const int tcnt = min(*tcnt_ptr, T);
    const int len = split_len(tcnt, S);
    const int live = len > 0 ? (tcnt + len - 1) / len : 0;
    const int share = (live + kMergeWarps - 1) / kMergeWarps;
    const int last = min(live, (w + 1) * share);
    for (int s0 = w * share; s0 < last; s0 += kMergeBatch) {
      float d[kMergeBatch][K];
      int i[kMergeBatch][K];
#pragma unroll
      for (int b = 0; b < kMergeBatch; ++b) {
        const int s = min(s0 + b, last - 1);
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const size_t at = ((size_t)s * K + j) * Q + q;
          d[b][j] = part_d[at];
          i[b][j] = part_i[at];
        }
      }
#pragma unroll
      for (int b = 0; b < kMergeBatch; ++b) {
        if (s0 + b < last) {
#pragma unroll
          for (int j = 0; j < K; ++j) {
            if (d[b][j] < bd[K - 1]) insert<K>(bd, bi, d[b][j], i[b][j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    warp_d[w][j][lane] = bd[j];
    warp_i[w][j][lane] = bi[j];
  }
  __syncthreads();
  if (w != 0 || q >= Q) return;
  for (int v = 1; v < kMergeWarps; ++v) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float d = warp_d[v][j][lane];
      if (d < bd[K - 1]) insert<K>(bd, bi, d, warp_i[v][j][lane]);
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const bool found = bi[j] >= 0;
    out_idx[(size_t)q * K + j] = found ? perm[bi[j]] : 0;
    out_sqd[(size_t)q * K + j] = found ? bd[j] : max_sq;
  }
}

template <int K>
cudaError_t launch(const float* query, const float4* tgt, const int64_t* perm,
                   const int* tcnt, const int* qcnt, int B, int Q, int T, int S,
                   float max_sq, float* part_d, int* part_i, int64_t* out_idx,
                   float* out_sqd, cudaStream_t stream) {
  using C = Tune<K>;
  auto kernel = knn_partial<K, C::R, C::U, C::B, C::threads, C::minb>;
  constexpr size_t kSmemBytes =
      kRingBytes + (size_t)C::B * C::threads * sizeof(int);
  if (kSmemBytes > 48 * 1024) {
    static cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (attr != cudaSuccess) return attr;
  }
  const int per_block = C::threads * C::R;
  const dim3 grid((Q + per_block - 1) / per_block, S, B);
  kernel<<<grid, C::threads, kSmemBytes, stream>>>(
      query, tgt, tcnt, qcnt, Q, T, max_sq, part_d, part_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  knn_merge<K><<<dim3((Q + 31) / 32, B), 32 * kMergeWarps, 0, stream>>>(
      part_d, part_i, perm, tcnt, qcnt, Q, T, S, max_sq, out_idx, out_sqd);
  return cudaGetLastError();
}

}  // namespace

// B items of: query (Q,3) f32, tgt (T,4) f32 records, perm (T,) i64, tcnt /
// qcnt (1,) i32, part_d / part_i (S,k,Q) f32 / i32 scratch, out_idx (Q,k)
// i64, out_sqd (Q,k) f32; each argument is the B items back to back, all
// device pointers.  Two kernels on `stream`, whatever B is.
extern "C" int knn_launch_batched(const void* query, const void* tgt,
                                  const void* perm, const void* tcnt,
                                  const void* qcnt, int B, int Q, int T,
                                  int k, int S, float max_sq, void* part_d,
                                  void* part_i, void* out_idx, void* out_sqd,
                                  void* stream) {
  if (Q <= 0 || B == 0) return 0;
  if (S < 1 || S > 65535 || T < 0 || B < 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* q = static_cast<const float*>(query);
  const float4* t = static_cast<const float4*>(tgt);
  const int64_t* p = static_cast<const int64_t*>(perm);
  const int* tc = static_cast<const int*>(tcnt);
  const int* qc = static_cast<const int*>(qcnt);
  float* pd = static_cast<float*>(part_d);
  int* pi = static_cast<int*>(part_i);
  int64_t* oi = static_cast<int64_t*>(out_idx);
  float* od = static_cast<float*>(out_sqd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1:
      return launch<1>(q, t, p, tc, qc, B, Q, T, S, max_sq, pd, pi, oi, od,
                       s);
    case 5:
      return launch<5>(q, t, p, tc, qc, B, Q, T, S, max_sq, pd, pi, oi, od,
                       s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// What this build was compiled with, for the wrapper's choice of S and for
// reports: out = {R, U, threads per block, blocks per SM asked of ptxas,
// targets per tile, tiles in the ring, depth of a lane's queue}.
// Returns 0, or -1 for another k.
extern "C" int knn_config(int k, int* out) {
  int r, u, th, mb, b;
  switch (k) {
    case 1:
      r = Tune<1>::R, u = Tune<1>::U, th = Tune<1>::threads,
      mb = Tune<1>::minb, b = Tune<1>::B;
      break;
    case 5:
      r = Tune<5>::R, u = Tune<5>::U, th = Tune<5>::threads,
      mb = Tune<5>::minb, b = Tune<5>::B;
      break;
    default:
      return -1;
  }
  out[0] = r, out[1] = u, out[2] = th, out[3] = mb, out[4] = kTile,
  out[5] = kStages, out[6] = b;
  return 0;
}

extern "C" const char* knn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
