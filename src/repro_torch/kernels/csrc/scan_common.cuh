// Shared body of the scan kernels (scan_topk.cu, and the indexed scans
// scan_topk_indexed.cu and scan_topk_indexed_q8.cu through the grouped
// driver of scan_grouped.cuh).
//
// Each computes, for a set of queries over blocks of database rows, the
// ascending top-K of a per-row distance, MASK_DIST on rows whose valid
// flag is 0.  The f32/bf16 scans use  aux[row] + coef * (q . x[row])  with
// aux = ||x||^2 (L2, coef = -2) or 0 (IP, coef = -1); the int8 scan its
// dequantized form (scan_topk_indexed_q8.cu).  ||q||^2 is added by the
// caller.  Order is lexicographic on (distance, flat index), so equal
// distances keep the smaller index and the result does not depend on
// block scheduling.
//
// Top-K selection (WarpTopK): one warp keeps one query's candidates in a
// buffer of BUF >= K + 32 entries.  Candidates below the running K-th
// distance are appended, 32 at a time; when the buffer would overflow,
// the filled prefix is bitonic-sorted and cut back to K.  Rows are
// offered in increasing index, so a candidate equal to the K-th distance
// always loses the tie and strict "<" is exact.  The buffer lives in
// shared memory, or, for K past what a block's shared memory holds, in a
// global scratch the wrapper allocates (slow, and large k is rare); the
// code is the same, since a warp's __syncwarp orders its global accesses
// too.  This is what lets every k_pad up to K_MAX = 16384 run on the
// kernels.
//
// The dense scan (scan_topk.cu) has loops of its own: a register-tiled
// GEMM whose epilogue offers each tile's rows to WarpTopK, and a row scan
// for few queries whose blocks fold their warps' lists.
//
// Pass two (merge_lists_kernel, one block per query): folds that query's
// K-lists into its running K-list.  Each fold keeps the K smallest of
// (running, list) as the elementwise minimum of the running list and the
// reversed list, a bitonic sequence, and sorts it with log2(K) half-
// cleaner stages, so it needs K entries of shared memory (128 KB at
// K = 16384).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <climits>
#include <cmath>

namespace quake {

constexpr float MASK_DIST = 3.0e38f;
constexpr int WARPS = 8;          // warps of a scan block
constexpr int THREADS = WARPS * 32;
constexpr int MERGE_THREADS = 128;
constexpr int K_MAX = 16384;      // the largest K the merge pass takes

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

// (da, ia) strictly before (db, ib) in (distance, index) order.
__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// Ascending bitonic sort of n (a power of two) pairs by one warp.
__device__ inline void warp_bitonic_sort(float* d, int* ix, int n,
                                         int lane) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < (n >> 1); t += 32) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const bool asc = (i & size) == 0;
        const float di = d[i], dj = d[j];
        const int ii = ix[i], ij = ix[j];
        const bool swap = asc ? before(dj, ij, di, ii)
                              : before(di, ii, dj, ij);
        if (swap) {
          d[i] = dj; d[j] = di;
          ix[i] = ij; ix[j] = ii;
        }
      }
      __syncwarp();
    }
  }
}

// The same sort for n of 256 and more (the larger buffers): a
// lane loads four of its compare-exchanges of a stage before it compares
// them, so their loads' latencies overlap instead of adding up.
__device__ inline void warp_bitonic_sort_wide(float* d, int* ix, int n,
                                              int lane) {
  const int half = n >> 1;
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t0 = lane; t0 < half; t0 += 128) {
        float di[4], dj[4];
        int ii[4], ij[4], pi[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int t = t0 + 32 * u;
          pi[u] = 2 * t - (t & (stride - 1));
          if (t < half) {
            di[u] = d[pi[u]];
            dj[u] = d[pi[u] + stride];
            ii[u] = ix[pi[u]];
            ij[u] = ix[pi[u] + stride];
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (t0 + 32 * u >= half) continue;
          const int i = pi[u], j = i + stride;
          const bool asc = (i & size) == 0;
          const bool swap = asc ? before(dj[u], ij[u], di[u], ii[u])
                                : before(di[u], ii[u], dj[u], ij[u]);
          if (swap) {
            d[i] = dj[u]; d[j] = di[u];
            ix[i] = ij[u]; ix[j] = ii[u];
          }
        }
      }
      __syncwarp();
    }
  }
}

// Per-warp exact top-K selection state.  bd/bi is the warp's buffer of
// BUF entries (shared or global memory); count and thr are warp-uniform.
// Entries at and past count are undefined: compact() fills the part of
// the buffer it sorts, with warp_bitonic_sort_wide past 128 entries.
struct WarpTopK {
  float* bd;
  int* bi;
  int K;
  int BUF;
  int count;
  float thr;

  __device__ void init() {
    count = 0;
    thr = INFINITY;
  }

  // Sort the filled prefix (the next power of two >= count, at least 64,
  // padded with (INF, INT_MAX)), keep the best K, refresh the admission
  // threshold.
  __device__ void compact(int lane) {
    int n = 64;
    while (n < count) n <<= 1;
    for (int t = count + lane; t < n; t += 32) {
      bd[t] = INFINITY;
      bi[t] = INT_MAX;
    }
    __syncwarp();
    if (n > 128) warp_bitonic_sort_wide(bd, bi, n, lane);
    else warp_bitonic_sort(bd, bi, n, lane);
    if (count > K) count = K;
    if (count == K) thr = bd[K - 1];
  }

  // Offer one candidate per lane (ok = lane has a real candidate).
  __device__ void push(int lane, float dist, int idx, bool ok) {
    if (count + 32 > BUF) compact(lane);
    ok = ok && dist < thr;
    const unsigned m = __ballot_sync(0xffffffffu, ok);
    const int pos = count + __popc(m & ((1u << lane) - 1u));
    if (ok) {
      bd[pos] = dist;
      bi[pos] = idx;
    }
    count += __popc(m);
    __syncwarp();
  }

  // Final sorted K-list, padded with (MASK_DIST, -1).
  __device__ void write(int lane, float* out_d, int* out_i) {
    compact(lane);
    for (int t = lane; t < K; t += 32) {
      const bool real = t < count;
      out_d[t] = real ? bd[t] : MASK_DIST;
      out_i[t] = real ? bi[t] : -1;
    }
  }
};

__host__ __device__ inline int buffer_size(int K) {
  int buf = 64;
  while (buf < K + 32) buf <<= 1;
  return buf;
}

// Pass two: fold the K-lists part[b, l, :] (l < nlists, only where
// qmask[b * qmask_stride + l] != 0, or all when qmask is null) into the
// running ascending K-list run[b, :].  K is a power of two <= K_MAX.
__global__ void __launch_bounds__(MERGE_THREADS) merge_lists_kernel(
    const float* __restrict__ part_d, const int* __restrict__ part_i,
    const uint8_t* __restrict__ qmask, int qmask_stride, int nlists,
    float* __restrict__ run_d, int* __restrict__ run_i, int K) {
  extern __shared__ float msmem[];
  __shared__ uint8_t take[MERGE_THREADS];
  float* md = msmem;
  int* mi = reinterpret_cast<int*>(md + K);
  const int b = blockIdx.x, tid = threadIdx.x;
  for (int t = tid; t < K; t += blockDim.x) {
    md[t] = run_d[(size_t)b * K + t];
    mi[t] = run_i[(size_t)b * K + t];
  }
  for (int l0 = 0; l0 < nlists; l0 += MERGE_THREADS) {
    const int nl = min(MERGE_THREADS, nlists - l0);
    __syncthreads();
    if (tid < nl)                              // this row's mask, coalesced
      take[tid] = qmask == nullptr
          || qmask[(size_t)b * qmask_stride + l0 + tid] != 0;
    __syncthreads();
    for (int j = 0; j < nl; ++j) {
      if (!take[j]) continue;                  // uniform across the block
      const size_t o = ((size_t)b * nlists + l0 + j) * K;
      const float* pd = part_d + o;
      const int* pi = part_i + o;
      for (int t = tid; t < K; t += blockDim.x) {  // min(run, list reversed)
        const float dl = pd[K - 1 - t];
        const int il = pi[K - 1 - t];
        if (before(dl, il, md[t], mi[t])) {
          md[t] = dl;
          mi[t] = il;
        }
      }
      __syncthreads();
      for (int s = K >> 1; s >= 1; s >>= 1) {   // sort the bitonic K
        for (int t = tid; t < (K >> 1); t += blockDim.x) {
          const int i = 2 * t - (t & (s - 1));
          const int j2 = i + s;
          if (before(md[j2], mi[j2], md[i], mi[i])) {
            const float dt = md[i]; md[i] = md[j2]; md[j2] = dt;
            const int it = mi[i]; mi[i] = mi[j2]; mi[j2] = it;
          }
        }
        __syncthreads();
      }
    }
  }
  __syncthreads();
  for (int t = tid; t < K; t += blockDim.x) {
    run_d[(size_t)b * K + t] = md[t];
    run_i[(size_t)b * K + t] = mi[t];
  }
}

__host__ inline size_t merge_smem_bytes(int K) {
  return (sizeof(float) + sizeof(int)) * (size_t)K;
}

// Lets fn take `bytes` of dynamic shared memory.  Without the attribute a
// block may have 48 KB of shared memory in all, its static part (at most
// STATIC_SMEM_MAX in these kernels: a flag, a tile counter, a row of
// merge flags) included, so the attribute is set from 48 KB less that.
constexpr size_t STATIC_SMEM_MAX = 1024;

__host__ inline cudaError_t allow_smem(const void* fn, size_t bytes) {
  if (bytes + STATIC_SMEM_MAX <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace quake
