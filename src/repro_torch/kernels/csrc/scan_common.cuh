// Shared body of the scan kernels (scan_topk_indexed.cu, scan_topk.cu,
// scan_topk_indexed_q8.cu).
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
// Pass one (one block per (row block, tile of WARPS queries)): each warp
// owns one query.  Rows are staged TILE_ROWS at a time in shared memory
// by a row policy (FloatRows, or Q8Rows for int8 codes) whose row stride
// is padded by one word, so lane r reading row r hits distinct banks;
// lane r computes the distance of row r; candidates below the warp's
// running K-th distance are appended to a per-warp buffer of BUF >= K + 32
// entries, which is bitonic-sorted and cut back to K when it would
// overflow.  Rows are visited in increasing index, so a candidate equal
// to the K-th distance always loses the tie and strict "<" is exact.
// Each (query, row block) writes its sorted K-list to scratch.
//
// Pass two (one block per query): folds that query's K-lists into its
// running K-list, each fold a bitonic merge of (running ascending ++ list
// reversed).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <climits>
#include <cmath>

namespace quake {

constexpr float MASK_DIST = 3.0e38f;
constexpr int WARPS = 8;          // query slots per pass-one block
constexpr int THREADS = WARPS * 32;
constexpr int TILE_ROWS = 32;     // rows staged in shared memory per step
constexpr int MERGE_THREADS = 128;

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

// Per-warp exact top-K selection state.  bd/bi is the warp's buffer of
// BUF entries in shared memory; count and thr are warp-uniform.
struct WarpTopK {
  float* bd;
  int* bi;
  int K;
  int BUF;
  int count;
  float thr;

  __device__ void init(int lane) {
    for (int t = lane; t < BUF; t += 32) {
      bd[t] = INFINITY;
      bi[t] = INT_MAX;
    }
    count = 0;
    thr = INFINITY;
    __syncwarp();
  }

  // Sort the buffer, keep the best K, refresh the admission threshold.
  __device__ void compact(int lane) {
    warp_bitonic_sort(bd, bi, BUF, lane);
    if (count > K) count = K;
    for (int t = K + lane; t < BUF; t += 32) {
      bd[t] = INFINITY;
      bi[t] = INT_MAX;
    }
    __syncwarp();
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

// Dynamic shared memory of one pass-one block.
__host__ inline size_t partial_smem_bytes(int d, int K) {
  const int buf = buffer_size(K);
  return sizeof(float) * ((size_t)TILE_ROWS * (d + 1) + (size_t)WARPS * d
                          + (size_t)WARPS * buf)
         + sizeof(int) * (size_t)WARPS * buf;
}

// Scan rows [0, nrows) of one row block for every active warp's query.
// ``rows`` is the row policy: rows.stage(r0, nr, warp, lane) copies rows
// [r0, r0 + nr) into shared memory (all threads), and rows.dist(r0, lane,
// out) computes the distance of row r0 + lane from the staged copy and
// returns whether the row is a candidate.  Every thread of the block must
// call this: it synchronises the block.
template <typename Rows>
__device__ void scan_rows(const Rows& rows, int nrows, int base_idx,
                          bool warp_active, WarpTopK& top) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r0 = 0; r0 < nrows; r0 += TILE_ROWS) {
    const int nr = min(TILE_ROWS, nrows - r0);
    __syncthreads();                          // previous tile consumed
    rows.stage(r0, nr, warp, lane);
    __syncthreads();
    if (warp_active) {
      float dist = INFINITY;
      bool ok = false;
      if (lane < nr) ok = rows.dist(r0, lane, dist);
      top.push(lane, dist, base_idx + r0 + lane, ok);
    }
  }
}

// f32 or bf16 rows, staged as f32 with row stride d + 1; qv is the warp's
// query in f32 (shared memory).
template <typename T>
struct FloatRows {
  const T* x;                 // the row block's first row
  const uint8_t* valid;       // its first flag, or null
  int d;
  float coef;
  bool l2;
  const float* qv;
  float* xs;

  __device__ void stage(int r0, int nr, int warp, int lane) const {
    const int ld = d + 1;
    for (int r = warp; r < nr; r += WARPS) {
      const T* src = x + (size_t)(r0 + r) * d;
      for (int j = lane; j < d; j += 32) xs[r * ld + j] = to_f32(src[j]);
    }
  }

  __device__ bool dist(int r0, int lane, float& out) const {
    const float* xr = xs + lane * (d + 1);
    float acc = 0.f, x2 = 0.f;
    for (int j = 0; j < d; ++j) {
      const float xv = xr[j];
      acc = fmaf(qv[j], xv, acc);
      x2 = fmaf(xv, xv, x2);
    }
    const bool v = valid == nullptr || valid[r0 + lane] != 0;
    const float aux = (l2 ? x2 : 0.f) + (v ? 0.f : MASK_DIST);
    out = aux + coef * acc;
    return v && out < MASK_DIST;
  }
};

// Pass two: fold the K-lists part[b, l, :] (l < nlists, only where
// qmask[b * qmask_stride + l] != 0, or all when qmask is null) into the
// running ascending K-list run[b, :].  K is a power of two.
__global__ void __launch_bounds__(MERGE_THREADS) merge_lists_kernel(
    const float* __restrict__ part_d, const int* __restrict__ part_i,
    const uint8_t* __restrict__ qmask, int qmask_stride, int nlists,
    float* __restrict__ run_d, int* __restrict__ run_i, int K) {
  extern __shared__ float msmem[];
  float* md = msmem;
  int* mi = reinterpret_cast<int*>(md + 2 * K);
  const int b = blockIdx.x, tid = threadIdx.x;
  for (int t = tid; t < K; t += blockDim.x) {
    md[t] = run_d[(size_t)b * K + t];
    mi[t] = run_i[(size_t)b * K + t];
  }
  for (int l = 0; l < nlists; ++l) {
    if (qmask != nullptr && qmask[(size_t)b * qmask_stride + l] == 0)
      continue;                                // uniform across the block
    const float* pd = part_d + ((size_t)b * nlists + l) * K;
    const int* pi = part_i + ((size_t)b * nlists + l) * K;
    __syncthreads();
    for (int t = tid; t < K; t += blockDim.x) {  // descending tail
      md[2 * K - 1 - t] = pd[t];
      mi[2 * K - 1 - t] = pi[t];
    }
    __syncthreads();
    for (int s = K; s >= 1; s >>= 1) {
      for (int t = tid; t < K; t += blockDim.x) {
        const int i = 2 * t - (t & (s - 1));
        const int j = i + s;
        if (before(md[j], mi[j], md[i], mi[i])) {
          const float dt = md[i]; md[i] = md[j]; md[j] = dt;
          const int it = mi[i]; mi[i] = mi[j]; mi[j] = it;
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();
  for (int t = tid; t < K; t += blockDim.x) {
    run_d[(size_t)b * K + t] = md[t];
    run_i[(size_t)b * K + t] = mi[t];
  }
}

__host__ inline size_t merge_smem_bytes(int K) {
  return (sizeof(float) + sizeof(int)) * 2 * (size_t)K;
}

__host__ inline cudaError_t allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace quake
