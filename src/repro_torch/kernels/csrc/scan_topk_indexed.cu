// Indexed partition scan with exact top-K: the batched executor's hot loop.
//
// Replaces the TPU kernel scan_topk_indexed_pallas
// (src/repro/kernels/scan_topk_indexed.py, _scan_indexed_kernel): for B
// queries over a union of U selected partitions of a (P, S, d) snapshot,
// the ascending top-K of ||x||^2 + bias - 2 q.x (L2) or bias - q.x (IP),
// where query b sees union slot u only if qmask[b, u].  Returns flat
// indices partition * S + slot.
//
// What bounds it on an H100: bytes.  Each (query tile, selected
// partition) pair does 2*d flops per row and reads 4*d (f32) or 2*d
// (bf16) bytes, far below the ~20 flop/byte where f32 CUDA-core math
// would become the limit; the least time is the selected partitions'
// live rows read once at 3.35 TB/s.
//
// What the design does about it: the TPU grid walked (union slot, row
// tile) in order and carried the running top-k in VMEM scratch; blocks
// here run in no order, so the scan is two passes (scan_common.cuh).
// Pass one is one block per (union slot, tile of 8 queries); it reads
// sel[u] itself, exits at once when no query of its tile probes u, and
// reads only the partition's live rows (nrows[p], the last valid row + 1,
// from the wrapper) rather than the padded capacity S.  Queries that
// share a partition in one tile share its staged rows.  Pass two merges
// each query's per-partition lists.  The union is processed in chunks of
// Uc slots so the (B, Uc, K) scratch stays bounded; each chunk is folded
// into the running result by the same merge.  Simple first: plain FP32
// FMA on CUDA cores, no wgmma, no TMA.
#include "scan_common.cuh"

namespace quake {

template <typename T>
__global__ void __launch_bounds__(THREADS) scan_indexed_partial_kernel(
    const T* __restrict__ q, const T* __restrict__ data,
    const uint8_t* __restrict__ valid, const int* __restrict__ nrows_p,
    const int* __restrict__ sel, const uint8_t* __restrict__ qmask,
    float* __restrict__ part_d, int* __restrict__ part_i, int B, int U,
    int S, int d, int K, float coef, int l2, int u0, int Uc) {
  extern __shared__ float smem[];
  const int uc = blockIdx.x;
  const int u = u0 + uc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y * WARPS + warp;
  const bool active = b < B && qmask[(size_t)b * U + u] != 0;
  if (!__syncthreads_or(active)) return;

  const int p = sel[u];
  const int ld = d + 1;
  const int buf = buffer_size(K);
  float* xs = smem;
  float* qs = xs + TILE_ROWS * ld;
  float* bd = qs + WARPS * d;
  int* bi = reinterpret_cast<int*>(bd + WARPS * buf);
  float* qv = qs + warp * d;
  WarpTopK top{bd + warp * buf, bi + warp * buf, K, buf, 0, INFINITY};
  if (active) {
    for (int j = lane; j < d; j += 32) qv[j] = to_f32(q[(size_t)b * d + j]);
    top.init(lane);
  }
  const FloatRows<T> rows{data + (size_t)p * S * d, valid + (size_t)p * S,
                          d, coef, l2 != 0, qv, xs};
  scan_rows(rows, nrows_p[p], p * S, active, top);
  if (active) {
    const size_t o = ((size_t)b * Uc + uc) * K;
    top.write(lane, part_d + o, part_i + o);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* data, const uint8_t* valid,
                   const int* nrows, const int* sel, const uint8_t* qmask,
                   float* part_d, int* part_i, float* run_d, int* run_i,
                   int B, int U, int S, int d, int K, int Uc, int l2,
                   cudaStream_t stream) {
  const size_t smem = partial_smem_bytes(d, K);
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(&scan_indexed_partial_kernel<T>), smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(reinterpret_cast<const void*>(&merge_lists_kernel),
                   merge_smem_bytes(K));
  if (err != cudaSuccess) return err;
  const float coef = l2 ? -2.f : -1.f;
  const int qtiles = (B + WARPS - 1) / WARPS;
  for (int u0 = 0; u0 < U; u0 += Uc) {
    const int uc = min(Uc, U - u0);
    scan_indexed_partial_kernel<T><<<dim3(uc, qtiles), THREADS, smem,
                                     stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(data), valid, nrows,
        sel, qmask, part_d, part_i, B, U, S, d, K, coef, l2, u0, uc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    merge_lists_kernel<<<B, MERGE_THREADS, merge_smem_bytes(K), stream>>>(
        part_d, part_i, qmask + u0, U, uc, run_d, run_i, K);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace quake

// q (B, d) and data (P, S, d) in the storage type (f32, or bf16 when
// is_bf16); valid (P, S) and qmask (B, U) as bytes; nrows (P,) and sel
// (U,) int32; part (B, Uc, K) scratch; run (B, K) the running result,
// initialised by the caller and updated in place.  K is a power of two.
extern "C" int scan_indexed(void* q, void* data, void* valid, void* nrows,
                            void* sel, void* qmask, void* part_d,
                            void* part_i, void* run_d, void* run_i, int B,
                            int U, int S, int d, int K, int Uc, int is_bf16,
                            int l2, void* stream) {
  auto* s = static_cast<cudaStream_t>(stream);
  auto* v = static_cast<const uint8_t*>(valid);
  auto* nr = static_cast<const int*>(nrows);
  auto* se = static_cast<const int*>(sel);
  auto* qm = static_cast<const uint8_t*>(qmask);
  auto* pd = static_cast<float*>(part_d);
  auto* pi = static_cast<int*>(part_i);
  auto* rd = static_cast<float*>(run_d);
  auto* ri = static_cast<int*>(run_i);
  cudaError_t err = is_bf16
      ? quake::launch<__nv_bfloat16>(q, data, v, nr, se, qm, pd, pi, rd, ri,
                                     B, U, S, d, K, Uc, l2, s)
      : quake::launch<float>(q, data, v, nr, se, qm, pd, pi, rd, ri, B, U,
                             S, d, K, Uc, l2, s);
  return static_cast<int>(err);
}
