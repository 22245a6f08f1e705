// Dense scan with exact top-K: the APS planner's centroid pass.
//
// Replaces the TPU kernel scan_topk_pallas (src/repro/kernels/scan_topk.py,
// _scan_topk_kernel): for Q queries against N rows, the ascending top-K
// of ||x||^2 + bias - 2 q.x (L2) or bias - q.x (IP) with bias = MASK_DIST
// on invalid rows.  Returns row indices; ||q||^2 is added by the caller.
//
// What bounds it on an H100: at the centroid-pass shape (Q = 1024
// queries, N ~ 1000 centroids, d = 128) the work is 2*Q*N*d flops over
// (Q + N)*d*4 bytes, ~230 flop/byte, so f32 CUDA-core operations bound
// it, not bytes.
//
// What the design does about it: it shares the indexed scan's body
// (scan_common.cuh) as the case sel = arange with every query active:
// the rows are cut into chunks of R rows, one pass-one block per (chunk,
// tile of 8 queries) stages each chunk through shared memory once for
// its 8 queries, and pass two merges each query's chunk lists.  Simple
// first: FP32 FMA on CUDA cores; more queries per staged tile, register
// blocking or wgmma are the later steps.
//
// K past K_SMEM (1024) keeps each warp's top-K buffer in a global
// scratch of scratch_blocks blocks' buffers (scan_common.cuh); the query
// tiles then run in launches of at most scratch_blocks blocks each.
#include "scan_common.cuh"

namespace quake {

template <typename T>
__global__ void __launch_bounds__(THREADS) scan_dense_partial_kernel(
    const T* __restrict__ q, const T* __restrict__ xs_g,
    const uint8_t* __restrict__ valid, float* __restrict__ part_d,
    int* __restrict__ part_i, float* __restrict__ gbuf_d,
    int* __restrict__ gbuf_i, int Q, int N, int d, int R, int K,
    float coef, int l2, int qt0) {
  extern __shared__ float smem[];
  const int c = blockIdx.x, n_chunks = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = (qt0 + blockIdx.y) * WARPS + warp;
  const bool active = b < Q;
  const int row0 = c * R;
  const int nrows = min(R, N - row0);
  const int ld = d + 1;
  const int buf = buffer_size(K);
  float* xs = smem;
  float* qs = xs + TILE_ROWS * ld;
  float* qv = qs + warp * d;
  float* bd;
  int* bi;
  if (gbuf_d == nullptr) {
    bd = qs + WARPS * d + warp * buf;
    bi = reinterpret_cast<int*>(qs + WARPS * d + WARPS * buf) + warp * buf;
  } else {
    const size_t slot =
        ((size_t)blockIdx.y * n_chunks + c) * WARPS + warp;
    bd = gbuf_d + slot * buf;
    bi = gbuf_i + slot * buf;
  }
  WarpTopK<false> top{bd, bi, K, buf, 0, INFINITY};
  if (active) {
    for (int j = lane; j < d; j += 32) qv[j] = to_f32(q[(size_t)b * d + j]);
    top.init();
  }
  const FloatRows<T> rows{xs_g + (size_t)row0 * d,
                          valid == nullptr ? nullptr : valid + row0, d, coef,
                          l2 != 0, qv, xs};
  scan_rows(rows, nrows, row0, active, top);
  if (active) {
    const size_t o = ((size_t)b * n_chunks + c) * K;
    top.write(lane, part_d + o, part_i + o);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* xs, const uint8_t* valid,
                   float* part_d, int* part_i, float* gbuf_d, int* gbuf_i,
                   int scratch_blocks, float* out_d, int* out_i, int Q,
                   int N, int d, int R, int K, int l2,
                   cudaStream_t stream) {
  const size_t smem = partial_smem_bytes(d, K);
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(&scan_dense_partial_kernel<T>), smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(reinterpret_cast<const void*>(&merge_lists_kernel),
                   merge_smem_bytes(K));
  if (err != cudaSuccess) return err;
  const int n_chunks = (N + R - 1) / R;
  const int qtiles = (Q + WARPS - 1) / WARPS;
  const bool global = K > K_SMEM;
  if (global && (gbuf_d == nullptr || scratch_blocks < n_chunks))
    return cudaErrorInvalidValue;
  const int step = global ? scratch_blocks / n_chunks : qtiles;
  for (int qt0 = 0; qt0 < qtiles; qt0 += step) {
    scan_dense_partial_kernel<T><<<dim3(n_chunks, min(step, qtiles - qt0)),
                                   THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(xs), valid, part_d,
        part_i, global ? gbuf_d : nullptr, gbuf_i, Q, N, d, R, K,
        l2 ? -2.f : -1.f, l2, qt0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  merge_lists_kernel<<<Q, MERGE_THREADS, merge_smem_bytes(K), stream>>>(
      part_d, part_i, nullptr, 0, n_chunks, out_d, out_i, K);
  return cudaGetLastError();
}

}  // namespace quake

// q (Q, d) and xs (N, d) in the storage type (f32, or bf16 when is_bf16);
// valid (N,) bytes or null (all rows valid); part (Q, ceil(N/R), K)
// scratch; out (Q, K) initialised to (MASK_DIST, -1) by the caller.  K is
// a power of two <= K_MAX; past K_SMEM, gbuf holds scratch_blocks (at
// least ceil(N/R)) blocks of WARPS * buffer_size(K) distances and as many
// indices (gbuf_i = gbuf_d + that count).
extern "C" int scan_dense(void* q, void* xs, void* valid, void* part_d,
                          void* part_i, void* gbuf, void* out_d,
                          void* out_i, int Q, int N, int d, int R, int K,
                          int scratch_blocks, int is_bf16, int l2,
                          void* stream) {
  if (K < 1 || K > quake::K_MAX || (K & (K - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* s = static_cast<cudaStream_t>(stream);
  auto* v = static_cast<const uint8_t*>(valid);
  auto* pd = static_cast<float*>(part_d);
  auto* pi = static_cast<int*>(part_i);
  auto* gd = static_cast<float*>(gbuf);
  int* gi = gd == nullptr ? nullptr : reinterpret_cast<int*>(
      gd + (size_t)scratch_blocks * quake::WARPS * quake::buffer_size(K));
  auto* od = static_cast<float*>(out_d);
  auto* oi = static_cast<int*>(out_i);
  cudaError_t err = is_bf16
      ? quake::launch<__nv_bfloat16>(q, xs, v, pd, pi, gd, gi,
                                     scratch_blocks, od, oi, Q, N, d, R, K,
                                     l2, s)
      : quake::launch<float>(q, xs, v, pd, pi, gd, gi, scratch_blocks, od,
                             oi, Q, N, d, R, K, l2, s);
  return static_cast<int>(err);
}
