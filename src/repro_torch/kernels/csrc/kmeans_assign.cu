// Nearest-centroid assignment: insert routing and maintenance.
//
// Replaces the TPU kernel kmeans_assign_pallas
// (src/repro/kernels/kmeans_assign.py, _kmeans_assign_kernel): for each
// point, the argmin over centroids of aux[c] - 2 x.c with aux = ||c||^2
// (+ MASK_DIST on invalid centroids), ties to the smallest centroid
// index; returns (assignment, minimum) and the caller adds ||x||^2.  A
// point with no centroid below MASK_DIST gets -1 and MASK_DIST.  The
// (N, C) distance matrix is never stored.
//
// What bounds it on an H100: 2*N*C*d flops over (N + C)*d*4 bytes; with
// C ~ 1000 centroids that is ~500 flop/byte, so f32 operations bound it.
// It stays on the CUDA cores (67 TFLOP/s): TF32 tensor cores would round
// the inputs, and exact ties must stay exact.
//
// What the design does about it: the standard register-tiled SGEMM with
// the argmin as its epilogue.  A block of 256 threads takes 128 points x
// 128 centroids; d runs through shared memory in chunks of 16, double-
// buffered by cp.async (tile s + 1 in flight while s is computed).  Both
// operands are staged d-major ([16][128 + 4]), so a thread reads its 8
// points and its 8 centroids at one d as 4 float4 loads and does 64 FMAs
// on them (thread (ty, tx) owns points 4ty.. and 64 + 4ty.., centroids
// 4tx.. and 64 + 4tx..).  The copies are 4 bytes each, whatever d is: a
// 16-byte copy cannot transpose a row into a column, and 16 copies a
// thread per chunk cost little beside its 1,024 FMAs.  (16-byte copies
// into a [d/4][row] layout of float4s were slower on the card: a thread
// then holds 8 float4 operands at once, which spill under the 128
// registers that two blocks an SM allow.)  Past d the copies fill zeros,
// so any d works.  After a centroid tile's last chunk each
// thread folds its 8 centroids, in increasing index, into its points'
// running (min, argmin) with a strict "<"; at the end the 16 threads of a
// point reduce in (distance, index) order with shuffles.
//
// Grid: 10,000 points make 79 tiles of 128 for 132 SMs, so the centroid
// tiles are also split over blocks (blockIdx.y): the wrapper picks the
// split so that some 4 blocks an SM are in flight (8 splits of one tile
// each at 10,000 x 1,000), and a second, small kernel merges each point's
// per-split results in increasing split order with a strict "<" (each
// split's index is already its smallest on ties).  A 64-point tile
// without the split would leave one wave of 157 blocks on 132 SMs, with
// some SMs doing twice the work of others.
#include <cuda_runtime.h>
#include <stdint.h>
#include <cmath>

#include "async_copy.cuh"

namespace {

using quake::cp_async;
using quake::cp_async_commit;
using quake::cp_async_wait;
using quake::smem_addr;

constexpr float MASK_DIST = 3.0e38f;
constexpr int TILE = 128;      // points, and centroids, per block tile
constexpr int KC = 16;         // d per staged chunk
constexpr int THREADS = 256;   // 16 x 16 threads, 8 x 8 each
constexpr int LDS = TILE + 4;  // padded: the transposing copies conflict
                               // at most two ways; float4 rows stay aligned

// rows r of [TILE][d] starting at row0 (< n of them) -> chunk [KC][LDS]
__device__ __forceinline__ void stage_chunk(float (*dst)[LDS],
                                            const float* __restrict__ src,
                                            int row0, int n, int d, int k0,
                                            int tid) {
#pragma unroll
  for (int i = 0; i < TILE * KC / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int r = e / KC, kd = e % KC;
    const bool in = row0 + r < n && k0 + kd < d;
    cp_async<4>(smem_addr(&dst[kd][r]),
                src + (in ? (size_t)(row0 + r) * d + k0 + kd : 0), in);
  }
}

__global__ void __launch_bounds__(THREADS, 2) kmeans_assign_kernel(
    const float* __restrict__ xs, const float* __restrict__ cents,
    const float* __restrict__ aux, int* __restrict__ out_a,
    float* __restrict__ out_d, int N, int C, int d, int tiles_per_split) {
  __shared__ __align__(16) float xs_s[2][KC][LDS];
  __shared__ __align__(16) float cs_s[2][KC][LDS];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int n0 = blockIdx.x * TILE;
  const int t0 = blockIdx.y * tiles_per_split;
  const int t1 = min((C + TILE - 1) / TILE, t0 + tiles_per_split);
  const int chunks = max(1, (d + KC - 1) / KC);   // d = 0: one of zeros
  const int steps = (t1 - t0) * chunks;

  auto stage = [&](int step) {
    const int buf = step & 1;
    const int c0 = (t0 + step / chunks) * TILE;
    const int k0 = (step % chunks) * KC;
    stage_chunk(xs_s[buf], xs, n0, N, d, k0, tid);
    stage_chunk(cs_s[buf], cents, c0, C, d, k0, tid);
  };

  float best_d[8];
  int best_a[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best_d[i] = MASK_DIST;
    best_a[i] = -1;
  }
  float acc[8][8];
  if (steps > 0) stage(0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) stage(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int chunk = s % chunks;
    if (chunk == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    const float (*xa)[LDS] = xs_s[s & 1];
    const float (*ca)[LDS] = cs_s[s & 1];
#pragma unroll
    for (int kd = 0; kd < KC; ++kd) {
      const float4 x0 = *reinterpret_cast<const float4*>(&xa[kd][ty * 4]);
      const float4 x1 = *reinterpret_cast<const float4*>(&xa[kd][64 + ty * 4]);
      const float4 c0 = *reinterpret_cast<const float4*>(&ca[kd][tx * 4]);
      const float4 c1 = *reinterpret_cast<const float4*>(&ca[kd][64 + tx * 4]);
      const float xr[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      const float cr[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xr[i], cr[j], acc[i][j]);
    }
    if (chunk == chunks - 1) {   // this centroid tile is summed over d
      const int cb = (t0 + s / chunks) * TILE;
#pragma unroll
      for (int j = 0; j < 8; ++j) {   // the thread's centroids, increasing
        const int c = cb + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
        if (c < C) {
          const float a = __ldg(aux + c);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float dist = a - 2.f * acc[i][j];
            if (dist < best_d[i]) {
              best_d[i] = dist;
              best_a[i] = c;
            }
          }
        }
      }
    }
    __syncthreads();   // every thread is done with this stage's buffer
  }
  cp_async_wait<0>();

  // the 16 threads of a point are 16 lanes of one warp
  const size_t off = gridDim.y > 1 ? (size_t)blockIdx.y * N : 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float bd = best_d[i];
    int ba = best_a[i];
#pragma unroll
    for (int w = 1; w < 16; w <<= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, w);
      const int oa = __shfl_xor_sync(0xffffffffu, ba, w);
      if (od < bd || (od == bd && oa < ba)) {
        bd = od;
        ba = oa;
      }
    }
    const int n = n0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (tx == 0 && n < N) {
      out_a[off + n] = ba;
      out_d[off + n] = bd;
    }
  }
}

// per point, the splits' (min, argmin) in increasing split order
__global__ void kmeans_merge_kernel(const int* __restrict__ part_a,
                                    const float* __restrict__ part_d,
                                    int* __restrict__ out_a,
                                    float* __restrict__ out_d, int N,
                                    int splits) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float bd = MASK_DIST;
  int ba = -1;
  for (int s = 0; s < splits; ++s) {
    const float dd = part_d[(size_t)s * N + n];
    if (dd < bd) {
      bd = dd;
      ba = part_a[(size_t)s * N + n];
    }
  }
  out_a[n] = ba;
  out_d[n] = bd;
}

}  // namespace

// xs (N, d), centroids (C, d), aux (C,) = ||c||^2 + bias, all f32;
// out_a (N,) int32 and out_d (N,) f32 (without ||x||^2).  Centroid tiles
// of 128 are split over blocks, tiles_per_split each; with more than one
// split, part_a and part_d (splits x N) hold each split's result and a
// second kernel merges them.
extern "C" int kmeans_assign(void* xs, void* cents, void* aux, void* out_a,
                             void* out_d, void* part_a, void* part_d, int N,
                             int C, int d, int tiles_per_split,
                             void* stream) {
  if (N <= 0 || C <= 0 || d < 0 || tiles_per_split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (C + TILE - 1) / TILE;
  const int splits = (tiles + tiles_per_split - 1) / tiles_per_split;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + TILE - 1) / TILE, splits);
  kmeans_assign_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const float*>(xs), static_cast<const float*>(cents),
      static_cast<const float*>(aux),
      static_cast<int*>(splits > 1 ? part_a : out_a),
      static_cast<float*>(splits > 1 ? part_d : out_d), N, C, d,
      tiles_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  kmeans_merge_kernel<<<(N + 255) / 256, 256, 0, st>>>(
      static_cast<const int*>(part_a), static_cast<const float*>(part_d),
      static_cast<int*>(out_a), static_cast<float*>(out_d), N, splits);
  return static_cast<int>(cudaGetLastError());
}
