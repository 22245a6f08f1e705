// Nearest-centroid assignment: insert routing and maintenance.
//
// Replaces the TPU kernel kmeans_assign_pallas
// (src/repro/kernels/kmeans_assign.py, _kmeans_assign_kernel): for each
// point, the argmin over centroids of aux[c] - 2 x.c with aux = ||c||^2
// (+ MASK_DIST on invalid centroids), ties to the smallest centroid
// index; returns (assignment, minimum) and the caller adds ||x||^2.  The
// (N, C) distance matrix is never stored.
//
// What bounds it on an H100: 2*N*C*d flops over (N + C)*d*4 bytes; with
// C ~ 1000 centroids that is ~500 flop/byte, so f32 CUDA-core
// operations bound it.
//
// What the design does about it: one block of 256 threads per tile of 32
// points, staged once in shared memory; centroids stream through shared
// memory 32 at a time.  Warp g owns centroids 4g..4g+3 of each tile and
// lane t owns point t, so a warp reads one centroid row as a broadcast
// and 32 point rows at distinct banks (row stride d + 1).  Each thread
// keeps a running (min, argmin) in registers, updated by strict "<" over
// its centroids in increasing index; the 8 warps' pairs are then reduced
// in (distance, index) order, which gives the smallest index on ties as
// the TPU kernel's in-block argmin plus strict cross-block update does.
// Simple first: FP32 FMA on CUDA cores.
#include <cuda_runtime.h>
#include <stdint.h>
#include <cmath>

namespace {

constexpr float MASK_DIST = 3.0e38f;
constexpr int PTS = 32;        // points per block
constexpr int CENT = 32;       // centroids per staged tile
constexpr int GROUPS = 8;      // warps; each owns CENT / GROUPS centroids
constexpr int PER = CENT / GROUPS;

__global__ void __launch_bounds__(PTS * GROUPS) kmeans_assign_kernel(
    const float* __restrict__ xs, const float* __restrict__ cents,
    const float* __restrict__ aux, int* __restrict__ out_a,
    float* __restrict__ out_d, int N, int C, int d) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* xs_s = smem;
  float* cs_s = xs_s + PTS * ld;
  float* red_d = cs_s + CENT * ld;
  int* red_a = reinterpret_cast<int*>(red_d + PTS * GROUPS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * PTS;

  for (int r = warp; r < PTS; r += GROUPS) {
    const bool in = n0 + r < N;
    for (int j = lane; j < d; j += 32)
      xs_s[r * ld + j] = in ? xs[(size_t)(n0 + r) * d + j] : 0.f;
  }
  float best_d = MASK_DIST;
  int best_a = -1;
  const float* xr = xs_s + lane * ld;
  for (int c0 = 0; c0 < C; c0 += CENT) {
    __syncthreads();
    for (int r = warp; r < CENT; r += GROUPS) {
      const bool in = c0 + r < C;
      for (int j = lane; j < d; j += 32)
        cs_s[r * ld + j] = in ? cents[(size_t)(c0 + r) * d + j] : 0.f;
    }
    __syncthreads();
    for (int t = 0; t < PER; ++t) {
      const int cl = warp * PER + t;
      const int c = c0 + cl;
      if (c >= C) break;
      const float* cr = cs_s + cl * ld;
      float acc = 0.f;
      for (int j = 0; j < d; ++j) acc = fmaf(xr[j], cr[j], acc);
      const float dist = aux[c] - 2.f * acc;
      if (dist < best_d) {
        best_d = dist;
        best_a = c;
      }
    }
  }
  red_d[warp * PTS + lane] = best_d;
  red_a[warp * PTS + lane] = best_a;
  __syncthreads();
  if (warp == 0 && n0 + lane < N) {
    float bd = red_d[lane];
    int ba = red_a[lane];
    for (int g = 1; g < GROUPS; ++g) {
      const float dg = red_d[g * PTS + lane];
      const int ag = red_a[g * PTS + lane];
      if (ag < 0) continue;
      if (ba < 0 || dg < bd || (dg == bd && ag < ba)) {
        bd = dg;
        ba = ag;
      }
    }
    out_a[n0 + lane] = ba;
    out_d[n0 + lane] = bd;
  }
}

}  // namespace

// xs (N, d), centroids (C, d), aux (C,) = ||c||^2 + bias, all f32;
// out_a (N,) int32 and out_d (N,) f32 (without ||x||^2).
extern "C" int kmeans_assign(void* xs, void* cents, void* aux, void* out_a,
                             void* out_d, int N, int C, int d,
                             void* stream) {
  const size_t smem = sizeof(float) * ((size_t)(PTS + CENT) * (d + 1)
                                       + (size_t)PTS * GROUPS)
                      + sizeof(int) * (size_t)PTS * GROUPS;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kmeans_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (N + PTS - 1) / PTS;
  kmeans_assign_kernel<<<blocks, PTS * GROUPS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xs), static_cast<const float*>(cents),
      static_cast<const float*>(aux), static_cast<int*>(out_a),
      static_cast<float*>(out_d), N, C, d);
  return static_cast<int>(cudaGetLastError());
}
