// Indexed partition scan over int8 codes with exact top-K: the batched
// executor's hot loop for int8 (IVF-residual SQ8) storage.
//
// Replaces the TPU kernel scan_topk_indexed_q8_pallas
// (src/repro/kernels/scan_topk_indexed.py, _scan_indexed_q8_kernel).  For
// B queries over a union of U selected partitions of (P, S, d) int8 codes,
// query b sees union slot u only if qmask[b, u]; over each valid row s of
// partition p = sel[u] it ranks
//
//   qx   = qc[b,u] + (float)(q_i8[b] . x_i8[p,s]) * q_scale[b] * x_scale[p,s]
//   dist = aux[p,s] + coef * qx          (coef = -2 for L2, -1 for IP)
//
// and returns the ascending top-K by (distance, flat index p * S + s).
// qc is the exact f32 query-centroid product for residual codes (0 for
// plain ones); aux the dequantized ||x^||^2 plus the pad bias (L2) or the
// bias alone (IP), both prepared by the wrapper.  The dequantization
// follows the reference's order with round-to-nearest intrinsics, so nvcc
// does not contract it into FMAs and the kernel gives the plain version's
// distances bit for bit.
//
// What bounds it on an H100: bytes.  Per live row it reads d bytes of
// codes, a 4-byte scale, 4 bytes of aux and a valid byte (137 bytes at
// d = 128, against 513 for f32 rows), and does 2*d int8 operations.
//
// What the design does about it: the same two passes as the f32 kernel
// (scan_topk_indexed.cu, scan_common.cuh), with the Q8Rows policy in place
// of FloatRows: rows are staged as 32-bit words (four codes each), and the
// int8 product is __dp4a on CUDA cores, exact in int32 (127^2 * d is far
// below 2^31).  The wrapper passes each partition's live-row count so the
// padding is never read.  Simple first: no mma.sync s8 or wgmma.
#include "scan_common.cuh"

namespace quake {

// int8 rows staged as words with row stride w + 1 (w = d / 4); qv is the
// warp's query codes as w words (shared memory), qc and qs its
// query-centroid product for this partition and its scale.
struct Q8Rows {
  const int* x;               // the partition's first row, w words a row
  const float* scale;         // its per-row scales
  const float* aux;           // its per-row aux
  const uint8_t* valid;       // its valid flags
  int w;
  float coef;
  float qc;
  float qs;
  const int* qv;
  int* xs;

  __device__ void stage(int r0, int nr, int warp, int lane) const {
    const int ld = w + 1;
    for (int r = warp; r < nr; r += WARPS) {
      const int* src = x + (size_t)(r0 + r) * w;
      for (int j = lane; j < w; j += 32) xs[r * ld + j] = src[j];
    }
  }

  __device__ bool dist(int r0, int lane, float& out) const {
    const int* xr = xs + lane * (w + 1);
    int acc = 0;
    for (int j = 0; j < w; ++j) acc = __dp4a(xr[j], qv[j], acc);
    const int row = r0 + lane;
    const float qx = __fadd_rn(
        qc, __fmul_rn(__fmul_rn(static_cast<float>(acc), qs), scale[row]));
    out = __fadd_rn(aux[row], __fmul_rn(coef, qx));
    return valid[row] != 0 && out < MASK_DIST;
  }
};

__host__ inline size_t q8_partial_smem_bytes(int w, int K) {
  const int buf = buffer_size(K);
  return sizeof(int) * ((size_t)TILE_ROWS * (w + 1) + (size_t)WARPS * w)
         + (sizeof(float) + sizeof(int)) * (size_t)WARPS * buf;
}

__global__ void __launch_bounds__(THREADS) scan_indexed_q8_partial_kernel(
    const int* __restrict__ q_codes, const float* __restrict__ q_scales,
    const int* __restrict__ codes, const float* __restrict__ scales,
    const float* __restrict__ aux, const float* __restrict__ qc,
    const uint8_t* __restrict__ valid, const int* __restrict__ nrows_p,
    const int* __restrict__ sel, const uint8_t* __restrict__ qmask,
    float* __restrict__ part_d, int* __restrict__ part_i, int B, int U,
    int S, int w, int K, float coef, int u0, int Uc) {
  extern __shared__ int qsmem[];
  const int uc = blockIdx.x;
  const int u = u0 + uc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y * WARPS + warp;
  const bool active = b < B && qmask[(size_t)b * U + u] != 0;
  if (!__syncthreads_or(active)) return;

  const int p = sel[u];
  const int buf = buffer_size(K);
  int* xs = qsmem;
  int* qsh = xs + TILE_ROWS * (w + 1);
  float* bd = reinterpret_cast<float*>(qsh + WARPS * w);
  int* bi = reinterpret_cast<int*>(bd + WARPS * buf);
  int* qv = qsh + warp * w;
  WarpTopK top{bd + warp * buf, bi + warp * buf, K, buf, 0, INFINITY};
  float qcv = 0.f, qsv = 0.f;
  if (active) {
    for (int j = lane; j < w; j += 32) qv[j] = q_codes[(size_t)b * w + j];
    qcv = qc[(size_t)b * U + u];
    qsv = q_scales[b];
    top.init(lane);
  }
  const size_t row0 = (size_t)p * S;
  const Q8Rows rows{codes + row0 * w, scales + row0, aux + row0,
                    valid + row0, w, coef, qcv, qsv, qv, xs};
  scan_rows(rows, nrows_p[p], p * S, active, top);
  if (active) {
    const size_t o = ((size_t)b * Uc + uc) * K;
    top.write(lane, part_d + o, part_i + o);
  }
}

cudaError_t launch_q8(const int* q_codes, const float* q_scales,
                      const int* codes, const float* scales,
                      const float* aux, const float* qc,
                      const uint8_t* valid, const int* nrows,
                      const int* sel, const uint8_t* qmask, float* part_d,
                      int* part_i, float* run_d, int* run_i, int B, int U,
                      int S, int d, int K, int Uc, int l2,
                      cudaStream_t stream) {
  const int w = d / 4;
  const size_t smem = q8_partial_smem_bytes(w, K);
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(&scan_indexed_q8_partial_kernel), smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(reinterpret_cast<const void*>(&merge_lists_kernel),
                   merge_smem_bytes(K));
  if (err != cudaSuccess) return err;
  const float coef = l2 ? -2.f : -1.f;
  const int qtiles = (B + WARPS - 1) / WARPS;
  for (int u0 = 0; u0 < U; u0 += Uc) {
    const int uc = min(Uc, U - u0);
    scan_indexed_q8_partial_kernel<<<dim3(uc, qtiles), THREADS, smem,
                                     stream>>>(
        q_codes, q_scales, codes, scales, aux, qc, valid, nrows, sel, qmask,
        part_d, part_i, B, U, S, w, K, coef, u0, uc);
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

// q_codes (B, d) and codes (P, S, d) int8, d a multiple of 4; q_scales
// (B,), scales and aux (P, S), qc (B, U) f32; valid (P, S) and qmask
// (B, U) as bytes; nrows (P,) and sel (U,) int32; part (B, Uc, K) scratch;
// run (B, K) the running result, initialised by the caller and updated in
// place.  K is a power of two.
extern "C" int scan_indexed_q8(void* q_codes, void* q_scales, void* codes,
                               void* scales, void* aux, void* qc,
                               void* valid, void* nrows, void* sel,
                               void* qmask, void* part_d, void* part_i,
                               void* run_d, void* run_i, int B, int U, int S,
                               int d, int K, int Uc, int l2, void* stream) {
  return static_cast<int>(quake::launch_q8(
      static_cast<const int*>(q_codes), static_cast<const float*>(q_scales),
      static_cast<const int*>(codes), static_cast<const float*>(scales),
      static_cast<const float*>(aux), static_cast<const float*>(qc),
      static_cast<const uint8_t*>(valid), static_cast<const int*>(nrows),
      static_cast<const int*>(sel), static_cast<const uint8_t*>(qmask),
      static_cast<float*>(part_d), static_cast<int*>(part_i),
      static_cast<float*>(run_d), static_cast<int*>(run_i), B, U, S, d, K,
      Uc, l2, static_cast<cudaStream_t>(stream)));
}
