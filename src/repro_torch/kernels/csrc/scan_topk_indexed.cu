// Indexed partition scan with exact top-K: the batched executor's hot loop.
//
// Replaces the TPU kernel scan_topk_indexed_pallas
// (src/repro/kernels/scan_topk_indexed.py, _scan_indexed_kernel): for B
// queries over a union of U selected partitions of a (P, S, d) snapshot,
// the ascending top-K of ||x||^2 + bias - 2 q.x (L2) or bias - q.x (IP),
// where query b sees union slot u only if qmask[b, u].  Returns flat
// indices partition * S + slot.
//
// What bounds it on an H100: bytes.  The selected partitions' live rows
// are the data that must be read, once: at the timed plan of
// chip_smoke.py (B = 1024, U = 544, S = 10,240, d = 128) about 446 MB of
// f32 rows (223 MB bf16), 0.133 ms (0.067 ms) at 3.35 TB/s.  The
// arithmetic is 2 * active_pair_rows * d, where active_pair_rows counts
// each (query, row) pair the mask selects: about 0.8 GFLOP there, 0.012
// ms at the 67 TFLOP/s of f32 outside the tensor cores.
//
// What the design does about it (scan_grouped.cuh): the queries are
// grouped on the device by the partitions they probe, and one block
// scans one partition for up to 16 of its queries, so a partition's rows
// are read once per 16 of its queries, and every warp of a running block
// has queries.  The design it replaces ran one block per (union slot,
// tile of 8 consecutive queries of the batch): at the timed plan a
// partition is probed by a few queries scattered over the batch, so
// most of its ~70,000 blocks exited at once and most of the rest had one
// busy warp, and a partition was read again for every tile that held
// one of its queries.  Rows are staged 64 at a time through a
// three-stage cp.async ring (bf16 rows as bf16, widened in registers),
// with their validity bytes; ||x||^2 is computed once per staged row; a
// thread owns a row and accumulates its products with up to 4 of the
// tile's queries from 16-byte shared loads, each as two interleaved sums
// (even and odd elements) so that consecutive FMAs do not wait on each
// other (128-row bf16 stages were slower on the card).  Pass two
// (merge_lists_kernel) is unchanged.
//
// What still separates it from the bound: a tile's first rows wait for
// their copy (no prefetch across tiles), blocks draw one tile at a time,
// and the f32 products run on FMAs: TF32 would break the f32 agreement
// the exact checks rely on.  bf16 rows on the tensor cores (mma/wgmma,
// exact products, f32 sums) are the next step.
#include "scan_grouped.cuh"

namespace quake {

// f32 or bf16 rows; queries in f32 in shared memory.
template <typename T>
struct FloatTiles {
  using Unit = T;
  using QUnit = float;
  using Acc = float2;                           // even and odd elements
  using Dot = float;
  static constexpr int VEC = 16 / sizeof(T);    // 4 f32, 8 bf16
  static constexpr int TR = 64;                 // rows per stage
  static constexpr int DCH = 512 / sizeof(T);   // 512 bytes of a row
  static constexpr int NMETA = 0;
  struct QV {
    float v[VEC];
  };

  const T* q;
  const T* data;
  const uint8_t* valid;
  int width;
  int S;
  float coef;
  int l2;

  // the VEC values of one 16-byte vector
  __device__ static void unpack(const uint4& w, float (&f)[VEC]) {
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j) f[j] = __uint_as_float(u[j]);
    } else {                          // bf16: the high half of an f32
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        f[2 * j] = __uint_as_float(u[j] << 16);
        f[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
      }
    }
  }

  __device__ bool aligned16() const {
    return (reinterpret_cast<uintptr_t>(data) & 15) == 0;
  }
  __device__ const float* meta_src(int) const { return nullptr; }
  __device__ const T* row(int p, int s) const {
    return data + ((size_t)p * S + s) * width;
  }
  __device__ const T* query(int b) const { return q + (size_t)b * width; }
  __device__ float2 query_meta(int, int) const { return make_float2(0.f, 0.f); }
  __device__ static float widen(T v) { return to_f32(v); }
  __device__ static void widen16(float* dst, const uint4& w) {
    float f[VEC];
    unpack(w, f);
#pragma unroll
    for (int j = 0; j < VEC; j += 4)
      *reinterpret_cast<float4*>(dst + j) =
          make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
  }
  __device__ void row_fold(float2& x2, const uint4& xv) const {
    float f[VEC];
    unpack(xv, f);
#pragma unroll
    for (int j = 0; j < VEC; j += 2) {
      x2.x = fmaf(f[j], f[j], x2.x);
      x2.y = fmaf(f[j + 1], f[j + 1], x2.y);
    }
  }
  __device__ void row_meta(float2 x2, const float*, int, bool v,
                           float2& rm, bool& ok) const {
    ok = v;
    rm = make_float2((l2 ? total(x2) : 0.f) + (v ? 0.f : MASK_DIST), 0.f);
  }
  __device__ static QV load_qv(const float* qp) {
    QV r;
#pragma unroll
    for (int j = 0; j < VEC / 4; ++j) {
      const float4 t = reinterpret_cast<const float4*>(qp)[j];
      r.v[4 * j] = t.x;
      r.v[4 * j + 1] = t.y;
      r.v[4 * j + 2] = t.z;
      r.v[4 * j + 3] = t.w;
    }
    return r;
  }
  __device__ static void fold(float2& acc, const QV& qv,
                              const uint4& xv) {
    float f[VEC];
    unpack(xv, f);
#pragma unroll
    for (int j = 0; j < VEC; j += 2) {
      acc.x = fmaf(qv.v[j], f[j], acc.x);
      acc.y = fmaf(qv.v[j + 1], f[j + 1], acc.y);
    }
  }
  __device__ static float total(float2 acc) { return acc.x + acc.y; }
  __device__ float finish(float dot, float2, float2 rm) const {
    return rm.x + coef * dot;
  }
};

}  // namespace quake

// q (B, d) and data (P, S, d) in the storage type (f32, or bf16 when
// is_bf16); valid (P, S) and qmask (B, U) as bytes; nrows (P,) and sel
// (U,) int32; order (U,) int32 the slots' order (a permutation within
// each chunk of Uc slots); ws the int32 workspace that GroupedWs lays
// out; part (B, Uc, K) scratch; gbuf null, or (K past what shared memory
// holds) scratch_blocks * QT * buffer_size(K) distances and as many
// indices; query_chunks the layout flag of scan_indexed_placement; run
// (B, K) the running result, initialised by the caller and updated in
// place.  K is a power of two <= K_MAX.
extern "C" int scan_indexed(void* q, void* data, void* valid, void* nrows,
                            void* sel, void* qmask, void* order, void* ws,
                            void* part_d, void* part_i, void* gbuf,
                            void* run_d, void* run_i, int B, int U, int S,
                            int d, int K, int Uc, int scratch_blocks,
                            int query_chunks, int is_bf16, int l2,
                            void* stream) {
  auto* s = static_cast<cudaStream_t>(stream);
  auto* v = static_cast<const uint8_t*>(valid);
  auto* nr = static_cast<const int*>(nrows);
  auto* se = static_cast<const int*>(sel);
  auto* qm = static_cast<const uint8_t*>(qmask);
  auto* od = static_cast<const int*>(order);
  auto* w = static_cast<int*>(ws);
  auto* pd = static_cast<float*>(part_d);
  auto* pi = static_cast<int*>(part_i);
  auto* gb = static_cast<float*>(gbuf);
  auto* rd = static_cast<float*>(run_d);
  auto* ri = static_cast<int*>(run_i);
  const float coef = l2 ? -2.f : -1.f;
  cudaError_t err;
  if (is_bf16) {
    using T = __nv_bfloat16;
    const quake::FloatTiles<T> pol{static_cast<const T*>(q),
                                   static_cast<const T*>(data), v, d, S,
                                   coef, l2};
    err = quake::launch_grouped(pol, se, nr, qm, od, w, pd, pi, gb,
                                scratch_blocks, query_chunks != 0, rd, ri,
                                B, U, S, K, Uc, s);
  } else {
    const quake::FloatTiles<float> pol{static_cast<const float*>(q),
                                       static_cast<const float*>(data), v,
                                       d, S, coef, l2};
    err = quake::launch_grouped(pol, se, nr, qm, od, w, pd, pi, gb,
                                scratch_blocks, query_chunks != 0, rd, ri,
                                B, U, S, K, Uc, s);
  }
  return static_cast<int>(err);
}

// The grouping step alone (the first two kernels of scan_indexed), for
// checking it against its plain version: qmask (B, U) bytes and the
// slots' order into ws, laid out as GroupedWs describes.
extern "C" int group_queries(void* qmask, void* order, void* ws, int B,
                             int U, int Uc, void* stream) {
  const quake::GroupedWs w(static_cast<int*>(ws), B, U, (U + Uc - 1) / Uc);
  return static_cast<int>(quake::launch_grouping(
      static_cast<const uint8_t*>(qmask), static_cast<const int*>(order), w,
      B, U, Uc, static_cast<cudaStream_t>(stream)));
}

// How a block lays out its shared memory for rows of width d at K
// (grouped_placement of scan_grouped.cuh: GROUPED_SMEM_BUFS or
// GROUPED_GLOBAL_BUFS, with GROUPED_QUERY_CHUNKS past the widths that
// hold the tile's queries whole), or the negated CUDA error.
extern "C" int scan_indexed_placement(int d, int K, int is_bf16) {
  int placement = 0;
  const cudaError_t err =
      is_bf16 ? quake::grouped_placement<
                    quake::FloatTiles<__nv_bfloat16>>(d, K, placement)
              : quake::grouped_placement<quake::FloatTiles<float>>(
                    d, K, placement);
  return err == cudaSuccess ? placement : -static_cast<int>(err);
}
