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
// d = 128, against 513 for f32 rows): about 0.12 GB at the timed plan of
// chip_smoke.py (B = 1024, U = 544, d = 128, K = 256), 0.037 ms at 3.35
// TB/s.  Its 2 * active_pair_rows * d int8 operations (about 0.8 G) take
// 0.0004 ms at the tensor cores' 1,979 TOP/s, and about 0.05 ms as
// __dp4a on the CUDA cores.
//
// What the design does about it: the f32 kernel's grouped driver
// (scan_grouped.cuh), with the Q8Tiles policy: a block scans one
// partition for up to 16 of the queries that probe it, so the codes are
// read once per 16 of a partition's queries instead of once per tile of
// 8 consecutive queries that holds one of them.  Codes are staged as
// 32-bit words, 256 rows at a time, with each row's scale, aux and valid
// flag; a thread owns a row and accumulates its products with each of the
// tile's queries, four __dp4a (exact in int32: 127^2 * d is far below
// 2^31) per 16-byte shared load of the row, in two independent chains.
// Pass two (merge_lists_kernel) is unchanged.
//
// What still separates it from the bound: the int8 products run as __dp4a
// on the CUDA cores, not on the tensor cores (mma s8.s8.s32, the next
// step), and the top-K selection of each (query, partition) pair sorts
// K = 256 entries in shared memory at least once.
#include "scan_grouped.cuh"

namespace quake {

// int8 codes as words (width = d / 4 a row); query codes as words.
struct Q8Tiles {
  using Unit = int;
  using QUnit = int;
  using Acc = int2;                  // two independent __dp4a chains
  using Dot = int;
  static constexpr int VEC = 4;      // words per 16 bytes
  static constexpr int TR = 256;     // rows per stage
  static constexpr int DCH = 32;     // 128 codes of a row per stage
                                     // (the ring fits beside K = 256
                                     // buffers up to d = 736)
  static constexpr int NMETA = 2;    // aux and scales, staged per row
  struct QV {
    int4 v;
  };

  const int* q_codes;                // (B, width)
  const float* q_scales;             // (B,)
  const int* codes;                  // (P, S, width)
  const float* scales;               // (P, S)
  const float* aux;                  // (P, S)
  const float* qc;                   // (B, U)
  const uint8_t* valid;              // (P, S)
  int width;
  int S;
  int U;
  float coef;

  __device__ bool aligned16() const {
    return (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  }
  __device__ const float* meta_src(int j) const {
    return j == 0 ? aux : scales;
  }
  __device__ const int* row(int p, int s) const {
    return codes + ((size_t)p * S + s) * width;
  }
  __device__ const int* query(int b) const {
    return q_codes + (size_t)b * width;
  }
  __device__ float2 query_meta(int b, int u) const {
    return make_float2(qc[(size_t)b * U + u], q_scales[b]);
  }
  __device__ static int widen(int v) { return v; }
  __device__ static void widen16(int* dst, const uint4& w) {
    *reinterpret_cast<uint4*>(dst) = w;
  }
  __device__ void row_fold(float2&, const uint4&) const {}
  __device__ void row_meta(float2, const float* mf, int r, bool v,
                           float2& rm, bool& ok) const {
    rm = make_float2(mf[r], mf[TR + r]);      // aux, scale
    ok = v;
  }
  __device__ static QV load_qv(const int* qp) {
    return QV{*reinterpret_cast<const int4*>(qp)};
  }
  __device__ static void fold(int2& acc, const QV& qv, const uint4& xv) {
    acc.x = __dp4a(static_cast<int>(xv.x), qv.v.x, acc.x);
    acc.y = __dp4a(static_cast<int>(xv.y), qv.v.y, acc.y);
    acc.x = __dp4a(static_cast<int>(xv.z), qv.v.z, acc.x);
    acc.y = __dp4a(static_cast<int>(xv.w), qv.v.w, acc.y);
  }
  __device__ static int total(int2 acc) { return acc.x + acc.y; }
  __device__ float finish(int dot, float2 qm, float2 rm) const {
    const float qx = __fadd_rn(
        qm.x, __fmul_rn(__fmul_rn(static_cast<float>(dot), qm.y), rm.y));
    return __fadd_rn(rm.x, __fmul_rn(coef, qx));
  }
};

}  // namespace quake

// q_codes (B, d) and codes (P, S, d) int8, d a multiple of 4; q_scales
// (B,), scales and aux (P, S), qc (B, U) f32; valid (P, S) and qmask
// (B, U) as bytes; nrows (P,), sel (U,) and order (U,) int32, order the
// slots' order (a permutation within each chunk of Uc slots); ws the int32
// workspace that GroupedWs lays out;
// part (B, Uc, K) scratch; gbuf null, or (K past what shared memory
// holds) scratch_blocks * QT * buffer_size(K) distances and as many
// indices; query_chunks the layout flag of scan_indexed_q8_placement;
// run (B, K) the running result, initialised by the caller and updated
// in place.  K is a power of two <= K_MAX.
extern "C" int scan_indexed_q8(void* q_codes, void* q_scales, void* codes,
                               void* scales, void* aux, void* qc,
                               void* valid, void* nrows, void* sel,
                               void* qmask, void* order, void* ws,
                               void* part_d, void* part_i, void* gbuf,
                               void* run_d, void* run_i, int B, int U, int S,
                               int d, int K, int Uc, int scratch_blocks,
                               int query_chunks, int l2, void* stream) {
  const quake::Q8Tiles pol{
      static_cast<const int*>(q_codes), static_cast<const float*>(q_scales),
      static_cast<const int*>(codes), static_cast<const float*>(scales),
      static_cast<const float*>(aux), static_cast<const float*>(qc),
      static_cast<const uint8_t*>(valid), d / 4, S, U, l2 ? -2.f : -1.f};
  return static_cast<int>(quake::launch_grouped(
      pol, static_cast<const int*>(sel), static_cast<const int*>(nrows),
      static_cast<const uint8_t*>(qmask), static_cast<const int*>(order),
      static_cast<int*>(ws),
      static_cast<float*>(part_d), static_cast<int*>(part_i),
      static_cast<float*>(gbuf), scratch_blocks, query_chunks != 0,
      static_cast<float*>(run_d), static_cast<int*>(run_i), B, U, S, K, Uc,
      static_cast<cudaStream_t>(stream)));
}

// How a block lays out its shared memory for codes of width d at K
// (grouped_placement of scan_grouped.cuh), or the negated CUDA error.
extern "C" int scan_indexed_q8_placement(int d, int K) {
  int placement = 0;
  const cudaError_t err =
      quake::grouped_placement<quake::Q8Tiles>(d / 4, K, placement);
  return err == cudaSuccess ? placement : -static_cast<int>(err);
}
