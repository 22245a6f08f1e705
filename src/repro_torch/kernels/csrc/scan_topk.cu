// Dense scan with exact top-K: the APS planner's centroid pass, the cost
// model's profile and per-query partition scans.
//
// Replaces the TPU kernel scan_topk_pallas (src/repro/kernels/scan_topk.py,
// _scan_topk_kernel): for Q queries against N rows, the ascending top-K
// of ||x||^2 + bias - 2 q.x (L2) or bias - q.x (IP) with bias = MASK_DIST
// on invalid rows.  Returns row indices; ||q||^2 is added by the caller.
// Equal distances keep the smaller row index; misses are (MASK_DIST, -1).
// Products are f32 FMAs (TF32 would break f32 parity); bf16 rows and
// queries are widened to f32.
//
// What bounds it on an H100, by regime:
// - Batches (the centroid pass, Q = 1024 x N = 1000 x d = 128): 2*Q*N*d
//   flops over (Q + N)*d*4 bytes, ~230 flop/byte, so f32 operations on the
//   CUDA cores (67 TFLOP/s) bound the products; the top-K selection of
//   Q*N candidates is the rest of the work.
// - Few queries (one-query probes, Q = 1 x N ~ 1,000): N*d*4 bytes and
//   2*N*d flops, 0.5 flop/byte, so bytes bound it, and at 512 KB the
//   bound (0.15 us) is far below a kernel launch: launch latency is the
//   floor.
//
// Design A, batches (dense_tiles_kernel): a register-tiled SGEMM with the
// top-K as its epilogue, after kmeans_assign.cu's main loop.  A block
// takes 32 queries x 128 rows; d runs through shared memory in chunks of
// 32, zeros past d, double-buffered: f32 rows whose width is a multiple of
// 4 by 16-byte cp.async copies, others widened by the staging threads.
// A chunk is stored row by row with its 16-byte columns XOR-swizzled by
// the row, so the copies, and the compute threads' float4 reads of 4 rows
// (or 4 queries, a broadcast) at one column, meet no bank conflict.
// Thread (warp w, lane l) keeps queries 4w..4w+3 x rows 4l..4l+3 in 4 x 4
// accumulators: per 4 dims 8 float4 reads for 64 FMAs (kmeans_assign's
// transposing 4-byte copies and 16-dim chunks were slower here: the
// staging took as long as the products).  ||x||^2 is summed once per row:
// warp w sums column w of each chunk, and the eight partial sums meet in
// shared memory.  After a row tile's last chunk each warp writes its q.x
// tile into the stage it has just read and offers each of its queries the
// tile's rows, 32 at a time in increasing row index, to the query's
// WarpTopK (only rows below the running K-th distance are admitted, so
// strict "<" keeps ties exact).  A block walks several row tiles for its
// query tile, so its lists carry over.  The tile is 32 queries, not
// kmeans_assign's 128, because the epilogue runs one warp per 4 queries:
// at 1024 x 1000 a 128-query tile gives 64 blocks whose warps select for
// 16 queries each, one after another (8 x 4 accumulators with 64-query
// tiles spilled under two blocks an SM and were slower).  Rows are split
// over blocks as far as fills the card in one wave (2 blocks an SM); each
// split writes its lists and merge_splits_kernel folds them (a fold in
// the last split's block instead was slower: 32 blocks folding 1024
// queries).  Past 64 KB of top-K buffers a block (k_pad > 128) they live
// in a global scratch, one slot per block of a grid that walks the work
// items.  What still bounds it is the epilogue: at 1024 x 16,384, k_pad
// 128, the selection behind each row tile's barrier takes about three
// times the products.
//
// Design B, few queries (dense_rows_kernel): one launch in all.  The rows
// are split over every warp of G blocks, 32-row ranges in order.  A warp
// reads 32 whole rows at a time with 16-byte loads (neighbouring lanes
// on neighbouring addresses, all 32 rows' loads in flight), each lane
// summing its slice of every row; a reduce-scatter of 31 shuffles gives
// lane r row r's distance, and the warp offers the 32 rows to its
// WarpTopK.  The queries are read from global memory (L1), one after
// another.  Each block folds its 8 warps' sorted lists; with G > 1 it
// writes its list to a scratch, and the last block to finish (an atomic
// ticket, which it resets, so no call needs a memset) folds the G lists
// and writes the output, misses included.  Nothing else is launched: no
// fill, no second kernel.
//
// The wrapper (kernels/scan_topk.py) takes B below CROSSOVER_Q = 3
// queries and A from there on, as both designs' device times on the card
// put it (chip_smoke.py prints them).
#include "async_copy.cuh"
#include "scan_common.cuh"

namespace quake {
namespace dense {

constexpr int RT = 128;          // rows a tile (design A)
constexpr int KC = 32;           // d a staged chunk
constexpr int CH = KC / 4;       // its 16-byte columns
constexpr int MQ = 4;            // queries a warp, and a thread, keeps
constexpr int QT = WARPS * MQ;   // queries a tile

// Shared memory of one design-A block, before its top-K buffers: two
// stages of a row chunk [RT][KC] and a query chunk [QT][KC].  After a row
// tile's last chunk is summed, the stage just read holds the warps' q.x
// tiles ([WARPS][MQ][RT], in xs) and partial norms ([WARPS][RT], in qs).
struct TilesSmem {
  float xs[2][RT * KC];
  float qs[2][QT * KC];
};
static_assert(WARPS * MQ * RT <= RT * KC && WARPS * RT <= QT * KC,
              "the q.x tiles and norms fit a stage");

__host__ inline size_t tiles_smem_bytes(int K, bool global_bufs) {
  return sizeof(TilesSmem) + (global_bufs ? 0
      : (sizeof(float) + sizeof(int)) * (size_t)QT * buffer_size(K));
}

// Offset of (row r, 16-byte column c) in a staged [R][KC] chunk: the
// column is XOR-swizzled with (r / 4) % 8, so the 8 lanes of a quarter
// warp that read rows 4l + j (l = 0..7) at one column, and the 8 threads
// that stage one row, hit 8 distinct groups of 4 banks.
__device__ __forceinline__ int swz(int r, int c) {
  return r * KC + 4 * (c ^ ((r >> 2) & 7));
}

// rows [row0, row0 + R) of src (n rows of d), dims [k0, k0 + KC) ->
// dst, swizzled; zeros past n and d.  VEC: 16-byte cp.async (f32, d a
// multiple of 4, 16-byte aligned rows); else loads widened to f32 by the
// staging threads.
template <typename T, bool VEC, int R>
__device__ __forceinline__ void stage_chunk(float* dst,
                                            const T* __restrict__ src,
                                            int row0, int n, int d,
                                            int k0) {
  static_assert(R * CH % THREADS == 0, "whole copies a thread");
#pragma unroll
  for (int i = 0; i < R * CH / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / CH, c = e % CH, k = k0 + 4 * c;
    const bool row_in = row0 + r < n;
    const T* p = src + (row_in ? (size_t)(row0 + r) * d : 0);
    if constexpr (VEC) {
      cp_async<16>(smem_addr(dst + swz(r, c)), p + (k < d ? k : 0),
                   row_in && k < d);
    } else {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = row_in && k + j < d ? to_f32(p[k + j]) : 0.f;
      *reinterpret_cast<float4*>(dst + swz(r, c)) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// Fold the L ascending K-lists d/ix[l * stride, + K) pairwise into list
// 0: each fold keeps the K smallest of (a, b) as min(a[t], b[K-1-t]), a
// bitonic sequence, sorted by log2(K) half-cleaner stages.  K is a power
// of two.  Every thread of the block must call it.
__device__ void tree_merge(float* d, int* ix, int L, int K, int stride) {
  const int tid = threadIdx.x, nt = blockDim.x;
  int lk = 0;
  while ((1 << lk) < K) ++lk;
  for (int step = 1; step < L; step <<= 1) {
    const int pairs = (L + step - 1) / (2 * step);
    for (int u = tid; u < (pairs << lk); u += nt) {
      const size_t a = (size_t)(u >> lk) * 2 * step * stride;
      const size_t b = a + (size_t)step * stride + K - 1 - (u & (K - 1));
      const size_t t = a + (u & (K - 1));
      if (before(d[b], ix[b], d[t], ix[t])) {
        d[t] = d[b];
        ix[t] = ix[b];
      }
    }
    __syncthreads();
    for (int s = K >> 1; s >= 1; s >>= 1) {
      for (int u = tid; u < (pairs << (lk - 1)); u += nt) {
        const int t = u & ((K >> 1) - 1);
        const size_t i = (size_t)(u >> (lk - 1)) * 2 * step * stride
            + 2 * t - (t & (s - 1));
        const size_t j = i + s;
        if (before(d[j], ix[j], d[i], ix[i])) {
          const float dt = d[i]; d[i] = d[j]; d[j] = dt;
          const int it = ix[i]; ix[i] = ix[j]; ix[j] = it;
        }
      }
      __syncthreads();
    }
  }
}

// Count this block in *ticket: true in the last of n blocks to count,
// which resets the ticket for the next launch.  Every thread of the block
// calls it after writing what the last block will read.
__device__ bool last_block(unsigned* ticket, int n) {
  __shared__ bool last;
  __threadfence();                 // this block's writes before its count
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1u) == (unsigned)n - 1;
    if (last) *ticket = 0u;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 2) dense_tiles_kernel(
    const T* __restrict__ q, const T* __restrict__ xs,
    const uint8_t* __restrict__ valid, float* __restrict__ out_d,
    int* __restrict__ out_i, float* __restrict__ part_d,
    int* __restrict__ part_i, float* __restrict__ gbuf_d,
    int* __restrict__ gbuf_i, int Q, int N, int d, int K, int splits,
    int tiles_per_split, int l2) {
  extern __shared__ __align__(16) float smem[];
  TilesSmem& sm = *reinterpret_cast<TilesSmem*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int buf = buffer_size(K);
  float* bd;
  int* bi;
  if (gbuf_d == nullptr) {
    float* base = smem + sizeof(TilesSmem) / sizeof(float);
    bd = base + warp * MQ * buf;
    bi = reinterpret_cast<int*>(base + QT * buf) + warp * MQ * buf;
  } else {
    const size_t o = ((size_t)blockIdx.x * WARPS + warp) * MQ * buf;
    bd = gbuf_d + o;
    bi = gbuf_i + o;
  }
  const float coef = l2 ? -2.f : -1.f;
  const int rtiles = (N + RT - 1) / RT;
  const int items = (Q + QT - 1) / QT * splits;
  const int chunks = max(1, (d + KC - 1) / KC);   // d = 0: one of zeros
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int q0 = item / splits * QT, sp = item % splits;
    const int t0 = sp * tiles_per_split;
    const int steps = (min(rtiles, t0 + tiles_per_split) - t0) * chunks;
    // each query's WarpTopK state between tiles (its buffer is fixed)
    int count[MQ];
    float thr[MQ];
#pragma unroll
    for (int i = 0; i < MQ; ++i) {
      count[i] = 0;
      thr[i] = INFINITY;
    }
    auto stage = [&](int step) {
      const int b = step & 1, k0 = (step % chunks) * KC;
      stage_chunk<T, VEC, QT>(sm.qs[b], q, q0, Q, d, k0);
      stage_chunk<T, VEC, RT>(sm.xs[b], xs, (t0 + step / chunks) * RT, N,
                              d, k0);
    };
    float acc[MQ][4], nrm[4];
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
        for (int j = 0; j < 4; ++j) {
          nrm[j] = 0.f;
#pragma unroll
          for (int i = 0; i < MQ; ++i) acc[i][j] = 0.f;
        }
      }
      float* xa = sm.xs[s & 1];
      float* qa = sm.qs[s & 1];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        float4 xv[4], qv[MQ];
#pragma unroll
        for (int j = 0; j < 4; ++j)      // rows 4 lane + j, dims 4c..4c+3
          xv[j] = *reinterpret_cast<const float4*>(xa + swz(4 * lane + j, c));
#pragma unroll
        for (int i = 0; i < MQ; ++i)     // a broadcast in the warp
          qv[i] = *reinterpret_cast<const float4*>(qa + swz(warp * MQ + i,
                                                            c));
#pragma unroll
        for (int i = 0; i < MQ; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(qv[i].x, xv[j].x, acc[i][j]);
            acc[i][j] = fmaf(qv[i].y, xv[j].y, acc[i][j]);
            acc[i][j] = fmaf(qv[i].z, xv[j].z, acc[i][j]);
            acc[i][j] = fmaf(qv[i].w, xv[j].w, acc[i][j]);
          }
        if (c == warp) {                 // this warp's share of ||x||^2
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            nrm[j] = fmaf(xv[j].x, xv[j].x, nrm[j]);
            nrm[j] = fmaf(xv[j].y, xv[j].y, nrm[j]);
            nrm[j] = fmaf(xv[j].z, xv[j].z, nrm[j]);
            nrm[j] = fmaf(xv[j].w, xv[j].w, nrm[j]);
          }
        }
      }
      if (chunk == chunks - 1) {         // the row tile is summed over d
        __syncthreads();                 // every warp is done with the stage
        float* qx = xa + warp * MQ * RT;   // this warp's q.x tile
#pragma unroll
        for (int i = 0; i < MQ; ++i)
          *reinterpret_cast<float4*>(qx + i * RT + lane * 4) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(qa + warp * RT + lane * 4) =
            make_float4(nrm[0], nrm[1], nrm[2], nrm[3]);
        __syncthreads();                 // every warp's norms are in
        const int row0 = (t0 + s / chunks) * RT;
        float aux[RT / 32];
        bool ok[RT / 32];
#pragma unroll
        for (int p = 0; p < RT / 32; ++p) {
          const int r = p * 32 + lane, row = row0 + r;
          float a = 0.f;
          if (l2) {
#pragma unroll
            for (int w = 0; w < WARPS; ++w) a += qa[w * RT + r];
          }
          aux[p] = a;
          ok[p] = row < N && (valid == nullptr || valid[row] != 0);
        }
#pragma unroll
        for (int i = 0; i < MQ; ++i) {
          if (q0 + warp * MQ + i >= Q) break;    // uniform in the warp
          WarpTopK top{bd + i * buf, bi + i * buf, K, buf, count[i], thr[i]};
#pragma unroll
          for (int p = 0; p < RT / 32; ++p) {
            const float dist = aux[p] + coef * qx[i * RT + p * 32 + lane];
            top.push(lane, dist, row0 + p * 32 + lane,
                     ok[p] && dist < MASK_DIST);
          }
          count[i] = top.count;
          thr[i] = top.thr;
        }
      }
      __syncthreads();   // every thread is done with this stage's buffers
    }
    cp_async_wait<0>();
#pragma unroll
    for (int i = 0; i < MQ; ++i) {    // this split's lists (out if only one)
      const int b = q0 + warp * MQ + i;
      if (b >= Q) break;
      const size_t o = ((size_t)b * splits + sp) * K;
      WarpTopK top{bd + i * buf, bi + i * buf, K, buf, count[i], thr[i]};
      top.write(lane, (splits == 1 ? out_d : part_d) + o,
                (splits == 1 ? out_i : part_i) + o);
    }
  }
}

// Design A's second pass, with splits > 1: one block a query loads its
// split lists into shared memory and folds them.
__global__ void __launch_bounds__(MERGE_THREADS) merge_splits_kernel(
    const float* __restrict__ part_d, const int* __restrict__ part_i,
    float* __restrict__ out_d, int* __restrict__ out_i, int splits,
    int K) {
  extern __shared__ __align__(16) float msmem[];
  float* md = msmem;
  int* mi = reinterpret_cast<int*>(msmem + (size_t)splits * K);
  const size_t o = (size_t)blockIdx.x * splits * K;
  for (int t = threadIdx.x; t < splits * K; t += MERGE_THREADS) {
    md[t] = part_d[o + t];
    mi[t] = part_i[o + t];
  }
  __syncthreads();
  tree_merge(md, mi, splits, K, K);
  for (int t = threadIdx.x; t < K; t += MERGE_THREADS) {
    out_d[(size_t)blockIdx.x * K + t] = md[t];
    out_i[(size_t)blockIdx.x * K + t] = mi[t];
  }
}

// E values of a row from p (16 bytes when E > 1; p aligned to them).
template <typename T, int E>
__device__ __forceinline__ void load_vals(const T* __restrict__ p,
                                          float (&v)[E]) {
  if constexpr (E == 1) {
    v[0] = to_f32(__ldg(p));
  } else if constexpr (sizeof(T) == 4) {
    static_assert(E == 4, "16 bytes of f32");
    const float4 w = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  } else {
    static_assert(E == 8, "16 bytes of bf16");
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u[h]));
      v[2 * h] = f.x;
      v[2 * h + 1] = f.y;
    }
  }
}

// One level of the warp's reduce-scatter of v[32] (row r's partial sums,
// one a lane): after the level of offset O, v[i] for i < O holds row
// i + (the lane's bits >= O) summed over the lanes that differ in bit O
// and below it.  After O = 16, 8, 4, 2, 1, v[0] is row `lane`'s sum.
template <int O>
__device__ __forceinline__ void reduce_scatter(float (&v)[32], int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float give = up ? v[i] : v[i + O];
    const float keep = up ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, give, O);
  }
}

// Shared memory of one design-B block: its warps' top-K buffers when they
// stay there, and the last block's G lists of one query.
__host__ __device__ inline size_t rows_smem_bytes(int K, int G,
                                                  bool global_bufs) {
  const size_t bufs = global_bufs ? 0 : (size_t)WARPS * buffer_size(K);
  const size_t lists = G > 1 ? (size_t)G * K : 0;
  return (sizeof(float) + sizeof(int)) * (bufs > lists ? bufs : lists);
}

template <typename T, int E>
__global__ void __launch_bounds__(THREADS) dense_rows_kernel(
    const T* __restrict__ q, const T* __restrict__ xs,
    const uint8_t* __restrict__ valid, float* __restrict__ out_d,
    int* __restrict__ out_i, float* __restrict__ part_d,
    int* __restrict__ part_i, float* __restrict__ gbuf_d,
    int* __restrict__ gbuf_i, unsigned* __restrict__ ticket, int Q, int N,
    int d, int K, int rows_per_warp, int l2) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = gridDim.x, buf = buffer_size(K);
  float* ld;                                  // the block's warp lists
  int* li;
  if (gbuf_d == nullptr) {
    ld = smem;
    li = reinterpret_cast<int*>(smem + WARPS * buf);
  } else {
    ld = gbuf_d + (size_t)blockIdx.x * WARPS * buf;
    li = gbuf_i + (size_t)blockIdx.x * WARPS * buf;
  }
  const float coef = l2 ? -2.f : -1.f;
  const long first = ((long)blockIdx.x * WARPS + warp) * rows_per_warp;
  const int r_begin = (int)min((long)N, first);
  const int r_end = (int)min((long)N, first + rows_per_warp);
  for (int b = 0; b < Q; ++b) {
    WarpTopK top{ld + warp * buf, li + warp * buf, K, buf, 0,
                        INFINITY};
    const T* qb = q + (size_t)b * d;
    for (int r0 = r_begin; r0 < r_end; r0 += 32) {
      float v[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) v[r] = 0.f;
      const int last_row = min(r0 + 32, r_end) - 1;
      for (int c = lane * E; c < d; c += 32 * E) {
        float qc[E];
        load_vals<T, E>(qb + c, qc);
#pragma unroll
        for (int e = 0; e < E; ++e) qc[e] *= coef;     // exact: -2 or -1
        constexpr int RG = E > 4 ? 16 : 32;   // rows whose loads fly together
#pragma unroll
        for (int g = 0; g < 32; g += RG) {
          float x[RG][E];
#pragma unroll
          for (int r = 0; r < RG; ++r)      // past the range: its last row
            load_vals<T, E>(xs + (size_t)min(r0 + g + r, last_row) * d + c,
                            x[r]);
#pragma unroll
          for (int r = 0; r < RG; ++r)
#pragma unroll
            for (int e = 0; e < E; ++e)     // x.x - 2 q.x, or -q.x
              v[g + r] = fmaf(x[r][e], l2 ? x[r][e] + qc[e] : qc[e],
                              v[g + r]);
        }
      }
      reduce_scatter<16>(v, lane);
      reduce_scatter<8>(v, lane);
      reduce_scatter<4>(v, lane);
      reduce_scatter<2>(v, lane);
      reduce_scatter<1>(v, lane);
      const int row = r0 + lane;
      const bool ok = row < r_end && (valid == nullptr || valid[row] != 0);
      top.push(lane, v[0], row, ok && v[0] < MASK_DIST);
    }
    top.write(lane, ld + warp * buf, li + warp * buf);   // sorted, in place
    __syncthreads();
    tree_merge(ld, li, WARPS, K, buf);
    const size_t o = G == 1 ? (size_t)b * K
                            : ((size_t)b * G + blockIdx.x) * K;
    for (int t = threadIdx.x; t < K; t += THREADS) {
      (G == 1 ? out_d : part_d)[o + t] = ld[t];
      (G == 1 ? out_i : part_i)[o + t] = li[t];
    }
    __syncthreads();
  }
  if (G == 1 || !last_block(ticket, G)) return;
  float* md = smem;
  int* mi = reinterpret_cast<int*>(smem + (size_t)G * K);
  for (int b = 0; b < Q; ++b) {
    const size_t o = (size_t)b * G * K;
    for (int t = threadIdx.x; t < G * K; t += THREADS) {
      md[t] = __ldcg(part_d + o + t);
      mi[t] = __ldcg(part_i + o + t);
    }
    __syncthreads();
    tree_merge(md, mi, G, K, K);
    for (int t = threadIdx.x; t < K; t += THREADS) {
      out_d[(size_t)b * K + t] = md[t];
      out_i[(size_t)b * K + t] = mi[t];
    }
    __syncthreads();
  }
}

__global__ void empty_kernel() {}

template <typename T, bool VEC>
cudaError_t launch_tiles(const void* q, const void* xs, const uint8_t* valid,
                         float* out_d, int* out_i, float* part_d,
                         int* part_i, float* gbuf_d, int* gbuf_i, int Q,
                         int N, int d, int K, int splits,
                         int tiles_per_split, int grid, int l2,
                         cudaStream_t stream) {
  const size_t smem = tiles_smem_bytes(K, gbuf_d != nullptr);
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(&dense_tiles_kernel<T, VEC>), smem);
  if (err != cudaSuccess) return err;
  dense_tiles_kernel<T, VEC><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(xs), valid, out_d,
      out_i, part_d, part_i, gbuf_d, gbuf_i, Q, N, d, K, splits,
      tiles_per_split, l2);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t msmem = (sizeof(float) + sizeof(int)) * (size_t)splits * K;
  err = allow_smem(reinterpret_cast<const void*>(&merge_splits_kernel),
                   msmem);
  if (err != cudaSuccess) return err;
  merge_splits_kernel<<<Q, MERGE_THREADS, msmem, stream>>>(
      part_d, part_i, out_d, out_i, splits, K);
  return cudaGetLastError();
}

template <typename T, int E>
cudaError_t launch_rows(const void* q, const void* xs, const uint8_t* valid,
                        float* out_d, int* out_i, float* part_d,
                        int* part_i, float* gbuf_d, int* gbuf_i,
                        unsigned* ticket, int Q, int N, int d, int K,
                        int blocks, int rows_per_warp, int l2,
                        cudaStream_t stream) {
  const size_t smem = rows_smem_bytes(K, blocks, gbuf_d != nullptr);
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(&dense_rows_kernel<T, E>), smem);
  if (err != cudaSuccess) return err;
  dense_rows_kernel<T, E><<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(xs), valid, out_d,
      out_i, part_d, part_i, gbuf_d, gbuf_i, ticket, Q, N, d, K,
      rows_per_warp, l2);
  return cudaGetLastError();
}

}  // namespace dense
}  // namespace quake

namespace {
bool bad_k(int K) { return K < 1 || K > quake::K_MAX || (K & (K - 1)); }
}  // namespace

// Design A.  q (Q, d) and xs (N, d) in the storage type (f32, or bf16
// when is_bf16); valid (N,) bytes or null; out (Q, K), written whole.
// vec: f32 rows copied 16 bytes at a time (xs and q 16-byte aligned, d a
// multiple of 4).  Query tiles of 32 x row tiles of 128; the row tiles
// are split over blocks, tiles_per_split each.  With splits > 1, part
// (Q, splits, K) holds every split's lists and a second kernel folds them
// into out (splits * K <= 12,288).  gbuf null keeps the top-K buffers in
// shared memory; else it holds grid blocks' buffers, grid * 32 *
// buffer_size(K) distances then as many indices, and the grid walks the
// (query tile, split) items.
extern "C" int scan_dense_tiles(void* q, void* xs, void* valid,
                                void* part_d, void* part_i, void* gbuf,
                                void* out_d, void* out_i, int Q, int N,
                                int d, int K, int splits,
                                int tiles_per_split, int grid, int vec,
                                int is_bf16, int l2, void* stream) {
  if (bad_k(K) || Q < 1 || N < 1 || splits < 1 ||
      tiles_per_split < 1 || grid < 1 ||
      (splits > 1 && (part_d == nullptr || (size_t)splits * K > 12288)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* gd = static_cast<float*>(gbuf);
  int* gi = gd == nullptr ? nullptr : reinterpret_cast<int*>(
      gd + (size_t)grid * quake::dense::QT * quake::buffer_size(K));
  auto* s = static_cast<cudaStream_t>(stream);
  auto* v = static_cast<const uint8_t*>(valid);
  auto* od = static_cast<float*>(out_d);
  auto* oi = static_cast<int*>(out_i);
  auto* pd = static_cast<float*>(part_d);
  auto* pi = static_cast<int*>(part_i);
  using quake::dense::launch_tiles;
  cudaError_t err = is_bf16
      ? launch_tiles<__nv_bfloat16, false>(q, xs, v, od, oi, pd, pi, gd, gi,
                                           Q, N, d, K, splits,
                                           tiles_per_split, grid, l2, s)
      : vec ? launch_tiles<float, true>(q, xs, v, od, oi, pd, pi, gd, gi, Q,
                                        N, d, K, splits, tiles_per_split,
                                        grid, l2, s)
            : launch_tiles<float, false>(q, xs, v, od, oi, pd, pi, gd, gi, Q,
                                         N, d, K, splits, tiles_per_split,
                                         grid, l2, s);
  return static_cast<int>(err);
}

// Design B, one launch.  Operands as above.  Rows are cut into ranges of
// rows_per_warp (a multiple of 32), one a warp of blocks x 8 warps; with
// blocks > 1, part (Q, blocks, K) holds each block's list and ticket (one
// word, 0 between launches on its stream) finds the last block.  gbuf
// null keeps the top-K buffers in shared memory (K <= 1024); else it
// holds blocks * 8 * buffer_size(K) distances then as many indices.  vec:
// rows are read 16 bytes a lane (xs and q 16-byte aligned, d * size a
// multiple of 16).
extern "C" int scan_dense_rows(void* q, void* xs, void* valid, void* part_d,
                               void* part_i, void* gbuf, void* ticket,
                               void* out_d, void* out_i, int Q, int N,
                               int d, int K, int blocks, int rows_per_warp,
                               int vec, int is_bf16, int l2, void* stream) {
  if (bad_k(K) || Q < 1 || N < 1 || blocks < 1 || rows_per_warp < 32 ||
      rows_per_warp % 32 || (blocks > 1 && ticket == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* gd = static_cast<float*>(gbuf);
  int* gi = gd == nullptr ? nullptr : reinterpret_cast<int*>(
      gd + (size_t)blocks * quake::WARPS * quake::buffer_size(K));
  auto* s = static_cast<cudaStream_t>(stream);
  auto* v = static_cast<const uint8_t*>(valid);
  auto* od = static_cast<float*>(out_d);
  auto* oi = static_cast<int*>(out_i);
  auto* pd = static_cast<float*>(part_d);
  auto* pi = static_cast<int*>(part_i);
  auto* tk = static_cast<unsigned*>(ticket);
  using quake::dense::launch_rows;
  cudaError_t err;
  if (is_bf16)
    err = vec ? launch_rows<__nv_bfloat16, 8>(q, xs, v, od, oi, pd, pi, gd,
                                              gi, tk, Q, N, d, K, blocks,
                                              rows_per_warp, l2, s)
              : launch_rows<__nv_bfloat16, 1>(q, xs, v, od, oi, pd, pi, gd,
                                              gi, tk, Q, N, d, K, blocks,
                                              rows_per_warp, l2, s);
  else
    err = vec ? launch_rows<float, 4>(q, xs, v, od, oi, pd, pi, gd, gi, tk,
                                      Q, N, d, K, blocks, rows_per_warp, l2,
                                      s)
              : launch_rows<float, 1>(q, xs, v, od, oi, pd, pi, gd, gi, tk,
                                      Q, N, d, K, blocks, rows_per_warp, l2,
                                      s);
  return static_cast<int>(err);
}

// An empty kernel, launched as the scans are: the floor of a launch.
extern "C" int launch_empty(void* stream) {
  auto* s = static_cast<cudaStream_t>(stream);
  quake::dense::empty_kernel<<<1, 32, 0, s>>>();
  return static_cast<int>(cudaGetLastError());
}
