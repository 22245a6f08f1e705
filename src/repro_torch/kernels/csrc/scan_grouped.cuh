// The grouped partition-scan driver of the two indexed scans
// (scan_topk_indexed.cu for f32/bf16 rows, scan_topk_indexed_q8.cu for
// int8 codes).  Each kernel plugs in a row policy; the driver groups the
// queries by the partitions they probe, stages each partition's rows
// once per group, and keeps every query's top-K (scan_common.cuh).
//
// Inputs: B queries, a union of U selected partitions sel[u] of a
// (P, S, width) snapshot, and qmask (B, U): query b sees union slot u only
// where qmask[b, u].  Output: per (query, union slot) pair the sorted
// K-list, into the (B, Uc, K) scratch that pass two (merge_lists_kernel)
// folds into each query's result, Uc union slots at a time.
//
// 1. group_queries_kernel (one block per u) compacts column u of qmask
//    into the list of queries that probe u, in increasing b, and its
//    count n_u.  tile_list_kernel (one block) turns the counts into a
//    flat work list of tiles of up to QT of a slot's queries, the slots
//    taken in the order the wrapper gives (within each chunk of Uc
//    slots, the longest partitions first): tile_off[u] is where u's
//    tiles start, chunk_off[c] where chunk c's start, work_u[t] the slot
//    of tile t.  Both run on the device, so the host never waits for the
//    plan's shape.
// 2. grouped_scan_kernel, per chunk: a persistent grid (as many blocks
//    as fit on the card) takes the chunk's tiles in order through an
//    atomic counter, so the longest tiles start first and blocks that
//    drew short ones take more.  A tile is (u, up to QT of u's queries):
//    the partition's live rows are read once per QT of its queries, and
//    blocks exist only for work that is there.  Which block takes which
//    tile does not change the result: each tile writes its own (query,
//    slot) lists.  A grid-stride walk was the alternative; with tiles of
//    very different lengths (partitions hold 0 to S rows) it leaves the
//    SMs that drew long ones working alone.
//
// Inside a tile, rows go through shared memory TR at a time in a
// STAGES-deep cp.async ring (16-byte copies when the row width and base
// allow, plain loads otherwise), each staged row padded by 16 bytes so
// the 16-byte reads of eight consecutive rows hit distinct banks.  (One
// bulk copy a row on an mbarrier, Hopper's copy engine, was slower here:
// 512-byte rows are small transfers for it.)  Rows
// wider than the policy's DCH units are staged in column chunks, the
// accumulators carried in registers from chunk to chunk, so the row
// ring does not grow with d.  The tile's queries are staged whole, once
// a tile, while the block fits the card's shared memory (first with the
// top-K buffers there, then with them in global memory: see
// grouped_placement); past that width each stage of the ring also
// carries the tile's queries' matching column chunk (GROUPED_QUERY_CHUNKS),
// loaded beside the rows' chunk, so no part of the block grows with d
// and rows of any width run.  All lanes of a warp read the same query
// unit (a broadcast), so the query chunks need no bank padding; their
// chunk is the rows' DCH, so the 16-byte units line up for the q8
// policy's __dp4a.  Thread t owns row t % TR of each
// stage and queries t / TR, t / TR + QB, .. of the tile (QB = 256 / TR):
// every warp computes whatever the number of queries, and each 16-byte
// read of a staged row feeds 4-8 FMAs (or 4 __dp4a) per query, the
// queries' vectors being broadcast reads.  The threads of the first
// query block also compute the row's own terms (||x||^2 for float rows),
// once per row.  The products go to a (QT, TR) tile in shared memory,
// double-buffered by row tile: while the block computes row tile t + 1,
// the warps that own the tile's queries (one query per warp up to 8, on
// the warps with the fewest products to sum) form row tile t's distances
// and offer them 32 at a time to their WarpTopK, whose admission
// threshold rejects most after the first K rows.
#pragma once

#include "async_copy.cuh"
#include "scan_common.cuh"

namespace quake {

constexpr int QT = 16;               // queries per tile
constexpr int MQ = QT / WARPS;       // queries whose top-K a warp keeps
constexpr int STAGES = 3;            // depth of the row ring
constexpr int GROUP_THREADS = 256;
constexpr int TILE_LIST_THREADS = 1024;
// most bytes of top-K buffers a block keeps in shared memory; past it, or
// past the card's shared memory, they go to the wrapper's global scratch
constexpr size_t TOPK_SMEM_BYTES = 64 << 10;

// Block-wide exclusive scan of one int per thread (blockDim.x a multiple
// of 32, at most 1024).  Returns the thread's exclusive prefix and sets
// total.  Every thread must call it; it synchronises the block.
__device__ inline int block_exclusive_scan(int v, int& total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int off = 0;
  total = 0;
  for (int w = 0; w < nw; ++w) {
    const int s = warp_sums[w];
    if (w < warp) off += s;
    total += s;
  }
  __syncthreads();                   // warp_sums free for the next call
  return off + incl - v;
}

// qlist[u * B + i] = the i-th query b (increasing) with qmask[b, u];
// qcount[u] = their number; ntiles[u] = ceil(qcount[u] / QT).
__global__ void __launch_bounds__(GROUP_THREADS) group_queries_kernel(
    const uint8_t* __restrict__ qmask, int B, int U, int* __restrict__ qlist,
    int* __restrict__ qcount, int* __restrict__ ntiles) {
  const int u = blockIdx.x, tid = threadIdx.x;
  int base = 0;
  for (int b0 = 0; b0 < B; b0 += 4 * GROUP_THREADS) {
    const int bt = b0 + 4 * tid;       // this thread's four consecutive b
    int flags = 0, cnt = 0;
    for (int j = 0; j < 4; ++j) {
      const bool f = bt + j < B && qmask[(size_t)(bt + j) * U + u] != 0;
      flags |= (int)f << j;
      cnt += f;
    }
    int total;
    int pos = base + block_exclusive_scan(cnt, total);
    for (int j = 0; j < 4; ++j)
      if ((flags >> j) & 1) qlist[(size_t)u * B + pos++] = bt + j;
    base += total;
  }
  if (tid == 0) {
    qcount[u] = base;
    ntiles[u] = (base + QT - 1) / QT;
  }
}

// The slots in the order order[0..U) (a permutation that keeps each
// chunk of Uc slots in place): chunk_off[c] = the tiles of the slots
// before chunk c, chunk_off[nchunks] = all tiles; tile_off[u] = where
// u's tiles start; work_u[t] = the slot of tile t.  The chunks' tile
// counters set to 0.
__global__ void __launch_bounds__(TILE_LIST_THREADS) tile_list_kernel(
    const int* __restrict__ ntiles, const int* __restrict__ order, int U,
    int Uc, int* __restrict__ tile_off, int* __restrict__ chunk_off,
    int* __restrict__ work_u, int* __restrict__ counters, int nchunks) {
  const int tid = threadIdx.x;
  int base = 0;
  for (int v0 = 0; v0 < U; v0 += blockDim.x) {
    const int v = v0 + tid;
    const int u = v < U ? order[v] : 0;
    const int n = v < U ? ntiles[u] : 0;
    int total;
    const int off = base + block_exclusive_scan(n, total);
    if (v < U) {
      tile_off[u] = off;
      for (int j = 0; j < n; ++j) work_u[off + j] = u;
      if (v % Uc == 0) chunk_off[v / Uc] = off;
    }
    base += total;
  }
  if (tid == 0) chunk_off[nchunks] = base;
  for (int c = tid; c < nchunks; c += blockDim.x) counters[c] = 0;
}

// Operands of one chunk's pass one.
struct GroupedArgs {
  const int* sel;          // (U,) partition of each union slot
  const int* nrows;        // (P,) live rows of each partition
  const int* qlist;        // (U, B) from group_queries_kernel
  const int* qcount;       // (U,)
  const int* tile_off;     // (U,)
  const int* work_u;       // (tiles,)
  const int* chunk_off;    // (nchunks + 1,)
  int chunk;
  int* counter;            // this chunk's tile counter, 0 at launch
  float* part_d;           // (B, Uc, K)
  int* part_i;
  float* gbuf_d;           // null: top-K buffers in shared memory; else
  int* gbuf_i;             //   gridDim.x * QT buffers of buffer_size(K)
  int B, S, K, u0, Uc;
  bool query_chunks;       // the queries staged a column chunk a stage
};

// Shared-memory layout of one grouped block, in bytes.  A staged row
// holds one column chunk of at most Pol::DCH units (all of it at d = 128).
// The tile's queries are held whole (qld = dv), or with query_chunks one
// column chunk a stage of the ring (qld = the chunk's units).
template <class Pol>
struct GroupedSmem {
  int dv;                  // row width rounded up to a 16-byte vector
  int ld;                  // staged row stride in units
  int qld;                 // staged query stride in units
  size_t xs, mf, mv, qs, dt, meta, qmeta, bufd, bufi, qb, ok, total;

  __host__ __device__ GroupedSmem(int width, int K, bool global_bufs,
                                  bool query_chunks) {
    constexpr int VEC = Pol::VEC, TR = Pol::TR;
    dv = (width + VEC - 1) / VEC * VEC;
    const int chunk = dv < Pol::DCH ? dv : Pol::DCH;
    ld = chunk + VEC;
    qld = query_chunks ? chunk : dv;
    const size_t buf = global_bufs ? 0 : (size_t)QT * buffer_size(K);
    xs = 0;
    mf = xs + (size_t)STAGES * TR * ld * sizeof(typename Pol::Unit);
    mv = mf + (size_t)STAGES * Pol::NMETA * TR * sizeof(float);
    qs = mv + (size_t)STAGES * TR;
    dt = qs + (size_t)(query_chunks ? STAGES : 1) * QT * qld
                  * sizeof(typename Pol::QUnit);
    meta = dt + (size_t)2 * QT * TR * sizeof(typename Pol::Dot);
    qmeta = meta + (size_t)2 * TR * sizeof(float2);
    bufd = qmeta + (size_t)QT * sizeof(float2);
    bufi = bufd + buf * sizeof(float);
    qb = bufi + buf * sizeof(int);
    ok = qb + (size_t)QT * sizeof(int);
    total = (ok + 2 * TR + 15) / 16 * 16;
  }
};

// One thread's products of its staged row (kv units of a column chunk)
// with N of the tile's queries (qp, qp + qstride, ..), and with X the
// row's own sum.  N and X are compile-time, so the loop is straight-line
// code with no per-query predicates.
template <class Pol, int N, bool X>
__device__ __forceinline__ void dot_chunk(const Pol& pol,
                                          const typename Pol::Unit* xr,
                                          const typename Pol::QUnit* qp,
                                          int qstride, int kv,
                                          typename Pol::Acc* acc,
                                          float2& racc) {
#pragma unroll 4
  for (int k = 0; k < kv; k += Pol::VEC) {
    const uint4 xv = *reinterpret_cast<const uint4*>(xr + k);
    if constexpr (X) pol.row_fold(racc, xv);
#pragma unroll
    for (int i = 0; i < N; ++i)
      Pol::fold(acc[i], Pol::load_qv(qp + i * qstride + k), xv);
  }
}

// dot_chunk for a run-time n in [N, NMAX] (one branch per count).
template <class Pol, int NMAX, int N = 1>
__device__ __forceinline__ void dot_n(int n, bool x, const Pol& pol,
                                     const typename Pol::Unit* xr,
                                     const typename Pol::QUnit* qp,
                                     int qstride, int kv,
                                     typename Pol::Acc* acc, float2& racc) {
  if constexpr (N <= NMAX) {
    if (n == N) {
      if (x) dot_chunk<Pol, N, true>(pol, xr, qp, qstride, kv, acc, racc);
      else dot_chunk<Pol, N, false>(pol, xr, qp, qstride, kv, acc, racc);
      return;
    }
    dot_n<Pol, NMAX, N + 1>(n, x, pol, xr, qp, qstride, kv, acc, racc);
  }
}

// The driver.  Pol supplies (see FloatTiles, Q8Tiles):
//   Unit, QUnit, QV       the staged row unit, the query unit in shared
//                         memory, one query vector;
//   Acc, Dot, total(acc)  a product's accumulator (two independent sums,
//                         so consecutive folds do not wait on each
//                         other), and the product it adds up to;
//   VEC, TR, DCH          units per 16 bytes, rows per stage (a multiple
//                         of 32 dividing 256), units per staged column
//                         chunk;
//   NMETA, meta_src(j)    per-row f32 arrays staged beside the rows;
//   width, valid          units per row; the (P, S) validity bytes;
//   aligned16(), row(p, s)           the rows' base and row s of p;
//   query(b), query_meta(b, u)       query b's width units (Unit, as
//                         stored) and its (query, slot) scalars;
//   widen(x), widen16(dst, xv)       one query unit, or one 16-byte
//                         vector of them, as QUnits;
//   row_fold(acc, xv)     fold one 16-byte vector of a row into the row's
//                         own sum (||x||^2 for float rows);
//   row_meta(acc, mf, r, v, rm, ok)  the row's scalars from its sum and
//                         its staged arrays, and whether it counts;
//   load_qv(ptr), fold(acc, qv, xv)  one 16-byte step of a product;
//   finish(dot, qm, rm)              the distance.
template <class Pol>
__global__ void __launch_bounds__(THREADS) grouped_scan_kernel(
    GroupedArgs a, Pol pol) {
  using Unit = typename Pol::Unit;
  using QUnit = typename Pol::QUnit;
  using Acc = typename Pol::Acc;
  using Dot = typename Pol::Dot;
  constexpr int TR = Pol::TR, VEC = Pol::VEC, DCH = Pol::DCH;
  constexpr int NMETA = Pol::NMETA;
  constexpr int QB = THREADS / TR;     // query blocks
  constexpr int MQT = QT / QB;         // queries a thread accumulates
  static_assert(THREADS % TR == 0 && TR % 32 == 0 && QT % QB == 0,
                "a stage's rows must tile the block by whole warps");
  extern __shared__ __align__(16) unsigned char gsmem[];
  __shared__ int s_tile;
  const bool qchunks = a.query_chunks;
  const GroupedSmem<Pol> L(pol.width, a.K, a.gbuf_d != nullptr, qchunks);
  Unit* xs = reinterpret_cast<Unit*>(gsmem + L.xs);
  QUnit* qs = reinterpret_cast<QUnit*>(gsmem + L.qs);
  float* mf = reinterpret_cast<float*>(gsmem + L.mf);
  uint8_t* mv = gsmem + L.mv;
  Dot* dt = reinterpret_cast<Dot*>(gsmem + L.dt);
  float2* meta = reinterpret_cast<float2*>(gsmem + L.meta);
  float2* qmeta = reinterpret_cast<float2*>(gsmem + L.qmeta);
  int* qb_s = reinterpret_cast<int*>(gsmem + L.qb);
  uint8_t* okr = gsmem + L.ok;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r = tid % TR, qb = tid / TR;   // this thread's row, queries
  const int width = pol.width, dv = L.dv, ld = L.ld, qld = L.qld;
  const int nd = (dv + DCH - 1) / DCH;   // column chunks per row
  const int buf = buffer_size(a.K);
  float* bd;
  int* bi;
  if (a.gbuf_d == nullptr) {
    bd = reinterpret_cast<float*>(gsmem + L.bufd);
    bi = reinterpret_cast<int*>(gsmem + L.bufi);
  } else {
    bd = a.gbuf_d + (size_t)blockIdx.x * QT * buf;
    bi = a.gbuf_i + (size_t)blockIdx.x * QT * buf;
  }
  WarpTopK top[MQ];       // of queries WARPS - 1 - warp, + WARPS, ..
#pragma unroll
  for (int i = 0; i < MQ; ++i) {
    const int slot = warp + WARPS * i;
    top[i] = WarpTopK{bd + (size_t)slot * buf,
                            bi + (size_t)slot * buf, a.K, buf, 0, INFINITY};
  }
  // a whole query's padding past width is never written again and reads
  // as 0 (query chunks are padded as they are staged)
  if (!qchunks)
    for (int t = tid; t < QT * dv; t += THREADS) qs[t] = QUnit(0);
  const bool vec = width % VEC == 0 && pol.aligned16();
  const bool qvec = width % VEC == 0 &&
      (reinterpret_cast<uintptr_t>(pol.query(0)) & 15) == 0;
  const bool vword = a.S % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(pol.valid) & 3) == 0;
  const int t_begin = a.chunk_off[a.chunk];
  const int t_end = a.chunk_off[a.chunk + 1];

  for (;;) {
    __syncthreads();                 // the previous tile is consumed
    if (tid == 0) s_tile = t_begin + atomicAdd(a.counter, 1);
    __syncthreads();
    const int t = s_tile;
    if (t >= t_end) break;
    const int u = a.work_u[t];
    const int q0 = (t - a.tile_off[u]) * QT;
    const int nq = min(QT, a.qcount[u] - q0);
    const int p = a.sel[u];
    const int nrows = a.nrows[p];
    for (int i = warp; i < nq; i += WARPS) {
      const int b = a.qlist[(size_t)u * a.B + q0 + i];
      if (!qchunks) {
        const Unit* qr = pol.query(b);
        for (int j = lane; j < width; j += 32)
          qs[(size_t)i * dv + j] = Pol::widen(qr[j]);
      }
      if (lane == 0) {
        qmeta[i] = pol.query_meta(b, u);
        qb_s[i] = b;
      }
    }
    // queries qb, qb + QB, .. of this thread that the tile has (uniform
    // across a warp: a warp's threads share qb)
    const int nmine = nq > qb ? (nq - qb + QB - 1) / QB : 0;
    // warp w keeps the top-K of queries owned, owned + WARPS, .. with
    // owned = WARPS - 1 - w: the first query blocks' warps, which also
    // sum ||x||^2 and have the most queries, keep none until nq > 4
    const int owned = WARPS - 1 - warp;
    const bool busy = owned < nq;
    if (busy) {
#pragma unroll
      for (int i = 0; i < MQ; ++i) top[i].init();
    }
    __syncthreads();                 // queries in place

    const Unit* src = pol.row(p, 0);
    const size_t prow = (size_t)p * a.S;
    // stage s: rows [r0, r0 + TR) x units [k0, k0 + DCH) into ring slot
    // s % STAGES, with the rows' validity bytes and the policy's per-row
    // arrays on the last column chunk of a row tile, so no global read
    // stands between a stage and its distances.  Rows past nrows and
    // units past width read as 0.  With query chunks, the tile's queries'
    // units [k0, k0 + DCH) go to the slot too, after the rows' copies
    // are issued (plain loads: bf16 queries are widened to f32).
    auto stage = [&](int s) {
      const int slot = s % STAGES;
      const int r0 = s / nd * TR, k0 = s % nd * DCH;
      const int kw = min(width - k0, DCH);
      const int kv = (kw + VEC - 1) / VEC * VEC;
      Unit* dst = xs + (size_t)slot * TR * ld;
      const int nr = min(TR, nrows - r0);
      if (s % nd == nd - 1) {
        uint8_t* v = mv + slot * TR;
        const uint8_t* vs = pol.valid + prow + r0;
        if (vword) {
          for (int c = tid; c < TR / 4; c += THREADS)
            cp_async<4>(smem_addr(v + 4 * c), vs + (4 * c < nr ? 4 * c : 0),
                        4 * c < nr);
        } else {
          for (int rr = tid; rr < TR; rr += THREADS)
            v[rr] = rr < nr ? vs[rr] : 0;
        }
        for (int c = tid; c < NMETA * TR; c += THREADS) {
          const int j = c / TR, rr = c - j * TR;
          cp_async<4>(smem_addr(mf + (slot * NMETA + j) * TR + rr),
                      pol.meta_src(j) + prow + r0 + (rr < nr ? rr : 0),
                      rr < nr);
        }
      }
      if (vec) {
        auto copy = [&](int rr, int v) {
          const bool in = rr < nr;
          cp_async<16>(smem_addr(dst + rr * ld + v * VEC),
                       src + (size_t)(in ? r0 + rr : 0) * width + k0
                           + v * VEC, in);
        };
        const int cpr = kv / VEC;      // 16-byte copies a row
        if (THREADS % cpr == 0) {      // a thread keeps one column
          for (int rr = tid / cpr; rr < TR; rr += THREADS / cpr)
            copy(rr, tid % cpr);
        } else {
          for (int c = tid; c < TR * cpr; c += THREADS)
            copy(c / cpr, c % cpr);
        }
      } else {
        for (int c = tid; c < TR * kv; c += THREADS) {
          const int rr = c / kv, j = c - rr * kv;
          dst[rr * ld + j] = rr < nr && j < kw
              ? src[(size_t)(r0 + rr) * width + k0 + j] : Unit(0);
        }
      }
      if (!qchunks) return;
      QUnit* qd = qs + (size_t)slot * QT * qld;
      if (qvec) {                      // kv == kw: 16-byte vectors
        const int vpr = kv / VEC;
        constexpr int NV = (QT * DCH / VEC + THREADS - 1) / THREADS;
        uint4 w[NV];                   // all loads first, then the stores
#pragma unroll
        for (int m = 0; m < NV; ++m) {
          const int c = tid + m * THREADS, i = c / vpr;
          if (i < nq)
            w[m] = *reinterpret_cast<const uint4*>(
                pol.query(qb_s[i]) + k0 + (c - i * vpr) * VEC);
        }
#pragma unroll
        for (int m = 0; m < NV; ++m) {
          const int c = tid + m * THREADS, i = c / vpr;
          if (i < nq) Pol::widen16(qd + i * qld + (c - i * vpr) * VEC, w[m]);
        }
      } else {
        for (int c = tid; c < nq * kv; c += THREADS) {
          const int i = c / kv, j = c - i * kv;
          qd[i * qld + j] = j < kw ? Pol::widen(pol.query(qb_s[i])[k0 + j])
                                   : QUnit(0);
        }
      }
    };

    const int nstages = (nrows + TR - 1) / TR * nd;
    for (int s = 0; s < STAGES - 1; ++s) {   // one group per stage, even
      if (s < nstages) stage(s);             // an empty one, so the wait
      cp_async_commit();                     // below counts stages
    }
    Acc acc[MQT];
    float2 racc;                     // qb == 0: this row's own sum
    // the owner warps offer row tile t's distances while the block
    // computes row tile t + 1: products and row terms are double-buffered
    // by row tile, so one barrier a stage orders both
    auto offer = [&](int rt) {
      const int h = rt & 1;
#pragma unroll
      for (int i = 0; i < MQ; ++i) {
        const int qi = owned + WARPS * i;
        if (qi < nq) {               // uniform across the warp
#pragma unroll
          for (int m = 0; m < TR / 32; ++m) {
            const int rr = lane + 32 * m;
            const float dist = pol.finish(dt[(h * QT + qi) * TR + rr],
                                          qmeta[qi], meta[h * TR + rr]);
            top[i].push(lane, dist, p * a.S + rt * TR + rr,
                        okr[h * TR + rr] && dist < MASK_DIST);
          }
        }
      }
    };
    int pend = -1;                   // row tile whose distances wait
    for (int s = 0; s < nstages; ++s) {
      const int rt = s / nd, r0 = rt * TR, dc = s % nd;
      const int kv = (min(width - dc * DCH, DCH) + VEC - 1) / VEC * VEC;
      cp_async_wait<STAGES - 2>();
      __syncthreads();               // stage s landed; s - 1 consumed
      if (s + STAGES - 1 < nstages) stage(s + STAGES - 1);
      cp_async_commit();
      if (dc == 0) {
        racc = make_float2(0.f, 0.f);
#pragma unroll
        for (int i = 0; i < MQT; ++i) acc[i] = Acc{};
      }
      const Unit* xr = xs + (size_t)(s % STAGES) * TR * ld + r * ld;
      const QUnit* qp = qs + (size_t)qb * qld +
          (qchunks ? (size_t)(s % STAGES) * QT * qld : (size_t)dc * DCH);
      // (qb == 0 has a query whenever the tile has one)
      dot_n<Pol, MQT>(nmine, qb == 0, pol, xr, qp, QB * qld, kv, acc,
                      racc);
      if (dc == nd - 1) {            // uniform across the block
        const int h = rt & 1;
        if (qb == 0) {
          const int slot = s % STAGES;
          float2 rm;
          bool ok;
          pol.row_meta(racc, mf + slot * NMETA * TR, r,
                       r0 + r < nrows && mv[slot * TR + r] != 0, rm, ok);
          meta[h * TR + r] = rm;
          okr[h * TR + r] = ok;
        }
#pragma unroll
        for (int i = 0; i < MQT; ++i)
          if (i < nmine)
            dt[(h * QT + qb + i * QB) * TR + r] = Pol::total(acc[i]);
      }
      if (pend >= 0 && busy) offer(pend);
      pend = dc == nd - 1 ? rt : -1;
    }
    if (pend >= 0) {
      __syncthreads();               // the last row tile's products
      if (busy) offer(pend);
    }
    cp_async_wait<0>();              // (only empty groups are left)
    if (busy) {
#pragma unroll
      for (int i = 0; i < MQ; ++i) {
        const int qi = owned + WARPS * i;
        if (qi < nq) {
          const size_t o = ((size_t)qb_s[qi] * a.Uc + (u - a.u0)) * a.K;
          top[i].write(lane, a.part_d + o, a.part_i + o);
        }
      }
    }
  }
}

// The int32 workspace of one scan, in order: qlist (U, B), qcount (U,),
// ntiles (U,), tile_off (U,), chunk_off (nchunks + 1,), work_u
// (U * ceil(B / QT),) and one tile counter per chunk.
struct GroupedWs {
  int *qlist, *qcount, *ntiles, *tile_off, *chunk_off, *work_u, *counters;

  __host__ GroupedWs(int* ws, int B, int U, int nchunks) {
    qlist = ws;
    qcount = qlist + (size_t)U * B;
    ntiles = qcount + U;
    tile_off = ntiles + U;
    chunk_off = tile_off + U;
    work_u = chunk_off + nchunks + 1;
    counters = work_u + (size_t)U * ((B + QT - 1) / QT);
  }
};

// Step 1: the grouping kernels, into ws; order is the slots' order.
__host__ inline cudaError_t launch_grouping(const uint8_t* qmask,
                                            const int* order,
                                            const GroupedWs& w, int B, int U,
                                            int Uc, cudaStream_t stream) {
  const int nchunks = (U + Uc - 1) / Uc;
  group_queries_kernel<<<U, GROUP_THREADS, 0, stream>>>(
      qmask, B, U, w.qlist, w.qcount, w.ntiles);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tile_list_kernel<<<1, TILE_LIST_THREADS, 0, stream>>>(
      w.ntiles, order, U, Uc, w.tile_off, w.chunk_off, w.work_u,
      w.counters, nchunks);
  return cudaGetLastError();
}

// How a block lays out its shared memory for rows of `width` units at K,
// within the limit: the device's opt-in shared memory a block (227 KB on
// an H100) less the kernel's static shared memory.  The first that fits
// of: the tile's queries whole and the top-K buffers in shared memory
// (GROUPED_SMEM_BUFS; the buffers take at most TOPK_SMEM_BYTES), whole
// queries and the buffers in the wrapper's global scratch
// (GROUPED_GLOBAL_BUFS), then the same two with the queries staged a
// column chunk a stage (| GROUPED_QUERY_CHUNKS).  The last does not grow
// with width or K, so every width has a layout.
enum { GROUPED_SMEM_BUFS = 0, GROUPED_GLOBAL_BUFS = 1,
       GROUPED_QUERY_CHUNKS = 4 };

template <class Pol>
__host__ cudaError_t grouped_placement(int width, int K, int& placement) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(
      &attr, reinterpret_cast<const void*>(&grouped_scan_kernel<Pol>));
  if (err != cudaSuccess) return err;
  const size_t limit = (size_t)optin - attr.sharedSizeBytes;
  const bool small = (size_t)QT * buffer_size(K) * 8 <= TOPK_SMEM_BYTES;
  if (small && GroupedSmem<Pol>(width, K, false, false).total <= limit)
    placement = GROUPED_SMEM_BUFS;
  else if (GroupedSmem<Pol>(width, K, true, false).total <= limit)
    placement = GROUPED_GLOBAL_BUFS;
  else if (small && GroupedSmem<Pol>(width, K, false, true).total <= limit)
    placement = GROUPED_SMEM_BUFS | GROUPED_QUERY_CHUNKS;
  else
    placement = GROUPED_GLOBAL_BUFS | GROUPED_QUERY_CHUNKS;
  return cudaSuccess;
}

// The whole scan: grouping, then per chunk of Uc union slots pass one and
// the merge into run (B, K).  gbuf is null with GROUPED_SMEM_BUFS; the
// layout flag query_chunks is grouped_placement's GROUPED_QUERY_CHUNKS.
template <class Pol>
cudaError_t launch_grouped(const Pol& pol, const int* sel, const int* nrows,
                           const uint8_t* qmask, const int* order, int* ws,
                           float* part_d, int* part_i, float* gbuf,
                           int scratch_blocks, bool query_chunks,
                           float* run_d, int* run_i, int B, int U, int S,
                           int K, int Uc, cudaStream_t stream) {
  if (K < 1 || K > K_MAX || (K & (K - 1)) || Uc < 1)
    return cudaErrorInvalidValue;
  const int nchunks = (U + Uc - 1) / Uc;
  const GroupedWs w(ws, B, U, nchunks);
  cudaError_t err = launch_grouping(qmask, order, w, B, U, Uc, stream);
  if (err != cudaSuccess) return err;

  const bool global = gbuf != nullptr;
  // past the card's limit (the wrapper asks grouped_placement first)
  // allow_smem fails and the launch returns its error
  const size_t smem =
      GroupedSmem<Pol>(pol.width, K, global, query_chunks).total;
  const void* fn = reinterpret_cast<const void*>(&grouped_scan_kernel<Pol>);
  err = allow_smem(fn, smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(reinterpret_cast<const void*>(&merge_lists_kernel),
                   merge_smem_bytes(K));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int buf = buffer_size(K);
  GroupedArgs a{sel, nrows, w.qlist, w.qcount, w.tile_off, w.work_u,
                w.chunk_off, 0, nullptr, part_d, part_i, gbuf,
                global ? reinterpret_cast<int*>(
                             gbuf + (size_t)scratch_blocks * QT * buf)
                       : nullptr,
                B, S, K, 0, 0, query_chunks};
  for (int c = 0; c < nchunks; ++c) {
    a.chunk = c;
    a.u0 = c * Uc;
    a.Uc = min(Uc, U - a.u0);
    a.counter = w.counters + c;
    const long most = (long)a.Uc * ((B + QT - 1) / QT);
    int grid = (int)min((long)sms * per_sm, most);
    if (global) grid = min(grid, scratch_blocks);
    grouped_scan_kernel<Pol><<<grid, THREADS, smem, stream>>>(a, pol);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    merge_lists_kernel<<<B, MERGE_THREADS, merge_smem_bytes(K), stream>>>(
        part_d, part_i, qmask + a.u0, U, a.Uc, run_d, run_i, K);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace quake
