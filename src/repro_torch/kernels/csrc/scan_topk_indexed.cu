// Indexed partition scan with exact top-K: the batched executor's hot loop.
//
// Replaces the TPU kernel scan_topk_indexed_pallas
// (src/repro/kernels/scan_topk_indexed.py, _scan_indexed_kernel): for B
// queries over a union of U selected partitions of a (P, S, d) snapshot,
// the ascending top-K of ||x||^2 + bias - 2 q.x (L2) or bias - q.x (IP),
// where query b sees union slot u only if qmask[b, u].  Returns flat
// indices partition * S + slot.  The executor's snapshot is pages of
// 1,024 slots, so a union slot is a page, and each (query, page) pair it
// selects is one sorted K-list that merge_lists_kernel folds.
//
// What bounds it on an H100 depends on the width.
// - d = 128 (the SIFT cells): neither bytes nor products.  A nprobe=32
//   batch reads ~0.6 GB of live rows (0.18 ms at 3.35 TB/s) and does
//   ~30 GFLOP (0.45 ms at the 67 TFLOP/s of f32 outside the tensor
//   cores); its ~132,000 (query, page) K-lists, each selecting 128 of up
//   to 1,024 rows with sorts in shared memory, take the time (10-13 ms).
// - d = 3,072 (the wide cell): the products.  A batch's 1,024 queries
//   meet ~571 million live (query, row) pairs, 3.5 TFLOP, 52 ms at the
//   f32 FMA rate; its ~12 GB of rows, read once, take 3.7 ms, and its
//   ~573,000 K-lists ~25 ms of selection beside the products.
//
// What the two designs do about it (run_grouped and the row-per-thread
// design are in scan_grouped.cuh).  Both group the queries on the device
// by the pages they probe and scan a page for a tile of its queries.  The
// row-per-thread design (tiles of 16) gives each thread one staged row
// and 4 of the tile's queries: per 16-byte read of a row 4 FMAs a query,
// so at d = 3,072 it runs near 9.6 TFLOP/s.  The register-tiled design
// (tiles of 64 queries x 128 rows, below) is an f32 outer product: each
// thread keeps an 8-row x 4-query block of accumulators, 12 16-byte
// shared reads feed 128 FMAs, and a page's rows are read from L2 once per
// 64 of its queries, not 16.
//
// Which design scans a call is decided in one place, the wrapper's
// design() (scan_topk_indexed.py); this library lays out the design it
// is told.  The tiled design takes f32 rows of TILED_MIN_D = 256 and
// wider, a multiple of 4 with 16-byte aligned bases (its copies are 16
// bytes), in calls of TILED_MIN_B = 32 queries or more.  Timed on the card at
// the benchmark cells' plans (scripts/scan_crossover.py, PERF.md section
// 6), it is 1.4-2.5x faster on batch plans whose pages are probed by
// ~100-600 queries (2.47x at 3,072: 366 -> 148 ms a batch).  Where few
// queries probe a page both designs mostly read rows, and the tiled one
// gains nothing or loses: at 128 on the APS plan (0.97x, so the SIFT
// cells keep the row-per-thread design), at 256-1,536 on the APS plan
// (0.95-0.99x in all but one reading), and in calls of 1-24 queries whose pages few of them
// share (0.87-1.02x; up to 14% slower at B = 1).  The queries a page
// decide, and the host sees only B: from 32 queries on, the benchmark
// plans' slices read 0.92-1.10x (few queries a page) to 1.24-2.08x (many).
// bf16 rows keep the row-per-thread design: a bf16 variant of the tiled
// design (widened to f32 at staging) was 2x slower on the APS plan at
// 3,072.  Products and sums stay f32 FMAs: TF32 would break the f32
// agreement the exact checks rely on.
//
// What still separates the tiled design from the bound at 3,072 (148 ms a
// batch against 52, an H100 80GB at 700 W): its product loop runs at
// about half the FMA rate with the operands already in shared memory
// (104 ms with the row copies left out); the row copies add ~20 ms (L2
// serves ~3.8 TB/s to the SMs); and the top-K selection ~25 ms, barriers
// around it included.  Neither fewer shared reads a FMA (8 x 8 blocks
// over 256-row tiles), more warps (512 threads), a deeper ring (6 stages)
// nor software-pipelined fragments moved the product loop.
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

// The register-tiled design for wide rows (notes at the top).  A block
// takes a work item of up to QW of a slot's queries and walks the slot's
// rows RT at a time; each row tile is an f32 outer product over d in KC
// chunks through a STAGES-deep ring, then an epilogue that offers its
// rows to the queries' WarpTopK.
namespace tiled {

constexpr int NT = THREADS;       // threads a block
constexpr int NW = WARPS;         // its warps
constexpr int QW = 64;            // queries a tile
constexpr int RT = 128;           // rows a row tile
constexpr int KC = 32;            // units of d a stage
constexpr int CH = KC / 4;        // 16-byte columns of a staged row
constexpr int STAGES = 3;         // depth of the ring
constexpr int TN = 4;             // queries of a thread's register block
constexpr int WQ = 4 * TN;        // queries of a warp's blocks
constexpr int WM = NW / (QW / WQ);  // warps along the rows
constexpr int RS = 8 * WM;        // row stride of a thread's block
constexpr int TM = RT / RS;       // its rows
constexpr int HALF = QW / 2;      // queries an epilogue pass offers
constexpr int DT_LD = RT + 8;     // row stride of the q.x tile
constexpr int MO = QW / NW;       // queries whose top-K a warp keeps
constexpr int XCP = RT * CH / NT;   // a thread's copies of a stage's rows,
constexpr int QCP = QW * CH / NT;   // and of its queries
constexpr int TPR = NT / RT;      // threads that sum a row's norm
// most bytes of top-K buffers a block keeps in shared memory (K <= 128)
constexpr size_t TOPK_SMEM_BYTES = 128 << 10;
static_assert(NW % (QW / WQ) == 0 && RT % RS == 0 && MO % 2 == 0 &&
              HALF % WQ == 0 && CH == 8 &&
              XCP * NT == RT * CH && QCP * NT == QW * CH &&
              TPR * RT == NT && CH % TPR == 0,
              "the block tiles its work whole");

// Shared-memory layout of one tiled block, in bytes: the ring of row
// chunks [RT][KC] and query chunks [QW][KC] in f32, half the tile's q.x
// products [HALF][DT_LD], the row terms, the tile's query ids, the top-K
// buffers (unless global) and the rows' flags.
struct Smem {
  size_t xs, qs, dt, nrm, qb, bufd, bufi, ok, total;

  __host__ __device__ Smem(int K, bool global_bufs) {
    const size_t buf = global_bufs ? 0 : (size_t)QW * buffer_size(K);
    xs = 0;
    qs = xs + (size_t)STAGES * RT * KC * sizeof(float);
    dt = qs + (size_t)STAGES * QW * KC * sizeof(float);
    nrm = dt + (size_t)HALF * DT_LD * sizeof(float);
    qb = nrm + RT * sizeof(float);
    bufd = qb + QW * sizeof(int);
    bufi = bufd + buf * sizeof(float);
    ok = bufi + buf * sizeof(int);
    total = (ok + RT + 15) / 16 * 16;
  }
};

// The f32 rows and queries of a scan.
struct Rows {
  const float* q;          // (B, d)
  const float* data;       // (P, S, d)
  const uint8_t* valid;    // (P, S)
  int d;
  float coef;              // -2 (L2) or -1 (IP)
  int l2;
};

// Offset of (row r, 16-byte column c) in a staged [R][KC] chunk, the
// column XOR-swizzled by r % 8: the 8 consecutive rows (or queries) a
// warp reads at one column, and the 8 threads that stage one row, meet 8
// distinct groups of 4 banks.
__device__ __forceinline__ int swz(int r, int c) {
  return r * KC + 4 * (c ^ (r & 7));
}

// One staged chunk's products of a thread's rows g + RS j (j < TM) with
// its queries qw + 4 i (i < NI): per 16-byte column TM + NI float4 reads
// (one wavefront each: 8 distinct rows, 4 distinct queries a warp) for
// 4 TM NI FMAs.
template <int NI>
__device__ __forceinline__ void products(const float* __restrict__ xa,
                                         const float* __restrict__ qa,
                                         int g, int qw,
                                         float (&acc)[TM][TN]) {
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    float4 xv[TM], qv[NI];
#pragma unroll
    for (int j = 0; j < TM; ++j)
      xv[j] = *reinterpret_cast<const float4*>(xa + swz(g + RS * j, c));
#pragma unroll
    for (int i = 0; i < NI; ++i)
      qv[i] = *reinterpret_cast<const float4*>(qa + swz(qw + 4 * i, c));
#pragma unroll
    for (int j = 0; j < TM; ++j)
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        float s = acc[j][i];
        s = fmaf(qv[i].x, xv[j].x, s);
        s = fmaf(qv[i].y, xv[j].y, s);
        s = fmaf(qv[i].z, xv[j].z, s);
        s = fmaf(qv[i].w, xv[j].w, s);
        acc[j][i] = s;
      }
  }
}

// The tiled design's pass one (the persistent tile walk of
// grouped_scan_kernel, with tiles of QW queries).  Warp w computes rows
// [64 (w % 2), + 64) of a row tile for queries [16 (w / 2), + 16); lane
// l's register block is rows g + 16 j (g = 8 (w % 2) + l % 8) by queries
// qw + 4 i (qw = 16 (w / 2) + l / 8).  A warp whose 16 queries are all
// absent skips the products, and one with n present runs ceil(n / 4) of
// its 4 query columns.  Rows and queries come by 16-byte cp.async, so d
// is a multiple of 4 and both bases are 16-byte aligned (the wrapper
// sends other f32 rows to the row-per-thread design).  GBUF: the top-K
// buffers in the wrapper's global scratch, else in shared memory; known
// at compile time, so the top-K's loads and stores are shared-memory
// instructions there.
template <bool GBUF>
__global__ void __launch_bounds__(NT, 1) grouped_scan_kernel_tiled(
    GroupedArgs a, Rows x) {
  extern __shared__ __align__(16) unsigned char gsmem[];
  __shared__ int s_tile;
  const Smem L(a.K, GBUF);
  float* xs = reinterpret_cast<float*>(gsmem + L.xs);
  float* qs = reinterpret_cast<float*>(gsmem + L.qs);
  float* dt = reinterpret_cast<float*>(gsmem + L.dt);
  float* nrm_s = reinterpret_cast<float*>(gsmem + L.nrm);
  int* qb_s = reinterpret_cast<int*>(gsmem + L.qb);
  uint8_t* ok_s = gsmem + L.ok;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wn = warp / WM;
  const int g = warp % WM * 8 + (lane & 7);
  const int qw = wn * WQ + (lane >> 3);
  const int d = x.d, nd = (d + KC - 1) / KC;
  const int buf = buffer_size(a.K);
  float* bd;
  int* bi;
  if constexpr (GBUF) {
    bd = a.gbuf_d + (size_t)blockIdx.x * QW * buf;
    bi = a.gbuf_i + (size_t)blockIdx.x * QW * buf;
  } else {
    bd = reinterpret_cast<float*>(gsmem + L.bufd);
    bi = reinterpret_cast<int*>(gsmem + L.bufi);
  }
  const int t_begin = a.chunk_off[a.chunk];
  const int t_end = a.chunk_off[a.chunk + 1];

  for (;;) {
    __syncthreads();                 // the previous tile is consumed
    if (tid == 0) s_tile = t_begin + atomicAdd(a.counter, 1);
    __syncthreads();
    const int t = s_tile;
    if (t >= t_end) break;
    const int u = a.work_u[t];
    const int q0 = (t - a.tile_off[u]) * QW;
    const int nq = min(QW, a.qcount[u] - q0);
    const int p = a.sel[u];
    const int nrows = a.nrows[p];
    if (tid < nq) qb_s[tid] = a.qlist[(size_t)u * a.B + q0 + tid];
    const int nw = nq - wn * WQ;     // uniform across the warp
    const int ni = nw <= 0 ? 0 : min(TN, (nw + 3) / 4);
    int count[MO];                   // queries warp + NW m: WarpTopK
    float thr[MO];                   // state between row tiles
#pragma unroll
    for (int m = 0; m < MO; ++m) {
      count[m] = 0;
      thr[m] = INFINITY;
    }
    __syncthreads();                 // query ids in place

    const float* src = x.data + (size_t)p * a.S * d;
    const size_t prow = (size_t)p * a.S;
    const int nsteps = (nrows + RT - 1) / RT * nd;
    // stage s: rows [r0, r0 + RT) x units [k0, k0 + KC) and the tile's
    // queries' units [k0, k0 + KC) into ring slot s % STAGES; rows past
    // nrows, queries past nq and units past d as zeros
    auto fetch = [&](int s) {
      const int r0 = s / nd * RT, k0 = s % nd * KC, slot = s % STAGES;
#pragma unroll
      for (int m = 0; m < XCP; ++m) {
        const int e = tid + m * NT, r = e / CH, c = e % CH;
        const int k = k0 + 4 * c;
        const bool in = r0 + r < nrows && k < d;
        const float* row = src + (size_t)(in ? r0 + r : 0) * d;
        cp_async<16>(smem_addr(xs + slot * RT * KC + swz(r, c)),
                     row + (in ? k : 0), in);
      }
#pragma unroll
      for (int m = 0; m < QCP; ++m) {
        const int e = tid + m * NT, i = e / CH, c = e % CH;
        const int k = k0 + 4 * c;
        const bool in = i < nq && k < d;
        const float* qrow = x.q + (in ? (size_t)qb_s[i] * d : 0);
        cp_async<16>(smem_addr(qs + slot * QW * KC + swz(i, c)),
                     qrow + (in ? k : 0), in);
      }
    };

    for (int s = 0; s < STAGES - 1; ++s) {   // one group per stage, even
      if (s < nsteps) fetch(s);              // an empty one, so the wait
      cp_async_commit();                     // below counts stages
    }
    float acc[TM][TN];
    float nrm = 0.f;                 // ||x||^2 of row tid / TPR, its share
    for (int s = 0; s < nsteps; ++s) {
      const int rt = s / nd, dc = s % nd;
      cp_async_wait<STAGES - 2>();
      __syncthreads();               // stage s landed; s - 1 consumed
      const bool ahead = s + STAGES - 1 < nsteps;
      if (ahead) fetch(s + STAGES - 1);
      cp_async_commit();
      if (dc == 0) {
        nrm = 0.f;
#pragma unroll
        for (int j = 0; j < TM; ++j)
#pragma unroll
          for (int i = 0; i < TN; ++i) acc[j][i] = 0.f;
      }
      const float* xa = xs + (s % STAGES) * RT * KC;
      const float* qa = qs + (s % STAGES) * QW * KC;
      switch (ni) {                  // uniform across the warp
        case 4: products<4>(xa, qa, g, qw, acc); break;
        case 3: products<3>(xa, qa, g, qw, acc); break;
        case 2: products<2>(xa, qa, g, qw, acc); break;
        case 1: products<1>(xa, qa, g, qw, acc); break;
        default: break;
      }
      if (x.l2) {                    // each row's norm once, TPR threads
        const int r = tid / TPR, c0 = tid % TPR * (CH / TPR);
#pragma unroll
        for (int c = 0; c < CH / TPR; ++c) {
          const float4 v = *reinterpret_cast<const float4*>(
              xa + swz(r, c0 + c));
          nrm = fmaf(v.x, v.x, nrm);
          nrm = fmaf(v.y, v.y, nrm);
          nrm = fmaf(v.z, v.z, nrm);
          nrm = fmaf(v.w, v.w, nrm);
        }
      }
      if (dc != nd - 1) continue;    // uniform across the block
      // the row tile is summed over d: offer its rows, half the tile's
      // queries a pass, each query's 32 rows at a time in increasing
      // index
      const int r0 = rt * RT;
      if (x.l2) {
#pragma unroll
        for (int o = 1; o < TPR; o <<= 1)
          nrm += __shfl_xor_sync(0xffffffffu, nrm, o);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __syncthreads();             // the q.x tile and row terms are free
        if (wn * WQ / HALF == h) {
#pragma unroll
          for (int j = 0; j < TM; ++j)
#pragma unroll
            for (int i = 0; i < TN; ++i)
              dt[(qw - h * HALF + 4 * i) * DT_LD + g + RS * j] = acc[j][i];
        }
        if (h == 0 && tid % TPR == 0) {
          const int r = tid / TPR;
          nrm_s[r] = nrm;
          ok_s[r] = r0 + r < nrows && x.valid[prow + r0 + r] != 0;
        }
        __syncthreads();
#pragma unroll
        for (int m = h * (MO / 2); m < (h + 1) * (MO / 2); ++m) {
          const int qi = warp + NW * m;
          if (qi < nq) {             // uniform across the warp
            WarpTopK top{bd + (size_t)qi * buf, bi + (size_t)qi * buf, a.K,
                         buf, count[m], thr[m]};
#pragma unroll
            for (int pp = 0; pp < RT / 32; ++pp) {
              const int r = pp * 32 + lane;
              const float dist =
                  nrm_s[r] + x.coef * dt[(qi - h * HALF) * DT_LD + r];
              top.push(lane, dist, (int)prow + r0 + r,
                       ok_s[r] && dist < MASK_DIST);
            }
            count[m] = top.count;
            thr[m] = top.thr;
          }
        }
      }
    }
    cp_async_wait<0>();              // (only empty groups are left)
#pragma unroll
    for (int m = 0; m < MO; ++m) {
      const int qi = warp + NW * m;
      if (qi < nq) {
        WarpTopK top{bd + (size_t)qi * buf, bi + (size_t)qi * buf, a.K, buf,
                     count[m], thr[m]};
        const size_t o = ((size_t)qb_s[qi] * a.Uc + (u - a.u0)) * a.K;
        top.write(lane, a.part_d + o, a.part_i + o);
      }
    }
  }
}

// The tiled design's whole scan (run_grouped with tiles of QW queries);
// gbuf as there.  Rows whose width or bases rule out 16-byte copies are
// refused (the wrapper never sends them).
template <bool GBUF>
cudaError_t launch_tiled_as(const Rows& x, const int* sel,
                            const int* nrows, const uint8_t* qmask,
                            const int* order, int* ws, float* part_d,
                            int* part_i, float* gbuf, int scratch_blocks,
                            float* run_d, int* run_i, int B, int U, int S,
                            int K, int Uc, cudaStream_t stream) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x.q)
      | reinterpret_cast<uintptr_t>(x.data);
  if (x.d % 4 != 0 || bases % 16 != 0) return cudaErrorInvalidValue;
  const size_t smem = Smem(K, GBUF).total;
  return run_grouped(
      reinterpret_cast<const void*>(&grouped_scan_kernel_tiled<GBUF>), NT,
      smem, QW,
      [&](const GroupedArgs& a, int grid) {
        grouped_scan_kernel_tiled<GBUF><<<grid, NT, smem, stream>>>(a, x);
      },
      sel, nrows, qmask, order, ws, part_d, part_i, gbuf, scratch_blocks,
      false, run_d, run_i, B, U, S, K, Uc, stream);
}

// The tiled design's layout at K: GROUPED_TILED, with the top-K buffers in
// shared memory while they take at most tiled::TOPK_SMEM_BYTES and the
// block fits the card, else in the wrapper's global scratch
// (| GROUPED_GLOBAL_BUFS).  Without them a block takes 92 KB.
__host__ inline cudaError_t tiled_placement(int K, int& placement) {
  size_t limit = 0;
  const cudaError_t err = smem_limit(
      reinterpret_cast<const void*>(&grouped_scan_kernel_tiled<false>),
      limit);
  if (err != cudaSuccess) return err;
  const bool small = (size_t)QW * buffer_size(K) * 8 <= TOPK_SMEM_BYTES;
  placement = GROUPED_TILED
      | (small && Smem(K, false).total <= limit ? GROUPED_SMEM_BUFS
                                                : GROUPED_GLOBAL_BUFS);
  return cudaSuccess;
}

}  // namespace tiled

}  // namespace quake

// q (B, d) and data (P, S, d) in the storage type (f32, or bf16 when
// is_bf16); valid (P, S) and qmask (B, U) as bytes; nrows (P,) and sel
// (U,) int32; order (U,) int32 the slots' order (a permutation within
// each chunk of Uc slots); ws the int32 workspace that GroupedWs lays out
// for the design's tile width; part (B, Uc, K) scratch; gbuf null, or (K
// past what shared memory holds) scratch_blocks * (queries a tile) *
// buffer_size(K) distances and as many indices; placement the flags of
// scan_indexed_placement (the design and its layout); run (B, K) the
// running result, initialised by the caller and updated in place.  K is
// a power of two <= K_MAX.
extern "C" int scan_indexed(void* q, void* data, void* valid, void* nrows,
                            void* sel, void* qmask, void* order, void* ws,
                            void* part_d, void* part_i, void* gbuf,
                            void* run_d, void* run_i, int B, int U, int S,
                            int d, int K, int Uc, int scratch_blocks,
                            int placement, int is_bf16, int l2,
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
  const bool chunks = (placement & quake::GROUPED_QUERY_CHUNKS) != 0;
  cudaError_t err;
  if (is_bf16) {
    using T = __nv_bfloat16;
    const quake::FloatTiles<T> pol{static_cast<const T*>(q),
                                   static_cast<const T*>(data), v, d, S,
                                   coef, l2};
    err = quake::launch_grouped(pol, se, nr, qm, od, w, pd, pi, gb,
                                scratch_blocks, chunks, rd, ri, B, U, S, K,
                                Uc, s);
  } else if (placement & quake::GROUPED_TILED) {
    const quake::tiled::Rows x{static_cast<const float*>(q),
                               static_cast<const float*>(data), v, d, coef,
                               l2};
    err = (gb ? quake::tiled::launch_tiled_as<true>
              : quake::tiled::launch_tiled_as<false>)(
        x, se, nr, qm, od, w, pd, pi, gb, scratch_blocks, rd, ri, B, U, S,
        K, Uc, s);
  } else {
    const quake::FloatTiles<float> pol{static_cast<const float*>(q),
                                       static_cast<const float*>(data), v,
                                       d, S, coef, l2};
    err = quake::launch_grouped(pol, se, nr, qm, od, w, pd, pi, gb,
                                scratch_blocks, chunks, rd, ri, B, U, S, K,
                                Uc, s);
  }
  return static_cast<int>(err);
}

// The grouping step alone (the first two kernels of scan_indexed), for
// checking it against its plain version: qmask (B, U) bytes and the
// slots' order into ws, in tiles of qt queries, laid out as GroupedWs
// describes.
extern "C" int group_queries(void* qmask, void* order, void* ws, int B,
                             int U, int Uc, int qt, void* stream) {
  const quake::GroupedWs w(static_cast<int*>(ws), B, U, (U + Uc - 1) / Uc,
                           qt);
  return static_cast<int>(quake::launch_grouping(
      static_cast<const uint8_t*>(qmask), static_cast<const int*>(order), w,
      B, U, Uc, qt, static_cast<cudaStream_t>(stream)));
}

// How the block of the design the wrapper chose lays out its shared
// memory for rows of width d at K, or the negated CUDA error.  tiled: the
// register-tiled design (f32 rows only; GROUPED_TILED, with
// tiled_placement's buffer flag); else the row-per-thread design
// (grouped_placement of scan_grouped.cuh: GROUPED_SMEM_BUFS or
// GROUPED_GLOBAL_BUFS, with GROUPED_QUERY_CHUNKS past the widths that
// hold the tile's queries whole).  The wrapper decides which design
// scans a call (scan_topk_indexed.py, design()).
extern "C" int scan_indexed_placement(int d, int K, int is_bf16,
                                      int tiled) {
  int placement = 0;
  cudaError_t err;
  if (tiled)
    err = is_bf16 ? cudaErrorInvalidValue
                  : quake::tiled::tiled_placement(K, placement);
  else
    err = is_bf16 ? quake::grouped_placement<
                        quake::FloatTiles<__nv_bfloat16>>(d, K, placement)
                  : quake::grouped_placement<quake::FloatTiles<float>>(
                        d, K, placement);
  return err == cudaSuccess ? placement : -static_cast<int>(err);
}
