// Causal (or full) GQA flash-attention forward: the LM serving prefill.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py, _flash_fwd_kernel).  q is
// (B, Sq, H, D), k and v are (B, Sk, KH, D), all read in place through
// their strides; query head h reads kv head h / (H / KH), and the
// repeated K/V is never formed.  Per query row, an online softmax over
// key tiles: s = (q . k) * 1/sqrt(D) in f32; masked entries are -1e30
// (keys at or past Sk and, under causal, kpos > qpos with both positions
// counted from 0); m_new = max(m, rowmax s), p = exp(s - m_new),
// a = exp(m - m_new), l = l a + sum p, acc = acc a + round_v(p) v, where
// round_v rounds p to v's type; out = acc / max(l, 1e-20) in q's type.
// Rows past Sq are not written.  The key tiling decides where p is
// rounded, so each kernel's tiles are its plain version's
// (flash_attention.py TILES).
//
// What bounds it on an H100: 4 D operations per live (query, key) pair
// and head over (q + k + v + out) bytes read and written once: at a
// 4096-token prefill some 4,000 operations a byte, so operations bound it
// (989 TFLOP/s for bf16 on the tensor cores; 67 TFLOP/s for f32 FMAs).
//
// bf16, the served path (flash_fwd_bf16_mma_kernel): FlashAttention-2's
// structure on the tensor cores.  bf16 x bf16 products are exact in f32,
// so mma.sync m16n8k16 with f32 accumulation computes the TPU kernel's
// f32-accumulated dots; only the order of the sums differs.  One block of
// 8 warps per (128-row query tile, head, batch row), the causal tiles
// with the most keys first; each warp owns 16 query rows, whose Q
// fragments it loads once with ldmatrix and keeps in registers.  Tiles of
// 64 keys stay bf16 in shared memory, in a ring of two stages filled by
// 16-byte cp.async, so tile j + 1 is in flight while tile j is computed;
// rows are padded by 16 bytes, so the 8 rows an ldmatrix reads fall in 8
// distinct bank groups.  S = Q K^T comes out in the m16n8 accumulator
// layout; the row max and sum run on it with quad shuffles, and p, packed
// to bf16 pairs, is already the A operand of the PV mma (V through
// ldmatrix.trans).  O stays in registers and is written once.  A warp
// skips key tiles that lie wholly past its rows (they would add exactly
// nothing) and masks only tiles that cross its diagonal or Sk.  Scores
// and maxima are kept in base 2 (1/sqrt(D) log2(e) folded into the
// scale), so each exponential is one exp2f, fewer instructions than
// expf, and the result stays within the same bounds of the plain version.
//
// f32 (flash_fwd_f32_kernel) serves only the exact checks: TF32 tensor
// cores would round the inputs to 10 mantissa bits, so it stays on the
// CUDA cores.  One block of 128 threads per (64-row query tile, head,
// batch row); q and 32-key K tiles are staged transposed (d-major) in
// shared memory, so a thread reads 4 rows at one d as one float4: thread
// (ty, tx) owns rows 4ty..4ty+3 and keys 4tx..4tx+3 of the score tile, 2
// shared loads for 16 FMAs, and the same rows of the output; p goes
// through shared memory to the PV product.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <cmath>

#include "async_copy.cuh"

namespace {

using quake::cp_async;
using quake::cp_async_commit;
using quake::cp_async_wait;
using quake::smem_addr;

constexpr float NEG_INF = -1.0e30f;

struct Shape {
  int B, Sq, Sk, H, KH, nq, causal;
  float scale;
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;   // element strides
};

// (query tile, head, batch row) of a block: the causal tiles with the
// most keys launch first
struct BlockPos {
  int qt, h, b, kvh;
};

__device__ __forceinline__ BlockPos block_pos(const Shape& sh) {
  const int bh = sh.B * sh.H;
  BlockPos p;
  p.qt = sh.nq - 1 - static_cast<int>(blockIdx.x / bh);
  const int rem = static_cast<int>(blockIdx.x % bh);
  p.h = rem % sh.H;
  p.b = rem / sh.H;
  p.kvh = p.h / (sh.H / sh.KH);
  return p;
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs (the exact checks)
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int BQ = 64;        // query rows per block (TILES[float32])
constexpr int BK = 32;        // keys per staged tile
constexpr int THREADS = 128;  // 16 row groups x 8 key groups
constexpr int QLD = BQ + 4;   // padded leading dimensions: 16-byte rows
constexpr int KLD = BK + 4;
constexpr int PLD = BQ + 4;

__device__ __forceinline__ float row_max8(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float row_sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, Shape sh) {
  // output columns of a thread: NV vectors of VEC, col = c*8*VEC + tx*VEC + e
  constexpr int VEC = D >= 32 ? 4 : 2;
  constexpr int NV = D / (8 * VEC);
  constexpr int NC = NV * VEC;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [D][QLD], transposed
  float* ks = qs + D * QLD;                       // [D][KLD], transposed
  float* vs = ks + D * KLD;                       // [BK][D]
  float* ps = vs + BK * D;                        // [BK][PLD], p transposed

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const BlockPos bp = block_pos(sh);
  const int q0 = bp.qt * BQ;
  const int q_end = min(q0 + BQ, sh.Sq);
  const int k_end = sh.causal ? min(sh.Sk, q_end) : sh.Sk;

  const float* qg = q + bp.b * sh.qb + bp.h * sh.qh;
  const float* kg = k + bp.b * sh.kb + bp.kvh * sh.kh;
  const float* vg = v + bp.b * sh.vb + bp.kvh * sh.vh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int row = q0 + r;
    qs[d * QLD + r] = row < sh.Sq ? qg[row * sh.qs + d] : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile's reads of ks, vs, ps are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const int key = k0 + r;
      const bool in = key < sh.Sk;
      ks[d * KLD + r] = in ? kg[key * sh.ks + d] : 0.f;
      vs[r * D + d] = in ? vg[key * sh.vs + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qs + d * QLD + ty * 4);
      const float4 kv = *reinterpret_cast<const float4*>(ks + d * KLD + tx * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        const bool live = kpos < sh.Sk && (!sh.causal || qpos >= kpos);
        s[i][j] = live ? s[i][j] * sh.scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max8(mx));
      const float a = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(tx * 4 + j) * PLD + ty * 4 + i] = p;
      }
      l[i] = l[i] * a + row_sum8(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= a;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 pv = *reinterpret_cast<const float4*>(ps + kk * PLD + ty * 4);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
      const float* vrow = vs + kk * D + tx * VEC;
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        float vv[VEC];
        if constexpr (VEC == 4) {
          const float4 t = *reinterpret_cast<const float4*>(vrow + c * 32);
          vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
        } else {
          const float2 t = *reinterpret_cast<const float2*>(vrow + c * 16);
          vv[0] = t.x; vv[1] = t.y;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[i][c * VEC + e] = fmaf(pa[i], vv[e], acc[i][c * VEC + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sh.Sq) continue;
    const float den = fmaxf(l[i], 1e-20f);
    float* orow = o + (((size_t)bp.b * sh.Sq + row) * sh.H + bp.h) * D
                  + tx * VEC;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        orow[c * 8 * VEC + e] = acc[i][c * VEC + e] / den;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, Shape sh,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)D * QLD + (size_t)D * KLD
                                       + (size_t)BK * D + (size_t)BK * PLD);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sh.nq = (sh.Sq + BQ - 1) / BQ;
  const unsigned blocks = (unsigned)((long long)sh.nq * sh.B * sh.H);
  flash_fwd_f32_kernel<D><<<blocks, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, f32 accumulation)
// ---------------------------------------------------------------------------

namespace bf16 {

constexpr int BQ = 128;       // query rows per block (TILES[bfloat16])
constexpr int BK = 64;        // keys per staged tile
constexpr int WARPS = BQ / 16;
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 2;     // K/V ring: tile j + 1 loads while j computes

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(D + 8) * (BQ + STAGES * 2 * BK);
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 g + t.  The f32
// accumulator of a 16 x 8 tile holds (row g, cols 2t, 2t+1) in [0], [1]
// and (row g + 8, the same cols) in [2], [3].  A's four registers hold
// bf16 pairs at (g, 2t), (g + 8, 2t), (g, 2t + 8), (g + 8, 2t + 8); B's
// two hold (k 2t, 2t+1; n g) and (k 2t + 8, 2t + 9; n g).  So the S
// accumulators of key tiles 2i and 2i + 1, packed pairwise, are the A
// operand of PV for keys 16i..16i+15.
template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_bf16_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    Shape sh) {
  constexpr int LD = D + 8;      // padded row (elements): 16 bytes more
  constexpr int CH = D / 8;      // 16-byte chunks a row
  constexpr int KD = D / 16;     // k-steps of Q K^T
  constexpr int NS = BK / 8;     // 8-key column tiles of S
  constexpr int NO = D / 8;      // 8-wide column tiles of O
  extern __shared__ float4 smem4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);  // [BQ][LD]
  __nv_bfloat16* ring = qs + BQ * LD;  // STAGES x (K [BK][LD], V [BK][LD])

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const BlockPos bp = block_pos(sh);
  const int q0 = bp.qt * BQ;
  const int q_end = min(q0 + BQ, sh.Sq);
  const int k_end = sh.causal ? min(sh.Sk, q_end) : sh.Sk;
  const int n_tiles = (k_end + BK - 1) / BK;
  // this warp's rows w0..w0+15 see keys [0, w_keys)
  const int w0 = q0 + warp * 16;
  const int w_keys = w0 >= sh.Sq ? 0
      : sh.causal ? min(sh.Sk, min(w0 + 16, sh.Sq)) : sh.Sk;

  const __nv_bfloat16* qg = q + bp.b * sh.qb + bp.h * sh.qh;
  const __nv_bfloat16* kg = k + bp.b * sh.kb + bp.kvh * sh.kh;
  const __nv_bfloat16* vg = v + bp.b * sh.vb + bp.kvh * sh.vh;

  for (int i = tid; i < BQ * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const bool in = q0 + r < sh.Sq;
    cp_async<16>(smem_addr(qs + r * LD + c * 8),
               qg + (in ? (q0 + r) * sh.qs : 0) + c * 8, in);
  }
  auto stage = [&](int tile) {
    __nv_bfloat16* ks = ring + (tile % STAGES) * 2 * BK * LD;
    __nv_bfloat16* vs = ks + BK * LD;
    for (int i = tid; i < BK * CH; i += THREADS) {
      const int r = i / CH, c = i % CH;
      const int key = tile * BK + r;
      const bool in = key < sh.Sk;
      cp_async<16>(smem_addr(ks + r * LD + c * 8),
                 kg + (in ? key * sh.ks : 0) + c * 8, in);
      cp_async<16>(smem_addr(vs + r * LD + c * 8),
                 vg + (in ? key * sh.vs : 0) + c * 8, in);
    }
  };
  if (n_tiles > 0) stage(0);
  cp_async_commit();

  uint32_t qf[KD][4];
  float oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) stage(j + 1);
    cp_async_commit();
    cp_async_wait<1>();   // every group but the newest: q and tile j
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldmatrix_x4(qf[kk], smem_addr(qs + (warp * 16 + (lane & 15)) * LD
                                      + kk * 16 + (lane >> 4) * 8));
    }
    const int k0 = j * BK;
    if (k0 < w_keys) {
      const __nv_bfloat16* ks = ring + (j % STAGES) * 2 * BK * LD;
      const __nv_bfloat16* vs = ks + BK * LD;
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      // S = Q K^T: one ldmatrix.x4 gives B of two 8-key tiles
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
#pragma unroll
        for (int n2 = 0; n2 < NS / 2; ++n2) {
          uint32_t b[4];
          ldmatrix_x4(b, smem_addr(
              ks + (n2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD
              + kk * 16 + ((lane >> 3) & 1) * 8));
          mma(s[2 * n2], qf[kk], b[0], b[1]);
          mma(s[2 * n2 + 1], qf[kk], b[2], b[3]);
        }
      const bool edge = k0 + BK > sh.Sk || (sh.causal && k0 + BK - 1 > w0);
      const float sl2 = sh.scale * 1.4426950408889634f;   // log2(e)
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * sl2;
          if (edge) {
            const int kpos = k0 + n * 8 + 2 * t + (e & 1);
            const int qpos = w0 + g + (e >> 1) * 8;
            if (kpos >= sh.Sk || (sh.causal && qpos < kpos)) x = NEG_INF;
          }
          s[n][e] = x;
        }
      // online softmax of rows g (entries 0, 1) and g + 8 (entries 2, 3),
      // in base 2: exp2(s log2 e - m log2 e) = exp(s - m)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = NEG_INF;
#pragma unroll
        for (int n = 0; n < NS; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        const float m_new = fmaxf(m[r], quad_max(mx));
        const float a = exp2f(m[r] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            s[n][e] = exp2f(s[n][e] - m_new);
            sum += s[n][e];
          }
        l[r] = l[r] * a + quad_sum(sum);
        m[r] = m_new;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          oacc[n][2 * r] *= a;
          oacc[n][2 * r + 1] *= a;
        }
      }
      // O += round_bf16(P) V: one ldmatrix.x4.trans gives B of two
      // 8-wide column tiles of V
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kt][0], s[2 * kt][1]),
            pack_bf16(s[2 * kt][2], s[2 * kt][3]),
            pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
            pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
        for (int d2 = 0; d2 < D / 16; ++d2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, smem_addr(
              vs + (kt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD
              + d2 * 16 + (lane >> 4) * 8));
          mma(oacc[2 * d2], pa, b[0], b[1]);
          mma(oacc[2 * d2 + 1], pa, b[2], b[3]);
        }
      }
    }
    __syncthreads();   // all warps are done with tile j's stage
  }
  cp_async_wait<0>();   // no copy outlives the block (Sk = 0 stages q only)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    if (row >= sh.Sq) continue;
    const float den = fmaxf(l[r], 1e-20f);
    __nv_bfloat16* orow =
        o + (((size_t)bp.b * sh.Sq + row) * sh.H + bp.h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(oacc[n][2 * r] / den,
                                oacc[n][2 * r + 1] / den);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, Shape sh,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16_mma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sh.nq = (sh.Sq + BQ - 1) / BQ;
  const unsigned blocks = (unsigned)((long long)sh.nq * sh.B * sh.H);
  flash_fwd_bf16_mma_kernel<D><<<blocks, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      sh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bf16

int launch_f32(int D, const void* q, const void* k, const void* v, void* o,
               const Shape& sh, cudaStream_t st) {
  switch (D) {
    case 16: return f32::launch<16>(q, k, v, o, sh, st);
    case 32: return f32::launch<32>(q, k, v, o, sh, st);
    case 64: return f32::launch<64>(q, k, v, o, sh, st);
    case 128: return f32::launch<128>(q, k, v, o, sh, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_bf16(int D, const void* q, const void* k, const void* v, void* o,
                const Shape& sh, cudaStream_t st) {
  switch (D) {
    case 16: return bf16::launch<16>(q, k, v, o, sh, st);
    case 32: return bf16::launch<32>(q, k, v, o, sh, st);
    case 64: return bf16::launch<64>(q, k, v, o, sh, st);
    case 128: return bf16::launch<128>(q, k, v, o, sh, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, Sq, H, D), k and v (B, Sk, KH, D) with unit stride in D and the
// given element strides of their first three dimensions; o (B, Sq, H, D)
// contiguous, in q's type.  All f32 (is_bf16 = 0) or all bf16; bf16
// operands start 16-byte aligned with strides that are multiples of 8.
extern "C" int flash_attention(void* q, void* k, void* v, void* o, int B,
                               int Sq, int Sk, int H, int KH, int D,
                               int q_sb, int q_ss, int q_sh, int k_sb,
                               int k_ss, int k_sh, int v_sb, int v_ss,
                               int v_sh, int causal, int is_bf16,
                               void* stream) {
  if (B <= 0 || Sq <= 0 || Sk < 0 || KH <= 0 || H <= 0 || H % KH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Shape sh;
  sh.B = B; sh.Sq = Sq; sh.Sk = Sk; sh.H = H; sh.KH = KH;
  sh.nq = 0;   // set by the launcher, from its query tile
  sh.causal = causal;
  sh.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  sh.qb = q_sb; sh.qs = q_ss; sh.qh = q_sh;
  sh.kb = k_sb; sh.ks = k_ss; sh.kh = k_sh;
  sh.vb = v_sb; sh.vs = v_ss; sh.vh = v_sh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_bf16(D, q, k, v, o, sh, st);
  return launch_f32(D, q, k, v, o, sh, st);
}
