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
// Rows past Sq are not written.
//
// What bounds it on an H100: 4 D operations per live (query, key) pair
// and head over (q + k + v + out) bytes read and written once: at a
// 4096-token prefill some 4,000 operations a byte, so operations bound it
// (989 TFLOP/s for bf16 on the tensor cores; f32 FMAs, which this kernel
// uses, peak at 67 TFLOP/s).
//
// What the design does about it: one block of 128 threads per (64-row
// query tile, head, batch row), the causal tiles with the most keys
// first.  The q tile is staged once in shared memory as f32, transposed
// (d-major), so a thread reads its 4 rows at one d as one float4; each
// tile of 32 keys is staged transposed the same way, and V row-major.
// Thread (ty, tx) owns rows 4ty..4ty+3 and keys 4tx..4tx+3 of the 64 x 32
// score tile, so a step of d is 2 shared loads for 16 FMAs; it owns the
// same rows of the output, and the running (m, l, acc) stay in its
// registers.  Row maxima and sums reduce over the 8 threads of a row with
// shuffles; p goes through shared memory to the PV product.  A query tile
// stops at its last live key tile.  Simple first: f32 FMAs on the CUDA
// cores, no tensor cores, no copy pipelining.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <cmath>

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr int BQ = 64;        // query rows per block (flash_attention.py Q_BLOCK)
constexpr int BK = 32;        // keys per staged tile (K_BLOCK)
constexpr int THREADS = 128;  // 16 row groups x 8 key groups
constexpr int QLD = BQ + 4;   // padded leading dimensions: 16-byte rows
constexpr int KLD = BK + 4;
constexpr int PLD = BQ + 4;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float from_f32(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f32(float x) {
    return __float2bfloat16_rn(x);
  }
  // p rounded to v's type before the PV product (p.astype(v.dtype))
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

struct Shape {
  int B, Sq, Sk, H, KH, nq, causal;
  float scale;
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;   // element strides
};

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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, Shape sh) {
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
  const int bh = sh.B * sh.H;
  const int qt = sh.nq - 1 - static_cast<int>(blockIdx.x / bh);
  const int rem = static_cast<int>(blockIdx.x % bh);
  const int h = rem % sh.H, b = rem / sh.H;
  const int kvh = h / (sh.H / sh.KH);
  const int q0 = qt * BQ;
  const int q_end = min(q0 + BQ, sh.Sq);
  const int k_end = sh.causal ? min(sh.Sk, q_end) : sh.Sk;

  const T* qg = q + b * sh.qb + h * sh.qh;
  const T* kg = k + b * sh.kb + kvh * sh.kh;
  const T* vg = v + b * sh.vb + kvh * sh.vh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int row = q0 + r;
    qs[d * QLD + r] = row < sh.Sq ? Elem<T>::load(qg[row * sh.qs + d]) : 0.f;
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
      ks[d * KLD + r] = in ? Elem<T>::load(kg[key * sh.ks + d]) : 0.f;
      vs[r * D + d] = in ? Elem<T>::load(vg[key * sh.vs + d]) : 0.f;
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
        ps[(tx * 4 + j) * PLD + ty * 4 + i] = Elem<T>::round(p);
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
    T* orow = o + (((size_t)b * sh.Sq + row) * sh.H + h) * D + tx * VEC;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        orow[c * 8 * VEC + e] = Elem<T>::from_f32(acc[i][c * VEC + e] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const Shape& sh, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)D * QLD + (size_t)D * KLD
                                       + (size_t)BK * D + (size_t)BK * PLD);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = (unsigned)((long long)sh.nq * sh.B * sh.H);
  flash_fwd_kernel<T, D><<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o,
             const Shape& sh, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, sh, stream);
    case 32: return launch<T, 32>(q, k, v, o, sh, stream);
    case 64: return launch<T, 64>(q, k, v, o, sh, stream);
    case 128: return launch<T, 128>(q, k, v, o, sh, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, Sq, H, D), k and v (B, Sk, KH, D) with unit stride in D and the
// given element strides of their first three dimensions; o (B, Sq, H, D)
// contiguous, in q's type.  All f32 (is_bf16 = 0) or all bf16.
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
  sh.nq = (Sq + BQ - 1) / BQ;
  sh.causal = causal;
  sh.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  sh.qb = q_sb; sh.qs = q_ss; sh.qh = q_sh;
  sh.kb = k_sb; sh.ks = k_ss; sh.kh = k_sh;
  sh.vb = v_sb; sh.vs = v_ss; sh.vh = v_sh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_d<__nv_bfloat16>(D, q, k, v, o, sh, st);
  return launch_d<float>(D, q, k, v, o, sh, st);
}
