// Tiled attention forward with an online softmax in plain f32 FMA, shared by
// the port's exact f32 attention forwards (flash_attention.cu: K1;
// vision_attention.cu: K2, K3; shared_prefix_attention.cu: S1, which chains
// two key sources through `fwd_source`). The bf16 K1, K3 and S1 run the
// tensor-core forward of attention_fwd_tc.cuh instead, the bf16 K2 its own
// tensor-core kernel in vision_attention.cu; the backward tiles are in
// attention_bwd.cuh.
//
// One block of 256 threads computes a 64-row query tile of one head of one
// batch entry (a batch entry is a sequence for K1, a window for K2, a
// (sample, t)-slice for K3). It walks 64-key tiles up to the causal limit,
// keeps the running max m, the running sum l and the output accumulator in
// f32 registers, and never writes the (rows, keys) scores to device memory.
// Ragged tile edges are masked in the kernel, so no shape has to be a
// multiple of 64 or 128.
//
// Thread layout: the 16x16 threads own a 4x4 block of the 64x64 score tile
// (rows ty + 16i, keys tx + 16j) and a 4 x D/16 block of the output
// (rows ty + 16i, columns tx + 16j). Row max and row sum are reduced over the
// 16 lanes that share a row with shuffles. Operands are staged in shared
// memory as f32: Q (scaled, and roped when ROPE) once per block, then K
// (transposed, roped when ROPE) and V in turn through one buffer, so that a
// head dim of 128 fits two blocks on an SM.
//
// The f32 instances are exact: the card-against-CPU comparisons use them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace t1 {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NTHREADS = 256;
constexpr float NEG_INF = -1e30f;  // finite, as in the JAX package: -inf would turn
                                   // fully masked pad rows into NaN

struct AttnParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;          // (batch, H, Sq) log-sum-exp, or nullptr
  const float* bias;   // additive key bias: bias[b * bias_batch + key], or nullptr
  const float* cos;    // rope tables, row-major [b * rope_batch + row][D] (ROPE only)
  const float* sin;
  long long q_batch;   // element strides between batch entries
  long long kv_batch;
  long long o_batch;
  long long bias_batch;
  long long rope_batch;  // rows
  int q_row;           // element strides between rows
  int kv_row;
  int o_row;
  int Sq;
  int Skv;
  int H;
  int G;               // q heads per kv head: q head h reads kv head h / G
  int causal;          // key j is visible to query row i iff j <= q_offset + i
  int q_offset;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int D>
constexpr int smem_floats() {
  // Q tile [BQ][D+1] + K^T [D][BK+1] (V [BK][D] reuses it) + P [BQ][BK+1]
  return BQ * (D + 1) + D * (BK + 1) + BQ * (BK + 1);
}

// x[d] rotated by half the head dim (rotate_half) and mixed with cos/sin.
template <typename T, int D>
__device__ __forceinline__ float rope_at(const T* row, int d, const float* c, const float* s) {
  constexpr int HALF = D / 2;
  const float x = to_f(row[d]);
  const float xr = to_f(row[d < HALF ? d + HALF : d - HALF]);
  return x * c[d] + (d < HALF ? -xr : xr) * s[d];
}

// Stage a 64-row query tile in shared memory as f32: scaled, and roped when ROPE.
// Rows past Sq are zeros.
template <typename T, int D, bool ROPE>
__device__ __forceinline__ void load_q_tile(float* Qs, const T* qg, int q_row, int Sq, int q0,
                                            float scale, const float* cosb, const float* sinb) {
  for (int idx = threadIdx.x; idx < BQ * D; idx += NTHREADS) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int row = q0 + r;
    float x = 0.f;
    if (row < Sq) {
      const T* src = qg + (long long)row * q_row;
      x = ROPE ? rope_at<T, D>(src, d, cosb + (long long)row * D, sinb + (long long)row * D)
               : to_f(src[d]);
      x *= scale;
    }
    Qs[r * (D + 1) + d] = x;
  }
}

// One key source of the online softmax: key tiles [0, n_tiles) of kg/vg
// (Skv rows, kv_row elements apart), with an optional additive key bias and,
// when causal, key j hidden from query row i unless j <= qpos0 + i. Updates
// the running max m, sum l and output accumulator of the thread's 4 rows.
// Sources chain: K1 runs one, S1 runs the shared prefix and then the own chunk.
template <typename T, int D, bool ROPE>
__device__ __forceinline__ void fwd_source(const float* Qs, float* KV, float* Ps, const T* kg,
                                           const T* vg, int kv_row, int Skv, const float* bias,
                                           int causal, int qpos0, int n_tiles, const float* cosb,
                                           const float* sinb, float (&m)[4], float (&l)[4],
                                           float (&acc)[4][D / 16]) {
  constexpr int DJ = D / 16;
  constexpr int QS = D + 1;   // padded row strides keep shared-memory banks apart
  constexpr int KS = BK + 1;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // Q staged / previous PV done with KV and Ps
    for (int idx = tid; idx < BK * D; idx += NTHREADS) {
      const int c = idx / D;
      const int d = idx - c * D;
      const int key = k0 + c;
      float x = 0.f;
      if (key < Skv) {
        const T* src = kg + (long long)key * kv_row;
        x = ROPE ? rope_at<T, D>(src, d, cosb + (long long)key * D, sinb + (long long)key * D)
                 : to_f(src[d]);
      }
      KV[d * KS + c] = x;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = KV[d * KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      const float kb = (key < Skv && bias) ? bias[key] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qpos = qpos0 + ty + 16 * i;
        if (key >= Skv)
          s[i][j] = -INFINITY;  // past the end: no weight at all
        else if (causal && key > qpos)
          s[i][j] = NEG_INF;
        else
          s[i][j] += kb;
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * KS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();  // K^T no longer read; P complete

    for (int idx = tid; idx < BK * D; idx += NTHREADS) {
      const int c = idx / D;
      const int d = idx - c * D;
      const int key = k0 + c;
      KV[c * D + d] = key < Skv ? to_f(vg[(long long)key * kv_row + d]) : 0.f;
    }
    __syncthreads();

    const int kmax = min(BK, Skv - k0);
    for (int c = 0; c < kmax; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * KS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = KV[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
}

// Key tiles a causal 64-row query tile starting at q0 reads: up to its last
// visible key q_offset + min(q0 + BQ, Sq) - 1.
__device__ __forceinline__ int causal_tiles(int Skv, int Sq, int q0, int q_offset) {
  const int n = (Skv + BK - 1) / BK;
  const int last = min(q0 + BQ, Sq) - 1 + q_offset;
  return min(n, last / BK + 1);
}

// Normalise and store the thread's 4 output rows (and lse = m + log l).
template <typename T, int D>
__device__ __forceinline__ void store_out(T* og, int o_row, float* lse_bh, int Sq, int q0,
                                          const float (&m)[4], const float (&l)[4],
                                          const float (&acc)[4][D / 16]) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* dst = og + (long long)row * o_row;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) store_f(dst + tx + 16 * j, acc[i][j] / l_safe);
    if (lse_bh != nullptr && tx == 0) lse_bh[row] = m[i] + logf(l_safe);
  }
}

template <int D>
__device__ __forceinline__ void init_softmax(float (&m)[4], float (&l)[4], float (&acc)[4][D / 16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  }
}

template <typename T, int D, bool ROPE>
__global__ void __launch_bounds__(NTHREADS, 2) attn_fwd(const AttnParams p) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  extern __shared__ float smem[];
  float* Qs = smem;
  float* KV = Qs + BQ * (D + 1);   // K^T during QK^T, then V during PV
  float* Ps = KV + D * (BK + 1);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_batch + (long long)h * D;
  const T* kg = static_cast<const T*>(p.k) + b * p.kv_batch + (long long)(h / p.G) * D;
  const T* vg = static_cast<const T*>(p.v) + b * p.kv_batch + (long long)(h / p.G) * D;
  const float* bias = p.bias ? p.bias + b * p.bias_batch : nullptr;
  const float* cosb = ROPE ? p.cos + b * p.rope_batch * D : nullptr;
  const float* sinb = ROPE ? p.sin + b * p.rope_batch * D : nullptr;

  load_q_tile<T, D, ROPE>(Qs, qg, p.q_row, p.Sq, q0, p.scale, cosb, sinb);
  float m[4], l[4], acc[4][D / 16];
  init_softmax<D>(m, l, acc);
  const int n_tiles = p.causal ? causal_tiles(p.Skv, p.Sq, q0, p.q_offset) : (p.Skv + BK - 1) / BK;
  fwd_source<T, D, ROPE>(Qs, KV, Ps, kg, vg, p.kv_row, p.Skv, bias, p.causal, q0 + p.q_offset,
                         n_tiles, cosb, sinb, m, l, acc);
  store_out<T, D>(static_cast<T*>(p.o) + b * p.o_batch + (long long)h * D, p.o_row,
                  p.lse ? p.lse + ((long long)b * p.H + h) * p.Sq : nullptr, p.Sq, q0, m, l, acc);
}

template <typename T, int D, bool ROPE>
cudaError_t launch(const AttnParams& p, int batch, cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  // above 48 KB of dynamic shared memory a kernel must opt in
  cudaError_t err = cudaFuncSetAttribute(attn_fwd<T, D, ROPE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, batch);
  attn_fwd<T, D, ROPE><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// T = float or __nv_bfloat16. Returns a cudaError_t, or -1 for a head dim
// without an instance.
template <typename T, bool ROPE>
int dispatch(int D, const AttnParams& p, int batch, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64, ROPE>(p, batch, stream);
    case 80: return launch<T, 80, ROPE>(p, batch, stream);
    case 128: return launch<T, 128, ROPE>(p, batch, stream);
    default: return -1;
  }
}

}  // namespace t1
