// D1 and D2: the G-way rollout decode step's attention over the shared
// prompt prefix.
//
// Replaces the Pallas kernels of time_r1_tpu/ops/decode_attention.py:
// - D1 `shared_prefix_decode_attention` (pallas_call at :171): online softmax
//   of the R·G grouped query rows of each (prompt, kv head) over the prompt's
//   prefix, bf16 or int8 with per-(token, head) K/V scales, returning the
//   unnormalised (acc, m, l);
// - D2 `shared_prefix_decode_full` (pallas_call at :403): the whole step's
//   exact softmax over [shared prefix | own suffix | new token], normalised.
//
// Layout: q (P, Hkv, N, D) with N = R·G rows (row r·G + g is rollout row
// p·R + r, q head h·G + g), as in the JAX kernels. The caches are read
// through strides, so the port hands over head-major views of its
// token-major (P, Lp, Hkv, D) / (B, Lo, Hkv, D) caches and nothing is
// transposed per decode session. The own suffix has one host-int length for
// every row: only its live rows are read (the JAX kernel takes a (Lo,) bias).
//
// The TPU grid (P, Hkv, prefix blocks) walks the prefix in order on one
// core; at the rollout shape (P = 1, Hkv = 2) the same grid on the GPU would
// be 2 blocks on 132 SMs. So the prefix is split: `decode_split` gives every
// (64-key chunk, kv head, prompt) its own block, which scores the chunk
// against all N rows (a 64x64 tile, 4x4 per thread, as attention_tile.cuh)
// and writes the chunk's (acc, m, l) in f32. D1 then folds the chunks
// (`decode_combine`). D2 in f32 folds them in `decode_tail` (one block per
// (kv head, rollout row), one warp per query row), continues the online
// softmax over the row's live suffix and the in-register new token, and
// normalises: two launches, the split pass shared with D1. D2 in bf16 is the
// one-launch tensor-core kernel further down (`decode_full_tc`).
//
// The mask floor: prompts are left-padded with a -1e30 additive bias. A chunk
// whose keys are all padding has m = -1e30; its probabilities are zeroed where
// the score sits at the floor (the TPU kernel's rule, :88-92), so it ends as
// l = 0, acc = 0 and carries no weight in any fold. The new token is always
// live, so the final maximum is finite.
//
// int8: K scales multiply the scores after Q·K, V scales the probabilities
// before P·V, as in the JAX kernels; the new token is unquantized.
//
// What bounds them on the H100: at the rollout step (N = 64, Lp = 2048,
// hd = 128) each key is used by 64 rows, about 64 operations per byte of bf16
// K/V, so the bound is reading the live prefix and suffix (about 2-4 MB per
// layer-step), about 1 us. At that size launches and the split's f32
// partials (P·Hkv·Lp/64·N·D·4 = 2 MB) matter more. The split pass and the
// tail are exact f32 FMA out of shared memory (D1 in both dtypes, D2 in
// f32); the tensor-core D2 is described at its kernel.
#include <stdint.h>

#include <type_traits>

#include "attention_tile.cuh"
#include "wgmma_tile.cuh"

namespace t1 {

__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

// The launch arguments, one struct (mirrored by ops/decode_attention.py::_Params).
struct DecodeParams {
  const void* q;      // (P, Hkv, N, D) contiguous
  const void* kp;     // prefix K/V (P, Hkv, Lp, D) through the kv_s* strides
  const void* vp;
  const float* ksp;   // prefix scales (P, Hkv, Lp) through the s_s* strides (int8 only)
  const float* vsp;
  const float* bias;  // (P, Lp) contiguous additive prefix bias
  const void* ko;     // own suffix K/V (B, Hkv, Lo, D) through the own_s* strides
  const void* vo;
  const float* kso;   // suffix scales (B, Hkv, Lo) through the os_s* strides (int8 only)
  const float* vso;
  const void* kn;     // new token K/V (B, Hkv, D) through the n_s* strides
  const void* vn;
  void* o;            // D2 output (P, Hkv, N, D) contiguous, q's dtype
  float* acc_part;    // (P, Hkv, nchunk, N, D)
  float* m_part;      // (P, Hkv, nchunk, N)
  float* l_part;
  float* acc_out;     // D1 output (P, Hkv, N, D)
  float* m_out;       // (P, Hkv, N)
  float* l_out;
  int* ticket;        // tensor-core D2: (P, Hkv) arrival counts, zero between launches
  const int* own_len; // D2: the live suffix length, uniform across the rows, in device memory
  long long kv_sp, kv_sh, kv_st;
  long long s_sp, s_sh, s_st;
  long long own_sb, own_sh, own_st;
  long long os_sb, os_sh, os_st;
  long long n_sb, n_sh;
  int P, Hkv, N, Lp, R, G, nchunk;
  int ctiles;         // tensor-core D2: 64-key tiles per prefix chunk
  float scale;
};

}  // namespace t1

namespace {

using t1::DecodeParams;
using t1::NEG_INF;
using t1::store_f;
using t1::to_f;

constexpr int CH = 64;   // prefix keys per split block; suffix keys per tail tile
constexpr int RT = 64;   // query rows per tile of the split pass
constexpr int NTH = 256;
constexpr int NWARPS = NTH / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <int D>
constexpr int split_smem_floats() {
  // Q [RT][D+1] + K^T [D][CH+1] + V [CH][D] + P [RT][CH+1] + k/v scales and bias [CH]
  return RT * (D + 1) + D * (CH + 1) + CH * D + RT * (CH + 1) + 3 * CH;
}

template <int D>
constexpr int tail_smem_floats() {
  // K [CH][D+1] + V [CH][D] + q rows [NWARPS][D] + p [NWARPS][CH] + k/v scales [CH]
  return CH * (D + 1) + CH * D + NWARPS * D + NWARPS * CH + 2 * CH;
}

// One block per (64-key chunk, kv head, prompt): the chunk's (acc, m, l) for all N rows.
template <typename T, typename C, int D, bool QUANT>
__global__ void __launch_bounds__(NTH) decode_split(const DecodeParams p) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Kt = Qs + RT * (D + 1);
  float* Vs = Kt + D * (CH + 1);
  float* Ps = Vs + CH * D;
  float* ksc = Ps + RT * (CH + 1);
  float* vsc = ksc + CH;
  float* bsc = vsc + CH;
  constexpr int DJ = D / 16;
  constexpr int QS = D + 1;
  constexpr int KS = CH + 1;

  const int chunk = blockIdx.x;
  const int h = blockIdx.y;
  const int pp = blockIdx.z;
  const int t0 = chunk * CH;
  const int nk = min(CH, p.Lp - t0);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const C* kg = static_cast<const C*>(p.kp) + pp * p.kv_sp + h * p.kv_sh;
  const C* vg = static_cast<const C*>(p.vp) + pp * p.kv_sp + h * p.kv_sh;

  for (int c = tid; c < CH; c += NTH) {
    const bool live = c < nk;
    bsc[c] = live ? p.bias[(long long)pp * p.Lp + t0 + c] : 0.f;
    if (QUANT) {
      const long long so = pp * p.s_sp + h * p.s_sh + (long long)(t0 + c) * p.s_st;
      ksc[c] = live ? p.ksp[so] : 0.f;
      vsc[c] = live ? p.vsp[so] : 0.f;
    }
  }
  for (int idx = tid; idx < CH * D; idx += NTH) {
    const int c = idx / D;
    const int d = idx - c * D;
    float kx = 0.f, vx = 0.f;
    if (c < nk) {
      const long long off = (long long)(t0 + c) * p.kv_st + d;
      kx = to_f(kg[off]);
      vx = to_f(vg[off]);
    }
    Kt[d * KS + c] = kx;
    Vs[c * D + d] = vx;
  }

  const T* qg = static_cast<const T*>(p.q) + ((long long)pp * p.Hkv + h) * p.N * D;
  const long long part_row0 = (((long long)pp * p.Hkv + h) * p.nchunk + chunk) * p.N;
  for (int r0 = 0; r0 < p.N; r0 += RT) {
    __syncthreads();  // staging done; the previous row tile is done with Qs and Ps
    for (int idx = tid; idx < RT * D; idx += NTH) {
      const int r = idx / D;
      const int d = idx - r * D;
      Qs[r * QS + d] = r0 + r < p.N ? to_f(qg[(long long)(r0 + r) * D + d]) * p.scale : 0.f;
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
      for (int j = 0; j < 4; ++j) kv[j] = Kt[d * KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (c >= nk) {
          s[i][j] = -INFINITY;  // past the prefix: no weight at all
        } else {
          if (QUANT) s[i][j] *= ksc[c];
          s[i][j] += bsc[c];
        }
      }
    }

    float m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float pr = s[i][j] > NEG_INF * 0.5f ? expf(s[i][j] - mx) : 0.f;  // the mask floor
        rs += pr;
        if (QUANT && c < nk) pr *= vsc[c];
        Ps[(ty + 16 * i) * KS + c] = pr;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      m[i] = mx;
      l[i] = rs;
    }
    __syncthreads();

    float acc[4][DJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
    for (int c = 0; c < nk; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * KS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty + 16 * i;
      if (row >= p.N) continue;
      float* dst = p.acc_part + (part_row0 + row) * D;
#pragma unroll
      for (int j = 0; j < DJ; ++j) dst[tx + 16 * j] = acc[i][j];
      if (tx == 0) {
        p.m_part[part_row0 + row] = m[i];
        p.l_part[part_row0 + row] = l[i];
      }
    }
  }
}

// D1's fold of the chunks: one block per (row, kv head, prompt).
__global__ void decode_combine(const DecodeParams p, int D) {
  const int row = blockIdx.x;
  const int h = blockIdx.y;
  const int pp = blockIdx.z;
  const long long base = ((long long)pp * p.Hkv + h) * p.nchunk;
  float m = NEG_INF;
  for (int c = 0; c < p.nchunk; ++c) m = fmaxf(m, p.m_part[(base + c) * p.N + row]);
  float l = 0.f;
  for (int c = 0; c < p.nchunk; ++c) {
    const long long pr = (base + c) * p.N + row;
    l += expf(p.m_part[pr] - m) * p.l_part[pr];
  }
  const long long out_row = ((long long)pp * p.Hkv + h) * p.N + row;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
    for (int c = 0; c < p.nchunk; ++c) {
      const long long pr = (base + c) * p.N + row;
      a += expf(p.m_part[pr] - m) * p.acc_part[pr * D + d];
    }
    p.acc_out[out_row * D + d] = a;
  }
  if (threadIdx.x == 0) {
    p.m_out[out_row] = m;
    p.l_out[out_row] = l;
  }
}

// D2's tail: one block per (kv head, rollout row b = p·R + r), one warp per
// query row g: fold the prefix chunks, then the row's live suffix in 64-key
// tiles, then the new token; normalise and store.
template <typename T, typename C, int D, bool QUANT>
__global__ void __launch_bounds__(NTH) decode_tail(const DecodeParams p) {
  extern __shared__ float smem[];
  float* Ks = smem;                 // [CH][D+1]
  float* Vs = Ks + CH * (D + 1);    // [CH][D]
  float* qs = Vs + CH * D;          // [NWARPS][D]
  float* ps = qs + NWARPS * D;      // [NWARPS][CH]
  float* ksc = ps + NWARPS * CH;    // [CH]
  float* vsc = ksc + CH;
  constexpr int DJ = D / 32;
  constexpr int KS = D + 1;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int pp = b / p.R;
  const int r = b - pp * p.R;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int own_len = *p.own_len;  // device data: a captured step reads each replay's length
  const long long head = (long long)pp * p.Hkv + h;
  const T* qg = static_cast<const T*>(p.q) + head * p.N * D;
  T* og = static_cast<T*>(p.o) + head * p.N * D;
  const long long part_base = head * p.nchunk;
  const C* kog = static_cast<const C*>(p.ko) + b * p.own_sb + h * p.own_sh;
  const C* vog = static_cast<const C*>(p.vo) + b * p.own_sb + h * p.own_sh;
  const T* kng = static_cast<const T*>(p.kn) + b * p.n_sb + h * p.n_sh;
  const T* vng = static_cast<const T*>(p.vn) + b * p.n_sb + h * p.n_sh;
  float* qrow = qs + warp * D;
  float* prow = ps + warp * CH;

  for (int g0 = 0; g0 < p.G; g0 += NWARPS) {
    const int g = g0 + warp;
    const bool active = g < p.G;
    const int row = r * p.G + g;
    float m = NEG_INF, l = 0.f, acc[DJ];
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[j] = 0.f;
    if (active) {
#pragma unroll
      for (int j = 0; j < DJ; ++j) qrow[lane + 32 * j] = to_f(qg[(long long)row * D + lane + 32 * j]) * p.scale;
      float mc = NEG_INF;
      for (int c = lane; c < p.nchunk; c += 32) mc = fmaxf(mc, p.m_part[(part_base + c) * p.N + row]);
      m = warp_max(mc);
      for (int c = 0; c < p.nchunk; ++c) {
        const long long pr = (part_base + c) * p.N + row;
        const float w = expf(p.m_part[pr] - m);
        l += w * p.l_part[pr];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[j] = fmaf(w, p.acc_part[pr * D + lane + 32 * j], acc[j]);
      }
    }
    __syncwarp();

    for (int t0 = 0; t0 < own_len; t0 += CH) {
      const int nk = min(CH, own_len - t0);
      __syncthreads();  // the previous tile is consumed
      for (int idx = threadIdx.x; idx < CH * D; idx += NTH) {
        const int c = idx / D;
        const int d = idx - c * D;
        float kx = 0.f, vx = 0.f;
        if (c < nk) {
          const long long off = (long long)(t0 + c) * p.own_st + d;
          kx = to_f(kog[off]);
          vx = to_f(vog[off]);
        }
        Ks[c * KS + d] = kx;
        Vs[c * D + d] = vx;
      }
      if (QUANT) {
        for (int c = threadIdx.x; c < CH; c += NTH) {
          const long long so = b * p.os_sb + h * p.os_sh + (long long)(t0 + c) * p.os_st;
          ksc[c] = c < nk ? p.kso[so] : 0.f;
          vsc[c] = c < nk ? p.vso[so] : 0.f;
        }
      }
      __syncthreads();
      if (active) {
        float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          const float qd = qrow[d];
          s0 = fmaf(qd, Ks[lane * KS + d], s0);
          s1 = fmaf(qd, Ks[(lane + 32) * KS + d], s1);
        }
        if (QUANT) {
          s0 *= ksc[lane];
          s1 *= ksc[lane + 32];
        }
        if (lane >= nk) s0 = -INFINITY;
        if (lane + 32 >= nk) s1 = -INFINITY;
        const float m_new = fmaxf(m, warp_max(fmaxf(s0, s1)));
        const float alpha = expf(m - m_new);
        float p0 = lane < nk ? expf(s0 - m_new) : 0.f;
        float p1 = lane + 32 < nk ? expf(s1 - m_new) : 0.f;
        l = l * alpha + warp_sum(p0 + p1);
        if (QUANT) {
          p0 *= vsc[lane];
          p1 *= vsc[lane + 32];
        }
        prow[lane] = p0;
        prow[lane + 32] = p1;
        __syncwarp();
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[j] *= alpha;
        for (int c = 0; c < nk; ++c) {
          const float pc = prow[c];
#pragma unroll
          for (int j = 0; j < DJ; ++j) acc[j] = fmaf(pc, Vs[c * D + lane + 32 * j], acc[j]);
        }
        m = m_new;
        __syncwarp();
      }
    }

    if (active) {
      float sn = 0.f;
#pragma unroll
      for (int j = 0; j < DJ; ++j) sn = fmaf(qrow[lane + 32 * j], to_f(kng[lane + 32 * j]), sn);
      sn = warp_sum(sn);
      const float m_new = fmaxf(m, sn);
      const float alpha = expf(m - m_new);
      const float pn = expf(sn - m_new);
      l = l * alpha + pn;
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float a = fmaf(pn, to_f(vng[lane + 32 * j]), acc[j] * alpha);
        store_f(og + (long long)row * D + lane + 32 * j, a / l);
      }
    }
    __syncthreads();  // qs and ps are reused by the next group of rows
  }
}

template <typename T, typename C, int D, bool QUANT>
int run_split(const DecodeParams& p, cudaStream_t stream) {
  const int smem = split_smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(decode_split<T, C, D, QUANT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  decode_split<T, C, D, QUANT><<<dim3(p.nchunk, p.Hkv, p.P), NTH, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename C, int D, bool QUANT>
int run_tail(const DecodeParams& p, cudaStream_t stream) {
  const int smem = tail_smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(decode_tail<T, C, D, QUANT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  decode_tail<T, C, D, QUANT><<<dim3(p.Hkv, p.P * p.R), NTH, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The split pass. dtype 0 = float32, 1 = bfloat16 (q); quant: int8 caches,
// else the caches have q's dtype; D 64 or 128. -1: no instance.
extern "C" int t1_decode_prefix_split(int dtype, int quant, int D, const DecodeParams* p, void* stream) {
  if ((dtype != 0 && dtype != 1) || (D != 64 && D != 128)) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (quant) return D == 64 ? run_split<float, int8_t, 64, true>(*p, st) : run_split<float, int8_t, 128, true>(*p, st);
    return D == 64 ? run_split<float, float, 64, false>(*p, st) : run_split<float, float, 128, false>(*p, st);
  }
  using bf = __nv_bfloat16;
  if (quant) return D == 64 ? run_split<bf, int8_t, 64, true>(*p, st) : run_split<bf, int8_t, 128, true>(*p, st);
  return D == 64 ? run_split<bf, bf, 64, false>(*p, st) : run_split<bf, bf, 128, false>(*p, st);
}

extern "C" int t1_decode_prefix_combine(int D, const DecodeParams* p, void* stream) {
  decode_combine<<<dim3(p->N, p->Hkv, p->P), 128, 0, static_cast<cudaStream_t>(stream)>>>(*p, D);
  return cudaGetLastError();
}

// D2's tail in f32 (bf16 D2 runs t1_decode_full_tc): quant: int8 caches,
// else f32; D 64 or 128. -1: no instance.
extern "C" int t1_decode_tail(int dtype, int quant, int D, const DecodeParams* p, void* stream) {
  if (dtype != 0 || (D != 64 && D != 128)) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quant) return D == 64 ? run_tail<float, int8_t, 64, true>(*p, st) : run_tail<float, int8_t, 128, true>(*p, st);
  return D == 64 ? run_tail<float, float, 64, false>(*p, st) : run_tail<float, float, 128, false>(*p, st);
}

// ---------------------------------------------------------------------------
// D2 in bf16 on Hopper's tensor cores (`t1_decode_full_tc`): bf16 q and new
// token over bf16 or int8 caches, one launch per call.
//
// Grid (nchunk + R, Hkv, P), two warpgroups (256 threads) a block, two kinds
// of block in the same grid:
// - prefix block x < nchunk: keys [x·CT·64, (x + 1)·CT·64) of its prompt's
//   prefix (CT = `ctiles` 64-key tiles) against all N = R·G query rows of its
//   (prompt, kv head), in 64-row tiles (one at N <= 64: 64 at 3B, 56 at 7B,
//   the last rows zero and dropped);
// - suffix block x = nchunk + r: rollout row b = p·R + r's live suffix
//   (own_len keys) and its new token, the token appended as key own_len,
//   against that row's G query rows, padded to a 64-row tile. The same
//   wgmma path as the prefix blocks: G = 7 or 8 rows fill 1/8 of the tile,
//   but at up to 201 keys that wastes ~0.4 MFLOP of tensor-core work (well
//   under a microsecond) and keeps one code path and one rounding rule for
//   every key, where mma.sync m16n8k16 would need its own fragments and FMA
//   would give the suffix other numerics than the prefix.
// Warpgroup w of a block takes the block's key tiles w, w + 2, ... with its
// own online softmax, so a block's chain is half its tiles long; each
// streams its tiles through its own ring of 2 stages of cp.async copies, with
// 64 K scales, V scales and bias values a stage. Per tile:
//   S = Q K^T   m64n64k16 over D (A = Q, B = the K tile, both K-major, smem)
//   x = S·scale (·k scale) + bias; keys past the end -inf; online max;
//   p = x > NEG_INF/2 ? exp(x - m) : 0 (the mask floor, as the TPU kernel's
//   :88-92), so a chunk of pad keys ends as m = NEG_INF, l = 0, acc = 0;
//   l += p (unrounded); p ·= v scale; P rounded to bf16 in registers as the
//   A fragment; O += P V  m64nDk16 (B = the V tile, MN-major).
// int8 tiles land raw and are converted to bf16 in shared memory, exactly,
// with integer and f32-add work only (int8x16_to_bf16; V while S is
// computed); the new token (bf16, scale 1) lands beside them. Warpgroup 1 then hands its (O, m, l) to
// warpgroup 0 through shared memory, which merges the two, and the block
// writes its rows' unnormalised (acc, m, l) in f32 to its slot of the
// partials (slot x for prefix chunk x, slot nchunk for the suffix blocks,
// whose rows are disjoint). It then takes an integer ticket of its (prompt,
// kv head). The block that takes the last ticket folds the nchunk + 1 slots
// of every row in slot order (weights exp(m_s - m) / l, no float atomics:
// two launches on the same inputs are bit-equal), each slot's partial one
// bulk copy (cp.async.bulk on an mbarrier) into the rings' space, four in
// flight, writes the normalised bf16 output, and resets the
// ticket to 0 for the next launch (the counters are reused, so launches that
// share them must be stream-ordered).
//
// The chunk length (ops/decode_attention.py::tc_chunk_tiles): a prefix
// block's f32 partials are N·D·4 bytes against CT·64·D·2·c bytes of K/V (c =
// 2 for bf16, 1 for int8), so CT >= N / (16·c) keeps them at most half the
// K/V they summarise (CT >= 2 in bf16, 4 in int8 at N = 64). CT = 4 at
// least: two tiles a warpgroup, the chain of a suffix block of up to 256
// keys, and at the rollout shape (Lp = 2048, Hkv = 2, R = 8) 8 + 8 blocks a
// kv head and a fold of 9 x 32 KB from L2 by one block. The fold is serial
// in one block, so the slots it reads, not the grid's fill, decide the
// chunk (scripts/profile_decode_window_tc.py times the parts at CT 1-8).
//
// What bounds it: the live K/V, ~2.1 MB in bf16 at the rollout shape
// (0.0011 ms at 3.35 TB/s); in practice one block's serial chain (its tiles'
// copies, two products and the softmax each), then the fold.
namespace t1 {
namespace tc {

constexpr int DEC_WGS = 2;         // warpgroups a block, each on its own key tiles
constexpr int DEC_STAGES = 2;      // key tiles in flight per warpgroup
constexpr int DEC_MAX_SLOTS = 65;  // up to 64 prefix chunks and the suffix slot
constexpr int DEC_EXTRA = 3 * 64 * 4;  // a stage's K scales, V scales and bias (f32)

// One warpgroup's ring: stages of (K, V) bf16 tiles; int8: stages of raw
// (K, V), then one bf16 (K, V) pair. Large enough for the other warpgroup's
// (O, m, l) in the merge.
template <int D, bool QUANT>
__host__ __device__ constexpr int dec_ring_bytes() {
  return QUANT ? DEC_STAGES * 2 * 64 * D + 2 * tile_bytes<D>() : DEC_STAGES * 2 * tile_bytes<D>();
}

// 1 KB of alignment, Q, the warpgroups' rings, their stages' extras, their
// new-token rows (2 x D bf16), the fold's m and l (slot x 64 rows each),
// the last-block flag and the fold's barriers.
template <int D, bool QUANT>
__host__ __device__ constexpr int dec_smem_bytes() {
  return 1024 + tile_bytes<D>() + DEC_WGS * (dec_ring_bytes<D, QUANT>() + DEC_STAGES * DEC_EXTRA + 4 * D) +
         2 * DEC_MAX_SLOTS * 64 * 4 + 16 + 64;
}

// A named barrier over warpgroup `wg`'s 128 threads (barrier 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "r"(WG) : "memory");
}

// PARTS 7 is the kernel; a timing build also instantiates 1, 2 and 4: its
// prefix blocks, its suffix blocks or its fold alone (t1_decode_full_tc_part).
template <int D, bool QUANT, int PARTS>
__global__ void __launch_bounds__(DEC_WGS * WG, 1) decode_full_tc(const __grid_constant__ DecodeParams p) {
  using C = typename std::conditional<QUANT, int8_t, bf16>::type;
  constexpr int TILE = tile_bytes<D>();
  constexpr int RING = dec_ring_bytes<D, QUANT>();
  constexpr int NT = DEC_WGS * WG;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  const uint32_t sRings = sQ + TILE;  // warpgroup w's ring at sRings + w RING
  const uint32_t sExtras = sRings + DEC_WGS * RING;
  const uint32_t sNew = sExtras + DEC_WGS * DEC_STAGES * DEC_EXTRA;  // w's new-token K, V rows at sNew + 4 D w
  const uint32_t sFold = sNew + DEC_WGS * 4 * D;
  auto at = [&](uint32_t a) { return smem_raw + (a - raw); };
  float* fm = reinterpret_cast<float*>(at(sFold));  // the fold: m, then l, [slot][64 rows]
  float* fl = fm + DEC_MAX_SLOTS * 64;
  int* last = reinterpret_cast<int*>(fl + DEC_MAX_SLOTS * 64);

  const int tid = threadIdx.x;
  const int wg = tid / WG;
  const int wt = tid % WG;  // thread in its warpgroup
  const int lane = tid & 31;
  const int h = blockIdx.y;
  const int pp = blockIdx.z;
  const long long ph = (long long)pp * p.Hkv + h;
  const int nslot = p.nchunk + 1;
  const bf16* qph = static_cast<const bf16*>(p.q) + ph * p.N * D;

  if constexpr (PARTS != 4) {
    const int role = blockIdx.x + (PARTS == 2 ? p.nchunk : 0);
    const bool prefix = role < p.nchunk;
    const C *kg, *vg;
    const float *ksg = nullptr, *vsg = nullptr, *bg = nullptr;
    const bf16 *kn = nullptr, *vn = nullptr;
    long long kst, sst = 0;
    int n_cache, row_begin, row_end, slot;
    if (prefix) {
      const int key0 = role * p.ctiles * 64;
      kg = static_cast<const C*>(p.kp) + pp * p.kv_sp + h * p.kv_sh + key0 * p.kv_st;
      vg = static_cast<const C*>(p.vp) + pp * p.kv_sp + h * p.kv_sh + key0 * p.kv_st;
      kst = p.kv_st;
      if (QUANT) {
        ksg = p.ksp + pp * p.s_sp + h * p.s_sh + key0 * p.s_st;
        vsg = p.vsp + pp * p.s_sp + h * p.s_sh + key0 * p.s_st;
        sst = p.s_st;
      }
      bg = p.bias + (long long)pp * p.Lp + key0;
      n_cache = min(p.ctiles * 64, p.Lp - key0);
      row_begin = 0;
      row_end = p.N;
      slot = role;
    } else {
      const int r = role - p.nchunk;
      const long long b = (long long)pp * p.R + r;
      kg = static_cast<const C*>(p.ko) + b * p.own_sb + h * p.own_sh;
      vg = static_cast<const C*>(p.vo) + b * p.own_sb + h * p.own_sh;
      kst = p.own_st;
      if (QUANT) {
        ksg = p.kso + b * p.os_sb + h * p.os_sh;
        vsg = p.vso + b * p.os_sb + h * p.os_sh;
        sst = p.os_st;
      }
      kn = static_cast<const bf16*>(p.kn) + b * p.n_sb + h * p.n_sh;
      vn = static_cast<const bf16*>(p.vn) + b * p.n_sb + h * p.n_sh;
      n_cache = *p.own_len;
      row_begin = r * p.G;
      row_end = row_begin + p.G;
      slot = p.nchunk;
    }
    const int n_keys = n_cache + (kn != nullptr);  // the new token is key n_cache of a suffix block
    const int ntiles = (n_keys + 63) / 64;
    const int my_tiles = (ntiles - wg + DEC_WGS - 1) / DEC_WGS;  // tiles wg, wg + DEC_WGS, ...
    const uint32_t ring = sRings + wg * RING;
    const uint32_t ex_base = sExtras + wg * DEC_STAGES * DEC_EXTRA;
    const uint32_t new_row = sNew + wg * 4 * D;

    // the warpgroup's i-th tile (key tile wg + DEC_WGS i) into stage i % DEC_STAGES
    auto load_kv = [&](int i) {
      const int st = i % DEC_STAGES;
      const int k0 = (wg + DEC_WGS * i) * 64;
      if constexpr (QUANT) {
        constexpr int CPR = D / 16;  // 16-byte chunks of an int8 row
        const uint32_t dk = ring + st * 2 * 64 * D;
#pragma unroll
        for (int it = 0; it < 64 * CPR / WG; ++it) {
          const int idx = it * WG + wt;
          const int r = idx / CPR;
          const int c = idx % CPR;
          const bool ok = k0 + r < n_cache;
          const long long off = (long long)(ok ? k0 + r : 0) * kst + 16 * c;
          cp_async16(dk + r * D + 16 * c, kg + off, ok);
          cp_async16(dk + 64 * D + r * D + 16 * c, vg + off, ok);
        }
        if (kn != nullptr && n_cache >= k0 && n_cache < k0 + 64 && wt < D / 4) {  // the new token's rows, bf16
          const int kv = wt / (D / 8);
          const int c = wt % (D / 8);
          cp_async16(new_row + kv * 2 * D + 16 * c, (kv ? vn : kn) + 8 * c, true);
        }
      } else {
        constexpr int CPR = D / 8;  // 16-byte chunks of a bf16 row
        const uint32_t dk = ring + 2 * st * TILE;
#pragma unroll
        for (int it = 0; it < 64 * CPR / WG; ++it) {
          const int idx = it * WG + wt;
          const int r = idx / CPR;
          const int c = idx % CPR;
          const int key = k0 + r;
          const bf16 *sk = kg, *sv = vg;
          const bool ok = key < n_cache || (key == n_cache && kn != nullptr);
          if (key < n_cache) {
            sk = kg + key * kst + 8 * c;
            sv = vg + key * kst + 8 * c;
          } else if (ok) {
            sk = kn + 8 * c;
            sv = vn + 8 * c;
          }
          cp_async16(dk + chunk_off<D>(r, c), sk, ok);
          cp_async16(dk + TILE + chunk_off<D>(r, c), sv, ok);
        }
      }
      if (wt < 64) {
        const int key = k0 + wt;
        const uint32_t dex = ex_base + st * DEC_EXTRA;
        float* ex = reinterpret_cast<float*>(at(dex));
        if (QUANT) {
          if (key < n_cache) {
            cp_async4(dex + 4 * wt, ksg + key * sst, true);
            cp_async4(dex + 256 + 4 * wt, vsg + key * sst, true);
          } else {  // the new token is unquantized; keys past the end are masked
            ex[wt] = 1.f;
            ex[64 + wt] = 1.f;
          }
        }
        if (bg != nullptr && key < n_cache)
          cp_async4(dex + 512 + 4 * wt, bg + key, true);
        else
          ex[128 + wt] = 0.f;
      }
    };

    const int r0 = (wt / 32) * 16 + (lane >> 2);  // the thread's rows of a tile: r0 and r0 + 8
    const long long slot_row0 = (ph * nslot + slot) * p.N;
    for (int rb = row_begin; rb < row_end; rb += 64) {
      const int nr = min(64, row_end - rb);
      if (rb != row_begin) __syncthreads();  // both warpgroups are done with Q and the merge area
      if (wg == 0) load_tile<D>(sQ, qph + (long long)rb * D, D, 0, nr, wt);  // with warpgroup 0's first group
      for (int i = 0; i < DEC_STAGES; ++i) {
        if (i < my_tiles) load_kv(i);
        cp_async_commit();
      }
      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
      cp_async_wait<DEC_STAGES - 1>();
      __syncthreads();  // Q and each warpgroup's first tile have landed

      for (int i = 0; i < my_tiles; ++i) {
        const int st = i % DEC_STAGES;
        const int k0 = (wg + DEC_WGS * i) * 64;
        uint32_t sK = ring + 2 * st * TILE;
        if (i > 0) {
          cp_async_wait<DEC_STAGES - 1>();
          wg_sync(wg);  // every thread's copies of this tile have landed
        }
        // int8: tile i's raw K (kv 0) or V (kv 1) into the bf16 pair at sK
        auto convert = [&](int kv) {
          constexpr int CPR = D / 16;
#pragma unroll
          for (int it = 0; it < 64 * CPR / WG; ++it) {
            const int idx = it * WG + wt;
            const int r = idx / CPR;
            const int c = idx % CPR;
            uint4 lo, hi;
            if (k0 + r == n_cache && kn != nullptr) {
              const uint4* src = reinterpret_cast<const uint4*>(at(new_row + kv * 2 * D + 32 * c));
              lo = src[0];
              hi = src[1];
            } else {
              int8x16_to_bf16(*reinterpret_cast<const uint4*>(at(ring + st * 2 * 64 * D + kv * 64 * D + r * D + 16 * c)),
                              lo, hi);
            }
            const uint32_t dst = sK + kv * TILE;
            *reinterpret_cast<uint4*>(at(dst + chunk_off<D>(r, 2 * c))) = lo;
            *reinterpret_cast<uint4*>(at(dst + chunk_off<D>(r, 2 * c + 1))) = hi;
          }
        };
        if constexpr (QUANT) {
          sK = ring + DEC_STAGES * 2 * 64 * D;
          convert(0);
        }
        const uint32_t sV = sK + TILE;
        fence_proxy_async();
        wg_sync(wg);

        float s[32];
        wgmma_fence();
        scores<D>(s, sQ, sK);
        wgmma_commit();
        if constexpr (QUANT) {  // V converts while S is computed
          convert(1);
          fence_proxy_async();
          wg_sync(wg);
        }
        wgmma_wait_all();
        fence_regs(s);

        const float* ex = reinterpret_cast<const float*>(at(ex_base + st * DEC_EXTRA));
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * (lane & 3) + (e & 1);
            float x = s[4 * j + e] * p.scale;
            if (QUANT) x *= ex[col];
            x += ex[128 + col];
            if (k0 + col >= n_keys) x = -INFINITY;  // past the end: no weight at all
            s[4 * j + e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          alpha[r] = __expf(m[r] - mx[r]);
          m[r] = mx[r];
          l[r] *= alpha[r];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * (lane & 3) + (e & 1);
            const float x = s[4 * j + e];
            float pr = x > NEG_INF * 0.5f ? __expf(x - m[e >> 1]) : 0.f;  // the mask floor
            l[e >> 1] += pr;
            if (QUANT) pr *= ex[64 + col];
            s[4 * j + e] = pr;
          }
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j + 0] *= alpha[0];
          o[4 * j + 1] *= alpha[0];
          o[4 * j + 2] *= alpha[1];
          o[4 * j + 3] *= alpha[1];
        }
        uint32_t a[4][4];
        to_afrag(s, a);
        __syncwarp();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(o, a[kk], mnmajor(sV, kk));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
        wg_sync(wg);  // the warpgroup is done with stage st (and the int8 pair)
        if (i + DEC_STAGES < my_tiles) load_kv(i + DEC_STAGES);
        cp_async_commit();
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }

      // merge warpgroup 1's (O, m, l) into warpgroup 0's through its ring,
      // thread for thread (both hold the same rows and columns)
      float* mg = reinterpret_cast<float*>(at(sRings + RING));
      if (wg == 1) {
#pragma unroll
        for (int k = 0; k < D / 2; ++k) mg[k * WG + wt] = o[k];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mg[(D / 2 + r) * WG + wt] = m[r];
          mg[(D / 2 + 2 + r) * WG + wt] = l[r];
        }
      }
      __syncthreads();
      if (wg == 0) {
        float a0[2], a1[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m1 = mg[(D / 2 + r) * WG + wt];
          const float mm = fmaxf(m[r], m1);
          a0[r] = __expf(m[r] - mm);
          a1[r] = __expf(m1 - mm);
          m[r] = mm;
          l[r] = l[r] * a0[r] + mg[(D / 2 + 2 + r) * WG + wt] * a1[r];
        }
#pragma unroll
        for (int k = 0; k < D / 2; ++k) o[k] = o[k] * a0[(k >> 1) & 1] + mg[k * WG + wt] * a1[(k >> 1) & 1];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = rb + r0 + 8 * r;
          if (row < rb + nr) {
            float* dst = p.acc_part + (slot_row0 + row) * D + 2 * (lane & 3);
#pragma unroll
            for (int j = 0; j < D / 8; ++j)
              *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
            if ((lane & 3) == 0) {
              p.m_part[slot_row0 + row] = m[r];
              p.l_part[slot_row0 + row] = l[r];
            }
          }
        }
      }
    }
    if constexpr (PARTS != 7) return;
    __syncthreads();  // the block's partials are written
    if (tid == 0) {   // as a grid barrier does: one fence releases them, the last block's acquires the others'
      __threadfence();
      *last = atomicAdd(p.ticket + ph, 1) == p.nchunk + p.R - 1;
      if (*last) __threadfence();
    }
    __syncthreads();
    if (!*last) return;
  }

  // The fold: every row of this (prompt, kv head), 64 rows at a time, over
  // the slots in order. Each slot's 64 x D f32 partial streams into one of
  // FB buffers (the rings' space) by one bulk copy of the async proxy,
  // completed on its mbarrier, so FB slots are in flight at once; each
  // thread holds F4 float4s of the rows' output.
  constexpr int F4 = 64 * D / 4 / NT;
  constexpr int FB = DEC_WGS * RING / (64 * D * 4);
  static_assert(FB >= 2, "the fold's buffers");
  const uint32_t bars = sFold + 2 * DEC_MAX_SLOTS * 64 * 4 + 16;
  if (tid == 0) {
    for (int i = 0; i < FB; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async;\n" ::: "memory");  // the partials' generic writes, before the bulk reads
  }
  int n_fold = 0;  // slots folded so far: buffer n_fold % FB, its phase n_fold / FB
  for (int rb = 0; rb < p.N; rb += 64) {
    const int nr = min(64, p.N - rb);
    __syncthreads();  // the barriers are set up; the previous rows' buffers, m and l are consumed
    const float* src = p.acc_part + (ph * nslot * p.N + rb) * D;
    auto issue = [&](int s, int n) {  // slot s as the block's n-th fold copy; thread 0
      const uint32_t bar = bars + 8 * (n % FB);
      const uint32_t bytes = nr * D * 4;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
                   ::"r"(sRings + (n % FB) * 64 * D * 4), "l"(src + (long long)s * p.N * D), "r"(bytes), "r"(bar)
                   : "memory");
    };
    if (tid == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the buffers' earlier generic use
      for (int s = 0; s < FB && s < nslot; ++s) issue(s, n_fold + s);
    }
#pragma unroll 4
    for (int idx = tid; idx < nslot * 64; idx += NT) {
      const int sl = idx / 64;
      const int r = idx % 64;
      const long long at_ml = (ph * nslot + sl) * p.N + rb + r;
      fm[idx] = r < nr ? __ldcg(p.m_part + at_ml) : NEG_INF;
      fl[idx] = r < nr ? __ldcg(p.l_part + at_ml) : 0.f;
    }
    __syncthreads();
    if (tid < 64) {  // fm becomes the slots' weights exp(m_s - m) / l
      float mm = NEG_INF;
      for (int sl = 0; sl < nslot; ++sl) mm = fmaxf(mm, fm[sl * 64 + tid]);
      float ll = 0.f;
      for (int sl = 0; sl < nslot; ++sl) {
        const float w = __expf(fm[sl * 64 + tid] - mm);
        fm[sl * 64 + tid] = w;
        ll += w * fl[sl * 64 + tid];
      }
      const float inv = tid < nr ? 1.f / ll : 0.f;  // > 0: the new token is always live
      for (int sl = 0; sl < nslot; ++sl) fm[sl * 64 + tid] *= inv;
    }
    __syncthreads();
    float4 acc[F4];
#pragma unroll
    for (int u = 0; u < F4; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sl = 0; sl < nslot; ++sl, ++n_fold) {
      mbar_wait(bars + 8 * (n_fold % FB), (n_fold / FB) & 1);
      const float4* buf = reinterpret_cast<const float4*>(at(sRings + (n_fold % FB) * 64 * D * 4));
#pragma unroll
      for (int u = 0; u < F4; ++u) {
        const int f = tid + NT * u;
        if (f * 4 < nr * D) {
          const float w = fm[sl * 64 + f / (D / 4)];
          const float4 x = buf[f];
          acc[u].x = fmaf(w, x.x, acc[u].x);
          acc[u].y = fmaf(w, x.y, acc[u].y);
          acc[u].z = fmaf(w, x.z, acc[u].z);
          acc[u].w = fmaf(w, x.w, acc[u].w);
        }
      }
      __syncthreads();  // every thread is done with the buffer
      if (tid == 0 && sl + FB < nslot) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // its generic reads, before the next copy
        issue(sl + FB, n_fold + FB);
      }
    }
    bf16* og = static_cast<bf16*>(p.o) + (ph * p.N + rb) * D;
#pragma unroll
    for (int u = 0; u < F4; ++u) {
      const int f = tid + NT * u;
      if (f * 4 < nr * D)
        *reinterpret_cast<uint2*>(og + 4 * f) = make_uint2(pack_bf16(acc[u].x, acc[u].y), pack_bf16(acc[u].z, acc[u].w));
    }
  }
  if constexpr (PARTS == 7)
    if (tid == 0) p.ticket[ph] = 0;  // every block of this (prompt, kv head) has arrived
}

template <int D, bool QUANT, int PARTS>
int run_full_tc(const DecodeParams& p, cudaStream_t stream) {
  constexpr int smem = dec_smem_bytes<D, QUANT>();
  cudaError_t err =
      cudaFuncSetAttribute(decode_full_tc<D, QUANT, PARTS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int gx = PARTS == 1 ? p.nchunk : PARTS == 2 ? p.R : PARTS == 4 ? 1 : p.nchunk + p.R;
  decode_full_tc<D, QUANT, PARTS><<<dim3(gx, p.Hkv, p.P), DEC_WGS * WG, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int PARTS>
int full_tc(int quant, int D, const DecodeParams& p, cudaStream_t st) {
  if (D != 64 && D != 128) return -1;
  if (p.nchunk < 1 || p.nchunk + 1 > DEC_MAX_SLOTS || p.G < 1 || p.G > 64 || p.ctiles < 1) return -2;
  if (quant) return D == 64 ? run_full_tc<64, true, PARTS>(p, st) : run_full_tc<128, true, PARTS>(p, st);
  return D == 64 ? run_full_tc<64, false, PARTS>(p, st) : run_full_tc<128, false, PARTS>(p, st);
}

}  // namespace tc
}  // namespace t1

// D2 on the tensor cores: bf16 q, new token and output; quant: int8 caches,
// else bf16; D 64 or 128. -1: no instance; -2: a shape the kernel does not take.
extern "C" int t1_decode_full_tc(int quant, int D, const t1::DecodeParams* p, void* stream) {
  return t1::tc::full_tc<7>(quant, D, *p, static_cast<cudaStream_t>(stream));
}

#ifdef T1_D2_PROFILE_PARTS
// A timing build only (scripts/profile_decode_window_tc.py compiles this
// file with -DT1_D2_PROFILE_PARTS; the port never loads it): parts 1, 2 or 4
// launch the tensor-core D2's prefix blocks, its suffix blocks or its fold
// alone. None of them takes a ticket, and only the fold writes the output.
extern "C" int t1_decode_full_tc_part(int parts, int quant, int D, const t1::DecodeParams* p, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (parts) {
    case 1: return t1::tc::full_tc<1>(quant, D, *p, st);
    case 2: return t1::tc::full_tc<2>(quant, D, *p, st);
    case 4: return t1::tc::full_tc<4>(quant, D, *p, st);
    default: return -2;
  }
}
#endif

// Dynamic shared memory of one tensor-core D2 block, in bytes.
extern "C" int t1_decode_full_tc_smem_bytes(int quant, int D) {
  using namespace t1::tc;
  if (D == 64) return quant ? dec_smem_bytes<64, true>() : dec_smem_bytes<64, false>();
  if (D == 128) return quant ? dec_smem_bytes<128, true>() : dec_smem_bytes<128, false>();
  return -1;
}
