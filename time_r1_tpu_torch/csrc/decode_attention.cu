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
// (`decode_combine`); D2 folds them in `decode_tail` (one block per (kv head,
// rollout row), one warp per query row), continues the online softmax over
// the row's live suffix and the in-register new token, and normalises. D1 is
// two launches and D2 two, the split pass shared.
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
// partials (P·Hkv·Lp/64·N·D·4 = 2 MB) matter more; the arithmetic is plain
// f32 FMA out of shared memory (tensor cores later).
#include <stdint.h>

#include "attention_tile.cuh"

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
  long long kv_sp, kv_sh, kv_st;
  long long s_sp, s_sh, s_st;
  long long own_sb, own_sh, own_st;
  long long os_sb, os_sh, os_st;
  long long n_sb, n_sh;
  int P, Hkv, N, Lp, R, G, nchunk, own_len;
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

    for (int t0 = 0; t0 < p.own_len; t0 += CH) {
      const int nk = min(CH, p.own_len - t0);
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

// dtype 0 = float32, 1 = bfloat16 (q, new token, output); quant: int8 caches,
// else the caches have q's dtype; D 64 or 128. -1: no instance.
template <template <typename, typename, int, bool> class F>
int dispatch(int dtype, int quant, int D, const DecodeParams& p, cudaStream_t st) {
  if ((dtype != 0 && dtype != 1) || (D != 64 && D != 128)) return -1;
  if (dtype == 0) {
    if (quant) return D == 64 ? F<float, int8_t, 64, true>::run(p, st) : F<float, int8_t, 128, true>::run(p, st);
    return D == 64 ? F<float, float, 64, false>::run(p, st) : F<float, float, 128, false>::run(p, st);
  }
  if (quant)
    return D == 64 ? F<__nv_bfloat16, int8_t, 64, true>::run(p, st) : F<__nv_bfloat16, int8_t, 128, true>::run(p, st);
  return D == 64 ? F<__nv_bfloat16, __nv_bfloat16, 64, false>::run(p, st)
                 : F<__nv_bfloat16, __nv_bfloat16, 128, false>::run(p, st);
}

template <typename T, typename C, int D, bool QUANT>
struct Split {
  static int run(const DecodeParams& p, cudaStream_t st) { return run_split<T, C, D, QUANT>(p, st); }
};

template <typename T, typename C, int D, bool QUANT>
struct Tail {
  static int run(const DecodeParams& p, cudaStream_t st) { return run_tail<T, C, D, QUANT>(p, st); }
};

}  // namespace

extern "C" int t1_decode_prefix_split(int dtype, int quant, int D, const DecodeParams* p, void* stream) {
  return dispatch<Split>(dtype, quant, D, *p, static_cast<cudaStream_t>(stream));
}

extern "C" int t1_decode_prefix_combine(int D, const DecodeParams* p, void* stream) {
  decode_combine<<<dim3(p->N, p->Hkv, p->P), 128, 0, static_cast<cudaStream_t>(stream)>>>(*p, D);
  return cudaGetLastError();
}

extern "C" int t1_decode_tail(int dtype, int quant, int D, const DecodeParams* p, void* stream) {
  return dispatch<Tail>(dtype, quant, D, *p, static_cast<cudaStream_t>(stream));
}
