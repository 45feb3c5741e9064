// FlashAttention-2 backward tiles, shared by B1/B2 (flash_attention_bwd.cu) and
// the two S2 kernels (shared_prefix_attention.cu).
//
// Both kernels recompute the probabilities from the forward's log-sum-exp,
// p = exp(s - lse), and take delta = rowsum(dO * O) from the caller, so the
// (rows, keys) scores never reach device memory:
//   dq = scale * sum_keys ds k,    ds = p (dp - delta),   dp = dO v^T
//   dv = sum_rows p^T dO,          dk = sum_rows ds^T (scale q)
//
// attn_bwd_dq: one block of 256 threads per 64-row query tile of one head of
// one batch entry. Q (scaled) and dO stay in shared memory; the block walks
// the 64-key tiles of one or two key sources (B1: the sequence itself; S2:
// the shared prefix of the row's prompt, then its own causal chunk), staging
// K^T and V^T, and keeps dq in registers.
//
// attn_bwd_dkv: one block per 64-key tile of one kv head of one kv batch entry.
// K and V stay in shared memory; the block loops over every query row batch
// entry that reads this kv entry (R of them: 1 for B2, the R rollout rows of
// a prompt for S2's prefix), over the G q-heads of the kv head, and over
// their query tiles from the causal start, accumulating dK and dV in f32
// registers. The sums over q-heads and rows stay inside the block: this is the
// GPU form of the TPU kernel's resident output block with the q-head (and the
// row) innermost in the grid. No atomics, so the result does not depend on the
// order blocks run in.
//
// Thread layout as in attention_tile.cuh: 16x16 threads, each owning a 4x4
// piece of the 64x64 score tile and a 4 x D/16 piece of the accumulator.
// Plain f32 FMA out of shared memory; tensor cores are a later change.
#pragma once

#include "attention_tile.cuh"

namespace t1 {

struct BwdSource {
  const void* k;        // key rows kv_row elements apart, entries kv_batch apart
  const void* v;
  const float* bias;    // additive key bias bias[entry * Skv + key], or nullptr
  long long kv_batch;
  int kv_row;
  int Skv;
  int causal;           // key j visible to query row i iff j <= q_offset + i
  int q_offset;
  int R;                // query batch entries per kv entry: row batch b reads entry b / R
};

struct BwdParams {
  const void* q;        // (B, Sq, H, D) contiguous; dout has the same layout
  const void* dout;
  const float* lse;     // (B, H, Sq)
  const float* delta;   // (B, H, Sq)
  void* dq;             // (B, Sq, H, D) in q's dtype (dq kernel)
  float* dk;            // (kv entries, Skv, Hkv, D) f32 (dkv kernel)
  float* dv;
  int Sq;
  int H;
  int Hkv;
  int G;                // q heads per kv head
  float scale;
  int n_src;            // key sources of the dq kernel (1 or 2); the dkv kernel reads src[0]
  BwdSource src[2];
};

template <int D>
constexpr int dq_smem_floats() {
  // Q, dO [BQ][D+1]; K^T, V^T [D][BK+1]; dS [BQ][BK+1]
  return 2 * BQ * (D + 1) + 2 * D * (BK + 1) + BQ * (BK + 1);
}

template <int D>
constexpr int dkv_smem_floats() {
  // K, V [BK][D+1]; Q^T, dO^T [D][BQ+1]; P^T, dS^T [BK][BQ+1]; lse, delta [BQ]
  return 2 * BK * (D + 1) + 2 * D * (BQ + 1) + 2 * BK * (BQ + 1) + 2 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS, 1) attn_bwd_dq(const BwdParams p) {
  constexpr int DJ = D / 16;
  constexpr int QS = D + 1;
  constexpr int KS = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;             // scaled q
  float* dOs = Qs + BQ * QS;
  float* KT = dOs + BQ * QS;
  float* VT = KT + D * KS;
  float* dS = VT + D * KS;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q_row = p.H * D;
  const long long q_off = (long long)b * p.Sq * q_row + (long long)h * D;
  load_q_tile<T, D, false>(Qs, static_cast<const T*>(p.q) + q_off, q_row, p.Sq, q0, p.scale,
                           nullptr, nullptr);
  load_q_tile<T, D, false>(dOs, static_cast<const T*>(p.dout) + q_off, q_row, p.Sq, q0, 1.f,
                           nullptr, nullptr);
  const long long bh = ((long long)b * p.H + h) * p.Sq;
  float lse[4], dl[4], dq[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lse[i] = row < p.Sq ? p.lse[bh + row] : 0.f;
    dl[i] = row < p.Sq ? p.delta[bh + row] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq[i][j] = 0.f;
  }

  for (int si = 0; si < p.n_src; ++si) {
    const BwdSource& s = p.src[si];
    const long long entry = b / s.R;
    const long long kv_off = entry * s.kv_batch + (long long)(h / p.G) * D;
    const T* kg = static_cast<const T*>(s.k) + kv_off;
    const T* vg = static_cast<const T*>(s.v) + kv_off;
    const float* bias = s.bias ? s.bias + entry * s.Skv : nullptr;
    const int n_tiles = s.causal ? causal_tiles(s.Skv, p.Sq, q0, s.q_offset) : (s.Skv + BK - 1) / BK;

    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * BK;
      __syncthreads();  // Q/dO staged / the previous tile's dq update done with K^T and dS
      for (int idx = tid; idx < BK * D; idx += NTHREADS) {
        const int c = idx / D;
        const int d = idx - c * D;
        const int key = k0 + c;
        const bool in = key < s.Skv;
        KT[d * KS + c] = in ? to_f(kg[(long long)key * s.kv_row + d]) : 0.f;
        VT[d * KS + c] = in ? to_f(vg[(long long)key * s.kv_row + d]) : 0.f;
      }
      __syncthreads();

      float sc[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qv[i] = Qs[(ty + 16 * i) * QS + d];
          ov[i] = dOs[(ty + 16 * i) * QS + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kv[j] = KT[d * KS + tx + 16 * j];
          vv[j] = VT[d * KS + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
            dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const float kb = (key < s.Skv && bias) ? bias[key] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float ds = 0.f;
          if (key < s.Skv) {
            const int qpos = q0 + ty + 16 * i + s.q_offset;
            const float x = (s.causal && key > qpos) ? NEG_INF : sc[i][j] + kb;
            ds = expf(x - lse[i]) * (dp[i][j] - dl[i]);
          }
          dS[(ty + 16 * i) * KS + tx + 16 * j] = ds;
        }
      }
      __syncthreads();

      const int kmax = min(BK, s.Skv - k0);
      for (int c = 0; c < kmax; ++c) {
        float dv_[4], kk[DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) dv_[i] = dS[(ty + 16 * i) * KS + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) kk[j] = KT[(tx + 16 * j) * KS + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) dq[i][j] = fmaf(dv_[i], kk[j], dq[i][j]);
      }
    }
  }

  T* dqg = static_cast<T*>(p.dq) + q_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) store_f(dqg + (long long)row * q_row + tx + 16 * j, dq[i][j] * p.scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS, 1) attn_bwd_dkv(const BwdParams p) {
  constexpr int DJ = D / 16;
  constexpr int KR = D + 1;   // key-row stride of K and V
  constexpr int RS = BQ + 1;  // query-row stride of Q^T, dO^T, P^T, dS^T
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * KR;
  float* QT = Vs + BK * KR;   // scaled q, transposed
  float* dOT = QT + D * RS;
  float* PT = dOT + D * RS;
  float* dST = PT + BK * RS;
  float* Ls = dST + BK * RS;
  float* Dl = Ls + BQ;

  const BwdSource& s = p.src[0];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const long long entry = blockIdx.z;
  const long long kv_off = entry * s.kv_batch + (long long)hk * D;
  const T* kg = static_cast<const T*>(s.k) + kv_off;
  const T* vg = static_cast<const T*>(s.v) + kv_off;
  for (int idx = tid; idx < BK * D; idx += NTHREADS) {
    const int c = idx / D;
    const int d = idx - c * D;
    const int key = k0 + c;
    const bool in = key < s.Skv;
    Ks[c * KR + d] = in ? to_f(kg[(long long)key * s.kv_row + d]) : 0.f;
    Vs[c * KR + d] = in ? to_f(vg[(long long)key * s.kv_row + d]) : 0.f;
  }
  float kb[4], dk[4][DJ], dv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    kb[i] = (s.bias && key < s.Skv) ? s.bias[entry * s.Skv + key] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk[i][j] = dv[i][j] = 0.f;
  }

  const int q_row = p.H * D;
  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int qt0 = s.causal ? max(0, k0 - s.q_offset) / BQ : 0;  // first tile a key here is visible to
  for (int r = 0; r < s.R; ++r) {
    const long long b = entry * s.R + r;
    for (int g = 0; g < p.G; ++g) {
      const int h = hk * p.G + g;
      const long long q_off = b * p.Sq * q_row + (long long)h * D;
      const T* qg = static_cast<const T*>(p.q) + q_off;
      const T* dog = static_cast<const T*>(p.dout) + q_off;
      const float* lse = p.lse + (b * p.H + h) * p.Sq;
      const float* delta = p.delta + (b * p.H + h) * p.Sq;
      for (int qt = qt0; qt < n_qt; ++qt) {
        const int q0 = qt * BQ;
        __syncthreads();  // K/V staged / the previous tile's update done with Q^T, dO^T, P^T, dS^T
        for (int idx = tid; idx < BQ * D; idx += NTHREADS) {
          const int rr = idx / D;
          const int d = idx - rr * D;
          const int row = q0 + rr;
          const bool in = row < p.Sq;
          QT[d * RS + rr] = in ? to_f(qg[(long long)row * q_row + d]) * p.scale : 0.f;
          dOT[d * RS + rr] = in ? to_f(dog[(long long)row * q_row + d]) : 0.f;
        }
        if (tid < BQ) {
          const int row = q0 + tid;
          Ls[tid] = row < p.Sq ? lse[row] : 0.f;
          Dl[tid] = row < p.Sq ? delta[row] : 0.f;
        }
        __syncthreads();

        // transposed scores: keys ty + 16i, query rows tx + 16j
        float st[4][4], dpt[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
          float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            kv[i] = Ks[(ty + 16 * i) * KR + d];
            vv[i] = Vs[(ty + 16 * i) * KR + d];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            qv[j] = QT[d * RS + tx + 16 * j];
            ov[j] = dOT[d * RS + tx + 16 * j];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
              dpt[i][j] = fmaf(vv[i], ov[j], dpt[i][j]);
            }
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int rr = tx + 16 * j;
            const int row = q0 + rr;
            float pr = 0.f, ds = 0.f;
            if (key < s.Skv && row < p.Sq) {
              const float x = (s.causal && key > row + s.q_offset) ? NEG_INF : st[i][j] + kb[i];
              pr = expf(x - Ls[rr]);
              ds = pr * (dpt[i][j] - Dl[rr]);
            }
            PT[(ty + 16 * i) * RS + rr] = pr;
            dST[(ty + 16 * i) * RS + rr] = ds;
          }
        }
        __syncthreads();

        const int rmax = min(BQ, p.Sq - q0);
        for (int rr = 0; rr < rmax; ++rr) {
          float pv[4], sv[4], ov[DJ], qv[DJ];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            pv[i] = PT[(ty + 16 * i) * RS + rr];
            sv[i] = dST[(ty + 16 * i) * RS + rr];
          }
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            ov[j] = dOT[(tx + 16 * j) * RS + rr];
            qv[j] = QT[(tx + 16 * j) * RS + rr];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < DJ; ++j) {
              dv[i][j] = fmaf(pv[i], ov[j], dv[i][j]);
              dk[i][j] = fmaf(sv[i], qv[j], dk[i][j]);
            }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= s.Skv) continue;
    const long long o = ((entry * s.Skv + key) * p.Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      p.dk[o + tx + 16 * j] = dk[i][j];
      p.dv[o + tx + 16 * j] = dv[i][j];
    }
  }
}

template <typename T, int D>
cudaError_t launch_bwd(bool dkv, const BwdParams& p, dim3 grid, cudaStream_t stream) {
  const int smem = (dkv ? dkv_smem_floats<D>() : dq_smem_floats<D>()) * (int)sizeof(float);
  const void* fn = dkv ? reinterpret_cast<const void*>(attn_bwd_dkv<T, D>)
                       : reinterpret_cast<const void*>(attn_bwd_dq<T, D>);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (dkv)
    attn_bwd_dkv<T, D><<<grid, NTHREADS, smem, stream>>>(p);
  else
    attn_bwd_dq<T, D><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. Head dims 64 and 128 (the decoder's).
// Returns a cudaError_t, or -1 for a head dim or dtype without an instance.
inline int dispatch_bwd(bool dkv, int dtype, int D, const BwdParams& p, dim3 grid,
                        cudaStream_t stream) {
  if (dtype != 0 && dtype != 1) return -1;
  switch (D) {
    case 64:
      return dtype ? launch_bwd<__nv_bfloat16, 64>(dkv, p, grid, stream)
                   : launch_bwd<float, 64>(dkv, p, grid, stream);
    case 128:
      return dtype ? launch_bwd<__nv_bfloat16, 128>(dkv, p, grid, stream)
                   : launch_bwd<float, 128>(dkv, p, grid, stream);
    default:
      return -1;
  }
}

}  // namespace t1
