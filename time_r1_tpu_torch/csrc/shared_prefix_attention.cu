// S1 and S2: shared-prefix attention for the GRPO split loss.
//
// B = P * R query rows, row-major by prompt: row b attends [the shared prefix
// of prompt b / R, masked by its (P, Lp) additive bias | its own causal
// chunk], with one softmax over both. The prefix K/V enter once per prompt
// and are read by the R rows of the group; nothing is repeated or
// concatenated in device memory.
//
// Replace the Pallas kernels of time_r1_tpu/ops/flash_attention.py:
//   S1 `_sp_fwd` (pallas_call at :575): forward + lse. K1's online softmax
//      (`fwd_source` in attention_tile.cuh) run over the two key sources in turn;
//   S2 `_sp_vjp_bwd`, dq (pallas_call at :739): attn_bwd_dq over the same two
//      sources, given the global lse/delta;
//   S2 `_sp_vjp_bwd`, prefix dK/dV (pallas_call at :769): attn_bwd_dkv over the
//      prefix, each block summing over the R rows and the G q-heads that read
//      its key tile. The own-chunk dK/dV is B2 (flash_attention_bwd.cu) with a
//      zero bias, as in the JAX package (:760).
//
// What bounds them on the H100: at the split-loss shape (q (8, 256, 16, 128),
// prefix (1, 2048, 2, 128), own chunk (8, 256, 2, 128)) each is ~10-40 GFLOP
// against tens of MB, so the bound is the arithmetic (989 TFLOP/s bf16). This
// first version runs plain f32 FMA. The prefix dK/dV kernel has the worst
// occupancy of the slice: P * Hkv * Lp/64 blocks (64 at that shape), each
// looping R * G = 64 (row, head) pairs over Sc/64 query tiles. Splitting that
// loop across blocks (f32 atomics) or tensor-core tiles are later changes.
#include "attention_bwd.cuh"

namespace {

struct SpParams {
  const void* q;        // (B, Sc, H, D)
  const void* kp;       // (P, Lp, Hkv, D)
  const void* vp;
  const void* ko;       // (B, Sc, Hkv, D)
  const void* vo;
  const float* pbias;   // (P, Lp)
  void* o;              // (B, Sc, H, D)
  float* lse;           // (B, H, Sc)
  int R;
  int Sc;
  int Lp;
  int H;
  int G;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(t1::NTHREADS, 2) sp_fwd(const SpParams p) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* KV = Qs + t1::BQ * (D + 1);
  float* Ps = KV + D * (t1::BK + 1);

  const int q0 = blockIdx.x * t1::BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int pi = b / p.R;
  const int Hkv = p.H / p.G;
  const int q_row = p.H * D;
  const int kv_row = Hkv * D;
  const long long q_off = (long long)b * p.Sc * q_row + (long long)h * D;
  const long long kvh = (long long)(h / p.G) * D;
  const long long pre_off = (long long)pi * p.Lp * kv_row + kvh;
  const long long own_off = (long long)b * p.Sc * kv_row + kvh;

  t1::load_q_tile<T, D, false>(Qs, static_cast<const T*>(p.q) + q_off, q_row, p.Sc, q0, p.scale,
                               nullptr, nullptr);
  float m[4], l[4], acc[4][D / 16];
  t1::init_softmax<D>(m, l, acc);
  t1::fwd_source<T, D, false>(Qs, KV, Ps, static_cast<const T*>(p.kp) + pre_off,
                              static_cast<const T*>(p.vp) + pre_off, kv_row, p.Lp,
                              p.pbias + (long long)pi * p.Lp, 0, q0,
                              (p.Lp + t1::BK - 1) / t1::BK, nullptr, nullptr, m, l, acc);
  t1::fwd_source<T, D, false>(Qs, KV, Ps, static_cast<const T*>(p.ko) + own_off,
                              static_cast<const T*>(p.vo) + own_off, kv_row, p.Sc, nullptr, 1, q0,
                              t1::causal_tiles(p.Sc, p.Sc, q0, 0), nullptr, nullptr, m, l, acc);
  t1::store_out<T, D>(static_cast<T*>(p.o) + q_off, q_row,
                      p.lse + ((long long)b * p.H + h) * p.Sc, p.Sc, q0, m, l, acc);
}

template <typename T, int D>
cudaError_t launch_fwd(const SpParams& p, int B, cudaStream_t stream) {
  const int smem = t1::smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(sp_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sc + t1::BQ - 1) / t1::BQ, p.H, B);
  sp_fwd<T, D><<<grid, t1::NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

t1::BwdSource prefix_source(const void* kp, const void* vp, const float* pbias, int R, int Lp,
                            int Hkv, int D) {
  return t1::BwdSource{kp, vp, pbias, (long long)Lp * Hkv * D, Hkv * D, Lp, 0, 0, R};
}

t1::BwdParams sp_bwd_params(const void* q, const void* dout, const float* lse,
                            const float* delta, int Sc, int H, int Hkv, float scale) {
  t1::BwdParams p{};
  p.q = q;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.Sq = Sc;
  p.H = H;
  p.Hkv = Hkv;
  p.G = H / Hkv;
  p.scale = scale;
  return p;
}

}  // namespace

// S1. q, o (B, Sc, H, D); kp, vp (P, Lp, Hkv, D); ko, vo (B, Sc, Hkv, D);
// prefix_bias (P, Lp) f32; lse (B, H, Sc) f32. B = P * R.
extern "C" int t1_sp_fwd(int dtype, const void* q, const void* kp, const void* vp, const void* ko,
                         const void* vo, const float* prefix_bias, void* o, float* lse, int B,
                         int P, int Sc, int Lp, int H, int Hkv, int D, float scale, void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  SpParams p{q, kp, vp, ko, vo, prefix_bias, o, lse, B / P, Sc, Lp, H, H / Hkv, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return dtype ? launch_fwd<__nv_bfloat16, 64>(p, B, st) : launch_fwd<float, 64>(p, B, st);
    case 128:
      return dtype ? launch_fwd<__nv_bfloat16, 128>(p, B, st) : launch_fwd<float, 128>(p, B, st);
    default:
      return -1;
  }
}

// S2, dq over the prefix and the own chunk. dout, dq as q; lse, delta (B, H, Sc) f32.
extern "C" int t1_sp_bwd_dq(int dtype, const void* q, const void* kp, const void* vp,
                            const void* ko, const void* vo, const float* prefix_bias,
                            const void* dout, const float* lse, const float* delta, void* dq,
                            int B, int P, int Sc, int Lp, int H, int Hkv, int D, float scale,
                            void* stream) {
  t1::BwdParams p = sp_bwd_params(q, dout, lse, delta, Sc, H, Hkv, scale);
  p.dq = dq;
  p.n_src = 2;
  p.src[0] = prefix_source(kp, vp, prefix_bias, B / P, Lp, Hkv, D);
  p.src[1] = t1::BwdSource{ko, vo, nullptr, (long long)Sc * Hkv * D, Hkv * D, Sc, 1, 0, 1};
  const dim3 grid((Sc + t1::BQ - 1) / t1::BQ, H, B);
  return t1::dispatch_bwd(false, dtype, D, p, grid, static_cast<cudaStream_t>(stream));
}

// S2, the prefix dK/dV (P, Lp, Hkv, D) f32, summed over the R rows and G q-heads.
extern "C" int t1_sp_bwd_dkv_prefix(int dtype, const void* q, const void* kp, const void* vp,
                                    const float* prefix_bias, const void* dout, const float* lse,
                                    const float* delta, float* dkp, float* dvp, int B, int P,
                                    int Sc, int Lp, int H, int Hkv, int D, float scale,
                                    void* stream) {
  t1::BwdParams p = sp_bwd_params(q, dout, lse, delta, Sc, H, Hkv, scale);
  p.dk = dkp;
  p.dv = dvp;
  p.n_src = 1;
  p.src[0] = prefix_source(kp, vp, prefix_bias, B / P, Lp, Hkv, D);
  const dim3 grid((Lp + t1::BK - 1) / t1::BK, Hkv, P);
  return t1::dispatch_bwd(true, dtype, D, p, grid, static_cast<cudaStream_t>(stream));
}
