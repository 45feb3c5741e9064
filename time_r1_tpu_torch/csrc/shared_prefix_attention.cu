// S1 and S2: shared-prefix attention for the GRPO split loss.
//
// B = P * R query rows, row-major by prompt: row b attends [the shared prefix
// of prompt b / R, masked by its (P, Lp) additive bias | its own causal
// chunk], with one softmax over both. The prefix K/V enter once per prompt
// and are read by the R rows of the group; nothing is repeated or
// concatenated in device memory.
//
// Replace the Pallas kernels of time_r1_tpu/ops/flash_attention.py:
//   S1 `_sp_fwd` (pallas_call at :575): forward + lse over the two key
//      sources in turn;
//   S2 `_sp_vjp_bwd`, dq (pallas_call at :739): the dq kernel over the same
//      two sources, given the global lse/delta;
//   S2 `_sp_vjp_bwd`, prefix dK/dV (pallas_call at :769): the dK/dV kernel
//      over the prefix, summed over the R rows and the G q-heads that read
//      each kv head of a prompt. The own-chunk dK/dV is B2
//      (flash_attention_bwd.cu) with a zero bias, as in the JAX package (:760).
//
// Two instances of each, picked by the wrapper by dtype:
// - bf16 (`t1_sp_fwd_tc`, `t1_sp_bwd_dq_tc`, `t1_sp_bwd_dkv_prefix_tc`): the
//   tensor-core kernels, S1 on attention_fwd_tc.cuh and S2 on
//   attention_bwd_tc.cuh (B1's and B2's kernels with the sources above). The
//   prefix dK/dV splits the P * Hkv * Lp/64 key tiles' R * G (row, q head)
//   pairs over n_split blocks (the wrapper picks it to fill the card: 8 at the
//   split-loss shape, 512 blocks) and folds the f32 partials in a fixed order.
//   Those headers' notes give the bound, the products' instructions and the
//   budget.
// - f32 (`t1_sp_fwd`, `t1_sp_bwd_dq`, `t1_sp_bwd_dkv_prefix`): exact f32 FMA
//   (attention_tile.cuh's `fwd_source` twice, attention_bwd.cuh's kernels),
//   so that f32 runs compare with the CPU at 1e-3 and below.
//
// What bounds them on the H100: at the split-loss shape (q (8, 256, 16, 128),
// prefix (1, 2048, 2, 128), own chunk (8, 256, 2, 128)) each is ~10-40 GFLOP
// against tens of MB, so the bound is the arithmetic (989 TFLOP/s bf16).
#include "attention_bwd_tc.cuh"
#include "attention_fwd_tc.cuh"

namespace {

struct SpParams {
  const float* q;       // (B, Sc, H, D)
  const float* kp;      // (P, Lp, Hkv, D)
  const float* vp;
  const float* ko;      // (B, Sc, Hkv, D)
  const float* vo;
  const float* pbias;   // (P, Lp)
  float* o;             // (B, Sc, H, D)
  float* lse;           // (B, H, Sc)
  int R;
  int Sc;
  int Lp;
  int H;
  int G;
  float scale;
};

// f32 S1: K1's online softmax (`fwd_source`) over the two key sources in turn.
template <int D>
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

  t1::load_q_tile<float, D, false>(Qs, p.q + q_off, q_row, p.Sc, q0, p.scale, nullptr, nullptr);
  float m[4], l[4], acc[4][D / 16];
  t1::init_softmax<D>(m, l, acc);
  t1::fwd_source<float, D, false>(Qs, KV, Ps, p.kp + pre_off, p.vp + pre_off, kv_row, p.Lp,
                                  p.pbias + (long long)pi * p.Lp, 0, q0,
                                  (p.Lp + t1::BK - 1) / t1::BK, nullptr, nullptr, m, l, acc);
  t1::fwd_source<float, D, false>(Qs, KV, Ps, p.ko + own_off, p.vo + own_off, kv_row, p.Sc, nullptr, 1,
                                  q0, t1::causal_tiles(p.Sc, p.Sc, q0, 0), nullptr, nullptr, m, l, acc);
  t1::store_out<float, D>(p.o + q_off, q_row, p.lse + ((long long)b * p.H + h) * p.Sc, p.Sc, q0, m, l,
                          acc);
}

template <int D>
cudaError_t launch_fwd_fma(const SpParams& p, int B, cudaStream_t stream) {
  const int smem = t1::smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(sp_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sc + t1::BQ - 1) / t1::BQ, p.H, B);
  sp_fwd<D><<<grid, t1::NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

t1::BwdSource prefix_source(const void* kp, const void* vp, const float* pbias, int R, int Lp,
                            int Hkv, int D) {
  return t1::BwdSource{kp, vp, pbias, (long long)Lp * Hkv * D, Hkv * D, Lp, 0, 0, R};
}

t1::BwdSource own_source(const void* ko, const void* vo, int Sc, int Hkv, int D) {
  return t1::BwdSource{ko, vo, nullptr, (long long)Sc * Hkv * D, Hkv * D, Sc, 1, 0, 1};
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

t1::BwdParams sp_dq_params(const void* q, const void* kp, const void* vp, const void* ko,
                           const void* vo, const float* prefix_bias, const void* dout,
                           const float* lse, const float* delta, void* dq, int B, int P, int Sc,
                           int Lp, int H, int Hkv, int D, float scale) {
  t1::BwdParams p = sp_bwd_params(q, dout, lse, delta, Sc, H, Hkv, scale);
  p.dq = dq;
  p.n_src = 2;
  p.src[0] = prefix_source(kp, vp, prefix_bias, B / P, Lp, Hkv, D);
  p.src[1] = own_source(ko, vo, Sc, Hkv, D);
  return p;
}

// The f32 FMA backward kernels at head dims 64 and 128; -1 for another.
int launch_bwd_fma(bool dkv, int D, const t1::BwdParams& p, dim3 grid, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return t1::launch_bwd<float, 64>(dkv, p, grid, s);
    case 128: return t1::launch_bwd<float, 128>(dkv, p, grid, s);
    default: return -1;
  }
}

}  // namespace

// S1, f32. q, o (B, Sc, H, D); kp, vp (P, Lp, Hkv, D); ko, vo (B, Sc, Hkv, D);
// prefix_bias (P, Lp) f32; lse (B, H, Sc) f32. B = P * R.
extern "C" int t1_sp_fwd(const void* q, const void* kp, const void* vp, const void* ko,
                         const void* vo, const float* prefix_bias, void* o, float* lse, int B,
                         int P, int Sc, int Lp, int H, int Hkv, int D, float scale, void* stream) {
  const SpParams p{static_cast<const float*>(q), static_cast<const float*>(kp),
                   static_cast<const float*>(vp), static_cast<const float*>(ko),
                   static_cast<const float*>(vo), prefix_bias, static_cast<float*>(o), lse,
                   B / P, Sc, Lp, H, H / Hkv, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_fwd_fma<64>(p, B, st);
    case 128: return launch_fwd_fma<128>(p, B, st);
    default: return -1;
  }
}

// S1, bf16 q, kp, vp, ko, vo, o; the rest as t1_sp_fwd. The tensor-core kernel.
extern "C" int t1_sp_fwd_tc(const void* q, const void* kp, const void* vp, const void* ko,
                            const void* vo, const float* prefix_bias, void* o, float* lse, int B,
                            int P, int Sc, int Lp, int H, int Hkv, int D, float scale,
                            void* stream) {
  t1::tc::FwdParams p{};
  p.q = q;
  p.o = o;
  p.lse = lse;
  p.Sq = Sc;
  p.H = H;
  p.G = H / Hkv;
  p.scale = scale;
  p.n_src = 2;
  p.src[0] = prefix_source(kp, vp, prefix_bias, B / P, Lp, Hkv, D);
  p.src[1] = own_source(ko, vo, Sc, Hkv, D);
  return t1::tc::dispatch_fwd<false>(D, p, B, static_cast<cudaStream_t>(stream));
}

// S2, dq over the prefix and the own chunk, f32. dout, dq as q; lse, delta (B, H, Sc) f32.
extern "C" int t1_sp_bwd_dq(const void* q, const void* kp, const void* vp, const void* ko,
                            const void* vo, const float* prefix_bias, const void* dout,
                            const float* lse, const float* delta, void* dq, int B, int P, int Sc,
                            int Lp, int H, int Hkv, int D, float scale, void* stream) {
  const t1::BwdParams p = sp_dq_params(q, kp, vp, ko, vo, prefix_bias, dout, lse, delta, dq, B, P,
                                       Sc, Lp, H, Hkv, D, scale);
  return launch_bwd_fma(false, D, p, dim3((Sc + t1::BQ - 1) / t1::BQ, H, B), stream);
}

// S2, dq, bf16 operands; the tensor-core kernel (B1's, over two key sources).
extern "C" int t1_sp_bwd_dq_tc(const void* q, const void* kp, const void* vp, const void* ko,
                               const void* vo, const float* prefix_bias, const void* dout,
                               const float* lse, const float* delta, void* dq, int B, int P,
                               int Sc, int Lp, int H, int Hkv, int D, float scale, void* stream) {
  const t1::BwdParams p = sp_dq_params(q, kp, vp, ko, vo, prefix_bias, dout, lse, delta, dq, B, P,
                                       Sc, Lp, H, Hkv, D, scale);
  const dim3 grid((Sc + t1::BQ - 1) / t1::BQ, H, B);
  return t1::tc::dispatch_dq(D, p, grid, static_cast<cudaStream_t>(stream));
}

// S2, the prefix dK/dV (P, Lp, Hkv, D) f32, summed over the R rows and G
// q-heads; f32 operands.
extern "C" int t1_sp_bwd_dkv_prefix(const void* q, const void* kp, const void* vp,
                                    const float* prefix_bias, const void* dout, const float* lse,
                                    const float* delta, float* dkp, float* dvp, int B, int P,
                                    int Sc, int Lp, int H, int Hkv, int D, float scale,
                                    void* stream) {
  t1::BwdParams p = sp_bwd_params(q, dout, lse, delta, Sc, H, Hkv, scale);
  p.dk = dkp;
  p.dv = dvp;
  p.n_src = 1;
  p.src[0] = prefix_source(kp, vp, prefix_bias, B / P, Lp, Hkv, D);
  return launch_bwd_fma(true, D, p, dim3((Lp + t1::BK - 1) / t1::BK, Hkv, P), stream);
}

// S2, the prefix dK/dV, bf16 operands; the tensor-core kernel (B2's). The R *
// G (row, q head) pairs of each kv head are split over n_split blocks; with
// n_split > 1 part_dk/part_dv (n_split, P, Lp, Hkv, D) f32 take the blocks'
// sums, folded into dkp/dvp in a fixed order (they may be null when n_split
// == 1).
extern "C" int t1_sp_bwd_dkv_prefix_tc(const void* q, const void* kp, const void* vp,
                                       const float* prefix_bias, const void* dout,
                                       const float* lse, const float* delta, float* dkp,
                                       float* dvp, float* part_dk, float* part_dv, int n_split,
                                       int B, int P, int Sc, int Lp, int H, int Hkv, int D,
                                       float scale, void* stream) {
  const int R = B / P;
  if (n_split < 1 || (R * (H / Hkv)) % n_split != 0) return -1;
  t1::BwdParams p = sp_bwd_params(q, dout, lse, delta, Sc, H, Hkv, scale);
  p.dk = n_split > 1 ? part_dk : dkp;
  p.dv = n_split > 1 ? part_dv : dvp;
  p.n_src = 1;
  p.src[0] = prefix_source(kp, vp, prefix_bias, R, Lp, Hkv, D);
  const dim3 grid((Lp + t1::BK - 1) / t1::BK, Hkv * n_split, P);
  return t1::tc::dispatch_dkv(D, p, n_split, grid, dkp, dvp, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one tensor-core S1 block at head dim D, in bytes
// (S2's blocks take t1_flash_bwd_tc_smem_bytes's).
extern "C" int t1_sp_fwd_tc_smem_bytes(int D) {
  return D == 64 || D == 128 ? t1::tc::fwd_smem(D, false) : -1;
}
