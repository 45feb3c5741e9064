// B1 and B2: the flash attention backward (K1's VJP) for the decoder's
// differentiable prompt forward, and B2 again for the own-chunk dK/dV of the
// shared-prefix backward (S2).
//
// Replace the Pallas kernels of time_r1_tpu/ops/flash_attention.py:
//   B1 `_flash_bwd_dq`  (pallas_call at :325): dq for a query tile given the
//      GLOBAL lse (B, H, Sq) and delta = rowsum(dO * O);
//   B2 `_flash_bwd_dkv` (grouped pallas_call at :368, per-head at :400): dK/dV
//      in f32, summed over the G q-heads of each kv head.
// The global lse/delta signature is kept so that ring attention can reuse
// both per ring block. Same masking as K1: additive (B, Skv) key bias, causal
// at global row q_offset + i.
//
// Two instances of each, picked by the wrapper by dtype:
// - bf16 (`t1_flash_bwd_dq_tc`, `t1_flash_bwd_dkv_tc`): the tensor-core
//   kernels of attention_bwd_tc.cuh (wgmma, cp.async ring, B2's q heads split
//   over blocks and folded in a fixed order). That header's notes give the
//   bound, the products' instructions and the budget.
// - f32 (`t1_flash_bwd_dq`, `t1_flash_bwd_dkv`): exact f32 FMA out of shared
//   memory (attention_bwd.cuh), so that f32 runs compare with the CPU at 1e-3
//   and below. B2's grid there is B * Hkv * Skv/64 blocks, each looping over
//   the G q-heads inside the block.
#include "attention_bwd_tc.cuh"

namespace {

t1::BwdParams flash_params(const void* q, const void* k, const void* v, const float* kv_bias,
                           const void* dout, const float* lse, const float* delta, int Sq,
                           int Skv, int H, int Hkv, int D, int causal, float scale, int q_offset) {
  t1::BwdParams p{};
  p.q = q;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.Sq = Sq;
  p.H = H;
  p.Hkv = Hkv;
  p.G = H / Hkv;
  p.scale = scale;
  p.n_src = 1;
  p.src[0] = t1::BwdSource{k, v, kv_bias, (long long)Skv * Hkv * D, Hkv * D, Skv, causal, q_offset, 1};
  return p;
}

// The f32 FMA kernels at head dims 64 and 128; -1 for another.
int launch_fma(bool dkv, int D, const t1::BwdParams& p, dim3 grid, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return t1::launch_bwd<float, 64>(dkv, p, grid, s);
    case 128: return t1::launch_bwd<float, 128>(dkv, p, grid, s);
    default: return -1;
  }
}

}  // namespace

// q, dout, dq (B, Sq, H, D) f32; k, v (B, Skv, Hkv, D) f32; kv_bias (B, Skv)
// f32; lse, delta (B, H, Sq) f32.
extern "C" int t1_flash_bwd_dq(const void* q, const void* k, const void* v, const float* kv_bias,
                               const void* dout, const float* lse, const float* delta, void* dq,
                               int B, int Sq, int Skv, int H, int Hkv, int D, int causal,
                               float scale, int q_offset, void* stream) {
  t1::BwdParams p = flash_params(q, k, v, kv_bias, dout, lse, delta, Sq, Skv, H, Hkv, D, causal,
                                 scale, q_offset);
  p.dq = dq;
  return launch_fma(false, D, p, dim3((Sq + t1::BQ - 1) / t1::BQ, H, B), stream);
}

// f32 operands; dk, dv (B, Skv, Hkv, D) f32, written whole (keys no query
// sees get zeros).
extern "C" int t1_flash_bwd_dkv(const void* q, const void* k, const void* v, const float* kv_bias,
                                const void* dout, const float* lse, const float* delta, float* dk,
                                float* dv, int B, int Sq, int Skv, int H, int Hkv, int D,
                                int causal, float scale, int q_offset, void* stream) {
  t1::BwdParams p = flash_params(q, k, v, kv_bias, dout, lse, delta, Sq, Skv, H, Hkv, D, causal,
                                 scale, q_offset);
  p.dk = dk;
  p.dv = dv;
  return launch_fma(true, D, p, dim3((Skv + t1::BK - 1) / t1::BK, Hkv, B), stream);
}

// bf16 q, k, v, dout, dq; the rest as t1_flash_bwd_dq. The tensor-core kernels.
extern "C" int t1_flash_bwd_dq_tc(const void* q, const void* k, const void* v, const float* kv_bias,
                                  const void* dout, const float* lse, const float* delta, void* dq,
                                  int B, int Sq, int Skv, int H, int Hkv, int D, int causal,
                                  float scale, int q_offset, void* stream) {
  t1::BwdParams p = flash_params(q, k, v, kv_bias, dout, lse, delta, Sq, Skv, H, Hkv, D, causal,
                                 scale, q_offset);
  p.dq = dq;
  const dim3 grid((Sq + t1::BQ - 1) / t1::BQ, H, B);
  return t1::tc::dispatch_dq(D, p, grid, static_cast<cudaStream_t>(stream));
}

// bf16 q, k, v, dout; dk, dv (B, Skv, Hkv, D) f32. The G q heads of each kv
// head are split over n_split blocks; with n_split > 1 part_dk/part_dv
// (n_split, B, Skv, Hkv, D) f32 take the blocks' sums, folded into dk/dv in a
// fixed order (they may be null when n_split == 1).
extern "C" int t1_flash_bwd_dkv_tc(const void* q, const void* k, const void* v,
                                   const float* kv_bias, const void* dout, const float* lse,
                                   const float* delta, float* dk, float* dv, float* part_dk,
                                   float* part_dv, int n_split, int B, int Sq, int Skv, int H,
                                   int Hkv, int D, int causal, float scale, int q_offset,
                                   void* stream) {
  if (n_split < 1 || (H / Hkv) % n_split != 0) return -1;
  t1::BwdParams p = flash_params(q, k, v, kv_bias, dout, lse, delta, Sq, Skv, H, Hkv, D, causal,
                                 scale, q_offset);
  p.dk = n_split > 1 ? part_dk : dk;
  p.dv = n_split > 1 ? part_dv : dv;
  const dim3 grid((Skv + t1::BK - 1) / t1::BK, Hkv * n_split, B);
  return t1::tc::dispatch_dkv(D, p, n_split, grid, dk, dv, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one tensor-core block at head dim D, in bytes.
extern "C" int t1_flash_bwd_tc_smem_bytes(int D) {
  return D == 64 ? t1::tc::smem_bytes<64>() : D == 128 ? t1::tc::smem_bytes<128>() : -1;
}
