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
// What bounds them on the H100: at the prompt shape (q (1, 2048, 16, 128),
// k/v (1, 2048, 2, 128)) the causal backward is ~2.5x the forward's FLOPs
// against a few tens of MB of operands, so the bound is the arithmetic
// (989 TFLOP/s bf16 tensor cores). This first version runs plain f32 FMA out
// of shared memory (attention_bwd.cuh). B2's grid is B * Hkv * Skv/64 blocks
// (64 at the prompt shape, on 132 SMs), each looping over G = 8 q-heads and
// the query tiles past the causal start: the q-head sum stays inside the
// block, so no atomics, at the price of occupancy. Splitting the head loop
// across blocks (f32 atomics) or tensor-core tiles are later changes.
#include "attention_bwd.cuh"

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

}  // namespace

// q, dout, dq (B, Sq, H, D); k, v (B, Skv, Hkv, D); kv_bias (B, Skv) f32;
// lse, delta (B, H, Sq) f32.
extern "C" int t1_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                               const float* kv_bias, const void* dout, const float* lse,
                               const float* delta, void* dq, int B, int Sq, int Skv, int H,
                               int Hkv, int D, int causal, float scale, int q_offset,
                               void* stream) {
  t1::BwdParams p = flash_params(q, k, v, kv_bias, dout, lse, delta, Sq, Skv, H, Hkv, D, causal,
                                 scale, q_offset);
  p.dq = dq;
  const dim3 grid((Sq + t1::BQ - 1) / t1::BQ, H, B);
  return t1::dispatch_bwd(false, dtype, D, p, grid, static_cast<cudaStream_t>(stream));
}

// dk, dv (B, Skv, Hkv, D) f32, written whole (keys no query sees get zeros).
extern "C" int t1_flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                                const float* kv_bias, const void* dout, const float* lse,
                                const float* delta, float* dk, float* dv, int B, int Sq, int Skv,
                                int H, int Hkv, int D, int causal, float scale, int q_offset,
                                void* stream) {
  t1::BwdParams p = flash_params(q, k, v, kv_bias, dout, lse, delta, Sq, Skv, H, Hkv, D, causal,
                                 scale, q_offset);
  p.dk = dk;
  p.dv = dv;
  const dim3 grid((Skv + t1::BK - 1) / t1::BK, Hkv, B);
  return t1::dispatch_bwd(true, dtype, D, p, grid, static_cast<cudaStream_t>(stream));
}
