// K1: flash attention forward for the decoder's prefill.
//
// Replaces the Pallas kernel `_flash_fwd` / `flash_attention` of
// time_r1_tpu/ops/flash_attention.py (pallas_call at :135). Same contract:
// q (B, Sq, H, D), k/v (B, Skv, Hkv, D) in f32 or bf16, q head h reads kv head
// h / (H / Hkv) (GQA, no repeated K/V), an additive (B, Skv) f32 key bias for
// padding, causal masking at global row q_offset + i, and the (B, H, Sq) f32
// log-sum-exp lse = m + log(max(l, 1e-30)) beside the output.
//
// In the cached prefill Skv is the whole cache buffer (prompt bucket plus the
// decode slots); keys past the written prefix are zeros that the causal
// limit never reaches, so the tile loop stops at the causal limit.
//
// What bounds it on the H100: at the serving shape (B=2, Sq=2048, H=16, D=128)
// the causal product is ~34 GFLOP against ~38 MB of operands, so the bound is
// the arithmetic (tensor cores, 989 TFLOP/s bf16). This first version runs
// plain f32 FMA (67 TFLOP/s peak) out of shared memory, fed by a 4x4
// register tile per thread: it is right and simple, and leaves the tensor
// cores (mma/wgmma with TMA-fed tiles) to a later change. See
// attention_tile.cuh for the tiling.
#include "attention_tile.cuh"

extern "C" int t1_flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                      const float* kv_bias, void* o, float* lse, int B, int Sq,
                                      int Skv, int H, int Hkv, int D, int causal, float scale,
                                      int q_offset, void* stream) {
  t1::AttnParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.bias = kv_bias;
  p.q_batch = (long long)Sq * H * D;
  p.kv_batch = (long long)Skv * Hkv * D;
  p.o_batch = p.q_batch;
  p.bias_batch = Skv;
  p.q_row = H * D;
  p.kv_row = Hkv * D;
  p.o_row = H * D;
  p.Sq = Sq;
  p.Skv = Skv;
  p.H = H;
  p.G = H / Hkv;
  p.causal = causal;
  p.q_offset = q_offset;
  p.scale = scale;
  return t1::dispatch<false>(dtype, D, p, B, static_cast<cudaStream_t>(stream));
}
