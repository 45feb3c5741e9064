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
// the causal product is ~25 GFLOP of live pairs against ~38 MB of operands,
// so the bound is the arithmetic (tensor cores, 989 TFLOP/s bf16). Two
// instances, picked by the wrapper by dtype:
// - bf16 (`t1_flash_attention_fwd_tc`): the tensor-core forward of
//   attention_fwd_tc.cuh (wgmma, a cp.async/mbarrier ring, the online softmax
//   on the accumulators) with one key source; its notes give the design and
//   the budget;
// - f32 (`t1_flash_attention_fwd`): exact f32 FMA (attention_tile.cuh), so
//   that f32 runs compare with the CPU at 1e-4 and below.
#include "attention_fwd_tc.cuh"
#include "attention_tile.cuh"

// K1, f32 q, k, v, o. kv_bias (B, Skv) and lse (B, H, Sq) f32.
extern "C" int t1_flash_attention_fwd(const void* q, const void* k, const void* v,
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
  return t1::dispatch<float, false>(D, p, B, static_cast<cudaStream_t>(stream));
}

// K1, bf16 q, k, v, o (16-byte aligned); the rest as t1_flash_attention_fwd.
// The tensor-core kernel.
extern "C" int t1_flash_attention_fwd_tc(const void* q, const void* k, const void* v,
                                         const float* kv_bias, void* o, float* lse, int B, int Sq,
                                         int Skv, int H, int Hkv, int D, int causal, float scale,
                                         int q_offset, void* stream) {
  t1::tc::FwdParams p{};
  p.q = q;
  p.o = o;
  p.lse = lse;
  p.Sq = Sq;
  p.H = H;
  p.G = H / Hkv;
  p.scale = scale;
  p.n_src = 1;
  p.src[0] = t1::BwdSource{k, v, kv_bias, (long long)Skv * Hkv * D, Hkv * D, Skv, causal, q_offset, 1};
  return t1::tc::dispatch_fwd<false>(D, p, B, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one tensor-core K1 block at head dim D, in bytes.
extern "C" int t1_flash_attention_fwd_tc_smem_bytes(int D) { return t1::tc::fwd_smem(D, false); }
