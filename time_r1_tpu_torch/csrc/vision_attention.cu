// K2 and K3: rope + attention for the vision tower.
//
// K2, window attention: replaces `window_attention_rope` of
// time_r1_tpu/ops/vision_attention.py (pallas_call at :140), run by the 28
// window layers of the ViT. q/k/v (P, nh, hd) pre-rope, cos/sin (P, hd) f32,
// key bias (P,) f32; P is a whole number of windows of `win` rows. The TPU
// kernel packs two 64-patch windows into one 128-row block with a
// block-diagonal mask to fill its 128x128 matrix unit; here one block per
// (window, head) is the same function without the masked half.
//
// K3, full-slice attention: replaces `full_attention_rope` (pallas_call at
// :233), run by the 4 full-attention layers. q/k/v (n_slices, S, nh, hd),
// cos/sin (n_slices, S, hd), key bias (n_slices, S) with the pad slots of a
// slice masked. One block per (slice, head, 64-row q tile) with an online
// softmax over 64-key tiles, so any slice length fits: the JAX cap
// FULL_KERNEL_MAX_SLICE = 1536 was a VMEM limit and does not apply.
//
// Both apply the 2D rope in the kernel as the TPU kernels do: rotate_half at
// hd/2 = 40 is the index (d + 40) % 80 with a sign (the TPU used a lane
// roll), q is scaled by hd^-0.5 after the rope, in f32, and k is re-roped as
// each key tile is loaded.
//
// What bounds them on the H100: at the serving shape (two videos, 15104
// patch rows, 16 heads of 80) K2 does ~5 GFLOP over ~165 MB of bf16
// operands, so its bound is the bytes (~50 us at 3.35 TB/s); K3 does ~36
// GFLOP over ~175 MB, bytes and tensor-core arithmetic about even. The shared
// tile code (attention_tile.cuh) runs plain f32 FMA, so today both are bound
// by the FMA rate instead; tensor cores come in a later change.
#include "attention_tile.cuh"

extern "C" int t1_window_attention_rope_fwd(int dtype, const void* q, const void* k,
                                            const void* v, const float* cos, const float* sin,
                                            const float* key_bias, void* o, int P, int nh, int hd,
                                            int win, float scale, void* stream) {
  if (win <= 0 || P % win != 0) return -2;
  t1::AttnParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.bias = key_bias;
  p.cos = cos;
  p.sin = sin;
  p.q_batch = (long long)win * nh * hd;
  p.kv_batch = p.q_batch;
  p.o_batch = p.q_batch;
  p.bias_batch = win;
  p.rope_batch = win;
  p.q_row = nh * hd;
  p.kv_row = nh * hd;
  p.o_row = nh * hd;
  p.Sq = win;
  p.Skv = win;
  p.H = nh;
  p.G = 1;
  p.scale = scale;
  return t1::dispatch<true>(dtype, hd, p, P / win, static_cast<cudaStream_t>(stream));
}

extern "C" int t1_full_attention_rope_fwd(int dtype, const void* q, const void* k, const void* v,
                                          const float* cos, const float* sin,
                                          const float* key_bias, void* o, int n_slices, int S,
                                          int nh, int hd, float scale, void* stream) {
  t1::AttnParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.bias = key_bias;
  p.cos = cos;
  p.sin = sin;
  p.q_batch = (long long)S * nh * hd;
  p.kv_batch = p.q_batch;
  p.o_batch = p.q_batch;
  p.bias_batch = S;
  p.rope_batch = S;
  p.q_row = nh * hd;
  p.kv_row = nh * hd;
  p.o_row = nh * hd;
  p.Sq = S;
  p.Skv = S;
  p.H = nh;
  p.G = 1;
  p.scale = scale;
  return t1::dispatch<true>(dtype, hd, p, n_slices, static_cast<cudaStream_t>(stream));
}
