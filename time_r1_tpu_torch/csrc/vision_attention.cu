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
// operands, so its bound is the bytes (~50 us at 3.35 TB/s); K3 does ~31
// GFLOP over ~140 MB, bytes and tensor-core arithmetic about even. Instances:
// - K3 in bf16 (`t1_full_attention_rope_fwd_tc`): the tensor-core forward of
//   attention_fwd_tc.cuh with its ROPE flag (Q and each K tile roped in
//   shared memory, in f32, and rounded to bf16 before wgmma; two 64-row query
//   tiles a block share each roped K tile; head dim 80 in a 64-column block
//   and a 16-column tail, no padded products);
// - K3 in f32 and K2 in both dtypes: the FMA tiles of attention_tile.cuh
//   (f32 operands in shared memory, 4x4 register tiles), exact in f32 so
//   that f32 runs compare with the CPU; K2 runs FMA in bf16 too, bound by
//   the FMA rate instead of its bytes.
#include "attention_fwd_tc.cuh"
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
  if (dtype != 0 && dtype != 1) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype ? t1::dispatch<__nv_bfloat16, true>(hd, p, P / win, st) : t1::dispatch<float, true>(hd, p, P / win, st);
}

// K3, f32 q, k, v, o (n_slices, S, nh, hd); cos, sin (n_slices, S, hd) and
// key_bias (n_slices, S) f32.
extern "C" int t1_full_attention_rope_fwd(const void* q, const void* k, const void* v,
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
  return t1::dispatch<float, true>(hd, p, n_slices, static_cast<cudaStream_t>(stream));
}

// K3, bf16 q, k, v, o (16-byte aligned; cos/sin too); the rest as
// t1_full_attention_rope_fwd. The tensor-core kernel.
extern "C" int t1_full_attention_rope_fwd_tc(const void* q, const void* k, const void* v,
                                             const float* cos, const float* sin,
                                             const float* key_bias, void* o, int n_slices, int S,
                                             int nh, int hd, float scale, void* stream) {
  t1::tc::FwdParams p{};
  p.q = q;
  p.o = o;
  p.cos = cos;
  p.sin = sin;
  p.Sq = S;
  p.H = nh;
  p.G = 1;
  p.scale = scale;
  p.n_src = 1;
  p.src[0] = t1::BwdSource{k, v, key_bias, (long long)S * nh * hd, nh * hd, S, 0, 0, 1};
  return t1::tc::dispatch_fwd<true>(hd, p, n_slices, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one tensor-core K3 block at head dim D, in bytes.
extern "C" int t1_full_attention_rope_fwd_tc_smem_bytes(int D) { return t1::tc::fwd_smem(D, true); }
