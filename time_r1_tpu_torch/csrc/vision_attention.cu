// K2 and K3: rope + attention for the vision tower.
//
// K2, window attention: replaces `window_attention_rope` of
// time_r1_tpu/ops/vision_attention.py (pallas_call at :140), run by the 28
// window layers of the ViT. q/k/v (P, nh, hd) pre-rope, cos/sin (P, hd) f32,
// key bias (P,) f32; P is a whole number of windows of `win` rows. The TPU
// kernel packs two 64-patch windows into one 128-row block with a
// block-diagonal mask to fill its 128x128 matrix unit; here a window is one
// 64-row tile, without the masked half.
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
// live patch rows in 252 windows, 16 heads of 80) K2 does ~5 GFLOP over
// ~165 MB of bf16 operands, so its bound is the bytes (~50 us at 3.35
// TB/s); K3 does ~31 GFLOP over ~140 MB, bytes and tensor-core arithmetic
// about even. Instances:
// - K2 in bf16 (`t1_window_attention_rope_fwd_tc`): one block per window,
//   one warpgroup, looping over all the heads. A Qwen2.5-VL window is 64
//   rows (window_patches² · merge_unit = 4² · 4), so each (window, head) is
//   one 64 x 64 query/key tile and the softmax needs no running max. The
//   window's 64 rows of cos/sin are staged once per block and serve Q and K
//   of every head: ~10 MB of cos/sin for the 252 windows, where K3's kernel
//   would stage them again for every (slice, head) (~165 MB). Q, K and V of head j + 2 stream in by cp.async into the
//   stage head j frees (a ring of two), so a head's copies run under the
//   previous head's products. Per head: Q (times hd^-0.5) and K roped in f32
//   in shared memory and rounded to bf16 (attention_fwd_tc.cuh's
//   rope_tile_inplace, the chunk-pair map of K3), S = Q K^T with m64n64k16
//   (a fifth k16 step on the 32-byte-swizzled tail at hd = 80), the key bias
//   and the softmax on S's f32 accumulator in registers, P rounded to bf16
//   as the A fragment of O = P V (m64n64k16 plus m64n16k16 at hd = 80),
//   normalised by the unrounded row sum and stored in bf16. Head dims 64, 80
//   and 128; windows of up to 64 rows (keys past the window masked).
// - K3 in bf16 (`t1_full_attention_rope_fwd_tc`): the tensor-core forward of
//   attention_fwd_tc.cuh with its ROPE flag (Q and each K tile roped in
//   shared memory, in f32, and rounded to bf16 before wgmma; two 64-row query
//   tiles a block share each roped K tile; head dim 80 in a 64-column block
//   and a 16-column tail, no padded products);
// - K2 and K3 in f32: the FMA tiles of attention_tile.cuh (f32 operands in
//   shared memory, 4x4 register tiles), exact, so that f32 runs compare
//   with the CPU.
#include "attention_fwd_tc.cuh"
#include "attention_tile.cuh"

namespace t1 {
namespace tc {

struct WindowParams {
  const bf16* q;  // (P, nh, D) bf16, pre-rope; P = n_windows · win rows
  const bf16* k;
  const bf16* v;
  bf16* o;
  const float* cos;   // (P, D) f32
  const float* sin;
  const float* bias;  // (P,) f32 additive key bias
  int nh;
  int win;  // rows of a window, <= 64
  float scale;
};

// Two stages of (Q, K, V) head tiles, the window's 64 rows of cos and sin,
// 64 bias values, 1 KB of alignment.
template <int D>
__host__ __device__ constexpr int window_smem_bytes() {
  return 1024 + 6 * tile_bytes<D>() + 2 * 64 * rope_stride<D>() * 4 + 256;
}

// K2 in bf16: one block per window, one warpgroup, every head in turn.
template <int D>
__global__ void __launch_bounds__(WG, 2) window_attn_tc(const __grid_constant__ WindowParams p) {
  constexpr int TILE = tile_bytes<D>();
  constexpr int DM = main_cols<D>();
  constexpr int DT = D - DM;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // stage st: Q, K, V at base + (3 st + 0, 1, 2) TILE
  const uint32_t sCS = base + 6 * TILE;          // cos rows 0..63, then sin rows
  const uint32_t sBias = sCS + 2 * 64 * rope_stride<D>() * 4;
  const float* cs = reinterpret_cast<const float*>(smem_raw + (sCS - raw));
  const float* kb = reinterpret_cast<const float*>(smem_raw + (sBias - raw));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long row0 = (long long)blockIdx.x * p.win;
  const int row_stride = p.nh * D;

  auto load_head = [&](int j) {
    const uint32_t dst = base + 3 * (j & 1) * TILE;
    const long long off = row0 * row_stride + (long long)j * D;
    load_tile<D>(dst, p.q + off, row_stride, 0, p.win);
    load_tile<D>(dst + TILE, p.k + off, row_stride, 0, p.win);
    load_tile<D>(dst + 2 * TILE, p.v + off, row_stride, 0, p.win);
  };

  // group 0: the window's cos/sin and bias with the first head's tiles; group 1: the second head's
  load_rope_rows<D>(sCS, p.cos + row0 * D, p.sin + row0 * D, 0, p.win);
  if (tid < p.win) cp_async4(sBias + 4 * tid, p.bias + row0 + tid, true);
  load_head(0);
  cp_async_commit();
  if (p.nh > 1) load_head(1);
  cp_async_commit();

  const int r0 = warp * 16 + (lane >> 2);  // the thread's rows: r0 and r0 + 8
  for (int j = 0; j < p.nh; ++j) {
    const uint32_t sQ = base + 3 * (j & 1) * TILE;
    const uint32_t sK = sQ + TILE;
    const uint32_t sV = sK + TILE;
    cp_async_wait<1>();
    __syncthreads();  // head j's tiles (and the cos/sin) have landed
    rope_tile_inplace<D>(smem_raw, raw, sQ, cs, p.scale);
    rope_tile_inplace<D>(smem_raw, raw, sK, cs, 1.f);
    fence_proxy_async();
    __syncthreads();

    float s[32];
    wgmma_fence();
    scores<D>(s, sQ, sK);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // one 64-key tile: the whole window, so the softmax needs no running max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * jj + 2 * (lane & 3) + (e & 1);
        const float x = col < p.win ? s[4 * jj + e] + kb[col] : -INFINITY;  // past the window: no weight
        s[4 * jj + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = __expf(s[4 * jj + e] - mx[e >> 1]);
        s[4 * jj + e] = pr;
        l[e >> 1] += pr;
      }
    float o[DM / 2], ot[DT ? DT / 2 : 1];
#pragma unroll
    for (int i = 0; i < DM / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DT / 2; ++i) ot[i] = 0.f;
    uint32_t a[4][4];
    to_afrag(s, a);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<DM>(o, a[kk], mnmajor(sV, kk));
      if constexpr (DT > 0) wgmma_rs_n16(ot, a[kk], mnmajor_tail(sV + 8192, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    if constexpr (DT > 0) fence_regs(ot);

    bf16* og = p.o + row0 * row_stride + (long long)j * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const float inv = 1.f / li;  // >= 1: the row's largest score has weight 1
      const int row = r0 + 8 * i;
      if (row < p.win) {
        bf16* dst = og + (long long)row * row_stride + 2 * (lane & 3);
#pragma unroll
        for (int jj = 0; jj < DM / 8; ++jj)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jj) =
              __floats2bfloat162_rn(o[4 * jj + 2 * i] * inv, o[4 * jj + 2 * i + 1] * inv);
#pragma unroll
        for (int jj = 0; jj < DT / 8; ++jj)
          *reinterpret_cast<__nv_bfloat162*>(dst + DM + 8 * jj) =
              __floats2bfloat162_rn(ot[4 * jj + 2 * i] * inv, ot[4 * jj + 2 * i + 1] * inv);
      }
    }
    __syncthreads();  // every warp is done with stage j & 1
    if (j + 2 < p.nh) load_head(j + 2);
    cp_async_commit();
  }
}

template <int D>
int launch_window(const WindowParams& p, int n_windows, cudaStream_t stream) {
  constexpr int smem = window_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(window_attn_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  window_attn_tc<D><<<n_windows, WG, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace t1

// K2, f32 q, k, v, o (P, nh, hd); cos, sin (P, hd) and key_bias (P,) f32; P
// a whole number of windows of `win` rows. The exact FMA kernel.
extern "C" int t1_window_attention_rope_fwd(const void* q, const void* k, const void* v, const float* cos,
                                            const float* sin, const float* key_bias, void* o, int P, int nh,
                                            int hd, int win, float scale, void* stream) {
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
  return t1::dispatch<float, true>(hd, p, P / win, static_cast<cudaStream_t>(stream));
}

// K2, bf16 q, k, v, o (16-byte aligned; cos/sin too), windows of win <= 64
// rows; the rest as t1_window_attention_rope_fwd. The tensor-core kernel.
extern "C" int t1_window_attention_rope_fwd_tc(const void* q, const void* k, const void* v, const float* cos,
                                               const float* sin, const float* key_bias, void* o, int P, int nh,
                                               int hd, int win, float scale, void* stream) {
  if (win <= 0 || win > 64 || P % win != 0) return -2;
  t1::tc::WindowParams p{static_cast<const t1::tc::bf16*>(q), static_cast<const t1::tc::bf16*>(k),
                         static_cast<const t1::tc::bf16*>(v), static_cast<t1::tc::bf16*>(o), cos, sin, key_bias,
                         nh, win, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return t1::tc::launch_window<64>(p, P / win, st);
    case 80: return t1::tc::launch_window<80>(p, P / win, st);
    case 128: return t1::tc::launch_window<128>(p, P / win, st);
    default: return -1;
  }
}

// Dynamic shared memory of one tensor-core K2 block at head dim D, in bytes.
extern "C" int t1_window_attention_rope_fwd_tc_smem_bytes(int D) {
  switch (D) {
    case 64: return t1::tc::window_smem_bytes<64>();
    case 80: return t1::tc::window_smem_bytes<80>();
    case 128: return t1::tc::window_smem_bytes<128>();
    default: return -1;
  }
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
