// Tensor-core attention forward with an online softmax, for bf16 operands on
// Hopper (sm_90a): `attn_fwd_tc`, instantiated from shared_prefix_attention.cu
// for S1. The f32 S1 and K1-K3 keep the FMA tiles of attention_tile.cuh.
//
// Replaces the Pallas kernel `_sp_fwd` of time_r1_tpu/ops/flash_attention.py
// (pallas_call at :575): query row b attends [the prefix of prompt b / R,
// masked by its (P, Lp) additive f32 bias | its own causal chunk] with one
// softmax over both, GQA (q head h reads kv head h / G), out in bf16 and the
// log-sum-exp (B, H, Sq) in f32 with attention_tile.cuh's `store_out`
// convention (lse = m + log max(l, 1e-30); keys hidden by a bias or the causal
// mask score NEG_INF, keys past the end -inf). Head dims 64 and 128. The
// prefix K/V are read in place, once per prompt: nothing is repeated or
// concatenated in device memory.
//
// The interface is general enough for K1: `FwdParams` walks n_src key sources
// (attention_bwd.cuh's `BwdSource`: an additive key bias, causal with a
// q_offset, R query batch entries per kv entry) in order.
//
// What bounds it on the H100: the arithmetic. At the split-loss shape (q (8,
// 256, 16, 128) over a (1, 2048, 2, 128) prefix with 134 pad keys and an own
// chunk of 256) it does 34.3 GFLOP of products against ~17 MB of operands, so
// the bound is the bf16 tensor cores' 989 TFLOP/s (0.035 ms).
//
// One warpgroup (128 threads) per 64-row query tile of one (b, h): grid
// (ceil(Sq/64), H, B), block x taking query tile n_qt - 1 - x (the heaviest
// causal tiles first). Both products are `wgmma.mma_async` with bf16 inputs
// and f32 accumulators:
//   S = Q K^T   m64n64k16, A = Q and B = the K tile from shared memory, both K-major
//   O += P V    m64nDk16,  A = P in registers, B = the V tile (MN-major)
// The scale, the bias, the masks (only on tiles that cross the diagonal or a
// ragged edge), the running max and the running sum act on S's f32
// accumulator; each thread's two rows are reduced over its quad with
// shuffles. P is rounded to bf16 in registers as the A fragment of the second
// product (an accumulator's layout is its A fragment's), after O is rescaled
// by exp(m_old - m_new); P never touches shared memory. q stays unscaled in
// bf16: the scale multiplies S in f32. The running sum adds the unrounded f32
// P, as FA-2 and FA-3 do.
//
// Q is resident; K, V and the 64 bias values of each key tile stream through
// a ring of two stages of `cp.async` copies, each completed on an mbarrier,
// so the next tile loads while this one computes; the ring walks source 0's
// tiles (the prefix), then source 1's (the own chunk, up to the diagonal).
//
// Budget (D = 128): shared memory 5 tiles x 16 KB + 512 B of bias + the
// barriers + 1 KB of alignment = 83,520 bytes, so two blocks fit on an SM;
// registers under __launch_bounds__(128, 2): O is 64 f32, S 32 f32. ptxas's
// report per instance is in PERF.md.
#pragma once

#include "attention_bwd.cuh"
#include "wgmma_tile.cuh"

namespace t1 {
namespace tc {

struct FwdParams {
  const void* q;  // (B, Sq, H, D) bf16, contiguous
  void* o;        // (B, Sq, H, D) bf16
  float* lse;     // (B, H, Sq)
  int Sq;
  int H;
  int G;          // q heads per kv head
  float scale;
  int n_src;      // key sources (1 or 2), walked in order
  BwdSource src[2];
};

// Q resident, two stages of K and V, 2 x 64 f32 of bias, two mbarriers, 1 KB of alignment.
template <int D>
__host__ __device__ constexpr int fwd_smem_bytes() { return 5 * tile_bytes<D>() + 512 + 64 + 1024; }

template <int D>
__global__ void __launch_bounds__(WG, 2) attn_fwd_tc(const __grid_constant__ FwdParams p) {
  constexpr int TILE = tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sQ = base;  // stage st: K at base + (1 + 2st) TILE, V one tile on
  const uint32_t sBias = base + 5 * TILE;
  const float* bias_s = reinterpret_cast<const float*>(smem_raw + (sBias - raw));
  const uint32_t bars = sBias + 512;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q_row = p.H * D;
  const long long q_off = (long long)b * p.Sq * q_row + (long long)h * D;

  auto n_tiles = [&](const BwdSource& s) {
    return s.causal ? causal_tiles(s.Skv, p.Sq, q0, s.q_offset) : (s.Skv + BK - 1) / BK;
  };
  const int n_t0 = n_tiles(p.src[0]);
  const int total = n_t0 + (p.n_src > 1 ? n_tiles(p.src[1]) : 0);

  // key tile t into stage t & 1
  auto load_kv = [&](int t) {
    const int si = t < n_t0 ? 0 : 1;
    const BwdSource& s = p.src[si];
    const int k0 = (t - (si ? n_t0 : 0)) * BK;
    const long long entry = b / s.R;
    const long long kv_off = entry * s.kv_batch + (long long)(h / p.G) * D;
    const int st = t & 1;
    load_tile<D>(base + (1 + 2 * st) * TILE, static_cast<const bf16*>(s.k) + kv_off, s.kv_row, k0, s.Skv);
    load_tile<D>(base + (2 + 2 * st) * TILE, static_cast<const bf16*>(s.v) + kv_off, s.kv_row, k0, s.Skv);
    if (tid < BK) {
      const int key = k0 + tid;
      const bool ok = s.bias != nullptr && key < s.Skv;
      cp_async4(sBias + (st * BK + tid) * 4, ok ? s.bias + entry * s.Skv + key : p.lse, ok);
    }
    mbar_arrive_copies(bars + 8 * st);
  };

  mbar_init_all(bars, 2);
  load_tile<D>(sQ, static_cast<const bf16*>(p.q) + q_off, q_row, q0, p.Sq);
  load_kv(0);  // every query tile sees at least one key tile (Skv >= 1)
  if (total > 1) load_kv(1);

  const int r0 = warp * 16 + (lane >> 2);  // the thread's rows: r0 and r0 + 8
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // the thread's share of the row sums; the quad's are added at the end

  for (int t = 0; t < total; ++t) {
    const int st = t & 1;
    const uint32_t sK = base + (1 + 2 * st) * TILE;
    const uint32_t sV = sK + TILE;
    mbar_wait(bars + 8 * st, (t >> 1) & 1);
    fence_proxy_async();
    __syncthreads();

    float s[32];
    wgmma_fence();
    scores<D>(s, sQ, sK);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    const int si = t < n_t0 ? 0 : 1;
    const BwdSource& src = p.src[si];
    const int k0 = (t - (si ? n_t0 : 0)) * BK;
    const bool edge = (src.causal && k0 + BK - 1 > q0 + src.q_offset) || k0 + BK > src.Skv;
    const float* kb = bias_s + st * BK;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int col = 8 * j + 2 * (lane & 3) + (e & 1);
        float x = fmaf(s[4 * j + e], p.scale, kb[col]);
        if (edge) {
          const int key = k0 + col;
          if (key >= src.Skv)
            x = -INFINITY;  // past the end: no weight at all
          else if (src.causal && key > q0 + r0 + 8 * i + src.q_offset)
            x = NEG_INF;
        }
        s[4 * j + e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = __expf(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = __expf(s[4 * j + e] - m[e >> 1]);
        s[4 * j + e] = pr;
        l[e >> 1] += pr;
      }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j + 0] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    uint32_t a[4][4];
    to_afrag(s, a);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(o, a[kk], mnmajor(sV, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncthreads();  // every warp is done with stage st
    if (t + 2 < total) load_kv(t + 2);
  }

  bf16* og = static_cast<bf16*>(p.o) + q_off;
  float* lse = p.lse + ((long long)b * p.H + h) * p.Sq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = q0 + r0 + 8 * i;
    const float l_safe = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / l_safe;
    if (row < p.Sq) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(og + (long long)row * q_row + 8 * j + 2 * (lane & 3)) =
            __floats2bfloat162_rn(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
      if ((lane & 3) == 0) lse[row] = m[i] + logf(l_safe);
    }
  }
}

template <int D>
cudaError_t launch_fwd(const FwdParams& p, dim3 grid, cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  attn_fwd_tc<D><<<grid, WG, smem, stream>>>(p);
  return cudaGetLastError();
}

// Head dims 64 and 128; -1 for another.
inline int dispatch_fwd(int D, const FwdParams& p, dim3 grid, cudaStream_t stream) {
  switch (D) {
    case 64: return launch_fwd<64>(p, grid, stream);
    case 128: return launch_fwd<128>(p, grid, stream);
    default: return -1;
  }
}

}  // namespace tc
}  // namespace t1
