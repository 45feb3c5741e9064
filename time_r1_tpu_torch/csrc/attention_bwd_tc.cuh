// Tensor-core FlashAttention-2 backward for bf16 operands on Hopper (sm_90a):
// B1 `attn_bwd_dq_tc`, B2 `attn_bwd_dkv_tc` and B2's fold `fold_dkv_partials`,
// instantiated from flash_attention_bwd.cu (B1, B2) and from
// shared_prefix_attention.cu (S2's dq and prefix dK/dV). The f32 paths keep
// the exact f32 FMA kernels of attention_bwd.cuh. The copy, descriptor and
// wgmma helpers are in wgmma_tile.cuh.
//
// Replace the Pallas kernels of time_r1_tpu/ops/flash_attention.py:
//   B1 `_flash_bwd_dq`  (pallas_call at :325),
//   B2 `_flash_bwd_dkv` (grouped pallas_call at :368, per-head at :400),
//   S2 `_sp_vjp_bwd`'s dq (:739, two key sources) and prefix dK/dV (:769,
//      R rows per kv entry).
// Same function as attention_bwd.cuh: the GLOBAL lse (B, H, Sq) and delta
// (given here as (B, H, Sq)), an additive f32 key bias, causal masking at
// global row q_offset + i, GQA (q head h reads kv head h / G; dK/dV summed
// over the G q heads in f32), any Sq and Skv (ragged edges masked), head dims
// 64 and 128.
//
// What bounds them on the H100: the arithmetic. At the prompt shape (q (1,
// 2048, 16, 128), k/v (1, 2048, 2, 128)) B1 does 22.5 and B2 30.0 GFLOP of
// causal products against ~20 MB of operands, so the bound is the bf16
// tensor cores' 989 TFLOP/s (0.023 and 0.030 ms).
//
// Every product is one warpgroup's `wgmma.mma_async` with bf16 inputs and f32
// accumulators, 64 rows of M:
//   B1, M = 64 query rows:  S = Q K^T, dP = dO V^T    m64n64k16, A and B from smem (K-major)
//                           dQ += dS K                m64nDk16, A = dS in registers, B = K (MN-major)
//   B2, M = 64 keys:        S^T = K Q^T, dP^T = V dO^T m64n64k16, A and B from smem (K-major)
//                           dV += P^T dO, dK += dS^T Q m64nDk16, A in registers, B MN-major
// Each score's orientation is chosen so that its f32 accumulator, rounded to
// bf16, is already the register A operand of the next product (a wgmma
// accumulator's layout is its A fragment's), so P and dS never touch shared
// memory. Q, K, V and dO are read in the D-contiguous layout in which they
// were loaded; the transpose bit of B picks K-major or MN-major. P and dS are
// rounded to bf16 before their products, as FA-2 and FA-3 do; the scale, the
// bias, the mask, exp(s - lse) and dP - delta act on the f32 accumulators, q
// stays unscaled, and the scale multiplies S and dQ/dK in f32.
//
// Tiles stay bf16 in shared memory, 64 rows x D as D/64 blocks of 64 x 64
// with the 128-byte swizzle that the wgmma descriptors name. Copies are
// `cp.async` into a ring of two stages, each completed on an mbarrier
// (`cp.async.mbarrier.arrive.noinc`), so the next tile loads while this one
// computes. B1 keeps Q and dO resident and streams K, V and the key bias; B2
// keeps K and V resident and streams Q, dO, lse and delta.
//
// B1 grid (ceil(Sq/64), H, B): block x takes query tile n_qt - 1 - x, so the
// heaviest causal tiles start first; only tiles that cross the diagonal or a
// ragged edge run the masks. B2 grid (ceil(Skv/64), Hkv * n_split, kv
// entries): the R * G (query row, q head) pairs that read a kv head of an
// entry (R = 1 for B2, the R rollout rows of a prompt for S2's prefix) are
// split over n_split blocks in order (the wrapper picks n_split to fill the
// card), each writing f32 partial dK/dV (n_split, entries, Skv, Hkv, D);
// `fold_dkv_partials` sums them in a fixed order. No atomics: two launches
// give bit-equal results. With n_split = 1 the block writes dK/dV itself.
//
// Budget (D = 128): one warpgroup of 128 threads; shared memory 6 tiles x 16
// KB + 2 KB = 100,416 bytes, so two blocks fit on an SM; registers under
// __launch_bounds__(128, 2) (B2 holds dK and dV, 128 f32, plus S^T and dP^T,
// 64 f32). ptxas's report per instance is in PERF.md.
//
// The interface is attention_bwd.cuh's BwdParams: the dq kernel walks
// p.n_src key sources (S2: the prefix, then the own causal chunk), and the
// dkv kernel sums over the R query rows of each kv entry.
#pragma once

#include "attention_bwd.cuh"
#include "wgmma_tile.cuh"

namespace t1 {
namespace tc {

// Q/dO (or K/V) resident, two stages of two streamed tiles, 1 KB of streamed
// f32 rows (B1: bias; B2: lse and delta), two mbarriers, 1 KB of alignment.
template <int D>
__host__ __device__ constexpr int smem_bytes() { return 6 * tile_bytes<D>() + 1024 + 64 + 1024; }

// ---- B1: dq

template <int D>
__global__ void __launch_bounds__(WG, 2) attn_bwd_dq_tc(const __grid_constant__ BwdParams p) {
  constexpr int TILE = tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sdO = base + TILE;  // stage st: K at base + (2 + 2st) TILE, V one tile on
  const uint32_t sBias = base + 6 * TILE;
  const float* bias_s = reinterpret_cast<const float*>(smem_raw + (sBias - raw));
  const uint32_t bars = sBias + 1024;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q_row = p.H * D;
  const long long q_off = (long long)b * p.Sq * q_row + (long long)h * D;

  auto n_tiles = [&](const BwdSource& s) {
    return s.causal ? causal_tiles(s.Skv, p.Sq, q0, s.q_offset) : (s.Skv + BK - 1) / BK;
  };
  const int n_t0 = n_tiles(p.src[0]);  // key tiles of source 0, then of source 1
  const int total = n_t0 + (p.n_src > 1 ? n_tiles(p.src[1]) : 0);

  // tile t into stage t & 1
  auto load_kv = [&](int t) {
    const int si = t < n_t0 ? 0 : 1;
    const BwdSource& s = p.src[si];
    const int k0 = (t - (si ? n_t0 : 0)) * BK;
    const long long entry = b / s.R;
    const long long kv_off = entry * s.kv_batch + (long long)(h / p.G) * D;
    const int st = t & 1;
    load_tile<D>(base + (2 + 2 * st) * TILE, static_cast<const bf16*>(s.k) + kv_off, s.kv_row, k0, s.Skv);
    load_tile<D>(base + (3 + 2 * st) * TILE, static_cast<const bf16*>(s.v) + kv_off, s.kv_row, k0, s.Skv);
    if (tid < BK) {
      const int key = k0 + tid;
      const bool ok = s.bias != nullptr && key < s.Skv;
      cp_async4(sBias + (st * BK + tid) * 4, ok ? s.bias + entry * s.Skv + key : p.lse, ok);
    }
    mbar_arrive_copies(bars + 8 * st);
  };

  mbar_init_all(bars, 2);
  load_tile<D>(sQ, static_cast<const bf16*>(p.q) + q_off, q_row, q0, p.Sq);
  load_tile<D>(sdO, static_cast<const bf16*>(p.dout) + q_off, q_row, q0, p.Sq);
  load_kv(0);  // every query tile sees at least one key tile (Skv >= 1)
  if (total > 1) load_kv(1);

  const long long bh = ((long long)b * p.H + h) * p.Sq;
  const int r0 = warp * 16 + (lane >> 2);  // the thread's rows: r0 and r0 + 8
  float lse[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    lse[i] = row < p.Sq ? p.lse[bh + row] : 0.f;
    dl[i] = row < p.Sq ? p.delta[bh + row] : 0.f;
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  for (int t = 0; t < total; ++t) {
    const int st = t & 1;
    const uint32_t sK = base + (2 + 2 * st) * TILE;
    const uint32_t sV = sK + TILE;
    mbar_wait(bars + 8 * st, (t >> 1) & 1);
    fence_proxy_async();
    __syncthreads();

    float s[32], dp[32];
    wgmma_fence();
    scores<D>(s, sQ, sK);
    scores<D>(dp, sdO, sV);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    const int si = t < n_t0 ? 0 : 1;
    const BwdSource& src = p.src[si];
    const int k0 = (t - (si ? n_t0 : 0)) * BK;
    const bool edge = (src.causal && k0 + BK - 1 > q0 + src.q_offset) || k0 + BK > src.Skv;
    const float* kb = bias_s + st * BK;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int col = 8 * j + 2 * (lane & 3) + (e & 1);
        float x = fmaf(s[4 * j + e], p.scale, kb[col]);
        bool live = true;
        if (edge) {
          const int key = k0 + col;
          live = key < src.Skv;
          if (src.causal && key > q0 + r0 + 8 * i + src.q_offset) x = NEG_INF;
        }
        s[4 * j + e] = live ? __expf(x - lse[i]) * (dp[4 * j + e] - dl[i]) : 0.f;  // dS
      }
    uint32_t a[4][4];
    to_afrag(s, a);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dq, a[kk], mnmajor(sK, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq);
    __syncthreads();  // every warp is done with stage st
    if (t + 2 < total) load_kv(t + 2);
  }

  bf16* dqg = static_cast<bf16*>(p.dq) + q_off;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + r0 + 8 * i;
      if (row < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(dqg + (long long)row * q_row + 8 * j + 2 * (lane & 3)) =
            __floats2bfloat162_rn(dq[4 * j + 2 * i] * p.scale, dq[4 * j + 2 * i + 1] * p.scale);
    }
}

// ---- B2: dK/dV

// p.dk / p.dv: (n_split, kv entries, Skv, Hkv, D) f32, this block's share of
// the (row, q head) pairs written whole (keys no query sees get zeros).
// n_split divides R * G.
template <int D>
__global__ void __launch_bounds__(WG, 2) attn_bwd_dkv_tc(const __grid_constant__ BwdParams p, int n_split) {
  constexpr int TILE = tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sK = base;
  const uint32_t sV = base + TILE;  // stage st: Q at base + (2 + 2st) TILE, dO one tile on
  const uint32_t sStats = base + 6 * TILE;  // stage st: lse [64], delta [64]
  const float* stats = reinterpret_cast<const float*>(smem_raw + (sStats - raw));
  const uint32_t bars = sStats + 1024;

  const BwdSource& s = p.src[0];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y / n_split;
  const int split = blockIdx.y - hk * n_split;
  const long long entry = blockIdx.z;
  const int pairs = s.R * p.G / n_split;  // (row, q head) pairs of this block: pair = r * G + g
  const int q_row = p.H * D;
  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int qt0 = s.causal ? max(0, k0 - s.q_offset) / BQ : 0;  // first tile a key here is visible to
  const int per = max(0, n_qt - qt0);
  const int total = pairs * per;  // (pair, query tile), query tile innermost

  auto tile_of = [&](int t, long long& b, int& h, int& q0) {
    const int i = t / per;
    const int pair = split * pairs + i;
    const int r = pair / p.G;
    b = entry * s.R + r;
    h = hk * p.G + pair - r * p.G;
    q0 = (qt0 + t - i * per) * BQ;
  };
  auto load_q = [&](int t) {
    long long b;
    int h, q0;
    tile_of(t, b, h, q0);
    const long long q_off = b * p.Sq * q_row + (long long)h * D;
    const int st = t & 1;
    load_tile<D>(base + (2 + 2 * st) * TILE, static_cast<const bf16*>(p.q) + q_off, q_row, q0, p.Sq);
    load_tile<D>(base + (3 + 2 * st) * TILE, static_cast<const bf16*>(p.dout) + q_off, q_row, q0, p.Sq);
    const int row = q0 + (tid & 63);
    const bool ok = row < p.Sq;
    const float* src = (tid < 64 ? p.lse : p.delta) + (b * p.H + h) * p.Sq + (ok ? row : 0);
    cp_async4(sStats + (st * 128 + tid) * 4, src, ok);
    mbar_arrive_copies(bars + 8 * st);
  };

  mbar_init_all(bars, 2);
  const long long kv_off = entry * s.kv_batch + (long long)hk * D;
  load_tile<D>(sK, static_cast<const bf16*>(s.k) + kv_off, s.kv_row, k0, s.Skv);
  load_tile<D>(sV, static_cast<const bf16*>(s.v) + kv_off, s.kv_row, k0, s.Skv);
  if (total > 0) load_q(0);
  if (total > 1) load_q(1);

  const int r0 = warp * 16 + (lane >> 2);  // the thread's keys: k0 + r0 and k0 + r0 + 8
  float kb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + r0 + 8 * i;
    kb[i] = (s.bias && key < s.Skv) ? s.bias[entry * s.Skv + key] : 0.f;
  }
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int t = 0; t < total; ++t) {
    const int st = t & 1;
    const uint32_t sQ = base + (2 + 2 * st) * TILE;
    const uint32_t sdO = sQ + TILE;
    mbar_wait(bars + 8 * st, (t >> 1) & 1);
    fence_proxy_async();
    __syncthreads();

    float sT[32], dpT[32];  // keys x query rows
    wgmma_fence();
    scores<D>(sT, sK, sQ);
    scores<D>(dpT, sV, sdO);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sT);
    fence_regs(dpT);

    long long b;
    int h, q0;
    tile_of(t, b, h, q0);
    const bool edge = (s.causal && k0 + BK - 1 > q0 + s.q_offset) || q0 + BQ > p.Sq;
    const float* L = stats + st * 128;
    const float* Dl = L + 64;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int col = 8 * j + 2 * (lane & 3) + (e & 1);  // query row in the tile
        float x = fmaf(sT[4 * j + e], p.scale, kb[i]);
        bool live = true;
        if (edge) {
          live = q0 + col < p.Sq;
          if (s.causal && k0 + r0 + 8 * i > q0 + col + s.q_offset) x = NEG_INF;
        }
        const float pr = live ? __expf(x - L[col]) : 0.f;
        sT[4 * j + e] = pr;                           // P^T
        dpT[4 * j + e] = pr * (dpT[4 * j + e] - Dl[col]);  // dS^T
      }
    uint32_t ap[4][4], as[4][4];
    to_afrag(sT, ap);
    to_afrag(dpT, as);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dv, ap[kk], mnmajor(sdO, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dk, as[kk], mnmajor(sQ, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv);
    fence_regs(dk);
    __syncthreads();  // every warp is done with stage st
    if (t + 2 < total) load_q(t + 2);
  }

  const long long out0 = ((long long)split * gridDim.z + entry) * s.Skv;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = k0 + r0 + 8 * i;
      if (key < s.Skv) {
        const long long o = ((out0 + key) * p.Hkv + hk) * D + 8 * j + 2 * (lane & 3);
        *reinterpret_cast<float2*>(p.dk + o) =
            make_float2(dk[4 * j + 2 * i] * p.scale, dk[4 * j + 2 * i + 1] * p.scale);
        *reinterpret_cast<float2*>(p.dv + o) = make_float2(dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
      }
    }
  cp_async_wait_all();  // a block whose keys no query row sees (total == 0) never waited on K/V
}

// dk[i] = sum over s of part_dk[s][i] in the order s = 0, 1, ... (and dv);
// n4 = elements per output / 4.
__global__ void fold_dkv_partials(const float* __restrict__ part_dk, const float* __restrict__ part_dv,
                                  float* __restrict__ dk, float* __restrict__ dv, long long n4,
                                  int n_split) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < 2 * n4; i += stride) {
    const bool second = i >= n4;
    const long long j = second ? i - n4 : i;
    const float4* src = reinterpret_cast<const float4*>(second ? part_dv : part_dk) + j;
    float4 acc = src[0];
    for (int sp = 1; sp < n_split; ++sp) {
      const float4 x = src[sp * n4];
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    reinterpret_cast<float4*>(second ? dv : dk)[j] = acc;
  }
}

template <int D>
cudaError_t launch_dq(const BwdParams& p, dim3 grid, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  attn_bwd_dq_tc<D><<<grid, WG, smem, stream>>>(p);
  return cudaGetLastError();
}

// p.dk/p.dv are the partials when n_split > 1 (then folded into dk/dv), else
// dk/dv themselves.
template <int D>
cudaError_t launch_dkv(const BwdParams& p, int n_split, dim3 grid, float* dk, float* dv,
                       cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dkv_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  attn_bwd_dkv_tc<D><<<grid, WG, smem, stream>>>(p, n_split);
  if (n_split > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long n4 = (long long)grid.z * p.src[0].Skv * p.Hkv * D / 4;
    const long long blocks = (2 * n4 + 255) / 256;
    fold_dkv_partials<<<(int)(blocks < 1056 ? blocks : 1056), 256, 0, stream>>>(p.dk, p.dv, dk, dv, n4,
                                                                                 n_split);
  }
  return cudaGetLastError();
}

// Head dims 64 and 128; -1 for another.
inline int dispatch_dq(int D, const BwdParams& p, dim3 grid, cudaStream_t stream) {
  switch (D) {
    case 64: return launch_dq<64>(p, grid, stream);
    case 128: return launch_dq<128>(p, grid, stream);
    default: return -1;
  }
}

inline int dispatch_dkv(int D, const BwdParams& p, int n_split, dim3 grid, float* dk, float* dv,
                        cudaStream_t stream) {
  switch (D) {
    case 64: return launch_dkv<64>(p, n_split, grid, dk, dv, stream);
    case 128: return launch_dkv<128>(p, n_split, grid, dk, dv, stream);
    default: return -1;
  }
}

}  // namespace tc
}  // namespace t1
