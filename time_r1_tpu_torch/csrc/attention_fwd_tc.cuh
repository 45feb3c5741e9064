// Tensor-core attention forward with an online softmax, for bf16 operands on
// Hopper (sm_90a): `attn_fwd_tc`, the one kernel body of three bf16 kernels:
//   K1 (flash_attention.cu): replaces `_flash_fwd` of
//      time_r1_tpu/ops/flash_attention.py (pallas_call at :135): one key
//      source, causal with a q_offset, an additive (B, Skv) key bias, GQA;
//   K3 (vision_attention.cu, ROPE): replaces `full_attention_rope` of
//      time_r1_tpu/ops/vision_attention.py (pallas_call at :233): one
//      non-causal source per (sample, t) slice with the 2D rope applied to q
//      and k inside the kernel;
//   S1 (shared_prefix_attention.cu): replaces `_sp_fwd` of
//      time_r1_tpu/ops/flash_attention.py (pallas_call at :575): query row b
//      attends [the prefix of prompt b / R, masked by its (P, Lp) bias | its
//      own causal chunk] with one softmax over both.
// `FwdParams` walks n_src key sources (attention_bwd.cuh's `BwdSource`: an
// additive key bias, causal with a q_offset, R query batch entries per kv
// entry) in order; q head h reads kv head h / G. Out in bf16 and the
// log-sum-exp (B, H, Sq) in f32 with attention_tile.cuh's `store_out`
// convention (lse = m + log max(l, 1e-30); keys hidden by a bias or the causal
// mask score NEG_INF, keys past the end -inf), so a row that sees no real key
// is a finite uniform average with lse ~ NEG_INF, as in the FMA kernels. Head
// dims 64, 80 and 128. The f32 K1, K3 and S1 keep the exact FMA kernels of
// attention_tile.cuh.
//
// What bounds it on the H100: K1 at the serving prefill (q (2, 2048, 16, 128)
// over a 2176-slot cache) and S1 at the split loss do ~25-35 GFLOP of live
// products against tens of MB, so the bf16 tensor cores' 989 TFLOP/s; K3 at
// the serving vision tower (q/k/v (28, 576, 16, 80)) ~31 GFLOP against ~140 MB
// of operands, bytes and products about even (0.042 ms). In practice each
// block re-reads every K/V tile of its (b, h) from L2 and walks them in
// order, one warpgroup waiting on each product: the kernels reach 7-21% of
// their bound (PERF.md).
//
// QT 64-row query tiles per block, one warpgroup (128 threads) running them
// one after the other over each key tile: grid (ceil(Sq / (64 QT)), H, B),
// block x taking the query rows of block n - 1 - x (the heaviest causal
// tiles first). QT is 1 for K1 and S1, 2 for K3, whose roped K tile and its
// cos/sin then serve 128 query rows. Both products are `wgmma.mma_async` with
// bf16 inputs and f32 accumulators:
//   S = Q K^T   m64n64k16, A = Q and B = the K tile from shared memory, both K-major
//   O += P V    m64nDk16,  A = P in registers, B = the V tile (MN-major)
// At D = 80 the tile's last 16 columns sit in a 32-byte-swizzled block
// (wgmma_tile.cuh): S takes a fifth k16 step on it, and O += P V is one
// m64n64k16 on the 64-column block plus one m64n16k16 on the tail, so O is
// 40 f32 a thread and no product is padded.
// The scale, the bias, the masks (only on tiles that cross the diagonal or a
// ragged edge), the running max and the running sum act on S's f32
// accumulator; each thread's two rows are reduced over its quad with
// shuffles. P is rounded to bf16 in registers as the A fragment of the second
// product (an accumulator's layout is its A fragment's), after O is rescaled
// by exp(m_old - m_new); P never touches shared memory. Without ROPE, q stays
// unscaled in bf16 and the scale multiplies S in f32. The running sum adds the
// unrounded f32 P, as FA-2 and FA-3 do.
//
// Q is resident; K, V and the 64 bias values of each key tile stream through
// a ring of two stages of `cp.async` copies, each completed on an mbarrier,
// so the next tile loads while this one computes; the ring walks source 0's
// tiles (S1: the prefix), then source 1's (the own chunk, up to the diagonal).
//
// ROPE (K3): rotate_half at D/2 is a whole number of 16-byte chunks (5 of a
// row's 10 at D = 80), so chunk c and chunk c + D/16 of a row rotate into each
// other. Q and each K tile land raw by cp.async; the 64 rows of cos and sin
// they need land beside them in one staging buffer (f32, rows padded to D + 4
// floats so that 8 consecutive rows fall in distinct banks) on a third
// mbarrier. Once both have landed each thread takes (row, chunk pair)s, rows
// innermost, computes x * cos + rotate_half(x) * sin in f32 (times the scale
// for Q, as the TPU kernel scales q after the rope, before the product), rounds
// to bf16 and writes both chunks back in place; a proxy fence and the block
// barrier then hand the tile to wgmma, and S is not scaled again. Q's tiles
// are roped in the prologue; K tile t + 1's cos/sin are fetched as soon as
// tile t is roped, so they load under tile t's products. A key tile's 40 KB
// of cos/sin is twice its K and V together: the rope doubles K3's time over
// the same attention without it (PERF.md), and QT = 2 halves that traffic
// per query row.
//
// Budget: shared memory QT + 4 tiles + 512 B of bias + the barriers + 1 KB of
// alignment (+ 2 x 64 x (D + 4) f32 of cos/sin with ROPE): K1/S1 at D = 128
// 83,520 bytes (two blocks an SM), D = 80 52,800, D = 64 42,560; K3 at D = 80
// 106,048 (two blocks an SM); registers under __launch_bounds__(128, 2).
// ptxas's report per instance is in PERF.md.
#pragma once

#include "attention_bwd.cuh"
#include "wgmma_tile.cuh"

namespace t1 {
namespace tc {

struct FwdParams {
  const void* q;     // (B, Sq, H, D) bf16, contiguous
  void* o;           // (B, Sq, H, D) bf16
  float* lse;        // (B, H, Sq), or nullptr (K3)
  const float* cos;  // ROPE: (B, Sq, D) f32 tables; q row i and key i of batch
  const float* sin;  // entry b take row b * Sq + i (K3: Sq == Skv, R == 1)
  int Sq;
  int H;
  int G;             // q heads per kv head
  float scale;
  int n_src;         // key sources (1 or 2), walked in order
  BwdSource src[2];
};

// f32 per staged cos/sin row: 8 consecutive rows start in distinct 16-byte bank groups
template <int D>
__host__ __device__ constexpr int rope_stride() { return D + 4; }

// QT query tiles resident, two stages of K and V, 2 x 64 f32 of bias, three
// mbarriers, 1 KB of alignment; with ROPE the 64 rows of cos and sin of one tile.
template <int D, bool ROPE, int QT>
__host__ __device__ constexpr int fwd_smem_bytes() {
  return (QT + 4) * tile_bytes<D>() + 512 + 64 + 1024 + (ROPE ? 2 * 64 * rope_stride<D>() * 4 : 0);
}

// The rope's staging (K2, K3): cos and sin rows row0.. of row-major (rows,
// D) f32 tables into `dst` (cos rows 0..63, then sin rows, rope_stride<D>()
// floats a row); rows from n_rows on are zeros. One cp.async group's worth
// of copies per thread; the caller completes them.
template <int D>
__device__ __forceinline__ void load_rope_rows(uint32_t dst, const float* cos, const float* sin, int row0,
                                               int n_rows) {
  constexpr int CPR = D / 4;  // 16-byte chunks of a f32 row
  constexpr int RS = rope_stride<D>();
#pragma unroll
  for (int it = 0; it < 2 * 64 * CPR / WG; ++it) {
    const int idx = it * WG + threadIdx.x;
    const int sn = idx / (64 * CPR);  // 0: cos, 1: sin
    const int r = (idx / CPR) % 64;
    const int c = idx % CPR;
    const bool ok = row0 + r < n_rows;
    const float* src = (sn ? sin : cos) + (long long)(ok ? row0 + r : 0) * D + 4 * c;
    cp_async16(dst + ((sn * 64 + r) * RS + 4 * c) * 4, src, ok);
  }
}

// x * cos + rotate_half(x) * sin, times `scale`, in place on a landed
// 64-row tile at shared address `tile` (smem_raw at shared address raw),
// with the staged cos/sin rows `cs`, one (row, chunk pair) at a time:
// rotate_half at D/2 is a whole number of 16-byte chunks, so chunk c and
// chunk c + D/16 of a row rotate into each other.
template <int D>
__device__ __forceinline__ void rope_tile_inplace(uint8_t* smem_raw, uint32_t raw, uint32_t tile, const float* cs,
                                                  float scale) {
  constexpr int RS = rope_stride<D>();
  constexpr int H2 = D / 16;  // 16-byte chunks in half a row
  const int tid = threadIdx.x;
#pragma unroll 1  // one pair's 40 registers of operands live at a time
  for (int it = 0; it < (64 * H2 + WG - 1) / WG; ++it) {
    const int idx = it * WG + tid;
    if (64 * H2 % WG == 0 || idx < 64 * H2) {
      const int r = idx % 64;
      const int c = idx / 64;
      uint4* lo = reinterpret_cast<uint4*>(smem_raw + (tile + chunk_off<D>(r, c) - raw));
      uint4* hi = reinterpret_cast<uint4*>(smem_raw + (tile + chunk_off<D>(r, c + H2) - raw));
      const uint4 xl = *lo, xh = *hi;
      const uint32_t wl[4] = {xl.x, xl.y, xl.z, xl.w}, wh[4] = {xh.x, xh.y, xh.z, xh.w};
      const float4* cl = reinterpret_cast<const float4*>(cs + r * RS + 8 * c);  // cos, low chunk
      const float4* ch = cl + 2 * H2;                                            // cos, high chunk
      const float4* sl = cl + 16 * RS;                                           // sin rows: 64 on
      const float4* sh = ch + 16 * RS;
      const float4 c4l[2] = {cl[0], cl[1]}, c4h[2] = {ch[0], ch[1]};
      const float4 s4l[2] = {sl[0], sl[1]}, s4h[2] = {sh[0], sh[1]};
      uint32_t yl[4], yh[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        // element 2w (low 16 bits of word w) and 2w + 1; a bf16 is the top half of its f32
        const float x1[2] = {__uint_as_float(wl[w] << 16), __uint_as_float(wl[w] & 0xffff0000u)};
        const float x2[2] = {__uint_as_float(wh[w] << 16), __uint_as_float(wh[w] & 0xffff0000u)};
        const float4 cvl = c4l[w >> 1], cvh = c4h[w >> 1], svl = s4l[w >> 1], svh = s4h[w >> 1];
        const float col[2] = {(w & 1) ? cvl.z : cvl.x, (w & 1) ? cvl.w : cvl.y};
        const float coh[2] = {(w & 1) ? cvh.z : cvh.x, (w & 1) ? cvh.w : cvh.y};
        const float sil[2] = {(w & 1) ? svl.z : svl.x, (w & 1) ? svl.w : svl.y};
        const float sih[2] = {(w & 1) ? svh.z : svh.x, (w & 1) ? svh.w : svh.y};
        float a[2], z[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          a[u] = (x1[u] * col[u] - x2[u] * sil[u]) * scale;
          z[u] = (x2[u] * coh[u] + x1[u] * sih[u]) * scale;
        }
        yl[w] = pack_bf16(a[0], a[1]);
        yh[w] = pack_bf16(z[0], z[1]);
      }
      *lo = make_uint4(yl[0], yl[1], yl[2], yl[3]);
      *hi = make_uint4(yh[0], yh[1], yh[2], yh[3]);
    }
  }
}

template <int D, bool ROPE, int QT>
__global__ void __launch_bounds__(WG, 2) attn_fwd_tc(const __grid_constant__ FwdParams p) {
  constexpr int TILE = tile_bytes<D>();
  constexpr int DM = main_cols<D>();  // columns in 64-column blocks: O's m64n64/n128 part
  constexpr int DT = D - DM;          // the 16-column tail at D = 80: O's m64n16 part
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // Q tile qt at base + qt TILE
  const uint32_t sKV = base + QT * TILE;         // stage st: K at sKV + 2st TILE, V one tile on
  const uint32_t sBias = sKV + 4 * TILE;
  const float* bias_s = reinterpret_cast<const float*>(smem_raw + (sBias - raw));
  const uint32_t bars = sBias + 512;  // K/V stages 0 and 1, then cos/sin
  const uint32_t bar_cs = bars + 16;
  const uint32_t sCS = bars + 64;  // ROPE: cos rows 0..63, then sin rows
  const float* cs = reinterpret_cast<const float*>(smem_raw + (sCS - raw));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_qb = (p.Sq + QT * BQ - 1) / (QT * BQ);
  const int q0 = (n_qb - 1 - (int)blockIdx.x) * QT * BQ;  // query tile qt starts at q0 + qt BQ
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q_row = p.H * D;
  const long long q_off = (long long)b * p.Sq * q_row + (long long)h * D;

  auto n_tiles = [&](const BwdSource& s) {  // up to the causal limit of the block's last row
    return s.causal ? causal_tiles(s.Skv, p.Sq, q0 + (QT - 1) * BQ, s.q_offset) : (s.Skv + BK - 1) / BK;
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
    load_tile<D>(sKV + 2 * st * TILE, static_cast<const bf16*>(s.k) + kv_off, s.kv_row, k0, s.Skv);
    load_tile<D>(sKV + (2 * st + 1) * TILE, static_cast<const bf16*>(s.v) + kv_off, s.kv_row, k0, s.Skv);
    if (tid < BK) {
      const int key = k0 + tid;
      const bool ok = s.bias != nullptr && key < s.Skv;
      cp_async4(sBias + (st * BK + tid) * 4, ok ? s.bias + entry * s.Skv + key : static_cast<const float*>(p.q), ok);
    }
    mbar_arrive_copies(bars + 8 * st);
  };

  // ROPE: cos and sin of table rows b * Sq + row0.. (zeros from n_rows on)
  // into the staging buffer, completed on bar_cs.
  auto load_cs = [&](int row0, int n_rows) {
    const long long tbl = (long long)b * p.Sq * D;
    load_rope_rows<D>(sCS, p.cos + tbl, p.sin + tbl, row0, n_rows);
    mbar_arrive_copies(bar_cs);
  };

  auto rope_tile = [&](uint32_t tile, float scale) { rope_tile_inplace<D>(smem_raw, raw, tile, cs, scale); };

  mbar_init_all(bars, ROPE ? 3 : 2);
  for (int qt = 0; qt < QT; ++qt)
    load_tile<D>(base + qt * TILE, static_cast<const bf16*>(p.q) + q_off, q_row, q0 + qt * BQ, p.Sq);
  if constexpr (ROPE) load_cs(q0, p.Sq);  // completes with Q's copies (phase 0 of bar_cs)
  load_kv(0);  // every query tile sees at least one key tile (Skv >= 1)
  if constexpr (ROPE) {
    // query tile qt's cos/sin are phase qt of bar_cs, key tile t's phase QT + t
#pragma unroll
    for (int qt = 0; qt < QT; ++qt) {
      mbar_wait(bar_cs, qt & 1);
      rope_tile(base + qt * TILE, p.scale);
      __syncthreads();  // every thread is done with the staged cos/sin
      if (qt + 1 < QT)
        load_cs(q0 + (qt + 1) * BQ, p.Sq);
      else
        load_cs(0, p.src[0].Skv);  // key tile 0's
    }
  }
  if (total > 1) load_kv(1);
  const float s_scale = ROPE ? 1.f : p.scale;

  const int r0 = warp * 16 + (lane >> 2);  // the thread's rows of each query tile: r0 and r0 + 8
  float o[QT][DM / 2];
  float ot[QT][DT ? DT / 2 : 1];
  float m[QT][2], l[QT][2];  // l: the thread's share of the row sums; the quad's are added at the end
#pragma unroll
  for (int qt = 0; qt < QT; ++qt) {
#pragma unroll
    for (int i = 0; i < DM / 2; ++i) o[qt][i] = 0.f;
#pragma unroll
    for (int i = 0; i < DT / 2; ++i) ot[qt][i] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[qt][i] = NEG_INF;
      l[qt][i] = 0.f;
    }
  }

  for (int t = 0; t < total; ++t) {
    const int st = t & 1;
    const uint32_t sK = sKV + 2 * st * TILE;
    const uint32_t sV = sK + TILE;
    mbar_wait(bars + 8 * st, (t >> 1) & 1);
    if constexpr (ROPE) {
      mbar_wait(bar_cs, (QT + t) & 1);
      rope_tile(sK, 1.f);
    }
    fence_proxy_async();
    __syncthreads();
    if constexpr (ROPE) {
      if (t + 1 < total) load_cs((t + 1) * BK, p.src[0].Skv);  // under this tile's products
    }

    const int si = t < n_t0 ? 0 : 1;
    const BwdSource& src = p.src[si];
    const int k0 = (t - (si ? n_t0 : 0)) * BK;
    const float* kb = bias_s + st * BK;
#pragma unroll
    for (int qt = 0; qt < QT; ++qt) {
      const int q0t = q0 + qt * BQ;
      float s[32];
      wgmma_fence();
      scores<D>(s, base + qt * TILE, sK);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      const bool edge = (src.causal && k0 + BK - 1 > q0t + src.q_offset) || k0 + BK > src.Skv;
      float mx[2] = {m[qt][0], m[qt][1]};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int col = 8 * j + 2 * (lane & 3) + (e & 1);
          float x = fmaf(s[4 * j + e], s_scale, kb[col]);
          if (edge) {
            const int key = k0 + col;
            if (key >= src.Skv)
              x = -INFINITY;  // past the end: no weight at all
            else if (src.causal && key > q0t + r0 + 8 * i + src.q_offset)
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
        alpha[i] = __expf(m[qt][i] - mx[i]);
        m[qt][i] = mx[i];
        l[qt][i] *= alpha[i];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pr = __expf(s[4 * j + e] - m[qt][e >> 1]);
          s[4 * j + e] = pr;
          l[qt][e >> 1] += pr;
        }
#pragma unroll
      for (int j = 0; j < DM / 8; ++j) {
        o[qt][4 * j + 0] *= alpha[0];
        o[qt][4 * j + 1] *= alpha[0];
        o[qt][4 * j + 2] *= alpha[1];
        o[qt][4 * j + 3] *= alpha[1];
      }
#pragma unroll
      for (int j = 0; j < DT / 8; ++j) {
        ot[qt][4 * j + 0] *= alpha[0];
        ot[qt][4 * j + 1] *= alpha[0];
        ot[qt][4 * j + 2] *= alpha[1];
        ot[qt][4 * j + 3] *= alpha[1];
      }
      uint32_t a[4][4];
      to_afrag(s, a);
      __syncwarp();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<DM>(o[qt], a[kk], mnmajor(sV, kk));
        if constexpr (DT > 0) wgmma_rs_n16(ot[qt], a[kk], mnmajor_tail(sV + 8192, kk));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o[qt]);
      if constexpr (DT > 0) fence_regs(ot[qt]);
    }
    __syncthreads();  // every warp is done with stage st
    if (t + 2 < total) load_kv(t + 2);
  }

  bf16* og = static_cast<bf16*>(p.o) + q_off;
#pragma unroll
  for (int qt = 0; qt < QT; ++qt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[qt][i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const int row = q0 + qt * BQ + r0 + 8 * i;
      const float l_safe = fmaxf(li, 1e-30f);
      const float inv = 1.f / l_safe;
      if (row < p.Sq) {
        bf16* dst = og + (long long)row * q_row + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < DM / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
              __floats2bfloat162_rn(o[qt][4 * j + 2 * i] * inv, o[qt][4 * j + 2 * i + 1] * inv);
#pragma unroll
        for (int j = 0; j < DT / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + DM + 8 * j) =
              __floats2bfloat162_rn(ot[qt][4 * j + 2 * i] * inv, ot[qt][4 * j + 2 * i + 1] * inv);
        if (p.lse != nullptr && (lane & 3) == 0)
          p.lse[((long long)b * p.H + h) * p.Sq + row] = m[qt][i] + logf(l_safe);
      }
    }
}

// Query tiles per block: K3 (ROPE) shares each roped K tile between two.
template <bool ROPE>
constexpr int fwd_qt() { return ROPE ? 2 : 1; }

template <int D, bool ROPE>
cudaError_t launch_fwd(const FwdParams& p, int batch, cudaStream_t stream) {
  constexpr int QT = fwd_qt<ROPE>();
  constexpr int smem = fwd_smem_bytes<D, ROPE, QT>();
  cudaError_t err =
      cudaFuncSetAttribute(attn_fwd_tc<D, ROPE, QT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + QT * BQ - 1) / (QT * BQ), p.H, batch);
  attn_fwd_tc<D, ROPE, QT><<<grid, WG, smem, stream>>>(p);
  return cudaGetLastError();
}

// Head dims 64, 80 and 128 over `batch` query batch entries; -1 for another
// head dim. ROPE takes one key source.
template <bool ROPE>
int dispatch_fwd(int D, const FwdParams& p, int batch, cudaStream_t stream) {
  if (ROPE && p.n_src != 1) return -1;
  switch (D) {
    case 64: return launch_fwd<64, ROPE>(p, batch, stream);
    case 80: return launch_fwd<80, ROPE>(p, batch, stream);
    case 128: return launch_fwd<128, ROPE>(p, batch, stream);
    default: return -1;
  }
}

// Dynamic shared memory of one block at head dim D, in bytes; -1 for another.
inline int fwd_smem(int D, bool rope) {
  switch (D) {
    case 64: return rope ? fwd_smem_bytes<64, true, fwd_qt<true>()>() : fwd_smem_bytes<64, false, 1>();
    case 80: return rope ? fwd_smem_bytes<80, true, fwd_qt<true>()>() : fwd_smem_bytes<80, false, 1>();
    case 128: return rope ? fwd_smem_bytes<128, true, fwd_qt<true>()>() : fwd_smem_bytes<128, false, 1>();
    default: return -1;
  }
}

}  // namespace tc
}  // namespace t1
