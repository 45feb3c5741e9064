// Q2: fused int8 SwiGLU MLP for the decode step, in one launch that streams
// the weights once.
//
// Replaces the Pallas kernel `fused_mlp_int8` of time_r1_tpu/ops/fused_mlp.py
// (pallas_call at :85): y = bf16(silu(x_b·Wgᵀ·s_g) · (x_b·Wuᵀ·s_u)) · Wdᵀ · s_d,
// with x_b = x rounded to bf16 whatever x's dtype (the TPU kernel feeds its
// bf16 MXU so), every sum in f32, and y cast to x's dtype. Weights are the
// port's fused layout: gu (2·inter, hid) int8 with rows [0, inter) the gate
// and [inter, 2·inter) the up projection, down (hid, inter) int8, and one
// f32 scale per output row of each.
//
// What bounds it on the H100: at decode (M = 8) each weight byte feeds 2·M
// operations against the ~295 per byte at which the tensor cores would bind,
// so the bound is streaming the int8 weights once (67.6 MB per 3B layer,
// 20 us at 3.35 TB/s). The design keeps that stream full and everything else
// off it (PERF.md has the timeline that shaped it):
// - One cooperative launch of one block per SM (grid from the occupancy
//   query; every block resident), two phases split by one grid barrier.
// - Phase A: a unit is 8 `inter` columns, i.e. 8 gate + the 8 matching up
//   rows, the 16 rows of one m16n8k16 A tile, over the whole hid. Block b
//   takes units [b·n/G, (b+1)·n/G) (ops/fused_mlp.py::unit_ranges mirrors
//   it). The unit's epilogue writes bf16(silu(g·s_g)·u·s_u) to an (M,
//   inter_pad) bf16 scratch (176 KB at M = 8, it stays in L2).
// - Phase B: a unit is 16 rows of down (16 outputs of y) over the whole
//   `inter`, so every output is one fixed-order sum in one block: no partials
//   in device memory, no atomics, and two launches are bit-equal. Before it
//   waits at the grid barrier, the producer already streams its first down
//   stages (they do not depend on phase A).
// - One producer warp keeps a ring of stages full: 16 rows x 2 KB at M <= 8
//   (3 stages, 96 KB in flight per SM), one bulk copy a row segment (lane r
//   copies row r; lane 16 + m the stage's activation row m in phase B), all
//   completed on the stage's mbarrier. A copy costs mostly per copy, so
//   segments are long. bf16 x goes first, by copies of its own.
// - Eight consumer warps split each stage's 64-deep blocks, turn int8 into
//   bf16 in registers exactly and multiply on the tensor cores (mma.sync
//   m16n8k16, f32 sums) against x (phase A, staged once per pass in shared
//   memory) or the activation (phase B, copied in beside the weights);
//   csrc/weight_stream.cuh has the fragment layout. At a unit's end each
//   warp hands its partial tile over on an mbarrier; the reducing warp (one
//   in turn) sums them in warp order and writes the epilogue while the
//   others go on; it loads its scales a reduced unit ahead.
// - M runs in passes of MT = 8 rows (16 rows a pass when M > 8: 16 rows x
//   1 KB stages, 4 of them); the weights stream once per pass. f32 x takes
//   the same kernel: x is rounded to bf16 by definition and int8 x bf16
//   products are exact in f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "weight_stream.cuh"

namespace {

using namespace t1::ws;
using bf16 = __nv_bfloat16;

constexpr int CW = 8;               // consumer warps
constexpr int NT = (CW + 1) * 32;   // and one producer warp
constexpr int ROWS = 16;            // weight rows of a unit and of a stage (one A tile)
constexpr int MAX_SMEM = 232448;    // a block's dynamic shared memory on the H100
constexpr int RED = 256;            // offset of the partial tiles (after the barriers)

// A stage holds KC bytes of each of 16 rows: at M <= 8, 32 KB stages, 3 of
// them (a copy's cost is mostly per copy, so rows go in 2 KB pieces); above,
// 16 KB stages, 4 of them (the activation's 16 rows take the room).
template <int NTILE>
__host__ __device__ constexpr int stage_kc() { return NTILE == 1 ? 2048 : 1024; }
template <int NTILE>
__host__ __device__ constexpr int stages() { return NTILE == 1 ? 3 : 4; }
// Pitches of a staged weight row (rows g and g + 1 on other banks) and of a
// staged activation row (bf16).
template <int NTILE>
__host__ __device__ constexpr int wp() { return stage_kc<NTILE>() + 64; }
template <int NTILE>
__host__ __device__ constexpr int ap() { return 2 * stage_kc<NTILE>() + 16; }

// x rows staged as bf16 with a pitch = 16 mod 128 bytes: rows n and n + 1 on other banks.
__host__ __device__ constexpr int x_pitch(int hid) { return 2 * hid + 16; }

template <int NTILE>
__host__ __device__ constexpr int red_bytes() { return 2 * CW * NTILE * 32 * 16; }

template <int NTILE>
__host__ __device__ constexpr int ring_off() { return RED + red_bytes<NTILE>(); }

// The region after the ring: x in phase A, the stages' activation rows in phase B.
template <int NTILE>
__host__ __device__ constexpr int region_off() { return ring_off<NTILE>() + stages<NTILE>() * ROWS * wp<NTILE>(); }

template <int NTILE>
__host__ __device__ constexpr int smem_bytes(int hid) {
  const int x = 8 * NTILE * x_pitch(hid), a = stages<NTILE>() * 8 * NTILE * ap<NTILE>();
  return region_off<NTILE>() + (x > a ? x : a);
}

// Units [unit_begin(n, G, b), unit_begin(n, G, b + 1)) are block b's.
__host__ __device__ inline int unit_begin(int n, int grid, int b) { return (int)((long long)b * n / grid); }

struct Params {
  const void* x;
  const int8_t* gu;
  const float* gu_s;
  const int8_t* down;
  const float* down_s;
  void* y;
  bf16* act;  // (M, inter_pad): bf16 activation, zero past inter
  int M, hid, inter, inter_pad;
  // A timing build's parts (bits): 1 phase A, 2 phase B (alone: over a stale
  // activation, no grid barrier). The kernel is 3.
  int parts;
};

__device__ GridBarrier g_barrier;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(bf16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 8 consecutive x values as bf16 (rounded): 16 or 32-byte loads where x is
// 16-byte aligned (`vec`), else one element at a time.
__device__ __forceinline__ uint4 load_x8(const bf16* src, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(src));
  uint32_t v[4];
  for (int e = 0; e < 4; ++e) v[e] = pack_bf16(to_f(src[2 * e]), to_f(src[2 * e + 1]));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint4 load_x8(const float* src, bool vec) {
  float f[8];
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(src)), b = __ldg(reinterpret_cast<const float4*>(src) + 1);
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
  } else {
    for (int e = 0; e < 8; ++e) f[e] = src[e];
  }
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}

template <typename T, int NTILE>
__global__ void __launch_bounds__(NT, 1) fused_mlp_tc(const __grid_constant__ Params p) {
  constexpr int STAGES = stages<NTILE>();
  constexpr int MT = 8 * NTILE;
  constexpr int KC = stage_kc<NTILE>(), WP = wp<NTILE>(), AP = ap<NTILE>();
  extern __shared__ __align__(128) uint8_t smem[];
  // barriers: the ring's full / empty, and the partial tiles' (two buffers) full / read out
  const uint32_t full = smem_u32(smem), empty = full + 8 * STAGES;
  const uint32_t red_full = empty + 8 * STAGES, red_free = red_full + 16, x_full = red_free + 16;
  float4* red = reinterpret_cast<float4*>(smem + RED);
  uint8_t* ring = smem + ring_off<NTILE>();
  uint8_t* region = smem + region_off<NTILE>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = gridDim.x, b = blockIdx.x;
#ifdef T1_Q2_PROFILE_PARTS
  const int parts = p.parts;
#else
  constexpr int parts = 3;
#endif
  const int ua0 = unit_begin(p.inter / 8, G, b), nua = (parts & 1) ? unit_begin(p.inter / 8, G, b + 1) - ua0 : 0;
  const int ub0 = unit_begin(p.hid / ROWS, G, b), nub = (parts & 2) ? unit_begin(p.hid / ROWS, G, b + 1) - ub0 : 0;
  const int passes = (p.M + MT - 1) / MT;
  const int chA = (p.hid + KC - 1) / KC, chB = (p.inter + KC - 1) / KC;
  const int nstA = passes * nua * chA, nstB = passes * nub * chB;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CW);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(red_full + 8 * s, CW);
      mbar_init(red_free + 8 * s, 1);
    }
    mbar_init(x_full, 1);
    mbar_init_fence();
  }
  // x's rows [m0, m0 + MT) as bf16 into the region, zero past M. The first
  // pass's rows go first, ahead of the weight stream (behind it, their loads
  // took 7 us of a 3B launch, PERF.md): bf16 x 16-byte aligned by the
  // producer's bulk copies, completed on x_full; any other x by the
  // consumers before the producer starts.
  const int xp = x_pitch(p.hid);
  const bool x_by_copy = sizeof(T) == 2 && (reinterpret_cast<uintptr_t>(p.x) & 15) == 0;
  const int x_rows = min(MT, p.M);
  auto stage_x = [&](int m0) {
    const T* x = static_cast<const T*>(p.x);
    const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    const int c8n = p.hid / 8;
#pragma unroll 8
    for (int i = threadIdx.x; i < MT * c8n; i += CW * 32) {
      const int r = i / c8n, c8 = i % c8n, m = m0 + r;
      *reinterpret_cast<uint4*>(region + r * xp + 16 * c8) =
          m < p.M ? load_x8(x + (long long)m * p.hid + 8 * c8, vec) : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  if (warp < CW && nua > 0) {
    if (!x_by_copy) {
      stage_x(0);
    } else {
      for (int i = threadIdx.x; i < (MT - x_rows) * xp / 16; i += CW * 32)
        reinterpret_cast<uint4*>(region + x_rows * xp)[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __syncthreads();  // the barriers are set up; x staged or about to be copied

  // Phase B's stage i: its pass, unit and chunk.
  auto b_stage = [&](int i, int& m0, int& u, int& c) {
    const int per = nub * chB;
    m0 = i / per * MT;
    u = ub0 + i % per / chB;
    c = i % per % chB;
  };

  if (warp == CW) {  // ---- the producer: lane r < 16 copies weight row r, lane 16 + m activation row m
    const int pre = min(STAGES, nstB);  // phase B stages whose weights go ahead of the grid barrier
    auto issue_b = [&](int i, bool weights, bool act) {
      int m0, u, c;
      b_stage(i, m0, u, c);
      const int q = nstA + i, slot = ring_slot<STAGES>(q);
      const int kc = min(KC, p.inter - c * KC), kc64 = (kc + 63) & ~63, mrows = min(MT, p.M - m0);
      const uint32_t bar = full + 8 * slot;
      if (weights && q >= STAGES) mbar_wait(empty + 8 * slot, ring_parity<STAGES>(q) ^ 1);
      if (weights) {
        if (lane == 0) mbar_arrive_expect_tx(bar, ROWS * kc + mrows * 2 * kc64);
        __syncwarp();
        if (lane < ROWS)
          bulk_copy(smem_u32(ring + slot * ROWS * WP + lane * WP),
                    p.down + (long long)(ROWS * u + lane) * p.inter + c * KC, kc, bar);
      }
      const int m = lane - ROWS;
      if (act && m >= 0 && m < mrows)  // the activation's columns [c·KC, c·KC + kc64), zero past inter
        bulk_copy(smem_u32(region + (slot * MT + m) * AP), p.act + (long long)(m0 + m) * p.inter_pad + c * KC,
                  2 * kc64, bar);
    };
    const unsigned int gen0 = lane == 0 ? ld_acquire(&g_barrier.gen) : 0u;
    if (x_by_copy && nua > 0) {
      if (lane == 0) mbar_arrive_expect_tx(x_full, x_rows * 2 * p.hid);
      __syncwarp();
      if (lane < x_rows)
        bulk_copy(smem_u32(region + lane * xp), static_cast<const T*>(p.x) + (long long)lane * p.hid, 2 * p.hid,
                  x_full);
    }
    for (int q = 0; q < nstA; ++q) {
      const int per = nua * chA;
      const int u = ua0 + q % per / chA, c = q % per % chA;
      const int kc = min(KC, p.hid - c * KC), slot = ring_slot<STAGES>(q);
      const uint32_t bar = full + 8 * slot;
      if (q >= STAGES) mbar_wait(empty + 8 * slot, ring_parity<STAGES>(q) ^ 1);
      if (lane == 0) mbar_arrive_expect_tx(bar, ROWS * kc);
      __syncwarp();
      if (lane < ROWS) {
        const long long row = lane < 8 ? 8 * u + lane : p.inter + 8 * u + lane - 8;
        bulk_copy(smem_u32(ring + slot * ROWS * WP + lane * WP), p.gu + row * p.hid + c * KC, kc, bar);
      }
    }
    for (int i = 0; i < pre; ++i) issue_b(i, true, false);
    __syncwarp();
    named_sync(1, NT);  // the consumers are through phase A: the activation is stored, x read out
    if ((parts & 3) == 3 && lane == 0) {
      grid_arrive(&g_barrier, gen0);
      grid_wait(&g_barrier, gen0);
    }
    __syncwarp();
    fence_proxy_async();  // the activation's generic stores (every block's), x's in the region: before the copies
    for (int i = 0; i < pre; ++i) issue_b(i, false, true);
    for (int i = pre; i < nstB; ++i) issue_b(i, true, true);
    return;
  }

  // ---- the consumers
  const int tid = threadIdx.x;
  const int g = lane >> 2, t = lane & 3;
  float acc[NTILE][4];
#pragma unroll
  for (int nt = 0; nt < NTILE; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  int q = 0, nunit = 0;

  // One stage: this warp's 64-deep blocks of it against B rows at `bsrc`.
  auto consume = [&](int nkb, int ntl, const uint8_t* bsrc, int bpitch) {
    const int slot = ring_slot<STAGES>(q);
    mbar_wait(full + 8 * slot, ring_parity<STAGES>(q));
    const uint8_t* w = ring + slot * ROWS * WP + g * WP + 16 * t;
    for (int kb = warp; kb < nkb; kb += CW) {
      uint32_t a[4][4];
      int8_block_frags(*reinterpret_cast<const uint4*>(w + kb * 64),
                       *reinterpret_cast<const uint4*>(w + 8 * WP + kb * 64), a);
#pragma unroll
      for (int nt = 0; nt < NTILE; ++nt) {
        if (nt < ntl) {
          const uint8_t* xb = bsrc + (nt * 8 + g) * bpitch + kb * 128 + 32 * t;
          mma_block(acc[nt], a, *reinterpret_cast<const uint4*>(xb), *reinterpret_cast<const uint4*>(xb + 16));
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * slot);
    ++q;
  };

  // The block's n-th unit (phase A's over the passes, then phase B's) is
  // reduced by warp n % CW, which holds the scales of rows g / g + 8 of its
  // next unit in (s0, s1), loaded one reduced unit ahead.
  const int nunits = passes * (nua + nub);
  float s0 = 0.f, s1 = 0.f;
  auto load_scales = [&](int n) {
    if (n >= nunits) return;
    const int na = passes * nua;
    if (n < na) {
      const int col = 8 * (ua0 + n % nua) + g;
      s0 = p.gu_s[col], s1 = p.gu_s[p.inter + col];
    } else {
      const int row = ROWS * (ub0 + (n - na) % nub) + g;
      s0 = p.down_s[row], s1 = p.down_s[row + 8];
    }
  };
  load_scales(warp);

  // A unit's end: every warp stores its partial tile to buffer n & 1 and
  // arrives on its barrier; the reducing warp sums them in warp order and
  // writes the epilogue while the others go on. Rows g / g + 8 of the tile
  // are gate / up of column 8u + g (phase A) or outputs 16u + g / 16u + 8 + g
  // (phase B); columns are rows m of x.
  auto finish = [&](bool phase_a, int u, int m0, int ntl) {
    const int buf = nunit & 1, use = nunit >> 1;
    if (use > 0) mbar_wait(red_free + 8 * buf, (use - 1) & 1);  // unit n - 2's reducer read it out
#pragma unroll
    for (int nt = 0; nt < NTILE; ++nt) {
      red[((buf * CW + warp) * NTILE + nt) * 32 + lane] = make_float4(acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3]);
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(red_full + 8 * buf);
    if (warp == nunit % CW) {
      mbar_wait(red_full + 8 * buf, use & 1);
      for (int nt = 0; nt < ntl; ++nt) {
        float sum[4] = {0.f, 0.f, 0.f, 0.f};
        for (int w = 0; w < CW; ++w) {
          const float4 v = red[((buf * CW + w) * NTILE + nt) * 32 + lane];
          sum[0] += v.x, sum[1] += v.y, sum[2] += v.z, sum[3] += v.w;
        }
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + nt * 8 + 2 * t + e;
          if (m >= p.M) continue;
          if (phase_a) {
            const float gate = sum[e] * s0, up = sum[2 + e] * s1;
            p.act[(long long)m * p.inter_pad + 8 * u + g] = __float2bfloat16(gate / (1.f + expf(-gate)) * up);
          } else {
            const int j = ROWS * u + g;
            T* y = static_cast<T*>(p.y) + (long long)m * p.hid;
            store_f(y + j, sum[e] * s0);
            store_f(y + j + 8, sum[2 + e] * s1);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(red_free + 8 * buf);
      load_scales(nunit + CW);
    }
    ++nunit;
  };

  if (b == 0) {  // the activation's pad columns, which phase B's copies read as zeros
    const int padw = p.inter_pad - p.inter;
    for (int i = tid; i < p.M * padw; i += CW * 32)
      p.act[(long long)(i / padw) * p.inter_pad + p.inter + i % padw] = __float2bfloat16(0.f);
  }

  // Phase A: gate and up, pass by pass over x's rows.
  if (x_by_copy && nua > 0) mbar_wait(x_full, 0);
  for (int m0 = 0; m0 < p.M && nua > 0; m0 += MT) {
    if (m0 > 0) {
      named_sync(2, CW * 32);  // the previous pass's x is read out
      stage_x(m0);
      named_sync(2, CW * 32);
    }
    const int ntl = min(NTILE, (p.M - m0 + 7) / 8);
    for (int u = ua0; u < ua0 + nua; ++u) {
      for (int c = 0; c < chA; ++c) consume(min(KC, p.hid - c * KC) / 64, ntl, region + 2 * c * KC, xp);
      finish(true, u, m0, ntl);
    }
  }
  named_sync(1, NT);  // to the producer: this block's activation is stored and x read out

  // Phase B: down, over the activation copied into each stage.
  for (int i = 0; i < nstB; ++i) {
    int m0, u, c;
    b_stage(i, m0, u, c);
    const int ntl = min(NTILE, (p.M - m0 + 7) / 8);
    consume((min(KC, p.inter - c * KC) + 63) / 64, ntl, region + ring_slot<STAGES>(q) * MT * AP, AP);
    if (c == chB - 1) finish(false, u, m0, ntl);
  }
}

// One cooperative launch on `stream` of as many blocks as can be resident.
template <typename T, int NTILE>
int launch(const Params& p, cudaStream_t stream) {
  auto kern = fused_mlp_tc<T, NTILE>;
  const int smem = smem_bytes<NTILE>(p.hid);
  if (smem > MAX_SMEM) return -2;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, smem)) != cudaSuccess) return err;
  if (per_sm < 1) return -3;
  void* args[] = {const_cast<Params*>(&p)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), dim3(per_sm * sms), dim3(NT), args, smem,
                                    stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

int dispatch(int dtype, const Params& p, cudaStream_t stream) {
  const bool wide = p.M > 8;
  if (dtype == 0) return wide ? launch<float, 2>(p, stream) : launch<float, 1>(p, stream);
  if (dtype == 1) return wide ? launch<bf16, 2>(p, stream) : launch<bf16, 1>(p, stream);
  return -1;
}

Params make_params(const void* x, const void* gu, const float* gu_s, const void* down, const float* down_s, void* y,
                   void* act, int M, int hid, int inter, int parts = 3) {
  return Params{x, static_cast<const int8_t*>(gu), gu_s, static_cast<const int8_t*>(down), down_s, y,
                static_cast<bf16*>(act), M, hid, inter, (inter + 63) & ~63, parts};
}

bool takes(int M, int hid, int inter) { return hid % 128 == 0 && inter % 16 == 0 && M >= 1 && M <= 128; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y). act is (M, round_up(inter, 64))
// bf16 scratch. hid must be a multiple of 128, inter of 16, 1 <= M <= 128,
// and the block's shared memory must fit (hid <= 7552 at M <= 8, 4480 above).
// Weights 16-byte aligned. One launch on `stream`.
extern "C" int t1_fused_mlp_int8(int dtype, const void* x, const void* gu, const float* gu_s, const void* down,
                                 const float* down_s, void* y, void* act, int M, int hid, int inter, void* stream) {
  if (!takes(M, hid, inter)) return -2;
  return dispatch(dtype, make_params(x, gu, gu_s, down, down_s, y, act, M, hid, inter),
                  static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of a block at (M, hid).
extern "C" int t1_fused_mlp_smem_bytes(int M, int hid) {
  return M > 8 ? smem_bytes<2>(hid) : smem_bytes<1>(hid);
}

#ifdef T1_Q2_PROFILE_PARTS
// A timing build's launch of the parts (Params::parts) of the kernel.
extern "C" int t1_fused_mlp_int8_part(int parts, int dtype, const void* x, const void* gu, const float* gu_s,
                                      const void* down, const float* down_s, void* y, void* act, int M, int hid,
                                      int inter, void* stream) {
  if (!takes(M, hid, inter) || parts < 1 || parts > 3) return -2;
  return dispatch(dtype, make_params(x, gu, gu_s, down, down_s, y, act, M, hid, inter, parts),
                  static_cast<cudaStream_t>(stream));
}
#endif
