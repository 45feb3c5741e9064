// Q1: int4 dequant-matmul for the decode step's projections.
//
// Replaces the Pallas kernel `int4_matmul` of time_r1_tpu/ops/int4_matmul.py
// (pallas_call at :128): y (M, N) = x (M, K) @ dequant(W)^T, where W is the
// port's (N, K/2) uint8 weight with two k per byte as offset-8 unsigned
// nibbles (low nibble = even k, value = nibble - 8), and one f32 scale per
// output column applied to the f32 sum before the cast to x's dtype.
//
// What bounds it on the H100: at the decode shape M = 8 the product does
// 2·M = 16 operations per weight byte pair, far below the card's ~295 per
// byte, so the bound is streaming the packed weight (N·K/2 bytes) once. Both
// routes keep the unpack on chip, as the TPU kernel does.
//
// bf16 x, N % 16 == 0 and K % 128 == 0 (every Qwen2.5-VL 3B and 7B product):
// the tensor-core kernel `int4_mm_tc`, one launch on csrc/weight_stream.cuh.
// - A unit is 16 whole rows of W (16 outputs, one m16n8k16 A tile) over the
//   whole K; block b of a grid of one block per SM takes units
//   [b·n/G, (b+1)·n/G) (ops/int4_matmul.py::work_partition mirrors it). So
//   every output is one fixed-order f32 sum inside one block: no K split, no
//   partials in device memory, no atomics, two launches bit-equal.
// - One producer warp keeps a ring of stages full with bulk copies completed
//   on the stages' mbarriers. Where K/2 <= 2048 bytes (K = 2048 at 3B, 3584
//   at 7B) a stage is a unit's 16 whole rows, one contiguous span copied at
//   once (16 / 28 KB), and x's rows (a pass of 8 or 16) stay in shared memory,
//   copied ahead of the weights. Longer rows (the down projections) go in
//   stages of 16 row segments of 2048 / 1024 bytes, each with the matching
//   segment of x's rows (bulk copies of their own): a copy costs mostly per
//   copy, so segments stay long (PERF.md, Q2).
// - Eight consumer warps split each stage's 128-deep k-blocks (block kb to
//   warp kb % 8), turn each weight word into four bf16x2 A registers exactly
//   (a mask and an fma a register) and multiply on the tensor cores
//   (mma.sync m16n8k16, f32 sums) against x, whose 16-byte pieces four byte
//   permutes pair the same way (csrc/weight_stream.cuh has the fragment
//   layout). A warp takes its blocks of a stage in pairs, into two
//   accumulators (its j-th block to j % 2: two chains of dependent products
//   interleave); at the decode's 8 rows over whole-row stages the B fragments
//   of its first pair stay in registers for the pass. At a unit's end each
//   warp adds its two accumulators and hands the tile over on an mbarrier (RB
//   units in flight); a reducing warp of its own sums the tiles in warp
//   order, applies the scale to the f32 sum and casts once, off the
//   consumers' path. The conversion's integer instructions (half the fma
//   pipe's rate) and the consumers' latency bind the long products, the
//   stream of x's segments the down projections (PERF.md).
// - M runs in passes of 8 rows (16 rows a pass when M > 8); the weights
//   stream once per pass.
//
// f32 x (and any bf16 shape the rule above leaves out): the exact FMA kernel
// `int4_mm`. Each thread owns one output column, reads its packed row 16
// bytes at a time, splits every byte into its two signed values in registers
// and multiplies them against 8 rows of x that the block stages in shared
// memory (a broadcast). M runs in tiles of 8 rows. Too few column blocks
// (N/128 = 16 for the (2048, 11008) down projection) would leave most SMs
// idle, so K is split across blocks as well (grid.y) and a second kernel sums
// the f32 partials in a fixed order, scales and casts: deterministic, no
// atomics. With one split the first kernel writes y itself. Ragged K and N are
// masked there: K/2 need not divide any block, and rows whose length is not a
// multiple of 16 bytes (or are not 16-byte aligned) take the byte-wise path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "weight_stream.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(bf16* p, float x) { *p = __float2bfloat16(x); }

// ---------------------------------------------------------------------------
// The FMA kernel (f32 x, ragged bf16 shapes)
namespace scalar {

constexpr int NT = 128;  // threads per block = output columns per block
constexpr int MT = 8;    // rows of x per pass
constexpr int KT = 512;  // k values of x staged per tile (a multiple of 32)

// Both values of one packed byte against column c (even) of the staged x tile.
__device__ __forceinline__ void fma_byte(float (&acc)[MT], const float (*xs)[KT], int c, unsigned b) {
  const float lo = (float)((int)(b & 15u) - 8);
  const float hi = (float)((int)((b >> 4) & 15u) - 8);
#pragma unroll
  for (int r = 0; r < MT; ++r) acc[r] = fmaf(xs[r][c + 1], hi, fmaf(xs[r][c], lo, acc[r]));
}

__device__ __forceinline__ void fma_word(float (&acc)[MT], const float (*xs)[KT], int c, unsigned w) {
#pragma unroll
  for (int e = 0; e < 4; ++e) fma_byte(acc, xs, c + 2 * e, (w >> (8 * e)) & 255u);
}

template <typename T>
__global__ void __launch_bounds__(NT) int4_mm(const T* __restrict__ x, const uint8_t* __restrict__ w,
                                              const float* __restrict__ s, T* __restrict__ y,
                                              float* __restrict__ part, int M, int K, int N,
                                              int k_per_split, int vec) {
  __shared__ float xs[MT][KT];
  const int n = blockIdx.x * NT + threadIdx.x;
  const int split = blockIdx.y;
  const int kb = split * k_per_split;
  const int ke = min(K, kb + k_per_split);
  const long long K2 = K / 2;
  const uint8_t* wrow = w + (long long)min(n, N - 1) * K2;

  for (int m0 = 0; m0 < M; m0 += MT) {
    float acc[MT];
#pragma unroll
    for (int r = 0; r < MT; ++r) acc[r] = 0.f;
    for (int k0 = kb; k0 < ke; k0 += KT) {
      const int kn = min(KT, ke - k0);  // even: K, kb and KT are
      __syncthreads();                  // the previous tile is consumed
      for (int idx = threadIdx.x; idx < MT * KT; idx += NT) {
        const int r = idx / KT;
        const int c = idx - r * KT;
        xs[r][c] = (m0 + r < M && c < kn) ? to_f(x[(long long)(m0 + r) * K + k0 + c]) : 0.f;
      }
      __syncthreads();
      if (n < N) {
        const uint8_t* wp = wrow + k0 / 2;
        const int nb = kn / 2;
        int j = 0;
        if (vec) {
          for (; j + 16 <= nb; j += 16) {
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(wp + j));
            fma_word(acc, xs, 2 * j, v.x);
            fma_word(acc, xs, 2 * j + 8, v.y);
            fma_word(acc, xs, 2 * j + 16, v.z);
            fma_word(acc, xs, 2 * j + 24, v.w);
          }
        }
        for (; j < nb; ++j) fma_byte(acc, xs, 2 * j, __ldg(wp + j));
      }
    }
    if (n < N) {
      for (int r = 0; r < MT && m0 + r < M; ++r) {
        if (part != nullptr)
          part[((long long)split * M + m0 + r) * N + n] = acc[r];
        else
          store_f(y + (long long)(m0 + r) * N + n, acc[r] * s[n]);
      }
    }
  }
}

template <typename T>
__global__ void int4_mm_reduce(const float* __restrict__ part, const float* __restrict__ s,
                               T* __restrict__ y, int M, int N, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)M * N) return;
  float sum = 0.f;
  for (int sp = 0; sp < splits; ++sp) sum += part[(long long)sp * M * N + i];
  store_f(y + i, sum * s[i % N]);
}

template <typename T>
int launch(const void* x, const void* w, const float* s, void* y, float* part, int M, int K, int N,
           int k_per_split, int splits, int vec, cudaStream_t stream) {
  const dim3 grid((N + NT - 1) / NT, splits);
  int4_mm<T><<<grid, NT, 0, stream>>>(static_cast<const T*>(x), static_cast<const uint8_t*>(w), s,
                                      static_cast<T*>(y), splits > 1 ? part : nullptr, M, K, N,
                                      k_per_split, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = (long long)M * N;
  int4_mm_reduce<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(part, s, static_cast<T*>(y), M, N,
                                                                          splits);
  return cudaGetLastError();
}

}  // namespace scalar

// ---------------------------------------------------------------------------
// The tensor-core kernel (bf16 x, N % 16 == 0, K % 128 == 0)
namespace tc {

using namespace t1::ws;

constexpr int CW = 8;              // consumer warps
constexpr int NT = (CW + 2) * 32;  // and one producer warp, one reducing warp
constexpr int ROWS = 16;           // weight rows of a unit (one A tile)
constexpr int KB = 64;             // bytes of a weight row in one 128-deep k-block
constexpr int MAX_SMEM = 232448;   // a block's dynamic shared memory on the H100
constexpr int MAX_STAGES = 8;
constexpr int WHOLE_MAX = 2048;    // row bytes up to which a stage is a unit's whole rows
constexpr int RED = 256;           // offset of the partial tiles (after the barriers)
constexpr int RB = 4;              // buffers of partial tiles (units in flight to the reducing warp)

template <int NTILE>
__host__ __device__ constexpr int red_bytes() { return RB * CW * NTILE * 32 * 16; }

__host__ __device__ constexpr int align128(int v) { return (v + 127) & ~127; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// Where a block's shared memory goes, from (K, NTILE): the ring's stages of
// `stage_bytes` (weight rows at pitch `wp`; with `whole` == 0 each stage's x
// segment follows its 16 rows, at pitch `xp`), and with `whole` x's pass of
// rows at x_off, pitch xp. Pitches of 16 mod 128 bytes put rows g and g + 1
// on other banks (a whole-row stage keeps the rows' own pitch K/2).
struct Layout {
  int whole, kc, wp, xp, x_off, ring_off, stage_bytes, nst, smem;
};

template <int NTILE>
Layout layout(int K) {
  const int K2 = K / 2, MT = 8 * NTILE;
  Layout l{};
  l.whole = K2 <= WHOLE_MAX;
  if (l.whole) {
    l.kc = l.wp = K2;
    l.xp = 2 * K + 16;
    l.x_off = RED + red_bytes<NTILE>();
    l.ring_off = align128(l.x_off + MT * l.xp);
    l.stage_bytes = ROWS * K2;
  } else {
    l.kc = 2048 / NTILE;
    l.wp = l.kc + 16;
    l.xp = 4 * l.kc + 16;  // 2·kc bf16 of x a row
    l.x_off = 0;
    l.ring_off = align128(RED + red_bytes<NTILE>());
    l.stage_bytes = align128(ROWS * l.wp + MT * l.xp);
  }
  l.nst = imin(MAX_STAGES, (MAX_SMEM - l.ring_off) / l.stage_bytes);
  l.smem = l.ring_off + l.nst * l.stage_bytes;
  return l;
}

// Units [unit_begin(n, G, b), unit_begin(n, G, b + 1)) are block b's.
__host__ __device__ inline int unit_begin(int n, int grid, int b) { return (int)((long long)b * n / grid); }

struct Params {
  const bf16* x;
  const uint8_t* w;
  const float* s;
  bf16* y;
  int M, K, N;
  Layout l;
  // A timing build's parts (bits): 1 the stream (copies, waits, no
  // products), 2 the products (over stale stages, no copies). The kernel is 3.
  int parts;
};

template <int NTILE>
__global__ void __launch_bounds__(NT, 1) int4_mm_tc(const __grid_constant__ Params p) {
  constexpr int MT = 8 * NTILE;
  extern __shared__ __align__(128) uint8_t smem[];
  // barriers: the ring's full / empty, the partial tiles' (RB buffers) full /
  // read out, and x's pass full / read out
  const uint32_t full = smem_u32(smem), empty = full + 8 * MAX_STAGES;
  const uint32_t red_full = empty + 8 * MAX_STAGES, red_free = red_full + 8 * RB;
  const uint32_t x_full = red_free + 8 * RB, x_empty = x_full + 8;
  float4* red = reinterpret_cast<float4*>(smem + RED);
  uint8_t* ring = smem + p.l.ring_off;
  uint8_t* xres = smem + p.l.x_off;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#ifdef T1_Q1_PROFILE_PARTS
  const int parts = p.parts;
#else
  constexpr int parts = 3;
#endif
  const bool whole = p.l.whole;
  const int nst = p.l.nst, K2 = p.K / 2, kc = p.l.kc, wp = p.l.wp, xp = p.l.xp;
  const int n_units = p.N / ROWS, u0 = unit_begin(n_units, gridDim.x, blockIdx.x);
  const int nu = unit_begin(n_units, gridDim.x, blockIdx.x + 1) - u0;
  const int chunks = (K2 + kc - 1) / kc, passes = (p.M + MT - 1) / MT;

  if (threadIdx.x == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CW);
    }
    for (int s = 0; s < RB; ++s) {
      mbar_init(red_full + 8 * s, CW);
      mbar_init(red_free + 8 * s, 1);
    }
    mbar_init(x_full, 1);
    mbar_init(x_empty, CW);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == CW) {  // ---- the producer
    if (!(parts & 1)) return;
    int slot = 0, phase = 0, q = 0;
    for (int m0 = 0; m0 < p.M; m0 += MT) {
      const int mrows = min(MT, p.M - m0);
      if (whole) {  // this pass's rows of x, ahead of its weights, once the last pass's are read out
        if (m0 > 0) mbar_wait(x_empty, (m0 / MT - 1) & 1);
        if (lane == 0) mbar_arrive_expect_tx(x_full, mrows * 2 * p.K);
        __syncwarp();
        if (lane < mrows)
          bulk_copy(smem_u32(xres + lane * xp), p.x + (long long)(m0 + lane) * p.K, 2 * p.K, x_full);
      }
      for (int u = u0; u < u0 + nu; ++u) {
        for (int c = 0; c < chunks; ++c, ++q) {
          const int kcc = min(kc, K2 - c * kc);
          if (q >= nst) mbar_wait(empty + 8 * slot, phase ^ 1);
          const uint32_t bar = full + 8 * slot;
          uint8_t* st = ring + slot * p.l.stage_bytes;
          const uint8_t* wsrc = p.w + (long long)ROWS * u * K2;
          if (lane == 0) mbar_arrive_expect_tx(bar, ROWS * kcc + (whole ? 0 : mrows * 4 * kcc));
          __syncwarp();
          if (whole) {
            if (lane == 0) bulk_copy(smem_u32(st), wsrc, ROWS * K2, bar);
          } else if (lane < ROWS) {
            bulk_copy(smem_u32(st + lane * wp), wsrc + (long long)lane * K2 + c * kc, kcc, bar);
          } else if (lane - ROWS < mrows) {  // x row m0 + lane - 16, k = 2·c·kc ..
            const int m = lane - ROWS;
            bulk_copy(smem_u32(st + ROWS * wp + m * xp), p.x + (long long)(m0 + m) * p.K + 2 * c * kc, 4 * kcc,
                      bar);
          }
          if (++slot == nst) slot = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  const int nunits = passes * nu;
  if (warp == CW + 1) {  // ---- the reducing warp: unit n's tiles from buffer n % RB, in warp order
    float s0 = 0.f, s1 = 0.f;  // the scales of rows g / g + 8 of unit n, loaded one unit ahead
    auto load_scales = [&](int n) {
      if (n >= nunits) return;
      const int row = ROWS * (u0 + n % nu) + g;
      s0 = p.s[row], s1 = p.s[row + 8];
    };
    load_scales(0);
    for (int n = 0; n < nunits; ++n) {
      const int buf = n % RB, u = u0 + n % nu, m0 = n / nu * MT, ntl = min(NTILE, (p.M - m0 + 7) / 8);
      const float c0 = s0, c1 = s1;
      load_scales(n + 1);
      mbar_wait(red_full + 8 * buf, (n / RB) & 1);
      for (int nt = 0; nt < ntl; ++nt) {
        float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int w = 0; w < CW; ++w) {
          const float4 v = red[((buf * CW + w) * NTILE + nt) * 32 + lane];
          sum[0] += v.x, sum[1] += v.y, sum[2] += v.z, sum[3] += v.w;
        }
        // rows g / g + 8 of the tile are outputs 16u + g / 16u + 8 + g, columns rows m of x
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + nt * 8 + 2 * t + e;
          if (m >= p.M) continue;
          bf16* y = p.y + (long long)m * p.N + ROWS * u + g;
          y[0] = __float2bfloat16(sum[e] * c0);
          y[8] = __float2bfloat16(sum[2 + e] * c1);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(red_free + 8 * buf);
    }
    return;
  }

  // ---- the consumers
  // A warp's j-th block of a stage (kb = warp + 8j) goes to accumulator j % 2:
  // blocks go in pairs, two chains of dependent products that interleave.
  float acc[2][NTILE][4] = {};
  int slot = 0, phase = 0, nunit = 0;
  // At one 8-row tile of x over whole-row stages (the decode products), a
  // warp's k-blocks are the same in every unit: the B fragments of its first
  // pair stay in registers for the pass (all its blocks at 3B; at 7B, 28
  // blocks, a second pair comes from shared memory).
  const bool xreg = NTILE == 1 && whole;
  uint4 xf[2][NTILE][4];

  // A unit's end: each warp adds its two accumulators and stores the tile to
  // buffer n % RB (once the reducing warp has read out unit n - RB's).
  auto finish = [&]() {
    const int buf = nunit % RB, use = nunit / RB;
    if (use > 0) mbar_wait(red_free + 8 * buf, (use - 1) & 1);
#pragma unroll
    for (int nt = 0; nt < NTILE; ++nt) {
      red[((buf * CW + warp) * NTILE + nt) * 32 + lane] = make_float4(
          acc[0][nt][0] + acc[1][nt][0], acc[0][nt][1] + acc[1][nt][1], acc[0][nt][2] + acc[1][nt][2],
          acc[0][nt][3] + acc[1][nt][3]);
#pragma unroll
      for (int i = 0; i < 2; ++i) acc[i][nt][0] = acc[i][nt][1] = acc[i][nt][2] = acc[i][nt][3] = 0.f;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(red_full + 8 * buf);
    ++nunit;
  };

  // Blocks kb0 and kb1 of the stage at `wr` against B fragments x0 / x1 (an
  // absent second block is kb0 again against zero B: its products add 0,
  // which changes no sum).
  auto pair = [&](const uint8_t* wr, int kb0, int kb1, const uint4 (&x0)[NTILE][4], const uint4 (&x1)[NTILE][4],
                  int ntl) {
    uint32_t a0[8][4], a1[8][4];
    int4_block_frags(*reinterpret_cast<const uint4*>(wr + kb0 * KB),
                     *reinterpret_cast<const uint4*>(wr + 8 * wp + kb0 * KB), a0);
    int4_block_frags(*reinterpret_cast<const uint4*>(wr + kb1 * KB),
                     *reinterpret_cast<const uint4*>(wr + 8 * wp + kb1 * KB), a1);
#pragma unroll
    for (int nt = 0; nt < NTILE; ++nt) {
      if (nt < ntl) {
        mma_int4_block(acc[0][nt], a0, x0[nt]);
        mma_int4_block(acc[1][nt], a1, x1[nt]);
      }
    }
  };

  for (int m0 = 0; m0 < p.M; m0 += MT) {
    const int ntl = min(NTILE, (p.M - m0 + 7) / 8);
    if (whole && (parts & 1)) mbar_wait(x_full, (m0 / MT) & 1);
    if (xreg) {  // B fragments of blocks warp and warp + 8; zero past the row
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kb = warp + CW * j;
        const uint4* xr = reinterpret_cast<const uint4*>(xres + g * xp + 64 * t + min(kb, K2 / KB - 1) * 4 * KB);
#pragma unroll
        for (int q = 0; q < 4; ++q) xf[j][0][q] = kb < K2 / KB ? int4_b_frags(xr[q]) : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    for (int u = u0; u < u0 + nu; ++u) {
      for (int c = 0; c < chunks; ++c) {
        const int nkb = min(kc, K2 - c * kc) / KB;
        if (parts & 1) mbar_wait(full + 8 * slot, phase);
        const uint8_t* st = ring + slot * p.l.stage_bytes;
        const uint8_t* wr = st + g * wp + 16 * t;
        const uint8_t* xb = (whole ? xres : st + ROWS * wp) + g * xp + 64 * t;
        for (int kb0 = warp; kb0 < nkb && (parts & 2); kb0 += 2 * CW) {
          const bool has1 = kb0 + CW < nkb;
          const int kb1 = has1 ? kb0 + CW : kb0;
          if (xreg && kb0 == warp) {
            pair(wr, kb0, kb1, xf[0], xf[1], 1);
            continue;
          }
          uint4 x0[NTILE][4], x1[NTILE][4];
#pragma unroll
          for (int nt = 0; nt < NTILE; ++nt) {
            const uint4* r0 = reinterpret_cast<const uint4*>(xb + nt * 8 * xp + kb0 * 4 * KB);
            const uint4* r1 = reinterpret_cast<const uint4*>(xb + nt * 8 * xp + kb1 * 4 * KB);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              x0[nt][q] = int4_b_frags(r0[q]);
              x1[nt][q] = has1 ? int4_b_frags(r1[q]) : make_uint4(0u, 0u, 0u, 0u);
            }
          }
          pair(wr, kb0, kb1, x0, x1, ntl);
        }
        __syncwarp();
        if ((parts & 1) && lane == 0) mbar_arrive(empty + 8 * slot);
        if (++slot == nst) slot = 0, phase ^= 1;
      }
      finish();
    }
    if (whole && (parts & 1) && lane == 0) mbar_arrive(x_empty);  // this pass's x is read out
  }
}

// One launch on `stream` of one block per SM (at most one per unit).
template <int NTILE>
int launch(Params p, cudaStream_t stream) {
  p.l = layout<NTILE>(p.K);
  if (p.l.nst < 2) return -2;
  static int sms = 0, smem_set = 0;  // per instance: the device's SMs, the shared memory allowed so far
  cudaError_t err;
  if (sms == 0) {
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  }
  if (p.l.smem > smem_set) {
    err = cudaFuncSetAttribute(int4_mm_tc<NTILE>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    smem_set = MAX_SMEM;
  }
  const int grid = imin(p.N / ROWS, sms);
  int4_mm_tc<NTILE><<<grid, NT, p.l.smem, stream>>>(p);
  return cudaGetLastError();
}

bool takes(int M, int K, int N) { return M >= 1 && K > 0 && N > 0 && K % 128 == 0 && N % ROWS == 0; }

int dispatch(const void* x, const void* w, const float* s, void* y, int M, int K, int N, int parts,
             cudaStream_t stream) {
  if (!takes(M, K, N)) return -2;
  if (((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) & 15) != 0) return -4;
  Params p{static_cast<const bf16*>(x), static_cast<const uint8_t*>(w), s, static_cast<bf16*>(y), M, K, N, {},
           parts};
  return M > 8 ? launch<2>(p, stream) : launch<1>(p, stream);
}

}  // namespace tc

}  // namespace

// FMA kernel. dtype: 0 = float32, 1 = bfloat16 (x and y). k_per_split is a
// multiple of KT (or covers K); part is (splits, M, N) f32 scratch when
// splits > 1.
extern "C" int t1_int4_matmul(int dtype, const void* x, const void* w, const float* s, void* y, float* part,
                              int M, int K, int N, int k_per_split, int splits, int vec, void* stream) {
  using namespace scalar;
  if (K % 2 != 0 || M < 1 || N < 1 || splits < 1 || (splits > 1 && part == nullptr)) return -2;
  if (splits > 1 && k_per_split % KT != 0) return -3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, s, y, part, M, K, N, k_per_split, splits, vec, st);
  if (dtype == 1) return launch<bf16>(x, w, s, y, part, M, K, N, k_per_split, splits, vec, st);
  return -1;
}

// Tensor-core kernel: bf16 x (M, K) and y (M, N), K % 128 == 0, N % 16 == 0,
// x and w 16-byte aligned. One launch on `stream`.
extern "C" int t1_int4_matmul_tc(const void* x, const void* w, const float* s, void* y, int M, int K, int N,
                                 void* stream) {
  return tc::dispatch(x, w, s, y, M, K, N, 3, static_cast<cudaStream_t>(stream));
}

// A tensor-core block's ring stages and dynamic shared memory at (M, K): stages · 2^20 + bytes.
extern "C" int t1_int4_matmul_tc_smem(int M, int K) {
  const tc::Layout l = M > 8 ? tc::layout<2>(K) : tc::layout<1>(K);
  return l.nst * (1 << 20) + l.smem;
}

#ifdef T1_Q1_PROFILE_PARTS
// A timing build's launch of the parts (Params::parts) of the tensor-core kernel.
extern "C" int t1_int4_matmul_tc_part(int parts, const void* x, const void* w, const float* s, void* y, int M,
                                      int K, int N, void* stream) {
  if (parts < 1 || parts > 3) return -2;
  return tc::dispatch(x, w, s, y, M, K, N, parts, static_cast<cudaStream_t>(stream));
}
#endif
