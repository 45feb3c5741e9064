// P1 and P2: the paged decode step's attention over each slot's KV pages.
//
// Replaces the Pallas kernels of time_r1_tpu/ops/paged_attention.py:
// - P1 `paged_prefix_attention` (pallas_call at :163): online softmax of the
//   G grouped query rows of each (slot, kv head) over the slot's cache prefix
//   [0, lengths[s]), read in place from its pages through the page table,
//   returning the unnormalised (acc, m, l);
// - P2 `paged_prefix_attention_q8` (pallas_call at :311): the same over int8
//   pages with per-(token, head) f32 scales. K scales multiply the scores
//   after Q·K, V scales the probabilities before P·V, and `l` sums the
//   unscaled probabilities (`_kernel_q8`, :197-237), so no bf16 K/V is
//   materialized.
//
// Layout (the JAX package's): q (S, Hkv, G, D) contiguous; pages
// (Hkv, n_pages, P, D) through strides (the pool's per-layer slice is a view);
// scales (Hkv, n_pages, P) through strides; page table (S, max_pages) and
// lengths (S,) int32, read from device memory, because the lengths move on
// the device inside a decode segment. Any page size P >= 1 and any length in
// [0, max_pages·P] (a larger one is taken as max_pages·P, the plain version's
// view of the table).
//
// The TPU grid (S, Hkv, max_pages) walks a slot's pages in order on one core,
// carrying (m, l, acc) in VMEM scratch; at the serving step (4 slots, 2 kv
// heads) the same grid on the GPU would be 8 blocks on 132 SMs. So the prefix
// is split, as D1 splits its shared prefix (decode_attention.cu):
// `paged_split` gives every (64-key chunk, kv head, slot) its own block. The
// block looks up the page of each of its keys in the slot's table row (a
// chunk may span pages when P < 64, or be half a page at P = 128), stages the
// chunk's K and V in f32 in shared memory, scores the G rows against it (one
// warp per row, two keys per lane), masks pos >= length, and writes the
// chunk's partial (acc, m, l). A block whose chunk starts at or past its
// slot's length exits at once. `paged_fold` then folds the ceil(length / 64)
// live partials of each (slot, head, row) in a fixed order: deterministic, no
// atomics; an empty slot folds nothing and ends at m = -1e30, l = 0, acc = 0.
//
// What bounds them on the H100: each key is used by the G = 8 rows of its
// head, about 8 operations per byte of bf16 K/V (16 for int8), far below the
// card's ~295 operations per byte, so the bound is reading the live pages
// once (K and V, plus the scales in P2): at the serving step (lengths 0, 327,
// 1689, 2041; hd 128; 2 kv heads) about 4.2 MB of bf16 per layer-step, 1.2 us
// at 3.35 TB/s. The arithmetic is plain f32 FMA out of shared memory (tensor
// cores, TMA and a fused fold are later work).
#include <stdint.h>

#include "attention_tile.cuh"

namespace t1 {

__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

// The launch arguments, one struct (mirrored by ops/paged_attention.py::_Params).
struct PagedParams {
  const void* q;        // (S, Hkv, G, D) contiguous
  const void* kp;       // pages (Hkv, n_pages, P, D) through the kv_s* strides
  const void* vp;
  const float* ks;      // scales (Hkv, n_pages, P) through the s_s* strides (int8 only)
  const float* vs;
  const int* table;     // (S, max_pages) contiguous
  const int* lengths;   // (S,)
  float* acc_part;      // (S, Hkv, nchunk, G, D)
  float* m_part;        // (S, Hkv, nchunk, G)
  float* l_part;
  float* acc;           // (S, Hkv, G, D)
  float* m;             // (S, Hkv, G)
  float* l;
  long long kv_sh, kv_sp, kv_st;
  long long s_sh, s_sp, s_st;
  int S, Hkv, G, P, max_pages, nchunk;
  float scale;
};

}  // namespace t1

namespace {

using t1::NEG_INF;
using t1::PagedParams;
using t1::to_f;

constexpr int CH = 64;  // keys per split block: two per lane of a warp
constexpr int NTH = 256;
constexpr int NWARPS = NTH / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int slot_length(const PagedParams& p, int s) {
  return min(max(p.lengths[s], 0), p.max_pages * p.P);
}

template <int D>
constexpr int split_smem_floats() {
  // K [CH][D+1] + V [CH][D] + q rows [NWARPS][D] + p [NWARPS][CH] + k/v scales [CH]
  return CH * (D + 1) + CH * D + NWARPS * D + NWARPS * CH + 2 * CH;
}

// One block per (64-key chunk, kv head, slot): the chunk's (acc, m, l) for the G rows.
template <typename T, typename C, int D, bool QUANT>
__global__ void __launch_bounds__(NTH) paged_split(const PagedParams p) {
  extern __shared__ float smem[];
  float* Ks = smem;                 // [CH][D+1]
  float* Vs = Ks + CH * (D + 1);    // [CH][D]
  float* qs = Vs + CH * D;          // [NWARPS][D]
  float* ps = qs + NWARPS * D;      // [NWARPS][CH]
  float* ksc = ps + NWARPS * CH;    // [CH]
  float* vsc = ksc + CH;
  __shared__ long long kv_off[CH];  // element offset of each key's row in its head's pages
  constexpr int DJ = D / 32;
  constexpr int KS = D + 1;

  const int chunk = blockIdx.x;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int len = slot_length(p, s);
  const int t0 = chunk * CH;
  if (t0 >= len) return;  // the whole block: nothing of this slot lies here
  const int nk = min(CH, len - t0);
  const int* row = p.table + (long long)s * p.max_pages;

  for (int c = threadIdx.x; c < CH; c += NTH) {
    float kx = 0.f, vx = 0.f;
    long long off = 0;
    if (c < nk) {
      const int t = t0 + c;
      const int j = t / p.P;
      const long long page = row[j];
      const long long in_page = t - j * p.P;
      off = h * p.kv_sh + page * p.kv_sp + in_page * p.kv_st;
      if (QUANT) {
        const long long so = h * p.s_sh + page * p.s_sp + in_page * p.s_st;
        kx = p.ks[so];
        vx = p.vs[so];
      }
    }
    kv_off[c] = off;
    ksc[c] = kx;
    vsc[c] = vx;
  }
  __syncthreads();
  const C* kg = static_cast<const C*>(p.kp);
  const C* vg = static_cast<const C*>(p.vp);
  for (int idx = threadIdx.x; idx < CH * D; idx += NTH) {
    const int c = idx / D;
    const int d = idx - c * D;
    float kx = 0.f, vx = 0.f;
    if (c < nk) {
      kx = to_f(kg[kv_off[c] + d]);
      vx = to_f(vg[kv_off[c] + d]);
    }
    Ks[c * KS + d] = kx;
    Vs[c * D + d] = vx;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T* qg = static_cast<const T*>(p.q) + ((long long)s * p.Hkv + h) * p.G * D;
  const long long part0 = (((long long)s * p.Hkv + h) * p.nchunk + chunk) * p.G;
  float* qrow = qs + warp * D;
  float* prow = ps + warp * CH;
  const bool live0 = lane < nk;
  const bool live1 = lane + 32 < nk;
  for (int g = warp; g < p.G; g += NWARPS) {
#pragma unroll
    for (int j = 0; j < DJ; ++j) qrow[lane + 32 * j] = to_f(qg[(long long)g * D + lane + 32 * j]) * p.scale;
    __syncwarp();
    float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
      s0 = fmaf(qd, Ks[lane * KS + d], s0);
      s1 = fmaf(qd, Ks[(lane + 32) * KS + d], s1);
    }
    if (QUANT) {
      s0 *= ksc[lane];
      s1 *= ksc[lane + 32];
    }
    // nk >= 1, so the maximum is over at least one live key and is finite
    const float mx = warp_max(fmaxf(live0 ? s0 : -INFINITY, live1 ? s1 : -INFINITY));
    float p0 = live0 ? expf(s0 - mx) : 0.f;
    float p1 = live1 ? expf(s1 - mx) : 0.f;
    const float l = warp_sum(p0 + p1);
    if (QUANT) {
      p0 *= vsc[lane];
      p1 *= vsc[lane + 32];
    }
    prow[lane] = p0;
    prow[lane + 32] = p1;
    __syncwarp();
    float acc[DJ];
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[j] = 0.f;
    for (int c = 0; c < nk; ++c) {
      const float pc = prow[c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[j] = fmaf(pc, Vs[c * D + lane + 32 * j], acc[j]);
    }
    float* dst = p.acc_part + (part0 + g) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dst[lane + 32 * j] = acc[j];
    if (lane == 0) {
      p.m_part[part0 + g] = mx;
      p.l_part[part0 + g] = l;
    }
    __syncwarp();  // qrow and prow are reused by the warp's next row
  }
}

// The fold: one block per (row, kv head, slot) over the slot's live chunks.
__global__ void paged_fold(const PagedParams p, int D) {
  const int g = blockIdx.x;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int nc = (slot_length(p, s) + CH - 1) / CH;
  const long long base = ((long long)s * p.Hkv + h) * p.nchunk;
  float m = NEG_INF;
  for (int c = 0; c < nc; ++c) m = fmaxf(m, p.m_part[(base + c) * p.G + g]);
  float l = 0.f;
  for (int c = 0; c < nc; ++c) {
    const long long pi = (base + c) * p.G + g;
    l += expf(p.m_part[pi] - m) * p.l_part[pi];
  }
  const long long out_row = ((long long)s * p.Hkv + h) * p.G + g;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
    for (int c = 0; c < nc; ++c) {
      const long long pi = (base + c) * p.G + g;
      a += expf(p.m_part[pi] - m) * p.acc_part[pi * D + d];
    }
    p.acc[out_row * D + d] = a;
  }
  if (threadIdx.x == 0) {
    p.m[out_row] = m;
    p.l[out_row] = l;
  }
}

template <typename T, typename C, int D, bool QUANT>
int run_split(const PagedParams& p, cudaStream_t stream) {
  const int smem = split_smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(paged_split<T, C, D, QUANT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  paged_split<T, C, D, QUANT><<<dim3(p.nchunk, p.Hkv, p.S), NTH, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16 (q; the pages too unless quant); quant: int8
// pages with scales; D 64 or 128. -1: no instance.
extern "C" int t1_paged_split(int dtype, int quant, int D, const PagedParams* p, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || (D != 64 && D != 128)) return -1;
  if (dtype == 0) {
    if (quant) return D == 64 ? run_split<float, int8_t, 64, true>(*p, st) : run_split<float, int8_t, 128, true>(*p, st);
    return D == 64 ? run_split<float, float, 64, false>(*p, st) : run_split<float, float, 128, false>(*p, st);
  }
  if (quant)
    return D == 64 ? run_split<__nv_bfloat16, int8_t, 64, true>(*p, st)
                   : run_split<__nv_bfloat16, int8_t, 128, true>(*p, st);
  return D == 64 ? run_split<__nv_bfloat16, __nv_bfloat16, 64, false>(*p, st)
                 : run_split<__nv_bfloat16, __nv_bfloat16, 128, false>(*p, st);
}

extern "C" int t1_paged_fold(int D, const PagedParams* p, void* stream) {
  if (D != 64 && D != 128) return -1;
  paged_fold<<<dim3(p->G, p->Hkv, p->S), 128, 0, static_cast<cudaStream_t>(stream)>>>(*p, D);
  return cudaGetLastError();
}
