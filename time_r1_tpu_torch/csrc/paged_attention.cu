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
//   materialized in device memory.
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
// is split into chunks, each its own block, and the chunks' partial states
// are folded in a fixed order. Two routes, by q's dtype:
// - f32 q (the exact route that the card-against-CPU token checks rest on):
//   `paged_split` gives every (64-key chunk, kv head, slot) its own block,
//   which looks up each key's page, stages the chunk's K and V in f32, scores
//   the G rows against it in f32 FMA (one warp per row, two keys per lane),
//   masks pos >= length and writes the chunk's partial (acc, m, l);
//   `paged_fold` then folds the ceil(length / 64) live partials of each
//   (slot, head, row) in chunk order. Two launches.
// - bf16 q (`paged_tc`, further down): one launch on the tensor cores.
//
// What bounds them on the H100: each key is used by the G = 8 rows of its
// head, about 8 operations per byte of bf16 K/V (16 for int8), far below the
// card's ~295 operations per byte, so the bound is reading the live pages
// once (K and V, plus the scales in P2): at the serving step (lengths 0, 327,
// 1689, 2041; hd 128; 2 kv heads) about 4.2 MB of bf16 per layer-step, 1.2 us
// at 3.35 TB/s (int8: 2.1 MB, 0.6 us).
#include <stdint.h>

#include <type_traits>

#include "attention_tile.cuh"
#include "weight_stream.cuh"
#include "wgmma_tile.cuh"

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
  int* ticket;          // (S, Hkv), zero between launches (tensor-core route only)
  int ctiles;           // 64-key tiles a chunk (tensor-core route only)
};

// A slot's live keys: its length, clamped to [0, max_pages·P]. Every block of
// a (slot, kv head) reads the same value, so all agree on the live chunks.
__device__ __forceinline__ int slot_length(const PagedParams& p, int s) {
  return min(max(p.lengths[s], 0), p.max_pages * p.P);
}

}  // namespace t1

namespace {

using t1::NEG_INF;
using t1::PagedParams;
using t1::slot_length;
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

template <int D>
constexpr int split_smem_floats() {
  // K [CH][D+1] + V [CH][D] + q rows [NWARPS][D] + p [NWARPS][CH] + k/v scales [CH]
  return CH * (D + 1) + CH * D + NWARPS * D + NWARPS * CH + 2 * CH;
}

// One block per (64-key chunk, kv head, slot): the chunk's (acc, m, l) for the G rows.
template <typename C, int D, bool QUANT>
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
  const float* qg = static_cast<const float*>(p.q) + ((long long)s * p.Hkv + h) * p.G * D;
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

template <typename C, int D, bool QUANT>
int run_split(const PagedParams& p, cudaStream_t stream) {
  const int smem = split_smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(paged_split<C, D, QUANT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  paged_split<C, D, QUANT><<<dim3(p.nchunk, p.Hkv, p.S), NTH, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The f32 route's split pass (f32 q; bf16 q runs t1_paged_tc): quant: int8
// pages with scales, else f32 pages; D 64 or 128. -1: no instance.
extern "C" int t1_paged_split(int quant, int D, const PagedParams* p, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != 64 && D != 128) return -1;
  if (quant) return D == 64 ? run_split<int8_t, 64, true>(*p, st) : run_split<int8_t, 128, true>(*p, st);
  return D == 64 ? run_split<float, 64, false>(*p, st) : run_split<float, 128, false>(*p, st);
}

extern "C" int t1_paged_fold(int D, const PagedParams* p, void* stream) {
  if (D != 64 && D != 128) return -1;
  paged_fold<<<dim3(p->G, p->Hkv, p->S), 128, 0, static_cast<cudaStream_t>(stream)>>>(*p, D);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// P1 and P2 in bf16 on Hopper's tensor cores (`t1_paged_tc`): bf16 q over
// bf16 pages (P1) or int8 pages and their scales (P2), one launch a call.
//
// Grid (nchunk, Hkv, S), four warps a block. Chunk x of a slot holds keys
// [x·CT·64, (x + 1)·CT·64), CT = `ctiles` <= 4 64-key tiles
// (ops/paged_attention.py::tc_chunk_tiles):
// - a block whose chunk starts at or past its slot's device length exits at
//   once and takes no ticket; block 0 of an empty slot writes the exact empty
//   state (acc = 0, m = -1e30, l = 0); a dead slot's stale table row is read
//   but never followed;
// - the gather: a key row is D·2 bytes (D in int8) and lies whole inside its
//   page whatever P is, so the block looks up each of its rows' pages in the
//   slot's table row once (while the length is read, not after it) and
//   copies the rows' 16-byte pieces with cp.async into the 128-byte-swizzled
//   tile of wgmma_tile.cuh. Every live tile of the block is in flight at
//   once, each completed on its own mbarrier, so the warps start on tile 0
//   while the next tiles land (the ring's overlap, with every stage issued up
//   front); keys past the length are zero-filled, never fetched. int8 tiles
//   land raw, with their K and V scales, and each warp converts its rows to
//   bf16 exactly (int8x16_to_bf16) into the same swizzled layout;
// - warp w takes rows 16w .. 16w + 15 of every tile, with its own online
//   softmax, rows on the M side of mma.sync m16n8k16: the G <= 16 query rows
//   (the rest zero) are the A fragment, held in registers; the K rows through
//   ldmatrix are B, giving S = Q·Kᵀ (16 x 16) in f32; x = S·hd^-0.5 (·k
//   scale); keys past the length -inf; the row max and sum stay in a quad of
//   lanes; p = exp(x - m); l sums the unrounded p; p ·= v scale; P rounded to
//   bf16 is the A fragment of O += P·V, V through ldmatrix.trans. A 64-key
//   tile is one step of all four warps, so a block at CT = 1 already spreads
//   its products (and P2's conversion) over its warps;
// - the warps' (O, m, l) merge in shared memory in warp order (weights
//   exp(m_w - m)); a slot of one chunk writes the result, otherwise the block
//   writes its f32 partial, then takes an integer ticket of its (slot, kv
//   head). The block that draws ticket ceil(len / chunk) - 1 loads the live
//   chunks' m and l in one round, folds the partials in chunk order (weights
//   exp(m_c - m), no float atomics: two launches on the same inputs are
//   bit-equal), writes (acc, m, l) and resets the ticket to 0 for the next
//   launch (the tickets are reused, so launches that share them must be
//   stream-ordered), as D2 does (decode_attention.cu).
//
// Why mma.sync and not wgmma: a wgmma tile has 64 rows, of which G = 8 (7 at
// 7B) would be live, and wide products do not bind here: the bound is bytes.
namespace t1 {
namespace tc {

constexpr int PG_WARPS = 4;  // warps a block, each on 16 rows of every 64-key tile; CT <= PG_WARPS
constexpr int PG_NT = PG_WARPS * 32;

// A tile's shared memory: bf16 K and V (swizzled); int8: raw K and V rows,
// then the 64 K scales and 64 V scales.
template <int D, bool QUANT>
__host__ __device__ constexpr int pg_tile_bytes() {
  return 2 * tile_bytes<D>() + (QUANT ? 2 * 64 * D + 2 * 64 * 4 : 0);
}

// 128 bytes of alignment, then the tiles, or the fold's m and l (2 x nchunk
// x 16 rows of f32) and its buffer of partials (at least PG_FOLD_BYTES) where
// those are larger. The warps' merged states go over tile 0 (PG_WARPS x 16
// rows x D f32: its bf16 K and V).
constexpr int PG_FOLD_BYTES = 64 * 1024;  // 16 chunks' partials at G = 8, D = 128

template <int D, bool QUANT>
__host__ __device__ constexpr int pg_smem_bytes(int ctiles, int nchunk) {
  return 128 + (ctiles * pg_tile_bytes<D, QUANT>() > 2 * nchunk * 16 * 4 + PG_FOLD_BYTES
                    ? ctiles * pg_tile_bytes<D, QUANT>()
                    : 2 * nchunk * 16 * 4 + PG_FOLD_BYTES);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// STOP 5 is the kernel; a timing build also instantiates 0-4, which return at
// the entry (0), once the block knows whether it is live (1), once every warp
// has its tiles (2), once every warp has its (O, m, l) (3), or once the block
// has written its merged state (4), and take no ticket (t1_paged_tc_stop).
template <int D, bool QUANT, int STOP = 5>
__global__ void __launch_bounds__(PG_NT) paged_tc(const __grid_constant__ PagedParams p) {
  using C = typename std::conditional<QUANT, int8_t, bf16>::type;
  constexpr int TILE = tile_bytes<D>();
  constexpr int PER_TILE = pg_tile_bytes<D, QUANT>();
  extern __shared__ uint8_t pg_smem[];
  __shared__ __align__(8) uint64_t bars[PG_WARPS];
  __shared__ int row_page[PG_WARPS * 64], row_at[PG_WARPS * 64];  // each chunk row's page and place in it
  __shared__ float wm[PG_WARPS][16], wl[PG_WARPS][16];            // the warps' m and l
  __shared__ float fmax_row[16];                                  // the fold's m
  __shared__ int last;

  if constexpr (STOP == 0) return;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int chunk = blockIdx.x;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int G = p.G;
  const int ck = p.ctiles * 64;
  const int c0 = chunk * ck;
  const long long sh = (long long)s * p.Hkv + h;
  // the chunk rows' pages, read from the table row while the length is read
  const int* row_tab = p.table + (long long)s * p.max_pages;
  int pg[2], at_pg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = c0 + tid + PG_NT * i;
    const int j = min(key / p.P, p.max_pages - 1);
    pg[i] = tid + PG_NT * i < ck ? row_tab[j] : 0;
    at_pg[i] = key - j * p.P;
  }
  const int len = slot_length(p, s);
  float* acc_out = p.acc + sh * G * D;
  if (c0 >= len) {
    if (len == 0 && chunk == 0) {  // the empty state, exactly
      for (int i = tid; i < G * D; i += PG_NT) acc_out[i] = 0.f;
      if (tid < G) {
        p.m[sh * G + tid] = NEG_INF;
        p.l[sh * G + tid] = 0.f;
      }
    }
    return;
  }
  if constexpr (STOP == 1) return;
  const int g = lane >> 2;  // the thread's rows g and g + 8, columns 2 (lane % 4) + {0, 1} of each 8
  const int tq = lane & 3;
  const bf16* qg = static_cast<const bf16*>(p.q) + sh * G * D;
  uint32_t qa[D / 16][4];  // Q as A fragments, rows >= G zero
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int d0 = 16 * kk + 2 * tq;
    qa[kk][0] = g < G ? *reinterpret_cast<const uint32_t*>(qg + g * D + d0) : 0u;
    qa[kk][1] = g + 8 < G ? *reinterpret_cast<const uint32_t*>(qg + (g + 8) * D + d0) : 0u;
    qa[kk][2] = g < G ? *reinterpret_cast<const uint32_t*>(qg + g * D + d0 + 8) : 0u;
    qa[kk][3] = g + 8 < G ? *reinterpret_cast<const uint32_t*>(qg + (g + 8) * D + d0 + 8) : 0u;
  }
  const int nlive = (len + ck - 1) / ck;                  // the slot's live chunks: tickets to draw
  const int ntiles = min(p.ctiles, (len - c0 + 63) / 64);  // this chunk's tiles with a live key
  const uint32_t base = (smem_u32(pg_smem) + 127) & ~127u;
  auto at = [&](uint32_t a) { return pg_smem + (a - smem_u32(pg_smem)); };
  const uint32_t bar0 = smem_u32(&bars[0]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (tid + PG_NT * i < ck) {
      row_page[tid + PG_NT * i] = pg[i];
      row_at[tid + PG_NT * i] = at_pg[i];
    }
  }
  if (tid == 0) {
    for (int t = 0; t < ntiles; ++t) mbar_init(bar0 + 8 * t, PG_NT);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the gather: every live tile's rows, each tile completed on its barrier
  const C* kg = static_cast<const C*>(p.kp) + h * p.kv_sh;
  const C* vg = static_cast<const C*>(p.vp) + h * p.kv_sh;
  constexpr int CPR = QUANT ? D / 16 : D / 8;  // 16-byte pieces of a row
  constexpr int RPP = PG_NT / CPR;             // rows a pass of the block
  for (int t = 0; t < ntiles; ++t) {
    const uint32_t tb = base + t * PER_TILE;
#pragma unroll
    for (int it = 0; it < 64 / RPP; ++it) {
      const int r = it * RPP + tid / CPR;
      const int c = tid % CPR;
      const bool ok = c0 + 64 * t + r < len;
      const long long off =
          ok ? (long long)row_page[64 * t + r] * p.kv_sp + (long long)row_at[64 * t + r] * p.kv_st : 0;
      if constexpr (QUANT) {
        const uint32_t raw = tb + 2 * TILE;
        cp_async16(raw + r * D + 16 * c, kg + off + 16 * c, ok);
        cp_async16(raw + 64 * D + r * D + 16 * c, vg + off + 16 * c, ok);
      } else {
        cp_async16(tb + chunk_off<D>(r, c), kg + off + 8 * c, ok);
        cp_async16(tb + TILE + chunk_off<D>(r, c), vg + off + 8 * c, ok);
      }
    }
    if constexpr (QUANT) {  // thread r < 64: row r's K scale; 64 + r: its V scale
      const int r = tid & 63;
      const bool ok = c0 + 64 * t + r < len;
      const long long so =
          ok ? h * p.s_sh + (long long)row_page[64 * t + r] * p.s_sp + (long long)row_at[64 * t + r] * p.s_st : 0;
      cp_async4(tb + 2 * TILE + 2 * 64 * D + 4 * tid, (tid < 64 ? p.ks : p.vs) + so, ok);
    }
    mbar_arrive_copies(bar0 + 8 * t);
  }

  // Warp w takes rows 16 w .. 16 w + 15 of each tile, with its own online
  // softmax.
  const int r0 = 16 * warp;
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = c0 + 64 * t + r0;  // the warp's keys k0 .. k0 + 15
    if (k0 >= len) break;             // this slice and the later ones lie past the end
    const uint32_t sK = base + t * PER_TILE;
    const uint32_t sV = sK + TILE;
    mbar_wait(bar0 + 8 * t, 0);
    if constexpr (STOP == 2) continue;
    if constexpr (QUANT) {  // the warp's raw rows into the bf16 tiles, exactly
      const uint32_t raw = sK + 2 * TILE;
#pragma unroll
      for (int it = 0; it < 2 * 16 * (D / 16) / 32; ++it) {
        const int idx = it * 32 + lane;
        const int kv = idx / (16 * (D / 16));
        const int r = r0 + (idx / (D / 16)) % 16;
        const int c = idx % (D / 16);
        uint4 lo, hi;
        int8x16_to_bf16(*reinterpret_cast<const uint4*>(at(raw + kv * 64 * D + r * D + 16 * c)), lo, hi);
        *reinterpret_cast<uint4*>(at(sK + kv * TILE + chunk_off<D>(r, 2 * c))) = lo;
        *reinterpret_cast<uint4*>(at(sK + kv * TILE + chunk_off<D>(r, 2 * c + 1))) = hi;
      }
      __syncwarp();
    }
    // S = Q Kᵀ over the slice: two 8-key column tiles
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t b[4];  // keys r0 + 8 (lane / 16).., dims 16 kk + 8 (lane / 8 % 2)..: (b0, b1) of both column tiles
      ldsm_x4(b, sK + chunk_off<D>(r0 + (lane & 7) + 8 * (lane >> 4), 2 * kk + ((lane >> 3) & 1)));
      ws::mma_bf16_16816(sc[0], qa[kk], b[0], b[1]);
      ws::mma_bf16_16816(sc[1], qa[kk], b[2], b[3]);
    }
    const float* ex = reinterpret_cast<const float*>(at(sK + 2 * TILE + 2 * 64 * D)) + r0;  // int8: K, V scales
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * tq + (e & 1);
        float x = sc[j][e] * p.scale;
        if (QUANT) x *= ex[col];
        if (k0 + col >= len) x = -INFINITY;  // past the end: no weight at all
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the slice's first key is live, so each row max is finite
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = __expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * tq + (e & 1);
        float pr = __expf(sc[j][e] - m[e >> 1]);  // 0 at -inf
        l[e >> 1] += pr;
        if (QUANT) pr *= ex[64 + col];
        sc[j][e] = pr;
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // O += P V, P in bf16 as the A fragment of one 16-key step
    const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                            pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
    for (int n2 = 0; n2 < D / 16; ++n2) {
      uint32_t b[4];  // keys r0 + 8 (lane / 8 % 2).., dims 16 n2 + 8 (lane / 16)..
      ldsm_x4_trans(b, sV + chunk_off<D>(r0 + (lane & 7) + 8 * ((lane >> 3) & 1), 2 * n2 + (lane >> 4)));
      ws::mma_bf16_16816(o[2 * n2], pa, b[0], b[1]);
      ws::mma_bf16_16816(o[2 * n2 + 1], pa, b[2], b[3]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if constexpr (STOP == 2 || STOP == 3) {  // a store that no run takes keeps every product in the timing build
    float keep = l[0] + l[1];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) keep += o[n][0] + o[n][1] + o[n][2] + o[n][3];
    if (keep == 12345.f) p.acc[tid] = keep;
    return;
  }
  const int nw = min(PG_WARPS, (len - c0 + 15) / 16);  // warps with a live key
  __syncthreads();  // every warp is done with every tile: the warps' states go over tile 0
  // warp w's (O) rows < G, f32, 16-byte groups of a row swizzled by the row
  auto state = [&](int w, int row, int col) {
    return reinterpret_cast<float*>(at(base)) + (w * 16 + row) * D + (((col >> 2) ^ (row & 7)) << 2) + (col & 3);
  };
  if (warp < nw) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
      if (row < G) {
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<float2*>(state(warp, row, 8 * n + 2 * tq)) = make_float2(o[n][2 * r], o[n][2 * r + 1]);
        if (tq == 0) {
          wm[warp][row] = m[r];
          wl[warp][row] = l[r];
        }
      }
    }
  }
  __syncthreads();

  // merge the warps in order: weights exp(m_w - m), kept in wm
  const bool single = nlive == 1;  // the slot's one chunk: its state is the result
  const long long part = sh * p.nchunk + chunk;
  if (tid < G) {
    float mm = wm[0][tid];
    for (int w = 1; w < nw; ++w) mm = fmaxf(mm, wm[w][tid]);
    float ll = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float a = __expf(wm[w][tid] - mm);
      wm[w][tid] = a;
      ll = fmaf(a, wl[w][tid], ll);
    }
    (single ? p.m + sh * G : p.m_part + part * G)[tid] = mm;
    (single ? p.l + sh * G : p.l_part + part * G)[tid] = ll;
  }
  __syncthreads();
  float* dst = single ? acc_out : p.acc_part + part * G * D;
  for (int f = tid; f < G * D / 4; f += PG_NT) {
    const int row = 4 * f / D;
    const int col = 4 * f % D;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = 0; w < nw; ++w) {
      const float wt = wm[w][row];
      const float4 x = *reinterpret_cast<const float4*>(state(w, row, col));
      a.x = fmaf(wt, x.x, a.x);
      a.y = fmaf(wt, x.y, a.y);
      a.z = fmaf(wt, x.z, a.z);
      a.w = fmaf(wt, x.w, a.w);
    }
    reinterpret_cast<float4*>(dst)[f] = a;
  }
  if (single || STOP == 4) return;

  __syncthreads();  // the block's partial is written
  if (tid == 0) {   // one acq_rel atomic releases the block's partial and, for the last block, acquires the others'
    int ticket;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n" : "=r"(ticket) : "l"(p.ticket + sh) : "memory");
    last = ticket == nlive - 1;
  }
  __syncthreads();
  if (!last) return;

  // the fold, in chunk order. The chunks' m and l land in shared memory (the
  // tiles' space) in one round of loads and become the weights exp(m_c - m)
  // in parallel; the f32 partials (consecutive chunks lie next to each other)
  // stream through the rest of that space in batches of fb chunks, each
  // batch's 16-byte copies all in flight at once.
  float* fm = reinterpret_cast<float*>(at(base));  // [chunk][G]: m, then the weights
  float* fl = fm + nlive * G;
  const long long part0 = sh * p.nchunk;
  const uint32_t buf = base + ((2 * nlive * G * 4 + 15) & ~15);
  const int nf4 = G * D / 4;  // float4s a chunk's partial
  const int fb = (pg_smem_bytes<D, QUANT>(p.ctiles, p.nchunk) - 128 - (int)(buf - base)) / (16 * nf4);
  const float* acc_src = p.acc_part + part0 * G * D;
  auto stage = [&](int c) {  // chunks c .. c + fb - 1 into the buffer
    const int n = min(fb, nlive - c) * nf4;
    for (int i = tid; i < n; i += PG_NT) cp_async16(buf + 16 * i, acc_src + (long long)c * G * D + 4 * i, true);
    cp_async_commit();
  };
  stage(0);
  for (int i = tid; i < nlive * G; i += PG_NT) {
    fm[i] = __ldcg(p.m_part + part0 * G + i);
    fl[i] = __ldcg(p.l_part + part0 * G + i);
  }
  __syncthreads();
  if (tid < G) {
    float mm = NEG_INF;
    for (int c = 0; c < nlive; ++c) mm = fmaxf(mm, fm[c * G + tid]);
    fmax_row[tid] = mm;
  }
  __syncthreads();
  for (int i = tid; i < nlive * G; i += PG_NT) fm[i] = __expf(fm[i] - fmax_row[i % G]);
  __syncthreads();
  if (tid < G) {
    float ll = 0.f;
    for (int c = 0; c < nlive; ++c) ll = fmaf(fm[c * G + tid], fl[c * G + tid], ll);
    p.m[sh * G + tid] = fmax_row[tid];
    p.l[sh * G + tid] = ll;
  }
  constexpr int F4 = 16 * D / 4 / PG_NT;  // float4s a thread at G = 16
  float4 a[F4];
#pragma unroll
  for (int u = 0; u < F4; ++u) a[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < nlive; c += fb) {
    cp_async_wait<0>();
    __syncthreads();  // the batch has landed
    for (int b = 0; b < min(fb, nlive - c); ++b) {
#pragma unroll
      for (int u = 0; u < F4; ++u) {
        const int f = tid + PG_NT * u;
        if (f < nf4) {
          const float wt = fm[(c + b) * G + 4 * f / D];
          const float4 x = *reinterpret_cast<const float4*>(at(buf + 16 * (b * nf4 + f)));
          a[u].x = fmaf(wt, x.x, a[u].x);
          a[u].y = fmaf(wt, x.y, a[u].y);
          a[u].z = fmaf(wt, x.z, a[u].z);
          a[u].w = fmaf(wt, x.w, a[u].w);
        }
      }
    }
    if (c + fb < nlive) {
      __syncthreads();  // every thread is done with the buffer
      stage(c + fb);
    }
  }
#pragma unroll
  for (int u = 0; u < F4; ++u) {
    const int f = tid + PG_NT * u;
    if (f < nf4) reinterpret_cast<float4*>(acc_out)[f] = a[u];
  }
  if (tid == 0) p.ticket[sh] = 0;  // every live block of this (slot, kv head) has arrived
}

template <int D, bool QUANT, int STOP>
int run_tc(const PagedParams& p, cudaStream_t stream) {
  const int smem = pg_smem_bytes<D, QUANT>(p.ctiles, p.nchunk);
  const cudaError_t err =
      cudaFuncSetAttribute(paged_tc<D, QUANT, STOP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  paged_tc<D, QUANT, STOP><<<dim3(p.nchunk, p.Hkv, p.S), PG_NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int STOP>
int paged_tc_entry(int quant, int D, const PagedParams& p, cudaStream_t st) {
  if (D != 64 && D != 128) return -1;
  if (p.G < 1 || p.G > 16 || p.ctiles < 1 || p.ctiles > PG_WARPS || p.nchunk < 1) return -2;
  if (quant) return D == 64 ? run_tc<64, true, STOP>(p, st) : run_tc<128, true, STOP>(p, st);
  return D == 64 ? run_tc<64, false, STOP>(p, st) : run_tc<128, false, STOP>(p, st);
}

}  // namespace tc
}  // namespace t1

// P1 / P2 on the tensor cores: bf16 q; quant: int8 pages with scales, else
// bf16 pages; D 64 or 128. -1: no instance; -2: a shape the kernel does not take.
extern "C" int t1_paged_tc(int quant, int D, const t1::PagedParams* p, void* stream) {
  return t1::tc::paged_tc_entry<5>(quant, D, *p, static_cast<cudaStream_t>(stream));
}

#ifdef T1_PG_PROFILE_STOPS
// A timing build only (scripts/profile_paged_tc.py compiles this file with
// -DT1_PG_PROFILE_STOPS; the port never loads it): the kernel cut at `stop`
// 0-4 (paged_tc's STOP). None takes a ticket.
extern "C" int t1_paged_tc_stop(int stop, int quant, int D, const t1::PagedParams* p, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (stop) {
    case 0: return t1::tc::paged_tc_entry<0>(quant, D, *p, st);
    case 1: return t1::tc::paged_tc_entry<1>(quant, D, *p, st);
    case 2: return t1::tc::paged_tc_entry<2>(quant, D, *p, st);
    case 3: return t1::tc::paged_tc_entry<3>(quant, D, *p, st);
    case 4: return t1::tc::paged_tc_entry<4>(quant, D, *p, st);
    default: return -2;
  }
}
#endif

// Dynamic shared memory of one tensor-core P1 (quant 0) / P2 (quant 1) block, in bytes.
extern "C" int t1_paged_tc_smem_bytes(int quant, int D, int ctiles, int nchunk) {
  using namespace t1::tc;
  if (D == 64) return quant ? pg_smem_bytes<64, true>(ctiles, nchunk) : pg_smem_bytes<64, false>(ctiles, nchunk);
  if (D == 128) return quant ? pg_smem_bytes<128, true>(ctiles, nchunk) : pg_smem_bytes<128, false>(ctiles, nchunk);
  return -1;
}
