// Hopper (sm_90a) building blocks of the port's weight-streaming decode
// products (Q2: csrc/fused_mlp.cu; Q1: csrc/int4_matmul.cu): a ring of
// shared-memory stages filled by 1-D bulk copies (cp.async.bulk, completed on
// an mbarrier with expect_tx), the exact int8 and int4 -> bf16 conversions of
// mma fragments, the m16n8k16 bf16 tensor-core product, and a grid barrier
// for cooperative launches.
//
// The ring: stage q of a block's sequence lives in slot q % STAGES. Its
// `full` barrier (one arrival: the producer's expect_tx) completes once the
// stage's bytes have landed; its `empty` barrier (one arrival per consumer
// warp) once every consumer has read it. Both flip phase once per use of the
// slot, so use n of a slot waits on parity n & 1. On the H100 a bulk copy
// costs mostly per copy below a few KB (Q2's down phase streamed 0.5 / 1 /
// 2 KB row segments at 0.71 / 1.18 / 1.48 TB/s, PERF.md): copy long
// segments. A tensor copy (cp.async.bulk.tensor) whose box is 16 bytes wide
// was slower still.
//
// Fragments: for mma.sync m16n8k16 the order of k inside a 16-deep step is
// free as long as A and B follow the same permutation. A thread (group g =
// lane / 4, t = lane % 4) that reads 16 consecutive weight bytes of rows g
// and g + 8 (k = 16t .. 16t + 15 of a 64-deep block) feeds four products;
// product i takes bytes 4i .. 4i + 3, which `int8x4_to_bf16` turns into the
// A registers (bytes 4i, 4i + 1) and (4i + 2, 4i + 3), and B must then hold
// x[n][16t + 4i ..] in the same pairs: 16 bytes of B (8 bf16) at k = 16t
// give the B registers of products 0 and 1, the next 16 bytes of 2 and 3.
// So both operands come from shared memory with 16-byte loads and no
// shuffles.
//
// int4 (two k a byte, the even k in the low nibble, so nibble i of a word is
// its k i): a thread that reads 16 bytes of rows g and g + 8 (k = 32t .. 32t
// + 31 of a 128-deep block) feeds eight products. A register holds nibbles j
// and j + 4 of a word (one mask, no byte moves: `int4x8_to_bf16`), so word q
// feeds products 2q (A registers 0, 1: k 8q + 0 / + 4; 2, 3: k 8q + 1 / + 5)
// and 2q + 1 (k 8q + 2 / + 6, 8q + 3 / + 7), and B's registers pair x's
// values the same way: `int4_b_frags` turns 16 bytes of x in its natural
// order (8 bf16 at k = 32t + 8q) into them with four byte permutes. The
// thread's 64 bytes of B row g at k = 32t are four 16-byte loads, two
// products each.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace t1 {
namespace ws {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and bulk copies

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// After the inits, before any other thread or the async proxy uses them.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One arrival that also expects `bytes` of bulk copies on this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completed on `bar`'s transaction count.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// Orders this thread's earlier generic accesses (and those it acquired) with
// its later async-proxy ones: before bulk copies into shared memory that
// generic stores wrote, or of global data other blocks wrote.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async;\n" ::: "memory"); }

// A named barrier over `count` threads (id 0 is __syncthreads).
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Stage q of a ring of STAGES slots: its slot, and the parity a consumer
// waits on at its `full` barrier. The producer refilling the slot for stage
// q >= STAGES waits on `empty` with the parity of stage q - STAGES's use.
template <int STAGES>
__device__ __forceinline__ int ring_slot(int q) { return q % STAGES; }
template <int STAGES>
__device__ __forceinline__ int ring_parity(int q) { return (q / STAGES) & 1; }

// ---- fragments and the product

// 4 int8 (one word, byte b = element b) to 4 bf16, exactly: the byte x + 128
// goes into the mantissa of 2^23 (f32 bits 0x4B0000uu) and 2^23 + 128 comes
// off, which gives x as a float; a float integer of 8 bits is its top 16
// bits as a bf16. lo holds elements (0, 1), hi (2, 3), the first in the low
// half. Integer and f32-add work only, no int-to-float converts.
__device__ __forceinline__ void int8x4_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) f[b] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | b)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// One word of offset-8 int4 (nibble i = the word's k i) to 4 bf16x2,
// exactly: r[j] holds nibble j - 8 in its low half and nibble j + 4 - 8 in
// its high half. Each nibble n goes into the mantissa of bf16 128 (0x4300 |
// n = 128 + n) by one three-input mask-and-or (a shift first for j > 0), and
// 136 comes off in one bf16x2 fma: n - 8. No int-to-float converts, no byte
// moves: about 1.75 integer instructions a register, which bound the
// conversion (the integer pipe runs at half the rate of the fma pipe).
__device__ __forceinline__ void int4x8_to_bf16(uint32_t w, uint32_t (&r)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t v;
    asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(v) : "r"(w >> (4 * j)), "r"(0x000F000Fu), "r"(0x43004300u));
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r[j]) : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  }
}

// 8 bf16 of B in k order (k 0..7 of a word's nibbles) to the B registers of
// products 2q and 2q + 1 in `int4x8_to_bf16`'s pairing: (0, 4), (1, 5) and
// (2, 6), (3, 7).
__device__ __forceinline__ uint4 int4_b_frags(const uint4& x) {
  return make_uint4(__byte_perm(x.x, x.z, 0x5410), __byte_perm(x.x, x.z, 0x7632), __byte_perm(x.y, x.w, 0x5410),
                    __byte_perm(x.y, x.w, 0x7632));
}

// d += A (16 x 16 bf16, a[0..3] in the PTX register order) x B (16 x 8 bf16).
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments of one 64-deep block: wg / wg8 are this thread's 16 weight
// bytes of rows g and g + 8 (k = 16t ..); a[i] feeds product i.
__device__ __forceinline__ void int8_block_frags(const uint4& wg, const uint4& wg8, uint32_t (&a)[4][4]) {
  const uint32_t r0[4] = {wg.x, wg.y, wg.z, wg.w};
  const uint32_t r8[4] = {wg8.x, wg8.y, wg8.z, wg8.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int8x4_to_bf16(r0[i], a[i][0], a[i][2]);
    int8x4_to_bf16(r8[i], a[i][1], a[i][3]);
  }
}

// The four products of one 64-deep block against one 8-column B tile: x0 /
// x1 are this thread's 16 + 16 bytes of B row (column) g at k = 16t. d: rows
// g (d[0], d[1]) and g + 8 (d[2], d[3]) at columns 2t and 2t + 1.
__device__ __forceinline__ void mma_block(float (&d)[4], const uint32_t (&a)[4][4], const uint4& x0,
                                          const uint4& x1) {
  const uint32_t b[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) mma_bf16_16816(d, a[i], b[2 * i], b[2 * i + 1]);
}

// A fragments of one 128-deep int4 block: wg / wg8 are this thread's 16
// weight bytes of rows g and g + 8 (k = 32t ..); a[i] feeds product i.
__device__ __forceinline__ void int4_block_frags(const uint4& wg, const uint4& wg8, uint32_t (&a)[8][4]) {
  const uint32_t r0[4] = {wg.x, wg.y, wg.z, wg.w};
  const uint32_t r8[4] = {wg8.x, wg8.y, wg8.z, wg8.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t g0[4], g8[4];
    int4x8_to_bf16(r0[q], g0);
    int4x8_to_bf16(r8[q], g8);
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // nibble pairs (2h, 2h + 4), (2h + 1, 2h + 5): product 2q + h
      a[2 * q + h][0] = g0[2 * h];
      a[2 * q + h][1] = g8[2 * h];
      a[2 * q + h][2] = g0[2 * h + 1];
      a[2 * q + h][3] = g8[2 * h + 1];
    }
  }
}

// The eight products of one 128-deep int4 block against one 8-column B tile:
// xv are this thread's 64 bytes of B row (column) g at k = 32t, each 16
// bytes through `int4_b_frags`.
__device__ __forceinline__ void mma_int4_block(float (&d)[4], const uint32_t (&a)[8][4], const uint4 (&xv)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    mma_bf16_16816(d, a[2 * q], xv[q].x, xv[q].y);
    mma_bf16_16816(d, a[2 * q + 1], xv[q].z, xv[q].w);
  }
}

// ---- grid barrier for a cooperative launch (every block resident)

// count: arrivals so far in this episode; gen: episodes completed. One
// instance per kernel, zero at load; launches of that kernel on one device
// must not overlap (they queue on one stream).
struct GridBarrier {
  unsigned int count;
  unsigned int gen;
};

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// One thread of each block arrives, after a block barrier that orders the
// block's earlier stores before it; gen0 is `ld_acquire(&bar->gen)` read
// before the arrival (the episode cannot complete without it). The arrival
// is a release, the last one's new generation too: no separate fences.
__device__ __forceinline__ void grid_arrive(GridBarrier* bar, unsigned int gen0) {
  unsigned int old;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;\n" : "=r"(old) : "l"(&bar->count) : "memory");
  if (old == gridDim.x - 1) {
    asm volatile("st.relaxed.gpu.u32 [%0], 0;\n" ::"l"(&bar->count) : "memory");
    asm volatile("st.release.gpu.u32 [%0], %1;\n" ::"l"(&bar->gen), "r"(gen0 + 1) : "memory");
  }
}

// Any thread: on return every block's stores before its arrival are visible
// to this thread.
__device__ __forceinline__ void grid_wait(const GridBarrier* bar, unsigned int gen0) {
  while (ld_acquire(&bar->gen) == gen0) {
  }
}

}  // namespace ws
}  // namespace t1
