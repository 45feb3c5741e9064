// Hopper (sm_90a) building blocks of the port's tensor-core attention kernels:
// cp.async copies completed on mbarriers, 64-row bf16 tiles in shared memory
// with the 128-byte swizzle (and a 32-byte-swizzled tail at head dim 80),
// their wgmma descriptors, the warpgroup products, and the exact int8 -> bf16
// conversion of a 16-byte word. Shared by the forward (attention_fwd_tc.cuh:
// K1, K3, S1), the backward (attention_bwd_tc.cuh: B1, B2, S2) and the decode
// kernels (decode_attention.cu: D2; paged_attention.cu: P1, P2, whose
// mma.sync products read the same swizzled tiles through ldmatrix).
//
// A tile is 64 rows x D bf16. Its first 64 * (D / 64) columns are stored as
// D/64 blocks of 64 x 64 (8 KB each); row r's 16-byte chunk c of a block lies
// at r * 128 + ((c ^ (r & 7)) << 4). At D = 80 the last 16 columns (32 bytes
// a row) follow as one 2 KB block with the 32-byte swizzle: chunk c (0 or 1)
// of row r at 8192 + r * 32 + ((c ^ ((r >> 2) & 1)) << 4), the pattern of
// CUTLASS's Swizzle<1, 4, 3> (address bit 7 into bit 4).
// One warpgroup (128 threads) issues every product; a 64 x N f32 accumulator
// gives thread (warp w, lane l) rows 16w + l/4 and 16w + l/4 + 8, columns
// 8j + 2(l % 4) and +1: element 4j + 2i + e is (row + 8i, column 8j + 2(l % 4) + e).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace t1 {
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int WG = 128;  // one warpgroup per block

template <int D>
__host__ __device__ constexpr int tile_bytes() { return 64 * D * 2; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- copies and barriers

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Groups of the thread's cp.asyncs, completed in order: wait until at most N
// of the groups committed so far are still in flight.
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Thread 0 makes `n` barriers of WG arrivals each, 8 bytes apart, visible to
// the block's copies; every thread passes the __syncthreads after it.
__device__ __forceinline__ void mbar_init_all(uint32_t bars, int n) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) mbar_init(bars + 8 * i, WG);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The barrier's phase completes once every thread's earlier cp.asyncs have
// landed (one arrival per thread: the barrier counts WG).
__device__ __forceinline__ void mbar_arrive_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(bar) : "memory");
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

// Columns of a tile in 128-byte-swizzled 64-column blocks, and the rest (16
// at D = 80, in the 32-byte-swizzled tail block).
template <int D>
__host__ __device__ constexpr int main_cols() { return D == 80 ? 64 : D; }

// Byte offset in a tile of row r's 16-byte chunk c (8 bf16, columns 8c..8c+7).
template <int D>
__device__ __forceinline__ uint32_t chunk_off(int r, int c) {
  if (D == 80 && c >= 8) return 8192 + r * 32 + (((c & 1) ^ ((r >> 2) & 1)) << 4);
  return (c >> 3) * 8192 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// 64 rows x D bf16 from rows row0.. of a row-major source (row_stride
// elements) into the swizzled tile; rows >= n_rows are zeros. The copies are
// spread over one warpgroup, `tid` being the thread's index in it.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* g, long long row_stride, int row0,
                                          int n_rows, int tid = threadIdx.x) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < 64 * CPR / WG; ++it) {
    const int idx = it * WG + tid;
    const int r = idx / CPR;
    const int c = idx % CPR;
    const bool ok = row0 + r < n_rows;
    const bf16* src = g + (long long)(ok ? row0 + r : 0) * row_stride + c * 8;
    cp_async16(dst + chunk_off<D>(r, c), src, ok);
  }
}

// ---- int8 tiles

// 16 int8 (one 16-byte word) to 16 bf16 (two words), exactly: the byte x
// + 128 goes into the mantissa of 2^23 (f32 bits 0x4B0000uu) and 2^23 + 128
// comes off, which gives x as a float; a float integer of 8 bits is its top
// 16 bits as a bf16. Integer and f32-add work only, no int-to-float converts.
__device__ __forceinline__ void int8x16_to_bf16(const uint4 w, uint4& lo, uint4& hi) {
  const uint32_t in[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u, w.z ^ 0x80808080u, w.w ^ 0x80808080u};
  uint32_t out[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[b] = __uint_as_float(__byte_perm(in[i], 0x4B000000u, 0x7440 | b)) - 8388736.f;
    out[2 * i] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
    out[2 * i + 1] = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
  }
  lo = make_uint4(out[0], out[1], out[2], out[3]);
  hi = make_uint4(out[4], out[5], out[6], out[7]);
}

// ---- wgmma

// Shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// The same with the 32-byte swizzle (layout type 3 in bits 62-63, as
// CUTLASS's GmmaDescriptor encodes LayoutType::B32).
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (3ull << 62);
}

// K-major operand (rows = M or N, columns = the reduced dim) of a tile: the
// kk-th 16-column step lies in block kk / 4, 32 bytes per step into its rows.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return desc_sw128(tile + (kk >> 2) * 8192 + (kk & 3) * 32, 16, 1024);
}

// The kk-th 16-column step of a D-column tile; at D = 80 the fifth step is
// the whole 32-byte-swizzled tail block (8-row groups 256 bytes apart).
template <int D>
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int kk) {
  if (D == 80 && kk == 4) return desc_sw32(tile + 8192, 16, 256);
  return kmajor(tile, kk);
}

// MN-major B operand (rows = the reduced dim, columns = N = D): the kk-th
// 16-row step starts 16 rows down; the 64-column blocks lie 8 KB apart.
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return desc_sw128(tile + kk * 2048, 8192, 1024);
}

// The same over the 16-column tail block at `tail` (32 bytes a row): the
// kk-th 16-row step starts 512 bytes in, 8-row groups 256 bytes apart.
__device__ __forceinline__ uint64_t mnmajor_tail(uint32_t tail, int kk) {
  return desc_sw32(tail + kk * 512, 512, 256);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// Keeps the compiler from moving reads of an accumulator above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 64, f32) (+)= A (64 x 16, smem, K-major) * B (16 x 64, smem, K-major).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 16, f32) += A (64 x 16, bf16 registers) * B (16 x 16, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 64)
    wgmma_rs_n64(d, a, db);
  else
    wgmma_rs_n128(d, a, db);
}

// S = Q K^T-style product of two resident K-major tiles: 64 x 64 in f32.
template <int D>
__device__ __forceinline__ void scores(float (&s)[32], uint32_t a_tile, uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(s, kdesc<D>(a_tile, kk), kdesc<D>(b_tile, kk), kk);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A 64 x 64 accumulator (thread: rows r, r + 8 of its warp's 16, columns
// 8j + 2c, +1) rounded to bf16 as the A fragments of four k16 steps.
__device__ __forceinline__ void to_afrag(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

}  // namespace tc
}  // namespace t1
