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
// byte, so the bound is streaming the packed weight (N·K/2 bytes) once. The
// design keeps the unpack on chip, as the TPU kernel does: each thread owns
// one output column, reads its packed row 16 bytes at a time, splits every
// byte into its two signed values in registers and multiplies them against 8
// rows of x that the block stages in shared memory (all threads read the same
// x element at once: a broadcast). M runs in tiles of 8 rows.
//
// The TPU grid walks K in order per output block; here too few column blocks
// (N/128 = 16 for the (2048, 11008) down projection) would leave most SMs
// idle, so K is split across blocks as well (grid.y) and a second kernel sums
// the f32 partials in a fixed order, scales and casts: deterministic, no
// atomics. With one split the first kernel writes y itself. Ragged K and N are
// masked here: K/2 need not divide any block, and rows whose length is not a
// multiple of 16 bytes (or are not 16-byte aligned) take the byte-wise path.
// Arithmetic is f32 FMA; tensor cores come later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // threads per block = output columns per block
constexpr int MT = 8;    // rows of x per pass
constexpr int KT = 512;  // k values of x staged per tile (a multiple of 32)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y). k_per_split is a multiple of
// KT (or covers K); part is (splits, M, N) f32 scratch when splits > 1.
extern "C" int t1_int4_matmul(int dtype, const void* x, const void* w, const float* s, void* y, float* part,
                              int M, int K, int N, int k_per_split, int splits, int vec, void* stream) {
  if (K % 2 != 0 || M < 1 || N < 1 || splits < 1 || (splits > 1 && part == nullptr)) return -2;
  if (splits > 1 && k_per_split % KT != 0) return -3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, s, y, part, M, K, N, k_per_split, splits, vec, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, s, y, part, M, K, N, k_per_split, splits, vec, st);
  return -1;
}
