// Q2: fused int8 SwiGLU MLP for the decode step.
//
// Replaces the Pallas kernel `fused_mlp_int8` of time_r1_tpu/ops/fused_mlp.py
// (pallas_call at :85): y = (silu(x@Wg·s_g) · (x@Wu·s_u)) @ Wd · s_d, with x
// and the activation rounded to bf16 (as the TPU kernel feeds its bf16 MXU)
// and every sum in f32, without writing the (M, inter) intermediate to device
// memory. Weights are the port's fused layout: gu (2·inter, hid) int8 with
// rows [0, inter) the gate and [inter, 2·inter) the up projection, down
// (hid, inter) int8, and one f32 scale per output row of each.
//
// What bounds it on the H100: at decode (M = 8) every weight byte feeds 2·M
// operations, so the bound is streaming the int8 weights once (67.6 MB per
// 3B layer). Pass 1 gives each block 64 of the `inter` columns: its 8 warps
// compute the gate and up sums for those columns (lanes stride the weight row
// 4 bytes at a time against x staged once in shared memory), the block forms
// the bf16 activation in shared memory and multiplies it straight into the
// down projection's 64 matching weight columns, giving an f32 partial of the
// whole (M, hid) output. The TPU carries that sum over the `inter` blocks in
// VMEM along a sequential grid; GPU blocks run in no order, so the partials go
// to a (blocks, M, hid) f32 scratch and pass 2 sums them in a fixed order,
// applies s_d and casts: deterministic, no atomics (172 blocks x 8 rows x
// 2048 f32 = 11.3 MB of scratch at 3B, written and read once). M runs in
// tiles of 8 rows. Arithmetic is f32 FMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int NB = 64;  // inter columns per block
constexpr int MT = 8;   // rows of x per pass

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16(x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 4 int8 weights of one packed word against 4 consecutive x values of each row.
__device__ __forceinline__ void fma_word(float (&acc)[MT], const float* xs, int hid, int k, int w) {
  const float w0 = (float)(int8_t)(w & 255), w1 = (float)(int8_t)((w >> 8) & 255);
  const float w2 = (float)(int8_t)((w >> 16) & 255), w3 = (float)(int8_t)((w >> 24) & 255);
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    const float4 xv = *reinterpret_cast<const float4*>(xs + r * hid + k);
    acc[r] = fmaf(xv.w, w3, fmaf(xv.z, w2, fmaf(xv.y, w1, fmaf(xv.x, w0, acc[r]))));
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) fused_mlp_part(const T* __restrict__ x, const int8_t* __restrict__ gu,
                                                           const float* __restrict__ gu_s,
                                                           const int8_t* __restrict__ down,
                                                           float* __restrict__ part, int M, int hid, int inter) {
  extern __shared__ float smem[];
  float* xs = smem;             // [MT][hid], x rounded to bf16
  float* act = xs + MT * hid;   // [MT][NB], the bf16 activation
  const int blk = blockIdx.x;
  const int n0 = blk * NB;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int m0 = 0; m0 < M; m0 += MT) {
    __syncthreads();  // the previous tile's act is consumed
    for (int idx = threadIdx.x; idx < MT * hid; idx += NTHREADS) {
      const int r = idx / hid;
      xs[idx] = m0 + r < M ? round_bf16(to_f(x[(long long)(m0 + r) * hid + idx - r * hid])) : 0.f;
    }
    __syncthreads();

    // gate and up sums for this warp's columns
    for (int c = warp; c < NB; c += NWARPS) {
      const int n = n0 + c;
      const int* grow = reinterpret_cast<const int*>(gu + (long long)n * hid);
      const int* urow = reinterpret_cast<const int*>(gu + (long long)(inter + n) * hid);
      float ag[MT], au[MT];
#pragma unroll
      for (int r = 0; r < MT; ++r) ag[r] = au[r] = 0.f;
      for (int k = lane * 4; k < hid; k += 128) {
        fma_word(ag, xs, hid, k, __ldg(grow + k / 4));
        fma_word(au, xs, hid, k, __ldg(urow + k / 4));
      }
      const float sg = gu_s[n], su = gu_s[inter + n];
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        const float g = warp_sum(ag[r]) * sg;
        const float u = warp_sum(au[r]) * su;
        if (lane == 0) act[r * NB + c] = round_bf16(g / (1.f + expf(-g)) * u);
      }
    }
    __syncthreads();

    // this block's 64 columns of the down projection, for every output j
    for (int j = threadIdx.x; j < hid; j += NTHREADS) {
      const uint4* drow = reinterpret_cast<const uint4*>(down + (long long)j * inter + n0);
      float acc[MT];
#pragma unroll
      for (int r = 0; r < MT; ++r) acc[r] = 0.f;
#pragma unroll
      for (int q = 0; q < NB / 16; ++q) {
        const uint4 v = __ldg(drow + q);
        const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const float wv = (float)(int8_t)((words[e >> 2] >> (8 * (e & 3))) & 255u);
#pragma unroll
          for (int r = 0; r < MT; ++r) acc[r] = fmaf(act[r * NB + q * 16 + e], wv, acc[r]);
        }
      }
      for (int r = 0; r < MT && m0 + r < M; ++r) part[((long long)blk * M + m0 + r) * hid + j] = acc[r];
    }
  }
}

template <typename T>
__global__ void fused_mlp_reduce(const float* __restrict__ part, const float* __restrict__ down_s,
                                 T* __restrict__ y, int M, int hid, int nblk) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)M * hid) return;
  float sum = 0.f;
  for (int b = 0; b < nblk; ++b) sum += part[(long long)b * M * hid + i];
  store_f(y + i, sum * down_s[i % hid]);
}

template <typename T>
int launch(const void* x, const void* gu, const float* gu_s, const void* down, const float* down_s, void* y,
           float* part, int M, int hid, int inter, cudaStream_t stream) {
  const int nblk = inter / NB;
  const int smem = (MT * hid + MT * NB) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_part<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fused_mlp_part<T><<<nblk, NTHREADS, smem, stream>>>(static_cast<const T*>(x), static_cast<const int8_t*>(gu),
                                                      gu_s, static_cast<const int8_t*>(down), part, M, hid,
                                                      inter);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = (long long)M * hid;
  fused_mlp_reduce<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(part, down_s, static_cast<T*>(y), M,
                                                                            hid, nblk);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y). part is (inter/64, M, hid) f32
// scratch. hid must be a multiple of 128 and inter of 64.
extern "C" int t1_fused_mlp_int8(int dtype, const void* x, const void* gu, const float* gu_s, const void* down,
                                 const float* down_s, void* y, float* part, int M, int hid, int inter,
                                 void* stream) {
  if (hid % 128 != 0 || inter % NB != 0 || M < 1) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, gu, gu_s, down, down_s, y, part, M, hid, inter, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, gu, gu_s, down, down_s, y, part, M, hid, inter, st);
  return -1;
}
