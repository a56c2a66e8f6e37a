// Device helpers shared by the criss-cross attention kernels (cca_fwd.cu,
// cca_bwd.cu, cca_lines.cu; the tensor-core line helpers of the first two
// are in cca_tc.cuh). Each source is its own library; the helpers have
// internal linkage in each.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_CQ = 128;     // q/k channels the kernels take (MAX_CQ of the wrapper)
constexpr float MASK = -1e9f;  // the column self slot: NEG_INF of ccnet_tpu/ops/cc_attention.py

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__host__ __device__ __forceinline__ int round4(int c) { return (c + 3) & ~3; }

// Row stride (floats) of a shared tile whose rows hold `c4` (a multiple of
// 4) values and are read as float4 by the lanes of a warp, one row per lane:
// stride / 4 odd puts 8 consecutive rows in 8 distinct 16-byte bank groups.
__host__ __device__ __forceinline__ int padded_stride(int c4) { return 4 * ((c4 / 4) | 1); }

}  // namespace
