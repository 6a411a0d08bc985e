// Shared helpers for the hand-written kernels: bf16/fp32 element access and
// warp/block reductions.  Every launcher in this directory has a plain C
// interface (loaded with ctypes) and returns the cudaError_t of its launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace kernels {

constexpr float NEG_INF = -1e30f;  // the JAX package's masked-score sentinel

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the whole block; every thread gets the result.  blockDim.x must be
// a multiple of 32 and at most 1024.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float partial[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
  if (warp == 0) {
    float w = lane < n_warps ? partial[lane] : 0.f;
    w = warp_sum(w);
    if (lane == 0) partial[0] = w;
  }
  __syncthreads();
  return partial[0];
}

}  // namespace kernels
