// RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py::rmsnorm_pallas (body
// _rmsnorm_kernel): out = x * rsqrt(mean(x^2) + eps) * (1 + gamma), fp32
// statistics, output in x's dtype, gamma stored as (gamma - 1).
//
// Input is lane-batched: x (K, rows, d) and one gain row per lane, gamma
// (K, d); x and gamma are each fp32 or bf16.
//
// Bound on this card: memory.  The kernel reads x once and writes out once,
// 2 * K * rows * d * bytes at 3.35 TB/s; three flops per element are
// nothing beside that.  Design: one block per row, so a row's statistic is
// one block reduction (warp shuffles, then one shared-memory pass), with
// 16-byte vector loads and stores of x and out when d allows.  The second
// pass re-reads the row, which is then in L1/L2.
#include <cstdint>

#include "common.cuh"

namespace {

using kernels::block_sum;
using kernels::from_float;
using kernels::to_float;

template <typename T>
struct alignas(16) Pack {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

template <typename T, typename G, bool VEC>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const G* __restrict__ gamma,
                               T* __restrict__ out, long long rows, int d, float eps) {
  const long long row = blockIdx.x;  // global row of the (K * rows, d) view
  const long long lane = row / rows;
  const T* xr = x + row * d;
  T* orow = out + row * d;
  const G* g = gamma + lane * d;
  constexpr int N = Pack<T>::N;

  float ss = 0.f;
  if (VEC) {
    const Pack<T>* xv = reinterpret_cast<const Pack<T>*>(xr);
    for (int i = threadIdx.x; i < d / N; i += blockDim.x) {
      Pack<T> p = xv[i];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float f = to_float(p.v[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      float f = to_float(xr[i]);
      ss += f * f;
    }
  }
  const float r = rsqrtf(block_sum(ss) / static_cast<float>(d) + eps);

  if (VEC) {
    const Pack<T>* xv = reinterpret_cast<const Pack<T>*>(xr);
    Pack<T>* ov = reinterpret_cast<Pack<T>*>(orow);
    for (int i = threadIdx.x; i < d / N; i += blockDim.x) {
      Pack<T> p = xv[i], o;
#pragma unroll
      for (int j = 0; j < N; ++j)
        o.v[j] = from_float<T>(to_float(p.v[j]) * r * (1.f + to_float(g[i * N + j])));
      ov[i] = o;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      orow[i] = from_float<T>(to_float(xr[i]) * r * (1.f + to_float(g[i])));
  }
}

template <typename T, typename G>
cudaError_t launch(const void* x, const void* gamma, void* out, int K, long long rows,
                   int d, float eps, cudaStream_t stream) {
  constexpr int N = Pack<T>::N;
  const bool vec = d % N == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int work = vec ? d / N : d;
  int threads = ((work + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const long long blocks = static_cast<long long>(K) * rows;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  if (vec)
    rmsnorm_kernel<T, G, true><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const G*>(gamma), static_cast<T*>(out), rows, d, eps);
  else
    rmsnorm_kernel<T, G, false><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const G*>(gamma), static_cast<T*>(out), rows, d, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rmsnorm_fwd(const void* x, const void* gamma, void* out, int K,
                           long long rows, int d, float eps, int x_is_bf16, int g_is_bf16,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_is_bf16 && g_is_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, gamma, out, K, rows, d, eps, st);
  else if (x_is_bf16)
    err = launch<__nv_bfloat16, float>(x, gamma, out, K, rows, d, eps, st);
  else if (g_is_bf16)
    err = launch<float, __nv_bfloat16>(x, gamma, out, K, rows, d, eps, st);
  else
    err = launch<float, float>(x, gamma, out, K, rows, d, eps, st);
  return static_cast<int>(err);
}
