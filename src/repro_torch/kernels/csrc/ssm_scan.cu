// Mamba-1 selective scan forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssm_scan.py::ssm_scan_pallas (body
// _ssm_kernel):
//
//   h[t] = exp(dt[t] * A) * h[t-1] + (dt[t] * x[t]) (x) B[t]     fp32 state
//   y[t] = h[t] . C[t] + D * x[t]                                 x's dtype
//
// with an optional initial state h0 and the final state h_last written out.
// Input is lane-batched: rows of x, dt (R, L, Dm) and B, C (R, L, N), with
// one A (Dm, N) and one D (Dm) per lane, A (K, Dm, N), D (K, Dm); row r
// reads lane r / (R / K).  x, dt, B, C are all fp32 or all bf16; A, D, h0,
// h_last are fp32.  With `hs` given, the state entering every `chunk`
// timesteps is written to hs (R, ceil(L / chunk), Dm, N): the chunked
// backward pass rebuilds each chunk from it.
//
// Bound on this card: memory, by the count the roofline takes (x and dt
// read once, y written once, 6 bytes per (row, t, channel) in bf16; the
// 6 fp32 operations per (row, t, channel, state) come to less time at
// 67 TFLOP/s).  In practice the N exponentials per (row, t, channel) on the
// special-function units and the serial dependence along t limit it.
//
// Design (a first, simple kernel): the TPU grid swept the chunks of L in
// order with the state in VMEM scratch; here the sweep over t is a loop
// inside one thread, which owns one (row, channel) and keeps its N states
// and its N values of A in registers.  A block is 128 consecutive channels
// of one row, so each step's loads of x and dt and the store of y are
// coalesced along the channel axis; the block stages the B[t] and C[t]
// vectors of a tile of timesteps in shared memory, read by all its threads.
// The next step's x and dt are loaded (and kept unconverted) before the
// current step is computed.
// expf, the accurate exponential and not the fast intrinsic, keeps the
// decay within the fp32 gate.  L needs no padding; N is at most 64.
#include <cstdint>

#include "common.cuh"

namespace {

using kernels::from_float;
using kernels::to_float;

constexpr int THREADS = 128;   // channels per block
constexpr int TILE_T = 64;     // timesteps of B, C staged per pass

// Up to N = 32, ask for four resident blocks a SM (at most 128 registers a
// thread), which keeps the N states in registers without spilling.
template <typename T, int NT>
__global__ void __launch_bounds__(THREADS, NT <= 32 ? 4 : 1) ssm_scan_kernel(
    const T* __restrict__ x, const T* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ Dv,
    const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ h_last,
    float* __restrict__ hs, int L, int Dm, int N, int rows_per_lane, int chunk,
    int n_chunks, int d_blocks) {
  __shared__ float sB[TILE_T * NT];
  __shared__ float sC[TILE_T * NT];

  const long long row = blockIdx.x / d_blocks;
  const int d = (blockIdx.x % d_blocks) * THREADS + threadIdx.x;
  const bool live = d < Dm;
  const long long lane = row / rows_per_lane;

  float a[NT], h[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const bool on = live && n < N;
    a[n] = on ? A[(lane * Dm + d) * N + n] : 0.f;
    h[n] = on && h0 != nullptr ? h0[(row * Dm + d) * N + n] : 0.f;
  }
  const float dskip = live ? Dv[lane * Dm + d] : 0.f;

  const long long base = row * L * static_cast<long long>(Dm) + d;
  const T* xr = x + base;
  const T* dtr = dt + base;
  T* yr = y + base;
  const T* br = Bm + row * L * static_cast<long long>(N);
  const T* cr = Cm + row * L * static_cast<long long>(N);

  // the next step's raw x and dt; converted only when used, so the load's
  // latency hides behind the current step
  T x_next = live ? xr[0] : from_float<T>(0.f);
  T dt_next = live ? dtr[0] : from_float<T>(0.f);

  for (int t0 = 0; t0 < L; t0 += TILE_T) {
    const int tn = min(TILE_T, L - t0);
    __syncthreads();  // the previous tile's B, C are no longer read
    for (int i = threadIdx.x; i < tn * N; i += THREADS) {
      const int tt = i / N, n = i - tt * N;
      sB[tt * NT + n] = to_float(br[static_cast<long long>(t0) * N + i]);
      sC[tt * NT + n] = to_float(cr[static_cast<long long>(t0) * N + i]);
    }
    __syncthreads();
    if (!live) continue;
    for (int tt = 0; tt < tn; ++tt) {
      const int t = t0 + tt;
      const float xv = to_float(x_next), dtv = to_float(dt_next);
      if (t + 1 < L) {
        x_next = xr[static_cast<long long>(t + 1) * Dm];
        dt_next = dtr[static_cast<long long>(t + 1) * Dm];
      }
      if (hs != nullptr && t % chunk == 0) {
        float* out = hs + ((row * n_chunks + t / chunk) * Dm + d) * N;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          if (n < N) out[n] = h[n];
      }
      const float dtx = dtv * xv;
      const float* b = sB + tt * NT;
      const float* c = sC + tt * NT;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n < N) {
          h[n] = fmaf(h[n], expf(dtv * a[n]), dtx * b[n]);
          acc = fmaf(h[n], c[n], acc);
        }
      }
      yr[static_cast<long long>(t) * Dm] = from_float<T>(acc + dskip * xv);
    }
  }
  if (live) {
    float* out = h_last + (row * Dm + d) * N;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (n < N) out[n] = h[n];
  }
}

template <typename T, int NT>
cudaError_t launch_nt(const void* x, const void* dt, const float* A, const void* Bm,
                      const void* Cm, const float* Dv, const float* h0, void* y,
                      float* h_last, float* hs, int R, int L, int Dm, int N, int K,
                      int chunk, cudaStream_t stream) {
  const int d_blocks = (Dm + THREADS - 1) / THREADS;
  const long long blocks = static_cast<long long>(R) * d_blocks;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  const int n_chunks = (L + chunk - 1) / chunk;
  ssm_scan_kernel<T, NT><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), Dv, h0, static_cast<T*>(y), h_last, hs, L, Dm, N, R / K,
      chunk, n_chunks, d_blocks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const float* A, const void* Bm,
                   const void* Cm, const float* Dv, const float* h0, void* y, float* h_last,
                   float* hs, int R, int L, int Dm, int N, int K, int chunk,
                   cudaStream_t stream) {
  if (N <= 4)
    return launch_nt<T, 4>(x, dt, A, Bm, Cm, Dv, h0, y, h_last, hs, R, L, Dm, N, K, chunk, stream);
  if (N <= 8)
    return launch_nt<T, 8>(x, dt, A, Bm, Cm, Dv, h0, y, h_last, hs, R, L, Dm, N, K, chunk, stream);
  if (N <= 16)
    return launch_nt<T, 16>(x, dt, A, Bm, Cm, Dv, h0, y, h_last, hs, R, L, Dm, N, K, chunk, stream);
  if (N <= 32)
    return launch_nt<T, 32>(x, dt, A, Bm, Cm, Dv, h0, y, h_last, hs, R, L, Dm, N, K, chunk, stream);
  return launch_nt<T, 64>(x, dt, A, Bm, Cm, Dv, h0, y, h_last, hs, R, L, Dm, N, K, chunk, stream);
}

}  // namespace

extern "C" int ssm_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* Dv, const void* h0, void* y,
                            void* h_last, void* hs, int R, int L, int Dm, int N, int K,
                            int chunk, int is_bf16, void* stream) {
  if (N < 1 || N > 64 || K < 1 || R % K != 0 || L < 1 || Dm < 1 || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(Dv);
  const float* h0f = static_cast<const float*>(h0);
  float* hl = static_cast<float*>(h_last);
  float* hsf = static_cast<float*>(hs);
  cudaError_t err;
  if (is_bf16)
    err = launch<__nv_bfloat16>(x, dt, Af, Bm, Cm, Df, h0f, y, hl, hsf, R, L, Dm, N, K, chunk, st);
  else
    err = launch<float>(x, dt, Af, Bm, Cm, Df, h0f, y, hl, hsf, R, L, Dm, N, K, chunk, st);
  return static_cast<int>(err);
}
