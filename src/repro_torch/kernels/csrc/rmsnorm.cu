// RMSNorm forward and backward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py::rmsnorm_pallas (body
// _rmsnorm_kernel): out = x * rsqrt(mean(x^2) + eps) * (1 + gamma), fp32
// statistics, output in x's dtype, gamma stored as (gamma - 1).  The
// backward has no TPU kernel (the JAX package takes the VJP of the reference
// norm, repro/kernels/ops.py); rmsnorm_bwd computes that VJP in closed form,
// with r = rsqrt(mean(x^2) + eps) and w = 1 + gamma of the row's lane:
//     dx_i     = r w_i dy_i - (r^3 / d) x_i sum_j dy_j w_j x_j
//     dgamma_i = sum over the lane's rows of dy_i x_i r
// in fp32, dx cast to x's dtype and dgamma to gamma's.
//
// Input is lane-batched: x (K, rows, d) and one gain row per lane, gamma
// (K, d); x and gamma are each fp32 or bf16, dy and dx have x's dtype.
//
// Bound on this card: memory.  The forward reads x and writes out, the
// backward reads x and dy and writes dx, each once; a few flops an element
// are nothing beside that.
//
// Design.  A row group of W warps holds one row in registers, at most two
// 16-byte packs a thread (W = 6 at d = 3072 in bf16, 8 at 4096, 1 at 512),
// so the row is read from device memory once, and its sums are warp
// shuffles, then (W > 1) one exchange of warp sums behind the group's own
// named barrier, so row groups never wait for each other.  Few registers a
// thread keep the SM full of rows in flight: a whole row a warp (12 packs a
// thread at d = 3072, 16 at 4096) measured 42-69% of the byte bound
// (tools/rmsnorm_ab.py).  A block holds the row groups of up
// to 16 warps (forward) or 32 (backward), all of one lane, and stages that
// lane's gain in shared memory once.  The grid is the card's resident
// blocks split over the lanes: a forward row group strides over its lane's
// rows; a backward block takes a contiguous run of them, its row groups sum
// dy x r in registers, fold in group order and write one fp32 partial row a
// block (wide blocks, so few partials); rmsnorm_dgamma_kernel then sums a
// lane's partials in a fixed order.  No atomics: the bits depend only on
// the shapes and the card's SM count, so reruns agree, and so do lanes fed
// the same data.  Rows that are not a whole number of packs, unaligned
// pointers and rows too wide take the scalar kernels.
#include <cstdint>
#include <map>
#include <mutex>
#include <set>
#include <tuple>
#include <utility>

#include "common.cuh"

namespace {

using kernels::block_sum;
using kernels::from_float;
using kernels::to_float;
using kernels::warp_sum;

constexpr int MAX_PACKS = 2;           // 16-byte packs a thread holds of a row
constexpr int MAX_WARPS = 16;          // a row group's warps: rows up to 16 * 32 * 2 packs
constexpr int FWD_BLOCK_WARPS = 16;    // a block's warps, its row groups narrower than that
constexpr int BWD_BLOCK_WARPS = 32;    // (wider backward blocks: fewer dgamma partials)
constexpr int MAX_GROUPS = 15;         // row groups of 2+ warps a block: named barriers 1 to 15
constexpr int MAX_GAIN_BYTES = 32768;  // a gain row staged in shared memory
constexpr int MIN_ROW_STEPS = 2;       // a backward row group's least rows
constexpr int DGAMMA_SLICES = 8;       // warps a dgamma block, each summing every 8th partial
static_assert(MAX_WARPS <= FWD_BLOCK_WARPS && MAX_WARPS <= BWD_BLOCK_WARPS,
              "a row group fits a block");

// -------------------------------------------------------------- packs in words
// Element j of a run of 32-bit words holding values of type S.
template <typename S> __device__ __forceinline__ float elem(const uint32_t* w, int j);
template <> __device__ __forceinline__ float elem<float>(const uint32_t* w, int j) {
  return __uint_as_float(w[j]);
}
template <> __device__ __forceinline__ float elem<__nv_bfloat16>(const uint32_t* w, int j) {
  const uint32_t v = w[j >> 1];
  return __uint_as_float((j & 1) ? (v & 0xffff0000u) : (v << 16));
}

// Four words (a 16-byte pack) of type S from N floats, rounded as torch rounds.
template <typename S> __device__ __forceinline__ void put(uint32_t* w, const float* f);
template <> __device__ __forceinline__ void put<float>(uint32_t* w, const float* f) {
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = __float_as_uint(f[j]);
}
template <> __device__ __forceinline__ void put<__nv_bfloat16>(uint32_t* w, const float* f) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(f[2 * k]))) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(f[2 * k + 1]))) << 16);
}

__device__ __forceinline__ void load_pack(const void* p, uint32_t* w) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
}

__device__ __forceinline__ void store_pack(void* p, const uint32_t* w) {
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// An empty asm that the compiler must take to rewrite the packs: their
// values converted to float before it are not kept across it (that would
// double the registers a pack takes) but converted anew after it.
template <int P>
__device__ __forceinline__ void keep_words(uint32_t (&w)[P][4]) {
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(w[p][k]));
}

// The lane's gain row, copied once into the block's shared memory as 32-bit
// words (a row of d is a whole number of words: d is a multiple of the pack).
template <typename G>
__device__ __forceinline__ void stage_gain(const G* g, uint32_t* sg, int d) {
  const uint32_t* src = reinterpret_cast<const uint32_t*>(g);
  const int words = d * static_cast<int>(sizeof(G)) / 4;
  for (int k = threadIdx.x; k < words; k += blockDim.x) sg[k] = src[k];
  __syncthreads();
}

// WORDS words of the staged gain from p, read anew at each call: volatile,
// because the compiler would otherwise hoist the reads and their conversion
// out of the row loop and hold the gain as floats, a register a value,
// which costs the occupancy that hides the loads of x.
template <int WORDS>
__device__ __forceinline__ void lds_words(const uint32_t* p, uint32_t* w) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if constexpr (WORDS == 2) {
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];" : "=r"(w[0]), "=r"(w[1]) : "r"(a));
  } else {
#pragma unroll
    for (int k = 0; k < WORDS / 4; ++k)
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(w[4 * k]), "=r"(w[4 * k + 1]), "=r"(w[4 * k + 2]), "=r"(w[4 * k + 3])
                   : "r"(a + 16 * k));
  }
}

// Words of shared memory that a gain row of ``bytes`` takes, rounded to 16 bytes.
__host__ __device__ constexpr int gain_words(int bytes) { return (bytes + 15) / 16 * 4; }

// ------------------------------------------------------------ row-group sums
// Sum over a row group of W warps (threads [group * 32 W, (group + 1) * 32 W));
// every thread of the group gets it.  With W > 1 the group's warps exchange
// their sums through ``red`` behind the group's own named barrier, so row
// groups never wait for each other.  The caller alternates between two
// ``red`` buffers from row to row: a buffer is rewritten only after every
// warp of the group has passed the barrier of the row between, and so has
// read it.
template <typename V>
__device__ __forceinline__ V group_sum(V v, int W, int group, V* red);

__device__ __forceinline__ void group_barrier(int group, int W) {
  asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(32 * W) : "memory");
}

template <>
__device__ __forceinline__ float group_sum(float v, int W, int group, float* red) {
  v = warp_sum(v);
  if (W == 1) return v;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  group_barrier(group, W);
  float s = 0.f;
  for (int k = 0; k < W; ++k) s += red[group * W + k];
  return s;
}

template <>
__device__ __forceinline__ float2 group_sum(float2 v, int W, int group, float2* red) {
  v.x = warp_sum(v.x);
  v.y = warp_sum(v.y);
  if (W == 1) return v;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  group_barrier(group, W);
  float2 s = make_float2(0.f, 0.f);
  for (int k = 0; k < W; ++k) {
    s.x += red[group * W + k].x;
    s.y += red[group * W + k].y;
  }
  return s;
}

// Sum over the block, the same order in every thread; the block calls it
// together.  blockDim.x is a multiple of 32.
__device__ __forceinline__ float2 block_sum2(float2 v, float2* red) {
  v.x = warp_sum(v.x);
  v.y = warp_sum(v.y);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float2 s = make_float2(0.f, 0.f);
  for (int k = 0; k < static_cast<int>(blockDim.x >> 5); ++k) {
    s.x += red[k].x;
    s.y += red[k].y;
  }
  __syncthreads();  // red is rewritten by the next call
  return s;
}

// ------------------------------------------------------------------- forward
// grid (blocks a lane, K); a block of row groups of 32 W threads, each
// group striding over its lane's rows.
template <typename T, typename G, int P>
__global__ void __launch_bounds__(FWD_BLOCK_WARPS * 32)
rmsnorm_kernel(const T* __restrict__ x, const G* __restrict__ gamma, T* __restrict__ out,
               long long rows, int d, int W, float eps) {
  constexpr int N = 16 / sizeof(T);           // elements a pack
  constexpr int GW = N * sizeof(G) / 4;       // words of gain a pack
  __shared__ float red[2][FWD_BLOCK_WARPS];
  extern __shared__ __align__(16) uint32_t dyn_smem[];  // the lane's gain
  const int tpr = 32 * W, group = threadIdx.x / tpr, u = threadIdx.x % tpr;
  const int groups = blockDim.x / tpr, packs = d / N;
  const long long lane = blockIdx.y;

  stage_gain(gamma + lane * d, dyn_smem, d);
  const T* xl = x + lane * rows * d;
  T* ol = out + lane * rows * d;
  int buf = 0;
  for (long long row = static_cast<long long>(blockIdx.x) * groups + group; row < rows;
       row += static_cast<long long>(gridDim.x) * groups) {
    uint32_t xw[P][4];
    float ss = 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i = p * tpr + u;
      if (i < packs) {
        load_pack(xl + row * d + i * N, xw[p]);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float f = elem<T>(xw[p], j);
          ss += f * f;
        }
      }
    }
    ss = group_sum(ss, W, group, red[buf]);
    buf ^= 1;
    keep_words<P>(xw);
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i = p * tpr + u;
      if (i < packs) {
        uint32_t gw[GW];
        lds_words<GW>(dyn_smem + i * GW, gw);
        float o[N];
#pragma unroll
        for (int j = 0; j < N; ++j) o[j] = elem<T>(xw[p], j) * r * (1.f + elem<G>(gw, j));
        uint32_t ow[4];
        put<T>(ow, o);
        store_pack(ol + row * d + i * N, ow);
      }
    }
  }
}

// Any row: one block a row, a block reduction, the row read twice.
template <typename T, typename G>
__global__ void rmsnorm_kernel_scalar(const T* __restrict__ x, const G* __restrict__ gamma,
                                      T* __restrict__ out, long long rows, int d, float eps) {
  const long long row = blockIdx.x;  // global row of the (K * rows, d) view
  const T* xr = x + row * d;
  T* orow = out + row * d;
  const G* g = gamma + (row / rows) * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float f = to_float(xr[i]);
    ss += f * f;
  }
  const float r = rsqrtf(block_sum(ss) / static_cast<float>(d) + eps);
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    orow[i] = from_float<T>(to_float(xr[i]) * r * (1.f + to_float(g[i])));
}

// ------------------------------------------------------------------ backward
// grid (B blocks a lane, K); block b of a lane takes rows [b rows / B,
// (b + 1) rows / B), its row groups taking every groups-th of them, and
// writes partials[lane][b][:], its sum of dy x r.
template <typename T, typename G, int P>
__global__ void __launch_bounds__(BWD_BLOCK_WARPS * 32)
rmsnorm_bwd_kernel(const T* __restrict__ x, const G* __restrict__ gamma,
                   const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ partials,
                   long long rows, int d, int W, float eps) {
  constexpr int N = 16 / sizeof(T);
  constexpr int GW = N * sizeof(G) / 4;
  __shared__ float2 red[2][BWD_BLOCK_WARPS];
  // the lane's gain, then (2+ row groups) 32 W P N floats to fold the groups' sums
  extern __shared__ __align__(16) uint32_t dyn_smem[];
  float* fold = reinterpret_cast<float*>(dyn_smem + gain_words(d * sizeof(G)));
  const int tpr = 32 * W, group = threadIdx.x / tpr, u = threadIdx.x % tpr;
  const int groups = blockDim.x / tpr, packs = d / N;
  const long long lane = blockIdx.y;
  const long long lo = rows * blockIdx.x / gridDim.x, hi = rows * (blockIdx.x + 1) / gridDim.x;

  stage_gain(gamma + lane * d, dyn_smem, d);
  float acc[P][N] = {};
  const long long base = lane * rows * d;
  int buf = 0;
  for (long long row = lo + group; row < hi; row += groups) {
    uint32_t xw[P][4], dw[P][4];
    float ss = 0.f, sw = 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i = p * tpr + u;
      if (i < packs) {
        load_pack(x + base + row * d + i * N, xw[p]);
        load_pack(dy + base + row * d + i * N, dw[p]);
        uint32_t gw[GW];
        lds_words<GW>(dyn_smem + i * GW, gw);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float xf = elem<T>(xw[p], j);
          ss += xf * xf;
          sw += elem<T>(dw[p], j) * (1.f + elem<G>(gw, j)) * xf;
        }
      }
    }
    const float2 s = group_sum(make_float2(ss, sw), W, group, red[buf]);
    buf ^= 1;
    keep_words<P>(xw);
    keep_words<P>(dw);
    const float r = rsqrtf(s.x / static_cast<float>(d) + eps);
    const float c = r * r * r * s.y / static_cast<float>(d);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i = p * tpr + u;
      if (i < packs) {
        uint32_t gw[GW];
        lds_words<GW>(dyn_smem + i * GW, gw);
        float o[N];
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float xf = elem<T>(xw[p], j), df = elem<T>(dw[p], j);
          o[j] = r * (1.f + elem<G>(gw, j)) * df - c * xf;
          acc[p][j] += df * xf * r;
        }
        uint32_t ow[4];
        put<T>(ow, o);
        store_pack(dx + base + row * d + i * N, ow);
      }
    }
  }
  // fold the row groups into group 0, in group order
  for (int k = 1; k < groups; ++k) {
    if (group == k) {
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int j = 0; j < N; ++j) fold[(p * tpr + u) * N + j] = acc[p][j];
    }
    __syncthreads();
    if (group == 0) {
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int j = 0; j < N; ++j) acc[p][j] += fold[(p * tpr + u) * N + j];
    }
    __syncthreads();
  }
  if (group == 0) {
    float* part = partials + (lane * gridDim.x + blockIdx.x) * d;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i = p * tpr + u;
      if (i < packs) {
#pragma unroll
        for (int j = 0; j < N; j += 4)
          *reinterpret_cast<float4*>(part + i * N + j) =
              make_float4(acc[p][j], acc[p][j + 1], acc[p][j + 2], acc[p][j + 3]);
      }
    }
  }
}

// Any row: the block walks its rows one at a time, each thread keeping its
// columns' running dgamma sums in the block's partial row.
template <typename T, typename G>
__global__ void rmsnorm_bwd_kernel_scalar(const T* __restrict__ x, const G* __restrict__ gamma,
                                          const T* __restrict__ dy, T* __restrict__ dx,
                                          float* __restrict__ partials, long long rows, int d,
                                          float eps) {
  __shared__ float2 red[32];
  const long long lane = blockIdx.y;
  const long long lo = rows * blockIdx.x / gridDim.x, hi = rows * (blockIdx.x + 1) / gridDim.x;
  const G* g = gamma + lane * d;
  float* part = partials + (lane * gridDim.x + blockIdx.x) * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) part[i] = 0.f;
  for (long long row = lo; row < hi; ++row) {
    const long long off = (lane * rows + row) * d;
    float ss = 0.f, sw = 0.f;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float xf = to_float(x[off + i]);
      ss += xf * xf;
      sw += to_float(dy[off + i]) * (1.f + to_float(g[i])) * xf;
    }
    const float2 s = block_sum2(make_float2(ss, sw), red);
    const float r = rsqrtf(s.x / static_cast<float>(d) + eps);
    const float c = r * r * r * s.y / static_cast<float>(d);
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float xf = to_float(x[off + i]), df = to_float(dy[off + i]);
      dx[off + i] = from_float<T>(r * (1.f + to_float(g[i])) * df - c * xf);
      part[i] += df * xf * r;
    }
  }
}

// dgamma[lane][i] = the sum over b of partials[lane][b][i] in a fixed order:
// warp s of the block sums b = s, s + 8, ... for 32 columns, and the 8 sums
// are added in order of s.  grid (d / 32 rounded up, K).
template <typename G>
__global__ void __launch_bounds__(DGAMMA_SLICES * 32)
rmsnorm_dgamma_kernel(const float* __restrict__ partials, G* __restrict__ dgamma, int blocks,
                      int d) {
  __shared__ float sums[DGAMMA_SLICES][32];
  const long long lane = blockIdx.y;
  const int c = threadIdx.x & 31, s = threadIdx.x >> 5, i = blockIdx.x * 32 + c;
  float acc = 0.f;
  if (i < d) {
    const float* p = partials + lane * blocks * d + i;
    for (int b = s; b < blocks; b += DGAMMA_SLICES) acc += p[static_cast<long long>(b) * d];
  }
  sums[s][c] = acc;
  __syncthreads();
  if (s == 0 && i < d) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < DGAMMA_SLICES; ++k) t += sums[k][c];
    dgamma[lane * d + i] = from_float<G>(t);
  }
}

// ------------------------------------------------------------------ launchers
struct Shape {
  int W, P;  // warps a row group, packs a thread; P = 0: the scalar kernel
};

// The least W with at most MAX_PACKS packs a thread, then the least P.
template <typename T, typename G>
Shape pick(int d, bool aligned) {
  constexpr int N = 16 / sizeof(T);
  if (!aligned || d % N != 0 || d * sizeof(G) > MAX_GAIN_BYTES) return {0, 0};
  const int packs = d / N, W = (packs + 32 * MAX_PACKS - 1) / (32 * MAX_PACKS);
  if (W > MAX_WARPS) return {0, 0};
  return {W, (packs + 32 * W - 1) / (32 * W)};
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Row groups of W warps in a block of about ``block_warps`` warps.
int groups_of(int W, int block_warps) {
  const int g = block_warps / W;
  return g < 1 ? 1 : (W > 1 && g > MAX_GROUPS ? MAX_GROUPS : g);
}

// The card's SMs and the blocks of ``kernel`` resident on one at ``threads``
// and ``smem`` bytes of dynamic shared memory, asked of the runtime once for
// each device, kernel, block size and shared memory and then read from a
// table, so that a launch makes no query.  A kernel whose block needs more
// than the default 48 KB of shared memory, static included (2 row groups of
// the backward from d 6144 in bf16), is opted in, once, to all that a block
// can have on the card, so that no shape lowers the limit under another's.
// A null kernel asks for the SMs alone.
struct Fill {
  int sms, resident;
};

// Sets *opted when the kernel was opted in.
cudaError_t opt_in(const void* kernel, size_t smem, int dev, bool* opted) {
  cudaFuncAttributes attr;
  int most = 0;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess || attr.sharedSizeBytes + smem <= 48 * 1024) return err;
  err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most - static_cast<int>(attr.sharedSizeBytes));
  *opted = err == cudaSuccess;
  return err;
}

cudaError_t fill_of(const void* kernel, int threads, size_t smem, Fill* fill) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int, size_t>, Fill> table;
  static std::set<std::pair<int, const void*>> opted;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(dev, kernel, threads, smem);
  const std::lock_guard<std::mutex> lock(mu);
  const auto it = table.find(key);
  if (it != table.end()) {
    *fill = it->second;
    return cudaSuccess;
  }
  Fill f{0, 0};
  err = cudaDeviceGetAttribute(&f.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && kernel && !opted.count({dev, kernel})) {
    bool now = false;
    err = opt_in(kernel, smem, dev, &now);
    if (now) opted.insert({dev, kernel});
  }
  if (err == cudaSuccess && kernel)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&f.resident, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  f.resident = f.resident > 0 ? f.resident : 1;
  *fill = table[key] = f;
  return cudaSuccess;
}

cudaError_t card_sms(int* sms) {
  Fill f;
  const cudaError_t err = fill_of(nullptr, 0, 0, &f);
  *sms = f.sms;
  return err;
}

// How a shape is launched: the kernel (P packs a thread, 0: the scalar one),
// W warps a row group, the block's threads and dynamic shared memory, and
// the blocks a lane: the card's resident blocks split over the K lanes, at
// least 1 and at most ``cap``.
struct Launch {
  Shape s;
  int threads;
  size_t smem;
  int blocks;
};

cudaError_t plan(const void* kernel, Shape s, int threads, size_t smem, int K, long long cap,
                 Launch* L) {
  Fill f;
  const cudaError_t err = fill_of(kernel, threads, smem, &f);
  if (err != cudaSuccess) return err;
  long long b = (static_cast<long long>(f.sms) * f.resident + K - 1) / K;
  b = b < cap ? b : cap;
  *L = {s, threads, smem, static_cast<int>(b < 1 ? 1 : b)};
  return cudaSuccess;
}

template <typename T, typename G>
const void* fwd_kernel(int P) {
  static_assert(MAX_PACKS == 2, "one instance a pack count");
  return P == 1 ? reinterpret_cast<const void*>(rmsnorm_kernel<T, G, 1>)
                : reinterpret_cast<const void*>(rmsnorm_kernel<T, G, 2>);
}

template <typename T, typename G>
const void* bwd_kernel(int P) {
  return P == 0   ? reinterpret_cast<const void*>(rmsnorm_bwd_kernel_scalar<T, G>)
         : P == 1 ? reinterpret_cast<const void*>(rmsnorm_bwd_kernel<T, G, 1>)
                  : reinterpret_cast<const void*>(rmsnorm_bwd_kernel<T, G, 2>);
}

template <typename T, typename G>
cudaError_t fwd(const void* x, const void* gamma, void* out, int K, long long rows, int d,
                float eps, cudaStream_t st) {
  const Shape s = pick<T, G>(d, aligned16(x) && aligned16(gamma) && aligned16(out));
  if (s.P == 0) {
    int threads = ((d + 31) / 32) * 32;
    threads = threads > 1024 ? 1024 : threads;
    const long long blocks = static_cast<long long>(K) * rows;
    if (blocks > 2147483647LL) return cudaErrorInvalidValue;
    rmsnorm_kernel_scalar<T, G><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const G*>(gamma), static_cast<T*>(out), rows, d,
        eps);
    return cudaGetLastError();
  }
  const int groups = groups_of(s.W, FWD_BLOCK_WARPS);
  Launch L;
  cudaError_t err = plan(fwd_kernel<T, G>(s.P), s, groups * 32 * s.W,
                         4 * gain_words(d * sizeof(G)), K, (rows + groups - 1) / groups, &L);
  if (err != cudaSuccess) return err;
  const dim3 grid(L.blocks, K);
  const auto launch = [&](auto kernel) {
    kernel<<<grid, L.threads, L.smem, st>>>(static_cast<const T*>(x),
                                            static_cast<const G*>(gamma), static_cast<T*>(out),
                                            rows, d, s.W, eps);
  };
  if (s.P == 1) launch(rmsnorm_kernel<T, G, 1>);
  else launch(rmsnorm_kernel<T, G, 2>);
  return cudaGetLastError();
}

// The backward's launch for a shape, pointers' alignment included, its rows
// planned as in a launch of ``lanes`` lanes (K, or more: a population
// mesh's rank plans its K/N lanes as the whole population's K, so that a
// lane's blocks and row groups, and so the order of dgamma's sum, are the
// unsharded launch's).  Vector path: as many row groups as fill
// BWD_BLOCK_WARPS warps, fewer where the rows are too few to give a block
// on each SM MIN_ROW_STEPS rows a group; the shared memory holds the gain
// row and, with 2+ row groups, the fold of their dgamma sums (48 KB and
// more from d 6144 in bf16).
template <typename T, typename G>
cudaError_t plan_bwd(int lanes, long long rows, int d, bool aligned, Launch* L) {
  const Shape s = pick<T, G>(d, aligned);
  if (s.P == 0) {
    int threads = ((d + 31) / 32) * 32;
    threads = threads > 1024 ? 1024 : threads;
    return plan(bwd_kernel<T, G>(0), s, threads, 0, lanes, rows / MIN_ROW_STEPS, L);
  }
  int sms = 0;
  const cudaError_t err = card_sms(&sms);
  if (err != cudaSuccess) return err;
  int groups = groups_of(s.W, BWD_BLOCK_WARPS);
  const long long fill = lanes * rows / (static_cast<long long>(sms) * MIN_ROW_STEPS);
  groups = fill < groups ? (fill > 1 ? static_cast<int>(fill) : 1) : groups;
  const size_t smem = 4 * gain_words(d * sizeof(G)) +
                      (groups > 1 ? sizeof(float) * 32 * s.W * s.P * (16 / sizeof(T)) : 0);
  return plan(bwd_kernel<T, G>(s.P), s, groups * 32 * s.W, smem, lanes,
              rows / (static_cast<long long>(groups) * MIN_ROW_STEPS), L);
}

bool bwd_aligned(const void* x, const void* gamma, const void* dy, const void* dx) {
  return aligned16(x) && aligned16(gamma) && aligned16(dy) && aligned16(dx);
}

template <typename T, typename G>
cudaError_t bwd(const void* x, const void* gamma, const void* dy, void* dx, void* dgamma,
                float* partials, int K, int lanes, long long rows, int d, float eps,
                int partial_rows, cudaStream_t st) {
  Launch L;
  cudaError_t err = plan_bwd<T, G>(lanes, rows, d, bwd_aligned(x, gamma, dy, dx), &L);
  if (err != cudaSuccess) return err;
  if (L.blocks > partial_rows) return cudaErrorInvalidValue;
  const dim3 grid(L.blocks, K);
  const auto launch = [&](auto kernel, auto... w) {  // w: W, which the scalar kernel lacks
    kernel<<<grid, L.threads, L.smem, st>>>(
        static_cast<const T*>(x), static_cast<const G*>(gamma), static_cast<const T*>(dy),
        static_cast<T*>(dx), partials, rows, d, w..., eps);
  };
  if (L.s.P == 0) launch(rmsnorm_bwd_kernel_scalar<T, G>);
  else if (L.s.P == 1) launch(rmsnorm_bwd_kernel<T, G, 1>, L.s.W);
  else launch(rmsnorm_bwd_kernel<T, G, 2>, L.s.W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_dgamma_kernel<G><<<dim3((d + 31) / 32, K), DGAMMA_SLICES * 32, 0, st>>>(
      partials, static_cast<G*>(dgamma), L.blocks, d);
  return cudaGetLastError();
}

template <typename F>
cudaError_t by_dtype(int x_is_bf16, int g_is_bf16, F&& f) {
  if (x_is_bf16 && g_is_bf16) return f(__nv_bfloat16{}, __nv_bfloat16{});
  if (x_is_bf16) return f(__nv_bfloat16{}, float{});
  if (g_is_bf16) return f(float{}, __nv_bfloat16{});
  return f(float{}, float{});
}

}  // namespace

extern "C" int rmsnorm_fwd(const void* x, const void* gamma, void* out, int K,
                           long long rows, int d, float eps, int x_is_bf16, int g_is_bf16,
                           void* stream) {
  if (K < 1 || K > 65535 || rows < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_dtype(x_is_bf16, g_is_bf16, [&](auto t, auto g) {
    return fwd<decltype(t), decltype(g)>(x, gamma, out, K, rows, d, eps, st);
  }));
}

// The blocks a lane that rmsnorm_bwd launches for this shape, these
// pointers and ``lanes`` (the lanes its rows are planned for, at least K):
// the wrapper sizes the (K, blocks, d) fp32 partials from it.  The launch
// reads the same cached plan.
extern "C" int rmsnorm_bwd_blocks(const void* x, const void* gamma, const void* dy,
                                  const void* dx, int K, int lanes, long long rows, int d,
                                  int x_is_bf16, int g_is_bf16, int* blocks) {
  if (K < 1 || K > 65535 || lanes < K || rows < 1 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(by_dtype(x_is_bf16, g_is_bf16, [&](auto t, auto g) {
    using T = decltype(t);
    using G = decltype(g);
    Launch L;
    const cudaError_t err =
        plan_bwd<T, G>(lanes, rows, d, bwd_aligned(x, gamma, dy, dx), &L);
    *blocks = L.blocks;
    return err;
  }));
}

// dx (x's dtype) and dgamma (gamma's dtype) from x, gamma and dy (x's
// dtype), the rows planned for ``lanes`` lanes as in rmsnorm_bwd_blocks;
// ``partials`` holds K * partial_rows * d floats of scratch, with
// partial_rows at least rmsnorm_bwd_blocks's count.
extern "C" int rmsnorm_bwd(const void* x, const void* gamma, const void* dy, void* dx,
                           void* dgamma, void* partials, int K, int lanes, long long rows, int d,
                           float eps, int x_is_bf16, int g_is_bf16, int partial_rows,
                           void* stream) {
  if (K < 1 || K > 65535 || lanes < K || rows < 1 || d < 1 || partial_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_dtype(x_is_bf16, g_is_bf16, [&](auto t, auto g) {
    return bwd<decltype(t), decltype(g)>(x, gamma, dy, dx, dgamma, static_cast<float*>(partials),
                                         K, lanes, rows, d, eps, partial_rows, st);
  }));
}
