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
// backward pass rebuilds each chunk from it.  Any L and Dm, N from 1 to 64.
//
// Bound on this card, three ways, at falcon-mamba's shape x, dt (8, 1024,
// 8192) bf16, N 16 (R L Dm N = 1.07e9 state updates):
// - bytes: x and dt read once and y written once, 6 bytes per (row, t,
//   channel), 0.40 GB at 3.35 TB/s: 0.122 ms;
// - FP32 operations: dt * A, the decay times h plus dt x B, and h . C, about
//   6 per state update at 67 TFLOP/s: 0.096 ms;
// - the special-function units (SFU): one exponential per state update, and
//   an SM evaluates 16 a clock against its 128 FP32 lanes: 1.07e9 / (132 x 16
//   x 1.98 GHz) = 0.257 ms.  This one binds, and it is the floor the design
//   aims at.  Besides its exponential, a state update issues four FP32
//   instructions (dt * A', dt x * B, the FMA into h, the FMA into y), so the
//   SFU and the FP32 issue slots fill together.
//
// Design, against the four limits of a first kernel that gave each thread
// one (row, channel) and all N states (1.03 ms here):
// 1. One SFU instruction per state update.  The accurate exponential is a
//    range reduction of 6-8 FP32/INT instructions around one SFU op, which
//    left the issue slots, not the SFU, as the limit.  Here the lane's A is
//    scaled by log2 e once, in registers, and each decay is a single
//    ex2.approx.ftz.f32 of dt * A' (relative error about 2 ulp plus the
//    argument's rounding, |dt A| 2^-24).  The decay stays fp32: at
//    falcon-mamba's initial dt in [1e-3, 1e-1] with A_n = -(n + 1), a decay of
//    0.999 carried over ~1,000 steps does not survive fp16.  fp32 and bf16
//    inputs take the same instruction; the fp32 card cases hold 1e-4 with it.
// 2. Latency.  A channel's N states are split across S = 2, 4 or 8 adjacent
//    lanes of a warp, G states each (the instance is picked from N in the
//    launcher).  Each thread keeps its G states and G values of A' in
//    registers; y[t] is two interleaved FMA chains inside the thread, then
//    __shfl_xor_sync across the channel's S lanes, instead of one serial
//    chain of N FMAs.  At N = 16 (S = 2, G = 8) the main shape runs 4,096
//    warps in one wave of 8 resident warps a scheduler, each with 8
//    independent recurrences a step.  One wave at that occupancy allows 64
//    registers a thread; the tile loads and stores recompute their
//    addresses from the thread and block indices once per tile, so that no
//    per-thread offset lives (and spills) across the time loop.
// 3. Staging.  A block owns one row and CT consecutive channels.  Tiles of
//    TT steps of x, dt, B and C come into a ring of STAGES shared-memory
//    stages by cp.async of 16 bytes (zero-filled past L), one tile ahead of
//    the compute; after the ring's barrier the block converts the tile's B
//    and C rows to fp32, padded to G S states with zeros, and a second
//    barrier publishes them.  Those are the only block-wide barriers in the
//    time loop, two per tile: the per-tile work (addresses, conversion,
//    barriers) costs the same whatever the tile's length, and 32-step tiles
//    spend half as much of the loop on it as 16-step ones.
//    Steps past L carry dt = 0, which leaves the state unchanged.  Where a
//    ragged channel tile or an unaligned row stride rules out the 16-byte
//    copy, the block loads that tile element by element.
// 4. Writes.  y(t) is written over x(t) in the tile (safe: the shuffle that
//    completes y(t) waits on every lane's use of x(t)), and each warp stores
//    its own channels' y from there in 16-byte stores (element by element
//    on a ragged edge) with no block barrier.  The chunk states and h_last
//    go straight from the registers of their owners: a channel's G-state
//    groups are adjacent in memory, so the writes are float4 stores.  When
//    chunk is a multiple of TT the chunk test runs once per tile, not once
//    per step.
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

using kernels::from_float;
using kernels::to_float;

constexpr int CT = 64;      // channels per block
constexpr int TT = 32;      // timesteps per ring stage
constexpr int STAGES = 2;   // ring depth
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float exp2_sfu(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// threadIdx.x and blockIdx.x, read anew at each use: the tile loads and
// stores recompute their addresses from them once per tile instead of
// keeping per-thread offsets alive (and spilled) across the time loop
__device__ __forceinline__ int thread_index() {
  int v;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(v));
  return v;
}
__device__ __forceinline__ int block_index() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(v));
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// A thread's G states to dst (its first state's address); n0 is the index of
// its first state, and states from N on are padding.
template <int G>
__device__ __forceinline__ void write_states(float* dst, const float (&h)[G], int n0, int N) {
  if (G % 4 == 0 && N % 4 == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < G / 4; ++q)
      if (n0 + 4 * q < N)
        *reinterpret_cast<float4*>(dst + 4 * q) =
            make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (n0 + g < N) dst[g] = h[g];
  }
}

// G states a thread, S threads a channel
template <typename T, int G, int S>
struct Tile {
  static constexpr int THREADS = CT * S;
  static constexpr int NP = G * S;                            // states, padded
  static constexpr int CW = 32 / S;                           // channels a warp
  static constexpr int X_ELEMS = TT * CT;                     // one x or dt tile
  static constexpr int BC_ELEMS = TT * NP;                    // one B or C tile
  static constexpr int PER_CHUNK = 16 / static_cast<int>(sizeof(T));   // elements a copy
  static constexpr int X_CHUNKS = X_ELEMS / PER_CHUNK;        // 16-byte copies of x a tile
  static constexpr int X_CHUNKS_PER_THREAD = (X_CHUNKS + THREADS - 1) / THREADS;
  // a stage: x, dt (y is written over x), and B, C as they arrive
  static constexpr int STAGE_BYTES = (2 * X_ELEMS + 2 * BC_ELEMS) * sizeof(T);
  // the stages, then B and C of the tile being computed, as fp32
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * BC_ELEMS * 4;
  // at most 64 registers a thread: 1,024 threads an SM, 8 warps a scheduler
  static constexpr int MIN_BLOCKS = 1024 / THREADS;
};

// Where a block's tiles lie in global memory; recomputed once per tile.
struct Place {
  long long row;   // the block's row of x, dt, B, C, y
  int c0;          // its first channel
  bool vec;        // whole 16-byte copies of x, dt, y: a full channel tile, aligned rows
  bool vec_bc;     // whole 16-byte copies of B and C: aligned rows
};

template <typename T, int G, int S>
struct Scan {
  using C = Tile<T, G, S>;
  const T* x;
  const T* dt;
  const T* Bm;
  const T* Cm;
  T* y;
  float* hs;
  int L, Dm, N, chunk, n_chunks, d_blocks;
  unsigned char* smem;

  __device__ Place place() const {
    const int b = block_index();
    Place p;
    p.row = b / d_blocks;
    p.c0 = (b - static_cast<int>(p.row) * d_blocks) * CT;
    p.vec = p.c0 + CT <= Dm && Dm % C::PER_CHUNK == 0 &&
            ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dt) |
              reinterpret_cast<uintptr_t>(y)) & 15) == 0;
    p.vec_bc = static_cast<long long>(L) * N % C::PER_CHUNK == 0 &&
               ((reinterpret_cast<uintptr_t>(Bm) | reinterpret_cast<uintptr_t>(Cm)) & 15) == 0;
    return p;
  }

  __device__ T* sx(int k) const {
    return reinterpret_cast<T*>(smem + (k % STAGES) * C::STAGE_BYTES);
  }
  __device__ T* sdt(int k) const { return sx(k) + C::X_ELEMS; }
  __device__ T* sbr(int k) const { return sdt(k) + C::X_ELEMS; }   // B's rows as they arrive
  __device__ T* scr(int k) const { return sbr(k) + C::BC_ELEMS; }
  __device__ float* sB() const {
    return reinterpret_cast<float*>(smem + STAGES * C::STAGE_BYTES);
  }
  __device__ float* sC() const { return sB() + C::BC_ELEMS; }

  // x, dt, B and C of tile k into its ring slot: cp.async (zero-filled past
  // L), or element by element where an edge or an alignment rules it out
  __device__ void load(int k, const Place& p) const {
    const int tid = thread_index(), t0 = k * TT;
    T* dx = sx(k);
    T* ddt = sdt(k);
    const long long base = (p.row * L + t0) * Dm + p.c0;
    if (p.vec) {
#pragma unroll
      for (int i = 0; i < C::X_CHUNKS_PER_THREAD; ++i) {
        const int q = tid + i * C::THREADS;
        if (C::X_CHUNKS % C::THREADS == 0 || q < C::X_CHUNKS) {
          const int tt = q / (CT / C::PER_CHUNK), col = q % (CT / C::PER_CHUNK) * C::PER_CHUNK;
          const bool in = t0 + tt < L;
          const long long off = in ? base + static_cast<long long>(tt) * Dm + col : 0;
          cp_async16(dx + tt * CT + col, x + off, in ? 16 : 0);
          cp_async16(ddt + tt * CT + col, dt + off, in ? 16 : 0);
        }
      }
    } else {
#pragma unroll 1
      for (int q = tid; q < C::X_ELEMS; q += C::THREADS) {
        const int tt = q / CT, c = q % CT;
        const bool in = t0 + tt < L && p.c0 + c < Dm;
        const long long off = base + static_cast<long long>(tt) * Dm + c;
        dx[q] = in ? x[off] : from_float<T>(0.f);
        ddt[q] = in ? dt[off] : from_float<T>(0.f);
      }
    }
    // B and C: the tile's TT rows of N are contiguous
    const long long bc0 = (p.row * L + t0) * N;
    const int valid = (L - t0 < TT ? L - t0 : TT) * N;   // elements before L
    T* db = sbr(k);
    T* dc = scr(k);
    if (p.vec_bc) {
      const int chunks = (TT * N + C::PER_CHUNK - 1) / C::PER_CHUNK;
#pragma unroll 1
      for (int q = tid; q < chunks; q += C::THREADS) {
        const int e = q * C::PER_CHUNK;
        const int bytes = (valid - e < C::PER_CHUNK ? (valid - e > 0 ? valid - e : 0)
                                                     : C::PER_CHUNK) * static_cast<int>(sizeof(T));
        cp_async16(db + e, Bm + (bytes ? bc0 + e : 0), bytes);
        cp_async16(dc + e, Cm + (bytes ? bc0 + e : 0), bytes);
      }
    } else {
#pragma unroll 1
      for (int q = tid; q < TT * N; q += C::THREADS) {
        db[q] = q < valid ? Bm[bc0 + q] : from_float<T>(0.f);
        dc[q] = q < valid ? Cm[bc0 + q] : from_float<T>(0.f);
      }
    }
  }

  // B and C of tile k to fp32, padded to NP states with zeros
  __device__ void convert_bc(int k) const {
    const T* b = sbr(k);
    const T* c = scr(k);
    float* fb = sB();
    float* fc = sC();
#pragma unroll
    for (int i = 0; i < (C::BC_ELEMS + C::THREADS - 1) / C::THREADS; ++i) {
      const int q = thread_index() + i * C::THREADS;
      if (C::BC_ELEMS % C::THREADS == 0 || q < C::BC_ELEMS) {
        const int tt = q / C::NP, n = q % C::NP;
        fb[q] = n < N ? to_float(b[tt * N + n]) : 0.f;
        fc[q] = n < N ? to_float(c[tt * N + n]) : 0.f;
      }
    }
  }

  // y of tile k, which the warp wrote over its channels of the x tile, to
  // global memory: each warp stores its own channels
  __device__ void store_y(int k, const Place& p) const {
    const int lane = thread_index() & 31, cw0 = (thread_index() >> 5) * C::CW;
    const int t0 = k * TT;
    const T* src = sx(k);
    const long long base = (p.row * L + t0) * Dm + p.c0 + cw0;
    constexpr int ROW_CHUNKS = C::CW * static_cast<int>(sizeof(T)) / 16;   // 16-byte copies
    if (ROW_CHUNKS > 0 && p.vec) {
#pragma unroll
      for (int i = 0; i < (TT * ROW_CHUNKS + 31) / 32; ++i) {
        const int q = lane + 32 * i;
        const int tt = q / (ROW_CHUNKS > 0 ? ROW_CHUNKS : 1);
        const int col = (q - tt * ROW_CHUNKS) * C::PER_CHUNK;
        if ((TT * ROW_CHUNKS % 32 == 0 || q < TT * ROW_CHUNKS) && t0 + tt < L)
          *reinterpret_cast<int4*>(y + base + static_cast<long long>(tt) * Dm + col) =
              *reinterpret_cast<const int4*>(src + tt * CT + cw0 + col);
      }
    } else {
#pragma unroll 1
      for (int q = lane; q < TT * C::CW; q += 32) {
        const int tt = q / C::CW, c = q % C::CW;
        if (t0 + tt < L && p.c0 + cw0 + c < Dm)
          y[base + static_cast<long long>(tt) * Dm + c] = src[tt * CT + cw0 + c];
      }
    }
  }

  // the state entering step t, from the registers of its owner
  __device__ void save_chunk_state(int t, int d, int n0, const float (&h)[G]) const {
    if (d < Dm) {
      const long long row = block_index() / d_blocks;
      write_states<G>(hs + ((row * n_chunks + t / chunk) * Dm + d) * N + n0, h, n0, N);
    }
  }

  // TT steps of tile k for channel cl of the tile (d in the row), states n0..
  // PER_STEP: test for a chunk boundary at every step (chunk not a multiple
  // of TT); otherwise boundaries fall on tile starts.  y(t) goes over x(t):
  // the shuffle that completes y(t) waits for every lane's use of x(t).
  template <bool PER_STEP>
  __device__ void compute(int k, int cl, int d, int n0, float (&h)[G], const float (&a)[G],
                          float dskip, int& next_chunk) const {
    const int t0 = k * TT;
    T* px = sx(k) + cl;   // the channel's S threads store the same y here
    const T* pdt = sdt(k) + cl;
    const float* pb = sB() + n0;
    const float* pc = sC() + n0;
    if (!PER_STEP && t0 == next_chunk) {
      save_chunk_state(t0, d, n0, h);
      next_chunk = chunk < L - t0 ? t0 + chunk : INT_MAX;
    }
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) {
      if (PER_STEP && t0 + tt == next_chunk) {
        save_chunk_state(t0 + tt, d, n0, h);
        next_chunk = chunk < L - (t0 + tt) ? t0 + tt + chunk : INT_MAX;
      }
      const float xv = to_float(px[tt * CT]);
      const float dtv = to_float(pdt[tt * CT]);
      const float dtx = dtv * xv;
      float b[G], c[G];
      if constexpr (G % 4 == 0) {
#pragma unroll
        for (int g = 0; g < G; g += 4) {
          const float4 bb = *reinterpret_cast<const float4*>(pb + tt * C::NP + g);
          const float4 cc = *reinterpret_cast<const float4*>(pc + tt * C::NP + g);
          b[g] = bb.x, b[g + 1] = bb.y, b[g + 2] = bb.z, b[g + 3] = bb.w;
          c[g] = cc.x, c[g + 1] = cc.y, c[g + 2] = cc.z, c[g + 3] = cc.w;
        }
      } else {
#pragma unroll
        for (int g = 0; g < G; g += 2) {
          const float2 bb = *reinterpret_cast<const float2*>(pb + tt * C::NP + g);
          const float2 cc = *reinterpret_cast<const float2*>(pc + tt * C::NP + g);
          b[g] = bb.x, b[g + 1] = bb.y, c[g] = cc.x, c[g + 1] = cc.y;
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) h[g] = fmaf(h[g], exp2_sfu(dtv * a[g]), dtx * b[g]);
      float acc0 = h[0] * c[0], acc1 = h[1] * c[1];
#pragma unroll
      for (int g = 2; g < G; g += 2) {
        acc0 = fmaf(h[g], c[g], acc0);
        acc1 = fmaf(h[g + 1], c[g + 1], acc1);
      }
      float yv = acc0 + acc1;
#pragma unroll
      for (int off = S / 2; off > 0; off >>= 1) yv += __shfl_xor_sync(0xffffffffu, yv, off);
      px[tt * CT] = from_float<T>(fmaf(dskip, xv, yv));
    }
  }
};

template <typename T, int G, int S>
__global__ void __launch_bounds__(Tile<T, G, S>::THREADS, Tile<T, G, S>::MIN_BLOCKS)
    ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ Dv,
                    const float* __restrict__ h0, T* __restrict__ y,
                    float* __restrict__ h_last, float* __restrict__ hs, int L, int Dm, int N,
                    int rows_per_lane, int chunk, int n_chunks, int d_blocks) {
  extern __shared__ __align__(16) unsigned char smem[];

  Scan<T, G, S> sc;
  sc.x = x, sc.dt = dt, sc.Bm = Bm, sc.Cm = Cm, sc.y = y, sc.hs = hs;
  sc.L = L, sc.Dm = Dm, sc.N = N, sc.chunk = chunk, sc.n_chunks = n_chunks;
  sc.d_blocks = d_blocks;
  sc.smem = smem;

  // this thread: channel cl of the block's tile (d in the row), states n0..
  const Place p0 = sc.place();
  const int cl = threadIdx.x / S, n0 = threadIdx.x % S * G, d = p0.c0 + cl;
  const long long lane = p0.row / rows_per_lane;
  float a[G], h[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const bool on = d < Dm && n0 + g < N;
    a[g] = on ? A[(lane * Dm + d) * N + n0 + g] * LOG2E : 0.f;
    h[g] = on && h0 != nullptr ? h0[(p0.row * Dm + d) * N + n0 + g] : 0.f;
  }
  const float dskip = d < Dm ? Dv[lane * Dm + d] : 0.f;

  const int n_tiles = (L + TT - 1) / TT;
  sc.load(0, p0);
  cp_async_commit();
  int next_chunk = hs != nullptr ? 0 : INT_MAX;
  const bool per_step = hs != nullptr && chunk % TT != 0;
  for (int k = 0; k < n_tiles; ++k) {
    cp_async_wait<0>();
    __syncthreads();  // tile k has landed; tile k - 1's slot and the fp32 B, C are free
    sc.convert_bc(k);
    const Place p = sc.place();
    if (k + 1 < n_tiles) sc.load(k + 1, p);
    cp_async_commit();
    __syncthreads();  // tile k's fp32 B, C are in place
    if (per_step)
      sc.template compute<true>(k, cl, d, n0, h, a, dskip, next_chunk);
    else
      sc.template compute<false>(k, cl, d, n0, h, a, dskip, next_chunk);
    __syncwarp();
    sc.store_y(k, p);
  }
  if (d < Dm) write_states<G>(h_last + (p0.row * Dm + d) * N + n0, h, n0, N);
}

// The split of the states: S lanes a channel, G states a lane.
template <int G_, int S_>
struct Split {
  static constexpr int G = G_, S = S_;
};

template <typename F>
cudaError_t with_split(int N, F&& f) {
  if (N <= 4) return f(Split<2, 2>{});
  if (N <= 8) return f(Split<4, 2>{});
  if (N <= 16) return f(Split<8, 2>{});
  if (N <= 32) return f(Split<8, 4>{});
  return f(Split<8, 8>{});
}

// Above 48 KB of dynamic shared memory (fp32 at N > 32) the kernel has to
// ask for it; once per instance.
template <typename T, int G, int S>
cudaError_t set_attributes() {
  static bool done = Tile<T, G, S>::SMEM <= 48 * 1024;
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_kernel<T, G, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<T, G, S>::SMEM);
  done = err == cudaSuccess;
  return err;
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const float* A, const void* Bm,
                   const void* Cm, const float* Dv, const float* h0, void* y, float* h_last,
                   float* hs, int R, int L, int Dm, int N, int K, int chunk,
                   cudaStream_t stream) {
  return with_split(N, [&](auto split) {
    using P = decltype(split);
    using C = Tile<T, P::G, P::S>;
    const int d_blocks = (Dm + CT - 1) / CT;
    const long long blocks = static_cast<long long>(R) * d_blocks;
    if (blocks > 2147483647LL) return cudaErrorInvalidValue;
    const cudaError_t err = set_attributes<T, P::G, P::S>();
    if (err != cudaSuccess) return err;
    ssm_scan_kernel<T, P::G, P::S><<<static_cast<unsigned>(blocks), C::THREADS, C::SMEM, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dt), A, static_cast<const T*>(Bm),
        static_cast<const T*>(Cm), Dv, h0, static_cast<T*>(y), h_last, hs, L, Dm, N, R / K,
        chunk, (L + chunk - 1) / chunk, d_blocks);
    return cudaGetLastError();
  });
}

// Resident blocks an SM and threads a block of the instance that N picks.
template <typename T>
cudaError_t occupancy(int N, int* blocks_per_sm, int* threads) {
  return with_split(N, [&](auto split) {
    using P = decltype(split);
    using C = Tile<T, P::G, P::S>;
    const cudaError_t err = set_attributes<T, P::G, P::S>();
    if (err != cudaSuccess) return err;
    *threads = C::THREADS;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, ssm_scan_kernel<T, P::G, P::S>, C::THREADS, C::SMEM);
  });
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

// The occupancy of the kernel instance that ssm_scan_fwd launches for N.
extern "C" int ssm_scan_occupancy(int N, int is_bf16, int* blocks_per_sm, int* threads) {
  if (N < 1 || N > 64) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(is_bf16 ? occupancy<__nv_bfloat16>(N, blocks_per_sm, threads)
                                  : occupancy<float>(N, blocks_per_sm, threads));
}
