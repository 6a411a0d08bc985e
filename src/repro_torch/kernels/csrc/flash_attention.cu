// Flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_fwd_pallas
// (body _flash_kernel): an online-softmax attention forward with grouped-query
// heads (q head h reads kv head h / g), causal and sliding-window masks and a
// logit softcap, ragged Sq / Sk masked as q_pos < Sq && k_pos < Sk.  It
// returns out (B, Sq, H, Dv) in q's dtype and lse (B, H, Sq) in fp32, with
// lse = NEG_INF and out = 0 on fully masked rows.  q/k/v are fp32 or bf16;
// every head dim that is a multiple of 16 up to 256 is taken.
//
// Bound on this card: operations.  The two products take
// 2 * B * H * Sq * Sk * (D + Dv) flops, half of that under the causal mask,
// against 989 TFLOP/s in bf16 on the tensor cores.  This first kernel does
// not reach them: it computes in fp32 on the CUDA cores, which keeps fp32
// inputs exact and one code path for both dtypes; wgmma, TMA and warp
// specialisation are later work.
//
// Design: one block per (64-row q tile, q head, batch); 256 threads.  The
// q tile (pre-scaled) stays in shared memory while the block walks the kv
// tiles of 32 rows, staged through shared memory; the walk stops at the
// causal diagonal and starts at the window's first visible tile (the Pallas
// kernel runs those tiles fully masked, which changes nothing).  Each thread
// owns 4 q rows: 4 x 2 scores of a tile and 4 x Dv/16 output accumulators,
// and the 16 threads of a row reduce the row max and sum with shuffles.  The
// online softmax state (m, l) lives in registers in fp32.  Heavy causal
// tiles are scheduled first.
#include <cstdint>

#include "common.cuh"

namespace {

using kernels::from_float;
using kernels::NEG_INF;
using kernels::to_float;

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 32;        // kv rows per tile
constexpr int NT = 256;       // threads per block: 16 row groups x 16 columns
constexpr int RPT = 4;        // q rows per thread
constexpr int CPT = BK / 16;  // score columns per thread
constexpr int MAXC = 16;      // output columns per thread at Dv = 256

size_t smem_bytes(int D, int Dv) {
  return sizeof(float) * (static_cast<size_t>(BQ) * (D + 1) + static_cast<size_t>(BK) * (D + 1) +
                          static_cast<size_t>(BK) * Dv + static_cast<size_t>(BQ) * (BK + 1));
}

template <typename T>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int H, int Hkv, int D,
    int Dv, float scale, int causal, int window, float softcap) {
  extern __shared__ float smem[];
  const int ldq = D + 1, ldk = D + 1, ldp = BK + 1;  // odd strides: no bank conflicts
  float* Qs = smem;              // [BQ][D + 1], q * scale
  float* Ks = Qs + BQ * ldq;     // [BK][D + 1]
  float* Vs = Ks + BK * ldk;     // [BK][Dv]
  float* Ps = Vs + BK * Dv;      // [BQ][BK + 1], this tile's probabilities

  const int iq = gridDim.x - 1 - blockIdx.x;  // late (heavy causal) tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = iq * BQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int ncv = Dv / 16;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, c = idx - r * D, qp = q0 + r;
    float val = 0.f;
    if (qp < Sq) val = to_float(q[((static_cast<long long>(b) * Sq + qp) * H + h) * D + c]) * scale;
    Qs[r * ldq + c] = val;
  }

  float acc[RPT][MAXC];
  float m_i[RPT], l_i[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = (Sk + BK - 1) / BK;
  int hi = n_tiles, lo = 0;
  if (causal) hi = min(n_tiles, (q0 + BQ - 1) / BK + 1);
  if (window > 0) lo = max(0, (q0 - window + 1) / BK);

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K/V are no longer read
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, c = idx - r * D, kp = k0 + r;
      Ks[r * ldk + c] =
          kp < Sk ? to_float(k[((static_cast<long long>(b) * Sk + kp) * Hkv + hk) * D + c]) : 0.f;
    }
    for (int idx = tid; idx < BK * Dv; idx += NT) {
      const int r = idx / Dv, c = idx - r * Dv, kp = k0 + r;
      Vs[r * Dv + c] =
          kp < Sk ? to_float(v[((static_cast<long long>(b) * Sk + kp) * Hkv + hk) * Dv + c]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qa[RPT], kb[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qa[i] = Qs[(ty * RPT + i) * ldq + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kb[j] = Ks[(tx + 16 * j) * ldk + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty * RPT + i, qp = q0 + r;
      bool ok[CPT];
      float row_max = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kp = k0 + tx + 16 * j;
        float sv = s[i][j];
        if (softcap > 0.f) sv = softcap * tanhf(sv / softcap);
        ok[j] = qp < Sq && kp < Sk && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
        s[i][j] = ok[j] ? sv : NEG_INF;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m_i[i], row_max);
      const float m_safe = m_new > NEG_INF / 2 ? m_new : 0.f;
      const float corr = m_i[i] > NEG_INF / 2 ? expf(m_i[i] - m_safe) : 0.f;
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_safe) : 0.f;
        Ps[r * ldp + tx + 16 * j] = p;
        row_sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      m_i[i] = m_new;
      l_i[i] = l_i[i] * corr + row_sum;
#pragma unroll
      for (int c = 0; c < MAXC; ++c) acc[i][c] *= corr;
    }
    __syncwarp();  // a row's probabilities come from the 16 threads of its warp half

    for (int j = 0; j < BK; ++j) {
      float p[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) p[i] = Ps[(ty * RPT + i) * ldp + j];
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        if (c < ncv) {
          const float vv = Vs[j * Dv + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
        }
      }
    }
    __syncwarp();  // Ps is rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qp = q0 + ty * RPT + i;
    if (qp >= Sq) continue;
    const float l = fmaxf(l_i[i], 1e-30f);
    T* orow = out + ((static_cast<long long>(b) * Sq + qp) * H + h) * Dv;
#pragma unroll
    for (int c = 0; c < MAXC; ++c)
      if (c < ncv) orow[tx + 16 * c] = from_float<T>(acc[i][c] / l);
    if (tx == 0)
      lse[(static_cast<long long>(b) * H + h) * Sq + qp] =
          m_i[i] > NEG_INF / 2 ? m_i[i] + logf(l) : NEG_INF;
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* lse, int B,
                   int Sq, int Sk, int H, int Hkv, int D, int Dv, float scale, int causal,
                   int window, float softcap, cudaStream_t stream) {
  if (D % 16 || Dv % 16 || D <= 0 || Dv <= 0 || D > 256 || Dv > 256 || Hkv <= 0 || H % Hkv)
    return cudaErrorInvalidValue;
  if (H > 65535 || B > 65535) return cudaErrorInvalidConfiguration;
  const size_t smem = smem_bytes(D, Dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), Sq, Sk, H, Hkv, D, Dv, scale, causal,
      window, softcap);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                              int B, int Sq, int Sk, int H, int Hkv, int D, int Dv, float scale,
                              int causal, int window, float softcap, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, D, Dv, scale, causal,
                                      window, softcap, st)
              : launch<float>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, D, Dv, scale, causal, window,
                              softcap, st);
  return static_cast<int>(err);
}
