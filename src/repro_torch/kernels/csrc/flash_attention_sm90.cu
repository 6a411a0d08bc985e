// Flash attention forward for bf16 on Hopper's tensor cores (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_fwd_pallas
// (body _flash_kernel) for bf16 inputs; fp32 inputs go to the CUDA-core kernel
// in flash_attention.cu.  Same function as the Pallas kernel and as
// kernels/flash_attention.py::flash_fwd_plain: grouped-query heads (q head h
// reads kv head h / (H / Hkv)), the causal mask, the sliding window, the logit
// softcap applied before the mask, ragged Sq / Sk (Sq != Sk allowed), head dims
// D and Dv that are multiples of 16 up to 256 (Dv != D allowed).  It writes
// out (B, Sq, H, Dv) in bf16 and lse (B, H, Sq) in fp32, natural-log units,
// with lse = NEG_INF and out = 0 on fully masked rows.
//
// Bound on this card: operations.  The two products take
// 2 * B * H * Sq * Sk * (D + Dv) flops (about half of that under the causal
// mask) against 989 TFLOP/s of dense bf16 on the tensor cores; the bytes (q,
// k, v and out once each) take less than the operations at every shape the
// configs use.  At the starcoder2 main shape, q (16, 1024, 24, 128) and kv
// (16, 1024, 2, 128), causal: 103 GFLOP, 0.104 ms.  So both products run on
// the tensor cores with wgmma, and the loads are asynchronous so that they
// overlap the math:
//
// - A block owns one (128-row q tile, q head, batch): two consumer warpgroups
//   of 64 q rows each and one producer warpgroup, 384 threads; setmaxnreg
//   moves registers from the producer (40) to the consumers (232), which
//   hold the fp32 O accumulator (up to 128 a thread at Dv = 256).  Blocks run the
//   heavy causal q tiles first (blockIdx.z counts down over the q tiles) and
//   the q heads of one kv head side by side, so their K/V tiles meet in L2.
// - The producer's first thread loads the Q tile once and streams K and V
//   tiles of BK rows (128, or 64 at a 256-wide head) through a ring of 2
//   stages with TMA: one 4-D tensor map over (D, heads, S, B) per operand,
//   128-byte swizzle, 64-column panels, an mbarrier per stage for "full"
//   (transaction bytes) and one for "empty" (the 256 consumer threads).  Rows
//   past Sq / Sk and columns past D / Dv arrive as zeros (TMA's out-of-bounds
//   fill), so narrower head dims run in the 64-, 128- or 256-wide instance
//   whose padded columns add nothing.  cuTensorMapEncodeTiled comes through
//   cudaGetDriverEntryPoint, so the library needs no link against libcuda.
// - S = Q K^T: wgmma m64 n(BK) k16, bf16 from shared memory, fp32 accumulators
//   in registers.  The scale (folded with log2 e) is applied to the fp32
//   scores, never to bf16 Q; with a softcap, log2 e comes in after the tanh.
//   The masks are applied only on tiles at the causal diagonal, the window's
//   edge or the end of Sk; tiles that are fully masked for a warpgroup are
//   skipped.  The online softmax (m, l) lives in registers in log2 units; the
//   four threads that share a row reduce its max with shuffles.
// - O += P V: wgmma with P as the A operand from registers (the accumulator's
//   layout is the A fragment's) and V from shared memory in the transposed
//   (N-major) B mode.  P is rounded to bf16 for this product, the one change
//   of arithmetic against the Pallas kernel, which multiplies P in fp32; l
//   sums the fp32 P.  O accumulates in fp32.  The epilogue divides by l,
//   stages bf16 O through the warpgroup's (swizzled) Q rows and stores it in
//   16-byte pieces.
#include <cuda.h>

#include <cmath>
#include <cstdint>
#include <initializer_list>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using kernels::NEG_INF;

constexpr int BQ = 128;           // q rows per block
constexpr int NCONS = 256;        // two consumer warpgroups
constexpr int NT = NCONS + 128;   // and one producer warpgroup
constexpr int PRODUCER_REGS = 40; // setmaxnreg: 128 x 40 + 256 x 232 = 64,512 of 65,536
constexpr int CONSUMER_REGS = 232;
constexpr int STAGES = 2;         // K/V ring depth
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// DP: the head-dim instance (64, 128 or 256) that D and Dv are padded to.
template <int DP>
struct Cfg {
  static constexpr int BK = DP == 256 ? 64 : 128;      // kv rows per tile
  static constexpr int PANELS = DP / PANEL_COLS;
  static constexpr int NV = DP == 64 ? 64 : 128;       // N of one O += P V wgmma
  static constexpr int NHALF = DP / NV;                // O wgmmas per k step
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;         // one K or one V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_BYTES = 8 * (1 + 2 * STAGES);
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES + BAR_BYTES;
};

// -------------------------------------------------------------------- kernel
template <int DP>
__global__ void __launch_bounds__(NT, 1) flash_fwd_sm90_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int Sq, int Sk, int H, int Hkv, int Dv, float scale, int causal,
    int window, float softcap) {
  using C = Cfg<DP>;
  constexpr int BK = C::BK;
  constexpr int NS = BK / 2;       // score registers per thread
  constexpr int NO = C::NV / 2;    // output registers per thread per O wgmma
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023u) & ~1023u;  // [PANELS][BQ][64], swizzled
  const uint32_t sKV = sQ + C::Q_BYTES;         // per stage: K then V, [PANELS][BK][64]
  const uint32_t bar_q = sKV + STAGES * C::STAGE_BYTES;
  auto bar_full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto bar_empty = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int iq = gridDim.z - 1 - blockIdx.z;  // heavy causal tiles first
  const int hk = h / (H / Hkv);
  const int q0 = iq * BQ;
  const int n_tiles = (Sk + BK - 1) / BK;
  int lo = 0, hi = n_tiles;
  if (causal) hi = min(n_tiles, (q0 + BQ - 1) / BK + 1);
  if (window > 0) lo = max(0, (q0 - window + 1) / BK);
  const int n = max(hi - lo, 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), NCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NCONS / 32) {  // ------------------------- producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == NCONS) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
      for (int p = 0; p < C::PANELS; ++p)
        tma_load_4d(sQ + p * BQ * 128, &tm_q, bar_q, p * PANEL_COLS, h, q0, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(bar_empty(s), (i / STAGES - 1) & 1);
        const uint32_t sK = sKV + s * C::STAGE_BYTES, sV = sK + C::KV_BYTES;
        const int k0 = (lo + i) * BK;
        mbar_expect_tx(bar_full(s), C::STAGE_BYTES);
        for (int p = 0; p < C::PANELS; ++p) {
          tma_load_4d(sK + p * BK * 128, &tm_k, bar_full(s), p * PANEL_COLS, hk, k0, b);
          tma_load_4d(sV + p * BK * 128, &tm_v, bar_full(s), p * PANEL_COLS, hk, k0, b);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------ consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = warp / 4, t = threadIdx.x % 128;
  const int qw = q0 + 64 * wg;               // this warpgroup's first q row
  const int r0 = qw + 16 * (t / 32) + lane / 4;  // this thread's rows: r0 and r0 + 8
  const int c0 = 2 * (lane % 4);             // its first column in each 8-column block
  int lo_w = lo, hi_w = hi;                  // kv tiles this warpgroup needs
  if (causal) hi_w = min(hi, (qw + 63) / BK + 1);
  if (window > 0) lo_w = max(lo, (qw - window + 1) / BK);
  const float scale_log2 = scale * LOG2E;

  float o[C::NHALF][NO];
#pragma unroll
  for (int hh = 0; hh < C::NHALF; ++hh)
#pragma unroll
    for (int i = 0; i < NO; ++i) o[hh][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES, kt = lo + i, k0 = kt * BK;
    const uint32_t sK = sKV + s * C::STAGE_BYTES, sV = sK + C::KV_BYTES;
    mbar_wait(bar_full(s), (i / STAGES) & 1);
    if (qw < Sq && kt >= lo_w && kt < hi_w) {
      // S = Q K^T over DP / 16 steps of k16
      float sc[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) sc[j] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns within the panel
        const uint64_t da =
            smem_desc(sQ + (kk / 4) * BQ * 128 + wg * 64 * 128 + off, 16, 1024);
        const uint64_t db = smem_desc(sK + (kk / 4) * BK * 128 + off, 16, 1024);
        wgmma_ss<BK>(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // scale (and softcap) in fp32, then to log2 units
      if (softcap > 0.f) {
        const float inv_cap = 1.f / softcap, cap_log2 = softcap * LOG2E;
#pragma unroll
        for (int j = 0; j < NS; ++j) sc[j] = cap_log2 * tanhf(sc[j] * scale * inv_cap);
      } else {
#pragma unroll
        for (int j = 0; j < NS; ++j) sc[j] *= scale_log2;
      }
      // masks, only where the tile meets an edge
      if (k0 + BK > Sk || (causal && k0 + BK - 1 > qw) ||
          (window > 0 && k0 <= qw + 63 - window)) {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const int kp = k0 + 8 * (j / 4) + c0 + (j & 1);
          const int qp = r0 + 8 * ((j >> 1) & 1);
          const bool ok = kp < Sk && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
          sc[j] = ok ? sc[j] : -INFINITY;
        }
      }
      // online softmax: row max over the quad, rescale, exponentiate
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NS; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
      float mu[2], corr[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
        const float m_new = fmaxf(m[e], mx[e]);
        mu[e] = m_new == -INFINITY ? 0.f : m_new;
        corr[e] = exp2f(m[e] - mu[e]);
        m[e] = m_new;
        l[e] *= corr[e];
      }
      uint32_t pa[NS / 2];
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        const int e = (j >> 1) & 1;
        const float p0 = exp2f(sc[j] - mu[e]), p1 = exp2f(sc[j + 1] - mu[e]);
        l[e] += p0 + p1;
        pa[j / 2] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int hh = 0; hh < C::NHALF; ++hh)
#pragma unroll
        for (int j = 0; j < NO; ++j) o[hh][j] *= corr[(j >> 1) & 1];

      // O += P V over BK / 16 steps of k16
#pragma unroll
      for (int hh = 0; hh < C::NHALF; ++hh) fence_regs(o[hh]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
#pragma unroll
        for (int hh = 0; hh < C::NHALF; ++hh) {
          const uint64_t db = smem_desc(sV + hh * (C::NV / PANEL_COLS) * BK * 128 + kk * 16 * 128,
                                        BK * 128, 1024);
          wgmma_rs<C::NV>(o[hh], a, db);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int hh = 0; hh < C::NHALF; ++hh) fence_regs(o[hh]);
    }
    mbar_arrive(bar_empty(s));
  }

  // ------------------------------------------------------------- epilogue
  float inv[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
    inv[e] = 1.f / fmaxf(l[e], 1e-30f);
    const int qp = r0 + 8 * e;
    if (lane % 4 == 0 && qp < Sq)
      lse[(static_cast<long long>(b) * H + h) * Sq + qp] =
          m[e] == -INFINITY ? NEG_INF : (m[e] + log2f(l[e])) * LN2;
  }
  // bf16 O into this warpgroup's own Q rows (same swizzle), then 16-byte stores
  uint8_t* stage = smem_raw + (sQ - raw);
  const int rw = 16 * (t / 32) + lane / 4;  // row within the warpgroup
#pragma unroll
  for (int hh = 0; hh < C::NHALF; ++hh)
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      const int col = hh * C::NV + 8 * j;
      const int panel = col / PANEL_COLS, chunk = (col % PANEL_COLS) / 8;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = rw + 8 * e;
        const uint32_t off = panel * BQ * 128 + (64 * wg + row) * 128 +
                             ((chunk ^ (row & 7)) * 16) + 2 * c0;
        *reinterpret_cast<uint32_t*>(stage + off) =
            pack_bf16(o[hh][4 * j + 2 * e] * inv[e], o[hh][4 * j + 2 * e + 1] * inv[e]);
      }
    }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  constexpr int CHUNKS = DP / 8;  // 16-byte pieces of a row
  for (int idx = t; idx < 64 * CHUNKS; idx += 128) {
    const int row = idx / CHUNKS, ch = idx % CHUNKS, qp = qw + row;
    if (qp >= Sq || ch * 8 >= Dv) continue;
    const uint32_t off = (ch / 8) * BQ * 128 + (64 * wg + row) * 128 + (((ch % 8) ^ (row & 7)) * 16);
    *reinterpret_cast<uint4*>(out + ((static_cast<long long>(b) * Sq + qp) * H + h) * Dv + ch * 8) =
        *reinterpret_cast<const uint4*>(stage + off);
  }
}

// ---------------------------------------------------------------------- host
template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* lse, int B,
                   int Sq, int Sk, int H, int Hkv, int D, int Dv, float scale, int causal,
                   int window, float softcap, cudaStream_t stream) {
  using C = Cfg<DP>;
  const EncodeTiled enc = encoder();
  if (!enc) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(enc, &tq, q, D, H, Sq, B, BQ) || !make_map(enc, &tk, k, D, Hkv, Sk, B, C::BK) ||
      !make_map(enc, &tv, v, Dv, Hkv, Sk, B, C::BK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_sm90_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, (Sq + BQ - 1) / BQ);
  flash_fwd_sm90_kernel<DP><<<grid, NT, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), Sq, Sk, H, Hkv,
      Dv, scale, causal, window, softcap);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attn_fwd_sm90(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int B, int Sq, int Sk, int H, int Hkv, int D,
                                   int Dv, float scale, int causal, int window, float softcap,
                                   void* stream) {
  if (D % 16 || Dv % 16 || D <= 0 || Dv <= 0 || D > 256 || Dv > 256 || Hkv <= 0 || H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {q, k, v, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  if (B > 65535 || (Sq + BQ - 1) / BQ > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int dp = D > Dv ? D : Dv;
  cudaError_t err =
      dp <= 64    ? launch<64>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, D, Dv, scale, causal, window,
                               softcap, st)
      : dp <= 128 ? launch<128>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, D, Dv, scale, causal,
                                window, softcap, st)
                  : launch<256>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, D, Dv, scale, causal,
                                window, softcap, st);
  return static_cast<int>(err);
}
