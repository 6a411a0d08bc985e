// Flash attention backward on Hopper (sm_90a): bf16 on the tensor cores
// (wgmma + TMA at the main paths' widths, mma.sync at the others), fp32 in
// exact FMAs on the CUDA cores.
//
// Replaces no TPU kernel: it is the VJP of repro/kernels/flash_attention.py::
// _flash_fwd_pallas, which the JAX package computes in plain jnp
// (_make_flash.bwd, the blocked backward repro/kernels/ref.py::_blocked_bwd).
// It computes what kernels/flash_attention.py::flash_bwd_plain computes, from
// (q, k, v, out, lse, dout): dq (B, Sq, H, D), dk (B, Sk, Hkv, D) and dv (B,
// Sk, Hkv, Dv) in the inputs' dtype, with P = exp(S - lse) recomputed from the
// forward's lse (B, H, Sq), S = scale q k^T under the logit softcap, the
// causal and window masks and ragged Sq / Sk, and P = 0 on rows whose lse is
// NEG_INF (fully masked rows).  Grouped-query heads: q head h reads kv head
// h / (H / Hkv); head dims D and Dv multiples of 16 up to 256, D != Dv allowed.
//
// Bound on this card: operations.  Five products over each visible (q, k)
// pair of each head (S, dP = dO V^T, dV += P^T dO, dK += dS^T Q, dQ += dS K):
// 2 * B * H * pairs * (3 D + 2 Dv) flops against 989 TFLOP/s of dense bf16;
// the bytes (q, k, v, out, dout read once, dq, dk, dv written once) take less
// at every shape the configs use.  At the starcoder2 main shape, q (16, 1024,
// 24, 128) over 2 kv heads, causal: 258 GFLOP, 0.261 ms.
//
// Design: the deterministic two-kernel form, after a pre-pass, all on the
// caller's stream, no atomics.  Every output element is written once by one
// block, each block's sums run in a fixed order, and a block reads only its
// own batch row, so a lane's bits depend on its own rows alone, whatever the
// batch's extent or the card's SM count.  The form recomputes S and dP in
// the dQ kernel: 7 products where the bound counts 5.
//  - delta = rowsum(dO * O) in fp32, (B, H, Sq): at the wgmma instances the
//    dQ kernel forms it from its resident dO and O tiles and runs first; at
//    the others fa_bwd_delta_kernel, a pre-pass, one warp a row, each lane
//    summing its columns in order, then a fixed butterfly.
//  - bf16 at D, Dv <= 128 (past 64) and at D <= 192, Dv <= 128: the wgmma
//    kernels (fa_bwd_dq_bf16_sm90_kernel, fa_bwd_dkdv_bf16_sm90_kernel), on
//    the forward kernel's machinery (sm90.cuh): a producer warpgroup feeding
//    a TMA ring of 3 stages (2 in the 192-wide dQ kernel, which also holds
//    O) with mbarriers (setmaxnreg 24), two consumer
//    warpgroups of 64 rows (setmaxnreg 240), every product a wgmma on
//    128-byte-swizzled tiles.  Narrower widths arrive zero-filled by TMA and
//    their stores are masked.  In each step the two recomputed products
//    are two commit groups: P is formed (one FFMA and ex2.approx.ftz a
//    score) while the second runs, and the products that take P and dS as
//    their A operand are m64n128 where the width allows; the dK / dV kernel
//    issues dV's product before dS is formed.  (Orderings that carried the
//    products that take P and dS into the next step, or had the two
//    warpgroups take turns, ran no faster; some made ptxas serialize the
//    wgmmas, C7515.)
//    - dK / dV: K and V of a 128-row kv tile stay in shared memory; the block
//      walks the q tiles of a run of the kv head's q heads (64-row steps, 32
//      at 192 / 128, where fp32 dK and dV take 160 registers a thread), so
//      grouped heads sum in registers and not through per-head partials: a
//      kv head's g q heads split into ``splits`` runs, a block each (the
//      plan, kernels/flash_attention.py::bwd_plan, is a function of the head
//      counts and Sk alone, never of B), and only with splits > 1 does a run
//      write an fp32 partial, summed in run order by fa_bwd_sum_heads_kernel.
//    - dQ: the forward's shape, a 128-row q tile resident (at 128 wide its Q
//      and dO as register A fragments), K and V tiles of 64 rows streamed.
//  - bf16 at the other widths (64, 256 or D > 192 or Dv > 128), the
//    mma.sync.m16n8k16 kernels, chosen by width alone:
//    - dK / dV: one block per (q head, batch row, 64-row kv tile), heavy
//      causal tiles first.  K and V stay in shared memory; the block walks the
//      q tiles that see its kv tile, Q and dO double-buffered with cp.async.
//      Each warp owns 16 kv rows: S^T = K Q^T and dP^T = V dO^T in fp32
//      accumulators, P = exp(S - lse) masked, dS = P (dP - delta) (1 -
//      tanh^2) scale; then dV += P^T dO and dK += dS^T Q, with P and dS
//      rounded to bf16 for those products (as the forward rounds P for P V)
//      and the sums in fp32 registers, written once at the end.  At a
//      256-wide instance two warps share the 16 rows, each holding half of
//      dK's and dV's columns.  Under grouped-query heads each q head's block
//      writes its fp32 partial dK and dV, and fa_bwd_sum_heads_kernel sums
//      the g partials of a kv head in head order.
//    - dQ: one block per (q head, batch row, 64-row q tile), heavy causal
//      tiles first; Q and dO stay in shared memory, K and V tiles
//      double-buffered; each warp owns 16 q rows and accumulates dQ += dS K.
//    - Each has an instance at exactly its widths (64, 256), without width
//      guards; operands from padded shared memory by ldmatrix (transposed
//      where the product wants the stored rows as its k), the A operand of
//      P^T dO and dS^T Q (and dS K) straight from the accumulators.
//  - fp32: the same three kernels' shape in SIMT form on 32-row tiles, 256
//    threads, every product one fmaf a term in a fixed order (no TF32): a
//    thread forms 4 scores and 4 dP terms of the tile, then 8 threads a row
//    own strided columns of the row's dK and dV (or dQ).
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using kernels::NEG_INF;
using kernels::to_float;
using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BKV = 64;   // kv rows of a bf16 dK / dV block: 4 row warps of 16
constexpr int BQR = 64;   // q rows of a bf16 dQ block: 4 warps of 16
constexpr int FR = 32;    // fp32: rows of a block's own tile and of each step's tile
constexpr int FT = 256;   // fp32: threads a block (32 rows x 8 column lanes)

// --------------------------------------------------------------- PTX helpers
// 16 bytes global -> shared; ``bytes`` 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// D += A B, m16n8k16, bf16 in, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment (16 rows x 16 k) of k step ``kq`` from accumulators whose
// columns are that k: n blocks 2 kq and 2 kq + 1, rounded to bf16.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c)[N][4], int kq) {
  a[0] = pack_bf16(c[2 * kq][0], c[2 * kq][1]);
  a[1] = pack_bf16(c[2 * kq][2], c[2 * kq][3]);
  a[2] = pack_bf16(c[2 * kq + 1][0], c[2 * kq + 1][1]);
  a[3] = pack_bf16(c[2 * kq + 1][2], c[2 * kq + 1][3]);
}

// Rows [s0, s0 + rows) of one head of a (B, S, heads, dim) bf16 tensor (``src``
// at row 0 of that head, rows ``stride`` elements apart) into a shared tile of
// row stride ``ld`` elements, 16 bytes a copy; rows past S are zero-filled.
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* src, long long stride, int s0,
                                          int rows, int S, int dim, int ld, int tid, int nt) {
  const int pieces = dim >> 3;
  for (int i = tid; i < rows * pieces; i += nt) {
    const int r = i / pieces, c = (i - r * pieces) << 3;
    const bool ok = s0 + r < S;
    cp_async16(dst + 2u * static_cast<uint32_t>(r * ld + c), ok ? src + (s0 + r) * stride + c : src,
               ok ? 16 : 0);
  }
}

// The same in fp32, element by element, into a tile of odd row stride ``ld``.
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, long long stride,
                                              int s0, int rows, int S, int dim, int ld, int tid) {
  for (int i = tid; i < rows * dim; i += FT) {
    const int r = i / dim, c = i - r * dim;
    dst[r * ld + c] = s0 + r < S ? src[(s0 + r) * stride + c] : 0.f;
  }
}

// Whether key kp is visible to query qp.
__device__ __forceinline__ bool visible(int qp, int kp, int Sq, int Sk, int causal, int window) {
  return qp < Sq && kp < Sk && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// Whether every key of [k0, k0 + nk) is visible to every query of [q0, q0 + nq).
__device__ __forceinline__ bool inside(int q0, int nq, int k0, int nk, int Sq, int Sk, int causal,
                                       int window) {
  return q0 + nq <= Sq && k0 + nk <= Sk && (!causal || k0 + nk - 1 <= q0) &&
         (window <= 0 || k0 > q0 + nq - 1 - window);
}

// P and dS of one score: s the raw product q.k, dp the raw dO.v.  Returns P;
// ``ds`` gets P (dP - delta) (1 - tanh^2) scale.  ``lse`` is the row's lse
// times log2 e where EXP2 (the bf16 kernels' exp2), the lse itself otherwise
// (fp32's exp), and +inf on dead rows.
template <bool EXP2>
__device__ __forceinline__ float p_and_ds(float s, float dp, float lse, float delta, float scale,
                                          float softcap, bool ok, float& ds) {
  float x = s * scale, fac = scale;
  if (softcap > 0.f) {
    const float t = tanhf(x / softcap);
    x = softcap * t;
    fac = scale * (1.f - t * t);
  }
  const float p = ok ? (EXP2 ? exp2f(x * LOG2E - lse) : expf(x - lse)) : 0.f;
  ds = p * (dp - delta) * fac;
  return p;
}

// 2^x by the SFU alone (ex2.approx.ftz: results below 2^-126 flush to 0).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// P of one raw score s = q.k for the wgmma kernels (``lse2`` the row's lse
// times log2 e, +inf on dead rows; ``scale2`` the scale times log2 e) and,
// in ``pf``, P times the derivative of the scaled and capped score, so that
// dS = pf (dP - delta): P is formed before dP has arrived.
__device__ __forceinline__ float p_and_factor(float s, float lse2, float scale, float scale2,
                                              float softcap, bool ok, float& pf) {
  float p, fac = scale;
  if (softcap > 0.f) {
    const float t = tanhf(s * scale / softcap);
    fac = scale * (1.f - t * t);
    p = exp2_ftz(softcap * t * LOG2E - lse2);
  } else {
    p = exp2_ftz(fmaf(s, scale2, -lse2));
  }
  p = ok ? p : 0.f;
  pf = p * fac;
  return p;
}

// ------------------------------------------------------------ delta pre-pass
template <typename T>
__global__ void __launch_bounds__(256) fa_bwd_delta_kernel(const T* __restrict__ out,
                                                           const T* __restrict__ dout,
                                                           float* __restrict__ delta,
                                                           long long rows, int Sq, int H, int Dv) {
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // a whole warp at once
  const T* o = out + row * Dv;
  const T* d = dout + row * Dv;
  float s = 0.f;
  for (int c = lane; c < Dv; c += 32) s = fmaf(to_float(o[c]), to_float(d[c]), s);
  s = kernels::warp_sum(s);
  if (lane == 0) {  // row = (b Sq + q) H + h  ->  delta[(b H + h) Sq + q]
    const int h = static_cast<int>(row % H);
    const long long bq = row / H;
    delta[(bq / Sq * H + h) * Sq + bq % Sq] = s;
  }
}

// --------------------------------------------------------- bf16, tensor cores
// DK, DV: the instance's q/k and v widths (D <= DK, Dv <= DV).
template <int DK, int DV>
struct Cfg {
  static constexpr int NCOL = DK + DV > 384 ? 2 : 1;  // column warps of a dK / dV block
  static constexpr int NT_KV = 128 * NCOL;
  static constexpr int BQ = DK + DV <= 128 ? 64 : 32;  // q rows a step of the dK / dV block
  static constexpr int BK = DK <= 128 ? 64 : 32;       // kv rows a step of the dQ block
  static constexpr int LDK = DK + 8, LDV = DV + 8;     // padded row strides (elements)
  static constexpr int KW = DK / NCOL, VW = DV / NCOL; // dK, dV columns a column warp
  // K, V; Q and dO in two stages; lse and delta in two stages
  static constexpr int SMEM_KV = 2 * (BKV * LDK + BKV * LDV + 2 * BQ * LDK + 2 * BQ * LDV) +
                                 4 * 2 * 2 * BQ;
  // Q, dO; K and V in two stages
  static constexpr int SMEM_Q = 2 * (BQR * LDK + BQR * LDV + 2 * BK * LDK + 2 * BK * LDV);
};

template <int DK, int DV, bool EXACT>
__global__ void __launch_bounds__(Cfg<DK, DV>::NT_KV) fa_bwd_dkdv_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ part_k, float* __restrict__ part_v,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int H, int Hkv, int D, int Dv,
    float scale, int causal, int window, float softcap) {
  using C = Cfg<DK, DV>;
  constexpr int BQ = C::BQ, NT = C::NT_KV;
  constexpr int NQB = BQ / 8, NKB = C::KW / 8, NVB = C::VW / 8;
  if (EXACT) {   // the widths are the instance's: every width guard below folds away
    D = DK;
    Dv = DV;
  }
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sK = smem_u32(smem);
  const uint32_t sV = sK + 2 * BKV * C::LDK;
  const uint32_t sQ = sV + 2 * BKV * C::LDV;        // [2][BQ][LDK]
  const uint32_t sO = sQ + 2 * 2 * BQ * C::LDK;     // [2][BQ][LDV]
  float* sL = reinterpret_cast<float*>(smem + 2 * (BKV * C::LDK + BKV * C::LDV +
                                                   2 * BQ * C::LDK + 2 * BQ * C::LDV));
  float* sD = sL + 2 * BQ;

  const int h = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * BKV;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, l = tid & 31, warp = tid >> 5;
  const int kr = 16 * (warp & 3);                   // this warp's first row in the kv tile
  const int kc0 = (warp >> 2) * C::KW, vc0 = (warp >> 2) * C::VW;  // its column slices
  const int nq = (Sq + BQ - 1) / BQ;
  int qlo = 0, qhi = nq;                            // q tiles that see this kv tile
  if (causal) qlo = min(nq, k0 / BQ);
  if (window > 0) qhi = min(nq, (k0 + BKV - 2 + window) / BQ + 1);
  const int n = max(qhi - qlo, 0);
  const long long head = static_cast<long long>(b) * Sq * H + h;

  auto load_step = [&](int it, int st) {
    const int q0 = (qlo + it) * BQ;
    load_rows(sQ + 2u * st * BQ * C::LDK, q + head * D, static_cast<long long>(H) * D, q0, BQ,
              Sq, D, C::LDK, tid, NT);
    load_rows(sO + 2u * st * BQ * C::LDV, dout + head * Dv, static_cast<long long>(H) * Dv, q0,
              BQ, Sq, Dv, C::LDV, tid, NT);
    const long long at = (static_cast<long long>(b) * H + h) * Sq;
    for (int i = tid; i < BQ; i += NT) {
      const int qp = q0 + i;
      const float ls = qp < Sq ? lse[at + qp] : NEG_INF;
      sL[st * BQ + i] = ls > NEG_INF / 2 ? ls * LOG2E : INFINITY;
      sD[st * BQ + i] = qp < Sq ? delta[at + qp] : 0.f;
    }
  };

  const long long kvhead = static_cast<long long>(b) * Sk * Hkv + hk;
  load_rows(sK, k + kvhead * D, static_cast<long long>(Hkv) * D, k0, BKV, Sk, D, C::LDK, tid, NT);
  load_rows(sV, v + kvhead * Dv, static_cast<long long>(Hkv) * Dv, k0, BKV, Sk, Dv, C::LDV, tid,
            NT);
  if (n > 0) load_step(0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  float acc_k[NKB][4], acc_v[NVB][4];
#pragma unroll
  for (int j = 0; j < NKB; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_k[j][i] = 0.f;
#pragma unroll
  for (int j = 0; j < NVB; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_v[j][i] = 0.f;

  for (int it = 0; it < n; ++it) {
    const int st = it & 1;
    if (it + 1 < n) {
      load_step(it + 1, st ^ 1);
      cp_async_commit();
    }
    const int q0 = (qlo + it) * BQ;
    const uint32_t cQ = sQ + 2u * st * BQ * C::LDK, cO = sO + 2u * st * BQ * C::LDV;
    const float* cL = sL + st * BQ;
    const float* cD = sD + st * BQ;

    // S^T = K Q^T over D and dP^T = V dO^T over Dv: 16 kv rows x BQ q columns
    float s[NQB][4], dp[NQB][4];
#pragma unroll
    for (int j = 0; j < NQB; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      if (kk * 16 < D) {
        uint32_t a[4];
        ldsm_x4(a, sK + 2u * ((kr + (l & 15)) * C::LDK + kk * 16 + (l >> 4) * 8));
#pragma unroll
        for (int np = 0; np < NQB / 2; ++np) {
          uint32_t bb[4];
          ldsm_x4(bb, cQ + 2u * ((np * 16 + (l & 7) + (l >> 4) * 8) * C::LDK + kk * 16 +
                                 ((l >> 3) & 1) * 8));
          mma_bf16(s[2 * np], a, bb[0], bb[1]);
          mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) {
      if (kk * 16 < Dv) {
        uint32_t a[4];
        ldsm_x4(a, sV + 2u * ((kr + (l & 15)) * C::LDV + kk * 16 + (l >> 4) * 8));
#pragma unroll
        for (int np = 0; np < NQB / 2; ++np) {
          uint32_t bb[4];
          ldsm_x4(bb, cO + 2u * ((np * 16 + (l & 7) + (l >> 4) * 8) * C::LDV + kk * 16 +
                                 ((l >> 3) & 1) * 8));
          mma_bf16(dp[2 * np], a, bb[0], bb[1]);
          mma_bf16(dp[2 * np + 1], a, bb[2], bb[3]);
        }
      }
    }
    // P into s, dS into dp; the masks only where the tiles meet an edge
    auto p_ds = [&](auto inner) {
#pragma unroll
      for (int j = 0; j < NQB; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kp = k0 + kr + (l >> 2) + 8 * (i >> 1);
          const int qi = j * 8 + 2 * (l & 3) + (i & 1);
          float ds;
          s[j][i] = p_and_ds<true>(
              s[j][i], dp[j][i], cL[qi], cD[qi], scale, softcap,
              decltype(inner)::value || visible(q0 + qi, kp, Sq, Sk, causal, window), ds);
          dp[j][i] = ds;
        }
    };
    if (inside(q0, BQ, k0, BKV, Sq, Sk, causal, window)) p_ds(std::true_type{});
    else p_ds(std::false_type{});
    // dV += P^T dO and dK += dS^T Q over the step's q rows
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, s, kq);
      acc_to_a(da, dp, kq);
      const int row = kq * 16 + (l & 7) + ((l >> 3) & 1) * 8;
#pragma unroll
      for (int cp = 0; cp < NVB / 2; ++cp) {
        const int c = vc0 + cp * 16;
        if (c < Dv) {
          uint32_t bb[4];
          ldsm_x4_t(bb, cO + 2u * (row * C::LDV + c + (l >> 4) * 8));
          mma_bf16(acc_v[2 * cp], pa, bb[0], bb[1]);
          mma_bf16(acc_v[2 * cp + 1], pa, bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int cp = 0; cp < NKB / 2; ++cp) {
        const int c = kc0 + cp * 16;
        if (c < D) {
          uint32_t bb[4];
          ldsm_x4_t(bb, cQ + 2u * (row * C::LDK + c + (l >> 4) * 8));
          mma_bf16(acc_k[2 * cp], da, bb[0], bb[1]);
          mma_bf16(acc_k[2 * cp + 1], da, bb[2], bb[3]);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

  // each of the warp's rows and columns written once: dK and dV in bf16, or
  // under grouped heads this q head's fp32 partials
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int kp = k0 + kr + (l >> 2) + 8 * e;
    if (kp >= Sk) continue;
    const long long row = (static_cast<long long>(b) * Sk + kp) * Hkv + hk;
    const long long prow = (static_cast<long long>(b) * Sk + kp) * H + h;
#pragma unroll
    for (int j = 0; j < NKB; ++j) {
      const int c = kc0 + j * 8 + 2 * (l & 3);
      if (c >= D) continue;
      if (part_k)
        *reinterpret_cast<float2*>(part_k + prow * D + c) =
            make_float2(acc_k[j][2 * e], acc_k[j][2 * e + 1]);
      else
        *reinterpret_cast<uint32_t*>(dk + row * D + c) =
            pack_bf16(acc_k[j][2 * e], acc_k[j][2 * e + 1]);
    }
#pragma unroll
    for (int j = 0; j < NVB; ++j) {
      const int c = vc0 + j * 8 + 2 * (l & 3);
      if (c >= Dv) continue;
      if (part_v)
        *reinterpret_cast<float2*>(part_v + prow * Dv + c) =
            make_float2(acc_v[j][2 * e], acc_v[j][2 * e + 1]);
      else
        *reinterpret_cast<uint32_t*>(dv + row * Dv + c) =
            pack_bf16(acc_v[j][2 * e], acc_v[j][2 * e + 1]);
    }
  }
}

// dK (or dV) of each kv head: the sum of its g q heads' fp32 partials, in
// head order, four columns a thread.  part (B, Sk, H, dim), out (B, Sk, Hkv,
// dim): out row r is the sum of part rows r g .. r g + g - 1.
template <typename T>
__global__ void __launch_bounds__(256) fa_bwd_sum_heads_kernel(const float* __restrict__ part,
                                                               T* __restrict__ out,
                                                               long long rows, int g, int dim) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int quads = dim >> 2;
  if (i >= rows * quads) return;
  const long long r = i / quads;
  const int c = static_cast<int>(i - r * quads) << 2;
  const float* p = part + r * g * dim + c;
  float4 s = *reinterpret_cast<const float4*>(p);
  for (int j = 1; j < g; ++j) {
    const float4 x = *reinterpret_cast<const float4*>(p + j * dim);
    s.x += x.x;
    s.y += x.y;
    s.z += x.z;
    s.w += x.w;
  }
  T* o = out + r * dim + c;
  o[0] = kernels::from_float<T>(s.x);
  o[1] = kernels::from_float<T>(s.y);
  o[2] = kernels::from_float<T>(s.z);
  o[3] = kernels::from_float<T>(s.w);
}

template <int DK, int DV, bool EXACT>
__global__ void __launch_bounds__(128) fa_bwd_dq_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int Sq, int Sk, int H, int Hkv,
    int D, int Dv, float scale, int causal, int window, float softcap) {
  using C = Cfg<DK, DV>;
  constexpr int BK = C::BK, NKB = BK / 8, NDB = DK / 8;
  if (EXACT) {   // the widths are the instance's: every width guard below folds away
    D = DK;
    Dv = DV;
  }
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sO = sQ + 2 * BQR * C::LDK;
  const uint32_t sK = sO + 2 * BQR * C::LDV;   // [2][BK][LDK]
  const uint32_t sV = sK + 2 * 2 * BK * C::LDK; // [2][BK][LDV]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQR;  // heavy causal tiles first
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, l = tid & 31, qr = 16 * (tid >> 5);
  const int nk = (Sk + BK - 1) / BK;
  int lo = 0, hi = nk;                          // kv tiles this q tile sees
  if (causal) hi = min(nk, (q0 + BQR - 1) / BK + 1);
  if (window > 0) lo = max(0, (q0 - window + 1) / BK);
  const int n = max(hi - lo, 0);

  const long long head = static_cast<long long>(b) * Sq * H + h;
  const long long kvhead = static_cast<long long>(b) * Sk * Hkv + hk;
  auto load_step = [&](int kt, int st) {
    load_rows(sK + 2u * st * BK * C::LDK, k + kvhead * D, static_cast<long long>(Hkv) * D,
              kt * BK, BK, Sk, D, C::LDK, tid, 128);
    load_rows(sV + 2u * st * BK * C::LDV, v + kvhead * Dv, static_cast<long long>(Hkv) * Dv,
              kt * BK, BK, Sk, Dv, C::LDV, tid, 128);
  };
  load_rows(sQ, q + head * D, static_cast<long long>(H) * D, q0, BQR, Sq, D, C::LDK, tid, 128);
  load_rows(sO, dout + head * Dv, static_cast<long long>(H) * Dv, q0, BQR, Sq, Dv, C::LDV, tid,
            128);
  if (n > 0) load_step(lo, 0);
  cp_async_commit();

  float lse2[2], del[2];  // this thread's two rows
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qp = q0 + qr + (l >> 2) + 8 * e;
    const long long at = (static_cast<long long>(b) * H + h) * Sq + qp;
    const float ls = qp < Sq ? lse[at] : NEG_INF;
    lse2[e] = ls > NEG_INF / 2 ? ls * LOG2E : INFINITY;
    del[e] = qp < Sq ? delta[at] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

  float acc[NDB][4];
#pragma unroll
  for (int j = 0; j < NDB; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  for (int it = 0; it < n; ++it) {
    const int st = it & 1, k0 = (lo + it) * BK;
    if (it + 1 < n) {
      load_step(lo + it + 1, st ^ 1);
      cp_async_commit();
    }
    const uint32_t cK = sK + 2u * st * BK * C::LDK, cV = sV + 2u * st * BK * C::LDV;

    // S = Q K^T over D and dP = dO V^T over Dv: 16 q rows x BK kv columns
    float s[NKB][4], dp[NKB][4];
#pragma unroll
    for (int j = 0; j < NKB; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      if (kk * 16 < D) {
        uint32_t a[4];
        ldsm_x4(a, sQ + 2u * ((qr + (l & 15)) * C::LDK + kk * 16 + (l >> 4) * 8));
#pragma unroll
        for (int np = 0; np < NKB / 2; ++np) {
          uint32_t bb[4];
          ldsm_x4(bb, cK + 2u * ((np * 16 + (l & 7) + (l >> 4) * 8) * C::LDK + kk * 16 +
                                 ((l >> 3) & 1) * 8));
          mma_bf16(s[2 * np], a, bb[0], bb[1]);
          mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) {
      if (kk * 16 < Dv) {
        uint32_t a[4];
        ldsm_x4(a, sO + 2u * ((qr + (l & 15)) * C::LDV + kk * 16 + (l >> 4) * 8));
#pragma unroll
        for (int np = 0; np < NKB / 2; ++np) {
          uint32_t bb[4];
          ldsm_x4(bb, cV + 2u * ((np * 16 + (l & 7) + (l >> 4) * 8) * C::LDV + kk * 16 +
                                 ((l >> 3) & 1) * 8));
          mma_bf16(dp[2 * np], a, bb[0], bb[1]);
          mma_bf16(dp[2 * np + 1], a, bb[2], bb[3]);
        }
      }
    }
    // dS into dp; the masks only where the tiles meet an edge
    auto p_ds = [&](auto inner) {
#pragma unroll
      for (int j = 0; j < NKB; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = i >> 1;
          const int qp = q0 + qr + (l >> 2) + 8 * e;
          const int kp = k0 + j * 8 + 2 * (l & 3) + (i & 1);
          float ds;
          p_and_ds<true>(s[j][i], dp[j][i], lse2[e], del[e], scale, softcap,
                         decltype(inner)::value || visible(qp, kp, Sq, Sk, causal, window),
                         ds);
          dp[j][i] = ds;
        }
    };
    if (inside(q0, BQR, k0, BK, Sq, Sk, causal, window)) p_ds(std::true_type{});
    else p_ds(std::false_type{});
    // dQ += dS K over the tile's kv rows
#pragma unroll
    for (int kq = 0; kq < BK / 16; ++kq) {
      uint32_t da[4];
      acc_to_a(da, dp, kq);
      const int row = kq * 16 + (l & 7) + ((l >> 3) & 1) * 8;
#pragma unroll
      for (int cp = 0; cp < NDB / 2; ++cp) {
        const int c = cp * 16;
        if (c < D) {
          uint32_t bb[4];
          ldsm_x4_t(bb, cK + 2u * (row * C::LDK + c + (l >> 4) * 8));
          mma_bf16(acc[2 * cp], da, bb[0], bb[1]);
          mma_bf16(acc[2 * cp + 1], da, bb[2], bb[3]);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qp = q0 + qr + (l >> 2) + 8 * e;
    if (qp >= Sq) continue;
    const long long row = (static_cast<long long>(b) * Sq + qp) * H + h;
#pragma unroll
    for (int j = 0; j < NDB; ++j) {
      const int c = j * 8 + 2 * (l & 3);
      if (c < D)
        *reinterpret_cast<uint32_t*>(dq + row * D + c) =
            pack_bf16(acc[j][2 * e], acc[j][2 * e + 1]);
    }
  }
}

// ----------------------------------------------- bf16, wgmma + TMA (sm_90a)
// The instances at the main paths' widths: <128, 128> (any D, Dv <= 128 past
// 64, zero-filled by TMA past D / Dv) and <192, 128> (D <= 192, Dv <= 128).
constexpr int W_NCONS = 256;              // two consumer warpgroups
constexpr int W_NT = W_NCONS + 128;       // and one producer warpgroup
constexpr int W_PRODUCER_REGS = 24;       // setmaxnreg: 128 x 24 + 256 x 240 = 64,512
constexpr int W_CONSUMER_REGS = 240;
constexpr int W_BKV = 128;                // kv rows of a dK / dV block, 64 a warpgroup
constexpr int W_BQ = 128;                 // q rows of a dQ block, 64 a warpgroup
template <int DK, int DV>
struct WCfg {
  static constexpr int PK = DK / PANEL_COLS, PV = DV / PANEL_COLS;  // 64-column panels
  static constexpr int BQ = DK + DV <= 256 ? 64 : 32;  // q rows a step of the dK / dV block
  static constexpr int BK = 64;                         // kv rows a step of the dQ block
  // the dQ block's Q and dO as A fragments in registers (S and dP read only
  // K and V from shared memory); at 192 / 128 the registers are dQ's
  static constexpr bool QO_REGS = DK <= 128;
  static constexpr int KV_STAGES = 3, Q_STAGES = DK <= 128 ? 3 : 2;    // ring depths
  static constexpr int BAR_BYTES = 8 * (1 + 2 * (KV_STAGES > Q_STAGES ? KV_STAGES : Q_STAGES));
  // dK / dV block: K and V resident; Q, dO, lse and delta of a step in the ring
  static constexpr int K_BYTES = W_BKV * DK * 2, V_BYTES = W_BKV * DV * 2;
  static constexpr int QT_BYTES = BQ * DK * 2, OT_BYTES = BQ * DV * 2;
  static constexpr int KV_STAGE = QT_BYTES + OT_BYTES;  // TMA bytes a step
  static constexpr int SMEM_KV =
      1024 + K_BYTES + V_BYTES + KV_STAGES * KV_STAGE + KV_STAGES * 2 * BQ * 4 + BAR_BYTES;
  // dQ block: Q, dO and O resident; K and V of a step in the ring
  static constexpr int Q_BYTES = W_BQ * DK * 2, O_BYTES = W_BQ * DV * 2;
  static constexpr int KT_BYTES = BK * DK * 2, VT_BYTES = BK * DV * 2;
  static constexpr int Q_STAGE = KT_BYTES + VT_BYTES;
  static constexpr int SMEM_Q = 1024 + Q_BYTES + 2 * O_BYTES + Q_STAGES * Q_STAGE + BAR_BYTES;
};

// One block per (kv head and run of its group's q heads, batch row, 128-row
// kv tile), heavy causal tiles first: ``splits`` runs of g / splits q heads
// each.  The producer's first thread loads K and V once and streams each
// step's Q and dO tiles (the run's heads in order, each head's q tiles in
// order) by TMA; its second warp
// writes the step's lse (times log2 e; +inf on dead and padded rows) and
// delta into the stage.  Each consumer warpgroup owns 64 kv rows: S^T = K
// Q^T and dP^T = V dO^T (SS), P and dS in the fp32 accumulators, then dV +=
// P^T dO and dK += dS^T Q (RS: P and dS rounded to bf16 as the A operand,
// dO and Q N-major).  dK and dV stay in fp32 registers over the whole walk
// and are written once: in bf16, or with splits > 1 as the run's fp32
// partial (B, Sk, Hkv, splits, dim), which fa_bwd_sum_heads_kernel sums in
// run order.
template <int DK, int DV>
__global__ void __launch_bounds__(W_NT, 1) fa_bwd_dkdv_bf16_sm90_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ part_k,
    float* __restrict__ part_v, bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk,
    int H, int Hkv, int D, int Dv, int splits, float scale, int causal, int window,
    float softcap) {
  using C = WCfg<DK, DV>;
  constexpr int BQ = C::BQ, ST = C::KV_STAGES;
  constexpr int NS = BQ / 2;   // S^T and dP^T registers a thread
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u;   // [PK][W_BKV][64], swizzled
  const uint32_t sV = sK + C::K_BYTES;           // [PV][W_BKV][64]
  const uint32_t sRing = sV + C::V_BYTES;        // a stage: Q [PK][BQ][64], dO [PV][BQ][64]
  const uint32_t sLD = sRing + ST * C::KV_STAGE;  // a stage: lse log2 e [BQ], delta [BQ]
  const uint32_t bar_kv = sLD + ST * 2 * BQ * 4;
  auto bar_full = [&](int s) { return bar_kv + 8u * (1 + s); };
  auto bar_empty = [&](int s) { return bar_kv + 8u * (1 + ST + s); };
  float* const fLD = reinterpret_cast<float*>(smem_raw + (sLD - raw));

  const int g = H / Hkv, per = g / splits;
  const int hk = blockIdx.x / splits, run = blockIdx.x % splits, h0 = hk * g + run * per;
  const int b = blockIdx.y, k0 = blockIdx.z * W_BKV;
  const int nq = (Sq + BQ - 1) / BQ;
  int qlo = 0, qhi = nq;   // q tiles that see this kv tile
  if (causal) qlo = min(nq, k0 / BQ);
  if (window > 0) qhi = min(nq, (k0 + W_BKV - 2 + window) / BQ + 1);
  const int nqt = max(qhi - qlo, 0);
  const int n = per * nqt;
  // step i: the run's head i / nqt, its q tile qlo + i % nqt
  auto head_of = [&](int i) { return h0 + i / nqt; };
  auto q0_of = [&](int i) { return (qlo + i % nqt) * BQ; };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_full(s), 1 + 32);   // the TMA thread and the lse / delta warp
      mbar_init(bar_empty(s), W_NCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= W_NCONS / 32) {  // ------------------------- producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(W_PRODUCER_REGS));
    if (threadIdx.x == W_NCONS) {
      mbar_expect_tx(bar_kv, C::K_BYTES + C::V_BYTES);
      for (int p = 0; p < C::PK; ++p)
        tma_load_4d(sK + p * W_BKV * 128, &tm_k, bar_kv, p * PANEL_COLS, hk, k0, b);
      for (int p = 0; p < C::PV; ++p)
        tma_load_4d(sV + p * W_BKV * 128, &tm_v, bar_kv, p * PANEL_COLS, hk, k0, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % ST, h = head_of(i), q0 = q0_of(i);
        if (i >= ST) mbar_wait(bar_empty(s), (i / ST - 1) & 1);
        const uint32_t sQ = sRing + s * C::KV_STAGE, sO = sQ + C::QT_BYTES;
        mbar_expect_tx(bar_full(s), C::KV_STAGE);
        for (int p = 0; p < C::PK; ++p)
          tma_load_4d(sQ + p * BQ * 128, &tm_q, bar_full(s), p * PANEL_COLS, h, q0, b);
        for (int p = 0; p < C::PV; ++p)
          tma_load_4d(sO + p * BQ * 128, &tm_do, bar_full(s), p * PANEL_COLS, h, q0, b);
      }
    } else if (warp == W_NCONS / 32 + 1) {
      for (int i = 0; i < n; ++i) {
        const int s = i % ST, h = head_of(i), q0 = q0_of(i);
        if (i >= ST) mbar_wait(bar_empty(s), (i / ST - 1) & 1);
        const long long at = (static_cast<long long>(b) * H + h) * Sq;
        float* L = fLD + s * 2 * BQ;
        for (int r = lane; r < BQ; r += 32) {
          const int qp = q0 + r;
          const float ls = qp < Sq ? lse[at + qp] : NEG_INF;
          L[r] = ls > NEG_INF / 2 ? ls * LOG2E : INFINITY;
          L[BQ + r] = qp < Sq ? delta[at + qp] : 0.f;
        }
        mbar_arrive(bar_full(s));
      }
    }
    return;
  }

  // ------------------------------------------------------ consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(W_CONSUMER_REGS));
  const int wg = warp / 4, t = threadIdx.x % 128;
  const int kw = k0 + 64 * wg;                     // this warpgroup's first kv row
  const int r0 = kw + 16 * (t / 32) + lane / 4;    // this thread's kv rows: r0 and r0 + 8
  const int c0 = 2 * (lane % 4);                   // its first column in each 8-column block
  const float scale2 = scale * LOG2E;

  float ak[32 * C::PK], av[32 * C::PV];   // panel p's accumulator j at 32 p + j
#pragma unroll
  for (int i = 0; i < 32 * C::PK; ++i) ak[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32 * C::PV; ++i) av[i] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % ST, q0 = q0_of(i);
    const uint32_t sQ = sRing + s * C::KV_STAGE, sO = sQ + C::QT_BYTES;
    mbar_wait(bar_full(s), (i / ST) & 1);
    if (kw >= Sk || (causal && q0 + BQ - 1 < kw) || (window > 0 && q0 >= kw + 63 + window)) {
      mbar_arrive(bar_empty(s));   // no visible pair in this warpgroup's rows
      continue;
    }
    // S^T = K Q^T over DK / 16 steps of k16, then dP^T = V dO^T over DV / 16,
    // two groups
    float st[NS], dpt[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) st[j] = dpt[j] = 0.f;
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss<BQ>(st, smem_desc(sK + (kk / 4) * W_BKV * 128 + wg * 64 * 128 + off, 16, 1024),
                   smem_desc(sQ + (kk / 4) * BQ * 128 + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss<BQ>(dpt, smem_desc(sV + (kk / 4) * W_BKV * 128 + wg * 64 * 128 + off, 16, 1024),
                   smem_desc(sO + (kk / 4) * BQ * 128 + off, 16, 1024), kk > 0);
    }
    wgmma_commit();

    // P^T from S^T while dP^T runs: element j is kv row r0 + 8 ((j >> 1) &
    // 1), q column q0 + 8 (j / 4) + c0 + (j & 1); P rounded to bf16 as the A
    // fragments of dV's product, P times the softmax's scale factor (and the
    // softcap's derivative) kept in st for dS
    wgmma_wait<1>();
    fence_regs(st);
    const float* L = fLD + s * 2 * BQ;
    uint32_t pa[NS / 2], da[NS / 2];
    auto form_p = [&](auto edge) {   // the masks only where the tile meets an edge
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        const int qi = 8 * (j / 4) + c0, kp = r0 + 8 * ((j >> 1) & 1);
        const float2 l2 = *reinterpret_cast<const float2*>(L + qi);
        float f0, f1;
        const float p0 = p_and_factor(
            st[j], l2.x, scale, scale2, softcap,
            !decltype(edge)::value || visible(q0 + qi, kp, Sq, Sk, causal, window), f0);
        const float p1 = p_and_factor(
            st[j + 1], l2.y, scale, scale2, softcap,
            !decltype(edge)::value || visible(q0 + qi + 1, kp, Sq, Sk, causal, window), f1);
        pa[j / 2] = pack_bf16(p0, p1);
        st[j] = f0;
        st[j + 1] = f1;
      }
    };
    if (inside(q0, BQ, kw, 64, Sq, Sk, causal, window)) form_p(std::false_type{});
    else form_p(std::true_type{});

    // dV += P^T dO over the step's BQ q rows while dS^T is formed
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
      wgmma_rs_wide<C::PV>(av, a, sO + kk * 16 * 128, BQ * 128);
    }
    wgmma_commit();
    wgmma_wait<1>();   // dP^T is in
    fence_regs(dpt);
#pragma unroll
    for (int j = 0; j < NS; j += 2) {
      const float2 dl = *reinterpret_cast<const float2*>(L + BQ + 8 * (j / 4) + c0);
      da[j / 2] = pack_bf16(st[j] * (dpt[j] - dl.x), st[j + 1] * (dpt[j + 1] - dl.y));
    }

    // dK += dS^T Q over the step's BQ q rows
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint32_t d[4] = {da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3]};
      wgmma_rs_wide<C::PK>(ak, d, sQ + kk * 16 * 128, BQ * 128);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(pa);
    fence_regs(da);
    fence_regs(av);
    fence_regs(ak);
    mbar_arrive(bar_empty(s));
  }

  // each of the thread's rows and columns written once
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int kp = r0 + 8 * e;
    if (kp >= Sk) continue;
    const long long row = (static_cast<long long>(b) * Sk + kp) * Hkv + hk;
    const long long prow = row * splits + run;
#pragma unroll
    for (int p = 0; p < C::PK; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = p * PANEL_COLS + 8 * j + c0;
        if (c >= D) continue;
        if (splits > 1)
          *reinterpret_cast<float2*>(part_k + prow * D + c) =
              make_float2(ak[32 * p + 4 * j + 2 * e], ak[32 * p + 4 * j + 2 * e + 1]);
        else
          *reinterpret_cast<uint32_t*>(dk + row * D + c) =
              pack_bf16(ak[32 * p + 4 * j + 2 * e], ak[32 * p + 4 * j + 2 * e + 1]);
      }
#pragma unroll
    for (int p = 0; p < C::PV; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = p * PANEL_COLS + 8 * j + c0;
        if (c >= Dv) continue;
        if (splits > 1)
          *reinterpret_cast<float2*>(part_v + prow * Dv + c) =
              make_float2(av[32 * p + 4 * j + 2 * e], av[32 * p + 4 * j + 2 * e + 1]);
        else
          *reinterpret_cast<uint32_t*>(dv + row * Dv + c) =
              pack_bf16(av[32 * p + 4 * j + 2 * e], av[32 * p + 4 * j + 2 * e + 1]);
      }
  }
}

// One block per (q head, batch row, 128-row q tile), heavy causal tiles
// first: the forward kernel's shape plus one product.  The producer's first
// thread loads Q, dO and O once and streams K and V tiles of BK rows by TMA;
// each consumer warpgroup owns 64 q rows: it forms their delta (written for
// the dK / dV kernel) and keeps their lse and delta in registers, then S = Q
// K^T and dP = dO V^T (at 128 wide RS, Q and dO as register A fragments;
// SS at 192), dS in the fp32 accumulators, dQ += dS K (RS: dS rounded to
// bf16, K N-major), dQ in fp32 registers until one bf16 store.
template <int DK, int DV>
__global__ void __launch_bounds__(W_NT, 1) fa_bwd_dq_bf16_sm90_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_out, const float* __restrict__ lse,
    float* __restrict__ delta, bf16* __restrict__ dq,
    int Sq, int Sk, int H, int Hkv, int D, float scale, int causal, int window,
    float softcap) {
  using C = WCfg<DK, DV>;
  constexpr int BK = C::BK, ST = C::Q_STAGES;
  constexpr int NS = BK / 2;   // S and dP registers a thread
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023u) & ~1023u;   // [PK][W_BQ][64], swizzled
  const uint32_t sO = sQ + C::Q_BYTES;           // dO [PV][W_BQ][64]
  const uint32_t sOut = sO + C::O_BYTES;         // O [PV][W_BQ][64], for delta
  const uint32_t sRing = sOut + C::O_BYTES;      // a stage: K [PK][BK][64], V [PV][BK][64]
  const uint32_t bar_q = sRing + ST * C::Q_STAGE;
  auto bar_full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto bar_empty = [&](int s) { return bar_q + 8u * (1 + ST + s); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * W_BQ;  // heavy causal tiles first
  const int hk = h / (H / Hkv);
  const int nk = (Sk + BK - 1) / BK;
  int lo = 0, hi = nk;   // kv tiles this q tile sees
  if (causal) hi = min(nk, (q0 + W_BQ - 1) / BK + 1);
  if (window > 0) lo = max(0, (q0 - window + 1) / BK);
  const int n = max(hi - lo, 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), W_NCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= W_NCONS / 32) {  // ------------------------- producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(W_PRODUCER_REGS));
    if (threadIdx.x == W_NCONS) {
      mbar_expect_tx(bar_q, C::Q_BYTES + 2 * C::O_BYTES);
      for (int p = 0; p < C::PK; ++p)
        tma_load_4d(sQ + p * W_BQ * 128, &tm_q, bar_q, p * PANEL_COLS, h, q0, b);
      for (int p = 0; p < C::PV; ++p) {
        tma_load_4d(sO + p * W_BQ * 128, &tm_do, bar_q, p * PANEL_COLS, h, q0, b);
        tma_load_4d(sOut + p * W_BQ * 128, &tm_out, bar_q, p * PANEL_COLS, h, q0, b);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % ST, kv0 = (lo + i) * BK;
        if (i >= ST) mbar_wait(bar_empty(s), (i / ST - 1) & 1);
        const uint32_t sKt = sRing + s * C::Q_STAGE, sVt = sKt + C::KT_BYTES;
        mbar_expect_tx(bar_full(s), C::Q_STAGE);
        for (int p = 0; p < C::PK; ++p)
          tma_load_4d(sKt + p * BK * 128, &tm_k, bar_full(s), p * PANEL_COLS, hk, kv0, b);
        for (int p = 0; p < C::PV; ++p)
          tma_load_4d(sVt + p * BK * 128, &tm_v, bar_full(s), p * PANEL_COLS, hk, kv0, b);
      }
    }
    return;
  }

  // ------------------------------------------------------ consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(W_CONSUMER_REGS));
  const int wg = warp / 4, t = threadIdx.x % 128;
  const int qw = q0 + 64 * wg;                     // this warpgroup's first q row
  const int r0 = qw + 16 * (t / 32) + lane / 4;    // this thread's q rows: r0 and r0 + 8
  const int c0 = 2 * (lane % 4);
  const float scale2 = scale * LOG2E;
  int lo_w = lo, hi_w = hi;                        // kv tiles this warpgroup needs
  if (causal) hi_w = min(hi, (qw + 63) / BK + 1);
  if (window > 0) lo_w = max(lo, (qw - window + 1) / BK);
  float lse2[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qp = r0 + 8 * e;
    const float ls = qp < Sq ? lse[(static_cast<long long>(b) * H + h) * Sq + qp] : NEG_INF;
    lse2[e] = ls > NEG_INF / 2 ? ls * LOG2E : INFINITY;
  }

  float acc[32 * C::PK];   // panel p's accumulator j at 32 p + j
#pragma unroll
  for (int i = 0; i < 32 * C::PK; ++i) acc[i] = 0.f;

  mbar_wait(bar_q, 0);
  // delta = rowsum(dO * O) of this thread's rows, the quad's four threads
  // each summing every fourth 16-byte piece of the row in order, then a
  // fixed butterfly; written for the dK / dV kernel, which runs after
  const uint8_t* tile_do = smem_raw + (sO - raw);
  const uint8_t* tile_o = smem_raw + (sOut - raw);
  float del[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = 64 * wg + 16 * (t / 32) + lane / 4 + 8 * e, qp = q0 + row;
    float sum = 0.f;
#pragma unroll
    for (int ch = lane % 4; ch < DV / 8; ch += 4) {
      const uint32_t off = (ch / 8) * W_BQ * 128 + row * 128 + (((ch % 8) ^ (row & 7)) << 4);
      const uint4 x = *reinterpret_cast<const uint4*>(tile_do + off);
      const uint4 y = *reinterpret_cast<const uint4*>(tile_o + off);
      const bf16* xv = reinterpret_cast<const bf16*>(&x);
      const bf16* yv = reinterpret_cast<const bf16*>(&y);
#pragma unroll
      for (int i = 0; i < 8; ++i) sum = fmaf(to_float(xv[i]), to_float(yv[i]), sum);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    del[e] = sum;
    if (lane % 4 == 0 && qp < Sq) delta[(static_cast<long long>(b) * H + h) * Sq + qp] = sum;
  }
  // Q and dO of this warpgroup's rows as A fragments, where they are kept in
  // registers (QO_REGS)
  uint32_t qf[C::QO_REGS ? DK / 16 : 1][4], of[C::QO_REGS ? DV / 16 : 1][4];
  if constexpr (C::QO_REGS) {
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) ldsm_a_swizzled(qf[kk], sQ, W_BQ * 128, 64 * wg, kk);
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) ldsm_a_swizzled(of[kk], sO, W_BQ * 128, 64 * wg, kk);
  }
  for (int i = 0; i < n; ++i) {
    const int s = i % ST, kt = lo + i, kv0 = kt * BK;
    const uint32_t sKt = sRing + s * C::Q_STAGE, sVt = sKt + C::KT_BYTES;
    mbar_wait(bar_full(s), (i / ST) & 1);
    if (qw >= Sq || kt < lo_w || kt >= hi_w) {   // no visible pair in this warpgroup's rows
      mbar_arrive(bar_empty(s));
      continue;
    }
    // S = Q K^T over DK / 16 steps of k16, then dP = dO V^T over DV / 16, two
    // groups
    float sc[NS], dp[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) sc[j] = dp[j] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      const uint64_t db = smem_desc(sKt + (kk / 4) * BK * 128 + off, 16, 1024);
      if constexpr (C::QO_REGS) wgmma_rs_n64_kmajor(sc, qf[kk], db);
      else
        wgmma_ss<BK>(sc, smem_desc(sQ + (kk / 4) * W_BQ * 128 + wg * 64 * 128 + off, 16, 1024),
                     db, kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      const uint64_t db = smem_desc(sVt + (kk / 4) * BK * 128 + off, 16, 1024);
      if constexpr (C::QO_REGS) wgmma_rs_n64_kmajor(dp, of[kk], db);
      else
        wgmma_ss<BK>(dp, smem_desc(sO + (kk / 4) * W_BQ * 128 + wg * 64 * 128 + off, 16, 1024),
                     db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();   // S is in

    // P times its factor from S while dP runs: element j is q row r0 + 8
    // ((j >> 1) & 1), kv column kv0 + 8 (j / 4) + c0 + (j & 1)
    fence_regs(sc);
    auto form_p = [&](auto edge) {   // the masks only where the tile meets an edge
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        const int e = (j >> 1) & 1, qp = r0 + 8 * e, kp = kv0 + 8 * (j / 4) + c0;
        p_and_factor(sc[j], lse2[e], scale, scale2, softcap,
                     !decltype(edge)::value || visible(qp, kp, Sq, Sk, causal, window), sc[j]);
        p_and_factor(sc[j + 1], lse2[e], scale, scale2, softcap,
                     !decltype(edge)::value || visible(qp, kp + 1, Sq, Sk, causal, window),
                     sc[j + 1]);
      }
    };
    if (inside(qw, 64, kv0, BK, Sq, Sk, causal, window)) form_p(std::false_type{});
    else form_p(std::true_type{});
    // dS, rounded to bf16 as A fragments
    wgmma_wait<0>();
    fence_regs(dp);
    uint32_t da[NS / 2];
#pragma unroll
    for (int j = 0; j < NS; j += 2) {
      const int e = (j >> 1) & 1;
      da[j / 2] = pack_bf16(sc[j] * (dp[j] - del[e]), sc[j + 1] * (dp[j + 1] - del[e]));
    }

    // dQ += dS K over the tile's BK kv rows
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3]};
      wgmma_rs_wide<C::PK>(acc, a, sKt + kk * 16 * 128, BK * 128);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(da);
    fence_regs(acc);
    mbar_arrive(bar_empty(s));
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qp = r0 + 8 * e;
    if (qp >= Sq) continue;
    const long long row = (static_cast<long long>(b) * Sq + qp) * H + h;
#pragma unroll
    for (int p = 0; p < C::PK; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = p * PANEL_COLS + 8 * j + c0;
        if (c < D)
          *reinterpret_cast<uint32_t*>(dq + row * D + c) =
              pack_bf16(acc[32 * p + 4 * j + 2 * e], acc[32 * p + 4 * j + 2 * e + 1]);
      }
  }
}

// ------------------------------------------------------------ fp32, CUDA cores
// Shared floats of the fp32 kernels: the block's own tile and one step's
// tile of the other side (q/k rows at D + 1, v/dO rows at Dv + 1), and two
// 32 x 33 tiles of P and dS.
int smem_fp32(int D, int Dv) {
  return 4 * (2 * FR * (D + 1) + 2 * FR * (Dv + 1) + 2 * FR * (FR + 1) + 2 * FR);
}

// DP: the instance's widest head dim (D, Dv <= DP); DP / 8 columns a thread.
template <int DP>
__global__ void __launch_bounds__(FT) fa_bwd_dkdv_fp32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ part_k, float* __restrict__ part_v,
    float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int H, int Hkv, int D, int Dv,
    float scale, int causal, int window, float softcap) {
  constexpr int NJ = DP / 8;
  extern __shared__ float fsm[];
  const int ldk = D + 1, ldv = Dv + 1;
  float* sK = fsm;
  float* sV = sK + FR * ldk;
  float* sQ = sV + FR * ldv;
  float* sO = sQ + FR * ldk;
  float* sP = sO + FR * ldv;   // [kv][q], stride FR + 1
  float* sS = sP + FR * (FR + 1);
  float* sL = sS + FR * (FR + 1);
  float* sD = sL + FR;

  const int h = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * FR;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, r = tid >> 3, cg = tid & 7;
  const int nq = (Sq + FR - 1) / FR;
  int qlo = 0, qhi = nq;
  if (causal) qlo = min(nq, k0 / FR);
  if (window > 0) qhi = min(nq, (k0 + FR - 2 + window) / FR + 1);
  const long long head = static_cast<long long>(b) * Sq * H + h;

  const long long kvhead = static_cast<long long>(b) * Sk * Hkv + hk;
  load_rows_f32(sK, k + kvhead * D, static_cast<long long>(Hkv) * D, k0, FR, Sk, D, ldk, tid);
  load_rows_f32(sV, v + kvhead * Dv, static_cast<long long>(Hkv) * Dv, k0, FR, Sk, Dv, ldv, tid);

  float acc_k[NJ], acc_v[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc_k[j] = acc_v[j] = 0.f;

  for (int qt = qlo; qt < qhi; ++qt) {
    const int q0 = qt * FR;
    __syncthreads();  // the last step's reads are done
    load_rows_f32(sQ, q + head * D, static_cast<long long>(H) * D, q0, FR, Sq, D, ldk, tid);
    load_rows_f32(sO, dout + head * Dv, static_cast<long long>(H) * Dv, q0, FR, Sq, Dv, ldv, tid);
    if (tid < FR) {
      const int qp = q0 + tid;
      const long long at = (static_cast<long long>(b) * H + h) * Sq + qp;
      const float ls = qp < Sq ? lse[at] : NEG_INF;
      sL[tid] = ls > NEG_INF / 2 ? ls : INFINITY;
      sD[tid] = qp < Sq ? delta[at] : 0.f;
    }
    __syncthreads();
    // scores and dP of kv row r against q rows cg + 8 i, one FMA a term in order
    float sc[4] = {0.f, 0.f, 0.f, 0.f}, dpv[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < D; ++d) {
      const float kx = sK[r * ldk + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[i] = fmaf(kx, sQ[(cg + 8 * i) * ldk + d], sc[i]);
    }
    for (int c = 0; c < Dv; ++c) {
      const float vx = sV[r * ldv + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) dpv[i] = fmaf(vx, sO[(cg + 8 * i) * ldv + c], dpv[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = cg + 8 * i;
      float ds;
      sP[r * (FR + 1) + qi] = p_and_ds<false>(sc[i], dpv[i], sL[qi], sD[qi], scale, softcap,
                                              visible(q0 + qi, k0 + r, Sq, Sk, causal, window),
                                              ds);
      sS[r * (FR + 1) + qi] = ds;
    }
    __syncthreads();
    // dV[r] += P[r] dO and dK[r] += dS[r] Q over the step's q rows in order
    for (int qi = 0; qi < FR; ++qi) {
      const float p = sP[r * (FR + 1) + qi], ds = sS[r * (FR + 1) + qi];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = cg + 8 * j;
        if (c < Dv) acc_v[j] = fmaf(p, sO[qi * ldv + c], acc_v[j]);
        if (c < D) acc_k[j] = fmaf(ds, sQ[qi * ldk + c], acc_k[j]);
      }
    }
  }

  const int kp = k0 + r;
  if (kp < Sk) {   // dK and dV, or under grouped heads this q head's partials
    const long long row = (static_cast<long long>(b) * Sk + kp) * Hkv + hk;
    const long long prow = (static_cast<long long>(b) * Sk + kp) * H + h;
    float* ok = part_k ? part_k + prow * D : dk + row * D;
    float* ov = part_v ? part_v + prow * Dv : dv + row * Dv;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = cg + 8 * j;
      if (c < D) ok[c] = acc_k[j];
      if (c < Dv) ov[c] = acc_v[j];
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(FT) fa_bwd_dq_fp32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int Sq, int Sk, int H, int Hkv,
    int D, int Dv, float scale, int causal, int window, float softcap) {
  constexpr int NJ = DP / 8;
  extern __shared__ float fsm[];
  const int ldk = D + 1, ldv = Dv + 1;
  float* sQ = fsm;
  float* sO = sQ + FR * ldk;
  float* sK = sO + FR * ldv;
  float* sV = sK + FR * ldk;
  float* sS = sV + FR * ldv;   // [q][kv], stride FR + 1

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * FR;  // heavy causal tiles first
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, r = tid >> 3, cg = tid & 7;
  const int nk = (Sk + FR - 1) / FR;
  int lo = 0, hi = nk;
  if (causal) hi = min(nk, (q0 + FR - 1) / FR + 1);
  if (window > 0) lo = max(0, (q0 - window + 1) / FR);

  const long long head = static_cast<long long>(b) * Sq * H + h;
  const long long kvhead = static_cast<long long>(b) * Sk * Hkv + hk;
  load_rows_f32(sQ, q + head * D, static_cast<long long>(H) * D, q0, FR, Sq, D, ldk, tid);
  load_rows_f32(sO, dout + head * Dv, static_cast<long long>(H) * Dv, q0, FR, Sq, Dv, ldv, tid);
  const int qp = q0 + r;
  const long long at = (static_cast<long long>(b) * H + h) * Sq + qp;
  const float ls = qp < Sq ? lse[at] : NEG_INF;
  const float lse_r = ls > NEG_INF / 2 ? ls : INFINITY, del_r = qp < Sq ? delta[at] : 0.f;

  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * FR;
    __syncthreads();  // the last step's reads are done
    load_rows_f32(sK, k + kvhead * D, static_cast<long long>(Hkv) * D, k0, FR, Sk, D, ldk, tid);
    load_rows_f32(sV, v + kvhead * Dv, static_cast<long long>(Hkv) * Dv, k0, FR, Sk, Dv, ldv,
                  tid);
    __syncthreads();
    float sc[4] = {0.f, 0.f, 0.f, 0.f}, dpv[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < D; ++d) {
      const float qx = sQ[r * ldk + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[i] = fmaf(qx, sK[(cg + 8 * i) * ldk + d], sc[i]);
    }
    for (int c = 0; c < Dv; ++c) {
      const float ox = sO[r * ldv + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) dpv[i] = fmaf(ox, sV[(cg + 8 * i) * ldv + c], dpv[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ki = cg + 8 * i;
      float ds;
      p_and_ds<false>(sc[i], dpv[i], lse_r, del_r, scale, softcap,
                      visible(qp, k0 + ki, Sq, Sk, causal, window), ds);
      sS[r * (FR + 1) + ki] = ds;
    }
    __syncthreads();
    for (int ki = 0; ki < FR; ++ki) {
      const float ds = sS[r * (FR + 1) + ki];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = cg + 8 * j;
        if (c < D) acc[j] = fmaf(ds, sK[ki * ldk + c], acc[j]);
      }
    }
  }

  if (qp < Sq) {
    const long long row = (static_cast<long long>(b) * Sq + qp) * H + h;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = cg + 8 * j;
      if (c < D) dq[row * D + c] = acc[j];
    }
  }
}

// ---------------------------------------------------------------------- host
struct Args {
  const void *q, *k, *v, *out, *dout, *lse;
  void *delta, *part_k, *part_v, *dq, *dk, *dv;
  int B, Sq, Sk, H, Hkv, D, Dv;
  float scale;
  int causal, window;
  float softcap;
  int splits;   // partial slots a kv head (1: none)
  cudaStream_t stream;
};

// The partials' buffer, or none where each kv head has one q head.
float* parts(void* p, const Args& a) { return a.H == a.Hkv ? nullptr : static_cast<float*>(p); }

template <typename T>
cudaError_t launch_delta(const Args& a) {
  const long long rows = static_cast<long long>(a.B) * a.Sq * a.H;
  const long long blocks = (rows * 32 + 255) / 256;
  fa_bwd_delta_kernel<T><<<static_cast<unsigned>(blocks), 256, 0, a.stream>>>(
      static_cast<const T*>(a.out), static_cast<const T*>(a.dout),
      static_cast<float*>(a.delta), rows, a.Sq, a.H, a.Dv);
  return cudaGetLastError();
}

// dK and dV from the partials: g a kv head (g == 1: none), summed in order.
template <typename T>
cudaError_t launch_sum_heads(const Args& a, int g) {
  if (g == 1) return cudaSuccess;
  const long long rows = static_cast<long long>(a.B) * a.Sk * a.Hkv;
  for (int i = 0; i < 2; ++i) {   // dK, then dV
    const int dim = i ? a.Dv : a.D;
    const long long blocks = (rows * (dim / 4) + 255) / 256;
    fa_bwd_sum_heads_kernel<T><<<static_cast<unsigned>(blocks), 256, 0, a.stream>>>(
        static_cast<const float*>(i ? a.part_v : a.part_k), static_cast<T*>(i ? a.dv : a.dk),
        rows, g, dim);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int DK, int DV, bool EXACT>
cudaError_t launch_bf16(const Args& a) {
  using C = Cfg<DK, DV>;
  cudaError_t err = launch_delta<bf16>(a);
  if (err != cudaSuccess) return err;
  const auto* q = static_cast<const bf16*>(a.q);
  const auto* k = static_cast<const bf16*>(a.k);
  const auto* v = static_cast<const bf16*>(a.v);
  const auto* dout = static_cast<const bf16*>(a.dout);
  const auto* lse = static_cast<const float*>(a.lse);
  const auto* delta = static_cast<const float*>(a.delta);
  err = cudaFuncSetAttribute(fa_bwd_dkdv_bf16_kernel<DK, DV, EXACT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_KV);
  if (err != cudaSuccess) return err;
  fa_bwd_dkdv_bf16_kernel<DK, DV, EXACT>
      <<<dim3(a.H, a.B, (a.Sk + BKV - 1) / BKV), C::NT_KV, C::SMEM_KV, a.stream>>>(
          q, k, v, dout, lse, delta, parts(a.part_k, a), parts(a.part_v, a),
          static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.Sq, a.Sk, a.H, a.Hkv, a.D, a.Dv,
          a.scale, a.causal, a.window, a.softcap);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = launch_sum_heads<bf16>(a, a.H / a.Hkv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fa_bwd_dq_bf16_kernel<DK, DV, EXACT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_Q);
  if (err != cudaSuccess) return err;
  fa_bwd_dq_bf16_kernel<DK, DV, EXACT><<<dim3(a.H, a.B, (a.Sq + BQR - 1) / BQR), 128, C::SMEM_Q,
                                  a.stream>>>(q, k, v, dout, lse, delta,
                                              static_cast<bf16*>(a.dq), a.Sq, a.Sk, a.H, a.Hkv,
                                              a.D, a.Dv, a.scale, a.causal, a.window, a.softcap);
  return cudaGetLastError();
}

// The instance at exactly its widths (no width guards), or the general one.
template <int DK, int DV>
cudaError_t pick_bf16(const Args& a) {
  return a.D == DK && a.Dv == DV ? launch_bf16<DK, DV, true>(a) : launch_bf16<DK, DV, false>(a);
}

// The dQ kernel first (it also forms delta), then the dK / dV kernel and,
// with splits > 1, the runs' sum.
template <int DK, int DV>
cudaError_t launch_sm90(const Args& a) {
  using C = WCfg<DK, DV>;
  const EncodeTiled enc = encoder();
  if (!enc) return cudaErrorNotSupported;
  const auto* lse = static_cast<const float*>(a.lse);
  auto* delta = static_cast<float*>(a.delta);
  // the dQ block's boxes: Q, dO and O of the block, K and V a step
  CUtensorMap mq, mk, mv, mo, mout;
  if (!make_map(enc, &mq, a.q, a.D, a.H, a.Sq, a.B, W_BQ) ||
      !make_map(enc, &mk, a.k, a.D, a.Hkv, a.Sk, a.B, C::BK) ||
      !make_map(enc, &mv, a.v, a.Dv, a.Hkv, a.Sk, a.B, C::BK) ||
      !make_map(enc, &mo, a.dout, a.Dv, a.H, a.Sq, a.B, W_BQ) ||
      !make_map(enc, &mout, a.out, a.Dv, a.H, a.Sq, a.B, W_BQ))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fa_bwd_dq_bf16_sm90_kernel<DK, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_Q);
  if (err != cudaSuccess) return err;
  fa_bwd_dq_bf16_sm90_kernel<DK, DV>
      <<<dim3(a.H, a.B, (a.Sq + W_BQ - 1) / W_BQ), W_NT, C::SMEM_Q, a.stream>>>(
          mq, mk, mv, mo, mout, lse, delta, static_cast<bf16*>(a.dq), a.Sq, a.Sk, a.H, a.Hkv,
          a.D, a.scale, a.causal, a.window, a.softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the dK / dV block's boxes: Q and dO a step, K and V of the block
  if (!make_map(enc, &mq, a.q, a.D, a.H, a.Sq, a.B, C::BQ) ||
      !make_map(enc, &mk, a.k, a.D, a.Hkv, a.Sk, a.B, W_BKV) ||
      !make_map(enc, &mv, a.v, a.Dv, a.Hkv, a.Sk, a.B, W_BKV) ||
      !make_map(enc, &mo, a.dout, a.Dv, a.H, a.Sq, a.B, C::BQ))
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(fa_bwd_dkdv_bf16_sm90_kernel<DK, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_KV);
  if (err != cudaSuccess) return err;
  const bool parts = a.splits > 1;
  fa_bwd_dkdv_bf16_sm90_kernel<DK, DV>
      <<<dim3(a.Hkv * a.splits, a.B, (a.Sk + W_BKV - 1) / W_BKV), W_NT, C::SMEM_KV, a.stream>>>(
          mq, mk, mv, mo, lse, delta, parts ? static_cast<float*>(a.part_k) : nullptr,
          parts ? static_cast<float*>(a.part_v) : nullptr, static_cast<bf16*>(a.dk),
          static_cast<bf16*>(a.dv), a.Sq, a.Sk, a.H, a.Hkv, a.D, a.Dv, a.splits, a.scale,
          a.causal, a.window, a.softcap);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = launch_sum_heads<bf16>(a, a.splits);
  return err;
}

template <int DP>
cudaError_t launch_fp32(const Args& a) {
  cudaError_t err = launch_delta<float>(a);
  if (err != cudaSuccess) return err;
  const auto* q = static_cast<const float*>(a.q);
  const auto* k = static_cast<const float*>(a.k);
  const auto* v = static_cast<const float*>(a.v);
  const auto* dout = static_cast<const float*>(a.dout);
  const auto* lse = static_cast<const float*>(a.lse);
  const auto* delta = static_cast<const float*>(a.delta);
  const int smem = smem_fp32(a.D, a.Dv);
  err = cudaFuncSetAttribute(fa_bwd_dkdv_fp32_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fa_bwd_dkdv_fp32_kernel<DP><<<dim3(a.H, a.B, (a.Sk + FR - 1) / FR), FT, smem, a.stream>>>(
      q, k, v, dout, lse, delta, parts(a.part_k, a), parts(a.part_v, a),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.Sq, a.Sk, a.H, a.Hkv, a.D, a.Dv,
      a.scale, a.causal, a.window, a.softcap);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = launch_sum_heads<float>(a, a.H / a.Hkv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fa_bwd_dq_fp32_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fa_bwd_dq_fp32_kernel<DP><<<dim3(a.H, a.B, (a.Sq + FR - 1) / FR), FT, smem, a.stream>>>(
      q, k, v, dout, lse, delta, static_cast<float*>(a.dq), a.Sq, a.Sk, a.H, a.Hkv, a.D, a.Dv,
      a.scale, a.causal, a.window, a.softcap);
  return cudaGetLastError();
}

// ``grouped``: the partial slots a kv head the instance takes, when it takes
// a fixed number (g: one a q head; 0: any divisor of g).
cudaError_t validate(const Args& a, int align, int grouped) {
  if (a.D % 16 || a.Dv % 16 || a.D <= 0 || a.Dv <= 0 || a.D > 256 || a.Dv > 256 ||
      a.Hkv <= 0 || a.H % a.Hkv || a.B <= 0 || a.Sq <= 0 || a.Sk <= 0 || a.splits <= 0 ||
      (a.H / a.Hkv) % a.splits || (grouped && a.splits != grouped) ||
      (a.splits > 1 && !(a.part_k && a.part_v)))
    return cudaErrorInvalidValue;
  for (const void* p : {static_cast<const void*>(a.part_k), static_cast<const void*>(a.part_v)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  for (const void* p : {a.q, a.k, a.v, a.out, a.dout, static_cast<const void*>(a.dq),
                        static_cast<const void*>(a.dk), static_cast<const void*>(a.dv)})
    if (reinterpret_cast<uintptr_t>(p) % align) return cudaErrorMisalignedAddress;
  if (a.B > 65535 || a.H > 65535 || (a.Sq + FR - 1) / FR > 65535 || (a.Sk + FR - 1) / FR > 65535)
    return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

// The bf16 instance of D and Dv, chosen by width alone: wgmma at the main
// paths' widths, the mma.sync instances at the others.
enum class Bf16Instance { MMA64, SM90_128, SM90_192, MMA256 };

Bf16Instance bf16_instance(int D, int Dv) {
  return D <= 64 && Dv <= 64     ? Bf16Instance::MMA64
         : D <= 128 && Dv <= 128 ? Bf16Instance::SM90_128
         : D <= 192 && Dv <= 128 ? Bf16Instance::SM90_192
                                 : Bf16Instance::MMA256;
}

}  // namespace

// q, k, v, out, dout, lse, delta (scratch, fp32 (B, H, Sq)), part_k and part_v
// (scratch, fp32 (B, Sk, Hkv, splits, D) and (..., Dv); null where splits is
// 1), dq, dk, dv, B, Sq, Sk, H, Hkv, D, Dv, splits (the partial slots a kv
// head: at the wgmma instances any divisor of H / Hkv, otherwise H / Hkv),
// scale, causal, window (0: none), softcap (0: none), stream
extern "C" int flash_attn_bwd_bf16(const void* q, const void* k, const void* v, const void* out,
                                   const void* dout, const void* lse, void* delta, void* part_k,
                                   void* part_v, void* dq, void* dk, void* dv, int B, int Sq,
                                   int Sk, int H, int Hkv, int D, int Dv, int splits,
                                   float scale, int causal, int window, float softcap,
                                   void* stream) {
  const Args a{q, k, v, out, dout, lse, delta, part_k, part_v, dq, dk, dv, B, Sq, Sk, H, Hkv,
               D, Dv, scale, causal, window, softcap, splits,
               static_cast<cudaStream_t>(stream)};
  const Bf16Instance inst = bf16_instance(D, Dv);
  const bool sm90 = inst == Bf16Instance::SM90_128 || inst == Bf16Instance::SM90_192;
  cudaError_t err = validate(a, 16, sm90 || Hkv <= 0 ? 0 : H / Hkv);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (inst) {
    case Bf16Instance::MMA64: err = pick_bf16<64, 64>(a); break;
    case Bf16Instance::SM90_128: err = launch_sm90<128, 128>(a); break;
    case Bf16Instance::SM90_192: err = launch_sm90<192, 128>(a); break;
    default: err = pick_bf16<256, 256>(a);
  }
  return static_cast<int>(err);
}

extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v, const void* out,
                              const void* dout, const void* lse, void* delta, void* part_k,
                              void* part_v, void* dq, void* dk, void* dv, int B, int Sq, int Sk,
                              int H, int Hkv, int D, int Dv, int splits, float scale, int causal,
                              int window, float softcap, void* stream) {
  const Args a{q, k, v, out, dout, lse, delta, part_k, part_v, dq, dk, dv, B, Sq, Sk, H, Hkv,
               D, Dv, scale, causal, window, softcap, splits,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err = validate(a, 4, Hkv <= 0 ? 0 : H / Hkv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dp = D > Dv ? D : Dv;
  err = dp <= 64 ? launch_fp32<64>(a) : dp <= 128 ? launch_fp32<128>(a) : launch_fp32<256>(a);
  return static_cast<int>(err);
}
