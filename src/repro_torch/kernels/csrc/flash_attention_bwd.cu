// Flash attention backward on Hopper (sm_90a): bf16 on the tensor cores
// (mma.sync), fp32 in exact FMAs on the CUDA cores.
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
// batch's extent or the card's SM count.
//  - fa_bwd_delta_kernel: delta = rowsum(dO * O) in fp32, (B, H, Sq); one warp
//    a row, each lane summing its columns in order, then a fixed butterfly.
//  - dK / dV: one block per (q head, batch row, 64-row kv tile), heavy causal
//    tiles first.  K and V stay in shared memory; the block walks the q tiles
//    that see its kv tile (the causal diagonal and the window bound the
//    walk), Q and dO double-buffered with cp.async.  Each warp
//    owns 16 kv rows: S^T = K Q^T and dP^T = V dO^T in fp32 accumulators, P =
//    exp(S - lse) masked, dS = P (dP - delta) (1 - tanh^2) scale; then dV +=
//    P^T dO and dK += dS^T Q, with P and dS rounded to bf16 for those products
//    (as the forward rounds P for P V) and the sums in fp32 registers, written
//    once at the end.  At a 256-wide instance two warps share the 16 rows,
//    each holding half of dK's and dV's columns (both compute S and dP).
//    Under grouped-query heads (g > 1) each q head's block writes its fp32
//    partial dK and dV, and fa_bwd_sum_heads_kernel sums the g partials of a
//    kv head in head order: a block per q head fills the card where a block
//    per kv head (2 kv heads x 4 rows x 16 tiles at starcoder2's one-trial
//    shape) would leave SMs idle and walk g times as many q tiles in turn.
//  - dQ: one block per (q head, batch row, 64-row q tile), heavy causal tiles
//    first; Q and dO stay in shared memory, K and V tiles double-buffered;
//    each warp owns 16 q rows and accumulates dQ += dS K over its kv tiles.
//  - Each bf16 kernel has an instance at exactly its widths (64, 128, 192 /
//    128, 256), without width guards, so the products' loops are straight
//    code; the masks are computed only on tiles that meet an edge.
//  - Products: mma.sync.m16n8k16 (bf16 in, fp32 accumulate), operands from
//    padded shared memory by ldmatrix (transposed where the product wants
//    the stored rows as its k), the A operand of P^T dO and dS^T Q (and dS K)
//    straight from the accumulators' registers.
//  - fp32: the same three kernels' shape in SIMT form on 32-row tiles, 256
//    threads, every product one fmaf a term in a fixed order (no TF32): a
//    thread forms 4 scores and 4 dP terms of the tile, then 8 threads a row
//    own strided columns of the row's dK and dV (or dQ).
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

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
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
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

// Under grouped heads, dK and dV from the q heads' partials.
template <typename T>
cudaError_t launch_sum_heads(const Args& a) {
  if (a.H == a.Hkv) return cudaSuccess;
  const long long rows = static_cast<long long>(a.B) * a.Sk * a.Hkv;
  for (int i = 0; i < 2; ++i) {   // dK, then dV
    const int dim = i ? a.Dv : a.D;
    const long long blocks = (rows * (dim / 4) + 255) / 256;
    fa_bwd_sum_heads_kernel<T><<<static_cast<unsigned>(blocks), 256, 0, a.stream>>>(
        static_cast<const float*>(i ? a.part_v : a.part_k), static_cast<T*>(i ? a.dv : a.dk),
        rows, a.H / a.Hkv, dim);
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
  if (err == cudaSuccess) err = launch_sum_heads<bf16>(a);
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
  if (err == cudaSuccess) err = launch_sum_heads<float>(a);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fa_bwd_dq_fp32_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fa_bwd_dq_fp32_kernel<DP><<<dim3(a.H, a.B, (a.Sq + FR - 1) / FR), FT, smem, a.stream>>>(
      q, k, v, dout, lse, delta, static_cast<float*>(a.dq), a.Sq, a.Sk, a.H, a.Hkv, a.D, a.Dv,
      a.scale, a.causal, a.window, a.softcap);
  return cudaGetLastError();
}

cudaError_t validate(const Args& a, int align) {
  if (a.D % 16 || a.Dv % 16 || a.D <= 0 || a.Dv <= 0 || a.D > 256 || a.Dv > 256 ||
      a.Hkv <= 0 || a.H % a.Hkv || a.B <= 0 || a.Sq <= 0 || a.Sk <= 0 ||
      (a.H != a.Hkv && !(a.part_k && a.part_v)))
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

}  // namespace

// q, k, v, out, dout, lse, delta (scratch, fp32 (B, H, Sq)), part_k and part_v
// (scratch, fp32 (B, Sk, H, D) and (B, Sk, H, Dv); null where H == Hkv), dq,
// dk, dv, B, Sq, Sk, H, Hkv, D, Dv, scale, causal, window (0: none), softcap
// (0: none), stream
extern "C" int flash_attn_bwd_bf16(const void* q, const void* k, const void* v, const void* out,
                                   const void* dout, const void* lse, void* delta, void* part_k,
                                   void* part_v, void* dq, void* dk, void* dv, int B, int Sq,
                                   int Sk, int H, int Hkv, int D, int Dv, float scale, int causal,
                                   int window, float softcap, void* stream) {
  const Args a{q, k, v, out, dout, lse, delta, part_k, part_v, dq, dk, dv, B, Sq, Sk, H, Hkv,
               D, Dv, scale, causal, window, softcap, static_cast<cudaStream_t>(stream)};
  cudaError_t err = validate(a, 16);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = D <= 64 && Dv <= 64     ? pick_bf16<64, 64>(a)
        : D <= 128 && Dv <= 128 ? pick_bf16<128, 128>(a)
        : D <= 192 && Dv <= 128 ? pick_bf16<192, 128>(a)
                                : pick_bf16<256, 256>(a);
  return static_cast<int>(err);
}

extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v, const void* out,
                              const void* dout, const void* lse, void* delta, void* part_k,
                              void* part_v, void* dq, void* dk, void* dv, int B, int Sq, int Sk,
                              int H, int Hkv, int D, int Dv, float scale, int causal, int window,
                              float softcap, void* stream) {
  const Args a{q, k, v, out, dout, lse, delta, part_k, part_v, dq, dk, dv, B, Sq, Sk, H, Hkv,
               D, Dv, scale, causal, window, softcap, static_cast<cudaStream_t>(stream)};
  cudaError_t err = validate(a, 4);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dp = D > Dv ? D : Dv;
  err = dp <= 64 ? launch_fp32<64>(a) : dp <= 128 ? launch_fp32<128>(a) : launch_fp32<256>(a);
  return static_cast<int>(err);
}
