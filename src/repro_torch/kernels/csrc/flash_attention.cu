// Flash attention forward for fp32 on the CUDA cores (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_fwd_pallas
// (body _flash_kernel) for fp32 inputs; bf16 inputs go to the tensor-core
// kernel in flash_attention_sm90.cu.  An online-softmax attention forward with
// grouped-query heads (q head h reads kv head h / g), causal and sliding-window
// masks and a logit softcap, ragged Sq / Sk masked as q_pos < Sq && k_pos < Sk.
// It returns out (B, Sq, H, Dv) and lse (B, H, Sq) in fp32, with lse = NEG_INF
// and out = 0 on fully masked rows; every q/k and v head dim that is a
// multiple of 16 up to 256 is taken, independently.
//
// Bound on this card: operations.  The two products take
// 2 * B * H * Sq * Sk * (D + Dv) flops, about half of that under the causal
// mask, against 67 TFLOP/s of fp32 outside the tensor cores.  The kernel
// computes in exact fp32 FMAs (no TF32, no split TF32): the card-against-CPU
// parity of the fp32 configs needs it.  What holds it under that bound is the
// register file: the O accumulators (64 a thread), the scores and the
// fragments fill 168 registers, three blocks an SM fill the registers and
// the shared memory, and ptxas then schedules each chunk's loads just before
// their FMAs, so three warps a scheduler wait on shared-memory latency (the
// products run at about half the FMA rate; halving their loads changes
// nothing, so it is not bandwidth).  At a grid too small to fill the card the
// bound is the latency of one block's walk over the kv tiles.
//
// Design, as a SIMT SGEMM is built: blocks of 128 threads per (BQ-row q
// tile, q head, batch), heavy causal tiles first; 16 row groups x 8 column
// groups.  A thread owns RM q rows (rg + 16 i) and, in a kv tile of 32 rows,
// the 4 keys cg + 8 j.
//  - Q (pre-scaled) stays in shared memory for the whole walk; K, V stream
//    through it a tile at a time.  Q and K rows are padded by 4 floats, so
//    the 8 keys (or the row groups' rows) a warp reads at one d land on
//    distinct banks and a thread reads 4 consecutive d of a row or a key
//    with one 128-bit load: RM + 4 vector loads for 16 RM FMAs.
//  - S = Q K^T in registers (RM x 4 a thread), summed over d in order, one
//    FMA a term.  The mask (only in tiles that need it), the softcap and the
//    online softmax stay in fp32 registers; the row max and sum over the 8
//    threads of a row are warp shuffles; P goes to shared memory once a tile.
//  - O += P V in registers (RM rows x NJ chunks of 4 columns a thread, the
//    chunks cg + 8 jj, so 8 threads read a V row's consecutive 128 bytes; V
//    rows stored at the band's width, a compile-time stride): per 4 keys, RM
//    loads of P and 4 NJ of V for 16 RM NJ FMAs.
//  - K and V are copied with cp.async (16 bytes a copy, zero-filled past Sk,
//    no division in the copy loop), one buffer each and two barriers a tile:
//    a tile's V is issued after the first (the last tile's P V is done) and
//    lands while S and the softmax run; the next tile's K is issued after
//    the second (this tile's S is done) and lands while P V runs.
//  - Instances by the v head dim's band (NJ = 1, 2, 4, 8 chunks, so the
//    register blocks are compile-time), with RM = 4 rows a thread (BQ 64;
//    2, BQ 32, at v widths over 128).  Where that grid leaves SMs idle (the
//    short MLA check case, the smoke configs), blocks take half the rows and
//    SPLIT = 4 groups of 128 threads (2 where 4 do not fit the shared
//    memory) walk every SPLIT-th kv tile, each with its own buffers and
//    online-softmax state; group 0 merges the states in group order.
//    The walk stops at the causal diagonal and starts at the window's first
//    visible tile (the Pallas kernel runs those tiles fully masked, which
//    changes nothing: a masked tile leaves m, l and O as they were).
#include <cstdint>

#include "common.cuh"

namespace {

using kernels::NEG_INF;

constexpr int NT = 128;        // threads a block
constexpr int RG = 16;         // row groups
constexpr int CG = 8;          // column groups: the 8 lanes of a row group
constexpr int BK = 32;         // kv rows a tile
constexpr int KN = BK / CG;    // keys a thread in a tile
constexpr int LDP = BK + 4;    // P's row stride (floats)

// Q, then each group's K, V (rows at the band's width, 32 NJ floats: a
// compile-time stride) and P
size_t smem_bytes(int rm, int nj, int split, int D) {
  const size_t bq = static_cast<size_t>(RG) * rm;
  return sizeof(float) * (bq * (D + 4) + split * (static_cast<size_t>(BK) * (D + 4) +
                                                  static_cast<size_t>(BK) * 32 * nj + bq * LDP));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [k0, k0 + BK) of one kv head (row stride row_stride floats, width
// 4 * nchunk) into dst (stride ld), zero past Sk.  A thread copies the chunks
// tid, tid + NT, ...; (r0, c0) is the row and chunk of its first and
// (dr, dc) = divmod(NT, nchunk) its step, so no division runs here.
__device__ __forceinline__ void copy_tile(float* dst, int ld, const float* src,
                                          long long row_stride, int nchunk, int k0, int Sk,
                                          int r0, int c0, int dr, int dc) {
  for (int r = r0, c = c0; r < BK;) {
    const int kp = k0 + r;
    cp_async16(dst + r * ld + 4 * c, src + (kp < Sk ? kp : 0) * row_stride + 4 * c, kp < Sk);
    r += dr;
    c += dc;
    if (c >= nchunk) {
      c -= nchunk;
      ++r;
    }
  }
}

template <int RM, int NJ, int SPLIT, int MINB>
__global__ void __launch_bounds__(NT * SPLIT, MINB) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int H, int Hkv, int D,
    int Dv, float scale, int causal, int window, float softcap) {
  constexpr int BQ = RG * RM;
  constexpr int LDV = 32 * NJ;  // V row stride
  static_assert(SPLIT == 1 || BQ <= BK, "a group's merge state must fit its K and V buffers");
  extern __shared__ float4 smem4[];
  const int ld = D + 4;  // Q and K row stride
  // SPLIT groups of NT threads walk the kv tiles lo + group, lo + group + SPLIT,
  // ..., each with its own K, V and P buffers and its own softmax state
  const int group = SPLIT == 1 ? 0 : static_cast<int>(threadIdx.x) / NT;
  const int per_group = BK * ld + BK * LDV + BQ * LDP;  // floats
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][D + 4], q * scale
  float* Ks = Qs + BQ * ld + group * per_group; // [BK][D + 4]
  float* Vs = Ks + BK * ld;                     // [BK][LDV]
  float* Ps = Vs + BK * LDV;                    // [BQ][LDP], this tile's probabilities

  const int iq = gridDim.x - 1 - blockIdx.x;  // late (heavy causal) tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = iq * BQ;
  const int tid = threadIdx.x - group * NT, rg = tid >> 3, cg = tid & 7;
  const int nd = D >> 2, nv = Dv >> 2;  // 16-byte chunks a row
  const long long kv_row = static_cast<long long>(Hkv);
  const float* kh = k + (static_cast<long long>(b) * Sk * Hkv + hk) * D;
  const float* vh = v + (static_cast<long long>(b) * Sk * Hkv + hk) * Dv;

  const int n_tiles = (Sk + BK - 1) / BK;
  int hi = n_tiles, lo = 0;
  if (causal) hi = min(n_tiles, (q0 + BQ - 1) / BK + 1);
  if (window > 0) lo = max(0, (q0 - window + 1) / BK);

  // each thread's first chunk and step in the K and V copies
  const int kr0 = tid / nd, kc0 = tid - kr0 * nd, kdr = NT / nd, kdc = NT - kdr * nd;
  const int vr0 = tid / nv, vc0 = tid - vr0 * nv, vdr = NT / nv, vdc = NT - vdr * nv;
  if (lo + group < hi)
    copy_tile(Ks, ld, kh, kv_row * D, nd, (lo + group) * BK, Sk, kr0, kc0, kdr, kdc);
  cp_async_commit();
  for (int idx = threadIdx.x; idx < BQ * nd; idx += NT * SPLIT) {
    const int r = idx / nd, c = idx - r * nd, qp = q0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qp < Sq)
      x = *reinterpret_cast<const float4*>(
          q + ((static_cast<long long>(b) * Sq + qp) * H + h) * D + 4 * c);
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    *reinterpret_cast<float4*>(Qs + r * ld + 4 * c) = x;
  }

  float o[RM][NJ][4];
  float m_i[RM], l_i[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) o[i][jj][0] = o[i][jj][1] = o[i][jj][2] = o[i][jj][3] = 0.f;
  }
  int vc[NJ];  // this thread's V chunks (clamped: a chunk past Dv is computed, never stored)
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) vc[jj] = 4 * min(cg + CG * jj, nv - 1);

  // every group runs the same rounds (the barriers are the block's); in the
  // last one a group may have no tile
  const int rounds = hi > lo ? (hi - lo + SPLIT - 1) / SPLIT : 0;
  for (int round = 0; round < rounds; ++round) {
    const int kt = lo + group + round * SPLIT, k0 = kt * BK;
    const bool live = SPLIT == 1 || kt < hi;
    cp_async_wait<0>();  // this tile's K
    __syncthreads();     // K visible; the last tile's V and P are read
    if (live) copy_tile(Vs, LDV, vh, kv_row * Dv, nv, k0, Sk, vr0, vc0, vdr, vdc);
    cp_async_commit();

    float s[RM][KN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < KN; ++j) s[i][j] = 0.f;
    if (live) {
      const float* qr = Qs + rg * ld;
      const float* kr = Ks + cg * ld;
#pragma unroll 2
      for (int c = 0; c < nd; ++c) {
        float4 qa[RM], kb[KN];
#pragma unroll
        for (int i = 0; i < RM; ++i)
          qa[i] = *reinterpret_cast<const float4*>(qr + i * RG * ld + 4 * c);
#pragma unroll
        for (int j = 0; j < KN; ++j)
          kb[j] = *reinterpret_cast<const float4*>(kr + j * CG * ld + 4 * c);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < KN; ++j) {
            s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
            s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
            s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
            s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
          }
      }
    }
    // a mask is needed where the tile crosses Sq, Sk, the diagonal or the window
    const bool edge = q0 + BQ > Sq || k0 + BK > Sk || (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && k0 <= q0 + BQ - 1 - window);
    if (live) {
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = rg + RG * i, qp = q0 + r;
        float row_max = NEG_INF;
#pragma unroll
        for (int j = 0; j < KN; ++j) {
          const int kp = k0 + cg + CG * j;
          float sv = s[i][j];
          if (softcap > 0.f) sv = softcap * tanhf(sv / softcap);
          const bool ok = !edge || (qp < Sq && kp < Sk && (!causal || kp <= qp) &&
                                    (window <= 0 || kp > qp - window));
          s[i][j] = ok ? sv : NEG_INF;
          row_max = fmaxf(row_max, s[i][j]);
        }
#pragma unroll
        for (int off = 1; off < CG; off <<= 1)
          row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
        const float m_new = fmaxf(m_i[i], row_max);
        const float m_safe = m_new > NEG_INF / 2 ? m_new : 0.f;
        const float corr = m_i[i] > NEG_INF / 2 ? expf(m_i[i] - m_safe) : 0.f;
        float row_sum = 0.f;
#pragma unroll
        for (int j = 0; j < KN; ++j) {
          // a masked score is NEG_INF: its exponential is exactly 0
          const float p = expf(s[i][j] - m_safe);
          Ps[r * LDP + cg + CG * j] = p;
          row_sum += p;
        }
#pragma unroll
        for (int off = 1; off < CG; off <<= 1)
          row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
        m_i[i] = m_new;
        l_i[i] = l_i[i] * corr + row_sum;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          o[i][jj][0] *= corr;
          o[i][jj][1] *= corr;
          o[i][jj][2] *= corr;
          o[i][jj][3] *= corr;
        }
      }
    }
    cp_async_wait<0>();  // this tile's V
    __syncthreads();     // V and every row's P visible; K is read
    if (kt + SPLIT < hi)
      copy_tile(Ks, ld, kh, kv_row * D, nd, k0 + SPLIT * BK, Sk, kr0, kc0, kdr, kdc);
    cp_async_commit();

    if (live) {
#pragma unroll 2
      for (int kc = 0; kc < BK / 4; ++kc) {
        float4 pa[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i)
          pa[i] = *reinterpret_cast<const float4*>(Ps + (rg + RG * i) * LDP + 4 * kc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* vr = Vs + (4 * kc + kk) * LDV;
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) {
            const float4 vb = *reinterpret_cast<const float4*>(vr + vc[jj]);
#pragma unroll
            for (int i = 0; i < RM; ++i) {
              const float p = kk == 0 ? pa[i].x : kk == 1 ? pa[i].y : kk == 2 ? pa[i].z : pa[i].w;
              o[i][jj][0] = fmaf(p, vb.x, o[i][jj][0]);
              o[i][jj][1] = fmaf(p, vb.y, o[i][jj][1]);
              o[i][jj][2] = fmaf(p, vb.z, o[i][jj][2]);
              o[i][jj][3] = fmaf(p, vb.w, o[i][jj][3]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  if (SPLIT > 1) {
    // groups 1.. leave (m, l, O) in their own buffers; group 0 merges them in
    // order, as two online-softmax states merge
    __syncthreads();  // every group's last V and P are read
    float* mine = Ks;  // [m (BQ), l (BQ), O (BQ x LDV)]
    if (group > 0) {
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = rg + RG * i;
        if (cg == 0) {
          mine[r] = m_i[i];
          mine[BQ + r] = l_i[i];
        }
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
          *reinterpret_cast<float4*>(mine + 2 * BQ + r * LDV + 4 * (cg + CG * jj)) =
              make_float4(o[i][jj][0], o[i][jj][1], o[i][jj][2], o[i][jj][3]);
      }
    }
    __syncthreads();
    if (group > 0) return;
#pragma unroll
    for (int g = 1; g < SPLIT; ++g) {
      const float* other = Qs + BQ * ld + g * per_group;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = rg + RG * i;
        const float mg = other[r], lg = other[BQ + r];
        const float m_new = fmaxf(m_i[i], mg);
        const float m_safe = m_new > NEG_INF / 2 ? m_new : 0.f;
        const float c0 = m_i[i] > NEG_INF / 2 ? expf(m_i[i] - m_safe) : 0.f;
        const float c1 = mg > NEG_INF / 2 ? expf(mg - m_safe) : 0.f;
        l_i[i] = fmaf(lg, c1, l_i[i] * c0);
        m_i[i] = m_new;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const float4 og =
              *reinterpret_cast<const float4*>(other + 2 * BQ + r * LDV + 4 * (cg + CG * jj));
          o[i][jj][0] = fmaf(og.x, c1, o[i][jj][0] * c0);
          o[i][jj][1] = fmaf(og.y, c1, o[i][jj][1] * c0);
          o[i][jj][2] = fmaf(og.z, c1, o[i][jj][2] * c0);
          o[i][jj][3] = fmaf(og.w, c1, o[i][jj][3] * c0);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qp = q0 + rg + RG * i;
    if (qp >= Sq) continue;
    const float l = fmaxf(l_i[i], 1e-30f);
    float* orow = out + ((static_cast<long long>(b) * Sq + qp) * H + h) * Dv;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      if (cg + CG * jj < nv)
        *reinterpret_cast<float4*>(orow + 4 * (cg + CG * jj)) =
            make_float4(o[i][jj][0] / l, o[i][jj][1] / l, o[i][jj][2] / l, o[i][jj][3] / l);
    }
    if (cg == 0)
      lse[(static_cast<long long>(b) * H + h) * Sq + qp] =
          m_i[i] > NEG_INF / 2 ? m_i[i] + logf(l) : NEG_INF;
  }
}

constexpr int kMaxDevices = 64;

template <int RM, int NJ, int SPLIT, int MINB>
cudaError_t launch_instance(int dev, const float* q, const float* k, const float* v, float* out,
                            float* lse, int B, int Sq, int Sk, int H, int Hkv, int D, int Dv,
                            float scale, int causal, int window, float softcap,
                            cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<RM, NJ, SPLIT, MINB>;
  // the opt-in is set once an instance and device, to the card's limit, so
  // launches pay no host call
  static bool opted_in[kMaxDevices] = {};
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    int limit = 0;
    cudaError_t err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  const dim3 grid((Sq + RG * RM - 1) / (RG * RM), H, B);
  kernel<<<grid, NT * SPLIT, smem_bytes(RM, NJ, SPLIT, D), stream>>>(
      q, k, v, out, lse, Sq, Sk, H, Hkv, D, Dv, scale, causal, window, softcap);
  return cudaGetLastError();
}

cudaError_t launch(const float* q, const float* k, const float* v, float* out, float* lse, int B,
                   int Sq, int Sk, int H, int Hkv, int D, int Dv, float scale, int causal,
                   int window, float softcap, cudaStream_t stream) {
  if (D % 16 || Dv % 16 || D <= 0 || Dv <= 0 || D > 256 || Dv > 256 || Hkv <= 0 || H % Hkv)
    return cudaErrorInvalidValue;
  if (H > 65535 || B > 65535) return cudaErrorInvalidConfiguration;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) & 15)
    return cudaErrorMisalignedAddress;
  int dev = 0, sms = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  // the big instance's rows a block; when its grid leaves SMs idle, half the
  // rows and the kv walk split over 4 groups of warps (2 where 4 do not fit)
  const int rm = Dv > 128 ? 2 : 4, nj = Dv <= 32 ? 1 : Dv <= 64 ? 2 : Dv <= 128 ? 4 : 8;
  const long long blocks = static_cast<long long>((Sq + RG * rm - 1) / (RG * rm)) * H * B;
  const int split = blocks >= sms ? 1
                    : smem_bytes(rm / 2, nj, 4, D) <= static_cast<size_t>(limit) ? 4 : 2;
#define FLASH_ARGS dev, q, k, v, out, lse, B, Sq, Sk, H, Hkv, D, Dv, scale, causal, window, softcap, stream
#define FLASH_BAND(R, N, MINB)                                                  \
  return split == 1   ? launch_instance<R, N, 1, MINB>(FLASH_ARGS)             \
         : split == 2 ? launch_instance<R / 2, N, 2, 1>(FLASH_ARGS)            \
                      : launch_instance<R / 2, N, 4, 1>(FLASH_ARGS)
  if (nj == 1) FLASH_BAND(4, 1, 3);
  if (nj == 2) FLASH_BAND(4, 2, 3);
  if (nj == 4) FLASH_BAND(4, 4, 3);
  FLASH_BAND(2, 8, 2);
#undef FLASH_BAND
#undef FLASH_ARGS
}

}  // namespace

extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                              int B, int Sq, int Sk, int H, int Hkv, int D, int Dv, float scale,
                              int causal, int window, float softcap, void* stream) {
  return static_cast<int>(launch(static_cast<const float*>(q), static_cast<const float*>(k),
                                 static_cast<const float*>(v), static_cast<float*>(out),
                                 static_cast<float*>(lse), B, Sq, Sk, H, Hkv, D, Dv, scale,
                                 causal, window, softcap, static_cast<cudaStream_t>(stream)));
}
