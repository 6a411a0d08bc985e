// Synthetic token rows for the fused chunked engine, on the card.
//
// The port's counterpart of the device branch of the JAX package's
// repro/data/pipeline.py::synth_tokens (a lax.scan over positions inside the
// compiled chunk program), not of a Pallas kernel.  Out: int32 tokens
// (K, rows, n_pos), bit-identical to the numpy host path.  Every draw is the
// murmur3-style uint32 hash of its coordinates
//     (kind, seed, stream_lo, stream_hi, step, shard, row, position)
// and position t >= 2 follows the bigram rule hash(tok[t-2], tok[t-1]) % vocab
// when its FOLLOW draw's top 24 bits, as float32 times 2^-24, fall below the
// float32 order_mix, else takes its NOISE draw % vocab.
//
// Bound on this card: neither bytes (a few hundred KB a batch) nor
// operations; the one sequential part, the rule along a row, is latency.
// Design: one block per (lane, row).  The hash state after the seven
// coordinate words is the same for every position of a row, so it is formed
// once; the FOLLOW/NOISE draws of a tile of positions are then made by all
// threads at once into shared memory (the token, or -1 where the rule
// decides), one thread runs the rule over the tile with the last two tokens
// in registers, and all threads store the tile in coalesced order.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint32_t KIND_INIT = 0xA11CE;
constexpr uint32_t KIND_FOLLOW = 0xF0110;
constexpr uint32_t KIND_NOISE = 0x707E5;
constexpr int THREADS = 256;
constexpr int TILE = 2048;  // positions a tile: 8 KB of shared memory

__device__ __forceinline__ uint32_t mix_word(uint32_t h, uint32_t w) {
  h ^= w * 0xCC9E2D51u;
  h = (h << 13) | (h >> 19);
  return h * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t finalize(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// The hash state after the words (kind, seed, lo, hi, step, shard, row).
__device__ __forceinline__ uint32_t prefix(uint32_t kind, uint32_t seed, uint32_t lo,
                                           uint32_t hi, uint32_t step, uint32_t shard,
                                           uint32_t row) {
  uint32_t h = 0x9E3779B9u;
  h = mix_word(h, kind);
  h = mix_word(h, seed);
  h = mix_word(h, lo);
  h = mix_word(h, hi);
  h = mix_word(h, step);
  h = mix_word(h, shard);
  return mix_word(h, row);
}

__device__ __forceinline__ int rule(int a, int b, uint32_t vocab) {
  const uint32_t h = finalize(mix_word(mix_word(0x9E3779B9u, static_cast<uint32_t>(a)),
                                       static_cast<uint32_t>(b)));
  return static_cast<int>(h % vocab);
}

__global__ void __launch_bounds__(THREADS)
synth_tokens_kernel(const long long* __restrict__ steps, const long long* __restrict__ lo,
                    const long long* __restrict__ hi, int* __restrict__ out, int rows,
                    int n_pos, uint32_t seed, uint32_t shard, uint32_t vocab, float mix,
                    long long offset) {
  __shared__ int tile[TILE];
  const int lane = blockIdx.x / rows;
  const int row = blockIdx.x % rows;
  // the hash words are the low 32 bits of each coordinate (modular conversion)
  const uint32_t w_lo = static_cast<uint32_t>(lo[lane]);
  const uint32_t w_hi = static_cast<uint32_t>(hi[lane]);
  const uint32_t w_step = static_cast<uint32_t>(steps[lane] + offset);
  const uint32_t p_init = prefix(KIND_INIT, seed, w_lo, w_hi, w_step, shard, row);
  const uint32_t p_follow = prefix(KIND_FOLLOW, seed, w_lo, w_hi, w_step, shard, row);
  const uint32_t p_noise = prefix(KIND_NOISE, seed, w_lo, w_hi, w_step, shard, row);
  int* dst = out + static_cast<long long>(blockIdx.x) * n_pos;
  int a = 0, b = 0;  // the row's last two tokens, carried across tiles by thread 0

  for (int t0 = 0; t0 < n_pos; t0 += TILE) {
    const int n = min(TILE, n_pos - t0);
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const uint32_t t = static_cast<uint32_t>(t0 + i);
      int tok;
      if (t < 2) {
        tok = static_cast<int>(finalize(mix_word(p_init, t)) % vocab);
      } else {
        const uint32_t f = finalize(mix_word(p_follow, t));
        const bool follow = static_cast<float>(f >> 8) * 5.9604644775390625e-08f < mix;
        tok = follow ? -1 : static_cast<int>(finalize(mix_word(p_noise, t)) % vocab);
      }
      tile[i] = tok;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 0; i < n; ++i) {
        int tok = tile[i];
        if (tok < 0) {
          tok = rule(a, b, vocab);
          tile[i] = tok;
        }
        a = b;
        b = tok;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += THREADS) dst[t0 + i] = tile[i];
    __syncthreads();
  }
}

}  // namespace

// steps, lo, hi: int64 (K,) on the card (each value's low 32 bits are its hash
// word); out: int32 (K, rows, n_pos).  The step of lane k is steps[k] + offset.
extern "C" int synth_tokens_fwd(const void* steps, const void* lo, const void* hi, void* out,
                                int K, int rows, int n_pos, long long seed, long long shard,
                                int vocab, float mix, long long offset, void* stream) {
  if (K <= 0 || rows <= 0 || n_pos < 2 || vocab <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(K) * rows;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidConfiguration);
  synth_tokens_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(steps), static_cast<const long long*>(lo),
      static_cast<const long long*>(hi), static_cast<int*>(out), rows, n_pos,
      static_cast<uint32_t>(seed), static_cast<uint32_t>(shard), static_cast<uint32_t>(vocab),
      mix, offset);
  return static_cast<int>(cudaGetLastError());
}
