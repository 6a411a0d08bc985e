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
// operations; latency.  The rule makes a position depend on the two before
// it, but the dependency breaks wherever two consecutive tokens are fixed
// without the rule (positions 0 and 1, two NOISE draws in a row).  A row
// is therefore a set of independent chains, each starting at a rule
// position whose two predecessors are fixed, and the least time is the
// longest chain's dependent rule steps (a few hundred at order_mix 0.85,
// against the row's ~870 rule positions) times one step's latency.
//
// Design: one block per (lane, row), tiles of TILE positions.  The hash
// state after the seven coordinate words is the same for every position of a
// row, so it is formed once.  (1) All threads make the tile's INIT, FOLLOW
// and NOISE draws into shared memory: the token, or -1 where the rule
// decides.  (2) Every rule position whose two predecessors are fixed (a
// predecessor in an earlier, already resolved tile counts as fixed) is a
// chain start; a warp ballot and one shared atomic a warp list them.
// (3) Each chain goes to its own thread (round robin over the warps), which
// walks it rule step by rule step to its end (two fixed tokens in a row, or
// the tile's end).  A step's shortest dependent sequence is the second hash
// word (the previous result), the finalizer and the remainder: the first
// word's mix_word, which depends only on the older token, is formed a step
// ahead off the chain; the remainder is a multiply-high by the reciprocal
// floor((2^32 - 1) / vocab), formed once a launch (kernels/synth.py::
// vocab_reciprocal), and one min; the next positions' tokens are loaded a
// step ahead, so no shared-memory load sits on the chain.  (4) All threads
// store the tile in coalesced order.  Chains are independent, so the order in
// which threads finish them does not change a bit of the output.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint32_t KIND_INIT = 0xA11CE;
constexpr uint32_t KIND_FOLLOW = 0xF0110;
constexpr uint32_t KIND_NOISE = 0x707E5;
constexpr uint32_t HASH_SEED = 0x9E3779B9u;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 2048;  // positions a tile (kernels/synth.py::TILE)

__device__ __forceinline__ uint32_t mix_word(uint32_t h, uint32_t w) {
  h ^= w * 0xCC9E2D51u;
  h = __funnelshift_l(h, h, 13);
  return h * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t finalize(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// x % vocab for every uint32 x and vocab in (0, 2^31), from recip =
// floor((2^32 - 1) / vocab): q = umulhi(x, recip) is floor(x / vocab) or one
// less, so r = x - q * vocab lies in [0, 2 * vocab) and one min settles it
// (r - vocab wraps above r when r < vocab).
__device__ __forceinline__ uint32_t mod_vocab(uint32_t x, uint32_t vocab, uint32_t recip) {
  const uint32_t r = x - __umulhi(x, recip) * vocab;
  return min(r, r - vocab);
}

// The hash state after the words (kind, seed, lo, hi, step, shard, row).
__device__ __forceinline__ uint32_t prefix(uint32_t kind, uint32_t seed, uint32_t lo,
                                           uint32_t hi, uint32_t step, uint32_t shard,
                                           uint32_t row) {
  uint32_t h = HASH_SEED;
  h = mix_word(h, kind);
  h = mix_word(h, seed);
  h = mix_word(h, lo);
  h = mix_word(h, hi);
  h = mix_word(h, step);
  h = mix_word(h, shard);
  return mix_word(h, row);
}

// Walk the chain that starts at rule position s of a tile of n positions:
// tok[s-2], tok[s-1] are fixed (a, b).  Writes every rule position of the
// chain; stops before two fixed tokens in a row or at the tile's end.  The
// positions read ahead (p + 1, p + 2) are fixed or this chain's own, so no
// other thread writes them.
__device__ __forceinline__ void walk_chain(int* tile, int s, int n, uint32_t a, uint32_t b,
                                           uint32_t vocab, uint32_t recip) {
  uint32_t h = mix_word(mix_word(HASH_SEED, a), b);
  uint32_t ha = mix_word(HASH_SEED, b);  // first word of the step after, if it has no gap
  int p = s;
  for (;;) {
    const int n1 = p + 1 < n ? tile[p + 1] : 0;
    const int n2 = p + 2 < n ? tile[p + 2] : 0;
    const uint32_t r = mod_vocab(finalize(h), vocab, recip);
    tile[p] = static_cast<int>(r);
    const bool gap = n1 >= 0;  // p + 1 fixed: the next rule position is p + 2
    if (p + 1 >= n || (gap && (p + 2 >= n || n2 >= 0))) break;
    // no gap: tok[p+1] = rule(tok[p-1], r); a gap: tok[p+2] = rule(r, tok[p+1])
    h = mix_word(gap ? HASH_SEED : ha, r);
    if (gap) h = mix_word(h, static_cast<uint32_t>(n1));
    ha = mix_word(HASH_SEED, gap ? static_cast<uint32_t>(n1) : r);
    p += gap ? 2 : 1;
  }
}

__global__ void __launch_bounds__(THREADS)
synth_tokens_kernel(const long long* __restrict__ steps, const long long* __restrict__ lo,
                    const long long* __restrict__ hi, int* __restrict__ out, int rows,
                    int n_pos, uint32_t seed, uint32_t shard, uint32_t vocab, uint32_t recip,
                    float mix, long long offset) {
  __shared__ int tile[TILE];
  __shared__ int starts[TILE];
  __shared__ int n_starts;
  __shared__ int carry[2];  // the previous tile's last two tokens
  const int lane_k = blockIdx.x / rows;
  const int row = blockIdx.x % rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the hash words are the low 32 bits of each coordinate (modular conversion)
  const uint32_t w_lo = static_cast<uint32_t>(lo[lane_k]);
  const uint32_t w_hi = static_cast<uint32_t>(hi[lane_k]);
  const uint32_t w_step = static_cast<uint32_t>(steps[lane_k] + offset);
  const uint32_t p_init = prefix(KIND_INIT, seed, w_lo, w_hi, w_step, shard, row);
  const uint32_t p_follow = prefix(KIND_FOLLOW, seed, w_lo, w_hi, w_step, shard, row);
  const uint32_t p_noise = prefix(KIND_NOISE, seed, w_lo, w_hi, w_step, shard, row);
  int* dst = out + static_cast<long long>(blockIdx.x) * n_pos;

  for (int t0 = 0; t0 < n_pos; t0 += TILE) {
    const int n = min(TILE, n_pos - t0);
    // (1) the draws
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const uint32_t t = static_cast<uint32_t>(t0 + i);
      int tok;
      if (t < 2) {
        tok = static_cast<int>(mod_vocab(finalize(mix_word(p_init, t)), vocab, recip));
      } else {
        const uint32_t f = finalize(mix_word(p_follow, t));
        const bool follow = static_cast<float>(f >> 8) * 5.9604644775390625e-08f < mix;
        tok = follow ? -1
                     : static_cast<int>(
                           mod_vocab(finalize(mix_word(p_noise, t)), vocab, recip));
      }
      tile[i] = tok;
    }
    if (threadIdx.x == 0) n_starts = 0;
    __syncthreads();
    // (2) the chain starts, in any order
    for (int base = 0; base < n; base += THREADS) {
      const int i = base + threadIdx.x;
      const bool start = i < n && tile[i] < 0 && (i < 1 || tile[i - 1] >= 0) &&
                         (i < 2 || tile[i - 2] >= 0);
      const unsigned ballot = __ballot_sync(0xffffffffu, start);
      if (ballot) {
        int first = 0;
        if (lane == 0) first = atomicAdd(&n_starts, __popc(ballot));
        first = __shfl_sync(0xffffffffu, first, 0);
        if (start) starts[first + __popc(ballot & ((1u << lane) - 1u))] = i;
      }
    }
    __syncthreads();
    // (3) one chain a thread, spread over the warps
    const int n_chains = n_starts;
    for (int c = warp + WARPS * lane; c < n_chains; c += THREADS) {
      const int s = starts[c];
      // a predecessor before the tile is the previous tile's (s >= 2 in tile 0)
      const int a = s >= 2 ? tile[s - 2] : (s == 1 ? carry[1] : carry[0]);
      const int b = s >= 1 ? tile[s - 1] : carry[1];
      walk_chain(tile, s, n, static_cast<uint32_t>(a), static_cast<uint32_t>(b), vocab,
                 recip);
    }
    __syncthreads();
    // (4) the tile, coalesced
    for (int i = threadIdx.x; i < n; i += THREADS) dst[t0 + i] = tile[i];
    if (threadIdx.x == 0 && n >= 2) {
      carry[0] = tile[n - 2];
      carry[1] = tile[n - 1];
    }
    __syncthreads();
  }
}

}  // namespace

// steps, lo, hi: int64 (K,) on the card (each value's low 32 bits are its hash
// word); out: int32 (K, rows, n_pos).  The step of lane k is steps[k] + offset.
// recip must be floor((2^32 - 1) / vocab) (kernels/synth.py::vocab_reciprocal).
extern "C" int synth_tokens_fwd(const void* steps, const void* lo, const void* hi, void* out,
                                int K, int rows, int n_pos, long long seed, long long shard,
                                int vocab, unsigned recip, float mix, long long offset,
                                void* stream) {
  if (K <= 0 || rows <= 0 || n_pos < 2 || vocab <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (recip != 0xFFFFFFFFu / static_cast<uint32_t>(vocab))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(K) * rows;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidConfiguration);
  synth_tokens_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(steps), static_cast<const long long*>(lo),
      static_cast<const long long*>(hi), static_cast<int*>(out), rows, n_pos,
      static_cast<uint32_t>(seed), static_cast<uint32_t>(shard), static_cast<uint32_t>(vocab),
      recip, mix, offset);
  return static_cast<int>(cudaGetLastError());
}
