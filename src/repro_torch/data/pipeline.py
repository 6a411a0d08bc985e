"""Deterministic synthetic data pipeline (host side) and the device feed.

Language modeling: a seeded 2nd-order Markov token stream — structured enough
that a model visibly learns (loss drops from ln(V) toward the process
entropy), cheap enough for smoke training, and exactly reproducible from
``(seed, stream, step)`` so a trial replays the *same* batch sequence (the
data cursor is just the step counter).

**Counter-based synthesis.** Every random draw is a pure function of its
coordinates — ``hash(kind, seed, stream, step, shard, row, position)`` over
32-bit integer arithmetic (xor / rotate / wrapping multiply) in NumPy.  There
is no sequential PRNG state: a batch at ``(stream, step)`` never depends on
any other batch having been drawn.  The generator is bit-identical to the JAX
package's host path, so both packages train on the same tokens.

Per-trial streams (population HPO): ``stream`` is two extra hash words so
every trial of a population consumes an *independent* data sequence;
``make_population_batch`` stacks K such batches along a leading population
axis.  Negative streams are reserved sentinels (padding population lanes):
they wrap to the top of the u64 range, far from any real trial stream.

**Device synthesis.** The same generator also runs in PyTorch on the
tensors' own device (``synth_tokens_device``, ``synth_population_batch_device``):
the fused chunked engine (``repro_torch.train.population.
make_population_scan_step``) makes each step's batch from ``(seed, stream
words, step cursor)`` without a host round trip, bit-identical to the numpy
path.  The plain PyTorch version does the uint32 arithmetic in int64 with a
32-bit mask after every multiply, add and left shift (products by 16-bit
halves of the constant, so no intermediate leaves int64); on the card the
token recurrence runs as one kernel, ``repro_torch.kernels.synth``.

``HostPrefetcher`` moves host batches onto the device: pinned host tensors
copied with ``non_blocking=True`` so the copy of batch ``s+1`` overlaps the
device work of step ``s``.  ``HostDataset`` is what the prefetch ring
(``repro_torch.data.ring``) reads: ``SynthHostDataset`` over this stream,
``ArrayHostDataset`` over a token array in host memory.

Classification: ``SyntheticClassification``, the paper's §IV MNIST
stand-in that ``train/cnn.py`` trains on, a numpy copy of the JAX
package's, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Protocol, Sequence, Tuple

import numpy as np
import torch

_U64 = 0xFFFFFFFFFFFFFFFF
_U32 = 0xFFFFFFFF

# draw kinds: the leading hash word, so the three per-position draw families
# (initial tokens / follow-the-rule uniforms / noise tokens) never collide
_KIND_INIT = 0xA11CE
_KIND_FOLLOW = 0xF0110
_KIND_NOISE = 0x707E5


def _rotl13(h):
    return (h << np.uint32(13)) | (h >> np.uint32(19))


def _hash_u32(shape, words) -> np.ndarray:
    """Combine integer ``words`` (scalars or arrays broadcastable against
    ``shape`` — pre-expand trailing dims yourself) into one uint32 hash.

    murmur3-style combine + finalizer over pure uint32 ops (xor, rotate,
    wrapping ``*``/``+``, logical shifts).
    """
    u = np.uint32
    h = np.full(shape, 0x9E3779B9, dtype=np.uint32)
    for w in words:
        if isinstance(w, (int, np.integer)):
            w = np.uint32(int(w) & _U32)
        w = np.broadcast_to(np.asarray(w).astype(np.uint32), shape)
        h = h ^ (w * u(0xCC9E2D51))
        h = _rotl13(h)
        h = h * u(5) + u(0xE6546B64)
    h = h ^ (h >> u(16))
    h = h * u(0x85EBCA6B)
    h = h ^ (h >> u(13))
    h = h * u(0xC2B2AE35)
    h = h ^ (h >> u(16))
    return h


def _u01(h):
    """uint32 hash -> float32 uniform in [0, 1): the top 24 bits scaled by
    2^-24, exact in float32."""
    return (h >> np.uint32(8)).astype(np.float32) * np.float32(2.0 ** -24)


def _rule32(a, b, vocab: int):
    """Fixed pseudo-random bigram successor function (the Markov 'language'),
    independent of seed/stream/step: it is the process being learned."""
    h = _hash_u32(a.shape, [a.astype(np.uint32), b.astype(np.uint32)])
    return (h % np.uint32(vocab)).astype(np.int32)


def split_stream(stream: int) -> Tuple[int, int]:
    """A (possibly negative, possibly 64-bit) stream id as two uint32 hash
    words.  Negative sentinels wrap to the top of the u64 range."""
    s = int(stream) & _U64
    return s & _U32, (s >> 32) & _U32


def split_streams(streams: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized ``split_stream``: two uint32[K] word arrays."""
    pairs = [split_stream(s) for s in streams]
    return (np.asarray([p[0] for p in pairs], np.uint32),
            np.asarray([p[1] for p in pairs], np.uint32))


def synth_tokens(spec: "SyntheticLM", rows_shape, step, stream_lo,
                 stream_hi, shard=0) -> np.ndarray:
    """The pure generator: int32 tokens of shape ``rows_shape + (seq_len+1,)``.

    ``rows_shape`` is the batch-rows shape (``(b,)`` for one batch,
    ``(K, b)`` for a population); ``step`` / ``stream_lo`` / ``stream_hi`` /
    ``shard`` are integers or arrays broadcastable against ``rows_shape``
    (pass per-lane values shaped ``(K, 1)``).  The draws of every position
    depend only on their coordinates, so they are made for all positions at
    once; only the bigram rule runs position by position.
    """
    vocab = int(spec.vocab_size)
    rows_shape = tuple(rows_shape)
    n_pos = int(spec.seq_len) + 1
    expand = lambda w: w if isinstance(w, (int, np.integer)) else np.asarray(w)[..., None]  # noqa: E731
    row = np.arange(rows_shape[-1], dtype=np.uint32)[:, None]
    coords = [spec.seed, expand(stream_lo), expand(stream_hi), expand(step), expand(shard),
              row]

    def draw(kind, lo, hi):
        pos = np.arange(lo, hi, dtype=np.uint32)
        return _hash_u32(rows_shape + (hi - lo,), [kind] + coords + [pos])

    mix = np.float32(spec.order_mix)
    toks = np.empty(rows_shape + (n_pos,), np.int32)
    toks[..., :2] = (draw(_KIND_INIT, 0, 2) % np.uint32(vocab)).astype(np.int32)
    follow = _u01(draw(_KIND_FOLLOW, 2, n_pos)) < mix
    noise = (draw(_KIND_NOISE, 2, n_pos) % np.uint32(vocab)).astype(np.int32)
    for t in range(2, n_pos):
        toks[..., t] = np.where(follow[..., t - 2],
                                _rule32(toks[..., t - 2], toks[..., t - 1], vocab),
                                noise[..., t - 2])
    return toks


# -- the same generator in PyTorch ------------------------------------------------
#
# uint32 values live in int64 tensors; every multiply, add and left shift is
# masked back to 32 bits.  ``_mul32`` multiplies by the 16-bit halves of the
# constant, so no product exceeds 2^48 and nothing relies on signed wrap.


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2^32`` for ``h`` in [0, 2^32) and a constant ``c``."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _words_t(w, shape, device) -> torch.Tensor:
    """A hash word (int or integer tensor, broadcastable against ``shape``)
    as its low 32 bits in an int64 tensor of ``shape``."""
    if isinstance(w, (int, np.integer)):
        return torch.full(shape, int(w) & _U32, dtype=torch.int64, device=device)
    return torch.broadcast_to(w.to(torch.int64) & _U32, shape)


def _hash_u32_t(shape, words, device) -> torch.Tensor:
    """``_hash_u32`` on tensors: the same murmur3-style combine and finalizer,
    bit for bit, in masked int64."""
    h = torch.full(shape, 0x9E3779B9, dtype=torch.int64, device=device)
    for w in words:
        h = h ^ _mul32(_words_t(w, shape, device), 0xCC9E2D51)
        h = ((h << 13) & _U32) | (h >> 19)
        h = (h * 5 + 0xE6546B64) & _U32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _u01_t(h: torch.Tensor) -> torch.Tensor:
    """``_u01`` on tensors: the top 24 bits as float32, times 2^-24."""
    return (h >> 8).to(torch.float32) * (2.0 ** -24)


def _rule32_t(a: torch.Tensor, b: torch.Tensor, vocab: int) -> torch.Tensor:
    """``_rule32`` on tensors (int32 tokens in, int32 tokens out)."""
    return (_hash_u32_t(a.shape, [a, b], a.device) % vocab).to(torch.int32)


def synth_tokens_device(spec: "SyntheticLM", rows_shape, step, stream_lo,
                        stream_hi, shard=0, device="cpu") -> torch.Tensor:
    """``synth_tokens`` in plain PyTorch on ``device``: int32 tokens of shape
    ``rows_shape + (seq_len+1,)``, bit-identical to the numpy path.

    ``step`` / ``stream_lo`` / ``stream_hi`` / ``shard`` are ints or integer
    tensors broadcastable against ``rows_shape`` (per-lane values shaped
    ``(K, 1)``); a tensor carries its values' low 32 bits.  The draws of every
    position depend only on their coordinates, so they are made for all
    positions at once; only the bigram rule runs position by position.
    """
    vocab = int(spec.vocab_size)
    rows_shape = tuple(rows_shape)
    n_pos = int(spec.seq_len) + 1
    expand = lambda w: w if isinstance(w, (int, np.integer)) else w[..., None]  # noqa: E731
    row = torch.arange(rows_shape[-1], dtype=torch.int64, device=device)[:, None]
    coords = [int(spec.seed), expand(stream_lo), expand(stream_hi), expand(step),
              expand(shard), row]

    def draw(kind, lo, hi):
        pos = torch.arange(lo, hi, dtype=torch.int64, device=device)
        return _hash_u32_t(rows_shape + (hi - lo,), [kind] + coords + [pos], device)

    toks = torch.empty(rows_shape + (n_pos,), dtype=torch.int32, device=device)
    toks[..., :2] = (draw(_KIND_INIT, 0, 2) % vocab).to(torch.int32)
    follow = _u01_t(draw(_KIND_FOLLOW, 2, n_pos)) < float(np.float32(spec.order_mix))
    noise = (draw(_KIND_NOISE, 2, n_pos) % vocab).to(torch.int32)
    for t in range(2, n_pos):
        toks[..., t] = torch.where(
            follow[..., t - 2], _rule32_t(toks[..., t - 2], toks[..., t - 1], vocab),
            noise[..., t - 2])
    return toks


def tokens_to_batch(spec: "SyntheticLM", toks) -> Dict[str, np.ndarray]:
    """``synth_tokens`` output -> the training-batch dict contract
    (``tokens`` int32, ``targets`` int32, ``mask`` float32 ones)."""
    return {
        "tokens": toks[..., :-1],
        "targets": toks[..., 1:].astype(np.int32),
        "mask": np.ones(toks.shape[:-1] + (spec.seq_len,), np.float32),
    }


def tokens_to_batch_device(spec: "SyntheticLM", toks: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``tokens_to_batch`` for a token tensor on its device; ``tokens`` and
    ``targets`` are contiguous, like the host path's copies."""
    return {
        "tokens": toks[..., :-1].contiguous(),
        "targets": toks[..., 1:].contiguous(),
        "mask": torch.ones(toks.shape[:-1] + (spec.seq_len,), dtype=torch.float32,
                           device=toks.device),
    }


def synth_batch_device(spec: "SyntheticLM", stream_lo: torch.Tensor,
                       stream_hi: torch.Tensor, step: torch.Tensor,
                       offset: int = 0) -> Dict[str, torch.Tensor]:
    """One training batch ``(global_batch, seq_len)`` on the tensors' device
    for one stream: ``stream_lo``/``stream_hi`` are its two hash words (see
    ``split_stream``) and ``step + offset`` the cursor, each a 0-d or (1,)
    integer tensor.  Bit-identical to ``make_batch(step + offset,
    stream=stream)``; the shared-stream twin of
    ``synth_population_batch_device``."""
    from ..kernels.synth import synth_tokens

    toks = synth_tokens(spec, step.reshape(1), stream_lo.reshape(1),
                        stream_hi.reshape(1), offset=offset)
    return tokens_to_batch_device(spec, toks[0])


def synth_population_batch_device(spec: "SyntheticLM", stream_lo: torch.Tensor,
                                  stream_hi: torch.Tensor, steps: torch.Tensor,
                                  offset: int = 0) -> Dict[str, torch.Tensor]:
    """K per-lane batches ``(K, global_batch, seq_len)`` on the tensors'
    device, from per-lane stream words (integer (K,), see ``split_streams``)
    and per-lane step cursors (integer (K,)) advanced by ``offset``.  Lane
    ``i``'s slab is bit-identical to ``make_batch(steps[i] + offset,
    stream=streams[i])``.  On the card the tokens come from the
    ``synth_tokens`` kernel, on the CPU from ``synth_tokens_device``."""
    from ..kernels.synth import synth_tokens

    return tokens_to_batch_device(spec, synth_tokens(spec, steps, stream_lo, stream_hi,
                                                     offset=offset))


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    order_mix: float = 0.85  # P(follow the markov rule) vs uniform noise

    @property
    def spec_key(self) -> Tuple:
        """Hashable identity of the generator — keys the chunk-program cache
        (a chunk program bakes the batch synthesis in, so it is specific to
        this exact stream definition)."""
        return (int(self.vocab_size), int(self.seq_len),
                int(self.global_batch), int(self.seed), float(self.order_mix))

    def make_batch(self, step: int, shard: int = 0, n_shards: int = 1,
                   stream: int = 0) -> Dict[str, np.ndarray]:
        """One host batch as a pure function of ``(stream, step)``; with
        ``n_shards`` it is shard ``shard``'s slice of the global batch."""
        assert self.global_batch % n_shards == 0
        b = self.global_batch // n_shards
        lo, hi = split_stream(stream)
        toks = synth_tokens(self, (b,), int(step), lo, hi, shard=int(shard))
        return tokens_to_batch(self, toks)

    def make_population_batch(self, step, streams: Sequence[int]
                              ) -> Dict[str, np.ndarray]:
        """K independent per-trial batches stacked on a leading population
        axis: leaf shapes ``(K, batch, ...)``, lane ``i`` reading stream
        ``streams[i]``.  ``step`` is one int (all lanes at the same cursor)
        or one int per lane."""
        steps = [int(step)] * len(streams) if np.isscalar(step) \
            else [int(s) for s in step]
        assert len(steps) == len(streams)
        lo, hi = split_streams(streams)
        st = np.asarray(steps, np.int64)[:, None]
        toks = synth_tokens(self, (len(streams), self.global_batch), st,
                            lo[:, None], hi[:, None])
        return tokens_to_batch(self, toks)


class HostDataset(Protocol):
    """What the prefetch ring (``repro_torch.data.ring``) needs from a host
    data source.

    One method: a *lane block*, per-lane token rows for K population lanes,
    each lane at its own step cursor, shaped ``(K, batch, seq_len + 1)``
    int32 (the raw ``synth_tokens`` layout; ``tokens_to_batch_device`` splits
    it into tokens/targets/mask on the device).  Implementations must be
    pure functions of ``(streams, steps)`` so a crash-restored flight
    replays the same bytes.
    """

    seq_len: int
    global_batch: int

    def lane_block(self, streams: Sequence[int], steps) -> np.ndarray:
        """Token rows ``(K, global_batch, seq_len + 1)`` int32 for lane ``i``
        reading ``streams[i]`` at step ``steps[i]``."""
        ...

    # Implementations may also provide
    #     lane_window(streams, steps, n) -> (n, K, global_batch, seq_len + 1)
    # n consecutive lane blocks in one vectorized call, bit-identical to
    # stacking ``lane_block`` per step; the ring's fill thread prefers it.


@dataclasses.dataclass
class SynthHostDataset:
    """``HostDataset`` over the counter-based synthetic stream: the ring's
    bit-equality oracle.  ``lane_block`` evaluates the same ``synth_tokens``
    the chunk programs run on the device, so a ring filled from this adapter
    reproduces in-chunk synthesis bit for bit."""

    spec: SyntheticLM

    @property
    def seq_len(self) -> int:
        return int(self.spec.seq_len)

    @property
    def global_batch(self) -> int:
        return int(self.spec.global_batch)

    def lane_block(self, streams: Sequence[int], steps) -> np.ndarray:
        lo, hi = split_streams(streams)
        st = np.asarray([int(s) for s in steps], np.int64)
        return synth_tokens(self.spec, (len(streams), self.global_batch), st[:, None],
                            lo[:, None], hi[:, None])

    def lane_window(self, streams: Sequence[int], steps, n: int) -> np.ndarray:
        """``n`` consecutive ``lane_block`` slabs (steps ``steps[i] + t`` for
        ``t in [0, n)``) in one vectorized synthesis call, shape ``(n, K,
        global_batch, seq_len + 1)``; bit-identical to stacking
        ``lane_block`` per step."""
        lo, hi = split_streams(streams)
        st = np.asarray([int(s) for s in steps], np.int64)
        step = st[None, :, None] + np.arange(int(n), dtype=np.int64)[:, None, None]
        return synth_tokens(self.spec, (int(n), len(streams), self.global_batch), step,
                            lo[None, :, None], hi[None, :, None])


@dataclasses.dataclass
class ArrayHostDataset:
    """``HostDataset`` over a token corpus held in host memory: a ``(n_rows,
    seq_len + 1)`` int32 array (e.g. a memory-mapped tokenized shard).  Lane
    ``i`` at step ``s`` reads ``global_batch`` consecutive rows from ``(streams[i]
    * stream_stride + s * global_batch) % n_rows``: per-trial streams start
    at disjoint offsets and the cursor is the step counter, so a resume
    replays the same rows."""

    tokens: np.ndarray
    global_batch: int
    stream_stride: int = 997

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int32)
        if self.tokens.ndim != 2 or len(self.tokens) == 0:
            raise ValueError(f"ArrayHostDataset: tokens must be a non-empty (n_rows, "
                             f"seq_len + 1) array, got shape {self.tokens.shape}")

    @property
    def seq_len(self) -> int:
        return int(self.tokens.shape[1]) - 1

    def lane_block(self, streams: Sequence[int], steps) -> np.ndarray:
        n = len(self.tokens)
        b = int(self.global_batch)
        out = np.empty((len(streams), b, self.tokens.shape[1]), np.int32)
        for i, (stream, step) in enumerate(zip(streams, steps)):
            start = (int(stream) * self.stream_stride + int(step) * b) % n
            out[i] = self.tokens[(start + np.arange(b)) % n]
        return out

    def lane_window(self, streams: Sequence[int], steps, n: int) -> np.ndarray:
        """``n`` consecutive ``lane_block`` slabs in one gather, shape ``(n,
        K, global_batch, seq_len + 1)``."""
        nrows = len(self.tokens)
        b = int(self.global_batch)
        sid = np.asarray([int(s) for s in streams], np.int64)
        st = np.asarray([int(s) for s in steps], np.int64)
        step = st[None, :] + np.arange(int(n), dtype=np.int64)[:, None]
        start = sid[None, :] * self.stream_stride + step * b
        return self.tokens[(start[..., None] + np.arange(b)) % nrows]


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Host batch -> tensors on ``device``.  A CUDA copy goes through pinned
    memory with ``non_blocking=True``: it is ordered on the current stream
    ahead of the step that reads it, and the host returns at once."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


class HostPrefetcher:
    """Prefetch-ahead feed for the serial driver: build batch ``s+1`` and
    start its copy to the device while step ``s`` is still running, before
    the driver blocks on step ``s``'s loss.  Batches are byte-identical to the
    direct ``make_batch`` path; only the timing of the host work moves.
    """

    def __init__(self, build: Callable[[int], Dict[str, np.ndarray]], device):
        self._build = build  # step -> host batch (dict of numpy arrays)
        self._device = device
        self._next: Any = None  # (step, device batch) or None

    def _put(self, step: int):
        return to_device(self._build(step), self._device)

    def prefetch(self, step: int) -> None:
        """Stage batch ``step`` on the device ahead of time."""
        self._next = (step, self._put(step))

    def pop(self, step: int):
        """The batch for ``step``: the staged one if it matches, else built
        on the spot."""
        if self._next is not None and self._next[0] == step:
            batch = self._next[1]
            self._next = None
            return batch
        self._next = None
        return self._put(step)


@dataclasses.dataclass
class SyntheticClassification:
    """Template-plus-noise image classification (paper §IV's MNIST stand-in).

    Each class has a fixed random template; samples are template + Gaussian
    noise.  Accuracy responds smoothly to model capacity / lr / dropout, so
    HPO curves (paper Fig. 5) are meaningful.
    """

    n_classes: int = 10
    image_size: int = 16
    noise: float = 5.0
    seed: int = 7

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # spatially smooth class templates (low-frequency random fields):
        # conv + pooling layers can pick these up; white-noise templates would
        # make the task adversarial to exactly the architectures being tuned
        coarse = rng.standard_normal((self.n_classes, 4, 4)).astype(np.float32)
        up = self.image_size // 4
        smooth = np.kron(coarse, np.ones((1, up, up), np.float32))
        # light blur across pixels to avoid blocky edges
        smooth = (smooth + np.roll(smooth, 1, 1) + np.roll(smooth, 1, 2)
                  + np.roll(smooth, -1, 1) + np.roll(smooth, -1, 2)) / 5.0
        self.templates = (2.0 * smooth[..., None]).astype(np.float32)

    def make_split(self, n: int, seed: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(seed)
        labels = rng.integers(self.n_classes, size=n)
        x = self.templates[labels] + self.noise * rng.standard_normal(
            (n, self.image_size, self.image_size, 1)
        ).astype(np.float32)
        return {"x": x.astype(np.float32), "y": labels.astype(np.int32)}
