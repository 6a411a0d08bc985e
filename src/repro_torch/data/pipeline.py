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

``HostPrefetcher`` moves host batches onto the device: pinned host tensors
copied with ``non_blocking=True`` so the copy of batch ``s+1`` overlaps the
device work of step ``s``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Sequence, Tuple

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
    (pass per-lane values shaped ``(K, 1)``).
    """
    vocab = int(spec.vocab_size)
    row = np.arange(rows_shape[-1], dtype=np.uint32)
    coords = [spec.seed, stream_lo, stream_hi, step, shard, row]

    def draw(kind, t):
        return _hash_u32(rows_shape, [kind] + coords + [t])

    def tok(kind, t):
        return (draw(kind, t) % np.uint32(vocab)).astype(np.int32)

    mix = np.float32(spec.order_mix)
    toks = np.empty(rows_shape + (spec.seq_len + 1,), np.int32)
    toks[..., 0], toks[..., 1] = tok(_KIND_INIT, 0), tok(_KIND_INIT, 1)
    for t in range(2, spec.seq_len + 1):
        follow = _u01(draw(_KIND_FOLLOW, t)) < mix
        toks[..., t] = np.where(
            follow, _rule32(toks[..., t - 2], toks[..., t - 1], vocab),
            tok(_KIND_NOISE, t))
    return toks


def tokens_to_batch(spec: "SyntheticLM", toks) -> Dict[str, np.ndarray]:
    """``synth_tokens`` output -> the training-batch dict contract
    (``tokens`` int32, ``targets`` int32, ``mask`` float32 ones)."""
    return {
        "tokens": toks[..., :-1],
        "targets": toks[..., 1:].astype(np.int32),
        "mask": np.ones(toks.shape[:-1] + (spec.seq_len,), np.float32),
    }


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    order_mix: float = 0.85  # P(follow the markov rule) vs uniform noise

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
