"""Synthetic token rows: the CUDA kernel, its plain version and the plain
helpers of the kernel's algorithm.

The fused chunked engine makes every step's batch on the device from
``(seed, stream words, step cursor)``.  The plain version is
``repro_torch.data.pipeline.synth_tokens_device`` (PyTorch, masked int64
arithmetic); the kernel (``csrc/synth_tokens.cu``) computes whole rows in
native uint32.  Both are bit-identical to the numpy host path.  A CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises.

The kernel splits each row into independent chains of the bigram rule
(``chain_starts``: a rule position whose two predecessors are fixed starts
one) and walks them in parallel, one a thread; its remainder by the
vocabulary is a multiply-high by ``vocab_reciprocal(vocab)``.  Those two
helpers, ``chain_rule_steps`` (the longest chain is the kernel's latency
bound) and ``synth_tokens_chains`` (the kernel's algorithm on the CPU, chains
walked in any order) are plain numpy and Python, so the CPU tests hold the
algorithm where the kernel cannot run.

This is the port's counterpart of the device branch of the JAX package's
``repro/data/pipeline.py::synth_tokens`` (a ``lax.scan`` over positions
inside the compiled chunk program), not of a Pallas kernel.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from . import build

TILE = 2048          # positions a tile of csrc/synth_tokens.cu
_U32 = 0xFFFFFFFF
_HASH_SEED = 0x9E3779B9
_count_lock = threading.Lock()
launches = 0  # kernel launches in this process (plain-version calls excluded)


def reset_launches() -> None:
    global launches
    with _count_lock:
        launches = 0


def _check(steps, stream_lo, stream_hi):
    for name, t in (("steps", steps), ("stream_lo", stream_lo), ("stream_hi", stream_hi)):
        if t.dim() != 1 or t.shape != steps.shape:
            raise ValueError(f"synth_tokens: {name} must be (K,) like steps; got "
                             f"{tuple(t.shape)} against {tuple(steps.shape)}")
        if t.dtype.is_floating_point or t.dtype == torch.bool or t.is_complex():
            raise TypeError(f"synth_tokens: {name} must be an integer tensor, got {t.dtype}")
        if t.device != steps.device:
            raise ValueError("synth_tokens: steps and stream words must lie on one device")


def synth_tokens_plain(spec, steps, stream_lo, stream_hi, offset: int = 0, shard: int = 0):
    """The plain version: int32 (K, global_batch, seq_len + 1)."""
    from ..data.pipeline import synth_tokens_device

    col = lambda t: t.to(torch.int64)[:, None]  # noqa: E731
    return synth_tokens_device(spec, (steps.shape[0], int(spec.global_batch)),
                               col(steps) + int(offset), col(stream_lo), col(stream_hi),
                               shard=int(shard), device=steps.device)


def synth_tokens_cuda(spec, steps, stream_lo, stream_hi, offset: int = 0, shard: int = 0):
    """Launch the kernel on the current stream; raises on what it does not take."""
    global launches
    _check(steps, stream_lo, stream_hi)
    if not steps.is_cuda:
        raise ValueError("synth_tokens: steps and stream words must lie on a CUDA device")
    K, rows, n_pos = steps.shape[0], int(spec.global_batch), int(spec.seq_len) + 1
    out = torch.empty((K, rows, n_pos), dtype=torch.int32, device=steps.device)
    if K == 0:
        return out
    words = [t.to(torch.int64).contiguous() for t in (steps, stream_lo, stream_hi)]
    vocab = int(spec.vocab_size)
    err = build.library().synth_tokens_fwd(
        words[0].data_ptr(), words[1].data_ptr(), words[2].data_ptr(), out.data_ptr(),
        K, rows, n_pos, int(spec.seed), int(shard), vocab, vocab_reciprocal(vocab),
        float(np.float32(spec.order_mix)), int(offset),
        torch.cuda.current_stream(steps.device).cuda_stream)
    build.check(err, "synth_tokens_fwd")
    with _count_lock:
        launches += 1
    return out


def synth_tokens(spec, steps, stream_lo, stream_hi, offset: int = 0, shard: int = 0):
    """Token rows ``(K, global_batch, seq_len + 1)`` int32 of ``spec`` for K
    lanes: lane ``k`` reads the stream whose hash words are ``stream_lo[k]``,
    ``stream_hi[k]`` at step ``steps[k] + offset`` (integer (K,) tensors on
    one device; their values' low 32 bits are the hash words)."""
    if steps.device.type == "cpu":
        _check(steps, stream_lo, stream_hi)
        return synth_tokens_plain(spec, steps, stream_lo, stream_hi, offset, shard)
    if steps.is_cuda:
        return synth_tokens_cuda(spec, steps, stream_lo, stream_hi, offset, shard)
    raise ValueError(f"synth_tokens: no kernel for device {steps.device}")


# -- the kernel's algorithm, plain ------------------------------------------------
def vocab_reciprocal(vocab: int) -> int:
    """``floor((2^32 - 1) / vocab)``, the kernel's reciprocal of the
    vocabulary, formed once a launch.  For every uint32 ``x`` and ``vocab`` in
    (0, 2^31), ``q = (x * recip) >> 32`` is ``floor(x / vocab)`` or one less
    (``recip`` lies within 1 of ``2^32 / vocab``), so ``x - q * vocab`` lies
    in [0, 2 vocab) and one compare settles it (``mod_vocab``)."""
    vocab = int(vocab)
    if not 0 < vocab < 1 << 31:
        raise ValueError(f"synth_tokens: vocab {vocab} must lie in (0, 2^31)")
    return _U32 // vocab


def mod_vocab(x, vocab: int, recip: int):
    """``x % vocab`` for uint32 ``x`` (an int or an integer array) as the
    kernel computes it from ``recip = vocab_reciprocal(vocab)``: a
    multiply-high, a multiply-subtract and ``min(r, r - vocab)`` in uint32."""
    xs = np.asarray(x, dtype=np.uint64)
    r = (xs - ((xs * np.uint64(recip)) >> np.uint64(32)) * np.uint64(vocab)) & np.uint64(_U32)
    wrapped = (r + np.uint64(1 << 32) - np.uint64(vocab)) & np.uint64(_U32)   # r - vocab
    r = np.minimum(r, wrapped).astype(np.uint32)
    return int(r) if np.ndim(x) == 0 else r


def rule_positions(spec, steps, stream_lo, stream_hi, offset: int = 0, shard: int = 0):
    """bool (K, global_batch, seq_len + 1): True where the bigram rule decides
    the token (position t >= 2 whose FOLLOW draw falls below ``order_mix``)
    for lane k's stream words and cursor ``steps[k] + offset`` (integer (K,)
    arrays; their low 32 bits are the hash words)."""
    from ..data import pipeline as dp

    lo, hi, st = (np.asarray(w, dtype=np.int64) for w in (stream_lo, stream_hi, steps))
    rows, n_pos = int(spec.global_batch), int(spec.seq_len) + 1
    col = lambda w: (w[:, None, None] & _U32).astype(np.uint32)  # noqa: E731
    h = dp._hash_u32((st.shape[0], rows, n_pos),
                     [dp._KIND_FOLLOW, int(spec.seed), col(lo), col(hi), col(st + int(offset)),
                      int(shard), np.arange(rows, dtype=np.uint32)[None, :, None],
                      np.arange(n_pos, dtype=np.uint32)[None, None, :]])
    rule = dp._u01(h) < np.float32(spec.order_mix)
    rule[..., :2] = False
    return rule


def chain_starts(rule: np.ndarray, tile: Optional[int] = TILE) -> np.ndarray:
    """bool like ``rule``: the rule positions whose two predecessors are fixed
    (not decided by the rule).  With ``tile``, a predecessor in an earlier tile
    of the kernel counts as fixed: that tile is resolved before the next one
    starts.  Each start begins a chain that runs to the next start."""
    rule = np.asarray(rule, dtype=bool)
    t = np.arange(rule.shape[-1])
    first = (t // tile) * tile if tile else np.zeros_like(t)
    fixed = ~rule
    before1 = np.concatenate([np.ones_like(fixed[..., :1]), fixed[..., :-1]], -1)
    before2 = np.concatenate([np.ones_like(fixed[..., :2]), fixed[..., :-2]], -1)
    return rule & (before1 | (t - 1 < first)) & (before2 | (t - 2 < first))


def chain_rule_steps(rule: np.ndarray, tile: Optional[int] = TILE) -> np.ndarray:
    """int64 like ``rule``: at each chain start, the chain's dependent rule
    steps (its rule positions, up to the next start); 0 elsewhere.  The row's
    largest entry is the kernel's critical path in rule steps."""
    rule = np.asarray(rule, dtype=bool)
    starts = chain_starts(rule, tile)
    flat_rule = rule.reshape(-1, rule.shape[-1])
    flat_starts = starts.reshape(flat_rule.shape)
    ids = np.cumsum(flat_starts, axis=-1)   # the chain a position belongs to, per row
    out = np.zeros(flat_rule.shape, dtype=np.int64)
    for r in range(flat_rule.shape[0]):
        counts = np.bincount(ids[r][flat_rule[r]], minlength=int(ids[r, -1]) + 1)
        out[r, flat_starts[r]] = counts[1:]
    return out.reshape(rule.shape)


def _mix(h: int, w: int) -> int:
    h ^= (w * 0xCC9E2D51) & _U32
    h = ((h << 13) | (h >> 19)) & _U32
    return (h * 5 + 0xE6546B64) & _U32


def _finalize(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _U32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _U32
    return h ^ (h >> 16)


def _walk_chain(tile: list, s: int, a: int, b: int, vocab: int, recip: int) -> None:
    """``csrc/synth_tokens.cu::walk_chain`` in Python ints: the chain from rule
    position ``s`` (``tok[s-2], tok[s-1] = a, b``, fixed), written into
    ``tile`` (-1 marks a rule position)."""
    n = len(tile)
    h, ha, p = _mix(_mix(_HASH_SEED, a), b), _mix(_HASH_SEED, b), s
    while True:
        n1 = tile[p + 1] if p + 1 < n else 0
        n2 = tile[p + 2] if p + 2 < n else 0
        r = mod_vocab(_finalize(h), vocab, recip)
        tile[p] = r
        gap = n1 >= 0
        if p + 1 >= n or (gap and (p + 2 >= n or n2 >= 0)):
            return
        h = _mix(_HASH_SEED if gap else ha, r)
        if gap:
            h = _mix(h, n1)
        ha = _mix(_HASH_SEED, n1 if gap else r)
        p += 2 if gap else 1


def synth_tokens_chains(spec, steps, stream_lo, stream_hi, offset: int = 0, shard: int = 0,
                        tile: Optional[int] = TILE, order=None) -> np.ndarray:
    """The kernel's algorithm on the CPU: int32 (K, global_batch, seq_len + 1),
    equal bit for bit to the plain version.  The draws are made at once
    (remainders through ``mod_vocab``); then, tile by tile, each row's chains
    are walked one after another in the order ``order(starts)`` gives (a
    list of the tile's start positions; by default ascending), each as the
    kernel's thread walks it.  ``tile=None`` walks a whole row as one tile."""
    from ..data import pipeline as dp

    vocab = int(spec.vocab_size)
    recip = vocab_reciprocal(vocab)
    lo, hi, st = (np.asarray(w, dtype=np.int64) for w in (stream_lo, stream_hi, steps))
    K, rows, n_pos = st.shape[0], int(spec.global_batch), int(spec.seq_len) + 1
    col = lambda w: (w[:, None, None] & _U32).astype(np.uint32)  # noqa: E731
    coords = [int(spec.seed), col(lo), col(hi), col(st + int(offset)), int(shard),
              np.arange(rows, dtype=np.uint32)[None, :, None],
              np.arange(n_pos, dtype=np.uint32)[None, None, :]]
    shape = (K, rows, n_pos)
    init = mod_vocab(dp._hash_u32(shape, [dp._KIND_INIT] + coords), vocab, recip)
    noise = mod_vocab(dp._hash_u32(shape, [dp._KIND_NOISE] + coords), vocab, recip)
    rule = rule_positions(spec, st, lo, hi, offset, shard)
    toks = np.where(rule, -1, noise.astype(np.int64))
    toks[..., :2] = init[..., :2]
    tile = tile or n_pos
    for k in range(K):
        for r in range(rows):
            row = toks[k, r]
            for t0 in range(0, n_pos, tile):
                part = [int(x) for x in row[t0:t0 + tile]]
                starts = np.flatnonzero(chain_starts(np.asarray(part) < 0, None)).tolist()
                for s in (order(starts) if order else starts):
                    tok = lambda j: part[j] if j >= 0 else int(row[t0 + j])  # noqa: E731
                    _walk_chain(part, s, tok(s - 2), tok(s - 1), vocab, recip)
                row[t0:t0 + tile] = part
    return toks.astype(np.int32)
