"""Synthetic token rows: the CUDA kernel and its plain version.

The fused chunked engine makes every step's batch on the device from
``(seed, stream words, step cursor)``.  The plain version is
``repro_torch.data.pipeline.synth_tokens_device`` (PyTorch, masked int64
arithmetic); the kernel (``csrc/synth_tokens.cu``) computes whole rows in
native uint32.  Both are bit-identical to the numpy host path.  A CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises.

This is the port's counterpart of the device branch of the JAX package's
``repro/data/pipeline.py::synth_tokens`` (a ``lax.scan`` over positions
inside the compiled chunk program), not of a Pallas kernel.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from . import build

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
    err = build.library().synth_tokens_fwd(
        words[0].data_ptr(), words[1].data_ptr(), words[2].data_ptr(), out.data_ptr(),
        K, rows, n_pos, int(spec.seed), int(shard), int(spec.vocab_size),
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
