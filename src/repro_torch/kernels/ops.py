"""Dispatching wrappers for the kernel layer.

A CUDA tensor always goes to the hand-written kernel; a CPU tensor goes to
the kernel's plain version.  There is no switch that sends the card to a
plain path.  Decode arguments (``q_offset`` / ``kv_len``) take the reference
attention, as in the JAX package: decode is not on the training path.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .flash_attention import flash_attention
from .rmsnorm import rmsnorm as _rmsnorm


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of a lane-batched ``x (K, ..., d)`` with per-lane ``gamma (K, d)``."""
    K, d = x.shape[0], x.shape[-1]
    return _rmsnorm(x.reshape(K, -1, d).contiguous(), gamma.contiguous(),
                    eps).reshape(x.shape)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
    kv_len=None,
) -> torch.Tensor:
    """q (B, Sq, H, D), k (B, Sk, Hkv, D), v (B, Sk, Hkv, Dv) -> (B, Sq, H, Dv)."""
    if kv_len is not None or q_offset != 0:
        return ref.attention(q, k, v, causal=causal, window=window, softcap=softcap,
                             scale=scale, q_offset=q_offset, kv_len=kv_len)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window, softcap=softcap, scale=scale)
