"""Dispatching wrappers for the kernel layer.

A CUDA tensor always goes to the hand-written kernel; a CPU tensor goes to
the kernel's plain version.  There is no switch that sends the card to a
plain path.  Decode arguments (``q_offset`` / ``kv_len``) take the reference
attention, as in the JAX package: decode is not on the training path.  The
selective scan takes lane-batched ``(K, B, L, .)`` inputs with per-lane ``A``
and ``D`` and flattens ``K * B`` into the kernel's rows; its single-token
decode step is the reference's.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .flash_attention import flash_attention
from .rmsnorm import rmsnorm as _rmsnorm
from .ssm_scan import SSMScan, ssm_scan_fwd


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


def _rows(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.reshape((-1,) + tuple(t.shape[2:])).contiguous()


def ssm_scan(x, dt, A, Bc, Cc, D, h0=None, chunk: int = 128):
    """Mamba-1 selective scan of lane-batched inputs: x, dt (K, B, L, Dm);
    Bc, Cc (K, B, L, N); A (K, Dm, N) and D (K, Dm) fp32, one per lane;
    optional h0 (K, B, Dm, N) fp32.  Returns (y (K, B, L, Dm) in x's dtype,
    h_last (K, B, Dm, N) fp32).  A CUDA tensor goes to the kernel (autograd
    function with the chunked backward; on the meta device the same function,
its forward recording the kernel's cost), a CPU tensor to the plain
version."""
    K, B = x.shape[:2]
    args = (_rows(x), _rows(dt), A.contiguous(), _rows(Bc), _rows(Cc), D.contiguous(),
            _rows(h0))
    if x.is_cuda or x.is_meta:
        y, h = SSMScan.apply(*args, int(chunk))
    else:
        y, h = ssm_scan_fwd(*args, chunk=chunk)
    return y.reshape(x.shape), h.reshape((K, B) + tuple(h.shape[1:]))


def ssm_decode_step(x, dt, A, Bc, Cc, D, h):
    """Single-token state update: x, dt (K, B, Dm); Bc, Cc (K, B, N); h
    (K, B, Dm, N).  The reference, as in the JAX package."""
    y, h_new = ref.ssm_decode_step(_rows(x), _rows(dt), A, _rows(Bc), _rows(Cc), D,
                                   _rows(h))
    return y.reshape(x.shape), h_new.reshape(h.shape)
