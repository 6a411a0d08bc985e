"""GQA attention mixer (global and sliding-window local), lane-batched.

The lanes and the batch fold into the kernel's batch dimension, so the flash
kernel sees ``(K * B, S, heads, head_dim)`` and needs no vmap rule.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import Params, dense_init, dtype_of
from .rope import apply_rope


def gqa_init(gen, cfg: ModelConfig, device) -> Params:
    pdt = dtype_of(cfg.param_dtype)
    d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "wq": dense_init(gen, (d, H, Dh), pdt, device, fan_in=d),
        "wk": dense_init(gen, (d, Hkv, Dh), pdt, device, fan_in=d),
        "wv": dense_init(gen, (d, Hkv, Dh), pdt, device, fan_in=d),
        "wo": dense_init(gen, (H, Dh, d), pdt, device, fan_in=H * Dh),
    }


def gqa_apply(
    p: Params,
    x: torch.Tensor,                     # (K, B, S, d)
    cfg: ModelConfig,
    positions: torch.Tensor,             # (S,)
    *,
    local: bool = False,
) -> torch.Tensor:
    K, B, S, _ = x.shape
    q = torch.einsum("kbsd,kdhe->kbshe", x, p["wq"])
    k = torch.einsum("kbsd,kdhe->kbshe", x, p["wk"])
    v = torch.einsum("kbsd,kdhe->kbshe", x, p["wv"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = ops.attention(
        q.reshape((K * B,) + q.shape[2:]),
        k.reshape((K * B,) + k.shape[2:]),
        v.reshape((K * B,) + v.shape[2:]),
        causal=not cfg.encoder_only,
        window=cfg.sliding_window if local else None,
        softcap=cfg.attn_softcap,
    )
    out = out.reshape((K, B) + out.shape[1:])
    return torch.einsum("kbshe,khed->kbsd", out, p["wo"])
