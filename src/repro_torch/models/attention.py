"""Attention mixers, lane-batched: GQA (global and sliding-window local)
and MLA (DeepSeek's multi-head latent attention, train / prefill form).

The lanes and the batch fold into the kernel's batch dimension, so the flash
kernel sees ``(K * B, S, heads, head_dim)`` and needs no vmap rule.  MLA
decompresses K and V from its latent and runs the same kernel with a q/k
head dim of ``head_dim + rope_head_dim`` (192 on deepseek-v2-lite) and a v
head dim of ``head_dim`` (128).  Its absorbed decode form comes with the
serving path (ROADMAP.md section 1, item 11.5).
"""
from __future__ import annotations

import math

import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import Params, apply_rmsnorm, dense_init, dtype_of, rmsnorm_init
from .rope import apply_rope


# =============================== GQA ==============================================
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


# =============================== MLA ==============================================
def mla_init(gen, cfg: ModelConfig, device) -> Params:
    pdt = dtype_of(cfg.param_dtype)
    d, H, Dh = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    r, rr = cfg.kv_lora_rank, cfg.rope_head_dim
    return {
        "wq": dense_init(gen, (d, H, Dh + rr), pdt, device, fan_in=d),
        "wkv_a": dense_init(gen, (d, r + rr), pdt, device, fan_in=d),
        "kv_norm": rmsnorm_init(r, pdt, device),
        "wk_b": dense_init(gen, (r, H, Dh), pdt, device, fan_in=r),
        "wv_b": dense_init(gen, (r, H, Dh), pdt, device, fan_in=r),
        "wo": dense_init(gen, (H, Dh, d), pdt, device, fan_in=H * Dh),
    }


def _mla_qkc(p: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """x (K, B, S, d) -> (q_nope (K,B,S,H,Dh), q_rope (K,B,S,H,rr), c (K,B,S,r)
    normed by the per-lane ``kv_norm`` (K, r), k_rope (K,B,S,rr))."""
    Dh, r = cfg.resolved_head_dim, cfg.kv_lora_rank
    q = torch.einsum("kbsd,kdhe->kbshe", x, p["wq"])
    q_nope, q_rope = q[..., :Dh], q[..., Dh:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv = torch.einsum("kbsd,kdr->kbsr", x, p["wkv_a"])
    c, k_rope = ckv[..., :r], ckv[..., r:]
    c = apply_rmsnorm(c, p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta, heads=False)
    return q_nope, q_rope, c, k_rope


def mla_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor) -> torch.Tensor:
    """Train / prefill path: decompress K and V, broadcast ``k_rope`` over the
    heads and run causal attention at q/k width ``Dh + rr``, v width ``Dh``."""
    K, B, S, _ = x.shape
    rr = cfg.rope_head_dim
    q_nope, q_rope, c, k_rope = _mla_qkc(p, x, cfg, positions)
    k_nope = torch.einsum("kbsr,krhe->kbshe", c, p["wk_b"])
    v = torch.einsum("kbsr,krhe->kbshe", c, p["wv_b"])
    k_rope_h = k_rope[:, :, :, None, :].expand(k_nope.shape[:4] + (rr,))
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope_h], dim=-1)
    out = ops.attention(
        q_full.reshape((K * B,) + q_full.shape[2:]),
        k_full.reshape((K * B,) + k_full.shape[2:]),
        v.reshape((K * B,) + v.shape[2:]),
        causal=True,
        scale=1.0 / math.sqrt(cfg.resolved_head_dim + rr),
    )
    out = out.reshape((K, B) + out.shape[1:])
    return torch.einsum("kbshe,khed->kbsd", out, p["wo"])
