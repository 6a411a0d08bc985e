"""Attention mixers, lane-batched: GQA (global and sliding-window local)
and MLA (DeepSeek's multi-head latent attention).

The lanes and the batch fold into the kernel's batch dimension, so the flash
kernel sees ``(K * B, S, heads, head_dim)`` and needs no vmap rule.  MLA
decompresses K and V from its latent and runs the same kernel with a q/k
head dim of ``head_dim + rope_head_dim`` (192 on deepseek-v2-lite) and a v
head dim of ``head_dim`` (128).

Decode writes one position of a per-layer cache in place, at ``pos``:

* GQA caches (k, v), each ``(K, B, max_seq, n_kv, head_dim)``, and attends
  through the reference attention with ``q_offset=pos, kv_len=pos + 1``, as
  the JAX package does (no flash kernel at decode);
* MLA caches the compressed latent ``c (K, B, max_seq, r)`` and the shared
  ``kr (K, B, max_seq, rope_head_dim)`` and runs the absorbed form: ``wk_b``
  folded into q, scores against the latent, all in fp32.
"""
from __future__ import annotations

import math

import torch

from ..configs.base import ModelConfig
from ..distributed.sharding import tp_enter, tp_reduce
from ..kernels import ops, ref
from .layers import Params, Specs, apply_rmsnorm, dense_init, dtype_of, einsum, rmsnorm_init
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


def gqa_specs(cfg: ModelConfig) -> Specs:
    return {"wq": ("embed", "heads", "head"), "wk": ("embed", "kv_heads", "head"),
            "wv": ("embed", "kv_heads", "head"), "wo": ("heads", "head", "embed")}


def gqa_apply(
    p: Params,
    x: torch.Tensor,                     # (K, B, S, d)
    cfg: ModelConfig,
    positions: torch.Tensor,             # (S,)
    *,
    local: bool = False,
) -> torch.Tensor:
    # on a two-level mesh the heads shard over the row: q, k, v are
    # column-parallel (their input through tp_enter), wo row-parallel
    K, B, S, _ = x.shape
    xs = tp_enter(x, "attn")
    q = einsum("kbsd,kdhe->kbshe", xs, p["wq"])
    k = einsum("kbsd,kdhe->kbshe", xs, p["wk"])
    v = einsum("kbsd,kdhe->kbshe", xs, p["wv"])
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
    return tp_reduce(einsum("kbshe,khed->kbsd", out, p["wo"]), "attn")


def gqa_cache_init(cfg: ModelConfig, K: int, batch: int, max_seq: int, dtype,
                   device) -> Params:
    shape = (K, batch, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_cache_specs(cfg: ModelConfig) -> Specs:
    return {"k": ("batch", "cache_seq", "kv_heads", "head"),
            "v": ("batch", "cache_seq", "kv_heads", "head")}


def gqa_decode(p: Params, x: torch.Tensor, cache: Params, pos: int, cfg: ModelConfig, *,
               local: bool = False):
    """x (K, B, 1, d) at position ``pos`` -> (y (K, B, 1, d), cache): k and v
    written into the cache at ``pos`` in place, the same tree returned."""
    K, B = x.shape[:2]
    q = einsum("kbsd,kdhe->kbshe", x, p["wq"])
    k = einsum("kbsd,kdhe->kbshe", x, p["wk"])
    v = einsum("kbsd,kdhe->kbshe", x, p["wv"])
    positions = torch.full((1,), pos, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    ck[:, :, pos] = k[:, :, 0]
    cv[:, :, pos] = v[:, :, 0]
    out = ops.attention(
        q.reshape((K * B,) + q.shape[2:]),
        ck.reshape((K * B,) + ck.shape[2:]),
        cv.reshape((K * B,) + cv.shape[2:]),
        causal=True,
        window=cfg.sliding_window if local else None,
        softcap=cfg.attn_softcap,
        q_offset=pos,
        kv_len=pos + 1,
    )
    out = out.reshape((K, B) + out.shape[1:])
    return einsum("kbshe,khed->kbsd", out, p["wo"]), cache


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


def mla_specs(cfg: ModelConfig) -> Specs:
    return {"wq": ("embed", "heads", "head"), "wkv_a": ("embed", None), "kv_norm": (None,),
            "wk_b": (None, "heads", "head"), "wv_b": (None, "heads", "head"),
            "wo": ("heads", "head", "embed")}


def _mla_qkc(p: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """x (K, B, S, d) -> (q_nope (K,B,S,H,Dh), q_rope (K,B,S,H,rr), c (K,B,S,r)
    normed by the per-lane ``kv_norm`` (K, r), k_rope (K,B,S,rr))."""
    Dh, r = cfg.resolved_head_dim, cfg.kv_lora_rank
    # wq is head-sharded on a two-level mesh, so its input enters through
    # the seam; wkv_a and kv_norm are replicated and take the raw x (through
    # the seam their gradient would be counted width times)
    q = einsum("kbsd,kdhe->kbshe", tp_enter(x, "attn"), p["wq"])
    q_nope, q_rope = q[..., :Dh], q[..., Dh:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv = einsum("kbsd,kdr->kbsr", x, p["wkv_a"])
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
    # replicated activations feeding head-sharded consumers: their
    # head-local partial gradients sum over the row before the replicated
    # wkv_a / kv_norm branch takes them
    c = tp_enter(c, "attn")
    k_rope = tp_enter(k_rope, "attn")
    k_nope = einsum("kbsr,krhe->kbshe", c, p["wk_b"])
    v = einsum("kbsr,krhe->kbshe", c, p["wv_b"])
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
    return tp_reduce(einsum("kbshe,khed->kbsd", out, p["wo"]), "attn")


def mla_cache_init(cfg: ModelConfig, K: int, batch: int, max_seq: int, dtype,
                   device) -> Params:
    return {"c": torch.zeros((K, batch, max_seq, cfg.kv_lora_rank), dtype=dtype,
                             device=device),
            "kr": torch.zeros((K, batch, max_seq, cfg.rope_head_dim), dtype=dtype,
                              device=device)}


def mla_cache_specs(cfg: ModelConfig) -> Specs:
    return {"c": ("batch", "cache_seq", None), "kr": ("batch", "cache_seq", None)}


def mla_decode(p: Params, x: torch.Tensor, cache: Params, pos: int, cfg: ModelConfig):
    """Absorbed MLA decode, x (K, B, 1, d) -> (y (K, B, 1, d), cache): the
    latent and ``k_rope`` written at ``pos`` in place; q taken into the
    latent space through ``wk_b``, scores against every cached latent plus
    ``q_rope . kr``, masked to ``s <= pos``, and the softmax's latent mix
    taken out through ``wv_b``, all in fp32; then ``wo``."""
    positions = torch.full((1,), pos, device=x.device)
    q_nope, q_rope, c_new, kr_new = _mla_qkc(p, x, cfg, positions)
    cc, ckr = cache["c"], cache["kr"]
    cc[:, :, pos] = c_new[:, :, 0]
    ckr[:, :, pos] = kr_new[:, :, 0]
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim + cfg.rope_head_dim)
    ccf = cc.float()
    q_lat = torch.einsum("kbqhe,krhe->kbqhr", q_nope.float(), p["wk_b"].float())
    scores = (torch.einsum("kbqhr,kbsr->kbhqs", q_lat, ccf)
              + torch.einsum("kbqhe,kbse->kbhqs", q_rope.float(), ckr.float())) * scale
    mask = torch.arange(cc.shape[2], device=x.device) <= pos
    scores = torch.where(mask, scores, ref.NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out_lat = torch.einsum("kbhqs,kbsr->kbqhr", probs, ccf)
    out = torch.einsum("kbqhr,krhe->kbqhe", out_lat, p["wv_b"].float()).to(x.dtype)
    return einsum("kbshe,khed->kbsd", out, p["wo"]), cache
