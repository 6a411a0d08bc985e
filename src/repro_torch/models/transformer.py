"""Model assembly: embedding -> [prefix layers] -> superblocks -> final norm
-> unembed, lane-batched.

The parameter tree is the JAX package's: the ``blocks`` leaves carry a
leading ``n_superblocks`` axis.  A population tree adds one more leading
axis, the lane axis K, in front of it, so ``blocks`` leaves are
``(K, n_superblocks, ...)``.  ``forward`` runs all K lanes at once:
projections are batched matmuls over K and the kernels take K as part of
their batch dimension.

This slice covers the dense decoder families: mixers ``attn`` and
``attn_local``, FFN ``dense``, with ``post_norm``, softcaps and
``scale_embed``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..configs.base import ModelConfig
from ..interop import tree_map
from . import attention as attn
from . import mlp as mlpm
from .layers import (
    Params,
    apply_rmsnorm,
    dtype_of,
    embed_tokens,
    embedding_init,
    rmsnorm_init,
    unembed,
)

_MIXERS = ("attn", "attn_local")
_FFNS = ("dense",)
_LATER = ("the other model families (ROADMAP.md section 1, item 11: MLA, MoE, "
          "Mamba and the frontends)")


def check_supported(cfg: ModelConfig) -> None:
    for mixer, ffn in cfg.prefix_pattern + cfg.pattern:
        if mixer not in _MIXERS:
            raise NotImplementedError(
                f"{cfg.name}: mixer {mixer!r} is not ported yet; it comes with {_LATER}")
        if ffn not in _FFNS:
            raise NotImplementedError(
                f"{cfg.name}: ffn {ffn!r} is not ported yet; it comes with {_LATER}")
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: frontend {cfg.frontend!r} is not ported yet; it comes with {_LATER}")


# ------------------------------ init --------------------------------------------------
def _layer_init(gen, cfg: ModelConfig, device) -> Params:
    pdt = dtype_of(cfg.param_dtype)
    p: Params = {
        "norm1": rmsnorm_init(cfg.d_model, pdt, device),
        "mixer": attn.gqa_init(gen, cfg, device),
    }
    if cfg.post_norm:
        p["norm1_post"] = rmsnorm_init(cfg.d_model, pdt, device)
    p["norm2"] = rmsnorm_init(cfg.d_model, pdt, device)
    p["ffn"] = mlpm.mlp_init(gen, cfg, device)
    if cfg.post_norm:
        p["norm2_post"] = rmsnorm_init(cfg.d_model, pdt, device)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """One trial's parameters (no lane axis), from ``gen``."""
    check_supported(cfg)
    params: Params = {"embedding": embedding_init(gen, cfg, device)}
    if cfg.prefix_pattern:
        params["prefix"] = [_layer_init(gen, cfg, device) for _ in cfg.prefix_pattern]
    blocks = [{f"l{i}": _layer_init(gen, cfg, device) for i in range(len(cfg.pattern))}
              for _ in range(cfg.n_superblocks)]
    params["blocks"] = tree_map(lambda *xs: torch.stack(xs), *blocks)
    params["final_norm"] = rmsnorm_init(cfg.d_model, dtype_of(cfg.param_dtype), device)
    return params


# ------------------------------ forward (train / prefill) ------------------------------
def _layer_apply(lp: Params, x: torch.Tensor, mixer: str, cfg: ModelConfig,
                 positions: torch.Tensor) -> torch.Tensor:
    h = apply_rmsnorm(x, lp["norm1"], cfg.norm_eps)
    h = attn.gqa_apply(lp["mixer"], h, cfg, positions, local=(mixer == "attn_local"))
    if cfg.post_norm:
        h = apply_rmsnorm(h, lp["norm1_post"], cfg.norm_eps)
    x = x + h
    h = apply_rmsnorm(x, lp["norm2"], cfg.norm_eps)
    h = mlpm.mlp_apply(lp["ffn"], h, cfg)
    if cfg.post_norm:
        h = apply_rmsnorm(h, lp["norm2_post"], cfg.norm_eps)
    return x + h


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (K, B, S) -> (logits fp32 (K, B, S, V), aux loss 0.0).

    ``params`` is lane-batched: every leaf has the leading lane axis K."""
    check_supported(cfg)
    x = embed_tokens(params["embedding"], tokens, cfg)
    positions = torch.arange(x.shape[2], device=x.device)
    for i, (m, _) in enumerate(cfg.prefix_pattern):
        x = _layer_apply(params["prefix"][i], x, m, cfg, positions)
    for j in range(cfg.n_superblocks):
        sp = tree_map(lambda a: a[:, j], params["blocks"])
        for i, (m, _) in enumerate(cfg.pattern):
            x = _layer_apply(sp[f"l{i}"], x, m, cfg, positions)
    x = apply_rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params["embedding"], x, cfg)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)
