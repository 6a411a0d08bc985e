"""Model assembly: embedding -> [prefix layers] -> superblocks -> final norm
-> unembed, lane-batched.

The parameter tree is the JAX package's: the ``blocks`` leaves carry a
leading ``n_superblocks`` axis.  A population tree adds one more leading
axis, the lane axis K, in front of it, so ``blocks`` leaves are
``(K, n_superblocks, ...)``.  ``forward`` runs all K lanes at once:
projections are batched matmuls over K and the kernels take K as part of
their batch dimension.

Every mixer of ``configs.base.MIXERS`` is ported: ``attn``, ``attn_local``,
``attn_mla`` (``attention.py``) and ``mamba``; every FFN: ``dense``, ``moe``
(``moe.py``, whose load-balancing loss ``forward`` sums over the layers, per
lane) or ``none`` (a layer without FFN has no ``norm2`` and no second
residual, as falcon-mamba's); ``post_norm``, softcaps and ``scale_embed``.
A model with a frontend (hubert's audio frames, pixtral's image patches)
takes ``inputs_embeds`` in place of tokens; ``frontend.py`` makes synthetic
ones, as the JAX package's stub does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..interop import tree_map
from . import attention as attn
from . import mamba as mam
from . import mlp as mlpm
from . import moe as moem
from .layers import (
    Params,
    apply_rmsnorm,
    dtype_of,
    embed_tokens,
    embedding_init,
    rmsnorm_init,
    unembed,
)

_MIXER_INIT = {"attn": attn.gqa_init, "attn_local": attn.gqa_init,
               "attn_mla": attn.mla_init, "mamba": mam.mamba_init}


# ------------------------------ init --------------------------------------------------
def _layer_init(gen, mixer: str, ffn: str, cfg: ModelConfig, device) -> Params:
    pdt = dtype_of(cfg.param_dtype)
    p: Params = {
        "norm1": rmsnorm_init(cfg.d_model, pdt, device),
        "mixer": _MIXER_INIT[mixer](gen, cfg, device),
    }
    if cfg.post_norm:
        p["norm1_post"] = rmsnorm_init(cfg.d_model, pdt, device)
    if ffn != "none":
        p["norm2"] = rmsnorm_init(cfg.d_model, pdt, device)
        p["ffn"] = (moem.moe_init(gen, cfg, device) if ffn == "moe"
                    else mlpm.mlp_init(gen, cfg, device))
        if cfg.post_norm:
            p["norm2_post"] = rmsnorm_init(cfg.d_model, pdt, device)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """One trial's parameters (no lane axis), from ``gen``."""
    params: Params = {"embedding": embedding_init(gen, cfg, device)}
    if cfg.prefix_pattern:
        params["prefix"] = [_layer_init(gen, m, f, cfg, device)
                            for m, f in cfg.prefix_pattern]
    # superblock by superblock into the stacked leaves: one superblock's
    # parameters are allocated beside them, not all of them twice
    blocks = None
    for b in range(cfg.n_superblocks):
        block = {f"l{i}": _layer_init(gen, m, f, cfg, device)
                 for i, (m, f) in enumerate(cfg.pattern)}
        if blocks is None:
            blocks = tree_map(lambda x: x.new_empty((cfg.n_superblocks,) + tuple(x.shape)),
                              block)
        tree_map(lambda dst, x: dst[b].copy_(x), blocks, block)
        del block
    params["blocks"] = blocks
    params["final_norm"] = rmsnorm_init(cfg.d_model, dtype_of(cfg.param_dtype), device)
    return params


# ------------------------------ forward (train / prefill) ------------------------------
def _layer_apply(lp: Params, x: torch.Tensor, mixer: str, ffn: str, cfg: ModelConfig,
                 positions: torch.Tensor, aux: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer; ``aux`` (K,) gains the layer's MoE loss."""
    h = apply_rmsnorm(x, lp["norm1"], cfg.norm_eps)
    if mixer == "mamba":
        h = mam.mamba_apply(lp["mixer"], h, cfg)
    elif mixer == "attn_mla":
        h = attn.mla_apply(lp["mixer"], h, cfg, positions)
    else:
        h = attn.gqa_apply(lp["mixer"], h, cfg, positions, local=(mixer == "attn_local"))
    if cfg.post_norm:
        h = apply_rmsnorm(h, lp["norm1_post"], cfg.norm_eps)
    x = x + h
    if ffn == "none":
        return x, aux
    h = apply_rmsnorm(x, lp["norm2"], cfg.norm_eps)
    if ffn == "moe":
        h, a = moem.moe_apply(lp["ffn"], h, cfg)
        aux = aux + a
    else:
        h = mlpm.mlp_apply(lp["ffn"], h, cfg)
    if cfg.post_norm:
        h = apply_rmsnorm(h, lp["norm2_post"], cfg.norm_eps)
    return x + h, aux


def forward(params: Params, tokens: Optional[torch.Tensor], cfg: ModelConfig, *,
            inputs_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (K, B, S), or ``inputs_embeds`` (K, B, S, d) in their place ->
    (logits fp32 (K, B, S, V), aux (K,)): each lane's MoE load-balancing loss
    summed over its layers (zeros without MoE).

    ``params`` is lane-batched: every leaf has the leading lane axis K."""
    if inputs_embeds is not None:
        x = inputs_embeds.to(dtype_of(cfg.compute_dtype))
    else:
        x = embed_tokens(params["embedding"], tokens, cfg)
    positions = torch.arange(x.shape[2], device=x.device)
    aux = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for i, (m, f) in enumerate(cfg.prefix_pattern):
        x, aux = _layer_apply(params["prefix"][i], x, m, f, cfg, positions, aux)
    for j in range(cfg.n_superblocks):
        sp = tree_map(lambda a: a[:, j], params["blocks"])
        block_aux = torch.zeros_like(aux)   # summed as the reference's scan sums it
        for i, (m, f) in enumerate(cfg.pattern):
            x, block_aux = _layer_apply(sp[f"l{i}"], x, m, f, cfg, positions, block_aux)
        aux = aux + block_aux
    x = apply_rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params["embedding"], x, cfg)
    return logits, aux
