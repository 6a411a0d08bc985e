"""Shared primitives: initializers, norms, embeddings, dtype plumbing.

Parameters are plain nested dicts of tensors in the JAX package's layout.
``*_init`` functions build one trial's tree (no lane axis) from a
``torch.Generator``; the apply functions take a lane-batched tree, every leaf
with a leading lane axis K, and activations shaped ``(K, B, S, ...)``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops

Params = Dict[str, Any]


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def per_lane(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` applied to each lane of ``x`` (K, ...) alone, stacked.  A
    reduction over the trailing dims of a (K, n) tensor splits n by the
    count of its outputs on the card, so its bits would depend on how many
    lanes share the tensor (a population mesh trains K/N of K lanes a
    rank); a lane's own reduction depends on the lane alone."""
    return torch.stack([fn(x[k]) for k in range(x.shape[0])])


def lane_sum(x: torch.Tensor) -> torch.Tensor:
    """Each lane's sum of ``x`` (K, ...), as (K,): one reduction a lane
    (``per_lane``)."""
    return per_lane(torch.sum, x)


def einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with the JAX package's dtype promotion: operands of
    different float dtypes (bf16 parameters under an fp32 compute dtype) are
    cast to the wider one; where they agree nothing is cast."""
    dt = operands[0].dtype
    for o in operands[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o if o.dtype == dt else o.to(dt) for o in operands))


def _trunc_normal(gen: torch.Generator, shape: Tuple[int, ...], std: float,
                  dtype, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=gen)
    return t.mul_(std).to(dtype)   # in place: one fp32 temporary a leaf


def dense_init(gen, shape: Tuple[int, ...], dtype, device,
               fan_in: Optional[int] = None) -> torch.Tensor:
    """Truncated normal at +-2, scaled by 1/sqrt(fan_in) (fan_in = shape[0])."""
    fan = fan_in if fan_in is not None else shape[0]
    return _trunc_normal(gen, shape, 1.0 / math.sqrt(max(fan, 1)), dtype, device)


def embed_init(gen, vocab: int, d: int, dtype, device) -> torch.Tensor:
    # 1/sqrt(d) keeps tied-unembedding logits O(1); ``scale_embed``
    # multiplies activations back up by sqrt(d) after lookup
    return _trunc_normal(gen, (vocab, d), 1.0 / math.sqrt(d), dtype, device)


# -- norm ---------------------------------------------------------------------------
def rmsnorm_init(d: int, dtype, device) -> torch.Tensor:
    return torch.zeros((d,), dtype=dtype, device=device)  # stored as (gamma - 1)


def apply_rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """x (K, ..., d), gamma (K, d)."""
    return ops.rmsnorm(x, gamma, eps=eps)


# -- embedding / unembedding ----------------------------------------------------------
def embedding_init(gen, cfg: ModelConfig, device) -> Params:
    pdt = dtype_of(cfg.param_dtype)
    p = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, pdt, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), pdt, device)
    return p


def embed_tokens(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """tokens (K, B, S) -> (K, B, S, d) in the compute dtype; lane k reads its
    own table ``embed[k]``."""
    table = params["embed"]                              # (K, V, d)
    K, V, d = table.shape
    offs = (torch.arange(K, device=tokens.device) * V).view(K, 1, 1)
    x = F.embedding(tokens.long() + offs, table.reshape(K * V, d))
    x = x.to(dtype_of(cfg.compute_dtype))
    if cfg.scale_embed:
        x = x * math.sqrt(cfg.d_model)
    return x


def unembed(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Final logits (K, B, S, V) in fp32, with the optional final softcap."""
    table = params.get("unembed")
    if table is None:
        logits = einsum("kbsd,kvd->kbsv", x, params["embed"]).float()
    else:
        logits = einsum("kbsd,kdv->kbsv", x, table).float()
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits
