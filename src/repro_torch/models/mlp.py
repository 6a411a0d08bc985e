"""Dense FFN: SwiGLU (llama/gemma family) or GeLU (starcoder2), lane-batched."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import Params, dense_init, dtype_of, einsum


def mlp_init(gen, cfg: ModelConfig, device, d_ff: int = 0) -> Params:
    pdt = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    c = 2 if cfg.activation == "swiglu" else 1  # gate & up stacked on axis 1
    return {
        "wi": dense_init(gen, (d, c, ff), pdt, device, fan_in=d),
        "wo": dense_init(gen, (ff, d), pdt, device, fan_in=ff),
    }


def mlp_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x (K, B, S, d); wi (K, d, c, ff); wo (K, ff, d)."""
    h = einsum("kbsd,kdcf->kbscf", x, p["wi"])
    if cfg.activation == "swiglu":
        h = F.silu(h[..., 0, :]) * h[..., 1, :]
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h[..., 0, :], approximate="tanh")
    return einsum("kbsf,kfd->kbsd", h, p["wo"])
