"""Dense FFN: SwiGLU (llama/gemma family) or GeLU (starcoder2), lane-batched.

On a two-level population mesh ``wi`` is column-parallel over ``ff`` and
``wo`` row-parallel: one all-reduce a forward and one a backward, through
the seams (no-ops elsewhere)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..distributed.sharding import tp_enter, tp_reduce
from .layers import Params, Specs, dense_init, dtype_of, einsum


def mlp_init(gen, cfg: ModelConfig, device, d_ff: int = 0) -> Params:
    pdt = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    c = 2 if cfg.activation == "swiglu" else 1  # gate & up stacked on axis 1
    return {
        "wi": dense_init(gen, (d, c, ff), pdt, device, fan_in=d),
        "wo": dense_init(gen, (ff, d), pdt, device, fan_in=ff),
    }


def mlp_specs(cfg: ModelConfig) -> Specs:
    return {"wi": ("embed", None, "ff"), "wo": ("ff", "embed")}


def mlp_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x (K, B, S, d); wi (K, d, c, ff); wo (K, ff, d)."""
    h = einsum("kbsd,kdcf->kbscf", tp_enter(x, "mlp"), p["wi"])
    if cfg.activation == "swiglu":
        h = F.silu(h[..., 0, :]) * h[..., 1, :]
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h[..., 0, :], approximate="tanh")
    return tp_reduce(einsum("kbsf,kfd->kbsd", h, p["wo"]), "mlp")
