"""Mamba-1 selective-SSM mixer (falcon-mamba), lane-batched.

x -> in_proj -> (u, z); u -> causal depthwise conv -> silu -> selective scan
(``kernels.ops.ssm_scan``: the Hopper kernel on the card) -> y * silu(z) ->
out_proj.  Every weight carries the leading lane axis K, so each trial has
its own ``A_log`` and ``D``; the scan takes them per lane.

Decode (``mamba_cache_init`` / ``mamba_decode``) comes with ROADMAP.md
section 1, item 11.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import Params, dense_init, dtype_of


def mamba_init(gen, cfg: ModelConfig, device) -> Params:
    """One trial's mixer (no lane axis), the JAX package's tree and
    distributions: truncated-normal projections, ``A_log = log(1..N)`` and
    ``D = 1`` in fp32, ``softplus(dt_bias) = 0.01``, ``conv_b = 0``."""
    pdt = dtype_of(cfg.param_dtype)
    d, di, N, Kc, dr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv, cfg.dt_rank
    A = torch.arange(1, N + 1, dtype=torch.float32, device=device).expand(di, N)
    return {
        "in_proj": dense_init(gen, (d, 2, di), pdt, device, fan_in=d),
        "conv_w": dense_init(gen, (Kc, di), pdt, device, fan_in=Kc),
        "conv_b": torch.zeros((di,), dtype=pdt, device=device),
        "x_proj": dense_init(gen, (di, dr + 2 * N), pdt, device, fan_in=di),
        "dt_proj": dense_init(gen, (dr, di), pdt, device, fan_in=dr),
        "dt_bias": torch.full((di,), math.log(math.expm1(0.01)), dtype=pdt, device=device),
        "A_log": torch.log(A).contiguous(),
        "D": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": dense_init(gen, (di, d), pdt, device, fan_in=di),
    }


def _split_xproj(h: torch.Tensor, cfg: ModelConfig):
    """x_proj output -> (dt_raw, B, C), in that order."""
    dr, N = cfg.dt_rank, cfg.ssm_state
    return h[..., :dr], h[..., dr:dr + N], h[..., dr + N:]


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence, per lane: u (K, B, L, D),
    w (K, Kc, D), b (K, D); the JAX package's shifted sum."""
    Kc, L = w.shape[1], u.shape[2]
    pad = F.pad(u, (0, 0, Kc - 1, 0))
    out = pad[:, :, 0:L] * w[:, None, None, 0]
    for j in range(1, Kc):
        out = out + pad[:, :, j:j + L] * w[:, None, None, j]
    return out + b[:, None, None]


def mamba_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x (K, B, S, d) -> (K, B, S, d)."""
    uz = torch.einsum("kbsd,kdci->kbsci", x, p["in_proj"])
    u, z = uz[..., 0, :], uz[..., 1, :]
    u = F.silu(_causal_conv(u, p["conv_w"], p["conv_b"]))
    dt_raw, Bc, Cc = _split_xproj(torch.einsum("kbsi,kij->kbsj", u, p["x_proj"]), cfg)
    dt = F.softplus(torch.einsum("kbsr,kri->kbsi", dt_raw, p["dt_proj"])
                    + p["dt_bias"][:, None, None])
    A = -torch.exp(p["A_log"].float())
    y, _ = ops.ssm_scan(u, dt, A, Bc, Cc, p["D"].float())
    y = y * F.silu(z)
    return torch.einsum("kbsi,kid->kbsd", y, p["out_proj"])
