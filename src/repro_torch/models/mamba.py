"""Mamba-1 selective-SSM mixer (falcon-mamba), lane-batched.

x -> in_proj -> (u, z); u -> causal depthwise conv -> silu -> selective scan
(``kernels.ops.ssm_scan``: the Hopper kernel on the card) -> y * silu(z) ->
out_proj.  Every weight carries the leading lane axis K, so each trial has
its own ``A_log`` and ``D``; the scan takes them per lane.

Decode keeps two pieces of state a layer, both O(1) in the sequence: the
last ``ssm_conv - 1`` conv inputs and the ``(K, B, d_inner, N)`` SSM state
``h``, in fp32 whatever the cache dtype.  ``mamba_decode`` updates both in
place, through the reference's single-token step (``ops.ssm_decode_step``),
as the JAX package does.  The conv window takes the cache's dtype where it
is the wider one (the JAX package's concatenation promotes), and the rest
of the step follows it, as JAX's promoting einsums do: under the serving
loop's fp32 cache a bf16 model's mixer computes in fp32, its weights cast
each step.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..distributed.sharding import tp_enter, tp_reduce
from ..kernels import ops
from .layers import Params, Specs, dense_init, dtype_of, einsum


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


def mamba_specs(cfg: ModelConfig) -> Specs:
    return {"in_proj": ("embed", None, "inner"), "conv_w": (None, "inner"),
            "conv_b": ("inner",), "x_proj": ("inner", None), "dt_proj": (None, "inner"),
            "dt_bias": ("inner",), "A_log": ("inner", None), "D": ("inner",),
            "out_proj": ("inner", "embed")}


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
    """x (K, B, S, d) -> (K, B, S, d).  On a two-level mesh the whole mixer
    runs on the row's share of the ``d_inner`` channels: ``in_proj``
    column-parallel, ``out_proj`` row-parallel; ``x_proj``'s output (dt_raw,
    B, C: every channel reads them) is closed by ``tp_reduce`` and enters
    the width-sharded consumers again through ``tp_enter``."""
    uz = einsum("kbsd,kdci->kbsci", tp_enter(x, "mamba"), p["in_proj"])
    u, z = uz[..., 0, :], uz[..., 1, :]
    u = F.silu(_causal_conv(u, p["conv_w"], p["conv_b"]))
    h = tp_enter(tp_reduce(einsum("kbsi,kij->kbsj", u, p["x_proj"]), "mamba"), "mamba")
    dt_raw, Bc, Cc = _split_xproj(h, cfg)
    dt = F.softplus(einsum("kbsr,kri->kbsi", dt_raw, p["dt_proj"])
                    + p["dt_bias"][:, None, None])
    A = -torch.exp(p["A_log"].float())
    y, _ = ops.ssm_scan(u, dt, A, Bc, Cc, p["D"].float())
    y = y * F.silu(z)
    return tp_reduce(einsum("kbsi,kid->kbsd", y, p["out_proj"]), "mamba")


def mamba_cache_init(cfg: ModelConfig, K: int, batch: int, dtype, device) -> Params:
    return {
        "conv": torch.zeros((K, batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=dtype,
                            device=device),
        "h": torch.zeros((K, batch, cfg.d_inner, cfg.ssm_state), dtype=torch.float32,
                         device=device),
    }


def mamba_cache_specs(cfg: ModelConfig) -> Specs:
    return {"conv": ("batch", None, "inner"), "h": ("batch", "inner", None)}


def mamba_decode(p: Params, x: torch.Tensor, cache: Params, cfg: ModelConfig):
    """Single-token step, x (K, B, 1, d) -> (out (K, B, 1, d), cache): the conv
    window and ``h`` advanced in place, the same tree returned.  On a mesh
    whose seams cover Mamba (``mamba_apply``'s), the step runs on the row's
    share of the channels, its cache's too: ``x_proj``'s and ``out_proj``'s
    partial sums closed by ``tp_reduce``."""
    uz = einsum("kbsd,kdci->kbsci", tp_enter(x, "mamba"), p["in_proj"])
    u, z = uz[:, :, 0, 0], uz[:, :, 0, 1]                              # (K, B, di)
    ct = torch.promote_types(u.dtype, cache["conv"].dtype)
    window = torch.cat([cache["conv"].to(ct), u[:, :, None].to(ct)], dim=2)  # (K, B, Kc, di)
    u_conv = F.silu(torch.einsum("kbci,kci->kbi", window, p["conv_w"].to(ct))
                    + p["conv_b"].to(ct)[:, None])
    dt_raw, Bc, Cc = _split_xproj(tp_reduce(torch.einsum("kbi,kij->kbj", u_conv,
                                                         p["x_proj"].to(ct)), "mamba"), cfg)
    dt = F.softplus(torch.einsum("kbr,kri->kbi", dt_raw, p["dt_proj"].to(ct))
                    + p["dt_bias"].to(ct)[:, None])
    A = -torch.exp(p["A_log"].float())
    y, h = ops.ssm_decode_step(u_conv, dt, A, Bc, Cc, p["D"].float(), cache["h"])
    y = y * F.silu(z)
    out = tp_reduce(torch.einsum("kbi,kid->kbd", y, p["out_proj"].to(y.dtype)),
                    "mamba")[:, :, None]
    cache["conv"].copy_(window[:, :, 1:])
    cache["h"].copy_(h)
    return out, cache
