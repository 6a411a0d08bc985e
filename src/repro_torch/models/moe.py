"""Mixture-of-Experts FFN, lane-batched: token-choice top-k routing,
sort-based capacity dispatch, optional always-on shared experts.

Every lane routes its own tokens with its own capacity, as the JAX package's
population ``vmap`` of ``repro.models.moe.moe_apply`` does: x is
``(K, B, S, d)``; the router is ``(K, d, E)`` in fp32, ``wi`` ``(K, E, d,
n_in, ff)``, ``wo`` ``(K, E, ff, d)``, ``shared`` as in ``mlp.py``.  The
grouped plain path is the only one: the expert-parallel ``shard_map`` path
comes with the two-level mesh (ROADMAP.md section 1, item 12(b)).

The dispatch is built so that nothing accumulates into one element from
several places, forward or backward, so a step's bits do not depend on the
order of atomic adds on the card, and the same tokens give the same bits in
every lane:

* each token is repeated k times by ``expand`` (its backward: a sum over k);
* the repeated rows go to their capacity slots by ``index_copy`` into a
  buffer of ``E * C + 1`` rows a group, the last row taking every dropped
  assignment and then cut off (the backward reads each slot's gradient
  back, one read per assignment);
* the combine reads each assignment's expert output by its slot from the
  output buffer with a zero row appended for the dropped ones, weights it
  in fp32 and sums over k.

The ranks within an expert come from a stable sort of the expert ids (as
``jnp.argsort``), and the top k from a stable descending sort of the
probabilities, so ties keep the lower expert first (as ``jax.lax.top_k``).
No call syncs with the host or changes shape with the data, so the layer
runs inside a captured CUDA graph.  A lane with NaN probabilities still
routes to experts in range.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import Params, dense_init, dtype_of, lane_sum, per_lane
from .mlp import mlp_apply, mlp_init


def moe_init(gen, cfg: ModelConfig, device) -> Params:
    """One trial's FFN (no lane axis): the JAX package's tree, with the
    router in fp32 whatever the parameter dtype."""
    pdt = dtype_of(cfg.param_dtype)
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    n_in = 2 if cfg.activation == "swiglu" else 1
    p = {
        "router": dense_init(gen, (d, E), torch.float32, device, fan_in=d),
        "wi": dense_init(gen, (E, d, n_in, ff), pdt, device, fan_in=d),
        "wo": dense_init(gen, (E, ff, d), pdt, device, fan_in=ff),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, cfg, device, d_ff=cfg.n_shared_experts * cfg.moe_d_ff)
    return p


def dispatch_groups(T: int, cfg: ModelConfig, dropless: bool = False) -> int:
    """Dispatch groups of T tokens: ``moe_groups``, or 1 when dropless or
    when they do not divide T."""
    G = max(1, cfg.moe_groups) if not dropless else 1
    return 1 if T % G else G


def capacity(cfg: ModelConfig, tokens_per_group: int, dropless: bool = False) -> int:
    """Slots an expert has in one dispatch group."""
    k, E = cfg.moe_top_k, cfg.n_experts
    if dropless:
        return tokens_per_group * k
    return max(1, int(math.ceil(cfg.capacity_factor * tokens_per_group * k / E)))


def route(router: torch.Tensor, xt: torch.Tensor, k: int):
    """Softmax router and top ``k``: xt (K, G, Tg, d), router (K, d, E) ->
    probs (K, G, Tg, E), top_p renormalised and top_e (K, G, Tg, k)."""
    K, G, Tg, d = xt.shape
    logits = torch.bmm(xt.float().reshape(K, G * Tg, d), router).reshape(K, G, Tg, -1)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    return probs, top_p, top_e


def dispatch_slots(top_e: torch.Tensor, E: int, C: int) -> torch.Tensor:
    """Each assignment's slot in its group's ``(E * C + 1)``-row buffer, in
    the assignments' own order (K, G, Tg * k): ``e * C + rank`` where
    ``rank`` is its place among its expert's assignments in token order,
    and ``E * C`` (the dump row) once the rank reaches the capacity."""
    K, G = top_e.shape[:2]
    flat_e = top_e.reshape(K, G, -1)
    n = flat_e.shape[-1]
    sorted_e, order = torch.sort(flat_e, dim=-1, stable=True)
    idx = torch.arange(n, device=flat_e.device).expand_as(flat_e)
    is_start = torch.ones_like(flat_e, dtype=torch.bool)
    is_start[..., 1:] = sorted_e[..., 1:] != sorted_e[..., :-1]
    run_start = torch.cummax(torch.where(is_start, idx, torch.zeros_like(idx)), dim=-1).values
    pos = idx - run_start
    slot = torch.where(pos < C, sorted_e * C + pos, torch.full_like(pos, E * C))
    # back from the sorted order to the assignments' own (order is a permutation)
    return torch.empty_like(slot).scatter_(-1, order, slot)


def dispatch(xt: torch.Tensor, slot: torch.Tensor, E: int, C: int) -> torch.Tensor:
    """xt (K, G, Tg, d) -> the capacity buffer (K, G, E, C, d): each token
    repeated k times (``slot`` (K, G, Tg * k)), each copy in its slot, the
    dropped ones in the dump row that is cut off."""
    K, G, Tg, d = xt.shape
    k = slot.shape[-1] // Tg
    rows = E * C + 1
    buf = xt.new_zeros((K * G * rows, d)).index_copy(
        0, _flat_slots(slot, rows), xt.unsqueeze(3).expand(K, G, Tg, k, d).reshape(-1, d))
    return buf.view(K, G, rows, d)[:, :, :E * C].reshape(K, G, E, C, d)


def experts(buf: torch.Tensor, p: Params, cfg: ModelConfig) -> torch.Tensor:
    """The expert products: buf (K, G, E, C, d) -> (K, G, E * C, d), one
    batched matmul over (lane, expert) a projection."""
    K, G, E, C, d = buf.shape
    n_in, ff = p["wi"].shape[-2:]
    xe = buf.transpose(1, 2).reshape(K * E, G * C, d)
    h = torch.bmm(xe, p["wi"].reshape(K * E, d, n_in * ff)).view(K * E, G * C, n_in, ff)
    if cfg.activation == "swiglu":
        h = F.silu(h[:, :, 0]) * h[:, :, 1]
    else:
        h = F.gelu(h[:, :, 0], approximate="tanh")   # jax.nn.gelu's default
    out = torch.bmm(h, p["wo"].reshape(K * E, ff, d))
    return out.view(K, E, G, C, d).transpose(1, 2).reshape(K, G, E * C, d)


def combine(out: torch.Tensor, slot: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """out (K, G, E * C, d), slot (K, G, Tg * k), top_p (K, G, Tg, k) -> y
    (K, G, Tg, d): each assignment's expert output read by its slot (a
    dropped one reads a zero row), weighted in fp32 and summed over k."""
    K, G, EC, d = out.shape
    Tg, k = top_p.shape[2:]
    out = torch.cat([out, out.new_zeros((K, G, 1, d))], dim=2).reshape(-1, d)
    got = out.index_select(0, _flat_slots(slot, EC + 1)).view(K, G, Tg, k, d)
    return (got.float() * top_p.unsqueeze(-1)).sum(3).to(out.dtype)


def _flat_slots(slot: torch.Tensor, rows: int) -> torch.Tensor:
    """Slots as rows of the buffers of all (lane, group) pairs stacked."""
    K, G = slot.shape[:2]
    base = torch.arange(K * G, device=slot.device).view(K, G, 1) * rows
    return (slot + base).reshape(-1)


def aux_loss(probs: torch.Tensor, top_e: torch.Tensor, E: int) -> torch.Tensor:
    """Each lane's Switch load-balancing loss ``E * sum_e f_e * P_e`` (K,):
    f the share of assignments an expert got, P its mean probability.  The
    counts are whole numbers, so a count by ``scatter_add_`` is exact; the
    means and the sum are each lane's own reductions (``per_lane``)."""
    K = top_e.shape[0]
    flat = top_e.reshape(K, -1)
    f = torch.zeros((K, E), dtype=torch.float32, device=top_e.device).scatter_add_(
        1, flat, torch.ones(flat.shape, device=top_e.device))
    mean_p = per_lane(lambda p: p.mean(dim=(0, 1)), probs)
    return E * lane_sum(f / flat.shape[1] * mean_p)


def moe_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *, dropless: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (K, B, S, d) -> (y (K, B, S, d), aux (K,)): the grouped sort-based
    dispatch of ``repro.models.moe.moe_apply`` on every lane, and each
    lane's load-balancing loss."""
    K, B, S, d = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    T = B * S
    G = dispatch_groups(T, cfg, dropless)
    C = capacity(cfg, T // G, dropless)
    xt = x.reshape(K, G, T // G, d)
    probs, top_p, top_e = route(p["router"], xt, k)
    slot = dispatch_slots(top_e, E, C)
    out = experts(dispatch(xt, slot, E, C), p, cfg)
    y = combine(out, slot, top_p).reshape(K, B, S, d)
    if cfg.n_shared_experts:
        y = y + mlp_apply(p["shared"], x, cfg)
    return y, aux_loss(probs, top_e, E)
