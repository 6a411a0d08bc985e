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

**Decode on a mesh** (``train/serve_step.py::ServeLayout``, the dry run):
the decode context names where each cache kind is stored
(``sharding.cache_placement``).  The production rules let ``cache_seq``
claim the model axis before ``kv_heads``, so a rank holds a block of the
cache's positions (over ``("data", "model")`` for a long context), its
data rows' rows, and its kv heads whole.  Each rank then attends from every
head (a rank whose heads are split gathers q, and the new k and v, over the
model axis) to its positions only, keeping the partials of an online
softmax, the max, the sum and the weighted values, in fp32; an all-reduce
of the max, then of the rescaled sum and values, over the positions' axes
joins them (``_split_attend``).  The row at ``pos`` is written by the rank
whose block holds it.  The heads a rank computes go on to the
row-parallel ``wo`` through the seam ``tp_reduce``.
"""
from __future__ import annotations

import math

import torch

from ..configs.base import ModelConfig
from ..distributed.sharding import cache_placement, ctx_mesh, tp_axis, tp_enter, tp_reduce
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


def _start(placement_axis, n_local: int, mesh) -> int:
    """Where this rank's block of ``n_local`` along a dim placed over
    ``placement_axis`` (None: held whole) starts."""
    return 0 if placement_axis is None else mesh.axis_index(placement_axis) * n_local


def _split_attend(scores: torch.Tensor, values: torch.Tensor, seq_axis, mesh, eq: str
                  ) -> torch.Tensor:
    """Softmax over the last dim of ``scores`` (fp32, masked with NEG_INF),
    its weights applied to ``values`` by ``eq``, where each rank holds a
    block of the positions (``seq_axis``; None: all of them): the local max,
    sum and weighted values, joined over ``seq_axis`` by an all-reduce of
    the max, then of the rescaled sum and values."""
    m = scores.amax(dim=-1, keepdim=True)
    if seq_axis is not None:
        m = mesh.axis_all_reduce(m.contiguous(), seq_axis, op="max")
    w = torch.where(scores > ref.NEG_INF / 2, torch.exp(scores - m), 0.0)
    den = w.sum(dim=-1, keepdim=True)
    num = torch.einsum(eq, w, values)
    if seq_axis is not None:
        den = mesh.axis_all_reduce(den, seq_axis)
        num = mesh.axis_all_reduce(num.contiguous(), seq_axis)
    return num, den


def _gqa_decode_split(q, k, v, cache: Params, pos: int, cfg: ModelConfig, place: tuple,
                      local: bool):
    """``gqa_decode`` against a cache stored as ``place`` says (module
    docstring): (K, B, 1, heads this rank computes, Dh) out."""
    mesh = ctx_mesh()
    split = tp_axis("attn") is not None
    if split:   # this rank's heads: every head is needed against its positions
        q, k, v = (mesh.axis_all_gather(t, 3, "model") for t in (q, k, v))
    K, B, _, H, Dh = q.shape
    ck, cv = cache["k"], cache["v"]
    g = H // k.shape[3]
    hn, sn = ck.shape[3], ck.shape[2]
    h0, s0 = _start(place[2], hn, mesh), _start(place[1], sn, mesh)
    if s0 <= pos < s0 + sn:
        ck[:, :, pos - s0] = k[:, :, 0, h0:h0 + hn]
        cv[:, :, pos - s0] = v[:, :, 0, h0:h0 + hn]
    scale = Dh ** -0.5
    qf = q[:, :, :, h0 * g:(h0 + hn) * g].float().reshape(K, B, hn, g, Dh) * scale
    scores = torch.einsum("kbngd,kbsnd->kbngs", qf, ck.float())
    if cfg.attn_softcap is not None:
        scores = cfg.attn_softcap * torch.tanh(scores / cfg.attn_softcap)
    k_pos = s0 + torch.arange(sn, device=q.device)
    mask = k_pos <= pos
    if local:
        mask &= k_pos > pos - cfg.sliding_window
    scores = torch.where(mask, scores, ref.NEG_INF)
    num, den = _split_attend(scores, cv.float(), place[1], mesh, "kbngs,kbsnd->kbngd")
    out = (num / den).reshape(K, B, 1, hn * g, Dh).to(q.dtype)
    if place[2] is not None:
        out = mesh.axis_all_gather(out, 3, place[2])
    if split:
        Hl = H // mesh.width
        out = out.narrow(3, mesh.model_rank * Hl, Hl)
    return out


def gqa_decode(p: Params, x: torch.Tensor, cache: Params, pos: int, cfg: ModelConfig, *,
               local: bool = False):
    """x (K, B, 1, d) at position ``pos`` -> (y (K, B, 1, d), cache): k and v
    written into the cache at ``pos`` in place, the same tree returned.  On
    a mesh's decode context, attention over a cache split as the context
    says (``_gqa_decode_split``)."""
    K, B = x.shape[:2]
    xs = tp_enter(x, "attn")
    q = einsum("kbsd,kdhe->kbshe", xs, p["wq"])
    k = einsum("kbsd,kdhe->kbshe", xs, p["wk"])
    v = einsum("kbsd,kdhe->kbshe", xs, p["wv"])
    positions = torch.full((1,), pos, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    place = cache_placement("gqa")
    if place is not None:
        out = _gqa_decode_split(q, k, v, cache, pos, cfg, place, local)
        return tp_reduce(einsum("kbshe,khed->kbsd", out, p["wo"]), "attn"), cache
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
    return tp_reduce(einsum("kbshe,khed->kbsd", out, p["wo"]), "attn"), cache


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
    taken out through ``wv_b``, all in fp32; then ``wo``.  On a mesh's
    decode context, against a cache split as the context says (module
    docstring)."""
    positions = torch.full((1,), pos, device=x.device)
    q_nope, q_rope, c_new, kr_new = _mla_qkc(p, x, cfg, positions)
    place = cache_placement("mla")
    if place is not None:
        out = _mla_decode_split(p, q_nope, q_rope, c_new, kr_new, cache, pos, cfg, place)
        return tp_reduce(einsum("kbshe,khed->kbsd", out.to(x.dtype), p["wo"]), "attn"), cache
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
    return tp_reduce(einsum("kbshe,khed->kbsd", out, p["wo"]), "attn"), cache


def _mla_decode_split(p: Params, q_nope, q_rope, c_new, kr_new, cache: Params, pos: int,
                      cfg: ModelConfig, place: tuple) -> torch.Tensor:
    """``mla_decode``'s absorbed attention against a latent cache stored as
    ``place`` says: (K, B, 1, heads this rank computes, Dh) fp32 out."""
    mesh = ctx_mesh()
    split = tp_axis("attn") is not None
    q_lat = torch.einsum("kbqhe,krhe->kbqhr", q_nope.float(), p["wk_b"].float())
    q_rope = q_rope.float()
    if split:   # this rank's heads: every head is needed against its positions
        q_lat, q_rope = (mesh.axis_all_gather(t, 3, "model") for t in (q_lat, q_rope))
    cc, ckr = cache["c"], cache["kr"]
    sn = cc.shape[2]
    s0 = _start(place[1], sn, mesh)
    if s0 <= pos < s0 + sn:
        cc[:, :, pos - s0] = c_new[:, :, 0]
        ckr[:, :, pos - s0] = kr_new[:, :, 0]
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim + cfg.rope_head_dim)
    ccf = cc.float()
    scores = (torch.einsum("kbqhr,kbsr->kbhqs", q_lat, ccf)
              + torch.einsum("kbqhe,kbse->kbhqs", q_rope, ckr.float())) * scale
    mask = s0 + torch.arange(sn, device=cc.device) <= pos
    scores = torch.where(mask, scores, ref.NEG_INF)
    num, den = _split_attend(scores, ccf, place[1], mesh, "kbhqs,kbsr->kbhqr")
    out_lat = (num / den).permute(0, 1, 3, 2, 4)                      # (K, B, 1, H, r)
    if split:
        Hl = out_lat.shape[3] // mesh.width
        out_lat = out_lat.narrow(3, mesh.model_rank * Hl, Hl)
    return torch.einsum("kbqhr,krhe->kbqhe", out_lat, p["wv_b"].float())
