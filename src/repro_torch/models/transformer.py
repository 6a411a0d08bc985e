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

Serving: ``init_cache`` builds the per-layer decode caches in the same
layout (``blocks`` leaves ``(K, n_superblocks, B, ...)``), ``decode_step``
runs one token a row at a position ``pos`` (a Python int) and writes each
layer's cache row at ``pos`` in place, and ``forward(..., last_only=True)``
is the prefill form that unembeds only the last position.  MoE layers
decode dropless, as in the JAX package.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ModelConfig
from ..distributed.sharding import at_use, reentry
from ..interop import tree_leaves, tree_map, tree_unflatten
from . import attention as attn
from . import mamba as mam
from . import mlp as mlpm
from . import moe as moem
from .layers import (
    Params,
    Specs,
    apply_rmsnorm,
    dtype_of,
    embed_tokens,
    embedding_init,
    embedding_specs,
    rmsnorm_init,
    rmsnorm_specs,
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


def _kept(keep, part: str, tree: Params) -> Params:
    """``keep(part, path, leaf)`` applied to each leaf of ``tree`` (the part's
    leaves at ``path`` within it), as each is made."""
    if keep is None:
        return tree

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return keep(part, path, node)

    return walk(tree, ())


def init_params(gen: torch.Generator, cfg: ModelConfig, device, keep=None) -> Params:
    """One trial's parameters (no lane axis), from ``gen``.  ``keep(part,
    path, leaf)`` (a trial mesh's rank) returns what is stored of each whole
    leaf as it is made: the leaves are drawn in one order whatever is kept,
    so every rank's blocks are those of the whole init, and one layer's
    whole leaves are allocated at a time (a superblock's stacked leaves are
    kept superblock by superblock: ``part`` is ``blocks``, ``path`` within
    one superblock)."""
    params: Params = {"embedding": _kept(keep, "embedding", embedding_init(gen, cfg, device))}
    if cfg.prefix_pattern:
        params["prefix"] = [_kept(keep, f"prefix/{j}", _layer_init(gen, m, f, cfg, device))
                            for j, (m, f) in enumerate(cfg.prefix_pattern)]
    # superblock by superblock into the stacked leaves: one superblock's
    # parameters are allocated beside them, not all of them twice
    blocks = None
    for b in range(cfg.n_superblocks):
        block = _kept(keep, "blocks", {f"l{i}": _layer_init(gen, m, f, cfg, device)
                                       for i, (m, f) in enumerate(cfg.pattern)})
        if blocks is None:
            blocks = tree_map(lambda x: x.new_empty((cfg.n_superblocks,) + tuple(x.shape)),
                              block)
        tree_map(lambda dst, x: dst[b].copy_(x), blocks, block)
        del block
    params["blocks"] = blocks
    params["final_norm"] = _kept(keep, "final_norm", rmsnorm_init(
        cfg.d_model, dtype_of(cfg.param_dtype), device))
    return params


_MIXER_SPECS = {"attn": attn.gqa_specs, "attn_local": attn.gqa_specs,
                "attn_mla": attn.mla_specs, "mamba": mam.mamba_specs}


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(i is None or isinstance(i, str) for i in x)


def _stacked(specs: Specs) -> Specs:
    """Each spec of a superblock's tree with the leading ``n_superblocks``
    axis (unnamed) in front."""
    if _is_spec(specs):
        return (None,) + specs
    if isinstance(specs, dict):
        return {k: _stacked(v) for k, v in specs.items()}
    return [_stacked(v) for v in specs]


def _layer_specs(mixer: str, ffn: str, cfg: ModelConfig) -> Specs:
    s: Specs = {"norm1": rmsnorm_specs(), "mixer": _MIXER_SPECS[mixer](cfg)}
    if cfg.post_norm:
        s["norm1_post"] = rmsnorm_specs()
    if ffn != "none":
        s["norm2"] = rmsnorm_specs()
        s["ffn"] = moem.moe_specs(cfg) if ffn == "moe" else mlpm.mlp_specs(cfg)
        if cfg.post_norm:
            s["norm2_post"] = rmsnorm_specs()
    return s


def param_specs(cfg: ModelConfig) -> Specs:
    """The parameter tree's logical axis names (per trial, no lane axis),
    the JAX package's ``param_specs``."""
    specs: Specs = {"embedding": embedding_specs(cfg)}
    if cfg.prefix_pattern:
        specs["prefix"] = [_layer_specs(m, f, cfg) for m, f in cfg.prefix_pattern]
    specs["blocks"] = _stacked({f"l{i}": _layer_specs(m, f, cfg)
                                for i, (m, f) in enumerate(cfg.pattern)})
    specs["final_norm"] = rmsnorm_specs()
    return specs


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


def _dots_saveable(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the matmuls'
    outputs, recompute everything else (the JAX package's
    ``dots_with_no_batch_dims_saveable``; the port's projections are
    matmuls batched over the lane axis, so they count as dots)."""
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.bmm.default, aten.addmm.default, aten.baddbmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, remat: str, *args):
    """``fn(*args)``, its activations recomputed in the backward pass as
    ``remat`` says: ``"none"`` keeps them, ``"full"`` recomputes the whole
    call, ``"dots"`` keeps only the matmuls' outputs."""
    if remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    if remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _dots_saveable))
    raise ValueError(f"remat {remat!r}: 'none', 'full' or 'dots'")


def forward(params: Params, tokens: Optional[torch.Tensor], cfg: ModelConfig, *,
            inputs_embeds: Optional[torch.Tensor] = None, remat: str = "full",
            last_only: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (K, B, S), or ``inputs_embeds`` (K, B, S, d) in their place ->
    (logits fp32 (K, B, S, V), aux (K,)): each lane's MoE load-balancing loss
    summed over its layers (zeros without MoE).  ``last_only``: the final
    norm and the unembedding of the last position only, logits (K, B, 1, V)
    (serving prefill).  ``remat`` (``"none" | "full" | "dots"``, as the JAX
    package's) recomputes each superblock's activations in the backward
    pass (``torch.utils.checkpoint``); the values are the same bits.

    ``params`` is lane-batched: every leaf has the leading lane axis K.
    Under a trial mesh's sharding context it holds the rank's stored
    blocks, each part gathered where it is used (``sharding.at_use``): the
    embedding once, each superblock inside its checkpointed call (so the
    recompute gathers it again and one superblock's gathered weights are
    held at a time)."""
    emb = at_use(params["embedding"], "embedding")
    if inputs_embeds is not None:
        x = inputs_embeds.to(dtype_of(cfg.compute_dtype))
    else:
        x = embed_tokens(emb, tokens, cfg)
    positions = torch.arange(x.shape[2], device=x.device)
    aux = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for i, (m, f) in enumerate(cfg.prefix_pattern):
        x, aux = _layer_apply(at_use(params["prefix"][i], "prefix", i), x, m, f, cfg,
                              positions, aux)
    contexts = reentry()

    def superblock(x, sp):
        with contexts():
            sp = at_use(sp, "blocks")
            block_aux = torch.zeros_like(aux)   # summed as the reference's scan sums it
            for i, (m, f) in enumerate(cfg.pattern):
                x, block_aux = _layer_apply(sp[f"l{i}"], x, m, f, cfg, positions, block_aux)
        return x, block_aux

    # each stacked leaf split once along its superblock axis: the backward
    # stacks the slices' gradients once, where a select per superblock would
    # add n_superblocks zero-filled gradients of the whole leaf
    split = [a.unbind(1) for a in tree_leaves(params["blocks"])]
    for j in range(cfg.n_superblocks):
        sp = tree_unflatten(params["blocks"], [u[j] for u in split])
        x, block_aux = _remat(superblock, remat, x, sp)
        aux = aux + block_aux
    if last_only:
        x = x[:, :, -1:]
    x = apply_rmsnorm(x, at_use(params["final_norm"], "final_norm"), cfg.norm_eps)
    logits = unembed(emb, x, cfg)
    return logits, aux


# ------------------------------ serving (decode) ---------------------------------------
def _layer_cache_init(mixer: str, cfg: ModelConfig, K: int, batch: int, max_seq: int,
                      dtype, device) -> Params:
    if mixer == "mamba":
        return mam.mamba_cache_init(cfg, K, batch, dtype, device)
    if mixer == "attn_mla":
        return attn.mla_cache_init(cfg, K, batch, max_seq, dtype, device)
    return attn.gqa_cache_init(cfg, K, batch, max_seq, dtype, device)


def init_cache(cfg: ModelConfig, K: int, batch: int, max_seq: int, dtype,
               device) -> Params:
    """Zeroed decode caches for K lanes of ``batch`` rows and ``max_seq``
    positions: ``prefix`` a list of per-layer caches, ``blocks`` one
    superblock's caches with ``n_superblocks`` after the lane axis."""
    cache: Params = {}
    if cfg.prefix_pattern:
        cache["prefix"] = [_layer_cache_init(m, cfg, K, batch, max_seq, dtype, device)
                           for m, _ in cfg.prefix_pattern]
    one = {f"l{i}": _layer_cache_init(m, cfg, K, batch, max_seq, dtype, device)
           for i, (m, _) in enumerate(cfg.pattern)}
    cache["blocks"] = tree_map(
        lambda a: a[:, None].repeat((1, cfg.n_superblocks) + (1,) * (a.dim() - 1)), one)
    return cache


def _layer_cache_specs(mixer: str, cfg: ModelConfig) -> Specs:
    if mixer == "mamba":
        return mam.mamba_cache_specs(cfg)
    if mixer == "attn_mla":
        return attn.mla_cache_specs(cfg)
    return attn.gqa_cache_specs(cfg)


def cache_specs(cfg: ModelConfig) -> Specs:
    """The decode cache tree's logical axis names (per trial), the JAX
    package's ``cache_specs``."""
    specs: Specs = {}
    if cfg.prefix_pattern:
        specs["prefix"] = [_layer_cache_specs(m, cfg) for m, _ in cfg.prefix_pattern]
    specs["blocks"] = _stacked({f"l{i}": _layer_cache_specs(m, cfg)
                                for i, (m, _) in enumerate(cfg.pattern)})
    return specs


def _layer_decode(lp: Params, x: torch.Tensor, cache: Params, pos: int, mixer: str,
                  ffn: str, cfg: ModelConfig) -> torch.Tensor:
    """One layer at one position; ``cache`` is written in place.  The mixer's
    output joins the residual stream in the stream's dtype: a Mamba mixer
    under a wider (fp32) cache computes in the cache's dtype, and the JAX
    package's layer scan keeps the stream's dtype (it raises where the two
    differ)."""
    h = apply_rmsnorm(x, lp["norm1"], cfg.norm_eps)
    if mixer == "mamba":
        h, _ = mam.mamba_decode(lp["mixer"], h, cache, cfg)
    elif mixer == "attn_mla":
        h, _ = attn.mla_decode(lp["mixer"], h, cache, pos, cfg)
    else:
        h, _ = attn.gqa_decode(lp["mixer"], h, cache, pos, cfg, local=(mixer == "attn_local"))
    h = h.to(x.dtype)
    if cfg.post_norm:
        h = apply_rmsnorm(h, lp["norm1_post"], cfg.norm_eps)
    x = x + h
    if ffn == "none":
        return x
    h = apply_rmsnorm(x, lp["norm2"], cfg.norm_eps)
    if ffn == "moe":
        h, _ = moem.moe_apply(lp["ffn"], h, cfg, dropless=True)   # decode never drops
    else:
        h = mlpm.mlp_apply(lp["ffn"], h, cfg)
    if cfg.post_norm:
        h = apply_rmsnorm(h, lp["norm2_post"], cfg.norm_eps)
    return x + h


@torch.no_grad()
def decode_step(params: Params, cache: Params, tokens: torch.Tensor, pos: int,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    """One serving step: tokens (K, B, 1) at position ``pos`` -> (logits fp32
    (K, B, 1, V), cache): every layer's cache row ``pos`` written in place,
    the same tree returned.  Under a mesh's decode context
    (``train/serve_step.py::ServeLayout``) ``params`` and ``cache`` hold the
    rank's blocks and ``tokens`` its data rows: each part of the parameters
    is gathered where it is used (``sharding.at_use``), as ``forward``
    gathers it, and the mixers attend over the cache's blocks."""
    emb = at_use(params["embedding"], "embedding")
    x = embed_tokens(emb, tokens, cfg)
    for i, (m, f) in enumerate(cfg.prefix_pattern):
        x = _layer_decode(at_use(params["prefix"][i], "prefix", i), x, cache["prefix"][i],
                          pos, m, f, cfg)
    for j in range(cfg.n_superblocks):
        sp = at_use(tree_map(lambda a: a[:, j], params["blocks"]), "blocks")
        sc = tree_map(lambda a: a[:, j], cache["blocks"])
        for i, (m, f) in enumerate(cfg.pattern):
            x = _layer_decode(sp[f"l{i}"], x, sc[f"l{i}"], pos, m, f, cfg)
    x = apply_rmsnorm(x, at_use(params["final_norm"], "final_norm"), cfg.norm_eps)
    return unembed(emb, x, cfg), cache
