"""Serving: batched single-token decode, greedy or by temperature sampling.

The twin of the JAX package's ``train/serve_step.py``, lane-batched: tokens
are ``(K, B, 1)``.  Temperature 0 takes the first maximum (``torch.argmax``,
as ``jnp.argmax``); a temperature above 0 draws from ``softmax(last / T)``
with an explicit ``torch.Generator`` on the step's device (the JAX package
draws with its own key, whose stream the port cannot reproduce).

``ServeLayout`` is prefill and decode on a trial mesh (the dry run's
``prefill_*``, ``decode_*`` and ``long_500k`` cells).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from ..configs.base import ModelConfig
from ..distributed.sharding import (axis_size, build_pspec, build_sharding, make_rules,
                                    map_specs, shard_tree, sharded_dims, sharding_context,
                                    tp_module_flags, tp_shard_context)
from ..interop import add_lane_axis, tree_map
from ..models import attention as attn
from ..models import transformer as T
from .train_step import block_of, init_placement, use_plans


def make_serve_step(cfg: ModelConfig, temperature: float = 0.0) -> Callable:
    """(params, cache, tokens (K, B, 1), pos, [generator]) -> (next tokens
    (K, B, 1) int32, cache); the cache is written in place."""

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos, generator=None):
        logits, cache = T.decode_step(params, cache, tokens, pos, cfg)
        last = logits[:, :, -1]                                    # (K, B, V)
        if temperature > 0.0 and generator is not None:
            probs = torch.softmax(last / temperature, dim=-1)
            nxt = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                                    generator=generator).reshape(last.shape[:-1])
        else:
            nxt = torch.argmax(last, dim=-1)
        return nxt[..., None].to(torch.int32), cache

    return serve_step


def greedy_generate(params, cfg: ModelConfig, prompt: torch.Tensor, n_new: int,
                    max_seq: int) -> torch.Tensor:
    """Prompt (K, B, P) -> (K, B, P + n_new): the prompt fed a token a step,
    then greedy tokens; an fp32 cache, as the JAX package's loop keeps."""
    cache = T.init_cache(cfg, prompt.shape[0], prompt.shape[1], max_seq,
                         dtype=torch.float32, device=prompt.device)
    step = make_serve_step(cfg)
    P = prompt.shape[2]
    tok = prompt[:, :, :1]
    out = [tok]
    for i in range(P + n_new - 1):
        nxt, cache = step(params, cache, tok, i)
        tok = prompt[:, :, i + 1:i + 2] if i + 1 < P else nxt
        out.append(tok)
    return torch.cat(out, dim=2)


class ServeLayout:
    """Where one model's parameters and decode cache live on a trial mesh
    (``launch/mesh.py``) for serving: the twin of the JAX dry run's
    ``build_sharding(params, param_specs(cfg), rules, mesh)`` and
    ``build_sharding(cache, cache_specs(cfg), rules, mesh)`` under
    ``make_rules(mesh axes, shard_cache_seq=...)``; a rank stores its block
    of each leaf.  The batch's rows split over the data axes where they
    divide them (a rank decodes its rows; else every data rank decodes them
    all), the parameters are gathered where they are used
    (``train_step.use_plans``), attention, the dense MLP, Mamba and the MoE
    experts split over the model axis as in training, under the seams, and
    the attention mixers read where their cache is stored from the decode
    context (``models/attention.py``).  Every method takes and returns one
    trial's trees and tensors (no lane axis)."""

    def __init__(self, cfg: ModelConfig, mesh, shard_cache_seq: bool = False):
        self.cfg, self.mesh = cfg, mesh
        self.rules = make_rules(mesh.axis_names, shard_cache_seq=shard_cache_seq)
        shapes = T.init_params(torch.Generator(), cfg, "meta")
        specs = T.param_specs(cfg)
        self.param_placements = build_sharding(shapes, specs, self.rules, mesh)
        self.uses = use_plans(cfg, mesh, self.param_placements, specs)
        self.flags = tp_module_flags(cfg, mesh.width)
        self._placed: dict = {}   # (batch, max_seq) -> _cache_placed's

    def _pspec(self, shape, logical) -> tuple:
        return build_pspec(shape, logical, self.rules, self.mesh)

    def _cache_placed(self, batch: int, max_seq: int):
        """(each cache leaf's placement, the axes its rows split over).
        Every layer's cache holds the rows its rank decodes, so where the
        kinds' rows would split differently (a long attention cache beside
        Mamba's), every kind holds them all."""
        key = (int(batch), int(max_seq))
        if key not in self._placed:
            whole = tree_map(lambda a: a[0], T.init_cache(self.cfg, 1, batch, max_seq,
                                                          torch.bfloat16, "meta"))
            specs = T.cache_specs(self.cfg)
            placed = build_sharding(whole, specs, self.rules, self.mesh)
            rows = set()
            map_specs(placed, specs, lambda p, logical: rows.add(p[logical.index("batch")]))
            if len(rows) == 1:
                self._placed[key] = placed, rows.pop()
            else:
                self._placed[key] = map_specs(placed, specs, lambda p, logical: tuple(
                    None if n == "batch" else a for a, n in zip(p, logical))), None
        return self._placed[key]

    def rows(self, batch: int, max_seq: Optional[int] = None) -> slice:
        """This rank's rows of a batch of ``batch`` rows: the tokens' split,
        or with ``max_seq`` the decode cache's (a long cache whose positions
        claim the data axis holds every row, and every rank decodes them)."""
        axis = (self._pspec((batch,), ("batch",))[0] if max_seq is None
                else self._cache_placed(batch, max_seq)[1])
        if axis is None or axis_size(self.mesh, axis) == 1:
            return slice(0, batch)
        n = batch // axis_size(self.mesh, axis)
        return slice(self.mesh.axis_index(axis) * n, (self.mesh.axis_index(axis) + 1) * n)

    def cache_placements(self, batch: int, max_seq: int):
        """The placement of each leaf of the decode cache (one trial's:
        ``blocks`` leaves with the superblock axis first)."""
        return self._cache_placed(batch, max_seq)[0]

    def caches(self, batch: int, max_seq: int) -> dict:
        """Each attention cache kind's placement, per layer (the decode
        context's ``caches``)."""
        cfg, rows = self.cfg, self._cache_placed(batch, max_seq)[1]
        out = {"gqa": self._pspec((batch, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim),
                                  attn.gqa_cache_specs(cfg)["k"]),
               "mla": self._pspec((batch, max_seq, cfg.kv_lora_rank),
                                  attn.mla_cache_specs(cfg)["c"])}
        return {k: (rows,) + tuple(p[1:]) for k, p in out.items()}

    def init_params(self, gen: torch.Generator) -> dict:
        """This rank's blocks of ``T.init_params(gen, cfg)``, on its device."""
        return T.init_params(gen, self.cfg, self.mesh.device, keep=lambda part, path, leaf:
                             block_of(leaf, init_placement(self.param_placements, part, path),
                                      self.mesh))

    def shard_params(self, whole) -> dict:
        return shard_tree(whole, self.param_placements, self.mesh)

    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16) -> dict:
        """This rank's blocks of a zeroed cache of ``batch`` rows and
        ``max_seq`` positions, on its device."""
        def block(leaf, placement):
            shape = list(leaf.shape)
            for i, a in sharded_dims(placement, self.mesh):
                shape[i] //= axis_size(self.mesh, a)
            return torch.zeros(shape, dtype=leaf.dtype, device=self.mesh.device)

        whole = tree_map(lambda a: a[0], T.init_cache(self.cfg, 1, batch, max_seq, dtype,
                                                      "meta"))
        return map_specs(whole, self.cache_placements(batch, max_seq), block)

    def _contexts(self, caches=None):
        stack = contextlib.ExitStack()
        stack.enter_context(sharding_context(self.mesh, self.uses, caches=caches))
        stack.enter_context(tp_shard_context(self.mesh, self.flags))
        return stack

    @torch.no_grad()
    def decode(self, params, cache, tokens: torch.Tensor, pos: int, batch: int,
               max_seq: int) -> torch.Tensor:
        """One decode step on this rank: ``tokens`` its rows (B_local, 1) of a
        batch of ``batch`` rows at ``pos``; ``cache`` its blocks of the
        ``max_seq`` cache, written in place.  Returns its rows' logits
        (B_local, 1, V) fp32."""
        with self._contexts(self.caches(batch, max_seq)):
            logits, _ = T.decode_step(add_lane_axis(params), add_lane_axis(cache),
                                      tokens[None], pos, self.cfg)
        return logits[0]

    @torch.no_grad()
    def prefill(self, params, tokens: Optional[torch.Tensor] = None,
                embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``forward(..., last_only=not encoder_only)`` on this rank's rows:
        the last position's logits (every position's for an encoder-only
        model), fp32."""
        with self._contexts():
            logits, _ = T.forward(add_lane_axis(params),
                                  None if tokens is None else tokens[None], self.cfg,
                                  inputs_embeds=None if embeds is None else embeds[None],
                                  remat="none", last_only=not self.cfg.encoder_only)
        return logits[0]
