"""Serving: batched single-token decode, greedy or by temperature sampling.

The twin of the JAX package's ``train/serve_step.py``, lane-batched: tokens
are ``(K, B, 1)``.  Temperature 0 takes the first maximum (``torch.argmax``,
as ``jnp.argmax``); a temperature above 0 draws from ``softmax(last / T)``
with an explicit ``torch.Generator`` on the step's device (the JAX package
draws with its own key, whose stream the port cannot reproduce).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..configs.base import ModelConfig
from ..models import transformer as T


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
