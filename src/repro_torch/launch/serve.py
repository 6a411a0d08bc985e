"""Batched serving: a continuous-batching decode loop, on the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch gemma2-9b --requests 8 --batch 4 --new-tokens 16

The twin of ``repro.launch.serve``: the same flags (and ``--device``, cuda
unless cpu is asked for; without a GPU it raises), the same request queue
drawn from ``numpy.random.default_rng(seed)``, the same slot filling and
printed lines.  Requests are fed a prompt token a step through
``train/serve_step.py`` and then decode; a request enters a free slot at
the loop's current position, which every slot shares, and the cache is
reset once that position reaches ``max_seq - 1``.  As in the reference, a
request that enters a freed slot at a position above 0 attends to the cache
rows its slot's earlier request left below that position.  The cache is
fp32, as the reference's.  An encoder-only architecture has no decode path:
the CLI says so and exits 0.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig


def serve_requests(cfg: ModelConfig, params, *, batch: int, requests: int, prompt_len: int,
                   new_tokens: int, max_seq: int, temperature: float = 0.0, seed: int = 0,
                   device) -> Tuple[Dict[int, List[int]], int, float, List[float]]:
    """Serve ``requests`` requests on ``batch`` slots with one lane's
    parameters (K = 1, every leaf's leading axis): (each request's emitted
    tokens by id, decode steps, wall seconds, each step's host seconds; a
    step ends when its tokens reach the host)."""
    from ..models import transformer as T
    from ..train.serve_step import make_serve_step

    step = make_serve_step(cfg, temperature=temperature)
    gen = torch.Generator(device=device).manual_seed(seed)
    # request queue: (id, prompt tokens), drawn as the reference draws them
    rng = np.random.default_rng(seed)
    queue = [
        (i, rng.integers(1, cfg.vocab_size, size=rng.integers(2, prompt_len + 1)))
        for i in range(requests)
    ]
    B = batch
    cache = T.init_cache(cfg, 1, B, max_seq, dtype=torch.float32, device=device)
    slots: list = [None] * B
    outputs: Dict[int, List[int]] = {}
    pos = 0
    steps = 0
    step_seconds: List[float] = []
    t0 = time.time()
    while queue or any(s is not None for s in slots):
        # fill free slots (continuous batching: a new request enters at the current pos)
        for b in range(B):
            if slots[b] is None and queue:
                rid, prompt = queue.pop(0)
                slots[b] = {"id": rid, "prompt": list(prompt), "out": [], "fed": 0}
        # this step's token a slot: the prompt's next, or the last one generated
        tok = np.zeros((1, B, 1), np.int32)
        for b, s in enumerate(slots):
            if s is None:
                continue
            if s["fed"] < len(s["prompt"]):
                tok[0, b, 0] = s["prompt"][s["fed"]]
            else:
                tok[0, b, 0] = s["out"][-1] if s["out"] else 0
        ts = time.perf_counter()
        nxt, cache = step(params, cache, torch.from_numpy(tok).to(device), pos, gen)
        nxt = nxt.cpu().numpy()
        step_seconds.append(time.perf_counter() - ts)
        steps += 1
        pos += 1
        for b, s in enumerate(slots):
            if s is None:
                continue
            s["fed"] += 1
            if s["fed"] >= len(s["prompt"]):
                s["out"].append(int(nxt[0, b, 0]))
            if len(s["out"]) >= new_tokens or pos >= max_seq - 1:
                outputs[s["id"]] = s["out"]
                slots[b] = None
        if pos >= max_seq - 1:
            # cache full: flush the remaining slots (the reference's simplification)
            for b, s in enumerate(slots):
                if s is not None:
                    outputs[s["id"]] = s["out"]
                    slots[b] = None
            if queue:
                cache = T.init_cache(cfg, 1, B, max_seq, dtype=torch.float32, device=device)
                pos = 0
    return outputs, steps, time.time() - t0, step_seconds


def report(outputs: Dict[int, List[int]], steps: int, seconds: float, batch: int) -> List[str]:
    """The reference's printed lines: one a request, then the totals."""
    lines = [f"req {rid}: {outputs[rid][:10]}{'...' if len(outputs[rid]) > 10 else ''}"
             for rid in sorted(outputs)]
    lines.append(f"{len(outputs)} requests, {steps} decode steps, {seconds:.1f}s "
                 f"({steps * batch / max(seconds, 1e-9):.1f} tok/s batched)")
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="starcoder2-3b")
    p.add_argument("--smoke", action="store_true", default=True)
    p.add_argument("--batch", type=int, default=4, help="decode batch slots")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=12, help="max prompt length")
    p.add_argument("--new-tokens", type=int, default=16)
    p.add_argument("--max-seq", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to serve (default cuda; without a GPU the CLI "
                        "raises unless cpu is asked for)")
    args = p.parse_args(argv)

    from ..configs import get_config, get_smoke_config
    from ..interop import add_lane_axis
    from ..models import transformer as T
    from .hpo import resolve_device

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.encoder_only:
        print(f"{args.arch} is encoder-only: no decode serving path")
        return 0
    device = resolve_device(args.device)
    params = add_lane_axis(T.init_params(torch.Generator(device=device).manual_seed(args.seed),
                                         cfg, device))
    outputs, steps, seconds, _ = serve_requests(
        cfg, params, batch=args.batch, requests=args.requests, prompt_len=args.prompt_len,
        new_tokens=args.new_tokens, max_seq=args.max_seq, temperature=args.temperature,
        seed=args.seed, device=device)
    for line in report(outputs, steps, seconds, args.batch):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
