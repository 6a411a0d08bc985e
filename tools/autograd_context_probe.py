#!/usr/bin/env python3
"""Whether a checkpointed function recomputed in the backward pass sees the
context variables its caller set, on the CPU and on the card.

    python3 tools/autograd_context_probe.py

Runs ``torch.utils.checkpoint.checkpoint(fn, x, use_reentrant=False)`` on
a tensor of each device with a ``contextvars.ContextVar`` set around the
forward and the backward, and records, at each call of ``fn`` (the forward,
then the recompute), the variable's value and the thread.  Prints one JSON
line: torch's version and, per device, those pairs.  The trial mesh's
superblocks read their gathers' plans and the seams from context variables,
and ``repro_torch.distributed.sharding.reentry`` re-enters them inside a
recompute: this shows where a recompute would otherwise miss them (the
autograd engine runs CUDA work on a thread of its own).
"""
import contextvars
import json
import threading

import torch
from torch.utils.checkpoint import checkpoint

VAR = contextvars.ContextVar("probe", default=None)


def calls_on(device) -> list:
    seen = []

    def fn(x):
        seen.append([VAR.get(), threading.current_thread().name])
        return (x * 2).sin()

    x = torch.randn(4, device=device, requires_grad=True)
    tok = VAR.set("set")
    try:
        checkpoint(fn, x, use_reentrant=False).sum().backward()
    finally:
        VAR.reset(tok)
    return seen


def main() -> None:
    devices = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
    print(json.dumps({"torch": torch.__version__,
                      "calls": {d: calls_on(d) for d in devices}}))


if __name__ == "__main__":
    main()
