"""Where the hand-written kernels report their work to an op-cost walk.

``launch/op_cost.py`` walks the aten ops one step dispatches; a kernel
launch is no aten op, so each wrapper reports its kernel's own work here
(``record``: the name, its operations and the HBM bytes it reads and
writes, from the kernel module's ``cost``) on the card, when a walk is
active, and on the meta device, where the wrapper returns empty outputs of
the kernel's shapes and launches nothing.  With no walk active a record
goes nowhere.
"""
from __future__ import annotations

from typing import Callable, List

_SINKS: List[Callable[[str, int, int], None]] = []


def record(name: str, flops: int, nbytes: int) -> None:
    """One launch of kernel ``name``: ``flops`` operations, ``nbytes`` bytes."""
    for sink in _SINKS:
        sink(name, int(flops), int(nbytes))


def active() -> bool:
    return bool(_SINKS)


def push(sink: Callable[[str, int, int], None]) -> None:
    _SINKS.append(sink)


def pop(sink: Callable[[str, int, int], None]) -> None:
    _SINKS.remove(sink)
