"""Collective traffic of one rank's step, from the port's own record.

The twin of the JAX package's ``launch/hlo_stats.py``.  The port has no
HLO to parse: every collective a mesh makes goes through
``distributed/sharding.py`` (``axis_all_gather``, ``axis_all_reduce``,
``axis_reduce_scatter``, ``model_all_reduce``), which tells its listeners
each op's axis, group size n and operand bytes (an all-gather's input, a
reduce-scatter's and an all-reduce's whole tensor).  ``CollectiveLog``
listens while it is open; the wire bytes of each op are its operand bytes
times JAX's ring model (``_wire_factor``, a copy of ``hlo_stats.py``'s):

    all-reduce        2 (n-1)/n x operand      (ring reduce-scatter + all-gather)
    all-gather        (n-1)   x operand        (each device receives n-1 shards)
    reduce-scatter    (n-1)/n x operand
    all-to-all        (n-1)/n x operand
    collective-permute       1 x operand

``CollectiveStats`` keeps ``hlo_stats.py``'s ``summary()`` keys, by JAX's op
names; ``by_axis`` adds the same by ``"axis/op"``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute", "ragged-all-to-all", "collective-broadcast",
)

# the port's op names (``sharding._count``) -> JAX's
PORT_OPS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
            "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all"}


def _wire_factor(op: str, n: int) -> float:
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (n - 1) / n
    if op == "all-gather":
        return float(n - 1)
    if op in ("reduce-scatter", "all-to-all", "ragged-all-to-all"):
        return (n - 1) / n
    if op == "collective-broadcast":
        return 1.0
    return 1.0  # collective-permute


@dataclasses.dataclass
class CollectiveStats:
    per_op: Dict[str, Dict[str, float]]      # op -> {count, operand_bytes, wire_bytes}
    operand_bytes: int
    wire_bytes: float
    by_axis: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)

    def summary(self) -> Dict:
        return {
            "per_op": self.per_op,
            "operand_bytes": self.operand_bytes,
            "wire_bytes": self.wire_bytes,
        }


def collective_stats(records: List[Tuple[str, str, int, int]]) -> CollectiveStats:
    """``records``: ``(axis, op, n, operand bytes)`` of each collective, op
    by the port's name or JAX's."""
    per_op: Dict[str, Dict[str, float]] = {}
    by_axis: Dict[str, Dict[str, float]] = {}
    total_operand, total_wire = 0, 0.0
    for axis, op, n, obytes in records:
        op = PORT_OPS.get(op, op)
        wire = obytes * _wire_factor(op, n)
        for d in (per_op.setdefault(op, {"count": 0, "operand_bytes": 0, "wire_bytes": 0.0}),
                  by_axis.setdefault(f"{axis}/{op}",
                                     {"count": 0, "operand_bytes": 0, "wire_bytes": 0.0})):
            d["count"] += 1
            d["operand_bytes"] += obytes
            d["wire_bytes"] += wire
        total_operand += obytes
        total_wire += wire
    return CollectiveStats(per_op=per_op, operand_bytes=total_operand, wire_bytes=total_wire,
                           by_axis=by_axis)


class CollectiveLog:
    """While open, every collective a mesh of this process makes, as
    ``(axis, op, n, operand bytes)`` in ``records``."""

    def __init__(self):
        self.records: List[Tuple[str, str, int, int]] = []

    def _on(self, axis: str, op: str, n: int, operand: int) -> None:
        self.records.append((axis, op, n, operand))

    def __enter__(self) -> "CollectiveLog":
        from ..distributed import sharding

        sharding.collective_listeners.append(self._on)
        return self

    def __exit__(self, *exc) -> None:
        from ..distributed import sharding

        sharding.collective_listeners.remove(self._on)

    def stats(self) -> CollectiveStats:
        return collective_stats(self.records)
