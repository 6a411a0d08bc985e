"""What one rank's step costs: a walk of the aten ops it dispatches.

The twin of the JAX package's ``launch/hlo_cost.py``, which walks the
post-SPMD HLO of the compiled step.  The port compiles nothing: a
``TorchDispatchMode`` (``OpCostWalk``) sees every aten op the step
dispatches, forward and backward, once each time it runs (a recomputed
superblock's ops twice, as its trip-counted loop body is in JAX's walk):

    flops       2 x result elements x contracted elements for ``mm``,
                ``bmm``, ``addmm``, ``baddbmm`` and ``convolution``
                (``_dot_flops`` / ``_conv_flops``); elementwise flops are
                ignored, as there
    bytes       operands plus result of every op that moves data, each
                distinct tensor once (an op that writes in place touches
                its operand once); view, alias and metadata ops, and the
                allocations that write nothing (``empty``), are skipped, as
                ``_SKIP_BYTES_OPS`` skips ``bitcast`` and the like.  In
                eager PyTorch every aten op is one kernel that reads and
                writes HBM, so no fusion adjustment applies.  Tensors on
                the host (a scalar wrapped to cross to the device) are not
                counted
    kernels     the hand-written kernels report their own work
                (``kernels/walk.py``: each kernel module's ``cost``), the
                twin of JAX's ``kernel_*`` named scopes: ``kernel_flops``
                and ``kernel_bytes`` are theirs, and they are in ``flops``
                and ``bytes`` too
    collectives every mesh collective's operand bytes and ring-model wire
                bytes (``op_stats``); their operand bytes are in ``bytes``
                too (the data still moves through HBM), as in JAX's walk

On the meta device the tensors keep their dtypes, so ``bytes_bf16eq ==
bytes`` and ``coll_tpu_wire == coll_wire``: JAX's f32 -> bf16 correction
undoes a promotion the CPU compiler makes, and the port makes none.  The
same walk runs on the card (a CUDA step under the mode), where it sees the
same ops.

**Memory** (the twin of ``compiled.memory_analysis()``): the walk tracks
every storage an op makes while it lives (a weak reference to the storage
frees its bytes when the last tensor on it dies).  The arguments' storages
are ``argument_size_in_bytes``; the high-water mark of the other live
storages is ``temp_size_in_bytes``; after the step, the live storages the
outputs hold that are not arguments are ``output_size_in_bytes``, those
that are (a state updated in place, a cache written in place) are
``alias_size_in_bytes``.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..kernels import walk as kernel_walk
from .op_stats import CollectiveLog

aten = torch.ops.aten

_DOTS = {aten.mm.default, aten.bmm.default, aten.addmm.default, aten.baddbmm.default}
_CONVS = {aten.convolution.default}
# ops that alias or allocate without writing, beyond those marked as views
_SKIP_BYTES_OPS = {
    aten._unsafe_view.default, aten.lift_fresh.default, aten.empty.memory_format,
    aten.empty_strided.default, aten.empty_like.default, aten.new_empty.default,
    aten.new_empty_strided.default, aten._local_scalar_dense.default,
}
_SKIP_NAMESPACES = ("c10d", "_c10d_functional", "_dtensor")


@dataclasses.dataclass
class Totals:
    """One rank's step: JAX's ``Totals`` fields, plus ``dot_flops`` /
    ``op_bytes`` (the aten ops' own), the kernels' records by name, the
    collectives by ``"axis/op"``, and the aten ops walked."""

    flops: float = 0.0
    bytes: float = 0.0
    bytes_bf16eq: float = 0.0
    kernel_flops: float = 0.0
    kernel_bytes: float = 0.0
    kernel_bytes_bf16eq: float = 0.0
    coll_operand: float = 0.0
    coll_wire: float = 0.0
    coll_tpu_wire: float = 0.0
    per_op: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    dot_flops: int = 0
    op_bytes: int = 0
    kernels: Dict[str, Dict[str, int]] = dataclasses.field(default_factory=dict)
    coll_by_axis: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    n_ops: int = 0


@dataclasses.dataclass
class Memory:
    argument_size_in_bytes: int = 0
    output_size_in_bytes: int = 0
    temp_size_in_bytes: int = 0
    alias_size_in_bytes: int = 0

    def to_json(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


def _tensors(tree) -> Iterable[torch.Tensor]:
    leaves, _ = tree_flatten(tree)
    return (x for x in leaves if isinstance(x, torch.Tensor))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dot_flops(func, args, out) -> int:
    """2 x result elements x contracted elements: the contracted size is the
    first (batched) matrix operand's last dim."""
    lhs = args[1] if func in (aten.addmm.default, aten.baddbmm.default) else args[0]
    return 2 * out.numel() * int(lhs.shape[-1])


def _conv_flops(args, out) -> int:
    """2 x output elements x (input channels a group x kernel window): the
    weight is (out_channels, in_channels / groups, *window)."""
    w = args[1]
    k = 1
    for d in w.shape[1:]:
        k *= int(d)
    return 2 * out.numel() * k


class OpCostWalk(TorchDispatchMode):
    """While open, the cost of every aten op dispatched, every hand-written
    kernel's record and every mesh collective (``totals``), and the live
    storages' bytes (``memory``).  ``args`` are the step's arguments: their
    storages count as arguments, not temporaries; with ``ops_log`` each op
    counted is kept in ``ops_log`` as ``[name, flops, bytes]``."""

    def __init__(self, args: Any = (), ops_log: bool = False):
        super().__init__()
        self.t = Totals()
        self.ops_log: Optional[list] = [] if ops_log else None
        self._args = {}   # storage id -> bytes
        for x in _tensors(args):
            st = x.untyped_storage()
            self._args[st._cdata] = st.nbytes()
        self._live: Dict[int, int] = {}   # non-argument storage id -> bytes
        self.live_bytes = 0
        self.peak_temp = 0
        self._coll = CollectiveLog()
        self._kernels = {}

    # -- the mode ---------------------------------------------------------------------
    def __enter__(self):
        kernel_walk.push(self._kernel)
        self._coll.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._coll.__exit__(*exc)
        kernel_walk.pop(self._kernel)
        return out

    def _counted(self, t: torch.Tensor) -> bool:
        return t.device.type != "cpu"

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._args or key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_temp = max(self.peak_temp, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = list(_tensors(out))
        for t in outs:
            if self._counted(t):
                self._track(t)
        if func.namespace in _SKIP_NAMESPACES or func.is_view or func in _SKIP_BYTES_OPS:
            return out
        self.t.n_ops += 1
        flops = (_dot_flops(func, args, out) if func in _DOTS
                 else _conv_flops(args, out) if func in _CONVS else 0)
        self.t.dot_flops += flops
        seen, nb = set(), 0
        for t in list(_tensors((args, kwargs))) + outs:
            if id(t) in seen or not self._counted(t):
                continue
            seen.add(id(t))
            nb += _nbytes(t)
        self.t.op_bytes += nb
        if self.ops_log is not None:
            self.ops_log.append([str(func), flops, nb])
        return out

    def _kernel(self, name: str, flops: int, nbytes: int) -> None:
        if self.ops_log is not None:
            self.ops_log.append([f"kernel:{name}", flops, nbytes])
        k = self._kernels.setdefault(name, {"launches": 0, "flops": 0, "bytes": 0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    # -- the results -------------------------------------------------------------------
    @property
    def totals(self) -> Totals:
        t = dataclasses.replace(self.t, kernels={k: dict(v) for k, v in self._kernels.items()})
        t.kernel_flops = float(sum(k["flops"] for k in t.kernels.values()))
        t.kernel_bytes = t.kernel_bytes_bf16eq = float(sum(k["bytes"] for k in t.kernels.values()))
        stats = self._coll.stats()
        t.per_op = {op: dict(d, tpu_wire_bytes=d["wire_bytes"]) for op, d in stats.per_op.items()}
        t.coll_by_axis = stats.by_axis
        t.coll_operand = float(stats.operand_bytes)
        t.coll_wire = t.coll_tpu_wire = float(stats.wire_bytes)
        t.flops = float(t.dot_flops) + t.kernel_flops
        t.bytes = t.bytes_bf16eq = float(t.op_bytes) + t.kernel_bytes + t.coll_operand
        return t

    def memory(self, outputs: Any = ()) -> Memory:
        out_b = alias_b = 0
        seen = set()
        for x in _tensors(outputs):
            st = x.untyped_storage()
            if st._cdata in seen:
                continue
            seen.add(st._cdata)
            if st._cdata in self._args:
                alias_b += st.nbytes()
            else:
                out_b += st.nbytes()
        return Memory(argument_size_in_bytes=sum(self._args.values()),
                      output_size_in_bytes=out_b, temp_size_in_bytes=self.peak_temp,
                      alias_size_in_bytes=alias_b)


def walk(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under an ``OpCostWalk`` whose arguments are
    ``args``: (its result, ``Totals``, ``Memory``)."""
    with OpCostWalk(args) as w:
        out = fn(*args, **kwargs)
    return out, w.totals, w.memory(out)
