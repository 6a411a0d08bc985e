"""The population mesh: an HPO population's K lanes split over the ranks of a
``torch.distributed`` process group.

The JAX package lays the population axis on a 1-D device mesh and runs each
engine under ``shard_map`` from one controller.  The port's twin is SPMD: N
processes, one rank a device, each holding a contiguous block of K/N lanes
(``PopulationMesh.lane_block``) and training it with the lane-batched step;
the lanes share no math, so the only traffic is what the engines move
explicitly: the K-length per-lane vectors (losses, latches, budgets) by an
``all_gather``, and whole lanes by point-to-point sends (a clone whose donor
lives on another rank, a snapshot harvested on its owner).

Backends: NCCL for CUDA ranks, gloo for CPU ranks.  A gloo group may also
join CUDA ranks (two ranks sharing one card, where NCCL refuses two ranks
on one device).  gloo takes CUDA tensors for ``all_gather`` and
``broadcast`` but not for point-to-point sends (torch 2.11 aborts on the
device pointer: ``tools/gloo_cuda_probe.py``), so under gloo ``exchange``
copies a CUDA tensor into a page-locked host buffer, sends that, and copies
what arrives back to the device.  That staging is the gloo transport, taken
only under gloo; NCCL takes the device tensors.

Every collective runs under the group's timeout (``timeout_s``): a rank
that dies makes the others raise instead of hang.

**The two-level ``(pop, model)`` mesh** (``width`` W > 1,
``--model-parallel W``): the N ranks form ``rows = N / W`` lane rows of W
ranks.  Rank r sits in row ``r // W`` at model position ``r % W``; a row's
ranks hold the same K/rows lanes, each only its model position's shard of
the leaves the width rules (``tp_width_rules``) shard, and every rank of a
row sees the same batch.  Two kinds of groups join them: a row's W ranks
(the *model group*, which the seams ``tp_enter`` / ``tp_reduce`` and the
per-lane gradient norm all-reduce over) and the rows' ranks at one model
position (the *pop group*, which the per-lane vectors are gathered over).
gloo takes CUDA tensors in ``all_reduce`` (``tools/gloo_cuda_probe.py``),
so the seams hand it the device tensors.

While a mesh lives, the RMSNorm backward plans a rank's K/rows lanes as the
whole population's K (``kernels/rmsnorm.py::plan_for_mesh(rows)``), so a
lane's gain gradient takes the unsharded launch's bits.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import os
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..interop import tree_leaves, tree_unflatten
from ..kernels import rmsnorm

DEFAULT_TIMEOUT_S = 300.0
PART_C = "ROADMAP.md section 1, item 12(c) (elastic regrid)"
_ALIGN = 8   # byte alignment of each leaf in a packed gather
Rules = Dict[str, Tuple[str, ...]]


@dataclasses.dataclass(eq=False)
class PopulationMesh:
    """This rank's place on a population mesh of ``world_size`` ranks.

    ``device`` is the rank's device, ``backend`` the group's (``nccl`` or
    ``gloo``), ``group`` the process group (None: the default group).  The
    ranks form ``rows`` lane rows of ``width`` ranks (width 1: a row is a
    rank).  A population of K lanes splits into contiguous blocks of
    K/rows: row i owns lanes ``[i*K/rows, (i+1)*K/rows)``, and every rank of
    the row holds them.  ``model_group`` joins this rank's row, ``pop_group``
    the ranks at its model position (at width 1 the whole mesh)."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    group: Any = None
    axis: str = "pop"
    timeout_s: float = DEFAULT_TIMEOUT_S
    owns_group: bool = False
    devices: tuple = ()   # every rank's device, in rank order
    width: int = 1
    model_group: Any = None
    pop_group: Any = None
    # held by rank 0 for a whole flight: the ranks apply one flight's ops in
    # the order rank 0 sends them, so two flights may not interleave
    flight_lock: Any = dataclasses.field(default_factory=threading.RLock, repr=False)

    @property
    def key(self) -> tuple:
        """What a program compiled for this mesh depends on."""
        return (self.axis, self.backend, int(self.world_size), int(self.rank),
                str(self.device)) + ((int(self.width),) if self.width > 1 else ())

    @property
    def rows(self) -> int:
        return self.world_size // self.width

    @property
    def row(self) -> int:
        return self.rank // self.width

    @property
    def model_rank(self) -> int:
        return self.rank % self.width

    def rank_at(self, row: int, model_rank: Optional[int] = None) -> int:
        """The global rank at ``row`` and ``model_rank`` (default: this
        rank's model position)."""
        return int(row) * self.width + (self.model_rank if model_rank is None
                                        else int(model_rank))

    # -- lane arithmetic ------------------------------------------------------
    def block_size(self, k: int) -> int:
        if int(k) % self.rows:
            raise ValueError(f"population {k} does not divide over {self.rows} lane rows")
        return int(k) // self.rows

    def lane_block(self, k: int) -> range:
        """The global lanes this rank's row owns."""
        blk = self.block_size(k)
        return range(self.row * blk, (self.row + 1) * blk)

    def block(self, x, k: int):
        """This rank's block of ``x``'s leading (lane) axis: a tensor view, a
        numpy view or a list slice."""
        r = self.lane_block(k)
        return x[r.start:r.stop]

    # -- collectives ----------------------------------------------------------
    def _staged(self, t: torch.Tensor) -> bool:
        """A point-to-point transfer of ``t`` goes through host memory."""
        return self.backend == "gloo" and t.is_cuda

    @staticmethod
    def _host(t: torch.Tensor) -> torch.Tensor:
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t)
        return out

    def broadcast_object(self, obj: Any = None) -> Any:
        """Rank 0's ``obj`` on every rank (pickled; host data only)."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def _all_gather_bytes(self, send: torch.Tensor) -> torch.Tensor:
        """``(rows, nbytes)`` uint8: every row's ``send`` (uint8, 1-D), row i
        from the rank of row i at this rank's model position."""
        out = torch.empty((self.rows, send.numel()), dtype=torch.uint8, device=send.device)
        if self.backend == "nccl":
            dist.all_gather_into_tensor(out, send, group=self.pop_group)
        else:
            dist.all_gather(list(out.unbind(0)), send, group=self.pop_group)
        return out

    def all_gather_lanes(self, tree: Any, dim: int = 0) -> Any:
        """Every leaf of ``tree`` (this row's block, its lane axis at
        ``dim``) gathered whole over the rows, in lane order: one
        collective for the whole tree over the pop group, its leaves packed
        as raw bytes, so the result is bit for bit what each row held."""
        leaves = tree_leaves(tree)
        if not leaves:
            return tree
        parts, metas, off = [], [], 0
        for leaf in leaves:
            x = (leaf.movedim(dim, 0) if dim else leaf).contiguous()
            n = x.numel() * x.element_size()
            parts.append(x.reshape(-1).view(torch.uint8))
            pad = -n % _ALIGN
            if pad:
                parts.append(torch.zeros(pad, dtype=torch.uint8, device=x.device))
            metas.append((off, n, tuple(x.shape), x.dtype))
            off += n + pad
        out = self._all_gather_bytes(torch.cat(parts))
        got = []
        for o, n, shape, dtype in metas:
            y = out[:, o:o + n].contiguous().view(dtype)
            y = y.reshape((self.rows * shape[0],) + shape[1:])
            got.append(y.movedim(0, dim) if dim else y)
        return tree_unflatten(tree, got)

    def exchange(self, sends, recvs) -> None:
        """Point-to-point transfers, all posted at once: ``sends`` and
        ``recvs`` are lists of ``(tensor, peer)``; every rank lists its
        transfers with one peer in the same order, so they pair up."""
        if not sends and not recvs:
            return
        staged_in = []
        ops = []
        for buf, peer in recvs:
            if self._staged(buf):
                host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
                staged_in.append((buf, host))
                buf = host
            ops.append(dist.P2POp(dist.irecv, buf, int(peer), group=self.group))
        for buf, peer in sends:
            if self._staged(buf):
                buf = self._host(buf)
            ops.append(dist.P2POp(dist.isend, buf, int(peer), group=self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for buf, host in staged_in:
            buf.copy_(host)

    def model_all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over this rank's row, in place (the seams' and the
        gradient norm's collective; counted in ``tp_collectives``)."""
        global _TP_COLLECTIVES, _TP_BYTES
        dist.all_reduce(t, group=self.model_group)
        _TP_COLLECTIVES += 1
        _TP_BYTES += t.numel() * t.element_size()
        return t

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def destroy(self) -> None:
        """Leave the process group, if this mesh made it."""
        global _CURRENT
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False
        if _CURRENT is self:
            _CURRENT = None
            rmsnorm.plan_for_mesh(1)


_CURRENT: Optional[PopulationMesh] = None   # the mesh this process made or joined


def _rank_device(device, local_rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA population mesh needs a GPU; pass device='cpu' "
                               "(CLI: --device cpu) for CPU ranks")
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def population_mesh(device=None, axis: str = "pop", width: Optional[int] = None,
                    backend: Optional[str] = None, init_method: Optional[str] = None,
                    rank: Optional[int] = None, world_size: Optional[int] = None,
                    timeout_s: float = DEFAULT_TIMEOUT_S) -> PopulationMesh:
    """This process's rank of a population mesh (the twin of the JAX
    package's ``population_mesh``): a 1-D mesh whose axis ``axis`` is the
    population axis, one rank a device.

    The process group is, in order: the one already initialised; one made
    from ``init_method`` with ``rank`` and ``world_size`` (e.g. a
    ``file://`` store shared by spawned ranks); one from ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``); else a world of
    one, made in this process.  ``device`` is ``cpu`` or ``cuda`` (a CUDA
    rank takes ``cuda:LOCAL_RANK``) or an explicit ``cuda:i``; the backend
    is NCCL for CUDA and gloo for the CPU unless ``backend`` names one.
    Called again (``device`` None, or the same, and the same width), it
    returns the mesh this process already made or joined.  ``width`` W > 1
    makes the mesh two-level: ``N / W`` lane rows of W ranks (it must
    divide N); every rank makes every row's and every model position's
    group, in the same order, as ``torch.distributed`` requires."""
    global _CURRENT
    w = 1 if width is None else int(width)
    if w < 1:
        raise ValueError(f"population mesh width {width} must be at least 1")
    if _CURRENT is not None and dist.is_initialized() and _CURRENT.width == w and (
            device is None or _rank_device(device, _CURRENT.device.index or 0)
            == _CURRENT.device):
        return _CURRENT
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    env = os.environ
    owns = False
    if not dist.is_initialized():
        timeout = datetime.timedelta(seconds=float(timeout_s))
        if init_method is not None:
            r, n = int(rank), int(world_size)
            kw = dict(init_method=init_method, rank=r, world_size=n)
        elif "WORLD_SIZE" in env and "MASTER_ADDR" in env:
            r, n = int(env["RANK"]), int(env["WORLD_SIZE"])
            kw = dict(init_method="env://")
        else:
            r, n = 0, 1
            kw = dict(store=dist.HashStore(), rank=0, world_size=1)
        dev = _rank_device(device, int(env.get("LOCAL_RANK", r)))
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev
        dist.init_process_group(backend, timeout=timeout, **kw)
        owns = True
    else:
        r, n = dist.get_rank(), dist.get_world_size()
        dev = _rank_device(device, int(env.get("LOCAL_RANK", r)))
        backend = backend or dist.get_backend()
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
    if n % w:
        if owns:
            dist.destroy_process_group()
        raise ValueError(f"width {w} does not tile {n} ranks into lane rows")
    devices = [str(dev)] * n
    if n > 1:
        dist.all_gather_object(devices, str(dev))
    model_group = pop_group = None
    if w > 1:
        rows = n // w
        for i in range(rows):   # every rank makes every group, in one order
            g = dist.new_group(list(range(i * w, (i + 1) * w)))
            if i == r // w:
                model_group = g
        for j in range(w):
            g = dist.new_group(list(range(j, n, w)))
            if j == r % w:
                pop_group = g
    _CURRENT = PopulationMesh(rank=r, world_size=n, device=dev, backend=str(backend),
                              axis=axis, timeout_s=float(timeout_s), owns_group=owns,
                              devices=tuple(torch.device(d) for d in devices), width=w,
                              model_group=model_group, pop_group=pop_group)
    rmsnorm.plan_for_mesh(n // w)
    return _CURRENT


def population_specs(tree: Any, mesh: PopulationMesh) -> Any:
    """Per leaf of ``tree``, where it lives on ``mesh``: ``"pop"`` (its
    leading axis is blocked over the ranks) or ``"rep"`` (every rank holds
    all of it).  Rank-0 leaves, and leaves whose leading dim does not divide
    over the ranks (scalar rule state, history rings, window counters), are
    replicated, as the JAX package's ``population_specs`` places them."""
    from ..interop import tree_map

    def one(leaf):
        shape = tuple(getattr(leaf, "shape", np.shape(leaf)))
        return "rep" if len(shape) < 1 or shape[0] % mesh.rows else "pop"

    return tree_map(one, tree)


def map_specs(shapes: Any, specs: Any, fn):
    """Walk a (nested dict / list) tree in lockstep with its specs tree,
    whose leaves are tuples of logical axis names (the JAX package's
    ``map_specs``)."""
    if _is_spec_leaf(specs):
        return fn(shapes, specs)
    if isinstance(specs, dict):
        return {k: map_specs(shapes[k], specs[k], fn) for k in specs}
    if isinstance(specs, (list, tuple)):
        return type(specs)(map_specs(a, b, fn) for a, b in zip(shapes, specs))
    raise TypeError(f"bad specs node: {type(specs)}")


def _is_spec_leaf(x: Any) -> bool:
    return isinstance(x, tuple) and all(i is None or isinstance(i, str) for i in x)


# -- the tensor-parallel seams of the two-level mesh -----------------------------------
#
# The width rules decide which weight families shard over a lane row's model
# ranks, and the seams (Megatron's f / g) place the matching all-reduces at
# activation boundaries:
#
#   tp_enter (f): identity forward, all-reduce backward: wraps a replicated
#       activation right before it feeds width-sharded weights (column
#       parallel), so the shards' partial input gradients sum up;
#   tp_reduce (g): all-reduce forward, identity backward: closes a
#       row-parallel contraction (its contracting dim sharded).
#
# A branch that feeds replicated weights must bypass tp_enter: all-reducing a
# full contribution W ways would count its gradient W times.  The seams are
# no-ops unless ``tp_shard_context`` armed them for the module.

_TP_CTX: contextvars.ContextVar[Optional[Dict[str, Any]]] = contextvars.ContextVar(
    "tp_ctx", default=None)
_TP_COLLECTIVES = 0   # model-group all-reduces this process has issued
_TP_BYTES = 0         # and the bytes of the tensors they reduced


def tp_collectives() -> int:
    """The model-group all-reduces this process has issued (the seams' and
    the gradient norm's)."""
    return _TP_COLLECTIVES


def tp_collective_bytes() -> int:
    """The bytes of the tensors those all-reduces summed."""
    return _TP_BYTES


def tp_width_rules(cfg, width: int, model_axis: str = "model") -> Rules:
    """Logical-axes rules for a ``width``-way tensor-parallel lane, decided
    per module (``tp_module_flags``): attention's ``heads`` and
    ``kv_heads``, the dense MLP's ``ff`` and Mamba's ``inner`` channels
    shard over ``model_axis``; the embedding, the norms, the router, the
    experts and the caches stay replicated."""
    flags = tp_module_flags(cfg, width)
    rules: Rules = {}
    if flags["attn"]:
        rules["heads"] = (model_axis,)
        rules["kv_heads"] = (model_axis,)
    if flags["mlp"]:
        rules["ff"] = (model_axis,)
    if flags["mamba"]:
        rules["inner"] = (model_axis,)
    return rules


def tp_module_flags(cfg, width: int) -> Dict[str, bool]:
    """Which modules shard at this width: attention iff the width divides
    both ``n_heads`` and ``n_kv_heads``; the dense MLP iff it divides
    ``d_ff`` and the arch has no MoE block (experts stay replicated); Mamba
    iff it divides ``d_inner``."""
    if width <= 1:
        return {"attn": False, "mlp": False, "mamba": False}
    n_kv = int(getattr(cfg, "n_kv_heads", 0) or 0)
    return {
        "attn": bool(cfg.has_attention and cfg.n_heads % width == 0 and n_kv % width == 0),
        "mlp": bool(cfg.d_ff % width == 0 and not cfg.has_moe),
        "mamba": bool(cfg.has_mamba and cfg.d_inner % width == 0),
    }


def tp_gnorm_mask(param_specs: Any, rules: Rules) -> Any:
    """Bool tree over a params specs tree: True iff the leaf's logical spec
    names a dimension the width rules shard."""
    return map_specs(param_specs, param_specs,
                     lambda _, logical: any(n in rules for n in logical if n is not None))


@contextlib.contextmanager
def tp_shard_context(mesh: PopulationMesh, flags: Dict[str, bool], gnorm_mask: Any = None):
    """Arm the seams for the modules ``flags`` names (``tp_module_flags``)
    over ``mesh``'s model group while a step runs; ``gnorm_mask`` (a
    params-shaped bool tree, True where a leaf is width-sharded) tells
    ``optim.adamw.global_norm`` which leaves' sums to all-reduce."""
    tok = _TP_CTX.set(dict(flags, mesh=mesh, axis="model", gnorm_mask=gnorm_mask))
    try:
        yield
    finally:
        _TP_CTX.reset(tok)


def tp_axis(module: Optional[str] = None) -> Optional[str]:
    """The model axis's name if the seams are armed (for ``module``), else
    None."""
    ctx = _TP_CTX.get()
    if ctx is None or (module is not None and not ctx.get(module, False)):
        return None
    return ctx["axis"]


class _SeamF(torch.autograd.Function):
    """f: identity forward, all-reduce over the row backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.model_all_reduce(g.contiguous().clone()), None


class _SeamG(torch.autograd.Function):
    """g: all-reduce over the row forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.model_all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_enter(x: torch.Tensor, module: str) -> torch.Tensor:
    """Seam into a column-parallel block (no-op unless armed for
    ``module``).  Wrap only activations that feed width-sharded weights."""
    if tp_axis(module) is None:
        return x
    return _SeamF.apply(x, _TP_CTX.get()["mesh"])


def tp_reduce(x: torch.Tensor, module: str) -> torch.Tensor:
    """Seam out of a row-parallel contraction: the shards' partial sums
    all-reduced over the row (no-op unless armed for ``module``)."""
    if tp_axis(module) is None:
        return x
    return _SeamG.apply(x, _TP_CTX.get()["mesh"])


def tp_gnorm_sumsq(leaf_sumsqs: Sequence[torch.Tensor], tree: Any) -> Optional[torch.Tensor]:
    """Each lane's sum of squares over a gradient tree under the seams
    (``leaf_sumsqs``: per leaf of ``tree``, in ``tree_leaves`` order, each
    lane's own sum, (K,)): the replicated leaves' sums once, plus the
    width-sharded leaves' sums all-reduced over the row.  None when the
    seams are not armed (the caller keeps its plain sum)."""
    ctx = _TP_CTX.get()
    if ctx is None or ctx.get("gnorm_mask") is None:
        return None
    mask = tree_leaves(ctx["gnorm_mask"])
    if len(mask) != len(leaf_sumsqs):
        return None
    total = shard = None
    for sq, m in zip(leaf_sumsqs, mask):
        if m:
            shard = sq if shard is None else shard + sq
        else:
            total = sq if total is None else total + sq
    if shard is not None:
        shard = ctx["mesh"].model_all_reduce(shard)
        total = shard if total is None else total + shard
    return total
