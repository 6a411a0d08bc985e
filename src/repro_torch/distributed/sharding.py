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

**Elastic regrid** re-lays a flight's lanes onto a mesh of another width
over the same ranks (``PopulationMesh.with_width``: one mesh a width, made
once, its groups made by every rank in one order); it leaves the process's
current mesh and the RMSNorm plan as they were.

**The trial mesh** (``launch/mesh.py::make_trial_mesh``, ``launch/train.py
--devices N``) is the same grid read as one trial's ``(data, model)`` axes:
the pop group is the data axis, a row's model group the model axis.  The
JAX package's logical-axis rules place each leaf (``make_rules``,
``build_pspec``, ``build_sharding``: the weights' ``embed`` dim over
``data``, FSDP; heads, ``ff``, ``inner``, ``vocab`` and ``expert`` over
``model``); a placement is, per dim, the mesh axis its blocks split over or
None.  A rank stores only its block of each leaf (``shard_tree``;
``gather_tree`` joins them).  Where a module computes on whole weights, a
leaf is gathered at use (``at_use``, read by ``models/transformer.py``
inside each checkpointed superblock): ``DataGather`` (all-gather forward;
backward the gradients summed over the data ranks, each keeping its block)
and ``ModelGather`` (all-gather forward; backward the rank's own slice, for
every model rank computed the same full gradient).  JAX's ``constrain`` has
no twin: each of its call sites is a layout hint to GSPMD, and the port's
explicit gathers and seams are the layout.  ``sharding_context`` /
``ctx_mesh`` carry the mesh to the code that reads it (``moe_apply``'s
expert-parallel path, the step), as JAX's ``_CTX`` does.

**A grid of named axes** (``grid_mesh``; ``launch/mesh.py::
make_production_mesh``'s ``(16, 16)`` ``("data", "model")`` and ``(2, 16,
16)`` ``("pod", "data", "model")`` grids): rank r sits at the row-major
coordinates of r; a mesh axis, or a tuple of them (a placement's
``("pod", "data")``, a long cache's ``("data", "model")``), joins the ranks
that differ only on those axes, and every such group is made once, by
every rank, in one order.  A tuple's index is row-major over its axes, so
its blocks are in rank order.  ``model`` is the last axis and its group a
row of consecutive ranks, as ``PopulationMesh(width=m)``'s.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import itertools
import math
import os
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..interop import tree_leaves, tree_map, tree_unflatten
from ..kernels import rmsnorm

DEFAULT_TIMEOUT_S = 300.0
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
    # width -> the mesh of that width over this group (``with_width``),
    # shared by every mesh made from this one
    widths: Dict[int, Any] = dataclasses.field(default_factory=dict, repr=False)
    # an elastic regrid's mesh: at a width that shards none of a model's
    # modules, a row's ranks hold and compute whole lanes (``--model-parallel``
    # refuses such a width instead)
    replicate_rows: bool = False
    # a grid of named axes (``grid_mesh``): ((name, size), ...), ``model``
    # last; None: the two axes ``(axis, "model")``
    grid: Optional[tuple] = None
    # a tuple of axes -> the group of the ranks that differ only on them
    # (a grid's axes and tuples other than the model and data axes)
    axis_groups: Dict[tuple, Any] = dataclasses.field(default_factory=dict, repr=False)

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
        gradient norm's collective; counted in ``tp_collectives`` and
        ``mesh_collectives``)."""
        dist.all_reduce(t, group=self.model_group)
        nb = t.numel() * t.element_size()
        _count("model", "all_reduce", nb, self.width, nb)
        return t

    # -- the trial mesh's axes (``axis`` the data axis, then ``model``) --------
    @property
    def axis_names(self) -> tuple:
        if self.grid is not None:
            return tuple(n for n, _ in self.grid)
        return (self.axis, "model")

    @property
    def data_axes(self) -> tuple:
        """The axes the data ranks span (all but ``model``)."""
        return tuple(a for a in self.axis_names if a != "model")

    @property
    def shape(self) -> Dict[str, int]:
        """Each axis's size, as a JAX mesh's ``shape``."""
        if self.grid is not None:
            return dict(self.grid)
        return {self.axis: self.rows, "model": self.width}

    def coords(self) -> Dict[str, int]:
        """This rank's index on each axis (row-major over the grid)."""
        out, r = {}, self.rank
        for name, size in reversed(list(self.shape.items())):
            out[name], r = r % size, r // size
        return out

    def axis_index(self, axis) -> int:
        """This rank's index along ``axis``; a tuple's is row-major over its
        axes."""
        c, shape, idx = self.coords(), self.shape, 0
        for a in _as_axes(axis):
            idx = idx * shape[a] + c[a]
        return idx

    def _axis_group(self, axis):
        axes = _as_axes(axis)
        if axes == ("model",):
            return self.model_group
        if axes == self.data_axes:
            return self.pop_group if self.width > 1 else self.group
        if set(axes) == set(self.axis_names):
            return self.group
        return self.axis_groups[axes]

    def axis_all_gather(self, t: torch.Tensor, dim: int, axis) -> torch.Tensor:
        """Every rank's ``t`` along ``axis``, joined along ``dim`` in axis
        order, bit for bit: the bytes are gathered (gloo gathers bytes of
        every dtype), then read back (counted in ``mesh_collectives``)."""
        n = axis_size(self, axis)
        raw = t.contiguous().view(torch.uint8)
        parts = [torch.empty_like(raw) for _ in range(n)]
        dist.all_gather(parts, raw, group=self._axis_group(axis))
        _count(axis, "all_gather", raw.numel() * n, n, raw.numel())
        return torch.cat(parts, dim).view(t.dtype)

    def axis_all_reduce(self, t: torch.Tensor, axis, op: str = "sum") -> torch.Tensor:
        """Reduce ``t`` over ``axis`` in place, by ``op`` (``"sum"`` or
        ``"max"``; counted in ``mesh_collectives``; the model axis's sum
        through ``model_all_reduce``)."""
        if _as_axes(axis) == ("model",) and op == "sum":
            return self.model_all_reduce(t)
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                        group=self._axis_group(axis))
        nb = t.numel() * t.element_size()
        _count(axis, "all_reduce", nb, axis_size(self, axis), nb)
        return t

    def axis_reduce_scatter(self, t: torch.Tensor, dim: int, axis) -> torch.Tensor:
        """This rank's block along ``dim`` of ``t`` summed over ``axis``
        (counted in ``mesh_collectives``)."""
        n = axis_size(self, axis)
        parts = [p.contiguous() for p in t.chunk(n, dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=self._axis_group(axis))
        nb = t.numel() * t.element_size()
        _count(axis, "reduce_scatter", nb, n, nb)
        return out

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def with_width(self, width: int) -> "PopulationMesh":
        """The mesh of ``width`` over this mesh's group and ranks (elastic
        regrid re-lays a flight's lanes onto it), made once a width and
        cached: a new width makes new row and model-position groups, a
        collective every rank must make in the same order (a flight's
        broadcast ops give it one).  The process's current mesh and the
        RMSNorm backward's plan are left as they are; the flight that uses
        the mesh plans for its lanes itself."""
        w = int(width)
        self.widths.setdefault(self.width, self)
        got = self.widths.get(w)
        if got is None:
            if w < 1 or self.world_size % w:
                raise ValueError(f"width {w} does not tile {self.world_size} ranks into "
                                 f"lane rows")
            model_group, pop_group = _row_groups(self.rank, self.world_size, w)
            # ``replace`` shares the flight lock and this dict with the new mesh
            got = dataclasses.replace(self, width=w, owns_group=False, replicate_rows=True,
                                      model_group=model_group, pop_group=pop_group)
            self.widths[w] = got
        return got

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
    Called again (``device`` None, or the same, the same width and axis), it
    returns the mesh this process already made or joined.  ``width`` W > 1
    makes the mesh two-level: ``N / W`` lane rows of W ranks (it must
    divide N); every rank makes every row's and every model position's
    group, in the same order, as ``torch.distributed`` requires."""
    global _CURRENT
    w = 1 if width is None else int(width)
    if w < 1:
        raise ValueError(f"population mesh width {width} must be at least 1")
    if _CURRENT is not None and dist.is_initialized() and _CURRENT.width == w and \
            _CURRENT.axis == axis and (device is None or _rank_device(
                device, _CURRENT.device.index or 0) == _CURRENT.device):
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
    model_group, pop_group = _row_groups(r, n, w)
    _CURRENT = PopulationMesh(rank=r, world_size=n, device=dev, backend=str(backend),
                              axis=axis, timeout_s=float(timeout_s), owns_group=owns,
                              devices=tuple(torch.device(d) for d in devices), width=w,
                              model_group=model_group, pop_group=pop_group)
    rmsnorm.plan_for_mesh(n // w)
    return _CURRENT


def _row_groups(r: int, n: int, w: int) -> tuple:
    """Rank ``r``'s model group (its row of ``w`` ranks) and pop group (the
    ranks at its model position) of ``n`` ranks at width ``w`` (None, None
    at width 1).  Every rank makes every group, in one order, as
    ``torch.distributed`` requires."""
    model_group = pop_group = None
    if w > 1:
        for i in range(n // w):
            g = dist.new_group(list(range(i * w, (i + 1) * w)))
            if i == r // w:
                model_group = g
        for j in range(w):
            g = dist.new_group(list(range(j, n, w)))
            if j == r % w:
                pop_group = g
    return model_group, pop_group


def grid_mesh(names: Sequence[str], sizes: Sequence[int], device,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> PopulationMesh:
    """This rank's place on a grid of named axes (``names``, ``model``
    last, of ``sizes``) over the process group already initialised, whose
    world must be the grid's size.  Every rank makes, in one order, the
    group of every proper subset of the axes: for each subset, one group
    for each setting of the other axes' coordinates, its ranks in
    row-major order."""
    names, sizes = tuple(names), tuple(int(x) for x in sizes)
    if names[-1] != "model":
        raise ValueError(f"a grid's last axis is 'model', got {names}")
    if not dist.is_initialized():
        raise RuntimeError(f"a grid mesh {dict(zip(names, sizes))} needs an initialised "
                           "process group")
    n, r = math.prod(sizes), dist.get_rank()
    if dist.get_world_size() != n:
        raise ValueError(f"a grid {dict(zip(names, sizes))} of {n} ranks over a process "
                         f"group of {dist.get_world_size()} ranks")
    coords = list(itertools.product(*(range(x) for x in sizes)))   # rank -> coordinates
    groups: Dict[tuple, Any] = {}
    for k in range(1, len(names)):
        for axes in itertools.combinations(range(len(names)), k):
            rest = [i for i in range(len(names)) if i not in axes]
            for fixed in itertools.product(*(range(sizes[i]) for i in rest)):
                ranks = [q for q, c in enumerate(coords)
                         if all(c[i] == f for i, f in zip(rest, fixed))]
                g = dist.new_group(ranks)
                if r in ranks:
                    groups[tuple(names[i] for i in axes)] = g
    dev = torch.device(device)
    data = names[:-1]
    mesh = PopulationMesh(rank=r, world_size=n, device=dev, backend=str(dist.get_backend()),
                          axis=data[0] if len(data) == 1 else data,
                          timeout_s=float(timeout_s), devices=(dev,) * n, width=sizes[-1],
                          model_group=groups[("model",)], pop_group=groups[data],
                          grid=tuple(zip(names, sizes)))
    mesh.axis_groups.update(groups)
    return mesh


def _as_axes(axis) -> tuple:
    """A mesh axis, or a tuple of them, as a tuple of names."""
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_size(mesh, axis) -> int:
    """The ranks of ``mesh`` (anything with ``.shape``, axis -> size) along
    ``axis``, a name or a tuple of names."""
    return math.prod(mesh.shape[a] for a in _as_axes(axis))


def population_specs(tree: Any, mesh: PopulationMesh) -> Any:
    """Per leaf of ``tree``, where it lives on ``mesh``: ``"pop"`` (its
    leading axis is blocked over the ranks) or ``"rep"`` (every rank holds
    all of it).  Rank-0 leaves, and leaves whose leading dim does not divide
    over the ranks (scalar rule state, history rings, window counters), are
    replicated, as the JAX package's ``population_specs`` places them."""
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
    """A tuple of logical names, or a placement: per dim None, an axis name
    or a tuple of axis names."""
    return isinstance(x, tuple) and all(
        i is None or isinstance(i, str)
        or (isinstance(i, tuple) and i and all(isinstance(j, str) for j in i)) for i in x)


# -- the trial mesh: logical-axis rules and placements ------------------------------------

def make_rules(mesh_axes: Sequence[str], *, shard_cache_seq: bool = False) -> Rules:
    """The JAX package's ``make_rules``: logical axis name -> mesh axes.
    ``embed`` goes over the data axes (FSDP), ``vocab``, the heads, ``ff``,
    ``moe_ff``, ``expert`` and ``inner`` over ``model``; ``act_seq_attn``
    is the Ulysses fallback for heads that do not divide ``model``."""
    dp: Tuple[str, ...] = ("pod", "data") if "pod" in mesh_axes else ("data",)
    rules: Rules = {
        "batch": dp, "embed": dp, "vocab": ("model",), "heads": ("model",),
        "kv_heads": ("model",), "head": (), "ff": ("model",), "moe_ff": ("model",),
        "expert": ("model",), "inner": ("model",),
        "cache_seq": ("data", "model") if shard_cache_seq else ("model",),
        "act_embed": (), "act_seq": (), "act_seq_attn": ("model",),
    }
    return {k: tuple(a for a in v if a in mesh_axes) for k, v in rules.items()}


# lower claims mesh axes first: head / ff / expert dims take the model axis
# when they divide it; act_seq_attn only as a fallback
_PRIORITY = {
    "vocab": 0, "heads": 0, "kv_heads": 0, "ff": 0, "moe_ff": 0,
    "expert": 0, "inner": 0, "cache_seq": 0,
    "embed": 1, "batch": 1,
    "act_seq_attn": 2, "act_seq": 3, "act_embed": 3, "head": 3,
}


def build_pspec(shape: Sequence[int], logical: Sequence[Optional[str]], rules: Rules,
                mesh) -> tuple:
    """A leaf's placement: per dim of ``shape``, the mesh axis (a tuple for
    several) its blocks split over, or None; the JAX package's
    ``build_pspec`` (``mesh`` needs only ``.shape``, axis -> size).  Dims
    claim axes in ``_PRIORITY`` order, a mesh axis at most once a leaf, each
    dim keeping the prefix of its axes whose sizes divide it."""
    if len(shape) != len(logical):
        raise ValueError(f"shape {tuple(shape)} and logical axes {tuple(logical)} differ in rank")
    used: set = set()
    spec: list = [None] * len(shape)
    for i in sorted(range(len(shape)), key=lambda i: _PRIORITY.get(logical[i], 1)):
        if logical[i] is None:
            continue
        keep, prod = [], 1
        for a in (a for a in rules.get(logical[i], ()) if a not in used):
            if shape[i] % (prod * mesh.shape[a]) == 0:
                keep.append(a)
                prod *= mesh.shape[a]
        if keep:
            used.update(keep)
            spec[i] = tuple(keep) if len(keep) > 1 else keep[0]
    return tuple(spec)


def build_sharding(tree_shapes: Any, tree_specs: Any, rules: Rules, mesh) -> Any:
    """The placement of every leaf of ``tree_shapes`` (tensors, or anything
    with ``.shape``), walked with its specs tree (``map_specs``)."""
    return map_specs(tree_shapes, tree_specs,
                     lambda leaf, logical: build_pspec(tuple(leaf.shape), logical, rules, mesh))


def sharded_dims(placement: tuple, mesh) -> list:
    """(dim, axis) of each dim a placement splits over an axis (or a tuple
    of axes) of more than one rank of ``mesh``."""
    return [(i, a) for i, a in enumerate(placement)
            if a is not None and axis_size(mesh, a) > 1]


def shard_tree(tree: Any, placements: Any, mesh: PopulationMesh) -> Any:
    """This rank's block of every leaf of a whole ``tree``, copied onto its
    device and freed of the rest."""
    def one(x, placement):
        for i, a in sharded_dims(placement, mesh):
            n = x.shape[i] // axis_size(mesh, a)
            x = x.narrow(i, mesh.axis_index(a) * n, n)
        return x.to(mesh.device, copy=True).contiguous()

    return map_specs(tree, placements, one)


def gather_tree(tree: Any, placements: Any, mesh: PopulationMesh, to_host: bool = False,
                keep: bool = True) -> Any:
    """Every leaf whole from the ranks' blocks (a collective: every rank
    calls it), leaf by leaf; ``to_host`` copies each to host memory as it
    is joined, so a rank holds one whole leaf on its device at a time; a
    rank that does not ``keep`` the result gets None leaves."""
    def one(x, placement):
        for i, a in sharded_dims(placement, mesh)[::-1]:
            x = mesh.axis_all_gather(x, i, a)
        if not keep:
            return None
        return x.to("cpu", copy=True) if to_host else x

    return map_specs(tree, placements, one)


_MESH_COUNTS: Dict[Tuple[str, str], list] = {}   # (axis, op) -> [calls, bytes]
# called with each collective as it is made: (axis, op, group size, operand
# bytes); the op-cost walk (``launch/op_cost.py``) listens while it is active
collective_listeners: list = []


def _count(axis, op: str, nbytes: int, n: int, operand: int) -> None:
    """One collective over ``axis`` (a name, or a tuple of names joined by
    ``+``) of ``n`` ranks: ``nbytes`` for ``mesh_collectives``, and the
    listeners told its group size and ``operand`` bytes (an all-gather's
    input, a reduce-scatter's and an all-reduce's whole tensor)."""
    name = "+".join(_as_axes(axis))
    c = _MESH_COUNTS.setdefault((name, op), [0, 0])
    c[0] += 1
    c[1] += int(nbytes)
    for fn in collective_listeners:
        fn(name, op, int(n), int(operand))


def mesh_collectives() -> Dict[str, Dict[str, int]]:
    """The collectives this process made over a mesh's axes, by
    ``"axis/op"``: calls and bytes (an all-gather's bytes are its output's, a
    reduce-scatter's its input's)."""
    return {f"{a}/{op}": {"calls": c[0], "bytes": c[1]}
            for (a, op), c in sorted(_MESH_COUNTS.items())}


class DataGather(torch.autograd.Function):
    """A leaf stored in blocks over the data axis (``dim``; None: stored
    whole) computed whole: all-gather forward.  Backward, when the data
    ranks trained on their own rows (``split``), the gradients summed over
    them, each rank getting its block (a reduce-scatter; an all-reduce for
    a leaf stored whole), since the batch's rows are the only thing the
    ranks split, so the sum is the unsharded gradient; else each rank's
    own block of its (whole, the same) gradient."""

    @staticmethod
    def forward(ctx, x, mesh, dim, split):
        ctx.mesh, ctx.dim, ctx.split = mesh, dim, split
        return x.view_as(x) if dim is None else mesh.axis_all_gather(x, dim, mesh.axis)

    @staticmethod
    def backward(ctx, g):
        mesh, dim = ctx.mesh, ctx.dim
        if ctx.split and dim is not None:
            g = mesh.axis_reduce_scatter(g, dim, mesh.axis)
        elif ctx.split:
            g = mesh.axis_all_reduce(g.contiguous().clone(), mesh.axis)
        elif dim is not None:
            n = g.shape[dim] // mesh.rows
            g = g.narrow(dim, mesh.row * n, n)
        return g, None, None, None


class ModelGather(torch.autograd.Function):
    """A leaf stored in blocks over the model axis (``dim``) that its module
    computes whole: all-gather forward; backward the rank's own slice of
    the gradient (every model rank computed the same whole gradient, so a
    sum would count it ``width`` times)."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.axis_all_gather(x, dim, "model")

    @staticmethod
    def backward(ctx, g):
        mesh, dim = ctx.mesh, ctx.dim
        n = g.shape[dim] // mesh.width
        return g.narrow(dim, mesh.model_rank * n, n), None, None


@dataclasses.dataclass(frozen=True)
class UsePlan:
    """How a stored leaf becomes the tensor its module computes on:
    ``model`` the dims gathered over the model axis, ``data`` the dim
    gathered over the data axis (None: stored whole over it), dims counted
    as the tensor at use has them."""

    model: Tuple[int, ...] = ()
    data: Optional[int] = None

    def apply(self, x: torch.Tensor, mesh: PopulationMesh, split: bool,
              reduce: bool = True) -> torch.Tensor:
        for d in self.model:
            x = ModelGather.apply(x, mesh, d)
        if self.data is not None or (split and reduce and mesh.rows > 1):
            x = DataGather.apply(x, mesh, self.data, split)
        return x


@dataclasses.dataclass(frozen=True)
class _Ctx:
    mesh: PopulationMesh
    uses: Any
    split: bool
    reduce: bool
    caches: Any


_CTX: contextvars.ContextVar[Optional[_Ctx]] = contextvars.ContextVar(
    "sharding_ctx", default=None)


@contextlib.contextmanager
def sharding_context(mesh: PopulationMesh, uses: Any = None, split: bool = False,
                     reduce: bool = True, caches: Optional[Dict[str, tuple]] = None):
    """Run a trial's step on ``mesh``: ``uses`` (a tree of
    ``UsePlan`` by part of the parameter tree: ``embedding``, ``prefix``,
    ``blocks`` (one superblock), ``final_norm``) tells ``at_use`` how to
    gather each stored leaf; ``split`` whether the data ranks train on
    their own rows of the batch; ``reduce`` False leaves a leaf stored
    whole over the data axis with this rank's partial gradient (ZeRO-1:
    the step reduce-scatters the sum once); ``caches`` (decode) the
    placement of each kind of layer cache (``"gqa"``, ``"mla"``: per dim,
    as ``build_pspec`` gives it, without the lane axis), which the decode
    attention reads (``cache_placement``)."""
    tok = _CTX.set(_Ctx(mesh, uses, bool(split), bool(reduce), caches))
    try:
        yield
    finally:
        _CTX.reset(tok)


def ctx_mesh() -> Optional[PopulationMesh]:
    """The active sharding context's mesh (None outside a context)."""
    ctx = _CTX.get()
    return ctx.mesh if ctx is not None else None


def cache_placement(kind: str) -> Optional[tuple]:
    """The active decode context's placement of a ``kind`` layer cache
    (None outside one)."""
    ctx = _CTX.get()
    if ctx is None or ctx.caches is None:
        return None
    return ctx.caches.get(kind)


def at_use(tree: Any, *part) -> Any:
    """``tree`` (stored blocks of the parameter tree's ``part``) as its
    modules compute on it, gathered by the context's ``UsePlan``s; the tree
    itself outside a trial's sharding context."""
    ctx = _CTX.get()
    if ctx is None or ctx.uses is None:
        return tree
    plans = ctx.uses
    for k in part:
        plans = plans[k]
    return tree_map(lambda x, plan: plan.apply(x, ctx.mesh, ctx.split, ctx.reduce), tree,
                    plans)


def reentry():
    """A context manager factory that sets the sharding and seam contexts
    active now.  A superblock recomputed in the backward pass runs on the
    autograd engine's thread, which does not see this thread's context
    variables: it re-enters the ones its forward saw."""
    saved = (_CTX.get(), _TP_CTX.get())

    @contextlib.contextmanager
    def enter():
        toks = (_CTX.set(saved[0]), _TP_CTX.set(saved[1]))
        try:
            yield
        finally:
            _TP_CTX.reset(toks[1])
            _CTX.reset(toks[0])

    return enter


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
def tp_collectives() -> int:
    """The model-group all-reduces this process has issued (the seams' and
    the gradient norm's)."""
    return _MESH_COUNTS.get(("model", "all_reduce"), [0, 0])[0]


def tp_collective_bytes() -> int:
    """The bytes of the tensors those all-reduces summed."""
    return _MESH_COUNTS.get(("model", "all_reduce"), [0, 0])[1]


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
    lane's own sum, (K,)): the replicated leaves' sums once, plus the sharded
    leaves' sums, each all-reduced over the axes its leaf is stored sharded
    on.  A mask leaf is True (sharded over the model axis: the two-level
    mesh), False, or the frozenset of the axes (the trial mesh).  None when
    the seams are not armed (the caller keeps its plain sum)."""
    ctx = _TP_CTX.get()
    if ctx is None or ctx.get("gnorm_mask") is None:
        return None
    mask = tree_leaves(ctx["gnorm_mask"])
    if len(mask) != len(leaf_sumsqs):
        return None
    total, groups = None, {}
    for sq, m in zip(leaf_sumsqs, mask):
        axes = (("model",) if m else ()) if isinstance(m, bool) else tuple(sorted(m, key=str))
        if axes:
            groups[axes] = sq if axes not in groups else groups[axes] + sq
        else:
            total = sq if total is None else total + sq
    for axes in sorted(groups, key=str):
        part = groups[axes]
        for a in axes:
            part = ctx["mesh"].axis_all_reduce(part, a)
        total = part if total is None else total + part
    return total
