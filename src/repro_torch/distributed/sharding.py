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

While a mesh of N ranks lives, the RMSNorm backward plans a rank's K/N
lanes as the whole population's K (``kernels/rmsnorm.py::plan_for_mesh``),
so a lane's gain gradient takes the unsharded launch's bits.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..interop import tree_leaves, tree_unflatten
from ..kernels import rmsnorm

DEFAULT_TIMEOUT_S = 300.0
PART_B = "ROADMAP.md section 1, item 12(b) (the two-level (pop, model) mesh)"
PART_C = "ROADMAP.md section 1, item 12(c) (elastic regrid)"
_ALIGN = 8   # byte alignment of each leaf in a packed gather


@dataclasses.dataclass(eq=False)
class PopulationMesh:
    """This rank's place on a population mesh of ``world_size`` ranks.

    ``device`` is the rank's device, ``backend`` the group's (``nccl`` or
    ``gloo``), ``group`` the process group (None: the default group).  A
    population of K lanes splits into contiguous blocks of K/N: rank r owns
    lanes ``[r*K/N, (r+1)*K/N)``."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    group: Any = None
    axis: str = "pop"
    timeout_s: float = DEFAULT_TIMEOUT_S
    owns_group: bool = False
    devices: tuple = ()   # every rank's device, in rank order
    # held by rank 0 for a whole flight: the ranks apply one flight's ops in
    # the order rank 0 sends them, so two flights may not interleave
    flight_lock: Any = dataclasses.field(default_factory=threading.RLock, repr=False)

    @property
    def key(self) -> tuple:
        """What a program compiled for this mesh depends on."""
        return (self.axis, self.backend, int(self.world_size), int(self.rank),
                str(self.device))

    # -- lane arithmetic ------------------------------------------------------
    def block_size(self, k: int) -> int:
        if int(k) % self.world_size:
            raise ValueError(f"population {k} does not divide over {self.world_size} ranks")
        return int(k) // self.world_size

    def lane_block(self, k: int) -> range:
        """The global lanes this rank owns."""
        blk = self.block_size(k)
        return range(self.rank * blk, (self.rank + 1) * blk)

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
        """``(N, nbytes)`` uint8: every rank's ``send`` (uint8, 1-D), row r
        from rank r."""
        n = self.world_size
        out = torch.empty((n, send.numel()), dtype=torch.uint8, device=send.device)
        if self.backend == "nccl":
            dist.all_gather_into_tensor(out, send, group=self.group)
        else:
            dist.all_gather(list(out.unbind(0)), send, group=self.group)
        return out

    def all_gather_lanes(self, tree: Any, dim: int = 0) -> Any:
        """Every leaf of ``tree`` (this rank's block, its lane axis at
        ``dim``) gathered whole over the ranks, in lane order: one
        collective for the whole tree, its leaves packed as raw bytes, so
        the result is bit for bit what each rank held."""
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
            y = y.reshape((self.world_size * shape[0],) + shape[1:])
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
    Called again (``device`` None, or the same), it returns the mesh this
    process already made or joined.  ``width`` > 1 (a two-level ``(pop,
    model)`` mesh) raises: it comes with a later part of the port."""
    global _CURRENT
    if width is not None and int(width) > 1:
        raise NotImplementedError(
            f"a two-level (pop, model) population mesh of width {width} is not ported "
            f"yet; it comes with {PART_B}")
    if _CURRENT is not None and dist.is_initialized() and (
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
    devices = [str(dev)] * n
    if n > 1:
        dist.all_gather_object(devices, str(dev))
    _CURRENT = PopulationMesh(rank=r, world_size=n, device=dev, backend=str(backend),
                              axis=axis, timeout_s=float(timeout_s), owns_group=owns,
                              devices=tuple(torch.device(d) for d in devices))
    rmsnorm.plan_for_mesh(n)
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
        return "rep" if len(shape) < 1 or shape[0] % mesh.world_size else "pop"

    return tree_map(one, tree)
