"""Sharded population resource manager: mesh-aware lanes, one SPMD program.

The vectorized manager buffers K jobs and runs them as one lane-batched
program on one device.  This subclass keeps that buffering machinery but
presents **mesh-aware slots**: the ranks of a population mesh
(``repro_torch.distributed.sharding.PopulationMesh``, default: the one this
process joined or made) are tiled into 1-device slices with
``mesh_pool.tile_pod``, and each resource id names the lane AND the rank it
lands on::

    slice[0:1,3:4]/lane2   ->  rank 3, the 3rd of its K/N population lanes

``n_parallel`` is rounded up to a multiple of the rank count so the
population axis always divides over the mesh (the trial pads short batches
with 0-budget lanes).  ``_run_batch`` forwards the mesh to the target's
``run_population(configs, mesh=...)``, which runs the flight on every rank,
K/N trials a rank (``launch/flight.py``).  The streaming protocols ride
through unchanged from the vectorized base: a lane-refill flight leases jobs
into mesh lanes and runs each lane op on the lane's owner, and streaming
PBT's clones cross ranks (the donor lane is sent to the target's owner).

When a supervised streaming flight exhausts its restart budget on the mesh,
the last attempt (and everything after) runs on rank 0 alone with the
vectorized engine, journaled as ``mesh_degrade``: a wedged collective or a
sick rank should not take the whole experiment down.  That is the one path
from a mesh flight to the vectorized engine.

The two-level ``(pop, model)`` mesh (``model_parallel > 1``) folds the
ranks into lane rows of W, each lane a width-W program over its row.

With ``elastic_regrid`` the lane geometry becomes a leased resource
(``ElasticLanePool``): at a rung boundary a flight regrids its survivors onto
fewer, wider lane rows of the same ranks, and every width change is a
scale-out of the new ``slice[...]xW{w}`` leases and a scale-in of the old.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

from . import ResourceManager, register
from .elastic import ElasticResourceManager
from .mesh_pool import tile_pod
from .vectorized import VectorizedResourceManager, accepts_kwarg


class _SlicePool(ResourceManager):
    """Bookkeeping-only pool whose resources are rank-slice leases, not job
    slots: ``ElasticLanePool`` scales it in and out as the lane geometry
    changes, and no job ever binds to a lease, so a scale-in can never mark
    a running flight LOST."""

    def run(self, job, target) -> None:  # pragma: no cover - never dispatched
        raise RuntimeError("_SlicePool leases rank slices; it does not run jobs")


class ElasticLanePool:
    """Width-annotated rank leases for elastic regrid (the JAX package's
    lease protocol on a population mesh's ranks).

    The pool starts at width 1 (a lane row a rank) and tiles the mesh's
    ranks into ``width``-wide slices with
    ``mesh_pool.tile_pod`` and leases them through an
    ``ElasticResourceManager``, so every geometry change is an observable
    scale event: ``regrid(n_survivors)`` scales out the new
    ``slice[...]xW{w}`` leases, then scales in the old.  ``plan`` is
    ``plan_regrid`` over the ranks (every lane row keeps a live lane);
    ``mesh()`` is the mesh of the current width over the same group, made
    once a width (``PopulationMesh.with_width``; a flight builds it on every
    rank as one of its broadcast ops).
    """

    def __init__(self, mesh):
        self.base = mesh
        self.devices = list(mesh.devices)
        self.manager = ElasticResourceManager(base=_SlicePool())
        self.width = 0
        self.lanes = 0
        self.width_history: List[int] = []
        self.n_regrids = 0
        self._lease_ids: List[str] = []
        self._retile(1)

    def _retile(self, width: int) -> None:
        n = len(self.devices)
        if width <= 0 or n % width:
            raise ValueError(f"width {width} does not tile {n} ranks")
        old = self._lease_ids
        slices = tile_pod((1, n), (1, width), devices=self.devices)
        self._lease_ids = [f"{s.slice_id}xW{width}" for s in slices]
        self.manager.scale_out(self._lease_ids)
        self.manager.scale_in(old)
        self.width = width
        self.width_history.append(width)

    def mesh(self):
        return self.base.with_width(self.width)

    def plan(self, n_survivors: int):
        from ...train.population import plan_regrid

        return plan_regrid(len(self.devices), n_survivors)

    def regrid(self, n_survivors: int):
        """Re-lease the ranks for ``n_survivors`` live trials: the ``(rows,
        width, lanes)`` plan.  A plan of the same width changes no lease and
        emits no scale event.  The flight builds the new width's mesh
        (``mesh()``) on every rank when it regrids."""
        rows, width, lanes = self.plan(n_survivors)
        if width != self.width:
            self._retile(width)
            self.n_regrids += 1
        self.lanes = lanes
        return rows, width, lanes


@register("sharded")
class ShardedPopulationResourceManager(VectorizedResourceManager):
    def __init__(
        self,
        n_parallel: int = 8,
        mesh: Optional[Any] = None,
        device: Optional[str] = None,
        axis: str = "pop",
        elastic_regrid: bool = False,
        model_parallel: int = 1,
        **kwargs,
    ):
        from ...distributed.sharding import population_mesh
        from ...train.population import pad_population

        if elastic_regrid and int(model_parallel) > 1:
            raise ValueError("model_parallel is incompatible with elastic_regrid: elastic "
                             "flights lease their own lane widths (the regrid is the width "
                             "change)")
        # --model-parallel W: the ranks fold into a two-level (pop, model)
        # mesh, N/W lane rows of W ranks.  Lane slots (and the padded K)
        # count rows, not ranks: each lane's tensors split over its row.
        width = max(1, int(model_parallel))
        self.model_parallel = width
        self.mesh = (mesh if mesh is not None
                     else population_mesh(device, axis=axis, width=width))
        if self.mesh.width != width:
            raise ValueError(f"model_parallel={width} on a mesh of width {self.mesh.width}")
        n = self.mesh.world_size
        # population axis must divide over the mesh's rows: round lanes up
        # (same rule the trial applies to its batch, so slot count and padded
        # K agree)
        n_slots = pad_population(int(n_parallel), self.mesh)
        self.lanes_per_device = n_slots // self.mesh.rows
        # resource ids name width-wide rank slices: slot j of row i is
        # "slice[0:1,i*W:(i+1)*W]/lane{j}"
        self.slices = {s.slice_id: s for s in tile_pod((1, n), (1, width),
                                                       devices=self.mesh.devices)}
        super().__init__(n_parallel=0, **kwargs)  # resources added below
        self.n_slots = n_slots
        for lane in range(self.lanes_per_device):
            for sid in self.slices:
                self.add_resource(f"{sid}/lane{lane}")
        self._degraded = False
        self.n_degraded_flights = 0
        # --elastic-regrid: the trial regrids through the pool at rung
        # boundaries, so width changes ride the scale-out/in protocol
        self.elastic = ElasticLanePool(self.mesh) if elastic_regrid else None

    def _on_flight_death(self, attempt: int) -> None:
        if not self._degraded and attempt >= self.supervisor.max_restarts:
            self._degraded = True
            if self.journal is not None:
                self.journal.append(
                    "mesh_degrade", step=attempt,
                    detail="sharded flight kept dying; retrying vmapped on rank 0")

    def _run_batch(self, runner: Callable, configs: List[dict],
                   scheduler=None) -> List[Any]:
        # discriminate on the signature, not on a raised TypeError: an
        # in-flight TypeError must propagate, never silently re-run the batch
        # on the single-device engine
        kwargs = {}
        if accepts_kwarg(runner, "mesh") and not self._degraded:
            kwargs["mesh"] = self.mesh
            # a degraded flight runs on rank 0 alone: it has no pool's ranks
            if self.elastic is not None and accepts_kwarg(runner, "elastic"):
                kwargs["elastic"] = self.elastic
        if self._degraded:
            self.n_degraded_flights += 1
        if scheduler is not None:  # streaming (lane-refill) flight
            kwargs["scheduler"] = scheduler
        return runner(configs, **kwargs)
