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
Elastic regrid comes with a later part of the port and raises.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

from . import register
from .mesh_pool import tile_pod
from .vectorized import VectorizedResourceManager, accepts_kwarg


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
        from ...distributed.sharding import PART_C, population_mesh
        from ...train.population import pad_population

        if elastic_regrid:
            raise NotImplementedError(f"elastic regrid is not ported yet; it comes with {PART_C}")
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
        if self._degraded:
            self.n_degraded_flights += 1
        if scheduler is not None:  # streaming (lane-refill) flight
            kwargs["scheduler"] = scheduler
        return runner(configs, **kwargs)
