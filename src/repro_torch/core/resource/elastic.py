"""Elastic resource pool — scale-out/in + node-failure semantics.

Wraps any base ResourceManager.  ``scale_out(ids)`` adds resources mid-flight
(the boto3/EC2-autoscaling analogue from §III-B1); ``fail_resource(id)``
removes one *while a job may be running on it* — the job is marked LOST and the
Experiment's retry policy re-proposes it.  This is the mechanism the
fault-tolerance integration tests drive.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

from . import ResourceManager, register
from ..job import Job, JobStatus


@register("elastic")
class ElasticResourceManager(ResourceManager):
    def __init__(self, base: ResourceManager = None, **kwargs):
        super().__init__(**kwargs)
        if base is None:
            from .local import LocalResourceManager

            base = LocalResourceManager(n_parallel=kwargs.get("n_parallel", 1))
        self.base = base
        self.lost_jobs = []

    # delegate pool bookkeeping to the base manager -----------------------------
    def get_available(self) -> Optional[Any]:
        return self.base.get_available()

    def release(self, res_id: Any) -> None:
        self.base.release(res_id)

    def n_total(self) -> int:
        return self.base.n_total()

    def n_free(self) -> int:
        return self.base.n_free()

    def bind(self, res_id: Any, job: Job) -> None:
        self.base.bind(res_id, job)

    def run(self, job: Job, target: Any) -> None:
        self.base.run(job, target)

    def kill(self, job: Job) -> None:
        self.base.kill(job)

    # elasticity -----------------------------------------------------------------
    def scale_out(self, res_ids) -> None:
        for r in res_ids:
            self.base.add_resource(r)

    # common alias
    add_resources = scale_out

    def scale_in(self, res_ids) -> None:
        for r in res_ids:
            victim = self.base.remove_resource(r)
            if victim is not None:
                self.lost_jobs.append(victim)
                victim.fail(f"resource {r} removed", status=JobStatus.LOST)

    def fail_resource(self, res_id: Any) -> Optional[Job]:
        """Simulate a node failure: resource disappears, running job is LOST."""
        victim = self.base.remove_resource(res_id)
        if victim is not None:
            self.lost_jobs.append(victim)
            victim.fail(f"node failure on {res_id}", status=JobStatus.LOST)
        return victim
