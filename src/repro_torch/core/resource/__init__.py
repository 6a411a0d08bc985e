"""Resource Manager interface (paper §III-B) + registry.

``get_available()`` returns a free resource id (or None — Algorithm 1 then
waits), ``run(job, target)`` launches the job on that resource and arranges
for ``job.finish(...)`` to fire asynchronously (the callback mechanism), and
``release(res)`` returns the resource to the pool.

Implementations:
* ``local``      — thread pool over in-process callables (paper's CPU/GPU mode)
* ``subprocess`` — paper-faithful script jobs: JSON argv[1] in, stdout score out
* ``elastic``    — wraps another manager; slices join/leave mid-experiment
                   (EC2-autoscaling analogue + node-failure injection)
* ``vectorized`` — K population slots; bound jobs are batched and executed as
                   ONE vmapped device program (compile-once HPO hot path)
* ``mesh``       — trials on contiguous tiles of a device grid (mesh slices)
* ``sharded``    — the vectorized manager's lanes split over the ranks of a
                   population mesh (``--shard-population``)
"""
from __future__ import annotations

import abc
import threading
from typing import Any, Callable, Dict, List, Optional, Type

from ..job import Job, JobStatus

_REGISTRY: Dict[str, Type["ResourceManager"]] = {}


def register(name: str):
    def deco(cls):
        _REGISTRY[name.lower()] = cls
        cls.registry_name = name.lower()
        return cls
    return deco


def get_resource_manager_cls(name: str) -> Type["ResourceManager"]:
    key = name.lower()
    if key not in _REGISTRY:
        raise KeyError(f"unknown resource manager {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def available_resource_managers() -> List[str]:
    return sorted(_REGISTRY)


class ResourceManager(abc.ABC):
    registry_name = "base"

    def __init__(self, **_unused: Any):
        self._lock = threading.RLock()
        self._free: List[Any] = []
        self._busy: Dict[Any, Optional[Job]] = {}

    # -- pool bookkeeping (shared) ---------------------------------------------
    def add_resource(self, res_id: Any) -> None:
        with self._lock:
            if res_id not in self._free and res_id not in self._busy:
                self._free.append(res_id)

    def remove_resource(self, res_id: Any) -> Optional[Job]:
        """Remove a resource; returns the job that was running on it (if any),
        which the caller should mark LOST (node-failure semantics)."""
        with self._lock:
            if res_id in self._free:
                self._free.remove(res_id)
                return None
            return self._busy.pop(res_id, None)

    def get_available(self) -> Optional[Any]:
        with self._lock:
            if not self._free:
                return None
            res = self._free.pop(0)
            self._busy[res] = None
            return res

    def release(self, res_id: Any) -> None:
        with self._lock:
            if res_id in self._busy:
                del self._busy[res_id]
                self._free.append(res_id)

    def n_total(self) -> int:
        with self._lock:
            return len(self._free) + len(self._busy)

    def n_free(self) -> int:
        with self._lock:
            return len(self._free)

    def bind(self, res_id: Any, job: Job) -> None:
        with self._lock:
            if res_id in self._busy:
                self._busy[res_id] = job

    # -- execution ----------------------------------------------------------------
    @abc.abstractmethod
    def run(self, job: Job, target: Any) -> None:
        """Launch ``job`` on ``job.resource_id``; must call job.finish/fail
        asynchronously and must NOT raise for job-level errors."""

    def kill(self, job: Job) -> None:
        """Best-effort termination (straggler mitigation)."""
        job.fail("killed by deadline", status=JobStatus.KILLED)

    def shutdown(self) -> None:
        pass


from . import local, subprocess_rm, elastic, vectorized, mesh_pool, sharded  # noqa: E402,F401
