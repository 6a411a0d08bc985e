"""Local thread-pool resource manager — in-process callable jobs.

``target`` is a Python callable ``f(config_dict) -> score`` (or
``(score, extra)``).  Each resource is one worker slot; the callable runs in a
daemon thread and the job's callback fires from that thread — exercising the
same async path a pod deployment uses.
"""
from __future__ import annotations

import threading
from typing import Any, Callable

from . import ResourceManager, register
from ..job import Job, JobResult, JobStatus


@register("local")
@register("cpu")
@register("gpu")
class LocalResourceManager(ResourceManager):
    def __init__(self, n_parallel: int = 1, resource_prefix: str = "local", **kwargs):
        super().__init__(**kwargs)
        for i in range(int(n_parallel)):
            self.add_resource(f"{resource_prefix}{i}")

    def run(self, job: Job, target: Callable[[dict], Any]) -> None:
        self.bind(job.resource_id, job)

        def _worker():
            job.mark_running()
            try:
                out = target(dict(job.config))
                score, extra = out if isinstance(out, tuple) else (out, None)
                job.finish(JobResult(score=float(score), extra=extra))
            except Exception as e:  # job error != framework error
                job.fail(f"{type(e).__name__}: {e}")

        t = threading.Thread(target=_worker, name=f"job-{job.job_id}", daemon=True)
        t.start()

    def kill(self, job: Job) -> None:
        # Python threads cannot be force-killed; mark the job KILLED so its
        # eventual return is ignored (Job.finish fires the callback only once).
        job.fail("killed by deadline", status=JobStatus.KILLED)
