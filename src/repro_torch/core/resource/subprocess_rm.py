"""Paper-faithful script jobs (§III-B2, Code 3/5).

The job's BasicConfig is written to ``<workdir>/job_<id>.json``; the user's
self-executable script runs as ``python <script> <json>``; stdout is parsed
for the ``print_result`` line.  The resource id is exported as
``REPRO_RESOURCE`` (the CUDA_VISIBLE_DEVICES analogue — on TPU the slice name).
"""
from __future__ import annotations

import os
import subprocess
import sys
import threading
from typing import Any, Optional

from . import ResourceManager, register
from ..basic_config import parse_result
from ..job import Job, JobResult, JobStatus


@register("subprocess")
@register("node")
class SubprocessResourceManager(ResourceManager):
    def __init__(self, n_parallel: int = 1, workdir: str = ".aup_jobs",
                 resource_prefix: str = "node", timeout_s: Optional[float] = None, **kwargs):
        super().__init__(**kwargs)
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.timeout_s = timeout_s
        self._procs = {}
        for i in range(int(n_parallel)):
            self.add_resource(f"{resource_prefix}{i}")

    def run(self, job: Job, target: str) -> None:
        self.bind(job.resource_id, job)
        cfg_path = os.path.join(self.workdir, f"job_{job.job_id}.json")
        job.config.save(cfg_path)

        def _worker():
            job.mark_running()
            env = dict(os.environ)
            env["REPRO_RESOURCE"] = str(job.resource_id)
            try:
                proc = subprocess.Popen(
                    [sys.executable, target, cfg_path],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                )
                self._procs[job.job_id] = proc
                out, err = proc.communicate(timeout=self.timeout_s)
                if proc.returncode != 0:
                    job.fail(f"exit {proc.returncode}: {err[-500:]}")
                    return
                payload = parse_result(out)
                job.finish(JobResult(score=payload["score"], extra=payload.get("extra")))
            except subprocess.TimeoutExpired:
                proc.kill()
                job.fail("timeout", status=JobStatus.KILLED)
            except Exception as e:
                job.fail(f"{type(e).__name__}: {e}")
            finally:
                self._procs.pop(job.job_id, None)

        threading.Thread(target=_worker, name=f"job-{job.job_id}", daemon=True).start()

    def kill(self, job: Job) -> None:
        proc = self._procs.get(job.job_id)
        if proc is not None:
            proc.kill()
        job.fail("killed by deadline", status=JobStatus.KILLED)
