"""Job object + status machine (paper §III-B2).

A Job wraps one execution of the user's code with one BasicConfig on one
resource.  ``callback`` fires exactly once when the job finishes (success or
failure) — it is the hook that triggers ``proposer.update()`` asynchronously
in Algorithm 1.
"""
from __future__ import annotations

import dataclasses
import enum
import threading
import time
from typing import Any, Callable, Dict, Optional

from .basic_config import BasicConfig


class JobStatus(str, enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    FINISHED = "finished"
    FAILED = "failed"
    KILLED = "killed"      # straggler mitigation / early stop
    LOST = "lost"          # resource disappeared (node failure)


@dataclasses.dataclass
class JobResult:
    score: Optional[float]
    extra: Any = None
    error: Optional[str] = None
    wall_time_s: float = 0.0


class Job:
    """One (config, resource) execution unit."""

    def __init__(
        self,
        job_id: int,
        config: BasicConfig,
        resource_id: Any,
        callback: Callable[["Job"], None],
        deadline_s: Optional[float] = None,
    ):
        self.job_id = job_id
        self.config = config
        self.resource_id = resource_id
        self.retries = 0  # how many prior attempts this lineage already burned
        self.status = JobStatus.PENDING
        self.result: Optional[JobResult] = None
        self.deadline_s = deadline_s
        self.start_time: Optional[float] = None
        self.end_time: Optional[float] = None
        self._callback = callback
        self._done = threading.Event()
        self._cb_fired = False
        self._lock = threading.Lock()

    # -- lifecycle ----------------------------------------------------------
    def mark_running(self) -> None:
        self.status = JobStatus.RUNNING
        self.start_time = time.time()

    def finish(self, result: JobResult, status: JobStatus = JobStatus.FINISHED) -> bool:
        """Complete the job and fire the callback exactly once (thread-safe).
        Returns True when this call delivered the result, False when the job
        was already settled (e.g. killed by a deadline)."""
        with self._lock:
            if self._cb_fired:
                return False
            self._cb_fired = True
            self.end_time = time.time()
            if self.start_time is not None:
                result.wall_time_s = self.end_time - self.start_time
            self.result = result
            self.status = status
        try:
            self._callback(self)
        finally:
            self._done.set()
        return True

    def fail(self, error: str, status: JobStatus = JobStatus.FAILED) -> None:
        self.finish(JobResult(score=None, error=error), status=status)

    def is_overdue(self) -> bool:
        return (
            self.deadline_s is not None
            and self.status == JobStatus.RUNNING
            and self.start_time is not None
            and (time.time() - self.start_time) > self.deadline_s
        )

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def to_row(self) -> Dict[str, Any]:
        return {
            "job_id": self.job_id,
            "config": self.config.to_json(),
            "resource_id": str(self.resource_id),
            "status": self.status.value,
            "score": None if self.result is None else self.result.score,
            "error": None if self.result is None else self.result.error,
            "start_time": self.start_time,
            "end_time": self.end_time,
        }
