"""Experiment — the paper's Algorithm 1 orchestration loop.

    while not proposer.finished():
        resource <- resource_manager.get_available()
        if not resource: sleep
        hyperparameters <- proposer.get_param()
        Job <- aup.run(hyperparameters, resource)
        if Job.callback(): proposer.update()
    aup.finish()   # wait for unfinished jobs

plus the production features a thousand-node deployment needs:

* **asynchronous callbacks** — jobs finish on worker threads; results flow
  through a queue so the proposer stays single-threaded;
* **fault tolerance** — every proposal/result is in SQLite *before* it is
  acted on; ``Experiment.resume()`` replays finished jobs into the proposer
  and re-queues the ones that were mid-flight at the crash;
* **straggler mitigation** — per-job deadline -> kill -> retry;
* **retries** — failed/LOST jobs are resubmitted up to ``max_retries`` before
  the failure is surfaced to the proposer; the retry budget is tracked per job
  lineage (on the Job itself), so two proposals with identical params cannot
  eat each other's retries;
* **batched proposal draining** — each loop pass claims every free resource
  and asks the proposer for that many configs at once (``get_params``), which
  lets the vectorized resource manager fill a whole population per round;
* **elasticity** — works with ElasticResourceManager; lost resources simply
  shrink the pool, lost jobs are retried.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from . import faultinject
from .basic_config import BasicConfig
from .job import Job, JobStatus
from .proposer import make_proposer
from .resource import ResourceManager, get_resource_manager_cls
from .tracking.database import FlightJournal, TrackingDB


class Experiment:
    def __init__(
        self,
        exp_config: Dict[str, Any],
        target: Any,
        db: Optional[TrackingDB] = None,
        resource_manager: Optional[ResourceManager] = None,
        user: str = "default",
    ):
        self.exp_config = dict(exp_config)
        self.target = target
        self.db = db or TrackingDB(exp_config.get("db_path", ":memory:"))
        self.user = user

        from .search_space import SearchSpace

        space = SearchSpace.from_json(self.exp_config.get("parameter_config", []))
        maximize = self.exp_config.get("target", "max") == "max"
        prop_kwargs = {
            k: v
            for k, v in self.exp_config.items()
            if k
            not in (
                "proposer", "parameter_config", "target", "resource", "script",
                "n_parallel", "db_path", "workdir", "job_deadline_s", "max_retries",
                "lane_refill", "cli", "snapshot_every", "snapshot_dir",
                "max_flight_restarts", "restart_backoff_s",
                "finish_join_timeout_s", "fault_spec", "resume",
                "model_parallel",
            )
        }
        self.proposer = make_proposer(
            self.exp_config["proposer"], space, maximize=maximize, **prop_kwargs
        )
        self.maximize = maximize

        if resource_manager is not None:
            self.rm = resource_manager
        else:
            rm_cls = get_resource_manager_cls(self.exp_config.get("resource", "local"))
            rm_kwargs: Dict[str, Any] = {"n_parallel": int(self.exp_config.get("n_parallel", 1))}
            if self.exp_config.get("workdir"):
                rm_kwargs["workdir"] = self.exp_config["workdir"]
            if self.exp_config.get("lane_refill"):
                rm_kwargs["lane_refill"] = True
            if self.exp_config.get("elastic_regrid"):
                # sharded manager only: lane geometry leased through an
                # ElasticLanePool so rung survivors absorb freed devices
                rm_kwargs["elastic_regrid"] = True
            if self.exp_config.get("model_parallel"):
                # sharded manager only: fold the device grid into a two-level
                # (pop, model) mesh whose model axis carries tensor-parallel
                # compute inside every lane
                rm_kwargs["model_parallel"] = int(self.exp_config["model_parallel"])
            for k in ("max_flight_restarts", "restart_backoff_s",
                      "finish_join_timeout_s"):
                if self.exp_config.get(k) is not None:
                    rm_kwargs[k] = self.exp_config[k]
            self.rm = rm_cls(**rm_kwargs)
            # unknown kwargs are silently swallowed by ResourceManager.__init__;
            # a streaming request that cannot stream must fail loudly instead
            if rm_kwargs.get("lane_refill") and not getattr(self.rm, "lane_refill", False):
                raise ValueError(
                    f"lane_refill requested but resource "
                    f"{self.exp_config.get('resource', 'local')!r} does not "
                    f"support streaming flights (use 'vectorized' or 'sharded')"
                )
        if (self.exp_config.get("lane_refill")
                and getattr(target, "per_trial_streams", True) is False):
            # refill was an *implicit* per-trial-stream assumption once; a
            # shared-stream target must fail at construction, not mid-flight
            # (a refilled lane has to replay its own stream from its step 0)
            raise ValueError(
                "lane_refill requires per-trial data streams: the target was "
                "built with per_trial_streams=False (drop --shared-stream)"
            )

        # lifecycle passthrough: a streaming proposer (PBT) exposes the
        # engine-facing half of its exploit/explore rule via lifecycle_hook();
        # targets with a `lifecycle` slot (PopulationTrial) get it wired here
        # so the lane-refill engine can execute keep/clone directives as
        # compiled lane ops.
        hook_factory = getattr(self.proposer, "lifecycle_hook", None)
        if hook_factory is not None and hasattr(self.target, "lifecycle"):
            hook = hook_factory()
            if hook is not None and getattr(self.target, "lifecycle") is None:
                self.target.lifecycle = hook

        self.deadline_s = self.exp_config.get("job_deadline_s")
        self.max_retries = int(self.exp_config.get("max_retries", 1))

        self.exp_id: Optional[int] = None
        self._next_job_id = 0
        self._cond = threading.Condition()
        self._finished_q: List[Job] = []
        self._running: Dict[int, Job] = {}
        # crash-resume / retry entries: (config, n_prior_retries).  Retries are
        # counted per job lineage, NOT per config value — two proposals with
        # identical params must not share a retry budget.
        self._requeue: List[tuple] = []
        self.job_log: List[Job] = []
        # incremental result hooks: fired once per *settled* job (scored, or
        # retries exhausted) as results drain — on the streaming engines this
        # happens while the rest of the population batch is still running
        self._result_callbacks: List[Callable[[Job], None]] = []

    def add_result_callback(self, fn: Callable[[Job], None]) -> None:
        """Register a hook fired for every settled job (finished with a score,
        or failed for good after its retry budget).  Fires on the experiment
        loop thread as soon as the result drains — with a streaming resource
        manager that is mid-batch, not at flight end.  Keep it fast: it runs
        under the experiment lock."""
        self._result_callbacks.append(fn)

    # -- callback (fires on worker threads; keep it tiny) -----------------------
    def _on_job_done(self, job: Job) -> None:
        with self._cond:
            self._finished_q.append(job)
            self._cond.notify_all()

    # -- helpers ------------------------------------------------------------------
    def _wire_journal(self) -> None:
        """Hand a ``FlightJournal`` to every collaborator exposing a
        ``journal`` slot (the streaming resource managers and the population
        trial), so flight deaths / restarts / snapshots / lane leases land in
        the tracking DB as write-ahead rows keyed to this experiment."""
        if self.exp_id is None:
            return
        journal = FlightJournal(self.db, self.exp_id)
        for obj in (self.rm, self.target):
            if hasattr(obj, "journal") and getattr(obj, "journal") is None:
                obj.journal = journal

    def _next_configs(self, k: int) -> List[tuple]:
        """Up to ``k`` ``(config, n_prior_retries)`` pairs: requeued jobs first,
        then a batched drain of the proposer (``get_params``) so synchronous
        proposers can fill a whole population of resources per loop pass.

        The requeue drains even when the proposer reports ``finished()`` —
        after a crash-resume every remaining job can be a re-queued lineage
        with zero proposals left to draw, and skipping the drain would strand
        them (the loop would spin on "finished but requeue non-empty")."""
        out: List[tuple] = []
        while self._requeue and len(out) < k:
            out.append(self._requeue.pop(0))
        if len(out) < k and not self.proposer.finished():
            out.extend((cfg, 0) for cfg in self.proposer.get_params(k - len(out)))
        return out

    def _drain_finished_locked(self) -> None:
        """Process completed jobs: DB, retries, proposer update, release."""
        while self._finished_q:
            job = self._finished_q.pop(0)
            self._running.pop(job.job_id, None)
            res = job.result
            ok = job.status == JobStatus.FINISHED and res is not None and res.score is not None
            self.db.record_job_end(
                self.exp_id, job.job_id, job.status.value,
                None if res is None else res.score,
                None if res is None else res.extra,
                None if res is None else res.error,
            )
            # resource returns to the pool unless it was lost with the node
            if job.status != JobStatus.LOST:
                self.rm.release(job.resource_id)
            if ok:
                self.proposer.update(res.score, job)
                self._fire_result_callbacks(job)
            else:
                # per-job retry counter rides on the Job itself: distinct
                # proposals with identical params keep separate retry budgets
                n = getattr(job, "retries", 0)
                if n < self.max_retries and not getattr(job, "quarantined", False):
                    cfg = {k: v for k, v in job.config.items() if k != "job_id"}
                    # the retry must keep the lineage's data stream: anonymous
                    # configs stream by job_id, and the new attempt gets a NEW
                    # job_id — without this stamp a retried trial would train
                    # on different batches than the original (and than an
                    # uninterrupted run)
                    cfg.setdefault("stream", job.job_id)
                    self._requeue.append((cfg, n + 1))
                else:
                    # quarantined jobs (poison lane across consecutive flight
                    # deaths) skip their remaining retry budget by design
                    self.proposer.update(None, job)
                    self._fire_result_callbacks(job)

    def _fire_result_callbacks(self, job: Job) -> None:
        for fn in self._result_callbacks:
            try:
                fn(job)
            except Exception:  # observers must never break the loop
                pass

    def _check_stragglers_locked(self) -> None:
        for job in list(self._running.values()):
            if job.is_overdue():
                self.rm.kill(job)

    # -- main loop -------------------------------------------------------------------
    def run(self, poll_interval: float = 0.02) -> Optional[Dict[str, Any]]:
        if self.exp_id is None:
            self.exp_id = self.db.create_experiment(self.exp_config, self.user)
        self._wire_journal()
        t0 = time.time()
        while True:
            with self._cond:
                self._drain_finished_locked()
                self._check_stragglers_locked()
                done = self.proposer.finished() and not self._running and not self._requeue
            if done:
                break

            res = self.rm.get_available()
            if res is None:
                if not self._running and self.rm.n_total() == 0:
                    raise RuntimeError("no resources left in the pool and none running")
                with self._cond:
                    self._cond.wait(timeout=poll_interval)
                continue

            # batched proposal draining: claim every free resource this pass so
            # a synchronous proposer can fill a whole population per round
            resources = [res]
            nxt = self.rm.get_available()
            while nxt is not None:
                resources.append(nxt)
                nxt = self.rm.get_available()

            with self._cond:
                self._drain_finished_locked()
                pairs = self._next_configs(len(resources))
                if pairs:
                    # write-ahead: the proposer's draw state lands in the DB
                    # before the drawn configs are acted on, so a resumed
                    # proposer continues the exact sequence an uninterrupted
                    # run would have produced (running rows replay as proposed)
                    try:
                        self.db.save_proposer_state(
                            self.exp_id, self.proposer.state_json())
                    except Exception:
                        pass  # state WAL is best-effort, never the data path
            if not pairs:
                for r in resources:
                    self.rm.release(r)
                with self._cond:
                    if self.proposer.finished() and not self._running and not self._requeue:
                        break
                    self._cond.wait(timeout=poll_interval)
                continue

            for (cfg, retries), r in zip(pairs, resources):
                job_id = self._next_job_id
                self._next_job_id += 1
                # chaos hook: 'raise@issue=N' — the classic between-batches
                # controller crash, right before job N lands in the DB
                faultinject.check("issue", issue=job_id)
                cfg = dict(cfg)
                cfg["job_id"] = job_id  # paper Code 1: job_id rides in the BasicConfig
                bc = BasicConfig(**cfg)
                job = Job(job_id, bc, r, self._on_job_done, deadline_s=self.deadline_s)
                job.retries = retries
                with self._cond:
                    self._running[job_id] = job
                self.job_log.append(job)
                self.db.record_job_start(self.exp_id, job_id, bc.to_json(), str(r))
                self.rm.run(job, self.target)
            # unused claims go back; for the vectorized manager this release is
            # also the signal to flush a partial population batch
            for r in resources[len(pairs):]:
                self.rm.release(r)

        # aup.finish(): drain stragglers, then let the resource manager close
        # any live streaming flight instead of lingering on its idle grace
        with self._cond:
            self._drain_finished_locked()
        rm_finish = getattr(self.rm, "finish", None)
        if rm_finish is not None:
            rm_finish()
        self.db.finish_experiment(self.exp_id)
        self.wall_time_s = time.time() - t0
        return self.best()

    def best(self) -> Optional[Dict[str, Any]]:
        return self.proposer.best()

    # -- crash-resume --------------------------------------------------------------
    @classmethod
    def resume(
        cls,
        db: TrackingDB,
        target: Any,
        exp_id: Optional[int] = None,
        resource_manager: Optional[ResourceManager] = None,
        user: str = "default",
    ) -> "Experiment":
        exp_id = exp_id if exp_id is not None else db.latest_experiment_id()
        if exp_id is None:
            raise ValueError("no experiment to resume")
        row = db.get_experiment(exp_id)
        exp = cls(row["exp_config"], target, db=db, resource_manager=resource_manager, user=user)
        exp.exp_id = exp_id
        rows = db.jobs(exp_id)
        # rows a *previous* resume marked lost ("controller crash") were
        # re-queued then under a new job id whose own row carries the outcome;
        # replaying them again would double-count the lineage on the 2nd+
        # resume (once as failed, once via the successor's row)
        live_rows = [r for r in rows
                     if not (r["status"] == "lost"
                             and r.get("error") == "controller crash")]
        exp.proposer.replay(live_rows)
        # the draw-state WAL puts the RNG back where the last proposal batch
        # left it, so the remaining draws continue the uninterrupted sequence
        exp.proposer.load_state_json(db.load_proposer_state(exp_id))
        max_id = -1
        for r in rows:
            max_id = max(max_id, int(r["job_id"]))
            if r["status"] == "running":  # mid-flight at crash -> re-queue
                cfg = {k: v for k, v in r["config"].items() if k != "job_id"}
                # keep the lineage's data stream across the new job id (see
                # the retry path) — bit-identical resume depends on it
                cfg.setdefault("stream", r["config"].get("stream", r["job_id"]))
                exp._requeue.append((cfg, 0))
                db.record_job_end(exp_id, r["job_id"], "lost", None, None, "controller crash")
        exp._next_job_id = max_id + 1
        exp._wire_journal()
        try:
            db.journal_append(exp_id, "resume",
                              detail={"requeued": len(exp._requeue)})
        except Exception:
            pass
        return exp
