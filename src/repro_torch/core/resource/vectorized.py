"""Vectorized resource manager — K population slots, one device program.

Presents ``n_slots`` resources to Algorithm 1, but instead of launching each
job on its own worker it *buffers* bound jobs and executes a whole batch in a
single call — on the training substrate that call is one vmapped, jitted
population step advancing every trial simultaneously (see
``repro_torch.train.population``).  ``ShardedPopulationResourceManager`` (in
``sharded.py``) keeps this exact buffering/flush machinery but lands the
batch on an N-device mesh: slots become per-device *lanes* and the batch call
carries the mesh.

Batch protocol: if the experiment's ``target`` exposes

    run_population(configs: list[dict]) -> list[score | (score, extra)]

the buffered batch goes through it in one shot (scores come back positionally,
one per config).  Otherwise the manager degrades gracefully to looping the
scalar ``target(config)`` over the batch on one worker thread — same
scheduling semantics, no vectorization.

Streaming protocol (``lane_refill=True``): when the target's
``run_population`` also accepts a ``scheduler`` keyword, the flush hands it a
``LaneScheduler`` instead of a positional batch.  The engine then *leases*
jobs into population lanes one at a time and *completes* them individually as
lanes retire (budget exhausted, rung-truncated, diverged) — each completion
fires the job callback immediately, Algorithm 1 releases the slot, the
proposer refills it, and ``run()`` offers the new job straight into the live
flight.  Freed lanes are re-initialized **inside the compiled program**
(``repro_torch.train.population.make_reset_lanes``), so the whole experiment can be
one continuous flight with no inter-batch bubble.  The engine polls the
scheduler (lease/complete) only at *event* steps — with ``chunk_steps > 1``
that cadence is per fused chunk, not per training step: offers made mid-chunk
are picked up at the next chunk boundary.

Lifecycle dispatch (streaming PBT): when the target carries a ``lifecycle``
hook (``core.proposer.pbt.PBTLifecycle``, wired by the Experiment from the
proposer's ``lifecycle_hook()``), the flush hands it to the ``LaneScheduler``
so jobs carrying lane-lifecycle directives are sequenced safely: a *donor*
member whose weights a pending clone still needs is deferred at lease time
(donor lease pinning) until the engine executes the compiled clone/splice op
— the engine-side half of the dispatch lives in
``PopulationTrial._run_streaming``.

Flush policy:

* the buffer flushes when all ``n_slots`` are bound (a full population), and
* ``release()`` of an *unbound* slot while jobs are buffered flushes a partial
  batch — that release is Algorithm 1 telling us the proposer has nothing
  more right now (budget exhausted, rung/generation barrier), so waiting for
  a full population would deadlock the loop.  While a streaming flight is
  live, buffered jobs drain *into* it instead of opening a second flight.

Failure blast radius stays as small as the protocol allows: on the scalar
fallback path every job is called (and caught) individually; on the batch
path a malformed *result* fails only its own job, and only an exception from
inside the single device program fails the whole batch.  A streaming flight
that dies fails its leased jobs; jobs still queued go back to the buffer's
retry path instead of being silently stranded.
"""
from __future__ import annotations

import inspect
import threading
import warnings
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from . import ResourceManager, register
from ..job import Job, JobResult, JobStatus


def accepts_kwarg(fn: Callable, name: str) -> bool:
    """True when ``fn`` can be called with keyword ``name`` (explicitly or via
    ``**kwargs``).  Signature-less builtins count as True — an in-flight
    ``TypeError`` must propagate rather than silently change the protocol."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return True
    return name in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()
    )


class LaneScheduler:
    """Host-side lane <-> job ledger for one streaming (lane-refill) flight.

    The manager *offers* bound jobs; the population engine *leases* them into
    freed lanes (``lease() -> (handle, config)``) and *completes* them
    individually as lanes retire, so results stream out while the flight is
    still running.  ``close()`` ends the flight: it stops further offers and
    splits the ledger into jobs never leased (the manager re-buffers or fails
    them) and leased-but-incomplete orphans (the engine died mid-lane).

    Thread-safety: ``offer`` is called from Algorithm 1's loop thread,
    ``lease``/``complete``/``fail`` from the flight worker thread, ``close``
    from the flight worker after the engine returns.  All state is guarded by
    one lock; job completion callbacks fire outside it.

    ``lifecycle`` (optional) is a lane-lifecycle hook (e.g. the streaming PBT
    proposer's ``PBTLifecycle``): jobs it reports ``lease_blocked`` — a
    ``keep`` round for a member pinned as a pending clone's donor — are
    rotated to the back of the queue instead of leased, so the donor's lane
    cannot resume training (and drift its weights) before the clone's device
    copy executes.  ``n_donor_waits`` counts those deferrals.
    """

    def __init__(self, on_stream: Optional[Callable[[], None]] = None,
                 lifecycle: Any = None) -> None:
        self._lock = threading.Lock()
        self._queue: Deque[Job] = deque()
        self._live: Dict[int, Job] = {}
        self._next_handle = 0
        self._on_stream = on_stream  # fired per streamed result, mid-flight
        self._lifecycle = lifecycle
        self.closed = False
        self.n_leased = 0
        self.n_streamed = 0
        self.n_donor_waits = 0
        self.n_device_retired = 0  # retirements harvested from a scan's log
        self._donor_waited: set = set()  # job ids counted once, not per poll

    # -- manager side -----------------------------------------------------------
    def offer(self, job: Job) -> bool:
        """Queue a job for the flight; False once the flight is shutting down
        (the caller keeps the job and flushes it into a fresh flight)."""
        with self._lock:
            if self.closed:
                return False
            self._queue.append(job)
            return True

    def close(self) -> Tuple[List[Job], List[Job]]:
        """Stop accepting offers; return ``(never_leased, leased_incomplete)``."""
        with self._lock:
            self.closed = True
            leftovers = [j for j in self._queue if j.status == JobStatus.PENDING]
            self._queue.clear()
            orphans = list(self._live.values())
            self._live.clear()
        return leftovers, orphans

    # -- engine side ------------------------------------------------------------
    def lease(self) -> Optional[Tuple[int, dict]]:
        """Next leasable job as ``(handle, config)``, or None when the queue
        holds nothing leasable right now.  Jobs killed/lost while buffered are
        skipped (a dead clone releases its donor pin); jobs the lifecycle hook
        blocks — a donor's next round while its weights await a pending clone
        copy — rotate to the back and stay queued."""
        with self._lock:
            for _ in range(len(self._queue)):
                job = self._queue.popleft()
                if job.status != JobStatus.PENDING:
                    # killed/lost while buffered: the Experiment's retry path
                    # re-offers the same config, so any donor pin stays held
                    # until the retried clone executes (or fails for good)
                    continue
                if self._lifecycle is not None and self._lifecycle.lease_blocked(
                        dict(job.config)):
                    self._queue.append(job)
                    if job.job_id not in self._donor_waited:
                        self._donor_waited.add(job.job_id)
                        self.n_donor_waits += 1
                    continue
                handle = self._next_handle
                self._next_handle += 1
                self._live[handle] = job
                self.n_leased += 1
                job.mark_running()
                return handle, dict(job.config)
            return None

    def complete(self, handle: int, score: float, extra: Any = None) -> None:
        """Retire a leased job with its score — fires the job callback now,
        while the flight keeps running (the streaming-result path).  Jobs
        already settled (deadline-killed mid-lane) do not count as streamed."""
        with self._lock:
            job = self._live.pop(handle, None)
        if job is None or job.done:  # already settled: deadline-killed mid-lane
            return
        # count before finish: the finish callback can end the experiment, and
        # readers of the counters must see this result included.  (A kill
        # landing in between is a benign +-1 on telemetry.)
        with self._lock:
            self.n_streamed += 1
        if self._on_stream is not None:
            self._on_stream()
        job.finish(JobResult(score=float(score), extra=extra))

    def complete_retirements(self, events: List[Tuple[int, float, Any]]) -> None:
        """Consume a device dispatch's emitted retirement log (--device-rules):
        one ``(handle, score, extra)`` triple per lane the in-scan rules ended.
        Each settles through ``complete`` — streaming semantics, counters and
        callbacks unchanged — but they arrive as one batch per dispatch rather
        than one host sync per event step, and ``n_device_retired`` records
        that the decisions were made on-device."""
        for handle, score, extra in events:
            self.complete(handle, score, extra=extra)
        with self._lock:
            self.n_device_retired += len(events)

    def fail(self, handle: int, error: str) -> None:
        with self._lock:
            job = self._live.pop(handle, None)
        if job is not None:
            job.fail(str(error))

    # -- supervisor side --------------------------------------------------------
    def reclaim_live(self) -> List[Job]:
        """Pull every leased-but-incomplete job out of the ledger (the flight
        died mid-lane).  The supervisor decides each job's fate: requeue into
        the restarted flight, or quarantine after repeated deaths."""
        with self._lock:
            jobs = list(self._live.values())
            self._live.clear()
        return jobs

    def requeue(self, job: Job) -> None:
        """Put a reclaimed job back at the FRONT of the queue for the
        restarted flight (it already held a lane; it goes first).  The job
        returns to PENDING so ``lease`` picks it up again."""
        job.status = JobStatus.PENDING
        with self._lock:
            self._queue.appendleft(job)


class FlightSupervisor:
    """Restart policy for a streaming flight worker.

    On flight death the worker reclaims the leased lanes and asks this object
    how to proceed: up to ``max_restarts`` restarts with exponential backoff
    (``backoff_base_s * 2**(attempt-1)``, capped) plus deterministic jitter —
    seeded, so chaos tests replay exactly — and a poison threshold: a job
    whose lane was leased across ``poison_deaths`` consecutive flight deaths
    is the likely culprit and fails for good (quarantine) instead of riding
    every restart into the ground.
    """

    def __init__(self, max_restarts: int = 2, backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 2.0, poison_deaths: int = 2,
                 seed: int = 0):
        import random

        self.max_restarts = int(max_restarts)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.poison_deaths = int(poison_deaths)
        self._rng = random.Random(seed)

    def delay_s(self, attempt: int) -> float:
        base = self.backoff_base_s * (2.0 ** max(0, attempt - 1))
        return min(self.backoff_cap_s, base) * (1.0 + 0.25 * self._rng.random())


class QueueFeedScheduler:
    """Minimal streaming feed for driving ``run_population(scheduler=...)``
    directly, without Algorithm 1 — a fixed config queue, results keyed by
    lease order.  ``closed=True`` tells the flight no more jobs will ever
    come, so it returns the moment the queue drains instead of lingering for
    late offers.  This is the reference adapter the benchmarks and tests use;
    ``LaneScheduler`` is the Algorithm-1 (Job-backed) implementation of the
    same lease/complete protocol.
    """

    closed = True

    def __init__(self, cfgs) -> None:
        self._q: List[Tuple[int, dict]] = list(enumerate(dict(c) for c in cfgs))
        self.scores: Dict[int, float] = {}
        self.extras: Dict[int, Any] = {}

    def lease(self) -> Optional[Tuple[int, dict]]:
        return self._q.pop(0) if self._q else None

    def complete(self, handle: int, score: float, extra: Any = None) -> None:
        self.scores[handle] = float(score)
        self.extras[handle] = extra

    def ordered_scores(self, n: int) -> List[float]:
        return [self.scores[i] for i in range(n)]


@register("vectorized")
class VectorizedResourceManager(ResourceManager):
    def __init__(self, n_parallel: int = 8, resource_prefix: str = "slot",
                 lane_refill: bool = False, max_flight_restarts: int = 2,
                 restart_backoff_s: float = 0.05,
                 finish_join_timeout_s: float = 30.0, **kwargs):
        super().__init__(**kwargs)
        self.n_slots = int(n_parallel)
        for i in range(self.n_slots):
            self.add_resource(f"{resource_prefix}{i}")
        self._pending: List[Job] = []
        self._last_target: Any = None
        self.lane_refill = bool(lane_refill)
        self._scheduler: Optional[LaneScheduler] = None
        self.n_batches = 0
        self.batch_sizes: List[int] = []
        self.n_streamed = 0        # results delivered mid-flight (refill mode)
        self.n_refill_flights = 0
        self._warned_no_stream = False
        # latched when a runner advertises a scheduler kwarg (e.g. **kwargs)
        # but never leases from it — all later flushes take the batch path
        self._streaming_broken = False
        self._flight_thread: Optional[threading.Thread] = None
        # crash-safety: supervised flight restarts + quarantine + journal
        self.supervisor = FlightSupervisor(
            max_restarts=max_flight_restarts, backoff_base_s=restart_backoff_s)
        self.finish_join_timeout_s = float(finish_join_timeout_s)
        self.journal: Any = None   # FlightJournal, wired by the Experiment
        self.n_flight_deaths = 0
        self.n_flight_restarts = 0
        self.n_quarantined = 0

    # -- Algorithm 1 surface ----------------------------------------------------
    def run(self, job: Job, target: Callable) -> None:
        # jobs stay PENDING while buffered: the straggler deadline clock only
        # starts when the batch actually executes (mark_running in the worker)
        self.bind(job.resource_id, job)
        with self._lock:
            self._last_target = target
            sch = self._scheduler
            if sch is not None and sch.offer(job):
                return  # spliced straight into the live streaming flight
            self._pending.append(job)
            full = len(self._pending) >= self.n_slots
        if full:
            self._flush(target)

    def release(self, res_id: Any) -> None:
        super().release(res_id)
        # an unbound slot coming back with jobs buffered == "no more proposals
        # are coming before a callback fires" -> run the partial population
        with self._lock:
            has_pending = bool(self._pending)
            target = self._last_target
        if has_pending and target is not None:
            self._flush(target)

    def _flush(self, target: Callable) -> None:
        """Claim the buffer atomically and start one batch/flight worker.

        All buffer handoff happens under the lock: a concurrent ``run()`` /
        ``release()`` pair can race into ``_flush`` freely — exactly one of
        them claims the batch (the other finds the buffer empty or a live
        flight absorbing it), so no job is ever double-flushed or stranded.
        """
        runner = getattr(target, "run_population", None)
        with self._lock:
            sch = self._scheduler
            if sch is not None:
                # a streaming flight is live: drain the buffer into it.  Offers
                # refused by a closing flight stay pending — the flight worker
                # re-flushes after it clears ``_scheduler``.
                self._pending = [j for j in self._pending if not sch.offer(j)]
                return
            batch, self._pending = self._pending, []
            if not batch:
                return
            self.n_batches += 1
            self.batch_sizes.append(len(batch))
            streaming = (
                self.lane_refill
                and not self._streaming_broken
                and runner is not None
                and accepts_kwarg(runner, "scheduler")
            )
            if self.lane_refill and not streaming and not self._warned_no_stream:
                # fall back to batch mode, but never silently: the user asked
                # for streaming and this target cannot do it
                self._warned_no_stream = True
                warnings.warn(
                    "lane_refill is enabled but the target does not accept a "
                    "'scheduler' kwarg on run_population; falling back to "
                    "batch-synchronous flights", stacklevel=2)
            if streaming:
                sch = LaneScheduler(
                    on_stream=self._note_streamed,
                    lifecycle=getattr(target, "lifecycle", None),
                )
                for job in batch:
                    sch.offer(job)
                self._scheduler = sch
                self.n_refill_flights += 1
        if streaming:
            self._start_streaming_worker(runner, target, sch)
        else:
            self._start_batch_worker(runner, target, batch)

    # -- batch-synchronous worker (legacy protocol) ------------------------------
    def _start_batch_worker(self, runner: Optional[Callable], target: Callable,
                            batch: List[Job]) -> None:
        def _worker():
            # anything no longer PENDING was killed/lost while buffered
            live = [j for j in batch if j.status == JobStatus.PENDING]
            if not live:
                return
            for job in live:
                job.mark_running()
            try:
                if runner is not None:
                    outs = self._run_batch(runner, [dict(j.config) for j in live])
                    if len(outs) != len(live):
                        raise ValueError(
                            f"run_population returned {len(outs)} results "
                            f"for {len(live)} configs"
                        )
                else:
                    # scalar fallback: per-job blast radius — one bad config
                    # must not take down its batch siblings
                    outs = []
                    for job in live:
                        try:
                            outs.append(target(dict(job.config)))
                        except Exception as e:
                            outs.append(e)
            except Exception as e:  # the one device program died: whole batch
                for job in live:
                    job.fail(f"{type(e).__name__}: {e}")
                return
            for job, out in zip(live, outs):
                try:
                    if isinstance(out, Exception):
                        job.fail(f"{type(out).__name__}: {out}")
                    else:
                        score, extra = out if isinstance(out, tuple) else (out, None)
                        job.finish(JobResult(score=float(score), extra=extra))
                except Exception as e:  # malformed result fails only its job
                    job.fail(f"{type(e).__name__}: {e}")

        threading.Thread(
            target=_worker, name=f"popbatch-{self.n_batches}", daemon=True
        ).start()

    # -- streaming worker (lane-refill protocol) ---------------------------------
    def _start_streaming_worker(self, runner: Callable, target: Callable,
                                sch: LaneScheduler) -> None:
        def _worker():
            import time as _time

            sup = self.supervisor
            attempt = 0
            err: Optional[Exception] = None
            doomed: List[Job] = []  # reclaimed but not requeued (exhausted)
            while True:
                err = None
                try:
                    self._run_batch(runner, [], scheduler=sch)
                except Exception as e:
                    err = e
                if err is None:
                    break
                # -- flight death: reclaim lanes, quarantine poison jobs,
                # restart with backoff (FlightSupervisor policy) ----------------
                with self._lock:
                    self.n_flight_deaths += 1
                msg = f"{type(err).__name__}: {err}"
                if self.journal is not None:
                    self.journal.append("flight_death", detail=msg)
                survivors: List[Job] = []
                for job in sch.reclaim_live():
                    job.flight_deaths = getattr(job, "flight_deaths", 0) + 1
                    if job.flight_deaths >= sup.poison_deaths:
                        # this lane was live across poison_deaths consecutive
                        # flight deaths: quarantine — fail for good, and flag
                        # the job so the Experiment skips its retry budget
                        job.quarantined = True
                        with self._lock:
                            self.n_quarantined += 1
                        if self.journal is not None:
                            self.journal.append(
                                "quarantine", job_id=job.job_id, detail=msg)
                        job.fail(
                            f"quarantined: lane died in {job.flight_deaths} "
                            f"consecutive flights: {msg}")
                    else:
                        survivors.append(job)
                if attempt >= sup.max_restarts:
                    doomed = survivors
                    break
                attempt += 1
                for job in survivors:
                    sch.requeue(job)
                self._on_flight_death(attempt)
                with self._lock:
                    self.n_flight_restarts += 1
                if self.journal is not None:
                    self.journal.append("flight_restart", step=attempt, detail=msg)
                _time.sleep(sup.delay_s(attempt))
            leftovers, orphans = sch.close()
            orphans = doomed + orphans
            with self._lock:
                self._scheduler = None
                if err is None and sch.n_leased == 0 and leftovers:
                    # the runner took a 'scheduler' kwarg (**kwargs?) but never
                    # leased a job: it cannot actually stream.  Without this
                    # latch the re-flush below would pick streaming again and
                    # livelock on zero-progress flights.
                    self._streaming_broken = True
                if err is None:
                    # offers that landed after the flight's last lease check
                    # seed the next flight instead of being stranded
                    self._pending = leftovers + self._pending
                has_pending = bool(self._pending)
                broken = self._streaming_broken
            if err is not None:
                msg = f"{type(err).__name__}: {err}"
                for job in orphans:
                    job.fail(f"streaming flight died mid-lane: {msg}")
                # never-leased jobs fail too (bounded per-lineage retries in
                # the Experiment), rather than looping a broken engine forever
                for job in leftovers:
                    job.fail(f"streaming flight died before lease: {msg}")
            else:
                for job in orphans:  # engine returned without completing a lease
                    job.fail("streaming flight ended without completing the lane")
                if broken and not self._warned_no_stream:
                    self._warned_no_stream = True
                    warnings.warn(
                        "lane_refill is enabled but the target's run_population "
                        "never leased from the scheduler; falling back to "
                        "batch-synchronous flights", stacklevel=2)
                if has_pending:
                    self._flush(target)

        t = threading.Thread(
            target=_worker, name=f"popflight-{self.n_batches}", daemon=True
        )
        with self._lock:
            self._flight_thread = t
        t.start()

    def _on_flight_death(self, attempt: int) -> None:
        """Subclass hook, called once per supervised restart (before the
        backoff sleep).  The sharded manager uses it to degrade the mesh
        (sharded -> vmapped) when the flight keeps dying."""

    def _note_streamed(self) -> None:
        # live counter: the experiment loop reads it while flights still run
        with self._lock:
            self.n_streamed += 1

    def _run_batch(self, runner: Callable, configs: List[dict],
                   scheduler: Optional[LaneScheduler] = None) -> List[Any]:
        """Execute one buffered batch (or streaming flight).  Subclass hook:
        the sharded manager passes its device mesh through here."""
        if scheduler is not None:
            return runner(configs, scheduler=scheduler)
        return runner(configs)

    def finish(self) -> None:
        """The experiment loop is done: close the live streaming flight now
        instead of letting it linger for its idle grace (and burn a polling
        loop until the grace expires), then join the flight worker so no
        thread is still mid-XLA-call when the caller tears the process down.
        Any jobs the close hands back were settled already — the loop only
        exits with nothing running — but they re-buffer defensively rather
        than being dropped.

        A worker still alive after ``finish_join_timeout_s`` is a *hung*
        flight (deadlocked lease loop, wedged XLA call): its leased jobs are
        failed so their callbacks fire, and a RuntimeError surfaces — a
        silent return here would let the caller tear down the process under
        a thread that still owns device buffers."""
        with self._lock:
            sch = self._scheduler
            worker = self._flight_thread
        orphans: List[Job] = []
        if sch is not None:
            leftovers, orphans = sch.close()
            if leftovers:
                with self._lock:
                    self._pending = leftovers + self._pending
        if worker is not None and worker is not threading.current_thread():
            worker.join(timeout=self.finish_join_timeout_s)
            if worker.is_alive():
                for job in orphans:
                    if not job.done:
                        job.fail(
                            f"streaming flight hung: worker still alive "
                            f"{self.finish_join_timeout_s:.1f}s after close")
                if self.journal is not None:
                    self.journal.append(
                        "flight_hung",
                        detail=f"join timeout {self.finish_join_timeout_s}s")
                raise RuntimeError(
                    f"streaming flight worker {worker.name!r} did not exit "
                    f"within {self.finish_join_timeout_s:.1f}s of close(); "
                    f"{len(orphans)} leased job(s) failed as hung")

    def kill(self, job: Job) -> None:
        # the batch thread cannot be interrupted; mark KILLED so the eventual
        # positional result is dropped (Job.finish fires exactly once)
        job.fail("killed by deadline", status=JobStatus.KILLED)
