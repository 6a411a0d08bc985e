"""HPO driver: the paper's Experiment loop over model-training trials, on the
PyTorch port.

    PYTHONPATH=src python -m repro_torch.launch.hpo --arch starcoder2-3b \\
        --proposer random --n-samples 8 --vectorize 4 --steps 30

Each trial trains the architecture's smoke config (or the config with
``model_overrides`` applied) for ``--steps`` on the deterministic synthetic
stream and reports -final_loss as the score (the models with a frontend,
hubert-xlarge and pixtral-12b, train on tokens too, as the JAX CLI's do:
their frontends are stubs).  Every proposal and result lands
in the tracking DB (``--db``).  Switching HPO algorithms is one flag
(``--proposer``).

**Execution engines**

* default (``--vectorize 0``) — serial: one trial at a time, a population
  of one lane (K=1) through the same train step;
* ``--vectorize K`` — population mode: ``VectorizedResourceManager`` drains
  the proposer in batches of K and each batch trains as one lane-batched
  program (``repro_torch.train.population``) with divergence masking: a NaN
  trial freezes and reports the sentinel score, the batch lives on.  Partial
  batches are padded to K with 0-budget lanes.

With ``--inflight-stop`` and a rung proposer (asha / hyperband / bohb), the
successive-halving rule also runs inside each population flight: at every
rung boundary, losing lanes get their step budget truncated, and the flight
ends as soon as the survivors finish.

Trials read independent per-trial data streams (their ``job_id`` folded into
the synthetic stream) in every engine, so the engines stay score-equivalent
trial for trial; ``--shared-stream`` gives every trial the same stream.

With ``--chunk-steps T`` (and ``--vectorize K``) a flight advances in fused
chunks of up to T steps between host events (rung boundaries, the flight's
end), sized in powers of two (``launch/chunkplan.py``); each step of a chunk
makes its batch on the device from the lanes' stream words and step cursors,
bit-identical to the host batches, so a chunked flight gives the per-step
flight's scores.  On the card a chunk, one of a single step too, is one
replay of a captured CUDA graph, its batches are made by the
``csrc/synth_tokens.cu`` kernel, and a flight holds the state the graphs
captured until its scores are read (a second flight of the same geometry
waits for it).

With ``--lane-refill`` (and ``--vectorize K``) a flight streams: a lane
whose trial retires (budget done, rung-truncated, diverged) reports its
result at once and takes the next proposal in place (``_run_streaming``),
so no lane idles until the slowest trial of a batch ends.  With
``--pbt-streaming`` PBT runs on the same engine: a member keeps its lane
across rounds, and an exploit step copies the donor lane's state on the
device (no host checkpoint).  With ``--device-rules`` the rung rule (or
PBT's window quantile) runs inside the chunk, so a whole ladder can be one
dispatch.  On the card a chunked streaming flight holds its geometry's
captured state from its first init to its return; every lane op writes
into that state and every training dispatch replays a graph.

**Device.**  Trials run on ``cuda`` unless ``--device cpu`` is given; without
a GPU the driver raises rather than fall back.  On the card every RMSNorm,
every attention forward and every Mamba selective scan runs the hand-written
Hopper kernels; on the CPU their plain PyTorch versions.

With ``--snapshot-every N`` (and ``--lane-refill``) a streaming flight is
crash-safe: every N-th event pass copies each live lane's state to the host
(on disk beside ``--db``), a flight that dies restarts under the supervisor
and its leases restore their lanes, and ``--resume`` picks a killed run up
from the tracking DB and the snapshots.  With ``--data-ring`` the chunks
read a prefetch ring on the device, filled from the host a window ahead
(``--ring-windows W``), instead of making their batches on the device.

``--legacy-recompile`` is the serial baseline of the JAX package's
throughput benchmark (``make_trial``): a fresh train step per trial with the
proposal baked into its config, every trial on the same seeded stream.

With ``--shard-population`` (and ``--vectorize K``) the K lanes split into
blocks of K/N over the N ranks of a ``torch.distributed`` group
(``ShardedPopulationResourceManager``): ``torchrun``'s ranks, else one rank
per visible GPU (this process starts them), or a world of one with
``--device cpu``.  Rank 0 runs the Experiment and every host decision; the
other ranks train their blocks of each flight (``launch/flight.py``), and
every score is the unsharded engine's.  NCCL joins CUDA ranks, gloo CPU
ranks::

    torchrun --nproc-per-node 2 -m repro_torch.launch.hpo --device cpu \
        --vectorize 4 --shard-population

With ``--model-parallel W`` as well the mesh is two-level: its N ranks
form N/W lane rows of W ranks, K/(N/W) lanes a row, and each lane is a
width-W tensor-parallel program over its row (attention heads, MLP ``ff``
and Mamba channels split as the width rules say, the all-reduces at the
model's seams); the JSON gains ``model_parallel`` and
``model_axis_collectives`` (the model-group collectives a step issues) and
the engine ``+tp{W}``.

With ``--elastic-regrid`` (and ``--vectorize K --inflight-stop``) a flight
regrids at the rung boundaries where its survivors fit fewer lanes: their
whole state is gathered into a smaller population (``regrid`` lane op), K
shrinks to the next power of two, and the retired lanes' scores are kept.
Under ``--shard-population`` the ranks are leased through an
``ElasticLanePool``: the survivors move onto fewer, wider lane rows of the
same ranks (``plan_regrid``: no row idle), each row a tensor-parallel
program where the width shards a module.  Streaming flights regrid once
the feed is closed and at most half the lanes are live.  A regrid changes
layout, never math: the scores are the fixed-width flight's (bit for bit
without a pool).  The JSON gains ``regrids`` and ``lane_width_history``
(``[lanes, width]`` after each regrid) and the engine ``+elastic``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import threading
import time

import numpy as np
import torch

from .chunkplan import ChunkPlanner, pow2_ceil

_U32 = 0xFFFFFFFF


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless ``cpu`` is asked for; raises when CUDA is asked for
    (or defaulted to) and there is no GPU — never a silent fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: the port runs on 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: --device cpu) "
            "to run the plain PyTorch versions on the CPU")
    return dev


def model_config(arch: str, overrides=None):
    """``arch``'s smoke config with ``overrides`` (``ModelConfig`` fields)
    applied: the model a trial trains."""
    from ..configs import get_smoke_config

    cfg = get_smoke_config(arch)
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def make_trial(arch: str, steps: int, batch: int, seq: int, seed: int, device=None):
    """Legacy trial callable: config dict -> score, with a fresh train step
    per trial.

    Bakes the proposal into the TrainConfig closure (``make_train_step``), as
    the JAX package's baseline does, where every call pays a full compile;
    kept as the ``--legacy-recompile`` baseline.  Every trial reads the
    same seeded stream and starts from the same weights.  Use
    ``PopulationTrial`` for real runs.
    """
    dev = resolve_device(device)

    def trial(config: dict) -> float:
        from ..configs.base import ParallelConfig, TrainConfig
        from ..data.pipeline import HostPrefetcher, SyntheticLM
        from ..train.train_step import init_train_state, make_train_step

        cfg = model_config(arch)
        n_steps = int(config.get("n_iterations", 1) * steps)
        tc = TrainConfig(
            model=cfg,
            parallel=ParallelConfig(remat="none"),
            learning_rate=float(config["learning_rate"]),
            warmup_steps=max(1, int(config.get("warmup_frac", 0.1) * n_steps)),
            total_steps=n_steps,
            weight_decay=float(config.get("weight_decay", 0.1)),
            b2=float(config.get("b2", 0.95)),
            grad_clip=float(config.get("grad_clip", 1.0)),
            seed=seed,
        )
        data = SyntheticLM(cfg.vocab_size, seq, batch, seed=seed)
        state = init_train_state(torch.Generator(device=dev).manual_seed(seed), tc, dev)
        step_fn = make_train_step(tc)
        # batch s+1 is built and sent while step s still runs, before the
        # blocking loss read
        feed = HostPrefetcher(data.make_batch, dev)
        loss = float("inf")
        for s in range(n_steps):
            state, metrics = step_fn(state, feed.pop(s))
            if s + 1 < n_steps:
                feed.prefetch(s + 1)
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                return -1e9  # diverged
        return -loss

    return trial


class PopulationTrial:
    """Trial executor for one architecture.

    ``__call__(config)`` is the scalar protocol (local/subprocess managers);
    ``run_population(configs)`` is the batch protocol the vectorized manager
    uses — K trials advance in one lane-batched program.  Either way the
    proposal's hyperparameters ride as per-lane tensors.

    ``per_trial_streams`` (default on) gives each trial its own data stream
    id — the ``stream`` config key, else its ``job_id``, else its lane
    position — in the scalar and batch protocols alike.

    ``early_stop`` may hold an in-flight hook (see
    ``repro_torch.core.proposer.early_stop``): at the hook's rung boundaries,
    losing lanes get their step budget truncated.

    ``per_trial_init`` folds each trial's stream id into its init seed, so
    every trial starts from its own weights; by default every trial starts
    from the weights of ``seed``.

    ``device`` is ``cuda`` unless ``cpu`` is asked for (see
    ``resolve_device``).  On the card the kernels always run: there is no
    ``fused_*`` switch.

    ``chunk_steps`` > 1 runs the population flights in fused chunks (see the
    module docstring); ``n_dispatches`` then counts chunks and lane ops.
    ``device_rules`` runs the rung rule (or PBT's window quantile) inside
    the chunks.  ``record_flight``, if set, is called at each flight's end
    with its per-step losses (``(steps, K)`` on the device) and its final
    population state; the losses are kept only then.  ``record_lane_op``,
    if set, is called after each lane op of a streaming flight as
    ``(op, pstate, lanes, donors)``.

    ``run_population(configs=[], scheduler=...)`` is the streaming (lane
    refill) protocol: jobs arrive through ``scheduler.lease()`` and leave
    through ``scheduler.complete()`` (see ``_run_streaming``).  ``lifecycle``
    is streaming PBT's lane-lifecycle hook, wired by the Experiment.

    ``snapshot_every`` > 0 with a ``snapshots`` store
    (``checkpoint.LaneSnapshotStore``) makes streaming flights crash-safe:
    every ``snapshot_every``-th event pass copies each live lane's state to
    the store, and a lease whose stream has a snapshot restores it and
    trains on from its step (a store alone, as ``--resume`` arms it, only
    restores).  ``data_ring`` feeds chunked flights from a prefetch ring of
    ``ring_windows`` chunk-windows filled on a host thread from
    ``host_dataset`` (default: the synthetic stream's host adapter).

    ``elastic_regrid`` (or an ``elastic`` pool handed to
    ``run_population``) makes flights regrid their rung survivors onto
    fewer lanes; ``n_regrids``, ``lane_width_history`` and, per rank,
    ``regrid_log`` (lanes, width, bytes received, seconds, the graphs of
    the geometry left and, on rank 0, the step of each regrid) record them.
    """

    DIVERGED_SCORE = -1e9

    def __init__(self, arch: str, steps: int, batch: int, seq: int, seed: int,
                 population: int = 0, per_trial_streams: bool = True,
                 early_stop=None, per_trial_init: bool = False,
                 model_overrides=None, device=None, chunk_steps: int = 1,
                 device_rules: bool = False, refill_idle_grace_s: float = 0.25,
                 lifecycle=None, snapshot_every: int = 0, snapshots=None,
                 data_ring: bool = False, ring_windows: int = 2,
                 elastic_regrid: bool = False):
        self.device = resolve_device(device)
        self.arch = arch
        self.steps = int(steps)
        self.batch = int(batch)
        self.seq = int(seq)
        self.seed = int(seed)
        self.population = int(population)  # >0: pad batches to this fixed K
        self.per_trial_streams = bool(per_trial_streams)
        self.per_trial_init = bool(per_trial_init)
        self.early_stop = early_stop
        self.model_overrides = dict(model_overrides or {})
        self.chunk_steps = max(1, int(chunk_steps))
        self.device_rules = bool(device_rules)
        self.record_flight = None   # callable(losses, pstate) at each flight's end
        self.record_lane_op = None  # callable(op, pstate, lanes, donors) after a lane op
        # a list: each training dispatch timed alone, (lanes, steps, seconds)
        self.dispatch_times = None
        # [[boundary_step, steps, s_per_step], ...] between rung boundaries
        self.per_rung_step_time_s: list = []
        self.model_axis_collectives = 0   # model-group collectives a step (two-level mesh)
        self.n_dispatches = 0       # device calls issued (steps, chunks, lane ops)
        self.n_train_steps = 0      # population steps those calls advanced
        self.n_lane_steps = 0       # lane-steps computed: K a population step
        self.n_active_lane_steps = 0  # of those, lane-steps that applied an update
        self.last_flight_steps = 0
        # streaming engines: PBT's lane-lifecycle hook (wired by the Experiment),
        # the flight journal, and how long an empty flight waits for proposals
        self.lifecycle = lifecycle
        self.journal = None
        self.refill_idle_grace_s = float(refill_idle_grace_s)
        # device dispatches from a streaming flight's start to its first
        # retirement: 1 when a device-rule ladder fits one chunk
        self.ladder_dispatches = None
        self.n_refills = 0          # lanes reused within a streaming flight
        self.n_clones = 0           # donor-clone lane ops
        self.n_splices = 0          # single-lane re-inits
        self.n_donor_waits = 0      # leases parked on a busy donor lane
        self.n_lineage_resets = 0   # keep/clone degraded to a fresh init
        self.n_host_ckpt_roundtrips = 0  # train states through the host (serial PBT)
        # crash-safe streaming: every snapshot_every-th event pass harvests
        # each live lane's state to the snapshot store (0 = off); a lease
        # whose stream has a stored snapshot restores it instead of starting
        # at step 0 (after a supervised restart or a --resume)
        self.snapshot_every = max(0, int(snapshot_every))
        self.snapshots = snapshots      # checkpoint.LaneSnapshotStore
        self.n_snapshots = 0            # lane snapshots harvested to the host
        self.n_lane_restores = 0        # leases resumed from a snapshot
        self.resumed_from_steps: list = []  # lane-local step of each restore
        # --data-ring: chunks read a prefetch ring filled from the host
        # (data.ring) instead of making their batches on the device; the
        # default fill, the synthetic stream's host adapter, gives in-chunk
        # synthesis's scores bit for bit
        self.data_ring = bool(data_ring)
        self.ring_windows = max(2, int(ring_windows))
        self.host_dataset = None        # a HostDataset (default: the synthetic stream)
        self.ring_fill_wait_s = 0.0     # the driver's wait on the host fill
        self.ring_fill_busy_s = 0.0     # the host's time producing windows
        self.ring_overlap_frac = 1.0    # share of the fill hidden behind the chunks
        self.n_ring_fills = 0
        self.n_ring_invalidations = 0
        # --elastic-regrid: flights regrid their survivors onto fewer lanes
        # (with a pool, onto wider lane rows) at rung boundaries
        self.elastic_regrid = bool(elastic_regrid)
        self.n_regrids = 0
        self.lane_width_history: list = []   # [lanes, width] after each regrid
        self.regrid_log: list = []   # this rank's regrids: lanes, bytes, seconds
        self._flight_epoch = 0
        self._event_seq = 0         # streaming event passes, all flights
        self._hist_cap = 0          # staggered rule history capacity (power of two)
        self._tc = None
        self._data = None
        self._serial_seq = 0  # fallback stream counter for anonymous configs
        self._setup_lock = threading.Lock()
        # an unknown arch or override is refused here, in the caller's
        # thread, not by every trial in the resource manager's workers
        model_config(arch, self.model_overrides)

    # locked because local resource managers call trials from worker threads
    def _setup(self):
        with self._setup_lock:
            if self._tc is None:
                from ..configs.base import ParallelConfig, TrainConfig
                from ..data.pipeline import SyntheticLM

                cfg = model_config(self.arch, self.model_overrides)   # checked at init
                self._data = SyntheticLM(cfg.vocab_size, self.seq, self.batch,
                                         seed=self.seed)
                self._tc = TrainConfig(model=cfg, parallel=ParallelConfig(remat="none"),
                                       seed=self.seed)
            return self._tc, self._data

    def _hparams(self, config: dict, n_steps: int):
        from ..optim.hparams import hparams_from_dict

        tc, _ = self._setup()
        return hparams_from_dict(dict(config, total_steps=n_steps), tc)

    def _n_steps(self, config: dict) -> int:
        return int(config.get("n_iterations", 1) * self.steps)

    def _stream_of(self, config: dict, fallback: int) -> int:
        """Per-trial data stream id: explicit ``stream`` key, else the job id,
        else ``fallback`` (lane position / serial call order)."""
        if not self.per_trial_streams:
            return 0
        return int(config.get("stream", config.get("job_id", fallback)))

    def _serial_stream_of(self, config: dict) -> int:
        """Stream id for a serial call: anonymous configs (no ``stream``, no
        ``job_id``) get distinct streams by call order."""
        if not self.per_trial_streams:
            return 0
        if "stream" in config or "job_id" in config:
            return self._stream_of(config, 0)
        with self._setup_lock:
            sid = self._serial_seq
            self._serial_seq += 1
        return sid

    def _generator(self, stream: int) -> torch.Generator:
        """Init generator for a trial: seeded with ``seed``, or — with
        ``per_trial_init`` — with the trial's stream id folded in."""
        seed = self.seed & _U32
        if self.per_trial_init:
            seed = (seed << 32) | (int(stream) & _U32)
        return torch.Generator(device=self.device).manual_seed(seed)

    @property
    def active_lane_share(self):
        """Lane-steps that applied an update over lane-steps computed, over
        every population flight so far (None before the first)."""
        if not self.n_lane_steps:
            return None
        return self.n_active_lane_steps / self.n_lane_steps

    def _count_active(self, acc, metrics, k: int, t: int):
        """Add a dispatch's applied lane-steps to the flight's device-side
        count (no host sync) and its computed lane-steps to the trial's."""
        self.n_lane_steps += k * t
        acc.add_(metrics["applied"].sum())

    def _batch(self, data, step: int, streams):
        if self.per_trial_streams:
            return data.make_population_batch(step, streams)
        return data.make_batch(step)

    def __call__(self, config: dict) -> float:
        """Serial protocol."""
        return self.serial_score_at(config, None)

    def serial_score_at(self, config: dict, steps=None) -> float:
        """Serial score after ``steps`` applied steps (default: the config's
        full budget); the LR schedule spans the config's own total budget, so
        ``steps < budget`` reproduces what a rung-truncated population lane
        reports.  The serial engine is the population step at K=1."""
        from ..data.pipeline import HostPrefetcher
        from ..interop import add_lane_axis
        from ..optim.hparams import stack_hparams
        from ..train import train_step as ts

        tc, data = self._setup()
        n_steps = self._n_steps(config)
        run_steps = n_steps if steps is None else min(int(steps), n_steps)
        stream = self._serial_stream_of(config)
        hp = stack_hparams([self._hparams(config, n_steps)], self.device)
        step_fn = ts.make_hparam_train_step(tc)
        state = add_lane_axis(ts.init_train_state(self._generator(stream), tc, self.device))

        def build(t):
            b = data.make_batch(t, stream=stream)
            return {k: v[None] for k, v in b.items()}

        feed = HostPrefetcher(build, self.device)
        loss = float("inf")
        for s in range(run_steps):
            state, metrics = step_fn(state, feed.pop(s), hp)
            if s + 1 < run_steps:
                feed.prefetch(s + 1)
            loss = float(metrics["loss"][0])
            if not np.isfinite(loss):
                return self.DIVERGED_SCORE
        return -loss

    def run_population(self, configs, mesh=None, scheduler=None, elastic=None) -> list:
        """Batch protocol: K trials in one lane-batched program.  Partial
        batches are padded to the fixed population size with 0-budget lanes
        (they freeze at once) reading distinct negative sentinel streams.
        With ``chunk_steps`` > 1 the flight advances in fused chunks whose
        boundaries land on the rung boundaries, so the rung rule sees exactly
        the state the per-step loop would at the same step; with
        ``device_rules`` the rung rule runs inside the chunks instead.  On the
        card a chunked flight holds its geometry's captured state for the
        whole flight.

        With ``mesh`` (a ``distributed.sharding.PopulationMesh``) the K
        lanes split into blocks of K/N over its ranks (K padded to a
        multiple of N): rank 0 drives the flight and the other ranks apply
        its operations to their blocks (``launch.flight``).  Every rank
        calls this with the same arguments and gets the same global list;
        rank 0's host decisions and scores are the unsharded engine's.

        With ``scheduler`` the call is the streaming protocol instead
        (``configs`` must be empty; see ``_run_streaming``).

        ``elastic`` (an ``ElasticLanePool``, on rank 0; ``mesh`` defaults to
        its mesh) regrids the flight's rung survivors onto the pool's lane
        rows (see ``_regrid_at``); ``elastic_regrid`` without a pool shrinks
        K to the next power of two."""
        from ..train.population import pad_population
        from .flight import LaneFlight, serve

        if mesh is None and elastic is not None:
            mesh = elastic.base
        if mesh is not None and mesh.rank != 0:
            return serve(self, mesh, flights=1)
        elastic_on = self.elastic_regrid or elastic is not None
        if elastic_on and self.device_rules:
            raise ValueError("--elastic-regrid and --device-rules are mutually exclusive: "
                             "in-chunk rule state is K-shaped, a regrid changes K mid-flight")
        if scheduler is not None:
            if configs:
                raise ValueError(
                    "streaming mode: seed proposals through the scheduler, not configs")
            return self._run_streaming(scheduler, mesh, elastic)
        budgets = np.array([float(self._n_steps(c)) for c in configs])
        streams = [self._stream_of(c, i) for i, c in enumerate(configs)]
        hps = [self._hparams(c, int(n)) for c, n in zip(configs, budgets)]
        k = pad_population(max(self.population, len(hps)), mesh)
        while len(hps) < k:
            hps.append(self._hparams({}, 0))
        streams += [-(i + 1) for i in range(len(streams), k)]
        budgets = np.concatenate([budgets, np.zeros(k - len(budgets))])
        spec = self._device_rule_spec()
        # the ring's lane axis is K-shaped, so an elastic flight has none
        ring_on = self.data_ring and self.chunk_steps > 1 and spec is None and not elastic_on
        if ring_on and not self.per_trial_streams:
            raise ValueError("--data-ring fills per-lane slabs; drop --shared-stream")
        with LaneFlight.open(self, k, mesh, graphed=self._graphed(spec is not None),
                             ptb=self.per_trial_streams, ring_on=ring_on,
                             width=None if elastic is None else elastic.width) as fl:
            fl.init_state(streams, per_lane=self.per_trial_init)
            fl.set_hp(hps)
            fl.set_streams(streams)
            if spec is not None:
                scores = self._flight_device_rules(fl, budgets, spec)
            else:
                scores = self._flight(fl, budgets, streams, hps, elastic_on, elastic)
            fl.result = [float(x) for x in scores[: len(configs)]]
        return fl.result

    def _device_rule_spec(self):
        """The rung rule lowered for the chunks (``device_rules`` with a rung
        hook), else None."""
        hook = self.early_stop
        if self.device_rules and hook is not None and hook.boundaries:
            return hook.device_rule()
        return None

    def _graphed(self, device_rule: bool) -> bool:
        """Whether a flight's training dispatches are chunk programs: on the
        card, graph replays on the geometry's captured state."""
        return self.device.type == "cuda" and (self.chunk_steps > 1 or device_rule)

    def _absorb_ring(self, ring) -> None:
        """Stop a flight's ring and add its telemetry to the trial's."""
        ring.stop()
        self.ring_fill_wait_s += ring.fill_wait_s
        self.ring_fill_busy_s += ring.fill_busy_s
        self.n_ring_fills += ring.n_fills
        self.n_ring_invalidations += ring.n_invalidations
        if self.ring_fill_busy_s > 0.0:
            self.ring_overlap_frac = max(0.0, min(
                1.0, 1.0 - self.ring_fill_wait_s / self.ring_fill_busy_s))

    def _finish_flight(self, fl, acc, losses, s: int) -> np.ndarray:
        """A flight's end: its scores (numpy (K,)), its counters, and the
        ``record_flight`` hook with this rank's state."""
        self.last_flight_steps = s
        scores = fl.scores(self.DIVERGED_SCORE)
        self.n_active_lane_steps += int(acc)
        if losses is not None:
            self.record_flight(torch.cat(losses) if losses else None, fl.state)
        return scores

    def _flight(self, fl, budgets, streams, hps, elastic_on=False, pool=None):
        """One batch flight from its first step to its scores (numpy (K,));
        with ``elastic_on`` it regrids at rung boundaries (``_regrid_at``),
        and its scores are still those of the K lanes it started with."""
        k = fl.k
        k0 = k
        # lane -> the lane of the flight's start it trains (-1: a pad), and
        # the scores of the lanes a regrid retired
        orig = list(range(k))
        final = np.full(k0, self.DIVERGED_SCORE, np.float64)
        chunk = self.chunk_steps
        ring = fl.ring is not None
        hook = self.early_stop
        planner = ChunkPlanner(chunk_steps=chunk,
                               boundaries=hook.boundaries if hook is not None else ())
        losses = [] if self.record_flight is not None else None
        acc = torch.zeros((), dtype=torch.int64, device=fl.dev)
        s = 0
        seg_t0, seg_s0 = time.perf_counter(), 0
        if ring:
            # every lane's data cursor is the global step in a batch flight:
            # offsets 0, and the lanes never re-key
            fl.ring_lanes(streams, [0] * k, 0)
        while s < int(budgets.max()):
            max_b = int(budgets.max())
            t = planner.chunk_to(s, planner.next_cohort_event(s, max_b))
            if ring:
                metrics = fl.ring_chunk(s, t)
            elif chunk > 1:
                # every dispatch of a chunked flight, one step too, is a chunk
                # program: on the card a graph replay in the pool
                metrics = fl.chunk(t, s)
            else:
                metrics = fl.step_at(s, s + 1 if s + 1 < max_b else None)
            self._count_active(acc, metrics, k, t)
            if losses is not None:
                # cloned: a graph's metrics are overwritten by its next replay
                losses.append(self._start_lanes(metrics["loss"].detach().reshape(-1, k),
                                                orig, k0))
            self.n_dispatches += 1
            self.n_train_steps += t
            s += t
            if hook is not None and s in hook.boundaries:
                last, diverged, _ = fl.lanes()
                new_budgets = hook(s, last, budgets, diverged)
                # the lane read above synced the device, so this segment's
                # wall-clock is honest
                self.per_rung_step_time_s.append(
                    [int(s), int(s - seg_s0),
                     round((time.perf_counter() - seg_t0) / max(1, s - seg_s0), 6)])
                seg_t0, seg_s0 = time.perf_counter(), s
                if (new_budgets != budgets).any():
                    # truncating a lane's budget freezes it on the next
                    # step; written in place, as a captured graph reads it
                    budgets = new_budgets
                    fl.set_budgets(budgets)
                if elastic_on:
                    got = self._regrid_at(fl, s, budgets, streams, hps, orig, final, pool)
                    if got is not None:
                        budgets, streams, hps, orig = got
                        k = fl.k
                        # the regrid's seconds are its own (regrid_log), not the
                        # next segment's
                        seg_t0 = time.perf_counter()
        scores = self._finish_flight(fl, acc, losses, s)
        if s > seg_s0:  # the tail past the last rung boundary (scores synced)
            self.per_rung_step_time_s.append(
                [int(s), int(s - seg_s0),
                 round((time.perf_counter() - seg_t0) / (s - seg_s0), 6)])
        if not elastic_on:
            return scores
        for j, o in enumerate(orig):
            if o >= 0:
                final[o] = scores[j]
        return final

    @staticmethod
    def _start_lanes(loss, orig, k0):
        """A dispatch's ``(steps, K)`` losses in the columns of the lanes the
        flight started with (NaN where no lane trains that one any more)."""
        if loss.shape[1] == k0 and orig == list(range(k0)):
            return loss.clone()
        out = torch.full((loss.shape[0], k0), float("nan"), dtype=loss.dtype,
                         device=loss.device)
        cols = [j for j, o in enumerate(orig) if o >= 0]
        out[:, [orig[j] for j in cols]] = loss[:, cols]
        return out

    def _regrid_target(self, fl, n_survivors: int, pool):
        """``(lanes, width)`` after a regrid of ``n_survivors`` live lanes,
        or None when it would not shrink the flight: with a pool its plan
        (``plan_regrid``: fewer lanes or wider rows), without one the next
        power of two (padded to the mesh's rows; the width stays)."""
        from ..train.population import pad_population

        k = fl.k
        if pool is not None:
            _, width, k2 = pool.plan(n_survivors)
            return (k2, width) if k2 != k or width != pool.width else None
        k2 = pad_population(pow2_ceil(n_survivors), fl.mesh)
        return (k2, None) if k2 < k else None

    def _regrid_at(self, fl, s, budgets, streams, hps, orig, final, pool):
        """The regrid step of an elastic batch flight at rung boundary
        ``s``: where the survivors (lanes whose budget runs past ``s``, in
        lane order) fit fewer lanes, harvest the retired lanes' scores into
        ``final``, re-lease the pool, gather the survivors (padded with 0-step
        copies of the first, reading sentinel streams ``-(K0 + j + 1)``)
        and restack their budgets, streams and hyperparameters.  Returns the
        new ``(budgets, streams, hps, orig)``, or None without a regrid."""
        k = fl.k
        survivors = [i for i in range(k) if budgets[i] > s]
        if not 0 < len(survivors) < k:
            return None
        plan = self._regrid_target(fl, len(survivors), pool)
        if plan is None:
            return None
        k2, width = plan
        # the retired lanes' budgets froze them: their scores are final
        cur = fl.scores(self.DIVERGED_SCORE)
        live = set(survivors)
        for i in range(k):
            if i not in live and orig[i] >= 0:
                final[orig[i]] = cur[i]
        if pool is not None:
            pool.regrid(len(survivors))
        fl.regrid(survivors, k2, width)
        self.regrid_log[-1]["step"] = int(s)
        pad = k2 - len(survivors)
        budgets = np.array([budgets[i] for i in survivors] + [0.0] * pad)
        streams = [streams[i] for i in survivors] + [-(fl.k0 + j + 1) for j in range(pad)]
        hps = [hps[i] for i in survivors] + [self._hparams({}, 0) for _ in range(pad)]
        orig = [orig[i] for i in survivors] + [-1] * pad
        fl.set_hp(hps)
        fl.set_budgets(budgets)
        fl.set_streams(streams)
        self.n_dispatches += 1
        self.n_regrids += 1
        self.lane_width_history.append([int(k2), 1 if fl.mesh is None else int(fl.mesh.width)])
        return budgets, streams, hps, orig

    def _flight_device_rules(self, fl, budgets, spec):
        """A batch flight with the cohort rung rule carried in the chunks
        (``device_rules``): chunks no longer stop at rung boundaries, and no
        budget goes back to the device between them, so a ladder whose
        largest budget fits one chunk is one dispatch.  Only the budgets
        come back per dispatch (to bound the loop); the hook's counters are
        rebuilt from the budget change at the end."""
        from ..train.population import cohort_rule_state

        k = fl.k
        planner = ChunkPlanner(chunk_steps=self.chunk_steps)   # boundaries ride in-chunk
        init_budgets = budgets.copy()
        losses = [] if self.record_flight is not None else None
        acc = torch.zeros((), dtype=torch.int64, device=fl.dev)
        s = 0
        while s < int(budgets.max()):
            t = planner.chunk_to(s, int(budgets.max()))
            rules = cohort_rule_state(budgets, np.zeros(k), np.full(k, s), spec.boundaries,
                                      spec.eta)
            rout, metrics = fl.rule_chunk(t, "cohort", rules, s)
            self._count_active(acc, metrics, k, t)
            if losses is not None:
                losses.append(metrics["loss"].detach().reshape(-1, k).clone())
            budgets = rout["budgets"].cpu().numpy().astype(np.float64)
            self.n_dispatches += 1
            self.n_train_steps += t
            s += t
        _, diverged, _ = fl.lanes()
        spec.absorb_cuts(init_budgets, budgets, diverged)
        return self._finish_flight(fl, acc, losses, s)

    # -- the streaming protocol ---------------------------------------------------
    def _run_streaming(self, scheduler, mesh=None, elastic=None) -> list:
        """A lane-refill flight: Algorithm 1's busy-resource rule inside one
        population.

        A lane **leases** a job from the scheduler, takes that trial's
        weights through a lane op, trains on its own data stream, and
        **retires** when its budget runs out, the rung rule truncates it, or
        it diverges.  Retiring streams the job's result out at once
        (``scheduler.complete``) and frees the lane for the next lease, so a
        losing lane hands its device time to a fresh proposal mid-flight.

        The lane op of a lease (never a host round trip of the weights):

        * default: **splice** (one lane's fresh init written into the lane),
          or one masked **init** when several lanes fill in one pass;
        * ``pbt_lifecycle == "keep"``: none; the member's lane keeps its
          weights and optimizer state, and only its hyperparameters, budget
          and data cursor move to the next round;
        * ``pbt_lifecycle == "clone"``: **clone** the donor member's lane
          (weights and optimizer state).  A clone whose donor is mid-round
          is parked until the donor retires, and the donor's next round
          waits for the clone (donor pinning), so the copy reads the donor's
          round-boundary state.

        A keep/clone lane's optimizer step counter runs on across rounds,
        so its ``total_steps`` is the steps already in the state plus this
        round's budget, and its data cursor continues the member's stream at
        ``round * round_steps``.

        The scheduler needs ``lease() -> (handle, config) | None``,
        ``complete(handle, score, extra)`` and, optionally, ``closed`` (True:
        no more jobs are coming, so an empty flight returns without waiting
        for its idle grace) and ``complete_retirements`` (device rules: one
        batch of results a dispatch).  ``core.resource.vectorized.LaneScheduler``
        is Algorithm 1's; ``QueueFeedScheduler`` a fixed queue.

        With ``mesh`` the lanes split over its ranks as in the batch
        protocol: the lane table, the leases and every decision stay on rank
        0, and each lane op runs on the rank that owns the lane (a clone
        whose donor lives on another rank has the donor lane sent over).

        On the card a flight whose dispatches are chunk programs holds the
        geometry's captured state (``flight_lease``) from its first init to
        its return: every lane op writes into that state, and every training
        dispatch replays a graph.

        An elastic flight (``elastic_regrid``, or the pool ``elastic``)
        regrids its tail: once the feed is closed, nothing is parked and at
        most half the lanes are live, the live lanes (in lane order) move
        into a smaller population, with a pool onto its wider lane rows, and
        the lane table is restacked."""
        from .flight import LaneFlight

        if not self.per_trial_streams:
            raise ValueError(
                "lane refill requires per-trial data streams: a refilled lane "
                "must replay its own stream from its own step 0 (drop "
                "--shared-stream)")
        elastic_on = self.elastic_regrid or elastic is not None
        if elastic_on and self.lifecycle is not None:
            raise ValueError("--elastic-regrid is incompatible with streaming PBT: keep/clone "
                             "directives pin members to lanes a regrid reindexes")
        # the flight starts on the pool's current width: its rows are the
        # ranks over that width (its mesh is made inside the flight's open)
        rows = 1 if mesh is None else (
            mesh.rows if elastic is None else mesh.world_size // elastic.width)
        k = -(-max(self.population, 1) // rows) * rows
        spec = self._device_rule_spec()
        device_pbt = bool(self.device_rules and self.lifecycle is not None
                          and getattr(self.lifecycle, "device_rule_on", False))
        # a ring feeds the training chunks; a rule chunk makes its own batches
        ring_on = (self.data_ring and self.chunk_steps > 1
                   and not (spec is not None or device_pbt or elastic_on))
        with LaneFlight.open(self, k, mesh, graphed=self._graphed(spec is not None or device_pbt),
                             ptb=True, ring_on=ring_on,
                             width=None if elastic is None else elastic.width) as fl:
            fl.result = self._stream(fl, scheduler, spec, device_pbt, elastic_on, elastic)
        return fl.result

    def _stream(self, fl, scheduler, device_spec, device_pbt, elastic_on=False,
                pool=None) -> list:
        """The body of ``_run_streaming`` on the flight ``fl``
        (``launch.flight.LaneFlight``)."""
        from ..core import faultinject
        from ..train.population import pbt_rule_state, release_lane_snapshot, staggered_rule_state

        k = fl.k
        ring = fl.ring
        chunk = self.chunk_steps
        hook = self.early_stop
        lifecycle = self.lifecycle
        # device rules: the rung rule (staggered) or PBT's window quantile
        # runs in the chunks; the host skips observe(), stops only at the poll
        # or the flight's end, and harvests retirements from the emitted rules
        device_active = device_spec is not None or device_pbt
        batch_complete = (getattr(scheduler, "complete_retirements", None)
                          if device_active else None)
        fault_plan = faultinject.get_plan()
        # crash safety: harvest a live lane to the host, restore a harvested
        # one into a lane of this flight
        snapshots = self.snapshots
        self._flight_epoch += 1
        epoch = self._flight_epoch
        dispatches0 = self.n_dispatches

        # the host's lane table (lane-local: budgets and steps restart per
        # lease; lineage lanes carry cumulative bases across rounds)
        handles: list = [None] * k
        used = [False] * k
        lineage: list = [None] * k           # member whose weights live here
        lane_round = [0] * k                 # pbt_round of the current lease
        rounds_done: dict = {}               # member -> rounds completed here
        starts = np.zeros(k, np.int64)       # global step of the lane's local 0
        base_data = np.zeros(k, np.int64)    # member data cursor at local 0
        applied0 = np.zeros(k, np.int64)     # optimizer step at lease time
        lane_applied = np.zeros(k, np.int64)  # optimizer step at last retire
        budgets = np.zeros(k, np.float64)    # this round's budget (lane-local)
        resumed_at = np.zeros(k, np.int64)   # lane-local step a restore resumed from
        streams = [-(i + 1) for i in range(k)]     # idle = sentinel stream
        hps = [self._hparams({}, 0) for _ in range(k)]
        k0, cols = k, list(range(k))   # lane -> the flight's first lane (a regrid moves it)
        fl.init_state(streams, per_lane=True)
        fl.set_hp(hps)
        fl.set_streams(streams)
        # device rules only: while True the state is still its initial one,
        # so the first fill needs no counted dispatch and a whole ladder can
        # be one
        virgin = True
        s = 0
        idle_deadline = None
        grace = self.refill_idle_grace_s
        if lifecycle is not None:
            # a lifecycle flight must outlive the proposer's round trip between
            # rounds: losing it loses every member's state
            grace = max(grace, 2.0)
        parked: list = []   # leases that cannot run yet (busy donor / no lane)
        donor_waited: set = set()
        force_parked = False  # the grace ran out: stuck directives degrade to init
        planner = ChunkPlanner(chunk_steps=chunk,
                               boundaries=hook.boundaries if hook is not None else ())
        next_event = 0
        acc = torch.zeros((), dtype=torch.int64, device=fl.dev)
        losses = [] if self.record_flight is not None else None

        def note_op(op, lanes, donors=None):
            if self.record_lane_op is not None:
                self.record_lane_op(op, fl.state, list(lanes), donors)

        def next_event_step() -> int:
            live_now = [i for i in range(k) if handles[i] is not None]
            if device_active:
                # rung cuts and budget ends happen in the chunks: the host
                # stops only for the poll or the whole flight's end
                return planner.device_horizon(s, starts, budgets, live_now)
            return planner.next_stream_event(s, starts, budgets, live_now)

        while True:
            live = [i for i in range(k) if handles[i] is not None]
            php_dirty = False
            if fault_plan is not None and live:
                # raise@step kills the flight (the supervisor restarts it);
                # nan@lane sets the divergence latch, and the retire path
                # takes over
                fault_plan.check("flight-step", step=s)
                poison = [i for i in fault_plan.poison_lanes(s) if i < k]
                if poison:
                    fl.poison(poison)
                    virgin = False
            # 1) at an event step: the rung rule, then retire the lanes whose
            # budget is spent (truncated ones too) or that diverged
            if live and s >= next_event:
                self._event_seq += 1
                # the optimizer's step counter is the exact count of applied
                # steps: a diverged lane froze there, however late it is seen
                last, diverged, applied = fl.lanes()
                if snapshots is not None and self.snapshot_every \
                        and self._event_seq % self.snapshot_every == 0:
                    # before the retirements and leases below, so the store
                    # and the journal describe this boundary; diverged lanes
                    # (nothing to resume) and lineage (PBT) lanes (their state
                    # is the proposer's: a dead flight re-inits them) are
                    # skipped, as are lanes at their step 0 or budget's end
                    for lane in live:
                        local = int(s - starts[lane])
                        if (diverged[lane] or lineage[lane] is not None
                                or local <= 0 or local >= budgets[lane]):
                            continue
                        snap = fl.snapshot(lane)
                        self.n_dispatches += 1
                        self.n_snapshots += 1
                        release_lane_snapshot(snapshots.put(streams[lane], snap, {
                            "local": local,
                            "stream": int(streams[lane]),
                            "applied": int(applied[lane]),
                            "applied0": int(applied0[lane]),
                            "budget": float(budgets[lane]),
                            # the lane's data cursor at this boundary: a
                            # restored lease re-derives base_data from it, so
                            # a ring-fed flight resumes the stream mid-window
                            "data_cursor": int(base_data[lane] + local),
                        }))
                        if self.journal is not None:
                            self.journal.append("snapshot", lane=lane, step=local,
                                                detail={"stream": int(streams[lane])})
                if fault_plan is not None:
                    # kill@event fires after any due harvest: a crash at an
                    # event boundary finds its snapshots stored
                    fault_plan.check("event", event=self._event_seq)
                if hook is not None and device_spec is None:
                    local = np.array([s - starts[i] if handles[i] is not None else 0
                                      for i in range(k)], np.float64)
                    budgets = np.asarray(hook.observe(local, last, budgets, diverged),
                                         np.float64)
                retired: list = []  # device rules: one batch an event pass
                for lane in live:
                    local_s = int(s - starts[lane])
                    if not (diverged[lane] or local_s >= budgets[lane]):
                        continue
                    bad = bool(diverged[lane]) or not np.isfinite(last[lane])
                    score = self.DIVERGED_SCORE if bad else -float(last[lane])
                    if (hook is not None and diverged[lane]
                            and budgets[lane] > applied[lane] - applied0[lane]):
                        # a diverged lane's remaining budget is reclaimed
                        hook.n_reclaimed += 1
                    extra = {
                        "steps": int(applied[lane] - applied0[lane]),
                        "total_steps": int(applied[lane]),
                        "diverged": bool(diverged[lane]),
                        "lane": lane,
                        "resumed_from_step": int(resumed_at[lane]),
                    }
                    if device_active:
                        # the step this lane retired at inside the chunk
                        at = (starts[lane] + applied[lane] - applied0[lane] if diverged[lane]
                              else starts[lane] + budgets[lane])
                        retired.append((int(at), lane, handles[lane], score, extra))
                    else:
                        scheduler.complete(handles[lane], score, extra=extra)
                    if self.journal is not None:
                        self.journal.append("retire", lane=lane, step=local_s,
                                            detail={"stream": int(streams[lane]),
                                                    "score": score})
                    if snapshots is not None and lineage[lane] is None:
                        # the trial is done: its snapshots are dead weight
                        release_lane_snapshot(snapshots.forget(streams[lane]))
                    resumed_at[lane] = 0
                    handles[lane] = None
                    budgets[lane] = 0.0
                    lane_applied[lane] = int(applied[lane])
                    if lineage[lane] is not None:
                        # a lineage lane freezes without a restack: its step
                        # counter equals its total_steps (or the latch holds it)
                        # until the next directive
                        rounds_done[lineage[lane]] = lane_round[lane] + 1
                    else:
                        streams[lane] = -(lane + 1)
                        hps[lane] = self._hparams({}, 0)
                        php_dirty = True  # restack: the retired lane freezes
                if retired:
                    # the chunk's retirements, settled in the order the host
                    # rule would have settled them (by the step each lane
                    # retired at, then by lane), in one call where the
                    # scheduler takes a batch
                    retired.sort(key=lambda r: r[:2])
                    if batch_complete is not None:
                        batch_complete([r[2:] for r in retired])
                    else:
                        for _, _, handle, score, extra in retired:
                            scheduler.complete(handle, score, extra=extra)
                if self.ladder_dispatches is None and any(handles[i] is None for i in live):
                    self.ladder_dispatches = self.n_dispatches - dispatches0
                live = [i for i in range(k) if handles[i] is not None]
            # 2) lease pending proposals (parked ones first), each through its
            # lane op
            pending, parked = parked + self._drain_leases(scheduler), []
            if pending:
                # clones first: a clone reads its donor's round-boundary state,
                # so it runs before a keep of the same round restarts the donor
                pending.sort(key=lambda hc: hc[1].get("pbt_lifecycle") != "clone")
                free = [i for i in range(k) if handles[i] is None and lineage[i] is None]
                clone_jobs: list = []   # (lane, donor_lane, cfg)
                splice_jobs: list = []  # lanes taking a fresh init
                for handle, cfg in pending:
                    directive = cfg.get("pbt_lifecycle")
                    member = cfg.get("pbt_member")
                    lane = donor_lane = None
                    if lifecycle is not None and directive in ("keep", "clone"):
                        lane = lifecycle.lane_of(member, epoch)
                        if force_parked:
                            if lane is not None and handles[lane] is not None:
                                # a second stuck round of this member waits
                                # for the first
                                parked.append((handle, cfg))
                                continue
                            # the flight idled out with this lease stuck (its
                            # predecessor or donor never comes): a counted init
                            self.n_lineage_resets += 1
                            if directive == "clone":
                                lifecycle.clone_done(cfg)
                            directive = "init" if lane is not None else None
                        else:
                            if lane is not None and handles[lane] is not None:
                                parked.append((handle, cfg))  # member's lane mid-round
                                continue
                            if int(cfg.get("pbt_round", 0)) != rounds_done.get(member, 0):
                                # rounds run in order: a later round offered
                                # early waits for its predecessor
                                parked.append((handle, cfg))
                                continue
                            if directive == "keep" and lane is not None \
                                    and lifecycle.pinned(member):
                                # donor pinning: a pending clone still needs this
                                # lane's state
                                if handle not in donor_waited:
                                    donor_waited.add(handle)
                                    self.n_donor_waits += 1
                                parked.append((handle, cfg))
                                continue
                            if directive == "clone" and lane is not None:
                                donor_lane = lifecycle.lane_of(cfg.get("pbt_donor"), epoch)
                                if donor_lane is not None and handles[donor_lane] is not None:
                                    # donor mid-round: wait for its boundary
                                    if handle not in donor_waited:
                                        donor_waited.add(handle)
                                        self.n_donor_waits += 1
                                    parked.append((handle, cfg))
                                    continue
                                if donor_lane is None:
                                    # the donor's state is gone: a counted init
                                    self.n_lineage_resets += 1
                                    lifecycle.clone_done(cfg)
                                    directive = "init"
                            if lane is None:
                                # keep/clone of a member whose state is gone
                                self.n_lineage_resets += 1
                                if directive == "clone":
                                    lifecycle.clone_done(cfg)
                                directive = None  # the init path below
                    if lane is None:
                        if not free:
                            parked.append((handle, cfg))  # every lane is busy
                            continue
                        lane = free.pop(0)
                        directive = "init"
                        if lifecycle is not None and member is not None:
                            lifecycle.bind(member, lane, epoch)
                            lineage[lane] = member
                    # the serial driver's stream: explicit stream / job id,
                    # else a distinct lease-order stream (never the lane index)
                    sid = self._serial_stream_of(cfg)
                    round_steps = int(self._n_steps(cfg))
                    handles[lane] = handle
                    starts[lane] = s
                    lane_round[lane] = int(cfg.get("pbt_round", 0))
                    base_data[lane] = lane_round[lane] * round_steps
                    budgets[lane] = float(round_steps)
                    streams[lane] = sid
                    if directive == "keep":
                        base_sched = int(lane_applied[lane])
                    elif directive == "clone":
                        base_sched = int(lane_applied[donor_lane])
                        clone_jobs.append((lane, donor_lane, cfg))
                    else:
                        stored = snapshots.get(sid) if snapshots is not None else None
                        if stored is not None:
                            # this stream died mid-lane in an earlier flight (a
                            # supervised restart or --resume): write its
                            # harvested state back and train on from the
                            # snapshot's lane-local step, not step 0
                            snap, meta = stored
                            local = int(meta["local"])
                            fl.restore(lane, snap)
                            virgin = False
                            self.n_dispatches += 1
                            self.n_lane_restores += 1
                            starts[lane] = s - local
                            resumed_at[lane] = local
                            self.resumed_from_steps.append(local)
                            if "data_cursor" in meta:
                                # and its data cursor: the ring and the chunk
                                # cursors replay the stream from the snapshot's
                                # position
                                base_data[lane] = int(meta["data_cursor"]) - local
                            base_sched = int(meta.get("applied0", 0))
                            if self.journal is not None:
                                self.journal.append("lane_restore", lane=lane, step=local,
                                                    detail={"stream": sid})
                        else:
                            base_sched = 0
                            resumed_at[lane] = 0
                            splice_jobs.append(lane)
                    if used[lane] and directive != "keep":
                        self.n_refills += 1
                    applied0[lane] = base_sched
                    used[lane] = True
                    hps[lane] = self._hparams(cfg, base_sched + round_steps)
                    php_dirty = True
                    if self.journal is not None:
                        self.journal.append("lease", job_id=cfg.get("job_id"), lane=lane,
                                            step=int(s), detail={"stream": sid})
                # lane ops: clones first (they read donor lanes, never a
                # splice target), then the fresh inits
                if clone_jobs:
                    mask = np.zeros(k, bool)
                    donor_idx = np.arange(k)
                    for lane, donor_lane, _ in clone_jobs:
                        mask[lane] = True
                        donor_idx[lane] = donor_lane
                    fl.clone(mask, donor_idx)
                    virgin = False
                    self.n_clones += len(clone_jobs)
                    self.n_dispatches += 1
                    note_op("clone", [j[0] for j in clone_jobs], [j[1] for j in clone_jobs])
                    for _, _, cfg in clone_jobs:
                        lifecycle.clone_done(cfg)
                if splice_jobs:
                    if len(splice_jobs) == 1 and not (virgin and device_active):
                        lane = splice_jobs[0]
                        fl.splice(lane, streams[lane])
                        self.n_splices += 1
                        note_op("splice", splice_jobs)
                    else:
                        # several lanes in one pass (the first fill, a mass
                        # refill): one masked init
                        mask = np.zeros(k, bool)
                        mask[splice_jobs] = True
                        fl.init_lanes(mask, streams)
                        note_op("init", splice_jobs)
                    if not (virgin and device_active):
                        # the first fill of a device-rule flight is not a
                        # dispatch of its ladder: nothing has trained yet
                        self.n_dispatches += 1
                        virgin = False
                live = [i for i in range(k) if handles[i] is not None]
                force_parked = False
            # elastic regrid of the tail: the feed is closed, nothing is
            # parked and the retirements left at most half the lanes live;
            # lane order is kept, so the staggered rule's history appends,
            # and with them every later cut, are the fixed-width flight's
            plan = None
            if (elastic_on and live and not parked and getattr(scheduler, "closed", False)
                    and len(live) <= k // 2):
                plan = self._regrid_target(fl, len(live), pool)
            if plan is not None:
                k2, width = plan
                if pool is not None:
                    pool.regrid(len(live))
                fl.regrid(live, k2, width)
                self.regrid_log[-1]["step"] = int(s)
                pad = k2 - len(live)

                def restack(seq, fill):
                    return [seq[i] for i in live] + [fill(j) for j in range(pad)]

                def restack_array(arr):
                    out = np.zeros(k2, arr.dtype)
                    out[: len(live)] = arr[live]
                    return out

                handles = restack(handles, lambda j: None)
                used = restack(used, lambda j: True)
                lineage = restack(lineage, lambda j: None)
                lane_round = restack(lane_round, lambda j: 0)
                hps = restack(hps, lambda j: self._hparams({}, 0))
                streams = restack(streams, lambda j: -(len(live) + j + 1))
                starts, base_data, applied0, lane_applied, budgets, resumed_at = (
                    restack_array(a) for a in (starts, base_data, applied0, lane_applied,
                                               budgets, resumed_at))
                cols = restack(cols, lambda j: -1)
                k = k2
                live = list(range(len(live)))
                virgin = False
                php_dirty = True
                self.n_dispatches += 1
                self.n_regrids += 1
                self.lane_width_history.append(
                    [int(k2), 1 if fl.mesh is None else int(fl.mesh.width)])
            if php_dirty:
                fl.set_hp(hps)
                fl.set_streams(streams)
                if ring is not None:
                    # the lane table changed: re-key the ring so lane i's slab
                    # at global step s' is its own stream at base_data + s' -
                    # starts (idle lanes read their sentinel stream; their
                    # steps are never applied)
                    fl.ring_lanes(streams, [int(base_data[i] - starts[i])
                                            if handles[i] is not None else 0
                                            for i in range(k)], s)
            if not live:
                # 3) the flight is idle: wait briefly for late proposals
                # (Algorithm 1 may be mid-callback), then give the lanes back
                if getattr(scheduler, "closed", False) and not parked:
                    break
                now = time.time()
                if idle_deadline is None:
                    idle_deadline = now + grace
                if now >= idle_deadline:
                    if any(c.get("pbt_lifecycle") in ("keep", "clone") for _, c in parked):
                        # stuck lifecycle leases: re-init them, do not strand them
                        force_parked = True
                        idle_deadline = None
                        continue
                    break
                time.sleep(0.002)
                continue
            idle_deadline = None
            next_event = next_event_step()
            if next_event <= s:
                # an event is due now (a zero-budget lease): back to the event
                # pass without a dispatch
                continue
            # 4) advance to the next event: lane i reads its own stream at its
            # own cursor (a refilled lane from 0, a keep/clone round from
            # round * round_steps)
            t = planner.chunk_to(s, next_event)
            cursors = np.zeros(k, np.int64)
            local0 = np.zeros(k, np.int64)
            for i in range(k):
                if handles[i] is not None:
                    local0[i] = s - starts[i]
                    cursors[i] = base_data[i] + local0[i]
            if device_active:
                if device_spec is not None:
                    counts_max = max((len(v) for v in hook._rung_history.values()), default=0)
                    # the capacity never shrinks: on the card each new shape is
                    # a new graph (padding the history changes no output)
                    self._hist_cap = max(self._hist_cap, pow2_ceil(counts_max + k))
                    hist, counts = device_spec.lower_history(self._hist_cap)
                    rules = staggered_rule_state(budgets, applied0, local0,
                                                 device_spec.boundaries, device_spec.eta,
                                                 hist, counts)
                    mode = "staggered"
                else:
                    wentries = lifecycle.window_snapshot()
                    wscore = np.zeros(lifecycle.window.maxlen, np.float32)
                    for j, (_, sc, _) in enumerate(wentries):
                        wscore[j] = sc
                    rules = pbt_rule_state(budgets, applied0, local0, lifecycle.quantile,
                                           wscore, len(wentries))
                    mode = "pbt"
                rout, metrics = fl.rule_chunk(t, mode, rules, cursors)
                # read now: the graph's next replay overwrites its outputs
                rout = {n: v.cpu().numpy().copy() for n, v in rout.items()}
                virgin = False
                if device_spec is not None:
                    new_budgets = rout["budgets"].astype(np.float64)
                    # every shrink in the chunk is a rung cut (the staggered
                    # rule skips diverged lanes; their reclaim is the retire
                    # pass's)
                    hook.n_truncated += int((new_budgets < budgets).sum())
                    device_spec.absorb_history(rout["hist"], rout["counts"])
                    budgets = new_budgets
                else:
                    for lane in range(k):
                        if rout["vready"][lane] and lineage[lane] is not None:
                            lifecycle.note_device_verdict(
                                lineage[lane], lane_round[lane], bool(rout["vbottom"][lane]),
                                float(rout["vlo"][lane]), float(rout["vhi"][lane]))
            elif ring is not None:
                # the slabs of steps [s, s + t) come from the ring; the lanes'
                # cursors are in its contents, not in stream words
                metrics = fl.ring_chunk(s, t)
            elif chunk > 1:
                # every dispatch of a chunked flight, one step too, is a chunk
                # program (on the card a graph replay); batches made on the device
                metrics = fl.chunk(t, cursors)
            else:
                # one host synthesis call for all K lanes (idle lanes read their
                # sentinel stream at cursor 0; their steps are never applied)
                metrics = fl.step_cursors(cursors)
            self._count_active(acc, metrics, k, t)
            if losses is not None:
                losses.append(self._start_lanes(metrics["loss"].detach().reshape(-1, k),
                                                cols, k0))
            self.n_dispatches += 1
            self.n_train_steps += t
            s += t
        self.last_flight_steps = s
        self.n_active_lane_steps += int(acc)
        if losses is not None:
            self.record_flight(torch.cat(losses) if losses else None, fl.state)
        return []

    @staticmethod
    def _drain_leases(scheduler) -> list:
        out = []
        while True:
            lease = scheduler.lease()
            if lease is None:
                return out
            out.append(lease)


class _ReplayJob:
    """A minimal job for feeding a proposer outside Algorithm 1."""

    def __init__(self, cfg):
        self.config = cfg


def run_pbt_serial(trial: PopulationTrial, proposer) -> dict:
    """The generation-barriered serial PBT driver, with host checkpoints.

    Drives a streaming ``PBTProposer`` with an explicit generation barrier:
    each pass takes one whole generation of member configs, trains every
    member's round one trial at a time (the population step at K=1), and
    takes the weights each round's directive names from checkpoints kept on
    the host as CPU tensor trees: ``keep`` the member's own, ``clone`` the
    donor's from the end of the previous generation.  Every round costs two
    host round trips (restore, checkpoint), counted in
    ``trial.n_host_ckpt_roundtrips``.

    The decision rule, the RNG, the data streams, the schedule bases and the
    init generators are those of the streaming engine, so a same-seed
    streaming flight must give these scores.  Returns ``{(member, round):
    score}``."""
    from ..data.pipeline import HostPrefetcher
    from ..interop import add_lane_axis, tree_map
    from ..optim.hparams import stack_hparams
    from ..train import train_step as ts

    tc, data = trial._setup()
    dev = trial.device
    step_fn = ts.make_hparam_train_step(tc)
    ckpts: dict = {}
    applied: dict = {}
    scores: dict = {}
    hook = proposer.lifecycle_hook()

    def to_host(state):
        return tree_map(lambda t: t.detach().to("cpu", copy=True), state)

    def to_card(state):
        return tree_map(lambda t: t.to(dev, copy=True), state)

    while not proposer.finished():
        gen = proposer.get_params(proposer.population)
        if not gen:
            break
        # a clone reads its donor's checkpoint from the generation barrier,
        # not one the donor already advanced in this generation
        gen_ckpts, gen_applied = dict(ckpts), dict(applied)
        results = []
        for cfg in gen:
            m, r = int(cfg["pbt_member"]), int(cfg["pbt_round"])
            lc = cfg.get("pbt_lifecycle", "init")
            n_steps = trial._n_steps(cfg)
            stream = trial._stream_of(cfg, m)
            if lc == "keep":
                state = to_card(ckpts[m])
                trial.n_host_ckpt_roundtrips += 1
                base_sched = applied[m]
            elif lc == "clone":
                donor = int(cfg["pbt_donor"])
                state = to_card(gen_ckpts[donor])
                trial.n_host_ckpt_roundtrips += 1
                base_sched = gen_applied[donor]
                if hook is not None:
                    hook.clone_done(cfg)  # pins are an engine concept
            else:
                state = add_lane_axis(ts.init_train_state(trial._generator(stream), tc, dev))
                base_sched = 0
            hp = stack_hparams([trial._hparams(cfg, base_sched + n_steps)], dev)

            def build(t, base=r * n_steps, stream=stream):
                return {n: v[None] for n, v in data.make_batch(base + t, stream=stream).items()}

            feed = HostPrefetcher(build, dev)
            loss, n_applied = float("inf"), 0
            for t in range(n_steps):
                state, metrics = step_fn(state, feed.pop(t), hp)
                if t + 1 < n_steps:
                    feed.prefetch(t + 1)
                loss = float(metrics["loss"][0])
                if not np.isfinite(loss):
                    break
                n_applied += 1
            score = -loss if n_applied == n_steps else trial.DIVERGED_SCORE
            ckpts[m] = to_host(state)
            trial.n_host_ckpt_roundtrips += 1
            applied[m] = base_sched + n_applied
            scores[(m, r)] = score
            results.append((cfg, score))
        # the generation barrier: results go back only once the whole
        # generation has run, in member order
        for cfg, score in results:
            proposer.update(score, _ReplayJob(cfg))
    return scores


SPACE = [
    {"name": "learning_rate", "type": "float", "range": [1e-4, 3e-2], "scale": "log"},
    {"name": "warmup_frac", "type": "float", "range": [0.02, 0.5]},
    {"name": "weight_decay", "type": "float", "range": [0.0, 0.3]},
    {"name": "b2", "type": "float", "range": [0.9, 0.999]},
    {"name": "grad_clip", "type": "choice", "range": [0.5, 1.0, 2.0]},
]

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", default="starcoder2-3b")
    p.add_argument("--proposer", default="random",
                   help="random | grid | gp | tpe | hyperband | bohb | asha | pbt")
    p.add_argument("--n-samples", type=int, default=8)
    p.add_argument("--n-parallel", type=int, default=2)
    p.add_argument("--steps", type=int, default=30, help="train steps per unit budget")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where trials train (default cuda; without a GPU the "
                        "driver raises unless cpu is asked for)")
    p.add_argument("--db", default="", help="sqlite path ('' = in-memory)")
    p.add_argument("--deadline", type=float, default=0.0, help="per-job seconds (straggler kill)")
    p.add_argument("--vectorize", type=int, default=0, metavar="K",
                   help="train K trials as one lane-batched program (0 = serial)")
    p.add_argument("--shared-stream", action="store_true",
                   help="every trial consumes the same seeded batch stream "
                        "(default: independent per-trial streams)")
    p.add_argument("--inflight-stop", action="store_true",
                   help="with --vectorize and asha/hyperband/bohb: apply the "
                        "rung rule mid-flight, truncating losing lanes' budgets")
    p.add_argument("--per-trial-init", action="store_true",
                   help="fold each trial's stream/job id into its init seed so "
                        "trials start from distinct weights")
    p.add_argument("--fused-rmsnorm", action="store_true",
                   help="accepted for the JAX CLI's sake: the port always runs "
                        "its Hopper RMSNorm kernel on the card (and the plain "
                        "version on the CPU)")
    p.add_argument("--fused-attention", action="store_true",
                   help="accepted for the JAX CLI's sake: the port always runs "
                        "its Hopper flash-attention kernel on the card (and the "
                        "plain version on the CPU)")
    p.add_argument("--fused-ssm", action="store_true",
                   help="accepted for the JAX CLI's sake: the port always runs "
                        "its Hopper selective-scan kernel on the card (and the "
                        "plain version on the CPU)")
    p.add_argument("--max-flight-restarts", type=int, default=2,
                   help="supervised flight restarts before the survivors fail")
    p.add_argument("--fault-spec", default="",
                   help="deterministic fault injection, e.g. 'raise@step=20' "
                        "(see repro_torch.core.faultinject)")
    p.add_argument("--lane-refill", action="store_true",
                   help="with --vectorize: streaming flights; a retired lane "
                        "(budget done, rung-truncated, diverged) reports its "
                        "result at once and takes the next proposal in place")
    p.add_argument("--pbt-streaming", action="store_true",
                   help="with --proposer pbt and --vectorize K: PBT on the "
                        "streaming engine (implies --lane-refill); an exploit "
                        "step copies the donor lane's weights and optimizer "
                        "state on the device, with no host checkpoint")
    p.add_argument("--pbt-async", action="store_true",
                   help="with --pbt-streaming: no round gate; exploit decisions "
                        "come from the sliding window of member scores alone")
    p.add_argument("--pbt-perturb", type=float, default=1.2,
                   help="PBT explore factor: floats scale by it or its inverse")
    p.add_argument("--pbt-quantile", type=float, default=0.25,
                   help="PBT exploit quantile: members in the bottom fraction "
                        "clone a donor from the top fraction")
    p.add_argument("--pbt-window", type=int, default=0,
                   help="sliding window of member scores for streaming PBT "
                        "(0 = the population size)")
    p.add_argument("--pbt-rounds", type=int, default=0,
                   help="training rounds per PBT member (0 = n-samples / "
                        "population)")
    p.add_argument("--device-rules", action="store_true",
                   help="with --vectorize: run the rung rule (--inflight-stop) "
                        "or PBT's window quantile (--pbt-streaming --pbt-async) "
                        "inside the chunks, so chunks no longer stop at rung "
                        "boundaries and a whole ladder can be one dispatch")
    p.add_argument("--snapshot-every", type=int, default=0, metavar="N",
                   help="with --lane-refill: copy every live lane's train state to "
                        "the host at every N-th streaming event pass (kept on "
                        "disk beside --db), so a crashed run resumes each lane "
                        "from its last snapshot instead of step 0 (0 = off)")
    p.add_argument("--snapshot-dir", default="",
                   help="lane-snapshot directory (default: <db>.lanes)")
    p.add_argument("--resume", nargs="?", type=int, const=-1, default=None,
                   metavar="EXP_ID",
                   help="resume a crashed experiment from --db (no id = the "
                        "latest): replays finished jobs into the proposer, "
                        "re-queues the ones in flight at the crash, and restores "
                        "snapshotted lanes from --snapshot-dir")
    p.add_argument("--data-ring", action="store_true",
                   help="with --vectorize and --chunk-steps T > 1: feed the chunks "
                        "from a prefetch ring on the device, filled on a host "
                        "thread ahead of them, instead of making batches on the "
                        "device; the default fill (the synthetic stream) gives "
                        "in-chunk synthesis's scores bit for bit")
    p.add_argument("--ring-windows", type=int, default=2, metavar="W",
                   help="with --data-ring: prefetch depth in chunk-windows (>= 2; "
                        "2 = double buffering, one window training, one filling)")
    p.add_argument("--legacy-recompile", action="store_true",
                   help="serial baseline: a fresh train step per trial with the "
                        "proposal baked into its config, every trial on the same "
                        "seeded stream and weights (make_trial)")
    p.add_argument("--chunk-steps", type=int, default=1, metavar="T",
                   help="with --vectorize K: advance each flight in fused chunks "
                        "of up to T steps between host events, batches made on "
                        "the device (on the card one CUDA-graph replay a chunk); "
                        "1 = the per-step loop")
    p.add_argument("--shard-population", action="store_true",
                   help="with --vectorize K: split the population's lanes over "
                        "the ranks of a torch.distributed group, K/N lanes a rank "
                        "(K is padded to a multiple of N with 0-budget trials): "
                        "torchrun's ranks, else one rank per visible GPU (--device "
                        "cuda) or a world of one (--device cpu)")
    p.add_argument("--model-parallel", type=int, default=1, metavar="W",
                   help="with --shard-population: fold the ranks into lane rows of W, "
                        "each lane a width-W tensor-parallel program over its row "
                        "(heads, ff and Mamba channels split; 1 = width 1)")
    p.add_argument("--elastic-regrid", action="store_true",
                   help="with --vectorize K and a rung rule (--inflight-stop): at rung "
                        "boundaries, gather the surviving lanes into a smaller population "
                        "(K shrinks to the next power of two) so later rungs do not step "
                        "frozen lanes; under --shard-population the survivors move onto "
                        "fewer, wider lane rows of the same ranks (an ElasticLanePool); "
                        "streaming flights (--lane-refill) shrink the same way once the "
                        "feed is closed.  The scores are the fixed-width run's")
    args = p.parse_args(argv)

    from ..core.tracking.database import TrackingDB

    resume_db = resume_exp_id = None
    if args.resume is not None:
        if not args.db:
            p.error("--resume needs --db (the tracking DB to resume from)")
        resume_db = TrackingDB(args.db)
        resume_exp_id = (resume_db.latest_experiment_id()
                         if args.resume == -1 else args.resume)
        if resume_exp_id is None:
            p.error(f"--resume: no experiment found in {args.db!r}")
        row = resume_db.get_experiment(resume_exp_id)
        if row is None:
            p.error(f"--resume: experiment {resume_exp_id} not in {args.db!r}")
        # the stored CLI wins: the trial must be rebuilt exactly as the
        # crashed run built it, or the resumed lanes would not score the same
        for key, val in (row["exp_config"].get("cli") or {}).items():
            setattr(args, key, val)

    if args.model_parallel < 1:
        p.error("--model-parallel must be >= 1")
    if args.model_parallel > 1:
        if not args.shard_population:
            p.error("--model-parallel W splits each lane's tensors over a W-rank row of "
                    "the population mesh; it requires --vectorize K with "
                    "--shard-population")
        if args.elastic_regrid:
            p.error("--model-parallel is incompatible with --elastic-regrid: elastic "
                    "flights lease their own lane widths (the regrid is the width change)")
    if args.elastic_regrid:
        if args.vectorize <= 0:
            p.error("--elastic-regrid acts on the population engines; it requires "
                    "--vectorize K")
        if args.device_rules:
            p.error("--elastic-regrid is incompatible with --device-rules: in-scan rule "
                    "state is K-shaped, a regrid changes K mid-flight")
        if args.pbt_streaming:
            p.error("--elastic-regrid is incompatible with --pbt-streaming: keep/clone "
                    "directives pin members to lanes a regrid reindexes")
    try:
        model_config(args.arch)
    except KeyError as e:
        p.error(str(e.args[0]))
    if args.pbt_streaming:
        if args.proposer != "pbt":
            p.error(f"--pbt-streaming needs --proposer pbt, got {args.proposer!r}")
        if args.vectorize <= 0:
            p.error("--pbt-streaming requires --vectorize K (members live in "
                    "population lanes)")
        args.lane_refill = True  # streaming PBT rides the lane-refill engine
    elif args.pbt_async:
        p.error("--pbt-async only applies with --pbt-streaming")
    if args.vectorize <= 0 and args.inflight_stop:
        p.error("--inflight-stop requires --vectorize K (it acts on the "
                "population engine)")
    if args.vectorize <= 0 and (args.shard_population or args.lane_refill):
        p.error("--shard-population/--inflight-stop/--lane-refill require "
                "--vectorize K (they act on the population engines)")
    if args.lane_refill and args.shared_stream:
        p.error("--lane-refill needs per-trial data streams (a refilled lane "
                "replays its own stream from step 0); drop --shared-stream")
    if args.chunk_steps > 1 and args.vectorize <= 0:
        p.error("--chunk-steps acts on the population engines; it requires "
                "--vectorize K")
    if args.snapshot_every and not args.lane_refill:
        p.error("--snapshot-every snapshots streaming lanes; it requires "
                "--lane-refill")
    if args.device_rules:
        if args.vectorize <= 0:
            p.error("--device-rules acts on the population engines; it "
                    "requires --vectorize K")
        if not (args.inflight_stop or (args.pbt_streaming and args.pbt_async)):
            p.error("--device-rules needs an in-scan rule: --inflight-stop "
                    "(rung cuts) or --pbt-streaming with --pbt-async "
                    "(window-quantile verdicts)")
    if args.legacy_recompile and (args.fused_rmsnorm or args.fused_attention
                                  or args.fused_ssm):
        p.error("--fused-rmsnorm/--fused-attention/--fused-ssm act on the "
                "compile-once train step; the --legacy-recompile baseline "
                "predates the kernel bank and would silently ignore them")
    if args.fused_attention or args.fused_ssm:
        from ..configs import get_smoke_config

        cfg = get_smoke_config(args.arch)
        if args.fused_attention and not cfg.has_attention:
            p.error(f"--fused-attention: arch {args.arch!r} has no attention mixer")
        if args.fused_ssm and not cfg.has_mamba:
            p.error(f"--fused-ssm: arch {args.arch!r} has no SSM mixer")

    if args.data_ring:
        if args.vectorize <= 0 or args.chunk_steps <= 1:
            p.error("--data-ring feeds the fused scans; it requires "
                    "--vectorize K and --chunk-steps T > 1")
        if args.shared_stream:
            p.error("--data-ring fills per-lane slabs; drop --shared-stream")
        if args.device_rules:
            p.error("--data-ring is incompatible with --device-rules: the "
                    "rule-carrying scan synthesizes its own batches (in-scan "
                    "cursors ride the rule state)")
        if args.elastic_regrid:
            p.error("--data-ring is incompatible with --elastic-regrid: the ring's lane "
                    "axis is K-shaped, a regrid changes K mid-flight")
        if args.ring_windows < 2:
            p.error("--ring-windows must be >= 2 (one window training, one "
                    "filling)")

    from ..core import faultinject
    from ..core.experiment import Experiment

    if args.fault_spec:
        faultinject.arm(args.fault_spec)
    mesh = None
    if args.shard_population:
        from ..distributed.sharding import population_mesh

        n_local = _ranks_to_spawn(args.device)
        if n_local > 1:
            # one rank per visible GPU, as the JAX mesh takes every local
            # device: this process starts them and waits
            return _spawn_ranks(argv, n_local)
        if args.model_parallel > 1:
            from ..distributed.sharding import tp_width_rules

            cfg = model_config(args.arch)
            if not tp_width_rules(cfg, args.model_parallel):
                p.error(f"--model-parallel {args.model_parallel} shards nothing of "
                        f"{args.arch} (heads={cfg.n_heads}, kv={cfg.n_kv_heads}, "
                        f"ff={cfg.d_ff}, moe={cfg.has_moe}): pick a width dividing the "
                        f"module dims")
        try:
            mesh = population_mesh(args.device, width=args.model_parallel)
        except ValueError as e:   # a width that does not tile the ranks
            p.error(str(e))

    exp_cfg = {
        "proposer": args.proposer,
        "parameter_config": SPACE,
        "n_samples": args.n_samples,
        "n_parallel": args.n_parallel,
        "target": "max",
        "random_seed": args.seed,
        "resource": "local",
        "max_flight_restarts": args.max_flight_restarts,
    }
    if args.db:
        exp_cfg["db_path"] = args.db
    if args.deadline:
        exp_cfg["job_deadline_s"] = args.deadline
    if args.snapshot_every:
        exp_cfg["snapshot_every"] = args.snapshot_every
    if args.pbt_streaming:
        exp_cfg.update(
            streaming=True,
            sync_rounds=not args.pbt_async,
            population=args.vectorize,
            perturb=args.pbt_perturb,
            quantile=args.pbt_quantile,
            window=args.pbt_window,
        )
        if args.pbt_rounds:
            exp_cfg["n_generations"] = args.pbt_rounds
    per_trial_streams = not args.shared_stream
    trial_kw = dict(per_trial_streams=per_trial_streams,
                    per_trial_init=args.per_trial_init, device=args.device)
    # the lane-snapshot store: armed when snapshots are taken, or when a
    # resume may restore lanes an earlier run kept
    snap_store = None
    if args.lane_refill and (args.snapshot_every > 0 or args.resume is not None):
        from ..checkpoint import LaneSnapshotStore

        snap_store = LaneSnapshotStore(
            root=args.snapshot_dir or (args.db + ".lanes" if args.db else None))
    if args.vectorize > 0:
        exp_cfg["resource"] = "sharded" if args.shard_population else "vectorized"
        exp_cfg["n_parallel"] = args.vectorize
        if args.lane_refill:
            exp_cfg["lane_refill"] = True
        if args.elastic_regrid and args.shard_population:
            exp_cfg["elastic_regrid"] = True
        if args.model_parallel > 1:
            exp_cfg["model_parallel"] = args.model_parallel
        trial = PopulationTrial(args.arch, args.steps, args.batch, args.seq, args.seed,
                                population=args.vectorize, chunk_steps=args.chunk_steps,
                                device_rules=args.device_rules,
                                snapshot_every=args.snapshot_every, snapshots=snap_store,
                                data_ring=args.data_ring, ring_windows=args.ring_windows,
                                elastic_regrid=args.elastic_regrid, **trial_kw)
    elif args.legacy_recompile:
        trial = make_trial(args.arch, args.steps, args.batch, args.seq, args.seed,
                           device=args.device)
    else:
        trial = PopulationTrial(args.arch, args.steps, args.batch, args.seq, args.seed,
                                **trial_kw)
    if mesh is not None and mesh.rank != 0:
        # a rank above 0 trains its block of every flight rank 0 opens
        from .flight import serve

        try:
            serve(trial, mesh)
        finally:
            mesh.destroy()
        return 0
    # the stored CLI is what --resume rebuilds the trial from
    exp_cfg["cli"] = {k: getattr(args, k) for k in (
        "arch", "steps", "batch", "seq", "seed", "vectorize", "shard_population", "chunk_steps",
        "per_trial_init", "shared_stream", "lane_refill", "inflight_stop",
        "snapshot_every", "snapshot_dir", "legacy_recompile", "pbt_streaming",
        "pbt_async", "device_rules", "elastic_regrid",
        "data_ring", "ring_windows", "fused_rmsnorm", "fused_attention", "fused_ssm",
        "device", "max_flight_restarts", "model_parallel")}
    t0 = time.time()
    try:
        if resume_db is not None:
            exp = Experiment.resume(resume_db, trial, exp_id=resume_exp_id)
        else:
            exp = Experiment(exp_cfg, trial)
        result_times: list = []
        exp.add_result_callback(lambda job: result_times.append(time.time()))
        if args.inflight_stop:
            hook_factory = getattr(exp.proposer, "inflight_hook", None)
            if hook_factory is None:
                p.error(f"--inflight-stop needs a rung proposer (asha/hyperband/bohb), "
                        f"got {args.proposer!r}")
            trial.early_stop = hook_factory(steps_per_unit=args.steps)
        if args.device_rules and args.pbt_streaming:
            # decide() takes the window-quantile verdicts the chunks emit
            exp.proposer.lifecycle_hook().enable_device_rule()
        best = exp.run()
    finally:
        if mesh is not None:
            from .flight import shutdown

            shutdown(mesh)   # the other ranks leave their flight loop
            mesh.destroy()
    dt = time.time() - t0
    out = {
        "proposer": args.proposer,
        "arch": args.arch,
        "engine": ("legacy-recompile" if args.legacy_recompile else
                   "serial" if args.vectorize == 0 else
                   "sharded" if args.shard_population else "vmapped")
                  + (f"+tp{args.model_parallel}" if args.model_parallel > 1 else "")
                  + ("+refill" if args.lane_refill else "")
                  + ("+chunked" if args.chunk_steps > 1 else "")
                  + ("+ring" if args.data_ring else "")
                  + ("+devrules" if args.device_rules else "")
                  + ("+elastic" if args.elastic_regrid else ""),
        "vectorize": args.vectorize,
        "device": str(resolve_device(args.device)),
    }
    if args.device_rules:
        out["device_rules"] = True
    if args.elastic_regrid:
        out["regrids"] = trial.n_regrids
        out["lane_width_history"] = trial.lane_width_history
    if args.vectorize > 0:
        trained = int(trial.n_train_steps)
        out["chunk_steps"] = args.chunk_steps
        out["device_dispatches"] = trial.n_dispatches
        out["trained_steps"] = trained
        out["dispatches_per_step"] = (
            round(trial.n_dispatches / trained, 3) if trained else None)
        # the port's own: lane-steps that applied an update over lane-steps computed
        share = trial.active_lane_share
        out["active_lane_share"] = None if share is None else round(share, 4)
    if args.data_ring:
        out["ring_windows"] = args.ring_windows
        out["ring_fills"] = trial.n_ring_fills
        out["ring_invalidations"] = trial.n_ring_invalidations
        out["ring_fill_wait_s"] = round(trial.ring_fill_wait_s, 4)
        out["ring_fill_busy_s"] = round(trial.ring_fill_busy_s, 4)
        out["overlap_frac"] = round(trial.ring_overlap_frac, 4)
    if mesh is not None:
        # the model-group collectives a step issued (the seams' and the
        # gradient norm's): 0 at width 1, where a lane row is one rank
        out["model_parallel"] = mesh.width
        out["model_axis_collectives"] = int(trial.model_axis_collectives)
        out["mesh_ranks"] = mesh.world_size
        out["mesh_backend"] = mesh.backend
        out["n_degraded_flights"] = exp.rm.n_degraded_flights
    if args.fused_rmsnorm:
        out["fused_rmsnorm"] = True
    if args.fused_attention:
        out["fused_attention"] = True
    if args.fused_ssm:
        out["fused_ssm"] = True
    if getattr(trial, "per_rung_step_time_s", None):   # make_trial's trials have none
        out["per_rung_step_time_s"] = trial.per_rung_step_time_s
    if getattr(trial, "early_stop", None) is not None:
        out["inflight_truncated_lanes"] = trial.early_stop.n_truncated
        out["inflight_reclaimed_diverged_lanes"] = trial.early_stop.n_reclaimed
    if args.lane_refill:
        if trial.ladder_dispatches is not None:
            # the first cohort's dispatches: 1 when a device-rule ladder fits
            # one chunk
            out["ladder_device_dispatches"] = trial.ladder_dispatches
        out["lane_refills"] = trial.n_refills
        out["streamed_results"] = exp.rm.n_streamed
        out["refill_flights"] = exp.rm.n_refill_flights
        out["flight_deaths"] = exp.rm.n_flight_deaths
        out["flight_restarts"] = exp.rm.n_flight_restarts
        out["quarantined"] = exp.rm.n_quarantined
    if args.snapshot_every or args.resume is not None:
        out["snapshots"] = trial.n_snapshots
        out["resumed"] = args.resume is not None
        out["resumed_lanes"] = trial.n_lane_restores
        out["resumed_from_steps"] = list(trial.resumed_from_steps)
    if args.pbt_streaming:
        hook = exp.proposer.lifecycle_hook()
        out["pbt_clones"] = trial.n_clones
        out["pbt_splices"] = trial.n_splices
        out["pbt_keeps"] = hook.n_keeps
        out["pbt_donor_waits"] = trial.n_donor_waits + hook.n_donor_waits
        out["pbt_lineage_resets"] = trial.n_lineage_resets
        # weights never go through the host on the streaming engine
        out["pbt_host_ckpt_roundtrips"] = trial.n_host_ckpt_roundtrips
        if args.device_rules:
            out["pbt_device_verdicts"] = hook.n_device_verdicts
    if result_times:
        out["first_result_s"] = round(result_times[0] - t0, 2)
        out["last_result_s"] = round(result_times[-1] - t0, 2)
    print(json.dumps(dict(out, **{
        "best_score": best["score"],
        "best_config": {k: v for k, v in best["config"].items()
                        if not k.startswith(("hb_", "asha_", "pbt_"))
                        and k not in ("job_id", "stream")},
        "n_jobs": best.get("n_jobs"),
        "seconds": round(dt, 1),
    }), default=float, indent=1))
    return 0


def _ranks_to_spawn(device: str) -> int:
    """Ranks this process must start for ``--shard-population``: one per
    visible GPU when nothing launched it as a rank (no process group, no
    ``torchrun`` environment), else 1 (it is a rank itself)."""
    import os

    import torch.distributed as dist

    if device != "cuda" or dist.is_initialized() or "WORLD_SIZE" in os.environ:
        return 1
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def _rank_main(rank: int, argv, world: int, port: int, target=None) -> None:
    import os

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    code = (target or main)(argv)
    if code:
        raise SystemExit(code)


def _spawn_ranks(argv, world: int, target=None) -> int:
    """Run the CLI (``target``, default this module's ``main``: a function
    of ``argv`` a spawned process can import) as ``world`` ranks on this
    host (``torchrun``'s environment on localhost), rank 0 printing the
    result; returns when every rank has exited."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    argv = list(sys.argv[1:] if argv is None else argv)
    mp.spawn(_rank_main, args=(argv, world, port, target), nprocs=world, join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
