"""HPO driver: the paper's Experiment loop over model-training trials, on the
PyTorch port.

    PYTHONPATH=src python -m repro_torch.launch.hpo --arch starcoder2-3b \\
        --proposer random --n-samples 8 --vectorize 4 --steps 30

Each trial trains the architecture's smoke config (or the config with
``model_overrides`` applied) for ``--steps`` on the deterministic synthetic
stream and reports -final_loss as the score.  Every proposal and result lands
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

**Device.**  Trials run on ``cuda`` unless ``--device cpu`` is given; without
a GPU the driver raises rather than fall back.  On the card every RMSNorm and
every attention forward runs the hand-written Hopper kernels; on the CPU
their plain PyTorch versions.

Engines of later slices (fused chunked scans, streaming refill and PBT,
device-side rules, crash safety, the prefetch ring, multi-device meshes) are
refused with the ROADMAP.md item that brings them.
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

from .chunkplan import ChunkPlanner

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
    """

    DIVERGED_SCORE = -1e9

    def __init__(self, arch: str, steps: int, batch: int, seq: int, seed: int,
                 population: int = 0, per_trial_streams: bool = True,
                 early_stop=None, per_trial_init: bool = False,
                 model_overrides=None, device=None):
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
        # [[boundary_step, steps, s_per_step], ...] between rung boundaries
        self.per_rung_step_time_s: list = []
        self.n_dispatches = 0       # population steps issued
        self.n_train_steps = 0      # population steps those calls advanced
        self.last_flight_steps = 0
        self._tc = None
        self._data = None
        self._serial_seq = 0  # fallback stream counter for anonymous configs
        self._setup_lock = threading.Lock()

    # locked because local resource managers call trials from worker threads
    def _setup(self):
        with self._setup_lock:
            if self._tc is None:
                from ..configs import get_smoke_config
                from ..configs.base import ParallelConfig, TrainConfig
                from ..data.pipeline import SyntheticLM
                from ..models.transformer import check_supported

                cfg = get_smoke_config(self.arch)
                if self.model_overrides:
                    cfg = dataclasses.replace(cfg, **self.model_overrides)
                check_supported(cfg)
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

    def run_population(self, configs) -> list:
        """Batch protocol: K trials in one lane-batched program.  Partial
        batches are padded to the fixed population size with 0-budget lanes
        (they freeze at once) reading distinct negative sentinel streams."""
        from ..data.pipeline import HostPrefetcher
        from ..optim.hparams import stack_hparams
        from ..train.population import (
            init_population_state,
            init_population_state_from_keys,
            make_population_train_step,
            pad_population,
            population_scores,
        )

        tc, data = self._setup()
        dev = self.device
        budgets = np.array([float(self._n_steps(c)) for c in configs])
        streams = [self._stream_of(c, i) for i, c in enumerate(configs)]
        hps = [self._hparams(c, int(n)) for c, n in zip(configs, budgets)]
        k = pad_population(max(self.population, len(hps)))
        while len(hps) < k:
            hps.append(self._hparams({}, 0))
        streams += [-(i + 1) for i in range(len(streams), k)]
        budgets = np.concatenate([budgets, np.zeros(k - len(budgets))])
        php = stack_hparams(hps, dev)
        if self.per_trial_init:
            pstate = init_population_state_from_keys(
                [self._generator(s) for s in streams], tc, dev)
        else:
            pstate = init_population_state(self._generator(0), tc, k, dev)
        pstep = make_population_train_step(tc, per_trial_batch=self.per_trial_streams)
        hook = self.early_stop
        planner = ChunkPlanner(chunk_steps=1,
                               boundaries=hook.boundaries if hook is not None else ())
        feed = HostPrefetcher(lambda t: self._batch(data, t, streams), dev)
        s = 0
        seg_t0, seg_s0 = time.perf_counter(), 0
        while s < int(budgets.max()):
            max_b = int(budgets.max())
            t = planner.chunk_to(s, planner.next_cohort_event(s, max_b))
            pstate, _ = pstep(pstate, feed.pop(s), php)
            if s + t < max_b:
                feed.prefetch(s + t)  # host synthesis overlaps the device step
            self.n_dispatches += 1
            self.n_train_steps += t
            s += t
            if hook is not None and s in hook.boundaries:
                new_budgets = hook(
                    s,
                    pstate["last_loss"].cpu().numpy(),
                    budgets,
                    pstate["diverged"].cpu().numpy(),
                )
                # the last_loss read above synced the device, so this
                # segment's wall-clock is honest
                self.per_rung_step_time_s.append(
                    [int(s), int(s - seg_s0),
                     round((time.perf_counter() - seg_t0) / max(1, s - seg_s0), 6)])
                seg_t0, seg_s0 = time.perf_counter(), s
                if (new_budgets != budgets).any():
                    # truncating a lane's budget freezes it on the next step
                    budgets = new_budgets
                    php = dataclasses.replace(
                        php, total_steps=torch.tensor(budgets, dtype=torch.float32,
                                                      device=dev))
        self.last_flight_steps = s
        scores = population_scores(pstate, self.DIVERGED_SCORE).cpu().numpy()
        if s > seg_s0:  # the tail past the last rung boundary (scores synced)
            self.per_rung_step_time_s.append(
                [int(s), int(s - seg_s0),
                 round((time.perf_counter() - seg_t0) / (s - seg_s0), 6)])
        return [float(x) for x in scores[: len(configs)]]


SPACE = [
    {"name": "learning_rate", "type": "float", "range": [1e-4, 3e-2], "scale": "log"},
    {"name": "warmup_frac", "type": "float", "range": [0.02, 0.5]},
    {"name": "weight_decay", "type": "float", "range": [0.0, 0.3]},
    {"name": "b2", "type": "float", "range": [0.9, 0.999]},
    {"name": "grad_clip", "type": "choice", "range": [0.5, 1.0, 2.0]},
]

# flags of the JAX CLI whose engines come with a later slice of the port
_ITEM = "ROADMAP.md section 1, item {}"
_LATER_FLAGS = (
    ("shard_population", "--shard-population", _ITEM.format("12 (multi-device engines)")),
    ("model_parallel", "--model-parallel", _ITEM.format("12 (multi-device engines)")),
    ("elastic_regrid", "--elastic-regrid", _ITEM.format("12 (multi-device engines)")),
    ("chunk_steps", "--chunk-steps > 1", _ITEM.format("7 (fused chunked scan)")),
    ("lane_refill", "--lane-refill", _ITEM.format("8 (streaming engines)")),
    ("pbt_streaming", "--pbt-streaming", _ITEM.format("8 (streaming engines)")),
    ("device_rules", "--device-rules", _ITEM.format("8 (device-side rules)")),
    ("data_ring", "--data-ring", _ITEM.format("10 (prefetch ring)")),
    ("snapshot_every", "--snapshot-every", _ITEM.format("9 (crash safety)")),
    ("resume", "--resume", _ITEM.format("9 (crash safety)")),
    ("fused_ssm", "--fused-ssm",
     _ITEM.format("11 (other model families) and section 2, the SSM scan kernel")),
    ("legacy_recompile", "--legacy-recompile",
     _ITEM.format("13 (tooling: the throughput benchmark's baselines)")),
)


def _later(args, name: str) -> bool:
    val = getattr(args, name)
    if name == "chunk_steps":
        return val > 1
    if name == "model_parallel":
        return val > 1
    if name == "resume":
        return val is not None
    return bool(val)


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
    p.add_argument("--max-flight-restarts", type=int, default=2,
                   help="supervised flight restarts before the survivors fail")
    p.add_argument("--fault-spec", default="",
                   help="deterministic fault injection, e.g. 'raise@step=20' "
                        "(see repro_torch.core.faultinject)")
    # accepted like the JAX CLI; they act only with engines refused below
    p.add_argument("--snapshot-dir", default="", help=argparse.SUPPRESS)
    p.add_argument("--pbt-async", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--pbt-perturb", type=float, default=1.2, help=argparse.SUPPRESS)
    p.add_argument("--pbt-quantile", type=float, default=0.25, help=argparse.SUPPRESS)
    p.add_argument("--pbt-window", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--pbt-rounds", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--ring-windows", type=int, default=2, help=argparse.SUPPRESS)
    for flag, kw in (
        ("--shard-population", dict(action="store_true")),
        ("--lane-refill", dict(action="store_true")),
        ("--pbt-streaming", dict(action="store_true")),
        ("--chunk-steps", dict(type=int, default=1, metavar="T")),
        ("--device-rules", dict(action="store_true")),
        ("--elastic-regrid", dict(action="store_true")),
        ("--data-ring", dict(action="store_true")),
        ("--fused-ssm", dict(action="store_true")),
        ("--model-parallel", dict(type=int, default=1, metavar="W")),
        ("--legacy-recompile", dict(action="store_true")),
        ("--snapshot-every", dict(type=int, default=0, metavar="N")),
        ("--resume", dict(nargs="?", type=int, const=-1, default=None, metavar="EXP_ID")),
    ):
        p.add_argument(flag, help="not ported yet: refused with the ROADMAP.md "
                                  "item that brings it", **kw)
    args = p.parse_args(argv)

    for name, flag, item in _LATER_FLAGS:
        if _later(args, name):
            p.error(f"{flag} is not ported to the PyTorch package yet; it comes "
                    f"with {item}")
    if args.pbt_async:
        p.error("--pbt-async only applies with --pbt-streaming")
    if args.vectorize <= 0 and args.inflight_stop:
        p.error("--inflight-stop requires --vectorize K (it acts on the "
                "population engine)")
    if args.fused_attention:
        from ..configs import get_smoke_config

        if not get_smoke_config(args.arch).has_attention:
            p.error(f"--fused-attention: arch {args.arch!r} has no attention mixer")

    from ..core import faultinject
    from ..core.experiment import Experiment

    if args.fault_spec:
        faultinject.arm(args.fault_spec)

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
    per_trial_streams = not args.shared_stream
    trial_kw = dict(per_trial_streams=per_trial_streams,
                    per_trial_init=args.per_trial_init, device=args.device)
    if args.vectorize > 0:
        exp_cfg["resource"] = "vectorized"
        exp_cfg["n_parallel"] = args.vectorize
        trial = PopulationTrial(args.arch, args.steps, args.batch, args.seq, args.seed,
                                population=args.vectorize, **trial_kw)
    else:
        trial = PopulationTrial(args.arch, args.steps, args.batch, args.seq, args.seed,
                                **trial_kw)
    exp_cfg["cli"] = {k: getattr(args, k) for k in (
        "arch", "steps", "batch", "seq", "seed", "vectorize", "per_trial_init",
        "shared_stream", "inflight_stop", "fused_rmsnorm", "fused_attention",
        "device", "max_flight_restarts")}
    t0 = time.time()
    exp = Experiment(exp_cfg, trial)
    result_times: list = []
    exp.add_result_callback(lambda job: result_times.append(time.time()))
    if args.inflight_stop:
        hook_factory = getattr(exp.proposer, "inflight_hook", None)
        if hook_factory is None:
            p.error(f"--inflight-stop needs a rung proposer (asha/hyperband/bohb), "
                    f"got {args.proposer!r}")
        trial.early_stop = hook_factory(steps_per_unit=args.steps)
    best = exp.run()
    dt = time.time() - t0
    out = {
        "proposer": args.proposer,
        "arch": args.arch,
        "engine": "serial" if args.vectorize == 0 else "vmapped",
        "vectorize": args.vectorize,
        "device": str(trial.device),
    }
    if args.vectorize > 0:
        trained = int(trial.n_train_steps)
        out["chunk_steps"] = 1
        out["device_dispatches"] = trial.n_dispatches
        out["trained_steps"] = trained
        out["dispatches_per_step"] = (
            round(trial.n_dispatches / trained, 3) if trained else None)
    if args.fused_rmsnorm:
        out["fused_rmsnorm"] = True
    if args.fused_attention:
        out["fused_attention"] = True
    if trial.per_rung_step_time_s:
        out["per_rung_step_time_s"] = trial.per_rung_step_time_s
    if trial.early_stop is not None:
        out["inflight_truncated_lanes"] = trial.early_stop.n_truncated
        out["inflight_reclaimed_diverged_lanes"] = trial.early_stop.n_reclaimed
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


if __name__ == "__main__":
    sys.exit(main())
