"""Population trial engine: K HPO trials trained as one program.

The lane-batched model runs all K trials' forward and backward passes
together (batched matmuls over K; the kernels take K as part of their batch
dimension), and AdamW updates all K lanes in one pass.

Population state layout (the JAX package's)::

    {"inner":     lane-batched train state (leading axis K),
     "diverged":  bool[K]   — latch; a NaN/inf loss freezes that trial,
     "last_loss": f32[K]    — loss at each trial's last *applied* step}

Semantics per ``pop_step(pstate, batch, hp)``:

* a trial is **active** while ``opt.step < hp.total_steps`` and not
  diverged — ``hp.total_steps`` doubles as the per-trial step budget, and the
  driver may shrink it mid-flight (in-flight early stopping);
* a non-finite loss at an active step sets the ``diverged`` latch and the
  update is not applied;
* lanes that are inactive or diverge keep their state bit for bit;
* ``last_loss`` records the loss of the most recent applied update.

Every leaf of the state is updated in place: the step never rebinds a
tensor, so a CUDA graph captured over it replays onto the same addresses.

**Fused chunked execution.**  ``make_population_scan_step`` advances every
lane ``chunk`` steps with each step's batch made on the device from the
lanes' stream words and step cursors (``repro_torch.data.pipeline.
synth_population_batch_device``), bit-identical to the per-step loop fed by
the host.  ``get_compiled_population_scan_step`` caches one program per
chunk size.  On the CPU a program is that plain T-step loop; on the card it
is one captured ``torch.cuda.CUDAGraph`` replayed per chunk (see
``_FlightGraphs``), so a chunk costs one host dispatch.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import TrainConfig
from ..interop import tree_leaves, tree_map
from ..optim.hparams import FIELDS, HParams
from . import train_step as ts

PopState = Dict[str, Any]


def _wrap(inner, k: int, device) -> PopState:
    return {
        "inner": inner,
        "diverged": torch.zeros((k,), dtype=torch.bool, device=device),
        "last_loss": torch.full((k,), float("inf"), dtype=torch.float32, device=device),
    }


def _init_into(out: PopState, gens, tc: TrainConfig, device) -> PopState:
    """Write a fresh population state into ``out``'s tensors: lane ``i``'s
    parameters from ``gens[i]`` (one generator: every lane), a zero optimizer
    state, as ``train_step.init_train_state`` makes them.  Only one lane's
    parameters are allocated beside ``out``."""
    lanes = [None] if len(gens) == 1 else range(len(gens))
    for lane, g in zip(lanes, gens):
        params = ts.init_params(g, tc, device)
        if lane is None:
            tree_map(lambda dst, x: dst.copy_(x[None].expand_as(dst)),
                     out["inner"]["params"], params)
        else:
            tree_map(lambda dst, x: dst[lane].copy_(x), out["inner"]["params"], params)
        del params
    for leaf in tree_leaves(out["inner"]["opt"]):
        leaf.zero_()
    out["diverged"].fill_(False)
    out["last_loss"].fill_(float("inf"))
    return out


def init_population_state(gen: torch.Generator, tc: TrainConfig, population: int,
                          device, out: Optional[PopState] = None) -> PopState:
    """K identical trials from one generator: every lane starts from the same
    weights (the serial driver inits every trial from the same seed); only
    their hyperparameters differ.  With ``out`` (a population state of the
    same geometry) the new state is written into its tensors, so only one
    lane's parameters are allocated beside it."""
    if out is not None:
        return _init_into(out, [gen], tc, device)
    one = ts.init_train_state(gen, tc, device)
    inner = tree_map(lambda x: x[None].repeat((population,) + (1,) * x.dim()), one)
    return _wrap(inner, population, device)


def init_population_state_from_keys(gens, tc: TrainConfig, device,
                                    out: Optional[PopState] = None) -> PopState:
    """One trial per generator (per-trial init weights); ``out`` as in
    ``init_population_state``."""
    if out is not None:
        return _init_into(out, list(gens), tc, device)
    states = [ts.init_train_state(g, tc, device) for g in gens]
    inner = tree_map(lambda *xs: torch.stack(xs), *states)
    return _wrap(inner, len(states), device)


def make_population_train_step(tc: TrainConfig, per_trial_batch: bool = False) -> Callable:
    """``(pstate, batch, hp) -> (pstate, metrics)`` over a leading K axis.

    ``hp`` is a stacked HParams (fields (K,)); metrics come back per lane plus
    the ``active`` mask.  With ``per_trial_batch`` the batch leaves carry a
    leading K axis (one data stream per trial); otherwise one batch is
    broadcast to every lane.  The state is updated in place.
    """
    step = ts.make_hparam_train_step(tc)

    def pop_step(pstate: PopState, batch, hp: HParams):
        inner = pstate["inner"]
        k = pstate["diverged"].shape[0]
        if not per_trial_batch:
            batch = {n: b[None].expand((k,) + b.shape) for n, b in batch.items()}
        in_budget = inner["opt"]["step"].float() < hp.total_steps
        active = in_budget & ~pstate["diverged"]
        _, metrics = step(inner, batch, hp, active=active)
        finite = torch.isfinite(metrics["loss"])
        applied = active & finite
        pstate["diverged"].copy_(pstate["diverged"] | (active & ~finite))
        pstate["last_loss"].copy_(torch.where(applied, metrics["loss"], pstate["last_loss"]))
        return pstate, dict(metrics, active=active)

    return pop_step


def make_population_scan_step(tc: TrainConfig, data, chunk: int,
                              per_trial_batch: bool = True) -> Callable:
    """``(pstate, hp, steps0, stream_lo, stream_hi) -> (pstate, metrics)``
    advancing every lane ``chunk`` steps.

    ``data`` is the ``SyntheticLM`` stream spec (baked in: the chunk program
    *is* the data pipeline for these lanes); ``steps0`` is each lane's data
    cursor at the chunk start (integer (K,), or a 0-d tensor in shared-stream
    mode) and ``stream_lo``/``stream_hi`` are the per-lane stream words from
    ``split_streams`` (integer (K,), 0-d in shared-stream mode), all on the
    state's device.  Step ``t`` of the chunk consumes exactly the batch the
    host loop would build at cursor ``steps0 + t``; budget/divergence masking
    is the ordinary population-step semantics, so a lane whose budget ends
    (or that diverges) mid-chunk freezes in place and the chunk remains safe
    to run past it.  ``metrics`` come back stacked with a leading
    ``(chunk,)`` axis.  The state is updated in place.
    """
    from ..data.pipeline import synth_batch_device, synth_population_batch_device

    step = make_population_train_step(tc, per_trial_batch=per_trial_batch)

    def scan_chunk(pstate: PopState, hp: HParams, steps0, stream_lo, stream_hi):
        per_step = []
        for t in range(int(chunk)):
            if per_trial_batch:
                batch = synth_population_batch_device(data, stream_lo, stream_hi, steps0,
                                                      offset=t)
            else:
                batch = synth_batch_device(data, stream_lo, stream_hi, steps0, offset=t)
            pstate, metrics = step(pstate, batch, hp)
            per_step.append(metrics)
            del batch
        return pstate, {n: torch.stack([m[n] for m in per_step]) for n in per_step[0]}

    return scan_chunk


# -- the chunk programs on the card: one CUDA graph a chunk size ----------------
#
# A chunk is captured once, from ``chunk`` population steps with their device
# synthesis, and replayed per dispatch.  A graph replays fixed addresses, so
# every graph of one flight geometry (static config, K, batch mode, data
# spec, device) captures the same tensors: the state of the first flight
# that ran it, and static copies of the hyperparameters, the cursor and the
# stream words.  A call copies its inputs into the static copies and
# replays.  All graphs of a geometry share one memory pool.  A failed capture
# raises: there is no eager path on the card.
#
# The captured state has one owner at a time: a flight holds the geometry's
# lease (``flight_lease``) from its init to its scores, and a second flight
# of the same geometry waits for it rather than write into the same tensors.


@dataclasses.dataclass
class _Captured:
    graph: Any
    metrics: Dict[str, torch.Tensor]
    capture_s: float
    pool_bytes: int


class _FlightGraphs:
    """The captured state and the graphs of one flight geometry on one card."""

    def __init__(self, tc: TrainConfig, data, per_trial_batch: bool, device):
        self.device = device
        self.warm_up_step = make_population_scan_step(tc, data, 1, per_trial_batch)
        self.state: Optional[PopState] = None
        self.inputs: Optional[Tuple] = None     # (hp, steps0, stream_lo, stream_hi)
        self.graphs: Dict[int, _Captured] = {}
        self.pool = None
        self.stream = None
        # held by a flight for its whole run, and by every call: reentrant
        self.lease = threading.RLock()

    def bind(self, pstate: PopState, hp: HParams, steps0, stream_lo, stream_hi) -> None:
        """Make the static inputs hold this call's: the first call's state
        becomes the captured state, and later calls must pass that state."""
        if self.state is None:
            self.state = pstate
            self.inputs = (HParams(**{f: getattr(hp, f).clone() for f in FIELDS}),
                           steps0.clone(), stream_lo.clone(), stream_hi.clone())
            return
        if pstate is not self.state:
            raise ValueError("this geometry's chunk graphs captured another population "
                             "state: initialise the flight into the state "
                             "flight_lease() yields")
        hp_s, *rest_s = self.inputs
        for f in FIELDS:
            _copy_into(getattr(hp_s, f), getattr(hp, f))
        for dst, x in zip(rest_s, (steps0, stream_lo, stream_hi)):
            _copy_into(dst, x)

    def warm_up(self) -> None:
        """One population step on the capture stream with every lane frozen
        (budgets 0): it runs every kernel and library call of a step once, so
        first-launch set-up (shared-memory attributes, library handles and
        workspaces) happens outside the capture, and it leaves the state bit
        for bit as it was (a frozen lane keeps its state)."""
        hp, steps0, lo, hi = self.inputs
        frozen = dataclasses.replace(hp, total_steps=torch.zeros_like(hp.total_steps))
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            self.warm_up_step(self.state, frozen, steps0, lo, hi)
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        torch.cuda.synchronize(self.device)

    def capture(self, fn: Callable, chunk: int) -> _Captured:
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
            self.pool = torch.cuda.graph_pool_handle()
            self.warm_up()
        torch.cuda.synchronize(self.device)
        gc.collect()
        torch.cuda.empty_cache()   # the eager blocks go back before the pool grows
        before = torch.cuda.memory_reserved(self.device)
        leaves = tree_leaves(self.state)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            _, metrics = fn(self.state, *self.inputs)
        torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - t0
        if any(a is not b for a, b in zip(leaves, tree_leaves(self.state))):
            raise RuntimeError("population step rebound a state tensor under capture: "
                               "a captured graph only updates tensors in place")
        got = _Captured(graph, metrics, seconds,
                        torch.cuda.memory_reserved(self.device) - before)
        self.graphs[chunk] = got
        return got

    def run(self, fn: Callable, chunk: int, pstate, hp, steps0, stream_lo, stream_hi):
        with self.lease:
            self.bind(pstate, hp, steps0, stream_lo, stream_hi)
            got = self.graphs.get(chunk) or self.capture(fn, chunk)
            got.graph.replay()
            return self.state, got.metrics


def _device_key(device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def _copy_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    if src is dst:
        return
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"chunk program captured a {tuple(dst.shape)} input; got "
                         f"{tuple(src.shape)}")
    dst.copy_(src)


def _geometry(tc: TrainConfig, population: int, per_trial_batch: bool, data) -> Tuple:
    """What the chunk graphs of one flight geometry share (the chunk-program
    key without its chunk size)."""
    return (ts.static_step_key(tc), int(population), bool(per_trial_batch), "scan",
            data.spec_key)


def _flight_graphs(tc: TrainConfig, population: int, per_trial_batch: bool, data,
                   device) -> _FlightGraphs:
    key = _geometry(tc, population, per_trial_batch, data) + (_device_key(device),)
    with _POP_CACHE_LOCK:
        fg = _GRAPHS.get(key)
        if fg is None:
            fg = _GRAPHS[key] = _FlightGraphs(tc, data, bool(per_trial_batch), device)
    return fg


class _ChunkProgram:
    """One entry of the chunk-program cache: ``chunk`` population steps for
    one flight geometry.  A CPU state runs the plain T-step loop; a CUDA
    state replays the chunk's captured graph."""

    def __init__(self, tc: TrainConfig, data, population: int, chunk: int,
                 per_trial_batch: bool):
        self.fn = make_population_scan_step(tc, data, chunk, per_trial_batch)
        self.chunk = int(chunk)
        self._geometry = (tc, int(population), bool(per_trial_batch), data)

    def __call__(self, pstate: PopState, hp: HParams, steps0, stream_lo, stream_hi):
        dev = pstate["diverged"].device
        if dev.type == "cpu":
            return self.fn(pstate, hp, steps0, stream_lo, stream_hi)
        if dev.type == "cuda":
            return _flight_graphs(*self._geometry, dev).run(
                self.fn, self.chunk, pstate, hp, steps0, stream_lo, stream_hi)
        raise ValueError(f"chunk program: no path for device {dev}")


# -- program caches -------------------------------------------------------------
#
# One chunk program per (static config, population size, batch mode, "scan",
# chunk, data spec) -- the JAX package's key; the captured graphs of the
# programs of one geometry live in ``_GRAPHS``, one entry per card.

_POP_CACHE: Dict[Tuple, Any] = {}
_GRAPHS: Dict[Tuple, _FlightGraphs] = {}
_POP_CACHE_LOCK = threading.Lock()


def get_compiled_population_scan_step(tc: TrainConfig, population: int, data, chunk: int,
                                      per_trial_batch: bool = True) -> _ChunkProgram:
    """Memoized chunk program (see ``make_population_scan_step`` for its
    call).  Drivers dispatch power-of-two chunk sizes, so an experiment makes
    at most ``log2(chunk_steps) + 1`` programs per geometry.
    ``clear_population_cache()`` drops them and their graphs."""
    g = _geometry(tc, population, per_trial_batch, data)
    key = g[:-1] + (int(chunk), g[-1])
    with _POP_CACHE_LOCK:
        fn = _POP_CACHE.get(key)
        if fn is None:
            fn = _POP_CACHE[key] = _ChunkProgram(tc, data, population, chunk,
                                                 per_trial_batch)
    return fn


@contextlib.contextmanager
def flight_lease(tc: TrainConfig, population: int, data, per_trial_batch: bool, device):
    """Own this geometry's captured state on ``device`` for one flight.

    Yields the state the chunk graphs captured, or None before the first
    capture (the flight's own state then becomes the captured one).  A new
    flight initialises into the yielded state (``init_population_state(...,
    out=)``) instead of holding a second copy beside it.  A second flight of
    the same geometry waits here until the first has left; a call of the
    geometry's chunk programs from another thread waits too."""
    fg = _flight_graphs(tc, population, per_trial_batch, data, device)
    with fg.lease:
        yield fg.state


def graph_stats() -> list:
    """Per captured chunk graph: its chunk size, capture seconds and the
    bytes its capture added to the geometry's memory pool."""
    with _POP_CACHE_LOCK:
        groups = list(_GRAPHS.values())
    return [{"chunk": c, "capture_s": g.capture_s, "pool_bytes": g.pool_bytes}
            for fg in groups for c, g in sorted(fg.graphs.items())]


def clear_population_cache() -> None:
    with _POP_CACHE_LOCK:
        _POP_CACHE.clear()
        _GRAPHS.clear()


def pad_population(k: int, mesh: Optional[Any] = None) -> int:
    """Smallest population size >= k that divides over the lane rows.  Only
    the single-device engine is ported: ``mesh`` must be None."""
    if mesh is not None:
        raise NotImplementedError(
            "multi-device population meshes come with ROADMAP.md section 1, item 12")
    return max(k, 1)


def population_scores(pstate: PopState, diverged_score: float = -1e9) -> torch.Tensor:
    """HPO convention: score = -final_loss, with a sentinel for diverged
    trials.  Trials that never applied a step (budget 0) also get the
    sentinel."""
    last = pstate["last_loss"]
    ok = ~pstate["diverged"] & torch.isfinite(last)
    return torch.where(ok, -last, torch.full_like(last, diverged_score))
