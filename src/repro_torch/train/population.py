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

**Lane ops and device-side rules** (the streaming engines).  The lane ops
``make_lane_init`` / ``make_lane_clone`` / ``make_lane_splice`` re-initialise
or copy lanes of a population state in place, so a flight's captured state
stays the one its graphs replay; ``make_lane_snapshot`` copies one lane to
the host and ``make_lane_restore`` writes such a snapshot back into any lane
(crash-safe streaming).  ``make_population_rule_scan_step`` is the
chunk with a decision rule carried through it (``cohort_rule_update``,
``staggered_rule_update`` or ``pbt_rule_update``): each step rebuilds the
lanes' budgets from the carried rule state and applies the rule to the
step's losses, with no host sync, so a rung cut lands inside the chunk.

**Ring-fed chunks** (``--data-ring``).  ``make_population_ring_scan_step``
is the chunk fed from a prefetch ring (``repro_torch.data.ring``) instead of
in-chunk synthesis; on the card its graphs read the geometry's ring tensor
(``ring_buffer``), allocated once beside the captured state.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import re
import tempfile
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import TrainConfig
from ..interop import tree_leaves, tree_map, tree_unflatten
from ..optim.hparams import FIELDS, HParams
from . import train_step as ts

PopState = Dict[str, Any]


def _wrap(inner, k: int, device) -> PopState:
    return {
        "inner": inner,
        "diverged": torch.zeros((k,), dtype=torch.bool, device=device),
        "last_loss": torch.full((k,), float("inf"), dtype=torch.float32, device=device),
    }


def _init_into(out: PopState, gens, tc: TrainConfig, device, layout=None) -> PopState:
    """Write a fresh population state into ``out``'s tensors: lane ``i``'s
    parameters from ``gens[i]`` (one generator: every lane), a zero optimizer
    state, as ``train_step.init_train_state`` makes them.  Only one lane's
    parameters are allocated beside ``out``.  With ``layout`` (a
    ``TPLayout``) ``out`` holds a model rank's shards, and each lane's
    parameters are drawn whole and sliced to them."""
    if len(gens) > 1:
        return _reinit_lanes(out, range(len(gens)), gens, tc, layout)
    params = ts.init_params(gens[0], tc, device)
    if layout is not None:
        params = layout.params(params)
    tree_map(lambda dst, x: dst.copy_(x[None].expand_as(dst)), out["inner"]["params"], params)
    del params
    for leaf in tree_leaves(out["inner"]["opt"]):
        leaf.zero_()
    out["diverged"].fill_(False)
    out["last_loss"].fill_(float("inf"))
    return out


def init_population_state(gen: torch.Generator, tc: TrainConfig, population: int,
                          device, out: Optional[PopState] = None,
                          layout=None) -> PopState:
    """K identical trials from one generator: every lane starts from the same
    weights (the serial driver inits every trial from the same seed); only
    their hyperparameters differ.  With ``out`` (a population state of the
    same geometry) the new state is written into its tensors, so only one
    lane's parameters are allocated beside it.  With ``layout`` the state is
    a model rank's shards of it (``TPLayout``)."""
    if out is not None:
        return _init_into(out, [gen], tc, device, layout)
    one = ts.init_train_state(gen, tc, device)
    if layout is not None:
        one = layout.inner(one)
    inner = tree_map(lambda x: x[None].repeat((population,) + (1,) * x.dim()), one)
    return _wrap(inner, population, device)


def init_population_state_from_keys(gens, tc: TrainConfig, device,
                                    out: Optional[PopState] = None,
                                    layout=None) -> PopState:
    """One trial per generator (per-trial init weights); ``out`` as in
    ``init_population_state``.  Without ``out``, lane 0's state is made
    for every lane and the other lanes then draw their parameters in place,
    so one lane's state is allocated beside the population, not K states
    and their stack."""
    gens = list(gens)
    if out is not None:
        return _init_into(out, gens, tc, device, layout)
    out = init_population_state(gens[0], tc, len(gens), device, layout=layout)
    return _reinit_lanes(out, range(1, len(gens)), gens[1:], tc, layout)


# -- lane ops ------------------------------------------------------------------
#
# The streaming engines change single lanes of a live population state: a
# retired lane takes the next proposal's weights, or a PBT member inherits a
# donor lane's weights and optimizer state.  Each op writes into the state's
# own tensors and returns the same dict, so a CUDA graph that captured the
# state replays onto the new lanes.  Beside the state, init and splice
# allocate one lane's parameters at a time and clone one leaf's donor rows;
# snapshot and restore copy between lane views and the host, nothing more.
#
# * ``init``   (``make_lane_init``)   — re-initialise the masked lanes;
# * ``clone``  (``make_lane_clone``)  — copy donor lanes into the masked lanes;
# * ``splice`` (``make_lane_splice``) — re-initialise one lane;
# * ``snapshot`` (``make_lane_snapshot``) — copy one lane to the host (a read);
# * ``restore`` (``make_lane_restore``) — write a snapshot into one lane;
# * ``regrid`` (``make_lane_regrid``) — gather the survivors into a new,
#   smaller state (elastic regrid; the one op that does not write in place).


def _lanes_of(mask) -> list:
    """The masked lanes' indices (a host list) from a bool mask (list,
    numpy or tensor)."""
    if isinstance(mask, torch.Tensor):
        mask = mask.detach().cpu().numpy()
    return [int(i) for i in np.flatnonzero(np.asarray(mask, bool))]


def _reinit_lanes(pstate: PopState, lanes: Sequence[int], gens, tc: TrainConfig,
                  layout=None) -> PopState:
    """Lane ``lanes[j]`` takes fresh parameters from ``gens[j]`` (through
    ``train_step.init_params``; with ``layout`` sliced to the rank's
    shards), a zero optimizer state, a cleared divergence latch and the
    ``last_loss`` sentinel."""
    if not lanes:
        return pstate
    dev = pstate["diverged"].device
    for lane, g in zip(lanes, gens):
        params = ts.init_params(g, tc, dev)
        if layout is not None:
            params = layout.params(params)
        tree_map(lambda dst, x: dst[lane].copy_(x), pstate["inner"]["params"], params)
        del params
    idx = torch.as_tensor(list(lanes), dtype=torch.long, device=dev)
    for leaf in tree_leaves(pstate["inner"]["opt"]):
        leaf.index_fill_(0, idx, 0)
    pstate["diverged"].index_fill_(0, idx, False)
    pstate["last_loss"].index_fill_(0, idx, float("inf"))
    return pstate


def make_lane_init(tc: TrainConfig) -> Callable:
    """``(pstate, mask, gens) -> pstate`` with the masked lanes re-initialised.

    ``mask`` is bool[K]; ``gens`` holds one init generator per lane (entries
    of unmasked lanes are not read), so a refilled lane starts from exactly
    the weights a fresh trial with the same generator would.  Unmasked lanes
    keep their state bit for bit."""

    def init(pstate: PopState, mask, gens) -> PopState:
        lanes = _lanes_of(mask)
        return _reinit_lanes(pstate, lanes, [gens[i] for i in lanes], tc)

    return init


def make_lane_clone(tc: TrainConfig) -> Callable:
    """``(pstate, mask, donor_idx) -> pstate`` cloning donor lanes in place.

    Every masked lane ``i`` takes lane ``donor_idx[i]``'s whole state
    (parameters, AdamW moments, step counter, divergence latch and
    ``last_loss``); unmasked lanes are untouched.  Each leaf gathers its donor
    rows before it writes, so a lane that is both a donor and a target (a
    chain 0<-1, 1<-2) reads the state from before the op, as the JAX
    package's functional clone does."""

    def clone(pstate: PopState, mask, donor_idx) -> PopState:
        lanes = _lanes_of(mask)
        if not lanes:
            return pstate
        if isinstance(donor_idx, torch.Tensor):
            donor_idx = donor_idx.detach().cpu().numpy()
        dev = pstate["diverged"].device
        targets = torch.as_tensor(lanes, dtype=torch.long, device=dev)
        donors = torch.as_tensor([int(donor_idx[i]) for i in lanes], dtype=torch.long,
                                 device=dev)
        for leaf in tree_leaves(pstate):
            leaf.index_copy_(0, targets, leaf.index_select(0, donors))
        return pstate

    return clone


def make_lane_splice(tc: TrainConfig) -> Callable:
    """``(pstate, lane, gen) -> pstate`` re-initialising exactly one lane
    from ``gen``: one lane's init, whatever K is."""

    def splice(pstate: PopState, lane, gen) -> PopState:
        return _reinit_lanes(pstate, [int(lane)], [gen], tc)

    return splice


def _lane_tree(pstate: PopState) -> PopState:
    """The snapshot tree's structure over a population state's leaves."""
    return {"inner": pstate["inner"], "diverged": pstate["diverged"],
            "last_loss": pstate["last_loss"]}


class _LaneSlots:
    """Host copies of one lane of a population geometry, reused across
    harvests: at most ``count`` of them (K + 1: every live lane's snapshot
    held in a store, and one more to harvest into before the store lets the
    superseded one go).  Each slot is one flat host buffer, page-locked from
    a card with ``cudaHostRegister`` (its exact size, where the caching host
    allocator would round a block up to a power of two and keep it for the
    process); its leaves are views into it.  ``clear_population_cache``
    unregisters the buffers."""

    _ALIGN = 64

    def __init__(self, pstate: PopState, count: int):
        self.count = int(count)
        self.pin = pstate["diverged"].is_cuda
        leaves = tree_leaves(pstate)
        self.slot_bytes = sum(-(-t[0].numel() * t.element_size() // self._ALIGN) * self._ALIGN
                              for t in leaves)
        self.free: list = []
        self.held: Dict[int, Tuple[PopState, torch.Tensor]] = {}   # id(tree) -> slot
        self.buffers: list = []
        self.pinned_bytes = 0
        self.lock = threading.Lock()

    def _make(self, pstate: PopState) -> Tuple[PopState, torch.Tensor]:
        flat = torch.empty(self.slot_bytes, dtype=torch.uint8)
        if self.pin:
            err = torch.cuda.cudart().cudaHostRegister(flat.data_ptr(), self.slot_bytes, 0)
            if int(err) != 0:
                raise RuntimeError(f"cudaHostRegister of a {self.slot_bytes}-byte lane "
                                   f"snapshot slot failed (error {int(err)})")
            self.pinned_bytes += self.slot_bytes
        offset = [0]

        def view(leaf):
            n = leaf[0].numel() * leaf.element_size()
            out = flat[offset[0]: offset[0] + n].view(leaf.dtype).view(leaf.shape[1:])
            offset[0] += -(-n // self._ALIGN) * self._ALIGN
            return out

        self.buffers.append(flat)
        return tree_map(view, _lane_tree(pstate)), flat

    def take(self, pstate: PopState) -> Optional[PopState]:
        """A free slot's tree, a new slot's while fewer than ``count``
        exist, else None (every slot is held)."""
        with self.lock:
            if self.free:
                slot = self.free.pop()
            elif len(self.buffers) < self.count:
                slot = self._make(pstate)
            else:
                return None
            self.held[id(slot[0])] = slot
            return slot[0]

    def flat_of(self, snap: PopState) -> torch.Tensor:
        """The flat host buffer a held slot's tree views."""
        with self.lock:
            return self.held[id(snap)][1]

    def release(self, snap: PopState) -> bool:
        with self.lock:
            slot = self.held.pop(id(snap), None)
            if slot is not None:
                self.free.append(slot)
            return slot is not None

    def stats(self) -> Dict[str, int]:
        with self.lock:
            return {"slots": len(self.buffers), "max_slots": self.count,
                    "held": len(self.held), "slot_bytes": self.slot_bytes,
                    "pinned_bytes": self.pinned_bytes}

    def unregister(self) -> None:
        with self.lock:
            if self.pin:
                for flat in self.buffers:
                    torch.cuda.cudart().cudaHostUnregister(flat.data_ptr())
            self.pinned_bytes = 0
            self.pin = False


_SLOTS: Dict[Tuple, _LaneSlots] = {}


def _lane_slots(pstate: PopState, count: Optional[int] = None) -> _LaneSlots:
    """The snapshot slots of this state's geometry: its device, K and the
    shapes and dtypes of its leaves; ``count`` (default K + 1) bounds them
    when the geometry's first slots are made (a mesh's rank 0 holds the
    snapshots of every rank's lanes)."""
    leaves = tree_leaves(pstate)
    key = (_device_key(leaves[0].device),) + tuple((tuple(t.shape), str(t.dtype))
                                                   for t in leaves)
    with _POP_CACHE_LOCK:
        slots = _SLOTS.get(key)
        if slots is None:
            slots = _SLOTS[key] = _LaneSlots(
                pstate, pstate["diverged"].shape[0] + 1 if count is None else count)
    return slots


def make_lane_snapshot(tc: TrainConfig) -> Callable:
    """``(pstate, lane) -> snap`` harvesting one lane's whole state to the host.

    The snapshot is the lane's ``inner`` leaves (parameters, AdamW moments,
    step counter), its divergence latch and its ``last_loss``, as CPU tensors
    without the lane axis, the JAX package's snapshot tree.  Each leaf's lane
    view is copied straight from the device into its host tensor, so nothing
    is gathered or staged on the device, and the state is only read: the
    flight trains on after a harvest.  The host tensors are a slot of the
    geometry's K + 1 (page-locked from a card), or fresh pageable ones while
    every slot is held; ``release_lane_snapshot`` hands a superseded
    snapshot's slot back.  On an H100 a lane crossed at 2.2-2.5 GB/s into
    pageable memory and at the link's ~55 GB/s into a page-locked slot
    (``PERF.md``)."""

    def snapshot(pstate: PopState, lane) -> PopState:
        lane = int(lane)
        out = _lane_slots(pstate).take(pstate)
        if out is None:
            return tree_map(lambda leaf: leaf[lane].to("cpu", copy=True), _lane_tree(pstate))
        tree_map(lambda dst, leaf: dst.copy_(leaf[lane]), out, _lane_tree(pstate))
        return out

    return snapshot


def release_lane_snapshot(snap: Optional[PopState]) -> None:
    """Hand a snapshot's host slot back for the next harvest, once nothing
    reads it any more (a store replaced or dropped it).  A snapshot that is
    no slot (fresh host tensors, or read from disk) is left to the garbage
    collector."""
    if snap is None:
        return
    with _POP_CACHE_LOCK:
        pools = list(_SLOTS.values())
    for slots in pools:
        if slots.release(snap):
            return


def lane_snapshot_slot_stats() -> list:
    """Per geometry with snapshot slots: the slots made and their bound
    (K + 1), the slots a store holds, a slot's bytes, the page-locked bytes."""
    with _POP_CACHE_LOCK:
        pools = list(_SLOTS.values())
    return [slots.stats() for slots in pools]


def make_lane_restore(tc: TrainConfig) -> Callable:
    """``(pstate, lane, snap) -> pstate`` writing a harvested snapshot
    (``make_lane_snapshot``) into lane ``lane``, in place.

    Every leaf of the lane takes the snapshot's, its optimizer step counter,
    divergence latch and ``last_loss`` included, so the restored lane is the
    harvested one bit for bit; a snapshot of lane i of a dead flight may land
    in any lane j of a new one.  Each leaf is copied from the host straight
    into its lane view (a leaf of another dtype is cast, as JAX's ``astype``),
    so a captured chunk graph stays valid and nothing is staged on the
    device."""

    def restore(pstate: PopState, lane, snap) -> PopState:
        lane = int(lane)
        tree_map(lambda dst, src: dst[lane].copy_(src), pstate["inner"], snap["inner"])
        pstate["diverged"][lane].copy_(torch.as_tensor(snap["diverged"]))
        pstate["last_loss"][lane].copy_(torch.as_tensor(snap["last_loss"]))
        return pstate

    return restore


def make_lane_regrid(tc: TrainConfig) -> Callable:
    """``(pstate, survivors, out=None) -> pstate'``: the lanes ``survivors``
    (ascending; padded by the caller, ``regrid_indices``) gathered into a
    compact population of ``len(survivors)`` lanes.

    At a rung boundary the cut lanes are dead weight: the regrid takes the
    survivors' whole state (parameters, AdamW moments, step counter,
    divergence latch and ``last_loss``) with an ``index_select`` on the lane
    axis of every leaf, so lane j of the result is lane ``survivors[j]``
    bit for bit.  It reads its input and never changes or aliases it (the
    lane count differs, so nothing is reused in place); with ``out`` (a
    population state of the new geometry, e.g. the state its chunk graphs
    captured) it writes into ``out``'s tensors instead of new ones."""

    def regrid(pstate: PopState, survivors, out: Optional[PopState] = None) -> PopState:
        dev = pstate["diverged"].device
        idx = torch.as_tensor([int(i) for i in survivors], dtype=torch.long, device=dev)
        if out is None:
            return tree_map(lambda x: x.index_select(0, idx), pstate)
        _check_apart(pstate, out)
        tree_map(lambda dst, x: torch.index_select(x, 0, idx, out=dst), out, pstate)
        return out

    return regrid


def _check_apart(src: PopState, out: PopState) -> None:
    """Raise if ``out`` shares a tensor's storage with ``src``."""
    mine = {t.untyped_storage().data_ptr() for t in tree_leaves(src)}
    if any(t.untyped_storage().data_ptr() in mine for t in tree_leaves(out)):
        raise ValueError("regrid: out shares storage with the state it reads")


def regrid_indices(survivors: Sequence[int], pad_to: Optional[int] = None) -> list:
    """``survivors`` padded to ``pad_to`` lanes by repeating the first
    survivor (the JAX package's padding: a pad lane is a copy the caller
    freezes with a 0-step budget)."""
    idx = [int(i) for i in survivors]
    k2 = max(int(pad_to) if pad_to else len(idx), 1)
    return (idx + [idx[0] if idx else 0] * k2)[:k2]


def plan_regrid(n_devices: int, n_survivors: int) -> Tuple[int, int, int]:
    """``(rows, width, lanes)`` for S survivors over N ranks (the JAX
    package's arithmetic): ``rows`` is the largest divisor of N that lays
    the survivors out contiguously (``ceil(S / rows)`` lanes a row, padding
    at the tail) with **no lane row idle**; ``width = N / rows`` ranks serve
    each row and ``lanes = rows * ceil(S / rows)`` is the padded population
    (pad lanes carry a 0-step budget)."""
    n = max(1, int(n_devices))
    s = max(1, int(n_survivors))
    for rows in sorted((d for d in range(1, n + 1) if n % d == 0), reverse=True):
        per = -(-s // rows)
        if rows <= s and (rows - 1) * per < s:
            return rows, n // rows, rows * per
    return 1, n, s  # unreachable: rows=1 always satisfies the invariant


def regrid_population_state(pstate: PopState, survivors, tc: TrainConfig,
                            pad_to: Optional[int] = None,
                            out: Optional[PopState] = None) -> PopState:
    """Gather ``survivors`` of a whole population state into a compact
    population of ``pad_to`` lanes (default: one a survivor), padded by
    repeating the first survivor (the pads' 0-step budgets are the caller's
    to set).  A regrid changes layout, never math.  ``out`` receives the
    result in place.  A flight on a mesh regrids through the sharded twin
    (``get_lane_op(..., "regrid", mesh=)``)."""
    return make_lane_regrid(tc)(pstate, regrid_indices(survivors, pad_to), out=out)


_LANE_OPS: Dict[str, Callable] = {
    "init": make_lane_init,
    "clone": make_lane_clone,
    "splice": make_lane_splice,
    "snapshot": make_lane_snapshot,
    "restore": make_lane_restore,
    "regrid": make_lane_regrid,
}


def get_lane_op(tc: TrainConfig, population: int, kind: str, mesh=None) -> Callable:
    """The lane op ``kind`` (``init`` / ``clone`` / ``splice`` / ``snapshot`` /
    ``restore`` / ``regrid``) for a population of ``population`` lanes; with
    ``mesh`` its sharded twin (``make_sharded_lane_*``), which every rank
    calls with global lane ids.  The ops are eager in-place writes (or, for
    a snapshot, reads; a regrid writes a new state), so there is nothing to
    compile or cache."""
    if kind not in _LANE_OPS:
        raise KeyError(f"unknown lane op {kind!r}; available: {sorted(_LANE_OPS)}")
    if mesh is not None:
        _check_rows(population, mesh)
        return _SHARDED_LANE_OPS[kind](tc, mesh)
    return _LANE_OPS[kind](tc)


def make_population_train_step(tc: TrainConfig, per_trial_batch: bool = False) -> Callable:
    """``(pstate, batch, hp) -> (pstate, metrics)`` over a leading K axis.

    ``hp`` is a stacked HParams (fields (K,)); metrics come back per lane plus
    the ``active`` mask and the ``applied`` mask (active with a finite loss).  With ``per_trial_batch`` the batch leaves carry a
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
        return pstate, dict(metrics, active=active, applied=applied)

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
    step = make_population_train_step(tc, per_trial_batch=per_trial_batch)

    def scan_chunk(pstate: PopState, hp: HParams, steps0, stream_lo, stream_hi):
        per_step = []
        for t in range(int(chunk)):
            batch = _synth(data, per_trial_batch, stream_lo, stream_hi, steps0, t)
            pstate, metrics = step(pstate, batch, hp)
            per_step.append(metrics)
            del batch
        return pstate, _stack(per_step)

    return scan_chunk


def _synth(data, per_trial_batch: bool, stream_lo, stream_hi, steps0, t: int):
    """Step ``t`` of a chunk's batch, made on the device."""
    from ..data.pipeline import synth_batch_device, synth_population_batch_device

    if per_trial_batch:
        return synth_population_batch_device(data, stream_lo, stream_hi, steps0, offset=t)
    return synth_batch_device(data, stream_lo, stream_hi, steps0, offset=t)


def _stack(per_step) -> Dict[str, torch.Tensor]:
    return {n: torch.stack([m[n] for m in per_step]) for n in per_step[0]}


def make_population_ring_scan_step(tc: TrainConfig, data, chunk: int,
                                   capacity: int) -> Callable:
    """``(pstate, hp, ring, slot0) -> (pstate, metrics)``: the chunk fed from
    a prefetch ring (``repro_torch.data.ring.PrefetchRing``) instead of
    in-chunk synthesis.

    ``ring`` is the ring's ``(capacity, K, batch, seq_len+1)`` int32 token
    tensor, one slab a global step, filled from the host ahead of the chunk;
    step ``t`` reads slot ``(slot0 + t) % capacity`` (``slot0``: an int, or a
    0-d integer tensor on the ring's device, the dispatch step's slot) and
    splits it into the batch on the device.  The train step, budget and
    divergence masking included, is the in-chunk synthesis path's, so a ring
    filled from the synthetic stream's host adapter reproduces that path bit
    for bit.  The ring is only read."""
    from ..data.pipeline import tokens_to_batch_device

    step = make_population_train_step(tc, per_trial_batch=True)
    cap = int(capacity)

    def scan_chunk(pstate: PopState, hp: HParams, ring, slot0):
        per_step = []
        for t in range(int(chunk)):
            slot = (slot0 + t) % cap
            slab = ring[slot] if isinstance(slot, int) else ring.index_select(
                0, slot.reshape(1))[0]
            pstate, metrics = step(pstate, tokens_to_batch_device(data, slab), hp)
            per_step.append(metrics)
            del slab
        return pstate, _stack(per_step)

    return scan_chunk


# -- device-side decision rules ---------------------------------------------------
#
# The rung rules and the PBT window quantile as functions of tensors, so a
# chunk carries them step by step (``--device-rules``).  Each takes the rule
# state, the lanes' ``last_loss`` and ``diverged`` after a step and each
# lane's lane-local step count, and returns a new rule state.  None of them
# reads a tensor on the host: ranks come from O(K^2) pairwise counts (ties
# keep the lower lane first, as ``np.argsort(kind="stable")`` does) and
# appends scatter through one extra "dump" slot that is dropped afterwards,
# so they run inside a captured CUDA graph.  Rule state leaves:
#
#   all modes   budgets f32[K] (lane-local), base f32[K] (steps already in
#               the lane's optimizer state: total_steps = base + budgets),
#               local0 i32[K] (each lane's local step at the chunk start)
#   cohort      boundaries f32[B], eta f32[]
#   staggered   + hist f32[B, cap] (per-rung loss history, +inf padded),
#               counts i32[B]
#   pbt         quantile f32[], wscore f32[W] (score ring), wcount i32[],
#               vbottom/vready bool[K], vlo/vhi f32[K]


def cohort_rule_update(rules, losses, diverged, local):
    """The rung rule of a synchronized batch flight
    (``InFlightSuccessiveHalving.__call__``) on tensors.

    ``local`` is the cohort's step (i32[K], all lanes equal).  Off a rung
    boundary it changes nothing; at one, diverged lanes' remaining budgets
    are reclaimed and ranked lanes outside the top ``1/eta`` are truncated to
    the boundary step."""
    budgets, boundaries, eta = rules["budgets"], rules["boundaries"], rules["eta"]
    k = budgets.shape[0]
    idx = torch.arange(k, device=budgets.device)
    sf = local[0].to(torch.float32)
    at = (boundaries == sf).any()
    dead = diverged & (budgets > sf)
    b2 = torch.where(dead, sf, budgets)
    ranked = (b2 >= sf) & (b2 > 0) & ~diverged & torch.isfinite(losses)
    n_ranked = ranked.sum()
    n_keep = torch.ceil(n_ranked.to(torch.float32) / eta).to(torch.int64)
    lower = ((losses[None, :] < losses[:, None]) & ranked[None, :]).sum(1)
    ties = ((losses[None, :] == losses[:, None]) & ranked[None, :]
            & (idx[None, :] < idx[:, None])).sum(1)
    rank = lower + ties
    noop = (n_ranked <= 1) | (n_keep >= n_ranked)
    cut = ranked & (rank >= n_keep) & (b2 > sf) & ~noop
    nb = torch.where(cut, sf, b2)
    return dict(rules, budgets=torch.where(at, nb, budgets))


def staggered_rule_update(rules, losses, diverged, local):
    """The asynchronous rung rule of a refill flight
    (``InFlightSuccessiveHalving.observe``) on tensors.

    ``local`` is each lane's own step (i32[K]).  A live lane (budget > 0,
    not diverged, finite loss, still inside its budget) whose step lands on a
    rung boundary appends its loss to that rung's history and is truncated
    unless it ranks in the top ``1/eta`` of the history including its own
    entry.  Lanes hitting a boundary in the same step append in lane order,
    as the host rule's lane loop does.  The history's capacity must hold
    every append (the driver sizes it to the largest count plus K, rounded
    up to a power of two); a larger capacity changes no output."""
    budgets, boundaries, eta = rules["budgets"], rules["boundaries"], rules["eta"]
    hist, counts = rules["hist"], rules["counts"]
    k = budgets.shape[0]
    n_rungs, cap = hist.shape
    dev = budgets.device
    idx = torch.arange(k, device=dev)
    lf = local.to(torch.float32)
    eq = lf[:, None] == boundaries[None, :]                       # [K, B]
    at = eq.any(1)
    bi = eq.to(torch.int32).argmax(1)
    hit = at & (budgets > 0) & ~diverged & torch.isfinite(losses) & (lf <= budgets)
    j_lt_i = idx[None, :] < idx[:, None]
    same = hit[None, :] & hit[:, None] & (bi[None, :] == bi[:, None])
    n_before = (same & j_lt_i).sum(1)
    cnt = counts.to(torch.int64)[bi]
    new_len = cnt + n_before + 1
    n_keep = torch.ceil(new_len.to(torch.float32) / eta).to(torch.int64)
    col = torch.arange(cap, device=dev)
    rank_hist = ((hist[bi] < losses[:, None]) & (col[None, :] < cnt[:, None])).sum(1)
    rank_same = (same & j_lt_i & (losses[None, :] < losses[:, None])).sum(1)
    cut = hit & (rank_hist + rank_same >= n_keep) & (budgets > lf)
    slot = cnt + n_before
    ok = hit & (slot < cap)
    flat = torch.where(ok, bi.to(torch.int64) * cap + slot,
                       torch.full_like(slot, n_rungs * cap))          # last = dump
    padded = torch.cat([hist.reshape(-1), hist.new_zeros(1)])
    padded = padded.scatter(0, flat, losses.to(hist.dtype))
    new_counts = counts + (ok[:, None] & eq).sum(0).to(counts.dtype)
    return dict(rules, budgets=torch.where(cut, lf, budgets),
                hist=padded[: n_rungs * cap].reshape(n_rungs, cap), counts=new_counts)


def window_quantile(scores, count, quantile):
    """``(lo, hi)`` quantile scores of a sliding window held as a ring of
    length W: the tensor twin of ``core.proposer.pbt.window_quantile``.
    ``count`` is how many appends the ring ever took, so the first
    ``min(count, W)`` slots are valid; ``lo`` is the k-th smallest and ``hi``
    the k-th largest valid score, ``k = max(1, int(quantile * n))``.  Both
    come back as 0-d tensors, without a host sync."""
    w = scores.shape[0]
    n = torch.clamp(count, max=w)
    k = torch.clamp((quantile * n.to(scores.dtype)).to(torch.int64), min=1)
    valid = torch.arange(w, device=scores.device) < n
    inf = torch.full_like(scores, float("inf"))
    asc_lo = torch.sort(torch.where(valid, scores, inf)).values
    asc_hi = torch.sort(torch.where(valid, scores, -inf)).values
    return (asc_lo.gather(0, (k - 1).reshape(1))[0],
            asc_hi.gather(0, (w - k).reshape(1))[0])


def pbt_rule_update(rules, losses, diverged, local):
    """The sliding-window quantile of streaming PBT (``PBTLifecycle``'s
    asynchronous rule) on tensors.

    A lane reaching its round end (``local == budgets``; a diverged lane's
    step count still reaches it) appends its score to the window ring in
    lane order, then latches a verdict: ``vbottom`` (its score at or below
    the window's low quantile), the quantiles ``vlo``/``vhi`` it saw, and
    ``vready``.  The host hands the verdicts to
    ``PBTLifecycle.note_device_verdict``; donor choice and perturbation stay
    on the host (they draw from the proposer's RNG).  Budgets are never
    truncated: PBT rounds end by budget."""
    from ..core.proposer.pbt import DIVERGED_SCORE

    budgets, wscore, wcount = rules["budgets"], rules["wscore"], rules["wcount"]
    k = budgets.shape[0]
    w = wscore.shape[0]
    idx = torch.arange(k, device=budgets.device)
    lf = local.to(torch.float32)
    hit = (budgets > 0) & (lf == budgets)
    score = torch.where(diverged | ~torch.isfinite(losses),
                        torch.full_like(losses, DIVERGED_SCORE), -losses)
    n_before = (hit[None, :] & (idx[None, :] < idx[:, None])).sum(1)
    slot = (wcount.to(torch.int64) + n_before) % w
    flat = torch.where(hit, slot, torch.full_like(slot, w))           # last = dump
    padded = torch.cat([wscore, wscore.new_zeros(1)]).scatter(0, flat, score.to(wscore.dtype))
    new_wscore = padded[:w]
    new_wcount = wcount + hit.sum().to(wcount.dtype)
    lo, hi = window_quantile(new_wscore, new_wcount, rules["quantile"])
    return dict(rules, wscore=new_wscore, wcount=new_wcount,
                vbottom=torch.where(hit, score <= lo, rules["vbottom"]),
                vready=rules["vready"] | hit,
                vlo=torch.where(hit, lo, rules["vlo"]),
                vhi=torch.where(hit, hi, rules["vhi"]))


_RULE_UPDATES: Dict[str, Callable] = {
    "cohort": cohort_rule_update,
    "staggered": staggered_rule_update,
    "pbt": pbt_rule_update,
}


def _f32(x, device):
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _i32(x, device):
    return torch.as_tensor(np.asarray(x, np.int32), device=device)


def cohort_rule_state(budgets, base, local0, boundaries, eta, device="cpu") -> Dict[str, Any]:
    return {"budgets": _f32(budgets, device), "base": _f32(base, device),
            "local0": _i32(local0, device), "boundaries": _f32(boundaries, device),
            "eta": _f32(eta, device)}


def staggered_rule_state(budgets, base, local0, boundaries, eta, hist, counts,
                         device="cpu") -> Dict[str, Any]:
    state = cohort_rule_state(budgets, base, local0, boundaries, eta, device)
    state["hist"] = _f32(hist, device)
    state["counts"] = _i32(counts, device)
    return state


def pbt_rule_state(budgets, base, local0, quantile, wscore, wcount,
                   device="cpu") -> Dict[str, Any]:
    k = len(budgets)
    return {"budgets": _f32(budgets, device), "base": _f32(base, device),
            "local0": _i32(local0, device), "quantile": _f32(quantile, device),
            "wscore": _f32(wscore, device), "wcount": _i32(wcount, device),
            "vbottom": torch.zeros((k,), dtype=torch.bool, device=device),
            "vready": torch.zeros((k,), dtype=torch.bool, device=device),
            "vlo": torch.zeros((k,), dtype=torch.float32, device=device),
            "vhi": torch.zeros((k,), dtype=torch.float32, device=device)}


def make_population_rule_scan_step(tc: TrainConfig, data, chunk: int, mode: str,
                                   per_trial_batch: bool = True,
                                   rule_update: Optional[Callable] = None) -> Callable:
    """``(pstate, hp, steps0, stream_lo, stream_hi, rules)
    -> ((pstate, rules), metrics)``: the chunk with a decision rule.

    As ``make_population_scan_step``, but before each step the lanes' step
    budgets are rebuilt from the carried rule state (``total_steps = base +
    budgets``), and after it ``mode``'s rule update runs on the lanes'
    ``last_loss``, ``diverged`` and lane-local steps (``local0 + t + 1``), so
    a rung cut (or a PBT verdict) lands at exactly the step the host rule
    would apply it.  ``metrics`` gain ``budgets`` (``(chunk, K)``), the log
    the host harvests retirements from; the rule state after the chunk comes
    back beside the population state (a new dict: the input rules are not
    written).  ``rule_update`` replaces ``mode``'s update (the population
    mesh passes its gathering twin, ``_sharded_rule_update``)."""
    step = make_population_train_step(tc, per_trial_batch=per_trial_batch)
    update = rule_update if rule_update is not None else _RULE_UPDATES[mode]

    def scan_chunk(pstate: PopState, hp: HParams, steps0, stream_lo, stream_hi, rules):
        per_step = []
        for t in range(int(chunk)):
            hp_t = dataclasses.replace(hp, total_steps=rules["base"] + rules["budgets"])
            batch = _synth(data, per_trial_batch, stream_lo, stream_hi, steps0, t)
            pstate, metrics = step(pstate, batch, hp_t)
            del batch
            rules = update(rules, pstate["last_loss"], pstate["diverged"],
                           rules["local0"] + (t + 1))
            per_step.append(dict(metrics, budgets=rules["budgets"]))
        return (pstate, rules), _stack(per_step)

    return scan_chunk


# -- the chunk programs on the card: one CUDA graph a chunk size ----------------
#
# A chunk is captured once, from ``chunk`` population steps with their device
# synthesis, and replayed per dispatch.  A graph replays fixed addresses, so
# every graph of one flight geometry (static config, K, batch mode, data
# spec, device) captures the same tensors: the state of the first flight
# that ran it, and static copies of the hyperparameters, the cursor and the
# stream words (a rule chunk also of its rule state, one set per rule mode
# and shapes).  A call copies its inputs into the static copies and
# replays.  All graphs of a geometry share one memory pool; they are keyed
# by (kind, rule mode, chunk, rule shapes).  A failed capture raises: there
# is no eager path on the card.
#
# The captured state has one owner at a time: a flight holds the geometry's
# lease (``flight_lease``) from its init to its scores, and a second flight
# of the same geometry waits for it rather than write into the same tensors.


# Set before a geometry's first capture, each captured graph keeps its nodes'
# types and kernel names (``cudaGraphDebugDotPrint``), which
# ``graph_stats(nodes=True)`` returns:
# what one replay launches, read from the graph itself rather than from a
# profiler trace that may drop kernels.
KEEP_GRAPH_NODES = False


@dataclasses.dataclass
class _Captured:
    graph: Any
    outputs: Any          # what the captured call returned; a replay overwrites it
    capture_s: float
    pool_bytes: int
    nodes: Optional[list] = None   # with KEEP_GRAPH_NODES: each node's DOT label head
    replays: int = 0


def _dot_nodes(graph) -> list:
    """Each node of a graph captured with ``keep_graph`` in debug mode and
    instantiated, as the head of its DOT label: its type and, for a kernel,
    its function's name (``{KERNEL | {ID | 0 | name<<<...``).
    Dumping frees the captured graph (its instantiated form stays and
    replays)."""
    fd, path = tempfile.mkstemp(suffix=".dot")
    os.close(fd)
    try:
        graph.debug_dump(path)
        with open(path) as f:
            text = f.read()
    finally:
        os.remove(path)
    # a node's declaration opens a line with its quoted name and "[";
    # an edge's line goes on with " ->"
    starts = [m.start() for m in re.finditer(r'(?m)^"graph_\d+_node_\d+"\[', text)]
    return [text[a:text.find("}", a) + 1] for a in starts]


def _rule_shapes(rules) -> Tuple:
    return tuple((n, tuple(rules[n].shape)) for n in sorted(rules))


def _scan_key(chunk: int) -> Tuple:
    return ("scan", "", int(chunk), ())


class _FlightGraphs:
    """The captured state and the graphs of one flight geometry on one card."""

    def __init__(self, tc: TrainConfig, data, per_trial_batch: bool, device, tp=None):
        self.device = device
        self.per_trial_batch = bool(per_trial_batch)
        self.warm_up_step = make_population_scan_step(tc, data, 1, per_trial_batch)
        if tp is not None:
            self.warm_up_step = _tp_body(self.warm_up_step, tc, tp)
        self.state: Optional[PopState] = None
        self.inputs: Optional[Tuple] = None     # (hp, steps0, stream_lo, stream_hi)
        self.rule_inputs: Dict[Tuple, Dict[str, torch.Tensor]] = {}   # (mode, shapes)
        self.rings: Dict[Tuple, torch.Tensor] = {}   # ring shape -> the ring tensor
        self.ring_slot: Optional[torch.Tensor] = None   # a ring chunk's first slot
        self.graphs: Dict[Tuple, _Captured] = {}
        self.pool = None
        self.stream = None
        # held by a flight for its whole run, and by every call: reentrant
        self.lease = threading.RLock()

    def bind(self, pstate: PopState, hp: HParams, steps0=None, stream_lo=None,
             stream_hi=None) -> None:
        """Make the static inputs hold this call's: the first call's state
        becomes the captured state, and later calls must pass that state.  A
        ring chunk passes no cursor or stream words: their static copies then
        start at zeros (the warm-up step reads them) and keep their values."""
        if self.state is None:
            k = pstate["diverged"].shape[0]
            zeros = lambda: torch.zeros((k,) if self.per_trial_batch else (),  # noqa: E731
                                        dtype=torch.int64, device=self.device)
            self.state = pstate
            self.inputs = (HParams(**{f: getattr(hp, f).clone() for f in FIELDS}),) + tuple(
                zeros() if x is None else x.clone() for x in (steps0, stream_lo, stream_hi))
            return
        if pstate is not self.state:
            raise ValueError("this geometry's chunk graphs captured another population "
                             "state: initialise the flight into the state "
                             "flight_lease() yields")
        hp_s, *rest_s = self.inputs
        for f in FIELDS:
            _copy_into(getattr(hp_s, f), getattr(hp, f))
        for dst, x in zip(rest_s, (steps0, stream_lo, stream_hi)):
            if x is not None:
                _copy_into(dst, x)

    def bind_rules(self, mode: str, rules) -> Dict[str, torch.Tensor]:
        """The static copy of a rule state of this mode and these shapes,
        holding ``rules``' values."""
        key = (mode, _rule_shapes(rules))
        static = self.rule_inputs.get(key)
        if static is None:
            static = self.rule_inputs[key] = {n: v.clone() for n, v in rules.items()}
        else:
            for n, v in rules.items():
                _copy_into(static[n], v)
        return static

    def ring(self, shape) -> torch.Tensor:
        """The geometry's ring tensor of this shape, allocated once beside
        the captured state: a ring chunk's graph reads it at a fixed
        address, so every ring-fed flight of the geometry fills this one."""
        shape = tuple(int(n) for n in shape)
        with self.lease:
            buf = self.rings.get(shape)
            if buf is None:
                buf = self.rings[shape] = torch.zeros(shape, dtype=torch.int32,
                                                      device=self.device)
        return buf

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

    def warm_up_rule(self, update: Callable, rules) -> None:
        """One eager call of the rule update on the capture stream, so its
        first-launch set-up (a mesh's collective among it) happens outside
        the capture (it writes no state: the update returns a new rule
        state)."""
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            update(rules, self.state["last_loss"], self.state["diverged"], rules["local0"] + 1)
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        torch.cuda.synchronize(self.device)

    def ensure_stream(self) -> None:
        """The capture stream and the graph pool, made (with the warm-up
        step) before the geometry's first capture."""
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
            self.pool = torch.cuda.graph_pool_handle()
            self.warm_up()

    def capture(self, key: Tuple, call: Callable[[], Any]) -> _Captured:
        """Capture ``call()`` (a chunk program applied to the captured state
        and static inputs) as the graph ``key``."""
        self.ensure_stream()
        torch.cuda.synchronize(self.device)
        gc.collect()
        torch.cuda.empty_cache()   # the eager blocks go back before the pool grows
        before = torch.cuda.memory_reserved(self.device)
        leaves = tree_leaves(self.state)
        graph = torch.cuda.CUDAGraph(keep_graph=KEEP_GRAPH_NODES)
        if KEEP_GRAPH_NODES:
            graph.enable_debug_mode()
        t0 = time.perf_counter()
        # thread_local: a prefetch ring's fill thread keeps copying on its own
        # stream while this thread captures; only this thread's calls are
        # held to the capture's rules
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            outputs = call()
        if KEEP_GRAPH_NODES:
            graph.instantiate()   # a kept graph is not instantiated at the capture's end
        torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - t0
        if any(a is not b for a, b in zip(leaves, tree_leaves(self.state))):
            raise RuntimeError("population step rebound a state tensor under capture: "
                               "a captured graph only updates tensors in place")
        got = _Captured(graph, outputs, seconds,
                        torch.cuda.memory_reserved(self.device) - before,
                        _dot_nodes(graph) if KEEP_GRAPH_NODES else None)
        self.graphs[key] = got
        return got

    def run(self, fn: Callable, chunk: int, pstate, hp, steps0, stream_lo, stream_hi):
        with self.lease:
            self.bind(pstate, hp, steps0, stream_lo, stream_hi)
            key = _scan_key(chunk)
            got = self.graphs.get(key) or self.capture(
                key, lambda: fn(self.state, *self.inputs))
            got.graph.replay()
            got.replays += 1
            return self.state, got.outputs[1]

    def run_rules(self, fn: Callable, mode: str, update: Callable, chunk: int, pstate, hp,
                  steps0, stream_lo, stream_hi, rules):
        """A rule chunk: as ``run``, the rule state bound too.  ``mode``
        keys the graph (a mesh's rule chunk carries its tag), ``update`` is
        the rule update the chunk runs.  The rule state and metrics it
        returns are the graph's outputs, which the next replay of this graph
        overwrites."""
        with self.lease:
            self.bind(pstate, hp, steps0, stream_lo, stream_hi)
            static = self.bind_rules(mode, rules)
            key = ("rulescan", mode, int(chunk), _rule_shapes(static))
            got = self.graphs.get(key)
            if got is None:
                self.ensure_stream()
                self.warm_up_rule(update, static)
                got = self.capture(key, lambda: fn(self.state, *self.inputs, static))
            got.graph.replay()
            got.replays += 1
            (_, rules_out), metrics = got.outputs
            return (self.state, rules_out), metrics

    def run_ring(self, fn: Callable, chunk: int, pstate, hp, ring, slot0):
        """A ring chunk: as ``run``, reading the geometry's ring tensor (the
        one ``ring(shape)`` hands out) from slot ``slot0``."""
        with self.lease:
            if self.rings.get(tuple(ring.shape)) is not ring:
                raise ValueError("a ring chunk's graph reads the geometry's ring tensor: "
                                 "fill the one population.ring_buffer() hands out")
            self.bind(pstate, hp)
            if self.ring_slot is None:
                self.ring_slot = torch.zeros((), dtype=torch.int64, device=self.device)
            self.ring_slot.fill_(int(slot0))
            key = ("ringscan", "", int(chunk), (("ring", tuple(ring.shape)),))
            got = self.graphs.get(key) or self.capture(
                key, lambda: fn(self.state, self.inputs[0], ring, self.ring_slot))
            got.graph.replay()
            got.replays += 1
            return self.state, got.outputs[1]


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


def _graphs_key(tc: TrainConfig, population: int, per_trial_batch: bool, data, device,
                tp=None) -> Tuple:
    """The key of a geometry's graphs on ``device``: ``tp`` (a two-level
    mesh) keys a model rank's shards apart from a whole lane's, and the
    lanes the RMSNorm backward plans a launch of ``population`` lanes for
    (``rmsnorm.lanes_for``) key the plan a graph baked in at its capture
    (an elastic flight's survivors keep the plan of its first K)."""
    from ..kernels import rmsnorm

    return _geometry(tc, population, per_trial_batch, data) + (
        _device_key(device), ("rmsnorm_bwd_lanes", rmsnorm.lanes_for(population))) + (
        () if tp is None else tp.key)


def _flight_graphs(tc: TrainConfig, population: int, per_trial_batch: bool, data,
                   device, tp=None) -> _FlightGraphs:
    """The graphs of a geometry on ``device`` (keyed by ``_graphs_key``)."""
    key = _graphs_key(tc, population, per_trial_batch, data, device, tp)
    with _POP_CACHE_LOCK:
        fg = _GRAPHS.get(key)
        if fg is None:
            fg = _GRAPHS[key] = _FlightGraphs(tc, data, bool(per_trial_batch), device, tp)
    return fg


class _ChunkProgram:
    """One entry of the chunk-program cache: ``chunk`` population steps for
    one flight geometry.  A CPU state runs the plain T-step loop; a CUDA
    state replays the chunk's captured graph.

    With ``tp`` (a two-level mesh) the chunk is a model rank's: its steps
    run under the seams (``_tp_body``).  gloo's collectives run on the host
    and cannot sit in a captured graph, so over gloo such a chunk runs
    eagerly on the card (``eager``); over NCCL it is captured."""

    def __init__(self, tc: TrainConfig, data, population: int, chunk: int,
                 per_trial_batch: bool, tp=None):
        self.fn = make_population_scan_step(tc, data, chunk, per_trial_batch)
        self.chunk = int(chunk)
        self._geometry = (tc, int(population), bool(per_trial_batch), data)
        self.tp = tp
        self.eager = tp is not None and tp.backend != "nccl"
        self._armed_fn = None

    def _armed(self) -> Callable:
        """``fn``, under the seams for a model rank."""
        if self.tp is None:
            return self.fn
        if self._armed_fn is None:
            self._armed_fn = _tp_body(self.fn, self._geometry[0], self.tp)
        return self._armed_fn

    def _graphs(self, dev) -> _FlightGraphs:
        return _flight_graphs(*self._geometry, dev, self.tp)

    def __call__(self, pstate: PopState, hp: HParams, steps0, stream_lo, stream_hi):
        dev = pstate["diverged"].device
        if dev.type == "cpu" or (dev.type == "cuda" and self.eager):
            return self._armed()(pstate, hp, steps0, stream_lo, stream_hi)
        if dev.type == "cuda":
            return self._graphs(dev).run(
                self._armed(), self.chunk, pstate, hp, steps0, stream_lo, stream_hi)
        raise ValueError(f"chunk program: no path for device {dev}")


class _RuleChunkProgram(_ChunkProgram):
    """A chunk program with the decision rule ``mode`` carried through it
    (``make_population_rule_scan_step``); called with the rule state as a
    sixth argument, it returns ``((pstate, rules), metrics)``.

    With ``mesh`` it is one rank's block of a sharded rule chunk: the rule
    update gathers the lanes' vectors every step (``_sharded_rule_update``),
    and on a two-level mesh the steps run under the seams.  Under NCCL the
    collectives are captured in the chunk's graph; gloo's run on the host
    and cannot be captured, so a gloo rank on a card runs the chunk eagerly
    (``eager`` is then True)."""

    def __init__(self, tc: TrainConfig, data, population: int, chunk: int, mode: str,
                 per_trial_batch: bool, mesh=None):
        super().__init__(tc, data, population, chunk, per_trial_batch,
                         tp=mesh if mesh is not None and mesh.width > 1 else None)
        self.update = (_RULE_UPDATES[mode] if mesh is None
                       else _sharded_rule_update(mode, mesh))
        self.fn = make_population_rule_scan_step(tc, data, chunk, mode, per_trial_batch,
                                                 rule_update=self.update)
        self.mode = str(mode) if mesh is None else (
            f"{mode}@{mesh.backend}{mesh.world_size}"
            + (f"x{mesh.width}" if mesh.width > 1 else ""))
        self.eager = mesh is not None and mesh.backend != "nccl"

    def __call__(self, pstate: PopState, hp: HParams, steps0, stream_lo, stream_hi, rules):
        dev = pstate["diverged"].device
        if dev.type == "cpu" or (dev.type == "cuda" and self.eager):
            return self._armed()(pstate, hp, steps0, stream_lo, stream_hi, rules)
        if dev.type == "cuda":
            return self._graphs(dev).run_rules(
                self._armed(), self.mode, self.update, self.chunk, pstate, hp, steps0,
                stream_lo, stream_hi, rules)
        raise ValueError(f"rule chunk program: no path for device {dev}")


class _RingChunkProgram(_ChunkProgram):
    """A chunk program fed from a prefetch ring of ``capacity`` slots
    (``make_population_ring_scan_step``); called as ``(pstate, hp, ring,
    slot0)``.  On the card ``ring`` must be the geometry's ring tensor
    (``ring_buffer``), the one its graphs read."""

    def __init__(self, tc: TrainConfig, data, population: int, chunk: int, capacity: int,
                 tp=None):
        super().__init__(tc, data, population, chunk, True, tp=tp)
        self.fn = make_population_ring_scan_step(tc, data, chunk, capacity)

    def __call__(self, pstate: PopState, hp: HParams, ring, slot0):
        dev = pstate["diverged"].device
        if dev.type == "cpu" or (dev.type == "cuda" and self.eager):
            return self._armed()(pstate, hp, ring, int(slot0))
        if dev.type == "cuda":
            return self._graphs(dev).run_ring(
                self._armed(), self.chunk, pstate, hp, ring, slot0)
        raise ValueError(f"ring chunk program: no path for device {dev}")


# -- program caches -------------------------------------------------------------
#
# One chunk program per (static config, population size, batch mode, "scan",
# chunk, data spec) -- the JAX package's key -- and one rule chunk program per
# (..., "rulescan", mode, chunk, data spec); the captured graphs of the
# programs of one geometry live in ``_GRAPHS``, one entry per card.

_POP_CACHE: Dict[Tuple, Any] = {}
_GRAPHS: Dict[Tuple, _FlightGraphs] = {}
_POP_CACHE_LOCK = threading.Lock()


def get_compiled_population_scan_step(tc: TrainConfig, population: int, data, chunk: int,
                                      per_trial_batch: bool = True, mesh=None):
    """Memoized chunk program (see ``make_population_scan_step`` for its
    call).  Drivers dispatch power-of-two chunk sizes, so an experiment makes
    at most ``log2(chunk_steps) + 1`` programs per geometry.
    ``clear_population_cache()`` drops them and their graphs.  With ``mesh``
    it is the sharded twin of JAX's ``make_sharded_population_scan_step``:
    this rank's block program, its metrics gathered whole."""
    if mesh is not None:
        _check_rows(population, mesh)
        blk = mesh.block_size(population)
        if mesh.width == 1:
            return _ShardedProgram(get_compiled_population_scan_step(
                tc, blk, data, chunk, per_trial_batch), mesh)
        key = _geometry(tc, blk, per_trial_batch, data) + (int(chunk), "tp", mesh.key)
        with _POP_CACHE_LOCK:
            fn = _POP_CACHE.get(key)
            if fn is None:
                fn = _POP_CACHE[key] = _ShardedProgram(
                    _ChunkProgram(tc, data, blk, chunk, per_trial_batch, tp=mesh), mesh)
        return fn
    g = _geometry(tc, population, per_trial_batch, data)
    key = g[:-1] + (int(chunk), g[-1])
    with _POP_CACHE_LOCK:
        fn = _POP_CACHE.get(key)
        if fn is None:
            fn = _POP_CACHE[key] = _ChunkProgram(tc, data, population, chunk,
                                                 per_trial_batch)
    return fn


def get_compiled_population_rule_scan_step(tc: TrainConfig, population: int, data,
                                           chunk: int, mode: str,
                                           per_trial_batch: bool = True, mesh=None):
    """Memoized rule chunk program (see ``make_population_rule_scan_step``
    for its call).  On the card its graphs join the geometry's chunk graphs:
    the same captured state and pool, one graph per (mode, chunk, rule
    shapes), so drivers keep the staggered history's capacity at a power of
    two.  With ``mesh`` it is the sharded twin of JAX's
    ``make_sharded_population_rule_scan_step``: training stays per block,
    but each step gathers the K-length loss, latch and budget vectors and
    every rank evaluates the same rule (``_sharded_rule_update``), so the
    cut set is the vmapped engine's.  Called with this rank's block of the
    rule state (``shard_rule_state``); the rule state's lane vectors and the
    metrics come back whole."""
    if mesh is not None:
        _check_rows(population, mesh)
        blk = mesh.block_size(population)
        g = _geometry(tc, blk, per_trial_batch, data)
        key = g[:3] + ("rulescan", str(mode), int(chunk), g[-1], mesh.key)
        with _POP_CACHE_LOCK:
            fn = _POP_CACHE.get(key)
            if fn is None:
                fn = _POP_CACHE[key] = _ShardedRuleProgram(
                    _RuleChunkProgram(tc, data, blk, chunk, mode, per_trial_batch, mesh),
                    mesh, mode)
        return fn
    g = _geometry(tc, population, per_trial_batch, data)
    key = g[:3] + ("rulescan", str(mode), int(chunk), g[-1])
    with _POP_CACHE_LOCK:
        fn = _POP_CACHE.get(key)
        if fn is None:
            fn = _POP_CACHE[key] = _RuleChunkProgram(tc, data, population, chunk, mode,
                                                     per_trial_batch)
    return fn


def get_compiled_population_ring_scan_step(tc: TrainConfig, population: int, data,
                                           chunk: int, capacity: int, mesh=None):
    """Memoized ring chunk program (see ``make_population_ring_scan_step``
    for its call), keyed like the chunk programs plus the ring's capacity
    (the slot modulus is part of the program).  On the card its graphs join
    the geometry's chunk graphs: the same captured state and pool, one graph
    per (chunk, ring shape).  With ``mesh`` it is the sharded twin
    of JAX's ``make_sharded_population_ring_scan_step``: this rank's block program
    reads this rank's ring, which holds only its block's slabs."""
    if mesh is not None:
        _check_rows(population, mesh)
        blk = mesh.block_size(population)
        if mesh.width == 1:
            return _ShardedProgram(get_compiled_population_ring_scan_step(
                tc, blk, data, chunk, capacity), mesh)
        key = _geometry(tc, blk, True, data) + ("ringscan", int(chunk), int(capacity), "tp",
                                                 mesh.key)
        with _POP_CACHE_LOCK:
            fn = _POP_CACHE.get(key)
            if fn is None:
                fn = _POP_CACHE[key] = _ShardedProgram(
                    _RingChunkProgram(tc, data, blk, chunk, capacity, tp=mesh), mesh)
        return fn
    g = _geometry(tc, population, True, data)
    key = g[:3] + ("ringscan", int(chunk), int(capacity), g[-1])
    with _POP_CACHE_LOCK:
        fn = _POP_CACHE.get(key)
        if fn is None:
            fn = _POP_CACHE[key] = _RingChunkProgram(tc, data, population, chunk, capacity)
    return fn


def ring_buffer(tc: TrainConfig, population: int, data, capacity: int,
                device, tp=None) -> torch.Tensor:
    """The ``(capacity, K, batch, seq_len+1)`` int32 ring tensor of this
    geometry on the card, allocated once beside the captured state: a ring
    chunk's graph reads it at a fixed address, so a ring-fed flight fills
    this tensor (``PrefetchRing(..., buffer=)``) while it holds the lease."""
    shape = (int(capacity), int(population), int(data.global_batch), int(data.seq_len) + 1)
    return _flight_graphs(tc, population, True, data, device, tp).ring(shape)


@contextlib.contextmanager
def flight_lease(tc: TrainConfig, population: int, data, per_trial_batch: bool, device,
                 tp=None):
    """Own this geometry's captured state on ``device`` for one flight.

    Yields the state the chunk graphs captured, or None before the first
    capture (the flight's own state then becomes the captured one).  A new
    flight initialises into the yielded state (``init_population_state(...,
    out=)``) instead of holding a second copy beside it.  A second flight of
    the same geometry waits here until the first has left; a call of the
    geometry's chunk programs from another thread waits too."""
    fg = _flight_graphs(tc, population, per_trial_batch, data, device, tp)
    with fg.lease:
        yield fg.state


def drop_flight_graphs(tc: TrainConfig, population: int, data, per_trial_batch: bool, device,
                       tp=None) -> list:
    """Forget this geometry's captured state, its graphs and its ring
    tensors (an elastic flight leaving the geometry for a smaller one: the
    state is freed once nothing else holds it).  Returns the dropped
    graphs' ``graph_stats`` with their nodes."""
    key = _graphs_key(tc, population, per_trial_batch, data, device, tp)
    with _POP_CACHE_LOCK:
        fg = _GRAPHS.pop(key, None)
    return [] if fg is None else _stats(fg, nodes=True)


def _stats(fg: _FlightGraphs, nodes: bool) -> list:
    lanes = None if fg.state is None else int(fg.state["diverged"].shape[0])
    return [dict({"kind": kind, "mode": mode or None, "chunk": c,
                  "shape": {n: list(sh) for n, sh in shapes} or None, "lanes": lanes,
                  "capture_s": g.capture_s, "pool_bytes": g.pool_bytes},
                 **({"nodes": g.nodes, "replays": g.replays} if nodes else {}))
            for (kind, mode, c, shapes), g in sorted(fg.graphs.items())]


def graph_stats(nodes: bool = False) -> list:
    """Per captured chunk graph: its kind (``scan``, ``rulescan`` or
    ``ringscan``), rule mode, chunk size and rule (or ring) shapes, the
    lanes of its geometry (a rank's block), its capture seconds and the
    bytes its capture added to the geometry's memory pool (what stays as
    it was captured); with ``nodes``, also what it ran: the head of each of
    its nodes' DOT labels (None unless ``KEEP_GRAPH_NODES`` was set when it
    was captured) and its replays so far."""
    with _POP_CACHE_LOCK:
        groups = list(_GRAPHS.values())
    return [st for fg in groups for st in _stats(fg, nodes)]


def clear_population_cache() -> None:
    """Drop the chunk programs, their graphs and captured states, and the
    lane snapshot slots (their host buffers unregistered)."""
    with _POP_CACHE_LOCK:
        _POP_CACHE.clear()
        _GRAPHS.clear()
        pools = list(_SLOTS.values())
        _SLOTS.clear()
    for slots in pools:
        slots.unregister()


# -- the population mesh (``--shard-population``) ------------------------------------
#
# K lanes split into contiguous blocks of K/rows over the lane rows of a
# ``distributed.sharding.PopulationMesh``.  Each rank holds its row's block
# of the population state and trains it with the lane-batched step; every
# sharded function below is called by every rank (SPMD), each passing its
# own block of every lane-axis argument, as the body of the JAX package's
# ``shard_map`` sees it.  What comes back whole is what the JAX twin returns
# partitioned on the population axis: the per-lane metrics and the rule
# state's lane vectors, gathered over the pop group with one ``all_gather``
# of their raw bytes (never of the train state).  Lane ops take global lane
# ids: a lane's row applies them, and a clone whose donor lives on another
# row has the donor lane sent to the target's row.
#
# On a two-level mesh (width W > 1) each rank of a row holds only its model
# position's shard of the leaves the width rules shard (``TPLayout``), its
# steps run under the seams (``_tp_body``), and a lane crosses rows as W
# point-to-point sends, shard j to shard j.  A snapshot gathers a lane's W
# shards to the whole host layout, so it restores onto any width.  A regrid
# re-lays the survivors onto a mesh of another width over the same ranks:
# each rank receives the pieces of the lanes and shards it will own.

_RULE_LANE_KEYS: Dict[str, frozenset] = {
    "cohort": frozenset({"budgets", "base", "local0"}),
    "staggered": frozenset({"budgets", "base", "local0"}),
    "pbt": frozenset({"budgets", "base", "local0", "vbottom", "vready", "vlo", "vhi"}),
}


def _state_logical_specs(tc: TrainConfig) -> Dict[str, Any]:
    return {"inner": ts.train_state_specs(tc), "diverged": (), "last_loss": ()}


def _tp_rules_or_raise(tc: TrainConfig, width: int, replicate: bool = False):
    """The width rules; a width that shards nothing raises, unless the mesh
    may ``replicate`` its rows (an elastic regrid's: every rank of a row
    then holds and computes whole lanes, with no seam armed)."""
    from ..distributed.sharding import tp_width_rules

    rules = tp_width_rules(tc.model, width)
    if not rules and not replicate:
        m = tc.model
        raise ValueError(
            f"model-parallel width {width} shards nothing of {m.name} (heads={m.n_heads}, "
            f"kv={m.n_kv_heads}, ff={m.d_ff}, moe={m.has_moe}) — pure replication "
            f"contradicts --model-parallel; pick a width dividing the module dims")
    return rules


def _tp_body(fn: Callable, tc: TrainConfig, mesh) -> Callable:
    """``fn`` (a block program of a model rank) run with the seams armed:
    the module flags pick which seams fire, and the gradient-norm mask tells
    ``optim.adamw.global_norm`` which leaves are width-sharded."""
    from ..distributed.sharding import tp_gnorm_mask, tp_module_flags, tp_shard_context

    flags = tp_module_flags(tc.model, mesh.width)
    mask = tp_gnorm_mask(ts.train_state_specs(tc)["params"],
                         _tp_rules_or_raise(tc, mesh.width, mesh.replicate_rows))

    def wrapped(*args):
        with tp_shard_context(mesh, flags, gnorm_mask=mask):
            return fn(*args)

    return wrapped


class TPLayout:
    """Where a population state's leaves split over a two-level mesh's lane
    row: ``dims`` mirrors the state, holding per leaf the axis (the lane
    axis counted) that ``tp_width_rules`` shards, or None (replicated);
    ``index`` is the model position whose shard this rank holds.  With
    ``replicate`` a width that shards nothing holds every leaf whole."""

    def __init__(self, tc: TrainConfig, width: int, index: int, replicate: bool = False):
        from ..distributed.sharding import map_specs

        rules = _tp_rules_or_raise(tc, int(width), replicate)
        specs = _state_logical_specs(tc)
        self.width, self.index = int(width), int(index)
        self.dims = map_specs(specs, specs, lambda _, logical: next(
            (1 + i for i, n in enumerate(logical) if n in rules), None))

    def _take(self, x: torch.Tensor, dim: Optional[int], index: Optional[int] = None):
        if dim is None:
            return x
        n = x.shape[dim] // self.width
        return x.narrow(dim, (self.index if index is None else int(index)) * n, n)

    def state(self, pstate: PopState) -> PopState:
        """Views of this rank's shard of a whole population state."""
        return tree_map(self._take, pstate, self.dims)

    def lane(self, tree: PopState, index: Optional[int] = None) -> PopState:
        """A lane tree's (a snapshot's, no lane axis) shard ``index``."""
        return tree_map(lambda x, d: self._take(x, None if d is None else d - 1, index),
                        tree, self.dims)

    def inner(self, one) -> Any:
        """One trial's train state (no lane axis), sliced to this shard."""
        return tree_map(lambda x, d: self._take(x, None if d is None else d - 1),
                        one, self.dims["inner"])

    def params(self, params) -> Any:
        """One trial's parameters (no lane axis), sliced to this shard."""
        return tree_map(lambda x, d: self._take(x, None if d is None else d - 1),
                        params, self.dims["inner"]["params"])

    def join(self, shards: Sequence[PopState]) -> PopState:
        """A lane tree whole from its W shards, in model order."""
        return tree_map(lambda d, *xs: xs[0] if d is None else torch.cat(xs, d - 1),
                        self.dims, *shards)


def tp_layout(tc: TrainConfig, mesh) -> Optional[TPLayout]:
    """This rank's ``TPLayout`` on a two-level mesh, None at width 1."""
    if mesh is None or mesh.width == 1:
        return None
    return TPLayout(tc, mesh.width, mesh.model_rank, mesh.replicate_rows)


def pad_population(k: int, mesh=None) -> int:
    """Smallest population size >= k that divides evenly over ``mesh``'s
    lane rows (1 without a mesh; on a two-level mesh the rows, not the
    ranks: a row of W ranks serves one lane block)."""
    n = 1 if mesh is None else mesh.rows
    return ((max(int(k), 1) + n - 1) // n) * n


def _check_rows(population: int, mesh) -> None:
    if int(population) % mesh.rows:
        raise ValueError(
            f"population {population} does not divide over {mesh.rows} lane rows; "
            f"pad to {pad_population(population, mesh)} with 0-budget trials")


def place_two_level(pstate: PopState, tc: TrainConfig, mesh) -> PopState:
    """This rank's part of a whole population state on a two-level mesh:
    its row's block of lanes, and of each leaf the width rules shard its
    model position's shard, copied onto its device."""
    k = pstate["diverged"].shape[0]
    _check_rows(k, mesh)
    block = tree_map(lambda x: mesh.block(x, k), pstate)
    return tree_map(lambda x: x.to(mesh.device, copy=True).contiguous(),
                    tp_layout(tc, mesh).state(block))


def shard_population_state(pstate: PopState, mesh, tc: Optional[TrainConfig] = None
                           ) -> PopState:
    """This rank's block of a global population state, copied onto its
    device (the twin of placing the state on the mesh); on a two-level mesh
    pass ``tc``, and the block holds the rank's shards (``place_two_level``)."""
    if mesh.width > 1:
        if tc is None:
            raise ValueError("a two-level mesh places a state by its width rules: pass tc")
        return place_two_level(pstate, tc, mesh)
    k = pstate["diverged"].shape[0]
    _check_rows(k, mesh)
    return tree_map(lambda x: mesh.block(x, k).to(mesh.device, copy=True), pstate)


def rule_state_specs(rules: Dict[str, Any], mode: str) -> Dict[str, str]:
    """Where each leaf of a ``mode`` rule state lives on the mesh: ``pop``
    (its lane vectors, blocked) or ``rep`` (history, window and rule
    constants, replicated)."""
    return {n: "pop" if n in _RULE_LANE_KEYS[mode] else "rep" for n in rules}


def shard_rule_state(rules: Dict[str, Any], mode: str, mesh, population: int) -> Dict[str, Any]:
    """This rank's view of a global rule state: its block of the lane
    vectors, the replicated leaves whole."""
    specs = rule_state_specs(rules, mode)
    return {n: (mesh.block(v, population) if specs[n] == "pop" else v)
            for n, v in rules.items()}


def _sharded_rule_update(mode: str, mesh) -> Callable:
    """A rule update for a sharded chunk: gather the K-length lane vectors
    (never the train state) over the rows, evaluate the global rule
    identically on every rank, and keep this row's block of the new lane
    vectors.  History, window and constant leaves are replicated, so the
    global evaluation keeps them equal on every rank (a row's ranks hold
    the same losses, so the cut set does not depend on the width)."""
    update = _RULE_UPDATES[mode]
    lane_keys = _RULE_LANE_KEYS[mode]

    def upd(rules, losses, diverged, local):
        blk = losses.shape[0]
        g = mesh.all_gather_lanes({"rules": {n: rules[n] for n in lane_keys},
                                   "losses": losses, "diverged": diverged, "local": local})
        new = update(dict(rules, **g["rules"]), g["losses"], g["diverged"], g["local"])
        lo = mesh.row * blk
        return {n: (v[lo:lo + blk] if n in lane_keys else v) for n, v in new.items()}

    return upd


def make_sharded_population_step(tc: TrainConfig, mesh, per_trial_batch: bool = False
                                 ) -> Callable:
    """``(pstate, batch, hp) -> (pstate, metrics)`` over this rank's block:
    ``pstate``, ``hp`` and (``per_trial_batch``) the batch are the row's
    block, a shared batch is every rank's whole; the metrics come back for
    all K lanes.  On a two-level mesh the state holds the rank's shards and
    the step runs under the seams: each lane row is a width-W
    tensor-parallel program."""
    step = make_population_train_step(tc, per_trial_batch=per_trial_batch)
    if mesh.width > 1:
        step = _tp_body(step, tc, mesh)
    return _ShardedProgram(step, mesh, lane_dim=0)


class _ShardedProgram:
    """A block program (a step, a chunk or a ring chunk of this row's
    K/rows lanes; a compiled chunk replays a graph on the card) whose
    metrics, their lane axis at ``lane_dim``, come back whole."""

    def __init__(self, inner, mesh, lane_dim: int = 1):
        self.inner = inner
        self.mesh = mesh
        self.lane_dim = lane_dim

    def __call__(self, *args):
        pstate, metrics = self.inner(*args)
        return pstate, self.mesh.all_gather_lanes(metrics, dim=self.lane_dim)


class _ShardedRuleProgram:
    """A block rule chunk whose rule state's lane vectors and ``(chunk,
    K/rows)`` metrics come back whole, in one gather (``eager``: a gloo
    rank on a card, whose chunk is not a graph)."""

    def __init__(self, inner, mesh, mode: str):
        self.inner = inner
        self.mesh = mesh
        self.mode = str(mode)
        self.eager = getattr(inner, "eager", False)

    def __call__(self, pstate, hp, steps0, stream_lo, stream_hi, rules):
        (pstate, rules), metrics = self.inner(pstate, hp, steps0, stream_lo, stream_hi, rules)
        lane = {n: rules[n] for n in _RULE_LANE_KEYS[self.mode]}
        g = self.mesh.all_gather_lanes(
            {"rules": lane, "metrics": {n: v.movedim(1, 0) for n, v in metrics.items()}})
        return ((pstate, dict(rules, **g["rules"])),
                {n: v.movedim(0, 1) for n, v in g["metrics"].items()})


def count_model_axis_collectives(call: Callable[[], Any], steps: int = 1) -> int:
    """The model-group collectives one step issues: the count the seams and
    the gradient norm add while ``call()`` runs ``steps`` population steps,
    over ``steps``.  0 at width 1 (nothing is armed), and at width W the
    model's seams (GQA and MLP 2 a layer, MLA and Mamba 4) plus one for the
    norm."""
    from ..distributed.sharding import tp_collectives

    before = tp_collectives()
    call()
    return (tp_collectives() - before) // max(int(steps), 1)


# -- sharded lane ops ---------------------------------------------------------------
#
# A lane crosses ranks as one flat byte buffer in the snapshot slots' layout
# (every leaf's lane row, in tree order, each at a 64-byte aligned offset),
# so what arrives is the lane bit for bit and a snapshot lands straight in a
# host slot.  On a two-level mesh a rank's buffer holds its shard of the
# lane, and it goes to the rank at the same model position of the other row.


def _lane_layout(pstate: PopState):
    """``[(offset, nbytes)]`` of each leaf's lane row in a lane's byte
    buffer, and the buffer's size."""
    out, off = [], 0
    for leaf in tree_leaves(_lane_tree(pstate)):
        n = leaf[0].numel() * leaf.element_size()
        out.append((off, n))
        off += -(-n // _LaneSlots._ALIGN) * _LaneSlots._ALIGN
    return out, off


def _pack_lane(pstate: PopState, lane: int) -> torch.Tensor:
    """Lane ``lane``'s bytes, on the state's device."""
    layout, size = _lane_layout(pstate)
    buf = torch.zeros(size, dtype=torch.uint8, device=pstate["diverged"].device)
    for (off, n), leaf in zip(layout, tree_leaves(_lane_tree(pstate))):
        buf[off:off + n].copy_(leaf[lane].reshape(-1).view(torch.uint8))
    return buf


def _unpack_lane(pstate: PopState, lane: int, buf: torch.Tensor) -> None:
    """Write a lane's bytes (on any device) into lane ``lane``."""
    layout, _ = _lane_layout(pstate)
    for (off, n), leaf in zip(layout, tree_leaves(_lane_tree(pstate))):
        dst = leaf[lane]
        dst.copy_(buf[off:off + n].view(leaf.dtype).view(dst.shape))


def _lane_views(pstate: PopState, flat: torch.Tensor) -> PopState:
    """A lane tree viewing a lane's byte buffer (host or device)."""
    layout, _ = _lane_layout(pstate)
    views = iter(flat[o:o + n] for o, n in layout)
    return tree_map(lambda leaf: next(views).view(leaf.dtype).view(leaf.shape[1:]),
                    _lane_tree(pstate))


def _snap_bytes(pstate: PopState, snap) -> torch.Tensor:
    """A snapshot tree packed into a host lane buffer (each leaf cast to the
    state's dtype, as a restore casts it)."""
    layout, size = _lane_layout(pstate)
    buf = torch.zeros(size, dtype=torch.uint8)
    for (off, n), leaf, src in zip(layout, tree_leaves(_lane_tree(pstate)),
                                   tree_leaves(snap)):
        src = torch.as_tensor(src).to("cpu", leaf.dtype).contiguous().reshape(-1)
        buf[off:off + n].copy_(src.view(torch.uint8))
    return buf


def _owner_of(mesh, pstate: PopState, lane: int) -> Tuple[int, int]:
    """(owning row, lane within its block) of a global lane id."""
    blk = pstate["diverged"].shape[0]
    return int(lane) // blk, int(lane) % blk


def make_sharded_lane_init(tc: TrainConfig, mesh) -> Callable:
    """``(pstate, mask, gens) -> pstate`` over this rank's block: ``mask``
    is bool[K] over the global lanes and ``gens`` one generator per global
    lane (only this row's masked lanes' are read); each row re-inits the
    masked lanes it owns (on a two-level mesh each rank its shards)."""
    layout = tp_layout(tc, mesh)

    def init(pstate: PopState, mask, gens) -> PopState:
        blk = pstate["diverged"].shape[0]
        lo = mesh.row * blk
        lanes = [i - lo for i in _lanes_of(mask) if lo <= i < lo + blk]
        return _reinit_lanes(pstate, lanes, [gens[i + lo] for i in lanes], tc, layout)

    return init


def make_sharded_lane_splice(tc: TrainConfig, mesh) -> Callable:
    """``(pstate, lane, gen) -> pstate``: the row owning global lane
    ``lane`` re-initialises it from ``gen``; the other rows keep their
    blocks bit for bit (their ``gen`` is not read)."""
    layout = tp_layout(tc, mesh)

    def splice(pstate: PopState, lane, gen) -> PopState:
        owner, local = _owner_of(mesh, pstate, lane)
        if owner == mesh.row:
            _reinit_lanes(pstate, [local], [gen], tc, layout)
        return pstate

    return splice


def make_sharded_lane_clone(tc: TrainConfig, mesh) -> Callable:
    """``(pstate, mask, donor_idx) -> pstate`` with global lane ids, so a
    clone may cross rows.

    The donors are known on the host, so each donor lane that a target on
    another row needs is packed on its row and sent to the target's row
    point to point (on a two-level mesh shard j to shard j: W sends);
    nothing is gathered, and the extra memory is the lanes moved.  Every
    donor row is read before any target is written (a chain 0<-1, 1<-2 reads
    the state from before the op), and the bytes copied are the vmapped
    clone's, bit for bit."""

    def clone(pstate: PopState, mask, donor_idx) -> PopState:
        lanes = _lanes_of(mask)
        if not lanes:
            return pstate
        if isinstance(donor_idx, torch.Tensor):
            donor_idx = donor_idx.detach().cpu().numpy()
        me = mesh.row
        dev = pstate["diverged"].device
        local_t, local_d, sends, recvs, landing = [], [], [], [], []
        for t in lanes:
            d = int(donor_idx[t])
            (ot, lt), (od, ld) = _owner_of(mesh, pstate, t), _owner_of(mesh, pstate, d)
            if ot == me and od == me:
                local_t.append(lt)
                local_d.append(ld)
            elif od == me:   # read before any write
                sends.append((_pack_lane(pstate, ld), mesh.rank_at(ot)))
            elif ot == me:
                buf = torch.empty(_lane_layout(pstate)[1], dtype=torch.uint8, device=dev)
                recvs.append((buf, mesh.rank_at(od)))
                landing.append((lt, buf))
        mesh.exchange(sends, recvs)
        if local_t:
            targets = torch.as_tensor(local_t, dtype=torch.long, device=dev)
            donors = torch.as_tensor(local_d, dtype=torch.long, device=dev)
            for leaf in tree_leaves(pstate):
                leaf.index_copy_(0, targets, leaf.index_select(0, donors))
        for lt, buf in landing:
            _unpack_lane(pstate, lt, buf)
        return pstate

    return clone


def make_sharded_lane_snapshot(tc: TrainConfig, mesh) -> Callable:
    """``(pstate, lane) -> snap`` with a global lane id: the owner harvests
    the lane and rank 0 gets it (a lane owned elsewhere is sent to rank 0,
    which receives it straight into a host slot); the other ranks get None.
    Rank 0's slots are bounded by K + 1 of the global population.

    On a two-level mesh each of the owning row's W ranks sends its shard to
    rank 0, which joins them into the lane's whole host layout (fresh host
    tensors), so the snapshot restores onto a flight of any width."""
    snapshot = make_lane_snapshot(tc)
    layout = tp_layout(tc, mesh)

    def sharded(pstate: PopState, lane):
        owner, local = _owner_of(mesh, pstate, lane)
        if layout is not None:
            return _snapshot_shards(pstate, owner, local)
        if owner == 0:
            return snapshot(pstate, local) if mesh.rank == 0 else None
        if mesh.rank == owner:
            mesh.exchange([(_pack_lane(pstate, local), 0)], [])
            return None
        if mesh.rank != 0:
            return None
        k = pstate["diverged"].shape[0] * mesh.world_size
        slots = _lane_slots(pstate, k + 1)
        tree = slots.take(pstate)
        if tree is None:
            flat = torch.empty(_lane_layout(pstate)[1], dtype=torch.uint8)
            tree = _lane_views(pstate, flat)
        else:
            flat = slots.flat_of(tree)
        if mesh.backend == "nccl":
            buf = torch.empty(flat.shape, dtype=torch.uint8, device=pstate["diverged"].device)
            mesh.exchange([], [(buf, owner)])
            flat.copy_(buf)
        else:
            mesh.exchange([], [(flat, owner)])
        return tree

    def _snapshot_shards(pstate: PopState, owner: int, local: int):
        if mesh.row == owner and mesh.rank != 0:
            mesh.exchange([(_pack_lane(pstate, local), 0)], [])
            return None
        if mesh.rank != 0:
            return None
        dev = pstate["diverged"].device
        size = _lane_layout(pstate)[1]
        nccl = mesh.backend == "nccl"
        bufs = [torch.empty(size, dtype=torch.uint8, device=dev if nccl else "cpu")
                for _ in range(mesh.width)]
        recvs = []
        for j, buf in enumerate(bufs):
            if owner == 0 and j == 0:
                buf.copy_(_pack_lane(pstate, local))
            else:
                recvs.append((buf, mesh.rank_at(owner, j)))
        mesh.exchange([], recvs)
        shards = [tree_map(lambda x: x.to("cpu", copy=True), _lane_views(pstate, b))
                  for b in bufs]
        return layout.join(shards)

    return sharded


def make_sharded_lane_restore(tc: TrainConfig, mesh) -> Callable:
    """``(pstate, lane, snap) -> pstate`` with a global lane id and the
    snapshot on rank 0 (other ranks pass None): rank 0 sends it to the
    lane's owner, which writes it into its block; every other block stays
    bit for bit.  On a two-level mesh the snapshot (whole host layout) is
    cut into the owning row's W shards, shard j sent to model rank j."""
    restore = make_lane_restore(tc)
    layout = tp_layout(tc, mesh)

    def sharded(pstate: PopState, lane, snap) -> PopState:
        owner, local = _owner_of(mesh, pstate, lane)
        dev = pstate["diverged"].device
        nccl = mesh.backend == "nccl"
        if layout is not None:
            if mesh.rank == 0:
                sends = []
                for j in range(mesh.width):
                    buf = _snap_bytes(pstate, layout.lane(snap, j))
                    if owner == 0 and j == 0:
                        _unpack_lane(pstate, local, buf)
                    else:
                        sends.append((buf.to(dev) if nccl else buf, mesh.rank_at(owner, j)))
                mesh.exchange(sends, [])
            elif mesh.row == owner:
                buf = torch.empty(_lane_layout(pstate)[1], dtype=torch.uint8,
                                  device=dev if nccl else "cpu")
                mesh.exchange([], [(buf, 0)])
                _unpack_lane(pstate, local, buf)
            return pstate
        if owner == 0:
            return restore(pstate, local, snap) if mesh.rank == 0 else pstate
        if mesh.rank == 0:
            buf = _snap_bytes(pstate, snap)
            mesh.exchange([(buf.to(dev) if nccl else buf, owner)], [])
        elif mesh.rank == owner:
            buf = torch.empty(_lane_layout(pstate)[1], dtype=torch.uint8,
                              device=dev if nccl else "cpu")
            mesh.exchange([], [(buf, 0)])
            _unpack_lane(pstate, local, buf)
        return pstate

    return sharded


def _shard_dims(tc: TrainConfig, width: int) -> Optional[PopState]:
    """Per leaf of a population state, the axis (the lane axis counted) its
    shards split at ``width`` (``TPLayout.dims``), None at width 1."""
    return None if width == 1 else TPLayout(tc, width, 0, replicate=True).dims


def _regrid_plan(tc: TrainConfig, mesh, mesh2, pstate: PopState, idx: Sequence[int]):
    """Every transfer of a sharded regrid, in one order on every rank:
    ``(new lane, sender rank, receiver rank, pieces)``, a piece per leaf
    (``tree_leaves`` order) being None (nothing of that leaf) or
    ``(dim, lo, hi, src_lo, dst_lo)``: the leaf's lane view along ``dim``
    (None: the whole view), positions ``[lo, hi)`` of the whole lane, at
    ``src_lo`` in the sender's shard and ``dst_lo`` in the receiver's.
    Also the new block's leaf shapes.  A leaf a width shards splits into
    equal intervals along its axis; one replicated on both sides is sent by
    one old shard only."""
    leaves = tree_leaves(pstate)
    w1, w2 = mesh.width, mesh2.width
    d1 = _shard_dims(tc, w1)
    d2 = _shard_dims(tc, w2)
    d1 = [None] * len(leaves) if d1 is None else tree_leaves(d1)
    d2 = [None] * len(leaves) if d2 is None else tree_leaves(d2)
    blk1 = leaves[0].shape[0]
    blk2 = mesh2.block_size(len(idx))
    metas, shapes = [], []
    for leaf, a, b in zip(leaves, d1, d2):
        if a is not None and b is not None and a != b:
            raise ValueError(f"regrid: a leaf splits along axis {a} at width {w1} and "
                             f"{b} at width {w2}")
        dim = a if a is not None else b
        whole = None if dim is None else leaf.shape[dim] * (w1 if a is not None else 1)
        metas.append((a, b, dim, whole))
        shape = list(leaf.shape)
        shape[0] = blk2
        if dim is not None:
            shape[dim] = whole // w2 if b is not None else whole
        shapes.append(tuple(shape))
    plan = []
    for j, src in enumerate(idx):
        r1, r2 = int(src) // blk1, j // blk2
        for j2 in range(w2):
            keep = (j2 * w1) // w2   # the old shard a replicated leaf comes from
            for j1 in range(w1):
                pieces = []
                for a, b, dim, whole in metas:
                    if dim is None:
                        pieces.append((None, 0, 0, 0, 0) if j1 == keep else None)
                        continue
                    if a is None and j1 != keep:
                        pieces.append(None)
                        continue
                    lo1 = j1 * whole // w1 if a is not None else 0
                    hi1 = (j1 + 1) * whole // w1 if a is not None else whole
                    lo2 = j2 * whole // w2 if b is not None else 0
                    hi2 = (j2 + 1) * whole // w2 if b is not None else whole
                    lo, hi = max(lo1, lo2), min(hi1, hi2)
                    pieces.append((dim - 1, lo, hi, lo - lo1, lo - lo2) if lo < hi else None)
                if any(p is not None for p in pieces):
                    plan.append((j, r1 * w1 + j1, r2 * w2 + j2, pieces))
    return plan, shapes


def _piece(view: torch.Tensor, piece, side: int) -> torch.Tensor:
    """The part of a lane view a piece names, on its sender (``side`` 3) or
    receiver (``side`` 4) side."""
    dim, lo, hi = piece[:3]
    return view if dim is None else view.narrow(dim, piece[side], hi - lo)


def _piece_bytes(pieces, views) -> list:
    """``(offset, nbytes)`` of each present piece in a transfer's buffer
    (64-byte aligned, as a lane's byte buffer), and the buffer's size last."""
    out, off = [], 0
    for p, v in zip(pieces, views):
        if p is None:
            out.append(None)
            continue
        n = _piece(v, p, 4).numel() * v.element_size()
        out.append((off, n))
        off += -(-n // _LaneSlots._ALIGN) * _LaneSlots._ALIGN
    return out + [off]


def make_sharded_lane_regrid(tc: TrainConfig, mesh) -> Callable:
    """``(pstate, survivors, out=None, to_mesh=None) -> pstate'`` over this
    rank's block: the global lanes ``survivors`` (padded, ascending) gathered
    into a population of ``len(survivors)`` lanes laid out on ``to_mesh``
    (default ``mesh``), a mesh of another width over the same ranks
    (``PopulationMesh.with_width``).

    Each rank receives the lanes its new row owns, and of each its model
    position's shard at the new width (``TPLayout``): a survivor crosses
    rows, and a leaf split at both widths crosses model positions, as the
    pieces that the new shard overlaps of the old ones.  Pieces held on the
    rank are copied; the others are sent point to point, one buffer per
    (lane, sender, receiver), all posted at once (``exchange``), so nothing
    is gathered whole and the new state is each lane's bytes.  The input is
    only read; ``out`` (the new geometry's captured state) receives the
    result in place.  Returns the new block; the bytes this rank received
    are kept in ``recv_bytes`` on the op."""

    def regrid(pstate: PopState, survivors, out: Optional[PopState] = None, to_mesh=None):
        mesh2 = mesh if to_mesh is None else to_mesh
        idx = [int(i) for i in survivors]
        plan, shapes = _regrid_plan(tc, mesh, mesh2, pstate, idx)
        leaves = tree_leaves(pstate)
        dev = leaves[0].device
        if out is None:
            out = tree_unflatten(pstate, [torch.empty(sh, dtype=t.dtype, device=dev)
                                          for sh, t in zip(shapes, leaves)])
        else:
            _check_apart(pstate, out)
        dst = tree_leaves(out)
        if [tuple(t.shape) for t in dst] != shapes:
            raise ValueError("regrid: out is not a state of the new geometry")
        blk1, blk2 = leaves[0].shape[0], dst[0].shape[0]
        me = mesh.rank
        sends, recvs, landing = [], [], []
        for j, sender, receiver, pieces in plan:
            src_views = [t[idx[j] % blk1] for t in leaves]
            dst_views = [t[j % blk2] for t in dst]
            if sender == me and receiver == me:
                for p, a, b in zip(pieces, src_views, dst_views):
                    if p is not None:
                        _piece(b, p, 4).copy_(_piece(a, p, 3))
            elif sender == me:
                *spans, size = _piece_bytes(pieces, dst_views)
                buf = torch.zeros(size, dtype=torch.uint8, device=dev)
                for p, sp, a in zip(pieces, spans, src_views):
                    if p is not None:
                        buf[sp[0]:sp[0] + sp[1]].copy_(
                            _piece(a, p, 3).contiguous().reshape(-1).view(torch.uint8))
                sends.append((buf, receiver))
            elif receiver == me:
                *spans, size = _piece_bytes(pieces, dst_views)
                buf = torch.empty(size, dtype=torch.uint8, device=dev)
                recvs.append((buf, sender))
                landing.append((buf, pieces, spans, dst_views))
        mesh.exchange(sends, recvs)
        for buf, pieces, spans, views in landing:
            for p, sp, v in zip(pieces, spans, views):
                if p is not None:
                    part = _piece(v, p, 4)
                    part.copy_(buf[sp[0]:sp[0] + sp[1]].view(v.dtype).view(part.shape))
        regrid.recv_bytes = sum(buf.numel() for buf, _ in recvs)
        return out

    regrid.recv_bytes = 0
    return regrid


_SHARDED_LANE_OPS: Dict[str, Callable] = {
    "init": make_sharded_lane_init,
    "clone": make_sharded_lane_clone,
    "splice": make_sharded_lane_splice,
    "snapshot": make_sharded_lane_snapshot,
    "restore": make_sharded_lane_restore,
    "regrid": make_sharded_lane_regrid,
}


def get_compiled_sharded_population_step(tc: TrainConfig, population: int, mesh,
                                         per_trial_batch: bool = False) -> Callable:
    """The sharded per-step program (``make_sharded_population_step``);
    raises if K does not divide over the mesh's rows (pad with
    ``pad_population`` first)."""
    _check_rows(population, mesh)
    key = (ts.static_step_key(tc), int(population), bool(per_trial_batch), "step", mesh.key)
    with _POP_CACHE_LOCK:
        fn = _POP_CACHE.get(key)
        if fn is None:
            fn = _POP_CACHE[key] = make_sharded_population_step(tc, mesh, per_trial_batch)
    return fn


def population_scores(pstate: PopState, diverged_score: float = -1e9) -> torch.Tensor:
    """HPO convention: score = -final_loss, with a sentinel for diverged
    trials.  Trials that never applied a step (budget 0) also get the
    sentinel."""
    last = pstate["last_loss"]
    ok = ~pstate["diverged"] & torch.isfinite(last)
    return torch.where(ok, -last, torch.full_like(last, diverged_score))
