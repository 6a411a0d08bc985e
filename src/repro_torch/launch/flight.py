"""The device side of one population flight, on one device or a population
mesh.

A flight's host driver (``PopulationTrial._flight`` / ``_stream`` in
``launch/hpo.py``) decides everything: the lane table, budgets, rung cuts,
leases and lane ops.  ``LaneFlight`` holds what lives on the device (the
population state, the lanes' hyperparameters and stream words, the prefetch
ring) and is the only thing that touches it: every device operation of a
flight is one of its methods.

Without a mesh a method is the plain call on the whole population.  With a
``distributed.sharding.PopulationMesh`` the flight is SPMD: rank 0's driver
calls a method, which broadcasts its name and host arguments to the other
ranks (``serve``) before running it; every rank then runs the same method on
its own block of K/N lanes, so the collectives inside (the ``all_gather`` of
the per-lane vectors, a lane sent between ranks) pair up.  Host decisions,
the Experiment, the proposer, the tracking DB, the lane scheduler and the
fault injector all stay on rank 0; the other ranks only ever apply what it
broadcasts.  A flight that dies on rank 0 ends on every rank (its ``end``
carries the error), so a supervised restart is the same restart everywhere.
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional

import numpy as np
import torch

# ops whose arguments stay on rank 0 (what is broadcast is only their head)
_LOCAL_ARGS = {"restore": 1}


class LaneFlight:
    """One flight's population state and device operations (see the module
    docstring).  ``k`` is the global population, ``graphed`` whether the
    flight holds its geometry's captured state (``flight_lease``),
    ``ptb`` whether lanes read their own data streams, ``ring_on`` whether
    a prefetch ring feeds the chunks.  Open one with ``LaneFlight.open``."""

    def __init__(self, trial, k: int, mesh=None, graphed: bool = False, ptb: bool = True,
                 ring_on: bool = False):
        from ..train.population import flight_lease

        self.trial = trial
        self.mesh = mesh
        self.k = int(k)
        self.tc, self.data = trial._setup()
        self.dev = trial.device if mesh is None else mesh.device
        self.blk = self.k if mesh is None else mesh.block_size(self.k)
        self.lo = 0 if mesh is None else mesh.rank * self.blk
        self.ptb = bool(ptb)
        self.graphed = bool(graphed)
        self.state = None
        self.hp = None
        self.streams: list = []
        self.s_lo = self.s_hi = None
        self.feed = None
        self.step_fn = None   # the per-step program, made at the first step
        self.result: Any = None   # what the flight returns; the other ranks get it at its end
        self._stack = contextlib.ExitStack()
        self.out = None
        if self.graphed:
            # the state the chunk graphs captured is reused in place, not
            # held twice, and by one flight at a time
            self.out = self._stack.enter_context(
                flight_lease(self.tc, self.blk, self.data, self.ptb, self.dev))
        self.ring = self._make_ring() if ring_on else None

    # -- opening, closing and the worker side ------------------------------------
    @classmethod
    @contextlib.contextmanager
    def open(cls, trial, k: int, mesh=None, graphed: bool = False, ptb: bool = True,
             ring_on: bool = False):
        """A flight for rank 0's driver (or the only rank's): the other ranks
        of ``mesh`` open theirs from the broadcast, and close it when this
        context exits, with the error that ended it, if any."""
        head = (int(k), bool(graphed), bool(ptb), bool(ring_on))
        with contextlib.ExitStack() as stack:
            if mesh is not None:
                # one flight at a time on a mesh (a partial batch may flush
                # while another flight trains)
                stack.enter_context(mesh.flight_lock)
                if mesh.world_size > 1:
                    mesh.broadcast_object(("begin", head))
            fl = cls(trial, k, mesh=mesh, graphed=graphed, ptb=ptb, ring_on=ring_on)
            err = None
            try:
                yield fl
            except BaseException as e:
                err = f"{type(e).__name__}: {e}"
                raise
            finally:
                try:
                    fl._send("end", fl.result, err)
                except Exception:
                    if err is None:
                        raise   # else the flight's own error is the one to see
                finally:
                    fl._close()

    def _send(self, op: str, *args) -> None:
        if self.mesh is not None and self.mesh.world_size > 1 and self.mesh.rank == 0:
            self.mesh.broadcast_object((op, args[:_LOCAL_ARGS.get(op, len(args))]))

    def _call(self, op: str, *args):
        self._send(op, *args)
        return getattr(self, "_" + op)(*args)

    def _close(self) -> None:
        try:
            if self.ring is not None:
                self.trial._absorb_ring(self.ring)
        finally:
            self._stack.close()

    # -- helpers ----------------------------------------------------------------
    def _block(self, x):
        return x if self.mesh is None else self.mesh.block(x, self.k)

    def _gather(self, tree, dim: int = 0):
        return tree if self.mesh is None else self.mesh.all_gather_lanes(tree, dim)

    def _in_block(self, lane: int) -> bool:
        return self.lo <= int(lane) < self.lo + self.blk

    def _make_ring(self):
        """This rank's prefetch ring (``--data-ring``): ``ring_windows``
        chunk-windows of its own lanes' slabs, filled from ``host_dataset``
        (default: the synthetic stream's host adapter, in-chunk synthesis's
        bit-equality oracle).  On the card it fills the geometry's ring
        tensor, the one the ring chunks' graphs read."""
        from ..data.pipeline import SynthHostDataset
        from ..data.ring import PrefetchRing
        from ..train.population import ring_buffer

        t = self.trial
        ds = t.host_dataset if t.host_dataset is not None else SynthHostDataset(self.data)
        capacity = t.ring_windows * t.chunk_steps
        buf = (ring_buffer(self.tc, self.blk, self.data, capacity, self.dev)
               if self.dev.type == "cuda" else None)
        return PrefetchRing(ds, population=self.blk, win_steps=t.chunk_steps,
                            windows=t.ring_windows, device=self.dev, buffer=buf)

    # -- the operations: ``name`` (rank 0) broadcasts, ``_name`` runs on every rank
    def init_state(self, streams, per_lane: bool):
        """A fresh population: lane i from ``streams[i]``'s init generator
        (``per_lane``), else every lane from the seed's weights."""
        return self._call("init_state", list(streams), bool(per_lane))

    def _init_state(self, streams, per_lane):
        from ..train.population import init_population_state, init_population_state_from_keys

        t = self.trial
        if per_lane:
            self.state = init_population_state_from_keys(
                [t._generator(s) for s in self._block(streams)], self.tc, self.dev, out=self.out)
        else:
            self.state = init_population_state(t._generator(0), self.tc, self.blk, self.dev,
                                               out=self.out)
        return self.state

    def set_hp(self, hps) -> None:
        """The lanes' hyperparameters (one ``HParams`` of floats a lane)."""
        self._call("set_hp", list(hps))

    def _set_hp(self, hps):
        from ..optim.hparams import stack_hparams

        self.hp = stack_hparams(self._block(hps), self.dev)

    def set_budgets(self, budgets) -> None:
        """New step budgets, written in place (a captured graph reads them)."""
        self._call("set_budgets", np.asarray(budgets, np.float64))

    def _set_budgets(self, budgets):
        self.hp.total_steps.copy_(torch.as_tensor(self._block(budgets), dtype=torch.float32))

    def set_streams(self, streams) -> None:
        """The lanes' data streams (their stream words on the device)."""
        self._call("set_streams", [int(s) for s in streams])

    def _set_streams(self, streams):
        from ..data.pipeline import split_stream, split_streams

        self.streams = self._block(streams)
        words = (split_streams(self.streams) if self.trial.per_trial_streams
                 else split_stream(0))
        self.s_lo, self.s_hi = (torch.as_tensor(np.asarray(w, np.int64), device=self.dev)
                                for w in words)

    def ring_lanes(self, streams, offsets, at_step: int) -> None:
        """Re-key the prefetch ring (``PrefetchRing.set_lanes``)."""
        self._call("ring_lanes", [int(s) for s in streams], [int(o) for o in offsets],
                   int(at_step))

    def _ring_lanes(self, streams, offsets, at_step):
        self.ring.set_lanes(self._block(streams), self._block(offsets), at_step=at_step)

    def step_at(self, s: int, prefetch: Optional[int]):
        """One population step of a batch flight on the host batch of
        global step ``s`` (every lane's cursor), staging ``prefetch``'s
        batch behind it."""
        return self._call("step_at", int(s), prefetch)

    def _step_at(self, s, prefetch):
        from ..data.pipeline import HostPrefetcher

        if self.feed is None:
            self.feed = HostPrefetcher(
                lambda t: self.trial._batch(self.data, t, self.streams), self.dev)
        _, metrics = self._pstep()(self.state, self.feed.pop(s), self.hp)
        if prefetch is not None:
            self.feed.prefetch(prefetch)  # host synthesis overlaps the device step
        return metrics

    def step_cursors(self, cursors):
        """One population step on host batches, lane i at ``cursors[i]``."""
        return self._call("step_cursors", np.asarray(cursors, np.int64))

    def _step_cursors(self, cursors):
        from ..data.pipeline import to_device

        batch = to_device(self.data.make_population_batch(self._block(cursors), self.streams),
                          self.dev)
        _, metrics = self._pstep()(self.state, batch, self.hp)
        return metrics

    def _pstep(self):
        from ..train.population import (
            get_compiled_sharded_population_step,
            make_population_train_step,
        )

        if self.step_fn is None:
            self.step_fn = (
                make_population_train_step(self.tc, per_trial_batch=self.ptb)
                if self.mesh is None else
                get_compiled_sharded_population_step(self.tc, self.k, self.mesh, self.ptb))
        return self.step_fn

    def _steps0(self, cursors):
        if np.isscalar(cursors):
            return torch.full((self.blk,) if self.ptb else (), int(cursors),
                              dtype=torch.int64, device=self.dev)
        return torch.as_tensor(self._block(np.asarray(cursors, np.int64)), device=self.dev)

    def chunk(self, t: int, cursors):
        """A fused chunk of ``t`` steps (on the card a graph replay), lane i
        from cursor ``cursors[i]`` (one int: every lane)."""
        return self._call("chunk", int(t), cursors)

    def _chunk(self, t, cursors):
        from ..train.population import get_compiled_population_scan_step

        prog = get_compiled_population_scan_step(self.tc, self.k, self.data, t,
                                                 per_trial_batch=self.ptb, mesh=self.mesh)
        _, metrics = prog(self.state, self.hp, self._steps0(cursors), self.s_lo, self.s_hi)
        return metrics

    def rule_chunk(self, t: int, mode: str, rules, cursors):
        """A chunk carrying ``mode``'s rule (``rules``: the global rule state
        as CPU tensors); returns ``(rules after the chunk, metrics)``."""
        return self._call("rule_chunk", int(t), str(mode), rules, cursors)

    def _rule_chunk(self, t, mode, rules, cursors):
        from ..train.population import get_compiled_population_rule_scan_step, shard_rule_state

        rules = {n: v.to(self.dev) for n, v in rules.items()}
        if self.mesh is not None:
            rules = shard_rule_state(rules, mode, self.mesh, self.k)
        prog = get_compiled_population_rule_scan_step(self.tc, self.k, self.data, t, mode,
                                                      per_trial_batch=self.ptb, mesh=self.mesh)
        (_, rout), metrics = prog(self.state, self.hp, self._steps0(cursors), self.s_lo,
                                  self.s_hi, rules)
        return rout, metrics

    def ring_chunk(self, s: int, t: int):
        """A ring-fed chunk of ``t`` steps from global step ``s``: wait until
        the host has staged exactly these steps (a lagging fill costs wait
        time, never another chunk split), dispatch, and free the slots."""
        return self._call("ring_chunk", int(s), int(t))

    def _ring_chunk(self, s, t):
        from ..train.population import get_compiled_population_ring_scan_step

        ring = self.ring
        ring.wait_filled(s, t)
        _, metrics = get_compiled_population_ring_scan_step(
            self.tc, self.k, self.data, t, ring.capacity, mesh=self.mesh)(
                self.state, self.hp, ring.slots, s % ring.capacity)
        ring.consume_to(s + t)
        return metrics

    def lanes(self):
        """``(last_loss, diverged, applied steps)`` of every lane, as numpy."""
        return self._call("lanes")

    def _lanes(self):
        st = self.state
        g = self._gather({"last_loss": st["last_loss"], "diverged": st["diverged"],
                          "step": st["inner"]["opt"]["step"]})
        return (g["last_loss"].cpu().numpy(), g["diverged"].cpu().numpy(),
                g["step"].cpu().numpy().astype(np.int64))

    def scores(self, diverged_score: float) -> np.ndarray:
        """Every lane's score (``population_scores``), as numpy."""
        return self._call("scores", float(diverged_score))

    def _scores(self, diverged_score):
        from ..train.population import population_scores

        return self._gather(population_scores(self.state, diverged_score)).cpu().numpy()

    def poison(self, lanes) -> None:
        """Set the divergence latch of ``lanes`` (fault injection)."""
        self._call("poison", [int(i) for i in lanes])

    def _poison(self, lanes):
        mask = torch.zeros(self.blk, dtype=torch.bool)
        mask[[i - self.lo for i in lanes if self._in_block(i)]] = True
        self.state["diverged"].logical_or_(mask.to(self.dev))

    def _op(self, kind: str):
        from ..train.population import get_lane_op

        return get_lane_op(self.tc, self.k, kind, mesh=self.mesh)

    def splice(self, lane: int, stream: int) -> None:
        """Re-initialise ``lane`` from ``stream``'s init generator."""
        self._call("splice", int(lane), int(stream))

    def _splice(self, lane, stream):
        gen = self.trial._generator(stream) if self._in_block(lane) else None
        self._op("splice")(self.state, lane, gen)

    def init_lanes(self, mask, streams) -> None:
        """Re-initialise the masked lanes, lane i from ``streams[i]``."""
        self._call("init_lanes", np.asarray(mask, bool), [int(s) for s in streams])

    def _init_lanes(self, mask, streams):
        gens = [self.trial._generator(streams[i]) if mask[i] and self._in_block(i) else None
                for i in range(self.k)]
        self._op("init")(self.state, mask, gens)

    def clone(self, mask, donor_idx) -> None:
        """Copy lane ``donor_idx[i]`` into every masked lane ``i``."""
        self._call("clone", np.asarray(mask, bool), np.asarray(donor_idx, np.int64))

    def _clone(self, mask, donor_idx):
        self._op("clone")(self.state, mask, donor_idx)

    def snapshot(self, lane: int):
        """Lane ``lane``'s whole state on the host (of rank 0)."""
        return self._call("snapshot", int(lane))

    def _snapshot(self, lane):
        return self._op("snapshot")(self.state, lane)

    def restore(self, lane: int, snap) -> None:
        """Write a harvested snapshot (held by rank 0) into ``lane``."""
        self._call("restore", int(lane), snap)

    def _restore(self, lane, snap=None):
        self._op("restore")(self.state, lane, snap)


def serve(trial, mesh, flights: Optional[int] = None):
    """A rank above 0 of ``mesh``: open, drive and close flights as rank 0
    broadcasts them, until rank 0 shuts the mesh down (``shutdown``), or
    after ``flights`` flights.  Returns the last flight's result; a flight
    that died on rank 0 raises here too when ``flights`` is given."""
    if mesh.rank == 0:
        raise ValueError("rank 0 drives the flights; serve() runs on the other ranks")
    done, result = 0, None
    while flights is None or done < flights:
        op, args = mesh.broadcast_object(None)
        if op == "shutdown":
            break
        if op != "begin":
            raise RuntimeError(f"population mesh: expected a flight to begin, got {op!r}")
        fl = LaneFlight(trial, args[0], mesh=mesh, graphed=args[1], ptb=args[2],
                        ring_on=args[3])
        try:
            while True:
                op, args = mesh.broadcast_object(None)
                if op == "end":
                    result, err = args
                    break
                getattr(fl, "_" + op)(*args)
        finally:
            fl._close()
        done += 1
        if err is not None and flights is not None:
            raise RuntimeError(f"population mesh: the flight died on rank 0: {err}")
    return result


def shutdown(mesh) -> None:
    """Rank 0: release the other ranks from ``serve``."""
    if mesh is not None and mesh.world_size > 1 and mesh.rank == 0:
        mesh.broadcast_object(("shutdown", ()))
