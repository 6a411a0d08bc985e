"""Prefetch ring: host-fed chunks without waiting on the host.

The chunked engine (``--chunk-steps``) makes its batches on the device,
which works only for the counter-based synthetic stream.  ``PrefetchRing``
opens that engine to host data: a ring of ``windows`` chunk-windows of
per-lane token slabs lives on the device as one ``(capacity, K, batch,
seq_len+1)`` int32 tensor at a fixed address, a background host thread
fills windows ahead of the consumer (``HostDataset.lane_window`` or
``lane_block``), and the ring chunk (``train.population.
make_population_ring_scan_step``) reads slot ``step % capacity``; the device
waits on the feed only if the host falls a whole ring behind.

Fence protocol (one lock and condition, two monotone step pointers):

- ``_filled_to``: batches for global steps ``[..., _filled_to)`` are in the
  ring for the current lane table.  Advanced only by the fill thread.
- ``_consumed_to``: the driver has dispatched every chunk that reads steps
  below this.  Advanced only by ``consume_to``.  The filler never lets
  ``_filled_to - _consumed_to`` exceed ``capacity``: an unconsumed slot is
  never overwritten.

``wait_filled(s, want)`` blocks until steps ``[s, s + want)`` are filled
(``fill_wait_s`` adds the time it blocked).  The driver asks for exactly
the chunk it is about to dispatch, so the dispatch sequence is the one of
in-chunk synthesis: a lagging fill costs wait time, never another chunk
split (which would reorder results under a stateful proposer).

On the card the fence has a device half.  The fill thread copies a window
from pinned host staging into its slots on a side stream and records an
event; ``wait_filled`` makes the dispatching stream wait on the events of
the slots it will read; ``consume_to`` records an event on the dispatching
stream after the chunk, and the side stream waits on it before it writes
those slots again.  A staging buffer is written again only after its copy
has finished.  On the CPU the fill thread writes the slots directly.

``set_lanes(streams, offsets, at_step)`` re-keys the ring when the lane
table changes (a refill, a PBT clone, a restored snapshot): a generation
counter drops in-flight and filled windows, and the filler restarts from
``at_step``.  Lane ``i``'s batch for global step ``s`` is
``dataset.lane_block`` at step ``offsets[i] + s``: offsets carry each lane's
own data cursor (``base_data - start`` in the streaming driver), so a
restored lane resumes its stream mid-window.  A call with an unchanged lane
table is a no-op: the prefetched windows are still the right bytes.
"""
from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch


class PrefetchRing:
    """``windows`` chunk-windows of per-lane token slabs on the device,
    filled ahead by a host thread.

    ``dataset`` is a ``repro_torch.data.pipeline.HostDataset``; ``win_steps``
    the chunk size (a window backs one chunk); ``windows`` the prefetch
    depth (2 is double buffering).  ``buffer`` is the ring tensor to fill
    (on the card: the geometry's, ``train.population.ring_buffer``, which
    the chunk graphs read); without it the ring allocates one on
    ``device``.  ``slots`` is the ring tensor.
    """

    def __init__(self, dataset, population: int, win_steps: int, windows: int = 2,
                 device="cpu", buffer: Optional[torch.Tensor] = None):
        if int(windows) < 2:
            raise ValueError("a prefetch ring needs at least two windows to overlap "
                             "its fill with the chunks")
        self.dataset = dataset
        self.population = int(population)
        self.win_steps = max(1, int(win_steps))
        self.windows = int(windows)
        self.capacity = self.windows * self.win_steps
        shape = (self.capacity, self.population, int(dataset.global_batch),
                 int(dataset.seq_len) + 1)
        if buffer is None:
            buffer = torch.zeros(shape, dtype=torch.int32, device=device)
        if tuple(buffer.shape) != shape or buffer.dtype != torch.int32:
            raise ValueError(f"ring buffer: want int32 {shape}, got {buffer.dtype} "
                             f"{tuple(buffer.shape)}")
        self.slots = buffer
        self._cuda = buffer.is_cuda
        if self._cuda:
            self._side = torch.cuda.Stream(buffer.device)
            self._filled_ev: list = [None] * self.capacity     # last fill of each slot
            self._consumed_ev: list = [None] * self.capacity   # last chunk reading it
            self._staging = [torch.empty((self.win_steps,) + shape[1:], dtype=torch.int32,
                                         pin_memory=True) for _ in range(self.windows)]
            self._staging_ev: list = [None] * self.windows     # its last copy
            self._next_staging = 0

        self._lock = threading.Condition()
        self._streams: Optional[np.ndarray] = None
        self._offsets: Optional[np.ndarray] = None
        self._gen = 0
        self._filled_to = 0
        self._consumed_to = 0
        self._stopped = False
        self._error: Optional[BaseException] = None

        # telemetry: time the consumer blocked on the feed against the time
        # the host spent producing; overlap_frac ~ 1 means the fill was hidden
        self.fill_wait_s = 0.0
        self.fill_busy_s = 0.0
        self.n_fills = 0
        self.n_invalidations = 0

        self._thread = threading.Thread(target=self._fill_loop, name="prefetch-ring-fill",
                                        daemon=True)
        self._thread.start()

    # -- driver-facing fences ---------------------------------------------------
    def set_lanes(self, streams: Sequence[int], offsets: Sequence[int], at_step: int) -> None:
        """(Re)key the ring: lane ``i`` at global step ``s`` reads
        ``streams[i]`` at data step ``offsets[i] + s``.  Anything filled past
        ``at_step`` is dropped: the lane table changed under it."""
        if len(streams) != self.population:
            raise ValueError(f"set_lanes: {len(streams)} streams for {self.population} lanes")
        new_streams = np.asarray([int(x) for x in streams], np.int64)
        new_offsets = np.asarray([int(o) for o in offsets], np.int64)
        with self._lock:
            if (self._streams is not None and np.array_equal(self._streams, new_streams)
                    and np.array_equal(self._offsets, new_offsets)):
                # an unchanged lane table: every filled window still holds the
                # same (stream, data step) slabs, so the prefetch is kept
                return
            if self._streams is not None and self._filled_to > int(at_step):
                self.n_invalidations += 1  # prefetched windows dropped
            self._streams = new_streams
            self._offsets = new_offsets
            self._gen += 1
            self._filled_to = int(at_step)
            self._consumed_to = int(at_step)
            self._lock.notify_all()

    def wait_filled(self, s: int, want: int = 1) -> int:
        """Block until batches for global steps ``[s, s + want)`` are in the
        ring; return the contiguous filled extent from ``s`` (>= ``want``).
        On the card the current stream then waits on those slots' fills, so
        a chunk dispatched after this call reads the filled slabs.  ``want``
        is capped at ``capacity``."""
        want = max(1, min(int(want), self.capacity))
        t0 = None
        with self._lock:
            while self._filled_to < s + want and self._error is None and not self._stopped:
                if t0 is None:
                    t0 = time.perf_counter()
                self._lock.wait(timeout=0.5)
            if t0 is not None:
                self.fill_wait_s += time.perf_counter() - t0
            if self._error is not None:
                raise RuntimeError("prefetch ring fill failed") from self._error
            if self._stopped:
                raise RuntimeError("prefetch ring stopped while waiting")
            if self._cuda:
                stream = torch.cuda.current_stream(self.slots.device)
                for t in range(s, s + want):
                    ev = self._filled_ev[t % self.capacity]
                    if ev is not None:
                        stream.wait_event(ev)
            return int(self._filled_to - s)

    def consume_to(self, s: int) -> None:
        """Every chunk reading steps below ``s`` is dispatched (on the card:
        on the current stream): their slots may be written again once those
        chunks have run."""
        with self._lock:
            if s > self._consumed_to:
                if self._cuda:
                    ev = torch.cuda.Event()
                    ev.record(torch.cuda.current_stream(self.slots.device))
                    for t in range(self._consumed_to, int(s)):
                        self._consumed_ev[t % self.capacity] = ev
                self._consumed_to = int(s)
                self._lock.notify_all()

    @property
    def overlap_frac(self) -> float:
        """Share of the host's fill time hidden behind the consumer."""
        if self.fill_busy_s <= 0.0:
            return 1.0
        return max(0.0, min(1.0, 1.0 - self.fill_wait_s / self.fill_busy_s))

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            self._lock.notify_all()
        self._thread.join(timeout=5.0)
        if self._cuda:
            self._side.synchronize()   # no copy outlives the ring's staging

    # -- fill thread ------------------------------------------------------------
    def _build(self, streams, offsets, s0: int, n: int) -> np.ndarray:
        window = getattr(self.dataset, "lane_window", None)
        if window is not None:
            # one vectorized call per window
            return window(streams, offsets + s0, n)
        return np.stack([self.dataset.lane_block(streams, offsets + (s0 + t))
                         for t in range(n)])

    def _stage(self, block: np.ndarray):
        """``(staging tensor holding the block, its index)``: the next pinned
        staging buffer, written once its last copy to the card has
        finished."""
        j = self._next_staging
        self._next_staging = (j + 1) % self.windows
        if self._staging_ev[j] is not None:
            self._staging_ev[j].synchronize()
        dst = self._staging[j][: len(block)]
        dst.numpy()[...] = block
        return dst, j

    def _fill_loop(self) -> None:
        try:
            while True:
                with self._lock:
                    while not self._stopped and (
                            self._streams is None
                            or self._filled_to - self._consumed_to >= self.capacity):
                        self._lock.wait(timeout=0.5)
                    if self._stopped:
                        return
                    gen = self._gen
                    s0 = self._filled_to
                    streams = self._streams.copy()
                    offsets = self._offsets.copy()
                    free = self.capacity - (s0 - self._consumed_to)
                    slot0 = s0 % self.capacity
                    n = min(self.win_steps, self.capacity - slot0, free)

                t0 = time.perf_counter()
                block = np.asarray(self._build(streams, offsets, s0, n), np.int32)
                if self._cuda:
                    staged, j = self._stage(block)

                with self._lock:
                    if self._stopped:
                        return
                    if gen != self._gen:
                        continue  # the lane table changed mid-build: drop it
                    dst = self.slots[slot0: slot0 + n]
                    if self._cuda:
                        # on the side stream, after the chunks that read these
                        # slots; the dispatching stream waits on ``ev``
                        for t in range(slot0, slot0 + n):
                            if self._consumed_ev[t] is not None:
                                self._side.wait_event(self._consumed_ev[t])
                        with torch.cuda.stream(self._side):
                            dst.copy_(staged, non_blocking=True)
                        ev = torch.cuda.Event()
                        ev.record(self._side)
                        self._staging_ev[j] = ev
                        for t in range(slot0, slot0 + n):
                            self._filled_ev[t] = ev
                    else:
                        dst.copy_(torch.from_numpy(block))
                    self._filled_to = s0 + n
                    self.n_fills += 1
                    self.fill_busy_s += time.perf_counter() - t0
                    self._lock.notify_all()
        except BaseException as e:  # handed to the blocked consumer
            with self._lock:
                self._error = e
                self._lock.notify_all()
