"""Chunk-dispatch / event-horizon planning shared by the HPO drivers.

The three ``launch.hpo`` drivers (batch, batch-with-device-rules, streaming)
all advance a population between *host events* — rung boundaries, budget ends,
the divergence/snapshot poll — and cover the gap with fused multi-step scans
whose sizes are power-of-two quantized so an experiment compiles at most
``log2(chunk_steps)+1`` scan programs.  That planning logic used to be
duplicated across the drivers; ``ChunkPlanner`` is its single home, so an
engine change (e.g. the elastic-regrid boundary decision) lands in exactly
one place.

The module-level functions are the primitive forms; the class packages the
per-flight constants (chunk size, poll cadence, rung boundaries).
"""
from __future__ import annotations

from typing import Sequence


def pow2_floor(n: int) -> int:
    """Largest power of two <= max(n, 1) — chunk sizes come from here, so an
    experiment compiles at most log2(chunk_steps)+1 fused-scan programs."""
    return 1 << (max(int(n), 1).bit_length() - 1)


def pow2_ceil(n: int) -> int:
    """Smallest power of two >= max(n, 1) — device-rule history capacities
    and elastic-regrid lane counts come from here, so array shapes (and thus
    compiled programs) stay bounded as histories grow / populations shrink."""
    return 1 << (max(int(n), 1) - 1).bit_length()


def poll_anchor(s: int, cadence: int) -> int:
    """Next divergence/snapshot poll step strictly after ``s``: polls anchor
    to an ABSOLUTE cadence (the next multiple), not a window sliding with
    ``s`` — a sliding window recomputed every pass never comes due, which
    both starved the capped divergence poll at chunk_steps=1 and left
    snapshot harvests with no mid-flight event to run at."""
    return (s // cadence + 1) * cadence


def next_event_step(s: int, cadence: int, starts, budgets, live,
                    boundaries: Sequence[int] = ()) -> int:
    """The streaming engine's next host event at-or-after ``s``: the poll
    anchor, each live lane's budget end, and the next rung boundary each lane
    can still reach (``local < b <= budget`` — completers feed the rung
    history too).  An event due AT ``s`` (e.g. a freshly leased zero-budget
    job) returns ``s`` itself so the driver re-runs the event pass instead of
    burning a dispatch on steps nobody needs."""
    ev = poll_anchor(s, cadence)
    for lane in live:
        local = s - starts[lane]
        ev = min(ev, int(starts[lane] + budgets[lane]))
        for b in boundaries:
            if local < b <= budgets[lane]:
                ev = min(ev, int(starts[lane] + b))
                break
    return max(ev, int(s))


def device_dispatch_horizon(s: int, cadence: int, starts, budgets,
                            live) -> int:
    """--device-rules chunk horizon: rung boundaries and individual budget
    ends are handled INSIDE the scan, so the host only stops at the
    divergence/snapshot poll anchor or once every live lane's budget is over
    (the scan would be all no-ops past that)."""
    ev = poll_anchor(s, cadence)
    ends = [int(starts[lane] + budgets[lane]) for lane in live]
    if ends:
        ev = min(ev, max(ends))
    return max(ev, int(s))


class ChunkPlanner:
    """One flight's dispatch plan: where the next host event is, and how many
    fused steps to scan toward it.

    ``chunk_steps`` caps the fused-scan length (1 = the per-step loop,
    bit-for-bit); ``cadence`` is the divergence/snapshot poll cadence
    (defaults to ``max(8, chunk_steps)`` — chunk-granular, so big chunks are
    not split by the poll); ``boundaries`` are the rung rule's cut steps
    (lane-local for the streaming staggered rule, global for the batch cohort
    rule).
    """

    def __init__(self, chunk_steps: int = 1, cadence: int = 0,
                 boundaries: Sequence[int] = ()):
        self.chunk = max(1, int(chunk_steps))
        self.cadence = int(cadence) if cadence else max(8, self.chunk)
        self.boundaries = tuple(int(b) for b in boundaries)

    # -- event horizons ---------------------------------------------------------
    def next_cohort_event(self, s: int, max_budget: int) -> int:
        """Batch protocol: the first rung boundary in ``(s, max_budget]``,
        else the flight end — the step the cohort rule next fires at."""
        nxt = int(max_budget)
        for b in self.boundaries:
            if s < b <= max_budget:
                return min(nxt, b)
        return nxt

    def next_stream_event(self, s: int, starts, budgets, live) -> int:
        """Streaming protocol with host rules: see ``next_event_step``."""
        return next_event_step(s, self.cadence, starts, budgets, live,
                               self.boundaries)

    def device_horizon(self, s: int, starts, budgets, live) -> int:
        """Streaming protocol with in-scan rules: see
        ``device_dispatch_horizon``."""
        return device_dispatch_horizon(s, self.cadence, starts, budgets, live)

    # -- chunk sizing -----------------------------------------------------------
    def chunk_to(self, s: int, event: int) -> int:
        """Fused-scan length covering ``(s, event]``: power-of-two quantized,
        capped by ``chunk_steps``; 1 when chunking is off."""
        if self.chunk <= 1:
            return 1
        return pow2_floor(min(int(event) - int(s), self.chunk))
