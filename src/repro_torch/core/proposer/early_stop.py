"""In-flight successive halving — early-stop decisions *inside* a population.

The rung-based proposers (ASHA, Hyperband) normally act only between jobs: a
config runs its whole ``n_iterations`` budget, reports, and the proposer then
decides whether it earns a promotion.  On the population engines that is
wasteful — all K lanes of a flight stay busy until the *longest* budget
finishes even when most lanes are clearly losing.

``InFlightSuccessiveHalving`` moves the rung rule into the flight.  The
population driver (``PopulationTrial.run_population``) calls the hook at every
rung boundary with each lane's current loss; lanes outside the top ``1/eta``
of still-active lanes get their traced ``hp.total_steps`` budget truncated to
the current step, which freezes them in the next population step **without a
recompile** (the budget is a traced leaf).  The host loop ends as soon as the
surviving max budget is reached, so the flush returns early and the freed
lanes go back to Algorithm 1 for the next batch — mid-flight lane reuse.

The hook is deliberately *stateless across flights* and shares nothing with
the proposer instance that spawned it (``ASHAProposer.inflight_hook()``), so
it is safe to call from the resource manager's batch worker thread while the
proposer keeps running on the experiment loop thread.  Truncated lanes report
the loss at their truncation step — ordinary early-stop semantics: the score
the proposer sees is simply measured at a smaller budget.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np


class DeviceRuleSpec:
    """Numpy lowering of a rung rule for the in-scan device twin.

    ``InFlightSuccessiveHalving.device_rule()`` returns one of these: the
    rule's configuration (``boundaries``, ``eta``) as plain arrays that the
    population engines can carry as extra ``lax.scan`` state, plus the
    host-sync pair ``lower_history`` / ``absorb_history`` that moves the
    staggered rule's per-rung loss history between the hook's Python dict
    and the fixed-capacity device arrays around each fused dispatch.  The
    spec holds a reference to its hook so truncation counters reconstructed
    from device results land back on the object tests and telemetry read.
    """

    def __init__(self, hook: "InFlightSuccessiveHalving"):
        self.hook = hook
        self.eta = np.float32(hook.eta)
        self.boundaries = np.asarray(hook.boundaries, np.float32)

    def lower_history(self, capacity: int):
        """``(hist f32[B, capacity] (+inf padded), counts i32[B])`` from the
        hook's per-rung history.  ``capacity`` must cover the largest rung's
        current length plus every append the next dispatch can make (at most
        one per lane per rung)."""
        b = len(self.hook.boundaries)
        hist = np.full((b, int(capacity)), np.inf, np.float32)
        counts = np.zeros((b,), np.int32)
        for bi, bnd in enumerate(self.hook.boundaries):
            h = self.hook._rung_history.get(bnd, [])
            if len(h) > capacity:
                raise ValueError(
                    f"rung {bnd} history ({len(h)}) exceeds capacity {capacity}")
            counts[bi] = len(h)
            hist[bi, : len(h)] = h
        return hist, counts

    def absorb_history(self, hist, counts) -> None:
        """Write device-side history arrays back into the hook's dict, so host
        rules (or a later host-rule flight) continue from the same state."""
        hist = np.asarray(hist)
        counts = np.asarray(counts)
        for bi, bnd in enumerate(self.hook.boundaries):
            c = int(counts[bi])
            self.hook._rung_history[bnd] = [float(x) for x in hist[bi, :c]]

    def absorb_cuts(self, old_budgets, new_budgets, diverged) -> None:
        """Reconstruct the hook's counters from a dispatch's budget delta:
        a shrunk budget on a diverged lane was reclaimed, on a live lane it
        was a rung cut."""
        old = np.asarray(old_budgets, np.float64)
        new = np.asarray(new_budgets, np.float64)
        div = np.asarray(diverged, bool)
        shrunk = new < old
        self.hook.n_reclaimed += int((shrunk & div).sum())
        self.hook.n_truncated += int((shrunk & ~div).sum())


class InFlightSuccessiveHalving:
    """Rung-boundary lane truncation with reduction factor ``eta``.

    ``boundaries`` is the set of step counts at which the rule fires:
    ``min_iter * eta**k`` for every rung below ``max_iter``.  At a boundary,
    every lane that reached it (budget >= step, not diverged, not padding) is
    ranked by current loss — including lanes whose budget *ends* here, exactly
    like ASHA compares rung completers against promotions passing through.
    The top ``ceil(n / eta)`` keep their budgets; ranked lanes below the cut
    that still had budget left are truncated to the boundary step.  Diverged
    lanes lose their remaining budget outright (they can never advance), so a
    flight of frozen lanes does not keep the devices busy.  Lanes never gain
    budget — promotions remain the proposer's decision between flights.
    """

    def __init__(self, eta: float = 3.0, min_iter: int = 1, max_iter: int = 27):
        self.eta = float(eta)
        self.min_iter = max(1, int(min_iter))
        self.max_iter = int(max_iter)
        n_rungs = int(
            math.floor(math.log(max(self.max_iter / self.min_iter, 1.0))
                       / math.log(self.eta))
        ) + 1
        self.boundaries = sorted(
            {
                min(self.max_iter, int(round(self.min_iter * self.eta ** k)))
                for k in range(n_rungs)
                if int(round(self.min_iter * self.eta ** k)) < self.max_iter
            }
        )
        # across all flights, for tests/telemetry: lanes cut by the rung rule
        # vs dead budget reclaimed from diverged lanes (a different mechanism)
        self.n_truncated = 0
        self.n_reclaimed = 0
        # per-rung loss history for the staggered (lane-refill) rule: every
        # loss ever observed at that boundary, across all lanes and flights
        self._rung_history: dict = {}

    def __call__(
        self,
        step: int,
        losses: Sequence[float],
        budgets: Sequence[float],
        diverged: Sequence[bool],
    ) -> np.ndarray:
        """Return the (possibly truncated) per-lane budgets after ``step``.

        ``losses`` are each lane's most recent applied-step losses
        (``pstate["last_loss"]``); padding lanes arrive with budget 0 and are
        never considered active.
        """
        budgets = np.asarray(budgets, np.float64).copy()
        losses = np.asarray(losses, np.float64)
        diverged = np.asarray(diverged, bool)
        if step not in self.boundaries:
            return budgets
        # a diverged lane's remaining budget is dead weight — reclaim it so an
        # all-frozen flight ends instead of stepping masked no-ops
        dead = diverged & (budgets > step)
        budgets[dead] = step
        self.n_reclaimed += int(dead.sum())
        ranked_mask = (budgets >= step) & (budgets > 0) & ~diverged & np.isfinite(losses)
        n_ranked = int(ranked_mask.sum())
        n_keep = int(math.ceil(n_ranked / self.eta))
        if n_ranked <= 1 or n_keep >= n_ranked:
            return budgets
        idx = np.flatnonzero(ranked_mask)
        # ascending loss = best first; stable: ties keep the lower lane index
        # (the device twin's pairwise rank reproduces exactly this order)
        ranked = idx[np.argsort(losses[idx], kind="stable")]
        cut = [i for i in ranked[n_keep:] if budgets[i] > step]
        budgets[cut] = step
        self.n_truncated += len(cut)
        return budgets

    def observe(
        self,
        local_steps: Sequence[float],
        losses: Sequence[float],
        budgets: Sequence[float],
        diverged: Sequence[bool],
    ) -> np.ndarray:
        """Staggered-lane variant for the continuous refill engine.

        With lane refill, lanes of one flight sit at *different* local steps
        (a refilled lane restarted its own step 0 mid-flight), so there is no
        synchronized cohort to rank at a boundary.  This is exactly the
        asynchronous-SHA setting: a lane reaching rung ``b`` is compared
        against the **history** of losses ever recorded at ``b`` — it keeps
        its budget only while inside the top ``1/eta`` of that history, else
        it is truncated to ``b``.  Early observations are optimistic (a lane
        with few predecessors always survives), matching ASHA's eager
        promotions; the history spans refills and flights, mirroring how ASHA
        rungs accumulate across the whole experiment.  The refill engine
        aligns its dispatch-chunk boundaries to these rung steps, so a lane
        is observed at *exactly* its boundary whether the flight advances one
        step or one fused chunk per device call.

        ``local_steps``/``budgets`` are lane-local; idle lanes carry budget 0
        and are skipped.  Diverged lanes are skipped too — the refill engine
        retires them directly (their budget is dead either way).
        """
        budgets = np.asarray(budgets, np.float64).copy()
        local_steps = np.asarray(local_steps, np.float64)
        losses = np.asarray(losses, np.float64)
        diverged = np.asarray(diverged, bool)
        for lane in np.flatnonzero((budgets > 0) & ~diverged):
            st = int(local_steps[lane])
            if st not in self.boundaries or st != local_steps[lane]:
                continue
            if not np.isfinite(losses[lane]):
                continue
            hist = self._rung_history.setdefault(st, [])
            loss = float(losses[lane])
            hist.append(loss)
            n_keep = int(math.ceil(len(hist) / self.eta))
            rank = sum(1 for x in hist if x < loss)  # ties keep the lane
            if rank >= n_keep and budgets[lane] > st:
                budgets[lane] = float(st)
                self.n_truncated += 1
        return budgets

    def device_rule(self) -> DeviceRuleSpec:
        """Lower this rule for in-scan evaluation — the device twin of
        ``inflight_hook()``.

        The returned spec carries ``boundaries``/``eta`` as arrays; the
        population engines evaluate the same cohort (``__call__``) and
        staggered (``observe``) semantics as pure vectorized functions of the
        scan-carried budgets and loss histories
        (``repro_torch.train.population.cohort_rule_update`` /
        ``staggered_rule_update``), so a fused chunk truncates lanes at rung
        boundaries without returning to the host.
        """
        return DeviceRuleSpec(self)
