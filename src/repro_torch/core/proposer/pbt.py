"""Population-Based Training (beyond-paper addition).

Two execution modes share one exploit/explore rule:

* **generation-barriered** (default) — a population of ``population`` members
  trains in generations; after each generation the bottom ``quantile`` clones
  the top quantile's hyperparameters AND checkpoint (via the ``pbt_ckpt`` /
  ``pbt_inherit`` aux keys — the job restores the donor's weights from a host
  checkpoint) then perturbs.  Maps naturally onto the mesh-slice pool: one
  member per slice.  The barrier means the whole population idles until its
  slowest member finishes each generation.

* **streaming** (``streaming=True``) — members live in population *lanes* of
  the lane-refill engine (``repro_torch.launch.hpo.PopulationTrial``).  Each member
  trains one round per job; when a round retires, the member's next job
  carries a **lifecycle directive**: ``keep`` (continue in place — no device
  op at all), or ``clone`` (the lane inherits a donor lane's weights AND
  optimizer state via the compiled ``make_lane_clone`` op — no ``pbt_ckpt``
  host round-trip, no generation bubble).  Exploit decisions come from an
  asynchronous quantile rule over a sliding window of member scores
  (``PBTLifecycle``), mirroring how the staggered in-flight SHA rule replaces
  Hyperband's cohort rung.  With ``sync_rounds=True`` (the default) rounds
  are gated so every member finishes round ``r`` before any round ``r+1``
  proposal is issued — decisions (and RNG draws) then match the
  generation-barriered driver exactly, which is what the equivalence tests
  and benchmarks pin; ``sync_rounds=False`` unlocks the fully asynchronous
  rule (fast members lap slow ones; the window is the only cohort).

Aux config keys planted by the streaming mode: ``pbt_member`` / ``pbt_round``
/ ``pbt_lifecycle`` (``init`` | ``keep`` | ``clone``) / ``pbt_donor`` (donor
*member* id, clone only) / ``stream`` (the member's stable data stream).
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from . import Proposer, register

DIVERGED_SCORE = -1e9


def window_quantile(scores, count, quantile, xp=None):
    """``(lo, hi)`` quantile scores of a sliding window, as a pure array op.

    ``scores`` is the window as a fixed-size ring buffer (length W);
    ``count`` is how many appends it has ever absorbed, so the valid region
    is the first ``min(count, W)`` slots (a full ring is valid everywhere).
    ``lo`` is the k-th smallest and ``hi`` the k-th largest valid score with
    ``k = max(1, int(quantile * n))`` — exactly the thresholds
    ``PBTLifecycle.decide`` reads off its sorted window, but expressed
    through ``xp`` (NumPy or ``jax.numpy``) so the population engines can
    evaluate it *inside* a fused scan (``--device-rules`` with
    ``--pbt-async``): invalid slots are masked to +/-inf so they sort to the
    far ends, and both thresholds come from one sort each.
    """
    import numpy as np

    if xp is None:
        xp = np
    w = scores.shape[0]
    n = xp.minimum(xp.asarray(count), w)
    k = xp.maximum(1, (xp.asarray(quantile) * n.astype(scores.dtype))
                   .astype(xp.int32))
    valid = xp.arange(w) < n
    asc_lo = xp.sort(xp.where(valid, scores, xp.inf))
    asc_hi = xp.sort(xp.where(valid, scores, -xp.inf))
    return xp.take(asc_lo, k - 1), xp.take(asc_hi, w - k)


def perturb_config(space, cfg: Dict[str, Any], rng, factor: float) -> Dict[str, Any]:
    """The explore rule, shared by both PBT modes (their decision-for-decision
    equivalence depends on consuming the RNG identically): floats scale by
    ``factor`` (or its inverse) through the unit cube, choices resample with
    p=0.25."""
    new_cfg = dict(cfg)
    for p in space:
        if p.type == "choice":
            if rng.uniform() < 0.25:
                new_cfg[p.name] = p.sample(rng)
        else:
            f = factor if rng.uniform() < 0.5 else 1.0 / factor
            u = p.to_unit(new_cfg[p.name])
            # perturb in unit space, clamped to the cube
            new_cfg[p.name] = p.from_unit(min(1.0, max(0.0, u * f)))
    return new_cfg


class PBTLifecycle:
    """Shared PBT decision rule + lane registry + donor pins.

    One object, two threads: the *proposer* half (``note_result`` /
    ``decide``) runs on the experiment loop thread and implements the
    asynchronous exploit/explore rule over a sliding window of the last
    ``window`` member scores; the *engine* half (``bind`` / ``lane_of`` /
    ``lease_blocked`` / ``clone_done``) runs on the streaming flight worker,
    which consults it on lane retirement and lease to map directives onto
    lane-lifecycle device ops.

    Donor pinning: when ``decide`` issues a clone, the donor member is pinned
    until the engine executes the device copy (``clone_done``).  A pinned
    member's own next-round ``keep`` lease is deferred (``lease_blocked``) so
    the donor lane cannot resume training — and advance its weights — between
    the exploit decision and the copy.  Pins release on terminal failure of
    the clone job too (``abandon``), so a dead clone cannot deadlock its
    donor.
    """

    def __init__(self, space, perturb: float = 1.2, quantile: float = 0.25,
                 window: int = 8, rng=None):
        import numpy as np

        self.space = space
        self.perturb = float(perturb)
        self.quantile = float(quantile)
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self._lock = threading.Lock()
        # (member, score, round) — round is None for legacy callers; it feeds
        # the decision-lag telemetry only, never the decision rule itself
        self.window: deque = deque(maxlen=max(2, int(window)))
        self.last_score: Dict[int, float] = {}
        # decision-lag telemetry: for every exploit/explore decision at round
        # r, how stale each window entry informing it was, in rounds
        # ((r - 1) - entry_round).  Gated (sync_rounds) mode is all zeros by
        # construction; --pbt-async spreads — the `pbt_async_quality` bench
        # row histograms this to quantify what dropping the gate costs.
        self.decision_lags: List[int] = []
        # engine registry: member -> (flight epoch, lane).  A flight that dies
        # loses its device state, so a stale epoch means the member's weights
        # are gone and the engine must fall back to a fresh init.
        self._lane: Dict[int, Tuple[int, int]] = {}
        # donor pins, keyed by the clone that created them ((member, round)):
        # releasing is idempotent, so a clone that is retried after its copy
        # already ran cannot double-release its donor
        self._pins: Dict[Tuple[int, int], int] = {}
        self._wait_tokens: set = set()  # jobs counted as donor waits (once)
        self.n_clones = 0
        self.n_keeps = 0
        self.n_donor_waits = 0
        # --device-rules: the fused scan evaluates the window quantile itself
        # (window_quantile as an in-scan op) and latches a per-lane verdict at
        # the lane's budget end; the engine reports it here keyed by (member,
        # round) and decide() consumes it instead of re-deriving the bottom
        # test on the host.  Off by default — enable_device_rule() is called
        # by the driver only under --device-rules + --pbt-async.
        self.device_rule_on = False
        self._device_verdicts: Dict[Tuple[int, int], Tuple[bool, float, float]] = {}
        self.n_device_verdicts = 0

    # -- proposer side ----------------------------------------------------------
    def note_result(self, member: int, score: float, rnd: Optional[int] = None) -> None:
        with self._lock:
            self.window.append((int(member), float(score),
                                None if rnd is None else int(rnd)))
            self.last_score[int(member)] = float(score)

    def enable_device_rule(self) -> None:
        """Switch decide() to consume scan-emitted window-quantile verdicts
        (--device-rules with --pbt-async).  Rounds without a verdict — e.g. a
        member retired early by a host divergence poll — fall back to the
        host rule, so the switch degrades gracefully."""
        self.device_rule_on = True

    def window_snapshot(self) -> List[Tuple[int, float, Optional[int]]]:
        """The window's entries oldest-first, for lowering to the scan's ring
        buffer before a device-rule dispatch."""
        with self._lock:
            return list(self.window)

    def note_device_verdict(self, member: int, rnd: int, bottom: bool,
                            lo: float, hi: float) -> None:
        """Record the scan's latched verdict for the member's round ``rnd``:
        whether its end-of-round score sat in the bottom quantile of the
        device-side sliding window, plus the (lo, hi) thresholds it saw."""
        with self._lock:
            self._device_verdicts[(int(member), int(rnd))] = (
                bool(bottom), float(lo), float(hi))
            self.n_device_verdicts += 1

    def decide(self, member: int, own_cfg: Dict[str, Any],
               rnd: Optional[int] = None) -> Tuple[str, Optional[int], Dict[str, Any]]:
        """``(lifecycle, donor_member, hparams_cfg)`` for the member's next round.

        Exploit iff the member's latest score sits in the bottom ``quantile``
        of the sliding window and a distinct, finite-scored donor exists in
        the top quantile — then the donor's hyperparameters are perturbed
        (floats scaled by ``perturb`` up or down through the unit cube,
        choices resampled with p=0.25) and the donor member is pinned until
        the device copy lands.  Otherwise the member keeps its own
        hyperparameters and weights untouched.  ``rnd`` (the round being
        decided) only feeds ``decision_lags`` telemetry.
        """
        with self._lock:
            entries = list(self.window)
            my = self.last_score.get(int(member))
            verdict = (self._device_verdicts.pop((int(member), int(rnd) - 1), None)
                       if self.device_rule_on and rnd is not None else None)
        if rnd is not None:
            # staleness of the evidence behind this decision: a gated run
            # decides round r strictly from round r-1 scores (lag 0); the
            # async rule may be looking at arbitrarily old rounds
            lags = [max(0, int(rnd) - 1 - er) for _, _, er in entries
                    if er is not None]
            with self._lock:
                self.decision_lags.extend(lags)
        scores = [s for _, s, _ in entries]
        n = len(scores)
        if my is None or n < 2:
            return "keep", None, dict(own_cfg)
        k = max(1, int(self.quantile * n))
        lo = sorted(scores)[k - 1]
        # top-quantile donors: distinct members, best score first, never self,
        # never a diverged sentinel
        hi = sorted(scores, reverse=True)[k - 1]
        if verdict is not None:
            # the scan already judged this round against the window it saw at
            # the lane's budget end — its bottom-quantile bit and thresholds
            # replace the host re-derivation; donors still come from the host
            # window (the device log carries verdicts, not donor identities)
            is_bottom, _dev_lo, hi = verdict
        else:
            is_bottom = not (my > lo)
        donors: List[int] = []
        for m, s, _ in sorted(entries, key=lambda ms: -ms[1]):
            if s >= hi and s > DIVERGED_SCORE and m != member and m not in donors:
                donors.append(m)
        if not is_bottom or not donors:
            with self._lock:
                self.n_keeps += 1
            return "keep", None, dict(own_cfg)
        donor = donors[int(self.rng.integers(len(donors)))]
        new_cfg = self._perturb(self._member_cfg(donor))
        with self._lock:
            self.n_clones += 1
        return "clone", donor, new_cfg

    def pin(self, config: Dict[str, Any]) -> None:
        """Pin the clone's donor until its device copy lands (or the clone
        dies for good).  Keyed by the clone job's (member, round), so release
        is idempotent across retries."""
        donor, token = config.get("pbt_donor"), self._token(config)
        if donor is None or token is None:
            return
        with self._lock:
            self._pins[token] = int(donor)

    @staticmethod
    def _token(config: Dict[str, Any]) -> Optional[Tuple[int, int]]:
        m, r = config.get("pbt_member"), config.get("pbt_round")
        return None if m is None or r is None else (int(m), int(r))

    def _member_cfg(self, member: int) -> Dict[str, Any]:
        """Hook point: the proposer stores members' current hparams here."""
        return dict(self.member_cfgs[member])

    def _perturb(self, cfg: Dict[str, Any]) -> Dict[str, Any]:
        return perturb_config(self.space, cfg, self.rng, self.perturb)

    # -- engine side ------------------------------------------------------------
    def bind(self, member: int, lane: int, epoch: int) -> None:
        with self._lock:
            self._lane[int(member)] = (int(epoch), int(lane))

    def lane_of(self, member: int, epoch: int) -> Optional[int]:
        """The member's lane in the current flight, or None when the member's
        device state belongs to a dead flight (fall back to a fresh init)."""
        with self._lock:
            got = self._lane.get(int(member))
        if got is None or got[0] != int(epoch):
            return None
        return got[1]

    def pinned(self, member: int) -> bool:
        with self._lock:
            return int(member) in self._pins.values()

    def lease_blocked(self, config: Dict[str, Any]) -> bool:
        """True when leasing this job now would let a pinned donor's lane
        resume training before an outstanding clone copies its weights.
        ``n_donor_waits`` counts each deferred job once, however many times
        the scheduler re-polls it."""
        if config.get("pbt_lifecycle") != "keep":
            return False
        member = config.get("pbt_member")
        if member is None or not self.pinned(member):
            return False
        token = self._token(config)
        with self._lock:
            if token not in self._wait_tokens:
                self._wait_tokens.add(token)
                self.n_donor_waits += 1
        return True

    def _release(self, config: Dict[str, Any]) -> None:
        token = self._token(config)
        if token is not None:
            with self._lock:
                self._pins.pop(token, None)

    def clone_done(self, config: Dict[str, Any]) -> None:
        """The engine executed this clone's device copy: release the donor."""
        self._release(config)

    def abandon(self, config: Dict[str, Any]) -> None:
        """A clone job died for good before its copy ran: release the donor so
        its next round is not deferred forever."""
        if config.get("pbt_lifecycle") == "clone":
            self._release(config)


@register("pbt")
class PBTProposer(Proposer):
    def __init__(self, space, population: int = 8, n_generations: int = None,
                 perturb: float = 1.2, quantile: float = 0.25,
                 streaming: bool = False, window: int = 0,
                 sync_rounds: bool = True, **kwargs):
        super().__init__(space, **kwargs)
        self.population = int(population)
        self.n_generations = int(n_generations or max(1, self.n_samples // self.population))
        self.n_samples = self.population * self.n_generations
        self.perturb = float(perturb)
        self.quantile = float(quantile)
        self.members: List[Dict[str, Any]] = [self.space.sample(self.rng) for _ in range(self.population)]
        self.streaming = bool(streaming)
        # -- generation-barriered state ----------------------------------------
        self.gen = 0
        self.gen_issued: set = set()
        self.gen_results: Dict[int, float] = {}
        # -- streaming state ----------------------------------------------------
        self.sync_rounds = bool(sync_rounds)
        self.member_round = [0] * self.population
        self.member_outstanding = [False] * self.population
        # sync mode: the current round's configs, decided atomically at the
        # barrier (pins included) and handed out one get_param at a time
        self._round_queue: List[Dict[str, Any]] = []
        self._lifecycle: Optional[PBTLifecycle] = None
        if self.streaming:
            self._lifecycle = PBTLifecycle(
                space, perturb=self.perturb, quantile=self.quantile,
                window=int(window) or self.population, rng=self.rng,
            )
            self._lifecycle.member_cfgs = self.members

    def lifecycle_hook(self) -> Optional[PBTLifecycle]:
        """The engine-facing half of the streaming proposer (sibling of the
        rung proposers' ``inflight_hook``): the lane-refill engine consults it
        on lane retirement/lease to execute keep/clone directives as compiled
        lane-lifecycle ops.  None in generation-barriered mode."""
        return self._lifecycle

    # -- proposal ---------------------------------------------------------------
    def _propose(self) -> Optional[Dict[str, Any]]:
        if self.streaming:
            return self._propose_streaming()
        if self.gen >= self.n_generations:
            return None
        for m in range(self.population):
            if m not in self.gen_issued and m not in self.gen_results:
                self.gen_issued.add(m)
                cfg = dict(self.members[m])
                cfg.update(pbt_member=m, pbt_gen=self.gen, pbt_ckpt=f"m{m}")
                return cfg
        if len(self.gen_results) >= self.population:
            self._exploit_explore()
        return None  # generation barrier

    def _propose_streaming(self) -> Optional[Dict[str, Any]]:
        if self.sync_rounds:
            # decide the WHOLE round atomically at the barrier: every member's
            # directive (and every donor pin) exists before the first config
            # leaves the proposer, so no interleaving of Experiment loop
            # passes can lease a donor's next round ahead of the clone that
            # still needs its round-boundary weights
            if not self._round_queue:
                gate = min(self.member_round)
                if gate < self.n_generations:
                    # members AT the gate and not in flight: the full
                    # population in normal operation (a round only unblocks
                    # once every member finished the previous one), the
                    # not-yet-reissued remainder after a crash-resume (the
                    # outstanding members' configs ride the requeue path)
                    self._round_queue = [
                        self._decide_member(m, gate)
                        for m in range(self.population)
                        if self.member_round[m] == gate
                        and not self.member_outstanding[m]
                    ]
            if self._round_queue:
                cfg = self._round_queue.pop(0)
                self.member_outstanding[cfg["pbt_member"]] = True
                return cfg
            return None  # round barrier
        for m in range(self.population):
            r = self.member_round[m]
            if self.member_outstanding[m] or r >= self.n_generations:
                continue
            cfg = self._decide_member(m, r)
            self.member_outstanding[m] = True
            return cfg
        return None  # every ready member is in flight

    def _decide_member(self, m: int, r: int) -> Dict[str, Any]:
        if r == 0:
            lifecycle, donor, cfg = "init", None, dict(self.members[m])
        else:
            lifecycle, donor, cfg = self._lifecycle.decide(
                m, self.members[m], rnd=r)
            self.members[m] = dict(cfg)
        cfg.update(pbt_member=m, pbt_round=r, pbt_lifecycle=lifecycle, stream=m)
        if donor is not None:
            cfg["pbt_donor"] = donor
            self._lifecycle.pin(cfg)
        return cfg

    # -- results ----------------------------------------------------------------
    def _exploit_explore(self) -> None:
        ranked = sorted(self.gen_results.items(), key=lambda kv: -kv[1])
        k = max(1, int(self.quantile * self.population))
        top = [m for m, _ in ranked[:k]]
        bottom = [m for m, _ in ranked[-k:]]
        for loser in bottom:
            donor = top[int(self.rng.integers(len(top)))]
            new_cfg = perturb_config(
                self.space, self.members[donor], self.rng, self.perturb)
            new_cfg["pbt_inherit"] = f"m{donor}"  # job restores donor checkpoint
            self.members[loser] = new_cfg
        self.gen += 1
        self.gen_issued = set()
        self.gen_results = {}

    def _on_result(self, config: Dict[str, Any], score: float) -> None:
        if self.streaming:
            m, r = config.get("pbt_member"), config.get("pbt_round")
            if m is None or r is None:
                return
            self._lifecycle.note_result(m, score, rnd=int(r))
            self.member_outstanding[m] = False
            self.member_round[m] = max(self.member_round[m], int(r) + 1)
            return
        m = config.get("pbt_member")
        if m is not None and config.get("pbt_gen") == self.gen:
            self.gen_results[m] = score
            self.gen_issued.discard(m)

    def _on_failure(self, config: Dict[str, Any]) -> None:
        if self.streaming and self._lifecycle is not None:
            # a clone that will never execute must release its donor pin
            self._lifecycle.abandon(config)
        self._on_result(config, float("-inf"))

    def finished(self) -> bool:
        if self.streaming:
            return (all(r >= self.n_generations for r in self.member_round)
                    and not any(self.member_outstanding))
        return self.gen >= self.n_generations

    def replay(self, rows) -> None:
        """Rebuild state from tracking-DB rows without double-issuing a
        generation/round.

        Generation-barriered mode replays *incrementally*: each finished row
        lands in its own generation's results and ``_exploit_explore`` fires
        the moment a generation completes — exactly like the live path — so
        rows spanning several generations advance ``gen`` (and consume the
        perturbation RNG) in the same order a never-crashed run would.  Rows
        still ``running`` at the crash mark their member as issued: the
        Experiment re-queues those jobs directly, so proposing the member
        again would double-issue it.

        Streaming mode restores each member's round cursor, hyperparameters
        (the decided config is materialized in the row itself) and the score
        window; ``running`` rows mark the member outstanding.  The decision
        RNG is *not* rewound, so post-resume exploit draws may differ from the
        never-crashed run — decisions already made are preserved verbatim.
        """
        if self.streaming:
            self._replay_streaming(rows)
            return
        for r in rows:
            if r.get("status") == "finished" and r.get("score") is not None:
                cfg = r["config"]
                self.n_proposed += 1
                self.n_updated += 1
                sc = float(r["score"]) if self.maximize else -float(r["score"])
                self.history.append({"config": cfg, "score": sc})
                if cfg.get("pbt_gen") == self.gen and cfg.get("pbt_member") is not None:
                    self.gen_results[cfg.get("pbt_member")] = sc
                    # the live path advances the moment a generation completes;
                    # replay must too, or later generations' rows are dropped
                    # and the next _propose re-issues an already-run generation
                    if len(self.gen_results) >= self.population:
                        self._exploit_explore()
            elif r.get("status") in ("failed", "killed", "lost"):
                cfg = r["config"]
                self.n_proposed += 1
                self.n_failed += 1
                if cfg.get("pbt_gen") == self.gen and cfg.get("pbt_member") is not None:
                    self.gen_results[cfg.get("pbt_member")] = float("-inf")
                    if len(self.gen_results) >= self.population:
                        self._exploit_explore()
            elif r.get("status") == "running":
                # mid-flight at the crash: the Experiment re-queues this exact
                # job, so its member counts as issued for the current gen
                cfg = r["config"]
                if cfg.get("pbt_gen") == self.gen and cfg.get("pbt_member") is not None:
                    self.gen_issued.add(cfg["pbt_member"])

    def _replay_streaming(self, rows) -> None:
        for r in rows:
            cfg = r["config"]
            m, rnd = cfg.get("pbt_member"), cfg.get("pbt_round")
            if m is None or rnd is None:
                continue
            base = {k: v for k, v in cfg.items()
                    if not k.startswith("pbt_") and k not in ("job_id", "stream")}
            self.members[m] = base
            if r.get("status") == "finished" and r.get("score") is not None:
                sc = float(r["score"]) if self.maximize else -float(r["score"])
                self.n_proposed += 1
                self.n_updated += 1
                self.history.append({"config": cfg, "score": sc})
                self._lifecycle.note_result(m, sc, rnd=int(rnd))
                self.member_round[m] = max(self.member_round[m], int(rnd) + 1)
            elif r.get("status") in ("failed", "killed", "lost"):
                self.n_proposed += 1
                self.n_failed += 1
                self._lifecycle.note_result(m, float("-inf"), rnd=int(rnd))
                self.member_round[m] = max(self.member_round[m], int(rnd) + 1)
            elif r.get("status") == "running":
                # the Experiment re-queues this job; issuing the member again
                # would double-run the round
                self.member_round[m] = max(self.member_round[m], int(rnd))
                self.member_outstanding[m] = True
