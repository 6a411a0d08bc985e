"""Deterministic fault injection for the crash-safety paths.

Recovery code that only runs when something actually dies is recovery code
that never runs in CI.  This module lets tests (and the ``chaos`` CI lane)
arm *precise, reproducible* faults at well-defined points of the execution —
no random kill loops, no sleeps, no flakes — so every recovery path
(supervised flight restart, lane snapshot/restore, ``--resume``, poison-lane
quarantine) is exercised by construction.

A fault *plan* is parsed from a spec string (CLI ``--fault-spec`` or the
``REPRO_FAULT_SPEC`` env var — the env form is how the subprocess SIGKILL
harness arms a child process).  Clauses are ``;``-separated::

    raise@step=K[,times=N]     raise InjectedFault in the flight loop once the
                               global flight step reaches K (N firings, default 1)
    nan@lane=L,step=K          poison lane L's loss to NaN at flight step K
                               (sets the divergence latch — the engine's
                               ordinary divergence path takes over)
    kill@event=N               SIGKILL the process at the N-th streaming event
                               boundary (counted across flights, after any due
                               snapshot harvest — "crash at an arbitrary event
                               boundary")
    raise@issue=N              raise in the Experiment loop right before job N
                               is issued (the classic between-batches crash)

The instrumented sites call :func:`check` / :func:`poison_lanes`; both are
no-ops (one ``is None`` test) when no plan is armed, so production runs pay
nothing.  Fired clauses are recorded on the plan (``plan.fired``) for test
assertions.
"""
from __future__ import annotations

import dataclasses
import os
import signal
from typing import Any, Dict, List, Optional, Tuple

ENV_VAR = "REPRO_FAULT_SPEC"


class InjectedFault(RuntimeError):
    """Raised by an armed ``raise`` clause — stands in for a flight death."""


@dataclasses.dataclass
class _Clause:
    action: str          # "raise" | "kill" | "nan"
    site: str            # "flight-step" | "event" | "issue" | "lane-nan"
    cond: Dict[str, int]
    times: int           # firings left
    spec: str            # original clause text, for messages/telemetry


def _parse_clause(text: str) -> _Clause:
    action, _, rest = text.partition("@")
    action = action.strip().lower()
    if action not in ("raise", "kill", "nan"):
        raise ValueError(f"unknown fault action {action!r} in {text!r}")
    cond: Dict[str, int] = {}
    times = 1
    for part in filter(None, (p.strip() for p in rest.split(","))):
        key, _, val = part.partition("=")
        if not val:
            raise ValueError(f"malformed fault condition {part!r} in {text!r}")
        if key == "times":
            times = int(val)
        else:
            cond[key] = int(val)
    if action == "nan":
        if "lane" not in cond or "step" not in cond:
            raise ValueError(f"nan fault needs lane= and step=: {text!r}")
        site = "lane-nan"
    elif "event" in cond:
        site = "event"
    elif "issue" in cond:
        site = "issue"
    elif "step" in cond:
        site = "flight-step"
    else:
        raise ValueError(f"fault {text!r} needs a step=/event=/issue= condition")
    return _Clause(action=action, site=site, cond=cond, times=times, spec=text)


class FaultPlan:
    """A parsed, stateful fault plan.  Clauses fire at most ``times`` each;
    firings are appended to ``fired`` as ``(clause_spec, coords)``."""

    def __init__(self, spec: str):
        self.spec = spec
        self.clauses: List[_Clause] = [
            _parse_clause(c) for c in filter(None, (s.strip() for s in spec.split(";")))
        ]
        if not self.clauses:
            raise ValueError(f"empty fault spec {spec!r}")
        self.fired: List[Tuple[str, Dict[str, Any]]] = []

    def _fire(self, clause: _Clause, coords: Dict[str, Any]) -> None:
        clause.times -= 1
        self.fired.append((clause.spec, dict(coords)))
        if clause.action == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        raise InjectedFault(f"injected fault {clause.spec!r} at {coords}")

    def check(self, site: str, **coords: int) -> None:
        """Fire any armed clause matching ``site`` whose threshold is reached.

        Thresholds compare ``>=`` on the site's coordinate (``step``, ``event``
        or ``issue``), so a site polled at coarse granularity (chunked flights,
        event boundaries) still fires at the first opportunity past K.
        """
        for clause in self.clauses:
            if clause.site != site or clause.times <= 0:
                continue
            key = {"flight-step": "step", "event": "event", "issue": "issue"}[site]
            if coords.get(key, -1) >= clause.cond[key]:
                self._fire(clause, coords)

    def poison_lanes(self, step: int) -> List[int]:
        """Lanes whose ``nan`` clause is due at flight step ``step`` (each
        clause fires once; the caller NaNs the lane's loss / sets the latch)."""
        out = []
        for clause in self.clauses:
            if clause.site == "lane-nan" and clause.times > 0 \
                    and step >= clause.cond["step"]:
                clause.times -= 1
                self.fired.append((clause.spec, {"step": step}))
                out.append(clause.cond["lane"])
        return out


_PLAN: Optional[FaultPlan] = None
_ENV_CHECKED = False


def arm(spec: str) -> FaultPlan:
    """Arm a fault plan for this process (replaces any previous plan)."""
    global _PLAN, _ENV_CHECKED
    _PLAN = FaultPlan(spec)
    _ENV_CHECKED = True
    return _PLAN


def disarm() -> None:
    global _PLAN, _ENV_CHECKED
    _PLAN = None
    _ENV_CHECKED = True  # an explicit disarm also wins over the env var


def get_plan() -> Optional[FaultPlan]:
    """The armed plan, if any.  Checks ``REPRO_FAULT_SPEC`` once, lazily, so a
    subprocess harness can arm a child by environment alone."""
    global _PLAN, _ENV_CHECKED
    if _PLAN is None and not _ENV_CHECKED:
        _ENV_CHECKED = True
        spec = os.environ.get(ENV_VAR, "").strip()
        if spec:
            _PLAN = FaultPlan(spec)
    return _PLAN


def check(site: str, **coords: int) -> None:
    """Module-level convenience: no-op unless a plan is armed."""
    plan = get_plan()
    if plan is not None:
        plan.check(site, **coords)
