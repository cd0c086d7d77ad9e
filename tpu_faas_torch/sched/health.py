"""Health-scored worker quarantine (ROADMAP item 7).

The scheduler already keeps a per-row tail-health score
(``SchedulerArrays.worker_health``): hedge losers, pool-child misfires and
liveness reclaims decay it, and the tick passively recovers it toward 1.0
at ``HEALTH_RECOVERY_TAU``. Until now the score only *biased* placement
(effective speed = speed x health). This module adds the policy layer on
top: when a row's score falls past a threshold the worker is
**quarantined** — placement-masked via a per-row ceiling the fused tick
consumes (``worker_place_cap``: 0 = no new placements, 1 = canary probe,
huge = unconstrained) — and **probed** with canary tasks until its score
recovers, at which point it is released.

Design constraints, in order of priority:

1. **Never strand the fleet.** Quarantine is an optimization, not an
   admission decision. Hard floors (``min_live`` unquarantined workers and
   ``min_capacity_frac`` of registered capacity) are checked *before*
   every enter transition; a quarantine that would cross a floor is
   refused and counted, never queued.
2. **Drain, don't kill.** Entering quarantine stops NEW placements only.
   In-flight tasks on the sick worker run to completion (their results are
   accepted normally) or ride the ordinary liveness reclaim if the worker
   dies. The drain path never writes a terminal task status — enforced by
   a static-analysis rule (see tpu_faas/analysis).
3. **Health is the only signal.** Canary probes don't need their own
   result plumbing: a probe landing on a still-sick worker produces fresh
   evidence through the existing producers (misfires, hedge losses,
   reclaims decay the score and reset the release streak); a probe landing
   on a recovered worker lets passive recovery carry the score back over
   the release threshold.

The book is host-side policy — a few comparisons per maintenance pass over
[W] rows. The only thing the device ever sees is the i32[W] ceiling.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

#: placement ceiling for unconstrained rows — far above any real
#: worker_free, so jnp.minimum(free, cap) is the identity
HUGE_CAP = 1 << 20

#: transition kinds reported by QuarantineBook.update()
ENTER = "enter"
RELEASE = "release"
REFUSED = "refused"
PURGED = "purged"


@dataclass
class _RowState:
    entered_at: float
    last_canary: float = -float("inf")
    streak: int = 0  # consecutive update() passes with health >= release


@dataclass
class QuarantineBook:
    """Per-fleet quarantine policy over the scheduler's health scores.

    ``update()`` runs in the dispatcher maintenance path (same cadence as
    liveness reaping); ``place_cap()`` is read right before each tick.
    """

    max_workers: int
    #: quarantine a row when its health score falls below this
    enter_below: float = 0.35
    #: release requires the score back above this...
    release_above: float = 0.8
    #: ...for this many consecutive update() passes (a canary that
    #: re-poisons the score resets the streak)
    release_streak: int = 3
    #: seconds between canary probes while quarantined (cap=1 for one
    #: tick, else 0)
    canary_period_s: float = 2.0
    #: hard floor: at least this many active workers must remain
    #: unquarantined
    min_live: int = 1
    #: hard floor: unquarantined rows must retain at least this fraction
    #: of the fleet's registered capacity (procs)
    min_capacity_frac: float = 0.5
    clock: "callable" = time.monotonic

    #: lifetime counters (surfaced via /stats and plane-gated metrics)
    entered_total: int = 0
    released_total: int = 0
    refused_total: int = 0
    canaries_total: int = 0

    _rows: dict[int, _RowState] = field(default_factory=dict)
    _cap: np.ndarray = field(init=False)

    def __post_init__(self) -> None:
        self._cap = np.full(self.max_workers, HUGE_CAP, dtype=np.int32)

    # -- queries -----------------------------------------------------------
    def is_quarantined(self, row: int) -> bool:
        return row in self._rows

    @property
    def quarantined_rows(self) -> tuple[int, ...]:
        return tuple(sorted(self._rows))

    def quarantined_mask(self) -> np.ndarray:
        m = np.zeros(self.max_workers, dtype=bool)
        for row in self._rows:
            m[row] = True
        return m

    # -- policy ------------------------------------------------------------
    def _floors_allow(
        self,
        candidate: int,
        active: np.ndarray,
        procs: np.ndarray,
    ) -> bool:
        """Would quarantining ``candidate`` keep the fleet above both
        floors? Evaluated against the post-transition state."""
        quarantined_after = set(self._rows)
        quarantined_after.add(candidate)
        live_rows = np.flatnonzero(active)
        live_un = [r for r in live_rows if r not in quarantined_after]
        if len(live_un) < self.min_live:
            return False
        total_cap = int(procs[live_rows].sum())
        if total_cap <= 0:
            return False
        un_cap = int(sum(int(procs[r]) for r in live_un))
        return un_cap >= self.min_capacity_frac * total_cap

    def update(
        self,
        health: np.ndarray,
        active: np.ndarray,
        procs: np.ndarray,
        now: float | None = None,
    ) -> list[tuple[str, int]]:
        """One policy pass; returns the transitions taken this pass as
        ``(kind, row)`` pairs (ENTER/RELEASE/REFUSED/PURGED) so the caller
        can log/record them without the book knowing about recorders."""
        now_f = now if now is not None else self.clock()
        events: list[tuple[str, int]] = []
        # purged workers leave the book: the row is about to be recycled
        # and a fresh registrant must not inherit the quarantine (health
        # memory — SchedulerArrays.recall_health — carries the penalty
        # across identities instead)
        for row in [r for r in self._rows if not active[r]]:
            del self._rows[row]
            events.append((PURGED, row))
        # releases first: a release can free headroom that lets a sicker
        # row enter within the same pass
        for row, st in list(self._rows.items()):
            if float(health[row]) >= self.release_above:
                st.streak += 1
                if st.streak >= self.release_streak:
                    del self._rows[row]
                    self.released_total += 1
                    events.append((RELEASE, row))
            else:
                st.streak = 0
        # enters, sickest first (if the floors only admit some of the
        # candidates, mask the worst offenders)
        candidates = [
            int(r)
            for r in np.flatnonzero(active)
            if r not in self._rows and float(health[r]) < self.enter_below
        ]
        candidates.sort(key=lambda r: float(health[r]))
        for row in candidates:
            if self._floors_allow(row, active, procs):
                self._rows[row] = _RowState(entered_at=now_f)
                self.entered_total += 1
                events.append((ENTER, row))
            else:
                self.refused_total += 1
                events.append((REFUSED, row))
        return events

    def place_cap(self, now: float | None = None) -> np.ndarray:
        """The i32[W] ceiling for the next tick. Quarantined rows get 0;
        a row due for a canary gets 1 for exactly this call (one probe
        task may land); everyone else gets HUGE_CAP. Returns a fresh
        array each call — the tick's cached upload snapshots it."""
        now_f = now if now is not None else self.clock()
        cap = self._cap
        cap.fill(HUGE_CAP)
        for row, st in self._rows.items():
            if now_f - st.last_canary >= self.canary_period_s:
                st.last_canary = now_f
                self.canaries_total += 1
                cap[row] = 1
            else:
                cap[row] = 0
        return cap

    def stats(self) -> dict:
        return {
            "quarantined": list(self.quarantined_rows),
            "entered_total": self.entered_total,
            "released_total": self.released_total,
            "refused_total": self.refused_total,
            "canaries_total": self.canaries_total,
            "enter_below": self.enter_below,
            "release_above": self.release_above,
            "min_live": self.min_live,
            "min_capacity_frac": self.min_capacity_frac,
        }
