"""Host-side hedge lifecycle for the speculation plane.

A copy of ``tpu_faas/spec/policy.py`` for the PyTorch port (which imports
nothing of the JAX package); it touches no device.

The device tick flags stragglers (spec/straggler.py); this module owns what
the dispatcher does about them: the opt-in policy knobs, the wasted-work
budget, and the per-task hedge book that tracks each replica from launch to
first-wins resolution. The store is never taught anything new — the hedge
is the SAME task id dispatched to a second worker behind a declared replica
(store ``declare_replica``, racecheck ``expect_replica``), both results
write through the existing first-wins ``finish_task`` path, and the loser
is killed through the existing CANCEL plane.

Invariants the book enforces (the dispatcher drives the transitions):

- at most ONE outstanding hedge per task id (a slot re-flagged by the tick
  while its hedge is pending/running is ignored);
- the wasted-work budget is a hard gate: ``hedges_launched`` never exceeds
  ``max_frac x tasks_dispatched`` (suppressions are counted, not silent);
- exactly-once accounting on every exit path — replica wins, original
  wins, hedge worker dies (abandon), original's worker dies (the hedge is
  PROMOTED to owner instead of re-queuing the task), task cancelled —
  because every exit pops the entry exactly once and releases exactly the
  charges that entry recorded.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from tpu_faas_torch.spec.straggler import DEFAULT_MIN_RUNTIME_S

#: resolved hedges whose loser's late result is still expected: bounded
#: map for wasted-work attribution (a loser that never reports ages out)
_LOSER_CAP = 10_000


@dataclass
class HedgeEntry:
    """One task's outstanding hedge, from consider to resolution."""

    task_id: str
    #: worker row running the ORIGINAL when the hedge was considered —
    #: the anti-affinity row the ghost placement must avoid
    orig_row: int
    launched_at: float
    #: set when the replica actually dispatches (None = ghost row still
    #: pending placement)
    hedge_row: int | None = None
    hedge_wid: bytes | None = None
    #: the replica's own tenant inflight charge (a hedge burns the
    #: tenant's share like any dispatch), released at resolution
    tenant_row: int | None = None
    #: the task's SLO class (obs/attribution.py), stamped at launch so
    #: resolution can attribute the outcome per class without a re-read
    cls: str = "default"

    @property
    def dispatched(self) -> bool:
        return self.hedge_row is not None


class SpeculationPolicy:
    """Policy knobs + hedge book + counters for one dispatcher.

    ``quantile_mult`` — flag an execution past this multiple of its
    predicted runtime (the device threshold); ``max_frac`` — hard ceiling
    on hedges_launched / tasks_dispatched (the wasted-work budget);
    ``min_runtime_s`` — absolute floor under which nothing hedges.
    """

    def __init__(
        self,
        quantile_mult: float,
        max_frac: float = 0.1,
        min_runtime_s: float = DEFAULT_MIN_RUNTIME_S,
        clock=time.monotonic,
    ) -> None:
        if not quantile_mult > 1.0:
            raise ValueError(
                "--speculate-mult must be > 1 (flag past that multiple of "
                "the predicted runtime)"
            )
        if not 0.0 < max_frac <= 1.0:
            raise ValueError("--speculate-max-frac must be in (0, 1]")
        self.quantile_mult = float(quantile_mult)
        self.max_frac = float(max_frac)
        self.min_runtime_s = max(0.0, float(min_runtime_s))
        self.clock = clock
        self.entries: dict[str, HedgeEntry] = {}
        #: task_id -> loser worker row: resolved hedges whose loser's late
        #: result is still in flight somewhere (wasted-work attribution)
        self._losers: dict[str, int] = {}
        self.n_launched = 0
        self.n_replica_wins = 0
        self.n_original_wins = 0
        self.n_promoted = 0
        self.n_abandoned = 0
        self.n_suppressed_budget = 0
        #: loser execution seconds actually reported back (the measured
        #: wasted work; losers killed pre-start report ~0)
        self.wasted_exec_s = 0.0

    # -- gates -------------------------------------------------------------
    def within_budget(self, n_dispatched: int) -> bool:
        """Would one more hedge keep hedges_launched / tasks <= max_frac?
        Callers pass the PRIMARY dispatch count (hedges excluded — the
        dispatcher subtracts ``n_launched`` from its total): a denominator
        that counted hedges would loosen the bound to f/(1-f) under heavy
        hedging, breaking the documented hard-budget contract."""
        return (self.n_launched + 1) <= self.max_frac * max(n_dispatched, 1)

    def consider(self, task_id: str, orig_row: int, n_dispatched: int):
        """Admit one straggler flag into the book: returns the new entry,
        or None when a hedge is already outstanding for the id or the
        budget is spent (counted)."""
        if task_id in self.entries:
            return None
        if not self.within_budget(n_dispatched):
            self.n_suppressed_budget += 1
            return None
        entry = HedgeEntry(task_id, int(orig_row), self.clock())
        self.entries[task_id] = entry
        self.n_launched += 1
        return entry

    # -- resolution --------------------------------------------------------
    def resolve(self, task_id: str, *, winner: str, loser_row: int) -> None:
        """Pop the entry on a first result; remember the loser for
        wasted-work attribution when its late result straggles in."""
        self.entries.pop(task_id, None)
        if winner == "replica":
            self.n_replica_wins += 1
        else:
            self.n_original_wins += 1
        if len(self._losers) >= _LOSER_CAP:
            self._losers.pop(next(iter(self._losers)), None)
        self._losers[task_id] = int(loser_row)

    def note_loser_result(
        self, task_id: str, sender_row, elapsed
    ) -> float | None:
        """A late result arrived for a task whose hedge already resolved:
        account its execution window as wasted work — but only when it
        came from the recorded LOSER's worker row (a winner's duplicate
        retransmit for the same id must not consume the entry and book
        the winner's window as waste). ``sender_row=None`` (unknown/
        purged sender) never matches — conservative: unattributable
        windows stay uncounted. Returns the seconds counted (0.0 for a
        pre-start kill with no window) when consumed, None otherwise."""
        row = self._losers.get(task_id)
        if row is None or sender_row is None or int(sender_row) != row:
            return None
        self._losers.pop(task_id, None)
        secs = (
            float(elapsed)
            if isinstance(elapsed, (int, float)) and elapsed > 0
            else 0.0
        )
        self.wasted_exec_s += secs
        return secs

    def abandon(self, task_id: str) -> HedgeEntry | None:
        """Drop an entry without a winner (hedge worker died, task
        cancelled/expired, original reclaimed pre-dispatch)."""
        entry = self.entries.pop(task_id, None)
        if entry is not None:
            self.n_abandoned += 1
        return entry

    def promote(self, task_id: str) -> HedgeEntry | None:
        """The ORIGINAL's worker died with the replica still running: the
        replica becomes the task's plain owner (no re-queue). Pops the
        entry; the caller moves the inflight table over."""
        entry = self.entries.pop(task_id, None)
        if entry is not None:
            self.n_promoted += 1
        return entry

    def stats(self) -> dict:
        # oldest outstanding hedge age: a value that keeps GROWING while
        # `outstanding` sits nonzero is a stuck race — a loser whose kill
        # never landed, or a ghost with no capacity off its sick worker
        oldest = (
            round(
                self.clock()
                - min(e.launched_at for e in self.entries.values()),
                3,
            )
            if self.entries
            else None
        )
        return {
            "quantile_mult": self.quantile_mult,
            "max_frac": self.max_frac,
            "min_runtime_s": self.min_runtime_s,
            "outstanding": len(self.entries),
            "oldest_outstanding_s": oldest,
            "launched": self.n_launched,
            "replica_wins": self.n_replica_wins,
            "original_wins": self.n_original_wins,
            "promoted": self.n_promoted,
            "abandoned": self.n_abandoned,
            "suppressed_budget": self.n_suppressed_budget,
            "wasted_exec_s": round(self.wasted_exec_s, 3),
        }
