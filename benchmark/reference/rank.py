"""The resident rank-matching tick's placement, in plain NumPy.

The rule is the scheduler's documented rank matching (the placement
rule of ``sched/greedy.py``, as the resident tick reports it): expand each
live worker into its free process slots, at most ``max_slots`` of them;
order the slots by the worker's speed, fastest first; admit the valid
pending tasks first come, first served, as many as there are slots; order
the admitted tasks by size, largest first; pair them rank for rank: the
i-th largest task goes to the i-th fastest slot's worker. The tick then
reports the first ``KP`` placements in pending-slot order; a placement
past them is not reported, keeps its task pending and takes no process.

Where the documented rule had to be read more closely:

- Ties. Both orders are stable sorts on the key negated: slots of equal
  speed keep slot order (``row * max_slots + k``, so the lower row first),
  tasks of equal size keep pending-slot order.
- "First come" is the pending slot's index, not the order of arrival: an
  arrival takes the free pending slot of lowest index, so a later call can
  sit ahead of an earlier one that took a higher slot.
- ``-0.0`` and ``0.0`` compare equal under the negated key and tie, broken
  by index as any tie (the sizes here are lognormal, never zero).
- A slot exists only below its worker's free count: a free count of zero
  or below gives none, as a worker that is not live does.
- The slot order is taken over the valid slots alone, and the task order
  over the admitted tasks alone: the program sorts every slot with the
  invalid ones keyed -inf and every task with the rest keyed -inf, which
  is the same order while no live worker's speed and no admitted size is
  -inf or NaN (none is here).
- ``KP`` bounds what the tick reports, not what it admits: admission is
  up to the slot count, and the cut to ``KP`` is by pending-slot index,
  after pairing.

Nothing here is taken from the program's code.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class RankTick:
    task_slots: np.ndarray  # i64 pending slots placed and reported, ascending
    rows: np.ndarray  # i64 worker row of each
    n_slots: int  # process slots kept (the live workers' free ones)
    n_admitted: int  # tasks admitted


def assignment(size: np.ndarray, valid: np.ndarray, speed: np.ndarray,
               free: np.ndarray, live: np.ndarray, max_slots: int
               ) -> np.ndarray:
    """The worker row of each pending slot, -1 where its task waits:
    i64[len(size)]."""
    K = max_slots
    slots_per_row = np.where(live, np.minimum(free, K), 0)
    rows = np.flatnonzero(slots_per_row > 0)
    # the valid slots in slot order, as their worker's row
    slot_row = np.repeat(rows, slots_per_row[rows])
    by_speed = slot_row[np.argsort(-speed[slot_row], kind="stable")]
    admitted = np.flatnonzero(valid)[:len(slot_row)]
    by_size = admitted[np.argsort(-size[admitted], kind="stable")]
    out = np.full(len(size), -1, dtype=np.int64)
    out[by_size] = by_speed[:len(by_size)]
    return out


def rank_tick(size, valid, speed, free, live, max_slots: int, kp: int
              ) -> RankTick:
    """One tick's reported placements and its work counts."""
    a = assignment(size, valid, speed, free, live, max_slots)
    placed = np.flatnonzero(a >= 0)  # every admitted task is paired
    n_slots = int(np.where(live, np.clip(free, 0, max_slots), 0).sum())
    return RankTick(placed[:kp], a[placed[:kp]], n_slots, len(placed))
