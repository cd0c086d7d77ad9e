"""Latency SLOs: configurable objectives + multi-window burn rates.

An :class:`Objective` says "at least ``target`` of events must land at or
under ``threshold_s`` seconds" — e.g. *p99 submit→result ≤ 250 ms* is
``Objective("submit_to_result", "total", 0.25, 0.99)``. The tracker
computes, per objective and per window (default 5 m and 1 h):

- the **good ratio** — the fraction of events inside the threshold over
  the window;
- the **burn rate** — ``(1 - good_ratio) / (1 - target)``: 1.0 burns the
  error budget exactly at the sustainable pace, 14.4 over 5 m is the
  classic page-now threshold (exhausts a 30-day budget in ~2 days).

The data source is the EXISTING fixed-bucket stage histograms
(``tpu_faas_task_stage_seconds`` on dispatchers, the gateway's e2e
histogram) — no per-event storage is added. Windowing works on a bounded
ring of cumulative-count snapshots taken at update time (scrapes and
``/slo`` hits both update), so sporadic scrapes degrade to a partial
window (reported as ``window_covered_s``) instead of lying.

Good events are counted at the largest bucket boundary ≤ the threshold —
a threshold between boundaries UNDERCOUNTS good events (conservative:
burn rates err toward alarming). Pick thresholds on bucket boundaries
(``LATENCY_BUCKETS``) to make the count exact.

Objectives are configurable via the ``TPU_FAAS_SLO`` environment variable:
``name=stage:threshold_s:target`` entries, comma-separated — e.g.
``TPU_FAAS_SLO="fast=total:0.25:0.99,queue=queue_wait:0.1:0.95"``.
Exposed as ``tpu_faas_slo_*`` gauges and the ``/slo`` endpoints.

**Per-class objectives** (the composed-SLO plane, obs/attribution.py):
``name=stage@class:threshold_s:target`` restricts the objective to one
SLO class — e.g. ``inter_p999=total@interactive:0.25:0.999``. The class
must be in the closed vocabulary (startup error otherwise), and the data
source must expose class-restricted reads (``TPU_FAAS_OBS_CLASS`` on):
against a class-blind source the objective honestly reports
``source_present=0`` instead of silently judging the aggregate.
"""

from __future__ import annotations

import bisect
import math
import os
import threading
import time
from collections import deque
from dataclasses import dataclass

from tpu_faas_torch.obs.attribution import SLO_CLASSES

#: env var carrying operator objectives (see module docstring)
SLO_ENV = "TPU_FAAS_SLO"

#: (label, seconds) burn-rate windows, shortest first
WINDOWS: tuple[tuple[str, float], ...] = (("5m", 300.0), ("1h", 3600.0))


@dataclass(frozen=True)
class Objective:
    name: str
    #: which latency distribution to judge — a stage of the task timeline
    #: on dispatchers ("total", "queue_wait", "execution", ...) or an e2e
    #: phase on the gateway ("submit_to_finish", "submit_to_observe")
    stage: str
    threshold_s: float
    #: required good fraction, e.g. 0.99 for a p99 objective
    target: float
    #: None judges the whole distribution; a class from the closed
    #: vocabulary (obs/attribution.py) judges that class's slice only —
    #: the source must support class-restricted reads
    cls: str | None = None

    def __post_init__(self) -> None:
        if not (0.0 < self.target < 1.0):
            raise ValueError(f"target must be in (0, 1): {self.target}")
        if not (self.threshold_s > 0 and math.isfinite(self.threshold_s)):
            raise ValueError(f"threshold must be positive: {self.threshold_s}")
        if self.cls is not None and self.cls not in SLO_CLASSES:
            raise ValueError(
                f"objective class {self.cls!r} not in {SLO_CLASSES}"
            )


def parse_objectives(spec: str) -> list[Objective]:
    """``name=stage[@class]:threshold_s:target`` entries, comma-separated.
    Raises ValueError with the offending entry — a typo'd objective must
    fail loudly at startup, not silently monitor nothing."""
    out: list[Objective] = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        try:
            name, rest = entry.split("=", 1)
            stage, threshold, target = rest.split(":")
            stage = stage.strip()
            cls: str | None = None
            if "@" in stage:
                stage, cls = stage.split("@", 1)
                stage, cls = stage.strip(), cls.strip()
            out.append(
                Objective(
                    name.strip(), stage, float(threshold), float(target), cls
                )
            )
        except ValueError as exc:
            raise ValueError(
                f"bad {SLO_ENV} entry {entry!r} "
                "(want name=stage[@class]:threshold_s:target)"
            ) from exc
    return out


def objectives_from_env(default: list[Objective]) -> list[Objective]:
    spec = os.environ.get(SLO_ENV, "").strip()
    if not spec:
        return list(default)
    return parse_objectives(spec)


#: dispatcher defaults: the ROADMAP item-2 bar (p99 submit→result ≤ 250 ms
#: for sub-ms functions) plus the queue-wait share of it
DEFAULT_DISPATCHER_OBJECTIVES = [
    Objective("submit_to_result", "total", 0.25, 0.99),
    Objective("queue_wait", "queue_wait", 0.1, 0.99),
]

#: gateway defaults: end-to-end as the CLIENT experiences it — the observe
#: phase includes the poll gap the dispatcher-side total cannot see
DEFAULT_GATEWAY_OBJECTIVES = [
    Objective("submit_to_finish", "submit_to_finish", 0.25, 0.99),
    Objective("submit_to_observe", "submit_to_observe", 0.5, 0.99),
]


@dataclass
class _Snap:
    t: float
    good: int
    total: int


class SLOTracker:
    """Multi-window burn rates over histogram snapshots.

    ``source(stage)`` returns ``(uppers, counts)`` — the finite bucket
    upper bounds and the per-bucket NON-cumulative counts including the
    overflow slot last (the shape ``_HistogramChild.snapshot`` yields) —
    or None while the stage has no series yet."""

    #: minimum seconds between ring snapshots (a scrape storm must not
    #: flush the window resolution)
    MIN_SNAP_PERIOD = 2.0
    #: ring depth: at the min period this covers > the longest window
    _RING_CAP = 2048

    def __init__(
        self,
        registry,
        objectives: list[Objective],
        source,
        clock=time.monotonic,
    ) -> None:
        self.objectives = list(objectives)
        self._source = source
        self._clock = clock
        self._lock = threading.Lock()
        self._rings: dict[str, deque[_Snap]] = {
            o.name: deque(maxlen=self._RING_CAP) for o in self.objectives
        }
        # zero baseline at construction: a process younger than one window
        # reports every event since startup (window_covered_s says how
        # much of the window that really is) instead of reporting nothing
        # until two spaced snapshots exist
        t0 = self._clock()
        for ring in self._rings.values():
            ring.append(_Snap(t0, 0, 0))
        self.m_burn = registry.gauge(
            "tpu_faas_slo_burn_rate",
            "Error-budget burn rate per objective and window: 1.0 burns "
            "the budget at exactly the sustainable pace, higher is worse "
            "(14.4 over 5m ~ page); 0 with no traffic in the window",
            ("objective", "window"),
        )
        self.m_good = registry.gauge(
            "tpu_faas_slo_good_ratio",
            "Fraction of events at or under the objective's latency "
            "threshold over the window (1.0 with no traffic)",
            ("objective", "window"),
        )
        self.m_target = registry.gauge(
            "tpu_faas_slo_target_ratio",
            "The objective's required good fraction (configuration echo, "
            "so alert rules can compare against the live target)",
            ("objective",),
        )
        self.m_threshold = registry.gauge(
            "tpu_faas_slo_threshold_seconds",
            "The objective's latency threshold (configuration echo)",
            ("objective",),
        )
        self.m_source = registry.gauge(
            "tpu_faas_slo_source_present",
            "1 once the objective's stage MATCHES a histogram series in "
            "THIS process (pre-created series count — presence means the "
            "stage name is in this process's vocabulary, not that "
            "traffic has flowed; window event counts say that). A "
            "fleet-wide TPU_FAAS_SLO names stages from both vocabularies "
            "(gateway e2e phases vs dispatcher timeline stages), so an "
            "objective foreign to a process stays 0 here by design — "
            "but a stage-name TYPO stays 0 everywhere. Its burn/good "
            "gauges keep their idle values, so alert on "
            "(source_present == 1) AND burn_rate",
            ("objective",),
        )
        #: objectives whose stage has matched a histogram series at least
        #: once (vocabulary presence, not traffic)
        self._seen: dict[str, bool] = {o.name: False for o in self.objectives}
        for o in self.objectives:
            self.m_target.labels(objective=o.name).set(o.target)
            self.m_threshold.labels(objective=o.name).set(o.threshold_s)
            self.m_source.labels(objective=o.name).set(0.0)
            for label, _ in WINDOWS:
                self.m_burn.labels(objective=o.name, window=label)
                self.m_good.labels(objective=o.name, window=label).set(1.0)
        registry.register_collector(self.collect)

    # -- snapshotting ------------------------------------------------------
    def _cumulative(self, o: Objective) -> tuple[int, int] | None:
        """(good, total) cumulative counts for one objective, or None when
        its stage has no data source yet."""
        if o.cls is None:
            snap = self._source(o.stage)
        else:
            try:
                snap = self._source(o.stage, cls=o.cls)
            except TypeError:
                # class-blind source (custom wiring, class label off):
                # a per-class objective must NOT silently judge the
                # aggregate distribution — report source-absent instead
                snap = None
        if snap is None:
            return None
        uppers, counts = snap
        total = sum(counts)
        # buckets with upper bound <= threshold are provably good; the
        # bucket straddling the threshold is counted BAD (conservative)
        idx = bisect.bisect_right(uppers, o.threshold_s)
        good = sum(counts[:idx])
        return good, total

    def update(self, now: float | None = None) -> None:
        if now is None:
            now = self._clock()
        with self._lock:
            for o in self.objectives:
                ring = self._rings[o.name]
                if ring and now - ring[-1].t < self.MIN_SNAP_PERIOD:
                    continue
                cum = self._cumulative(o)
                if cum is None:
                    continue
                if not self._seen[o.name]:
                    self._seen[o.name] = True
                    self.m_source.labels(objective=o.name).set(1.0)
                ring.append(_Snap(now, *cum))

    # -- reporting ---------------------------------------------------------
    def _window_stats(
        self, ring: deque[_Snap], window_s: float
    ) -> tuple[int, int, float]:
        """(good, total, covered_s) of the newest window over the ring."""
        if not ring:
            return 0, 0, 0.0
        latest = ring[-1]
        base = ring[0]
        horizon = latest.t - window_s
        for snap in ring:
            # the NEWEST snapshot at or before the horizon anchors the
            # window; all-younger rings degrade to the oldest (partial)
            if snap.t <= horizon:
                base = snap
            else:
                break
        return (
            latest.good - base.good,
            latest.total - base.total,
            latest.t - base.t,
        )

    def collect(self) -> None:
        """Registry collector: refresh the gauges at scrape time."""
        self.update()
        with self._lock:
            for o in self.objectives:
                ring = self._rings[o.name]
                for label, window_s in WINDOWS:
                    good, total, _cov = self._window_stats(ring, window_s)
                    ratio = 1.0 if total <= 0 else good / total
                    burn = (1.0 - ratio) / (1.0 - o.target)
                    self.m_good.labels(objective=o.name, window=label).set(
                        ratio
                    )
                    self.m_burn.labels(objective=o.name, window=label).set(
                        burn
                    )

    def snapshot(self) -> dict:
        """The ``/slo`` endpoint body."""
        self.update()
        with self._lock:
            out: dict = {"objectives": []}
            for o in self.objectives:
                ring = self._rings[o.name]
                windows = {}
                for label, window_s in WINDOWS:
                    good, total, cov = self._window_stats(ring, window_s)
                    ratio = 1.0 if total <= 0 else good / total
                    windows[label] = {
                        "events": total,
                        "good_ratio": round(ratio, 6),
                        "burn_rate": round(
                            (1.0 - ratio) / (1.0 - o.target), 4
                        ),
                        "window_covered_s": round(cov, 1),
                    }
                obj = {
                    "name": o.name,
                    "stage": o.stage,
                    "threshold_s": o.threshold_s,
                    "target": o.target,
                    "source_present": self._seen[o.name],
                    "windows": windows,
                }
                if o.cls is not None:
                    # keyed only when set: class-free configs keep their
                    # pre-attribution /slo body
                    obj["class"] = o.cls
                out["objectives"].append(obj)
            return out
