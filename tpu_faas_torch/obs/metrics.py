"""Metrics registry + Prometheus text exposition.

Design constraints, in order:

- **Hot-path cheap.** ``Counter.inc`` / ``Histogram.observe`` sit inside
  the dispatcher's per-message drain and the store client's round-trip
  path. Each child owns one uncontended ``threading.Lock`` around a couple
  of float ops; histograms are fixed-bucket (one ``bisect`` + two adds),
  never per-sample lists — a saturated dispatcher records millions of
  samples without growing memory.
- **One name, one type.** A registry rejects re-registration of a name
  with a different type, help text, or label set: the gateway and the
  dispatcher cannot drift into exposing the same series two ways.
- **Standard exposition.** :func:`render` emits Prometheus text format
  (version 0.0.4): ``# HELP``/``# TYPE`` once per family, escaped label
  values, cumulative histogram buckets ending in ``+Inf`` with matching
  ``_sum``/``_count``. The strict parser in :mod:`tpu_faas.obs.expofmt`
  (used by the conformance tests and the CI bench scrape) holds this
  renderer to the grammar.

There is a process-global :data:`REGISTRY` for process-scoped series (the
store client's round-trip counter registers there), but components that
tests instantiate repeatedly — dispatchers, gateway apps — own a private
``MetricsRegistry`` and render it concatenated with the global one, so one
test's counters never bleed into the next scrape.
"""

from __future__ import annotations

import bisect
import math
import re
import threading
from typing import Iterable, Mapping, Sequence

#: MIME type for exposition replies.
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: Default latency buckets (seconds): sub-millisecond device ticks through
#: multi-second executions. Mirrors the prometheus client defaults with a
#: finer low end for the tick path.
LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _escape_help(text: str) -> str:
    return text.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label_value(text: str) -> str:
    return (
        text.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
    )


def format_value(v: float) -> str:
    """Prometheus sample-value spelling: integral floats render without a
    fractional part (``17`` not ``17.0``), infinities as ``+Inf``/``-Inf``."""
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v).is_integer() and abs(v) < 2**53:
        return str(int(v))
    return repr(float(v))


def format_le(upper: float) -> str:
    """Bucket-boundary spelling for the ``le`` label (``+Inf``, ``0.005``)."""
    if math.isinf(upper):
        return "+Inf"
    if float(upper).is_integer():
        return f"{upper:.1f}"
    return repr(float(upper))


class _Child:
    """One (metric, label-values) time series. Value ops take the child's
    own lock — uncontended in the common single-writer case."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    @property
    def value(self) -> float:
        return self._value

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)


class _HistogramChild:
    """Fixed-bucket histogram series: per-bucket counts + running sum.

    No per-sample storage — ``observe`` is a bisect into the (sorted)
    upper-bounds tuple plus two adds under the child lock. Bucket counts
    are stored NON-cumulative and accumulated at render time, so the
    hot-path write touches exactly one slot."""

    __slots__ = ("_lock", "_uppers", "_counts", "_sum")

    def __init__(self, uppers: tuple[float, ...]) -> None:
        self._lock = threading.Lock()
        self._uppers = uppers  # excludes +Inf; the overflow slot is last
        self._counts = [0] * (len(uppers) + 1)
        self._sum = 0.0

    def observe(self, value: float) -> None:
        idx = bisect.bisect_left(self._uppers, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value

    def snapshot(self) -> tuple[list[int], float]:
        with self._lock:
            return list(self._counts), self._sum

    @property
    def count(self) -> int:
        return sum(self._counts)

    @property
    def sum(self) -> float:
        return self._sum


class _Metric:
    """A metric family: name, type, help, label names, and its children."""

    mtype = "untyped"

    def __init__(
        self, name: str, help: str, labelnames: Sequence[str] = ()
    ) -> None:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid label name {ln!r} on {name}")
            if ln == "le" and self.mtype == "histogram":
                raise ValueError("'le' is reserved on histograms")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], object] = {}
        if not self.labelnames:
            # unlabeled metrics get their single child eagerly, so the
            # family renders (at zero) from the moment it is registered —
            # scrapes see the full catalog before any traffic
            self._children[()] = self._make_child()

    def _make_child(self):
        return _Child()

    def labels(self, *values: str, **kv: str) -> object:
        """The child for one label-value combination (created on first
        use). Positional values follow ``labelnames`` order."""
        if kv:
            if values:
                raise ValueError("pass labels positionally or by name, not both")
            try:
                values = tuple(str(kv[ln]) for ln in self.labelnames)
            except KeyError as exc:
                raise ValueError(f"missing label {exc} for {self.name}") from None
            if len(kv) != len(self.labelnames):
                raise ValueError(f"unexpected labels for {self.name}: {kv}")
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, got {values}"
            )
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.setdefault(values, self._make_child())
        return child

    def _default(self):
        if self.labelnames:
            raise ValueError(f"{self.name} is labeled; use .labels(...)")
        return self._children[()]

    def child_items(self) -> list[tuple[tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())

    def _series(self, name: str, values: tuple[str, ...], extra: str = "") -> str:
        pairs = [
            f'{ln}="{_escape_label_value(lv)}"'
            for ln, lv in zip(self.labelnames, values)
        ]
        if extra:
            pairs.append(extra)
        return f"{name}{{{','.join(pairs)}}}" if pairs else name


class Counter(_Metric):
    mtype = "counter"

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        self._default().inc(amount)

    @property
    def value(self) -> float:
        return self._default().value

    def render_into(self, out: list[str]) -> None:
        for values, child in self.child_items():
            out.append(
                f"{self._series(self.name, values)} {format_value(child.value)}"
            )


class Gauge(_Metric):
    mtype = "gauge"

    def set(self, value: float) -> None:
        self._default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().inc(-amount)

    @property
    def value(self) -> float:
        return self._default().value

    render_into = Counter.render_into


class Histogram(_Metric):
    mtype = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = LATENCY_BUCKETS,
    ) -> None:
        uppers = tuple(sorted(float(b) for b in buckets))
        if not uppers:
            raise ValueError("histogram needs at least one bucket")
        if any(
            a >= b for a, b in zip(uppers, uppers[1:])
        ) or math.isinf(uppers[-1]):
            raise ValueError("buckets must be strictly increasing and finite")
        self._uppers = uppers
        super().__init__(name, help, labelnames)

    def _make_child(self):
        return _HistogramChild(self._uppers)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    def sum_counts(
        self, match: Sequence[str | None]
    ) -> tuple[tuple[float, ...], list[int]] | None:
        """(bucket uppers, summed per-bucket counts — overflow slot last)
        across every child whose label values equal ``match`` positionally
        (None = wildcard). None when nothing matches. The SLO trackers'
        shared data source: both the gateway e2e phases and the dispatcher
        stage histogram filter one label exactly and one to a terminal
        outcome."""
        total: list[int] | None = None
        for values, child in self.child_items():
            if any(
                want is not None and have != want
                for have, want in zip(values, match)
            ):
                continue
            counts, _ = child.snapshot()
            if total is None:
                total = counts
            else:
                total = [a + b for a, b in zip(total, counts)]
        if total is None:
            return None
        return self._uppers, total

    def render_into(self, out: list[str]) -> None:
        for values, child in self.child_items():
            counts, total = child.snapshot()
            acc = 0
            for upper, n in zip(self._uppers, counts):
                acc += n
                le = f'le="{format_le(upper)}"'
                out.append(
                    f"{self._series(self.name + '_bucket', values, le)} {acc}"
                )
            acc += counts[-1]
            inf_label = 'le="+Inf"'
            out.append(
                f"{self._series(self.name + '_bucket', values, inf_label)} {acc}"
            )
            out.append(
                f"{self._series(self.name + '_sum', values)} {format_value(total)}"
            )
            out.append(f"{self._series(self.name + '_count', values)} {acc}")


class MetricsRegistry:
    """Named metric families + render-time collector callbacks."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list = []

    def _get_or_create(self, cls, name, help, labelnames, **kw) -> _Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (
                    type(existing) is not cls
                    or existing.labelnames != tuple(labelnames)
                ):
                    raise ValueError(
                        f"metric {name!r} already registered with a "
                        f"different type or label set"
                    )
                return existing
            metric = cls(name, help, labelnames, **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str, labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str, labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(
        self, name: str, help: str, labelnames=(), buckets=LATENCY_BUCKETS
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def register_collector(self, fn) -> None:
        """``fn()`` runs at the top of every render — the place to refresh
        gauges whose truth lives elsewhere (queue depths, fleet sizes)."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def unregister_collector(self, fn) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def collect(self) -> list[_Metric]:
        with self._lock:
            collectors = list(self._collectors)
            metrics = list(self._metrics.values())
        for fn in collectors:
            fn()
        return sorted(metrics, key=lambda m: m.name)

    def render(self) -> str:
        return render([self])


def render(registries: Iterable[MetricsRegistry]) -> str:
    """Concatenated exposition over several registries (component-private +
    process-global). A metric name appearing in more than one registry is a
    hard error: duplicate families are invalid exposition, and silently
    merging them would hide a naming collision."""
    out: list[str] = []
    seen: dict[str, str] = {}
    for registry in registries:
        for metric in registry.collect():
            if metric.name in seen:
                raise ValueError(
                    f"metric {metric.name!r} registered in more than one "
                    "rendered registry"
                )
            seen[metric.name] = metric.mtype
            out.append(f"# HELP {metric.name} {_escape_help(metric.help)}")
            out.append(f"# TYPE {metric.name} {metric.mtype}")
            metric.render_into(out)
    return "\n".join(out) + "\n"


#: Process-global registry for series without a component owner (the store
#: client's round-trip counter, worker-pool counters). Component classes
#: that tests instantiate repeatedly keep PRIVATE registries instead.
REGISTRY = MetricsRegistry()
