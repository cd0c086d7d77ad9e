"""Deterministic, seeded fault-injection plan (``TPU_FAAS_CHAOS``).

Every robustness proof in the repo used to hand-roll its own fault (a
SIGKILL here, a closed socket there). This module is the one reusable
plane: a process reads ``TPU_FAAS_CHAOS`` once, parses it into a
:class:`ChaosPlan`, and threads per-site handlers through the three I/O
seams — store client round trips, the worker wire, worker execution.

Grammar (parse errors raise :class:`ChaosConfigError` at process start —
a typo must fail loudly, not silently run a chaos-free "chaos" test)::

    TPU_FAAS_CHAOS="seed=42;store.latency:ms=20:p=0.5,wire.drop:p=0.02"

- ``;``-separated segments: one optional ``seed=N`` (default 0), the
  rest are ``,``-separated rules.
- Rule: ``site.kind[:key=val]*``. Sites and kinds:

  ========== ============== =========================== ==============
  site       kind           effect                      params
  ========== ============== =========================== ==============
  store      latency        sleep before the round trip ms*, p, after, until
  store      outage         raise ConnectionError       dur*, after
                            without touching the socket
  store      torn           pipeline applies, then the  p, nth, after, until
                            connection tears (reply
                            lost) — the client sees an
                            error for writes that LANDED
  wire       drop           frame never sent            p, nth, after, until
  wire       dup            frame sent twice            p, nth, after, until
  wire       delay          frame held ``ms`` then sent ms*, p, after, until
  exec       slow           sleep before running a task ms*, p, after, until
  exec       crash_before   kill the worker process     p, nth, after
                            before the task runs
  exec       crash_after    kill the worker process     p, nth, after
                            after results shipped
  ========== ============== =========================== ==============

  ``*`` = required. ``p`` is a probability per eligible event (default
  1.0); ``nth`` fires exactly once, on the nth eligible event (1-based,
  mutually exclusive with ``p``); ``after``/``until``/``dur`` are
  seconds relative to plan arm (wall-clock windows, for scenario
  scripts); ``ms`` is milliseconds.

Determinism: each rule owns a private ``random.Random`` seeded from
``f"{seed}:{site}.{kind}:{rule_index}"`` (string seeding is stable
across processes and runs, unlike ``hash()``), so the same spec replays
the same injection decision sequence — the property the determinism
tests pin. Wall-clock windows are the one escape hatch for scenario
scripts; pure-deterministic tests use ``nth``.

Accounting: every injection increments
``tpu_faas_chaos_injected_total{site,kind}`` (the family is registered
lazily, on the first plan construction, so a chaos-free process's
exposition stays byte-identical) and, when the owning process bound its
flight recorder via :meth:`ChaosPlan.bind_flightrec`, lands a
``chaos_injected`` event joining the fault to its victim.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field

from tpu_faas_torch.obs.metrics import REGISTRY

__all__ = [
    "ChaosConfigError",
    "ChaosPlan",
    "ChaosRule",
    "ChaosWire",
    "ExecChaos",
    "StoreChaos",
    "parse_chaos",
]


class ChaosConfigError(ValueError):
    """Malformed TPU_FAAS_CHAOS spec — raised at process start."""


#: site.kind -> (allowed params, required params)
_RULE_TABLE: dict[tuple[str, str], tuple[frozenset, frozenset]] = {
    ("store", "latency"): (frozenset({"ms", "p", "after", "until"}),
                           frozenset({"ms"})),
    ("store", "outage"): (frozenset({"dur", "after"}), frozenset({"dur"})),
    ("store", "torn"): (frozenset({"p", "nth", "after", "until"}),
                        frozenset()),
    ("wire", "drop"): (frozenset({"p", "nth", "after", "until"}),
                       frozenset()),
    ("wire", "dup"): (frozenset({"p", "nth", "after", "until"}),
                      frozenset()),
    ("wire", "delay"): (frozenset({"ms", "p", "after", "until"}),
                        frozenset({"ms"})),
    ("exec", "slow"): (frozenset({"ms", "p", "after", "until"}),
                       frozenset({"ms"})),
    ("exec", "crash_before"): (frozenset({"p", "nth", "after"}),
                               frozenset()),
    ("exec", "crash_after"): (frozenset({"p", "nth", "after"}),
                              frozenset()),
}

_INT_KEYS = frozenset({"nth"})


@dataclass
class ChaosRule:
    """One parsed rule plus its private decision stream and counters."""

    site: str
    kind: str
    index: int  # position in the spec: part of the RNG stream key
    p: float = 1.0
    nth: int | None = None
    ms: float | None = None
    after: float | None = None
    until: float | None = None
    dur: float | None = None
    #: private deterministic decision stream (seeded by the plan)
    rng: random.Random = field(default_factory=random.Random, repr=False)
    #: eligible events seen (for ``nth``) — also handy in tests
    seen: int = 0
    fired: int = 0

    def seed_from(self, seed: int) -> None:
        # str seeding runs through the version-2 init (bytes-based),
        # which is stable across processes — hash() is not
        self.rng.seed(f"{seed}:{self.site}.{self.kind}:{self.index}")

    def in_window(self, elapsed_s: float) -> bool:
        if self.after is not None and elapsed_s < self.after:
            return False
        if self.until is not None and elapsed_s >= self.until:
            return False
        if self.dur is not None:
            start = self.after or 0.0
            if not (start <= elapsed_s < start + self.dur):
                return False
        return True

    def decide(self, elapsed_s: float) -> bool:
        """One eligible event: does this rule inject?  Advances the
        decision stream ONLY on probabilistic rules inside their window,
        so wall-clock window edges can't desynchronize the stream across
        runs that differ by microseconds."""
        if not self.in_window(elapsed_s):
            return False
        self.seen += 1
        if self.nth is not None:
            hit = self.seen == self.nth
        else:
            hit = self.p >= 1.0 or self.rng.random() < self.p
        if hit:
            self.fired += 1
        return hit


def _parse_rule(text: str, index: int) -> ChaosRule:
    parts = text.split(":")
    head = parts[0].strip()
    if "." not in head:
        raise ChaosConfigError(
            f"chaos rule {head!r}: expected site.kind (e.g. wire.drop)"
        )
    site, kind = head.split(".", 1)
    key = (site, kind)
    if key not in _RULE_TABLE:
        known = ", ".join(f"{s}.{k}" for s, k in sorted(_RULE_TABLE))
        raise ChaosConfigError(
            f"chaos rule {head!r}: unknown site.kind (known: {known})"
        )
    allowed, required = _RULE_TABLE[key]
    rule = ChaosRule(site=site, kind=kind, index=index)
    given: set[str] = set()
    for kv in parts[1:]:
        kv = kv.strip()
        if not kv:
            continue
        if "=" not in kv:
            raise ChaosConfigError(
                f"chaos rule {head!r}: param {kv!r} is not key=value"
            )
        k, v = kv.split("=", 1)
        k = k.strip()
        if k not in allowed:
            raise ChaosConfigError(
                f"chaos rule {head!r}: unknown param {k!r} "
                f"(allowed: {', '.join(sorted(allowed))})"
            )
        try:
            val = int(v) if k in _INT_KEYS else float(v)
        except ValueError:
            raise ChaosConfigError(
                f"chaos rule {head!r}: param {k}={v!r} is not numeric"
            ) from None
        setattr(rule, k, val)
        given.add(k)
    missing = required - given
    if missing:
        raise ChaosConfigError(
            f"chaos rule {head!r}: missing required param(s) "
            f"{', '.join(sorted(missing))}"
        )
    if "p" in given and "nth" in given:
        raise ChaosConfigError(
            f"chaos rule {head!r}: p and nth are mutually exclusive"
        )
    if not 0.0 <= rule.p <= 1.0:
        raise ChaosConfigError(f"chaos rule {head!r}: p must be in [0, 1]")
    if rule.nth is not None and rule.nth < 1:
        raise ChaosConfigError(f"chaos rule {head!r}: nth is 1-based")
    return rule


def parse_chaos(spec: str) -> "ChaosPlan":
    """Parse a TPU_FAAS_CHAOS string into an armed :class:`ChaosPlan`."""
    seed = 0
    seed_seen = False
    rules: list[ChaosRule] = []
    for segment in spec.split(";"):
        segment = segment.strip()
        if not segment:
            continue
        if segment.startswith("seed="):
            if seed_seen:
                raise ChaosConfigError("chaos spec: seed given twice")
            try:
                seed = int(segment[len("seed="):])
            except ValueError:
                raise ChaosConfigError(
                    f"chaos spec: seed={segment[len('seed='):]!r} "
                    "is not an integer"
                ) from None
            seed_seen = True
            continue
        for text in segment.split(","):
            text = text.strip()
            if not text:
                continue
            rules.append(_parse_rule(text, index=len(rules)))
    if not rules:
        raise ChaosConfigError(
            "chaos spec parsed to zero rules — a chaos-free chaos run is "
            "a misconfiguration, not a baseline; unset TPU_FAAS_CHAOS "
            "instead"
        )
    return ChaosPlan(seed=seed, rules=rules, spec=spec)


def _injected_counter():
    """The shared injection counter — registered lazily so a chaos-free
    process never grows the family and its exposition stays
    byte-identical."""
    return REGISTRY.counter(
        "tpu_faas_chaos_injected_total",
        "Fault injections performed by the chaos plane",
        ("site", "kind"),
    )


class ChaosPlan:
    """One process's armed chaos plan: the parsed rules, their seeded
    decision streams, the injection counter, and the (optional) flight
    recorder binding. Site handlers are constructed once per seam via
    :meth:`store`, :meth:`wire`, :meth:`execution`."""

    def __init__(self, seed: int, rules: list[ChaosRule], spec: str,
                 clock=time.monotonic):
        self.seed = seed
        self.rules = rules
        self.spec = spec
        self.clock = clock
        self.armed_at = clock()
        self.flightrec = None
        #: local mirror of the metric, for tests and /stats
        self.counts: dict[tuple[str, str], int] = {}
        self._metric = _injected_counter()
        for r in rules:
            r.seed_from(seed)

    # -- accounting --------------------------------------------------------
    def elapsed(self) -> float:
        return self.clock() - self.armed_at

    def note(self, site: str, kind: str, **fields) -> None:
        self.counts[(site, kind)] = self.counts.get((site, kind), 0) + 1
        self._metric.labels(site=site, kind=kind).inc()
        if self.flightrec is not None:
            # "fault", not "kind": emit()'s first positional IS the event
            # kind — a field named kind would collide with it
            self.flightrec.emit("chaos_injected", site=site, fault=kind,
                                **fields)

    def bind_flightrec(self, recorder) -> None:
        """Join injections to the owning process's event ring so a
        post-mortem can line faults up with their victims."""
        self.flightrec = recorder

    def _site_rules(self, site: str) -> list[ChaosRule]:
        return [r for r in self.rules if r.site == site]

    # -- seam handler factories (None = seam untouched: callers keep the
    # attribute None and pay a single identity check on the hot path) ---
    def store(self) -> "StoreChaos | None":
        rules = self._site_rules("store")
        return StoreChaos(self, rules) if rules else None

    def wire(self) -> "ChaosWire | None":
        rules = self._site_rules("wire")
        return ChaosWire(self, rules) if rules else None

    def execution(self) -> "ExecChaos | None":
        rules = self._site_rules("exec")
        return ExecChaos(self, rules) if rules else None


class StoreChaos:
    """Store-client seam: consulted once per round trip.

    ``before()`` runs ahead of the socket write: an ``outage`` window
    raises ConnectionError without touching the wire (the client's
    normal reconnect/failover machinery takes it from there), a
    ``latency`` hit sleeps. ``torn()`` is pipeline-only: the caller
    executes the pipeline NORMALLY, then tears the connection and raises
    — the applied-but-reply-lost shape that distinguishes a torn
    pipeline from a clean outage."""

    def __init__(self, plan: ChaosPlan, rules: list[ChaosRule]):
        self.plan = plan
        self.latency = [r for r in rules if r.kind == "latency"]
        self.outages = [r for r in rules if r.kind == "outage"]
        self.torn_rules = [r for r in rules if r.kind == "torn"]
        self.sleep = time.sleep

    def before(self, op: str = "") -> None:
        elapsed = self.plan.elapsed()
        for r in self.outages:
            if r.decide(elapsed):
                self.plan.note("store", "outage", op=op)
                raise ConnectionError(
                    f"chaos: injected store outage (window {r.after or 0}"
                    f"+{r.dur}s)"
                )
        for r in self.latency:
            if r.decide(elapsed):
                self.plan.note("store", "latency", op=op, ms=r.ms)
                self.sleep(r.ms / 1000.0)

    def torn(self) -> bool:
        elapsed = self.plan.elapsed()
        hit = any(r.decide(elapsed) for r in self.torn_rules)
        if hit:
            self.plan.note("store", "torn")
        return hit


class ChaosWire:
    """Worker-wire seam: consulted once per outgoing frame (either
    direction). First matching rule wins per frame — a dropped frame
    can't also duplicate.

    ``send(frames, send_fn)`` performs the real send through ``send_fn``
    zero (drop), one, or two (dup) times; a ``delay`` hit holds the
    frames in an internal queue released by ``flush(send_fn)``, which
    the owner calls once per serve-loop iteration. Lockstep sockets
    (REQ/REP) pass ``dup_ok=False, defer_ok=False, drop_ok=False``:
    drop would wedge the mandatory recv and dup would desync the reply
    stream, so only delay applies there — as a blocking sleep — and the
    pull worker documents this at its call site."""

    def __init__(self, plan: ChaosPlan, rules: list[ChaosRule]):
        self.plan = plan
        self.rules = rules  # spec order: first match wins
        self.held: list[tuple[float, object]] = []  # (release_at, frames)
        self.sleep = time.sleep

    def send(self, frames, send_fn, dup_ok: bool = True,
             defer_ok: bool = True, drop_ok: bool = True) -> None:
        elapsed = self.plan.elapsed()
        for r in self.rules:
            if not r.decide(elapsed):
                continue
            if r.kind == "drop":
                if not drop_ok:
                    continue  # lockstep socket: a lost request wedges
                self.plan.note("wire", "drop")
                return
            if r.kind == "dup":
                if not dup_ok:
                    continue  # lockstep socket: dup is not expressible
                self.plan.note("wire", "dup")
                send_fn(frames)
                send_fn(frames)
                return
            if r.kind == "delay":
                self.plan.note("wire", "delay", ms=r.ms)
                if defer_ok:
                    self.held.append(
                        (self.plan.clock() + r.ms / 1000.0, frames)
                    )
                else:
                    self.sleep(r.ms / 1000.0)
                    send_fn(frames)
                return
        send_fn(frames)

    def flush(self, send_fn) -> int:
        """Release held (delayed) frames whose time has come; returns
        how many frame-sets went out."""
        if not self.held:
            return 0
        now = self.plan.clock()
        due = [f for (t, f) in self.held if t <= now]
        self.held = [(t, f) for (t, f) in self.held if t > now]
        for frames in due:
            send_fn(frames)
        return len(due)


class ExecChaos:
    """Worker-execution seam. ``before_task()`` runs ahead of handing a
    task to the pool: ``crash_before`` kills the WORKER PROCESS (not the
    pool child — a dead child FAILs the task, which is admitted loss; a
    dead worker is reclaimed by the dispatcher's liveness machinery,
    which is the recovery path chaos exists to exercise), ``slow``
    sleeps in the worker's intake thread — the gray-failure shape the
    health plane must catch. ``after_result()`` runs after results
    ship: ``crash_after`` exercises the duplicate-result /
    already-terminal tolerance of the reclaim path."""

    #: distinctive exit code: lets scenario harnesses tell a chaos kill
    #: from a genuine worker crash
    EXIT_CODE = 86

    def __init__(self, plan: ChaosPlan, rules: list[ChaosRule],
                 exit_fn=None):
        import os

        self.plan = plan
        self.slow = [r for r in rules if r.kind == "slow"]
        self.crash_before = [r for r in rules if r.kind == "crash_before"]
        self.crash_after = [r for r in rules if r.kind == "crash_after"]
        self.sleep = time.sleep
        self.exit_fn = exit_fn if exit_fn is not None else os._exit

    def before_task(self, task_id: str = "") -> None:
        elapsed = self.plan.elapsed()
        for r in self.crash_before:
            if r.decide(elapsed):
                self.plan.note("exec", "crash_before", task_id=task_id)
                self.exit_fn(self.EXIT_CODE)
                return  # reachable only with an injected exit_fn
        for r in self.slow:
            if r.decide(elapsed):
                self.plan.note("exec", "slow", task_id=task_id, ms=r.ms)
                self.sleep(r.ms / 1000.0)

    def after_result(self, task_id: str = "") -> None:
        elapsed = self.plan.elapsed()
        for r in self.crash_after:
            if r.decide(elapsed):
                self.plan.note("exec", "crash_after", task_id=task_id)
                self.exit_fn(self.EXIT_CODE)
                return
