"""Strict Prometheus text-exposition parser (validation, not ingestion).

Consumed by the conformance tests and by the bench smoke job's mid-run
``/metrics`` scrape: both need to FAIL on exposition our renderer (or a
future backend) could plausibly get wrong — HELP/TYPE ordering, label
escaping, histogram bucket monotonicity, the ``+Inf``/``_sum``/``_count``
invariants — rather than shrug like a lenient scraper would.

:func:`parse_exposition` raises :class:`ExpositionError` on the first
violation and otherwise returns ``{family_name: Family}``.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
#: one label pair inside the braces: name="escaped value"
_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')

TYPES = ("counter", "gauge", "histogram", "summary", "untyped")


class ExpositionError(ValueError):
    """A violation of the exposition grammar or of a type invariant."""


@dataclass
class Sample:
    name: str
    labels: dict[str, str]
    value: float


@dataclass
class Family:
    name: str
    mtype: str
    help: str
    samples: list[Sample] = field(default_factory=list)


def _unescape_label(raw: str, lineno: int) -> str:
    out: list[str] = []
    i = 0
    while i < len(raw):
        c = raw[i]
        if c == "\\":
            if i + 1 >= len(raw):
                raise ExpositionError(f"line {lineno}: dangling backslash")
            nxt = raw[i + 1]
            if nxt == "\\":
                out.append("\\")
            elif nxt == '"':
                out.append('"')
            elif nxt == "n":
                out.append("\n")
            else:
                raise ExpositionError(
                    f"line {lineno}: invalid escape \\{nxt} in label value"
                )
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _parse_value(raw: str, lineno: int) -> float:
    if raw == "+Inf":
        return math.inf
    if raw == "-Inf":
        return -math.inf
    if raw == "NaN":
        return math.nan
    try:
        return float(raw)
    except ValueError:
        raise ExpositionError(f"line {lineno}: bad sample value {raw!r}") from None


def _parse_sample(line: str, lineno: int) -> Sample:
    rest = line
    brace = rest.find("{")
    labels: dict[str, str] = {}
    if brace >= 0:
        name = rest[:brace]
        close = rest.rfind("}")
        if close < brace:
            raise ExpositionError(f"line {lineno}: unbalanced braces")
        body = rest[brace + 1 : close]
        tail = rest[close + 1 :]
        pos = 0
        while pos < len(body):
            m = _LABEL_PAIR_RE.match(body, pos)
            if m is None:
                raise ExpositionError(
                    f"line {lineno}: malformed label pair near {body[pos:]!r}"
                )
            lname = m.group(1)
            if lname in labels:
                raise ExpositionError(
                    f"line {lineno}: duplicate label {lname!r}"
                )
            labels[lname] = _unescape_label(m.group(2), lineno)
            pos = m.end()
            if pos < len(body):
                if body[pos] != ",":
                    raise ExpositionError(
                        f"line {lineno}: expected ',' between labels"
                    )
                pos += 1
    else:
        parts = rest.split(None, 1)
        if len(parts) != 2:
            raise ExpositionError(f"line {lineno}: sample without value")
        name, tail = parts[0], " " + parts[1]
    if not _NAME_RE.match(name):
        raise ExpositionError(f"line {lineno}: invalid sample name {name!r}")
    tail = tail.strip()
    fields = tail.split()
    if len(fields) not in (1, 2):  # optional trailing timestamp
        raise ExpositionError(f"line {lineno}: trailing garbage {tail!r}")
    return Sample(name, labels, _parse_value(fields[0], lineno))


def _strip_suffix(name: str) -> tuple[str, str]:
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            return name[: -len(suffix)], suffix
    return name, ""


def _check_histogram(fam: Family) -> None:
    """Bucket monotonicity + the +Inf/_sum/_count invariants, per child."""
    by_child: dict[tuple, dict] = {}

    def child_key(labels: dict[str, str]) -> tuple:
        return tuple(
            sorted((k, v) for k, v in labels.items() if k != "le")
        )

    for s in fam.samples:
        base, suffix = _strip_suffix(s.name)
        entry = by_child.setdefault(
            child_key(s.labels), {"buckets": [], "sum": None, "count": None}
        )
        if suffix == "_bucket":
            if "le" not in s.labels:
                raise ExpositionError(
                    f"{fam.name}: histogram bucket without an 'le' label"
                )
            le = s.labels["le"]
            upper = math.inf if le == "+Inf" else _parse_value(le, 0)
            entry["buckets"].append((upper, s.value))
        elif suffix == "_sum":
            entry["sum"] = s.value
        elif suffix == "_count":
            entry["count"] = s.value
        else:
            raise ExpositionError(
                f"{fam.name}: unexpected histogram sample {s.name!r}"
            )
    for key, entry in by_child.items():
        buckets = entry["buckets"]
        if not buckets:
            raise ExpositionError(f"{fam.name}{dict(key)}: no buckets")
        uppers = [u for u, _ in buckets]
        if uppers != sorted(uppers):
            raise ExpositionError(
                f"{fam.name}{dict(key)}: 'le' bounds not sorted"
            )
        if len(set(uppers)) != len(uppers):
            raise ExpositionError(
                f"{fam.name}{dict(key)}: duplicate 'le' bound"
            )
        if not math.isinf(uppers[-1]):
            raise ExpositionError(
                f"{fam.name}{dict(key)}: missing le=\"+Inf\" bucket"
            )
        counts = [c for _, c in buckets]
        if any(b < a for a, b in zip(counts, counts[1:])):
            raise ExpositionError(
                f"{fam.name}{dict(key)}: bucket counts not cumulative"
            )
        if entry["count"] is None or entry["sum"] is None:
            raise ExpositionError(
                f"{fam.name}{dict(key)}: missing _count or _sum"
            )
        if entry["count"] != counts[-1]:
            raise ExpositionError(
                f"{fam.name}{dict(key)}: _count != +Inf bucket count"
            )


def parse_exposition(text: str) -> dict[str, Family]:
    """Parse + validate one exposition body. Raises ExpositionError on:

    - a sample appearing before its family's ``# HELP``/``# TYPE`` pair,
      HELP/TYPE out of order, or either repeated for one family;
    - invalid metric/label names, malformed or unescaped label values,
      duplicate labels in one sample, unparseable values;
    - a sample name that doesn't belong to the declared family (histogram
      suffix rules included);
    - histogram invariants: sorted unique ``le`` bounds ending in
      ``+Inf``, cumulative bucket counts, ``_count`` equal to the ``+Inf``
      bucket, ``_sum``/``_count`` present;
    - counters with negative values;
    - a duplicate (name, labels) series within the body.
    """
    families: dict[str, Family] = {}
    current: Family | None = None
    pending_help: tuple[str, str] | None = None
    seen_series: set[tuple[str, tuple]] = set()
    lines = text.split("\n")
    if not text.endswith("\n"):
        raise ExpositionError("exposition must end with a newline")
    for lineno, line in enumerate(lines, start=1):
        if line == "":
            continue
        if line.startswith("# HELP "):
            parts = line[len("# HELP ") :].split(" ", 1)
            name = parts[0]
            if not _NAME_RE.match(name):
                raise ExpositionError(f"line {lineno}: bad HELP name {name!r}")
            if name in families or (pending_help and pending_help[0] == name):
                raise ExpositionError(
                    f"line {lineno}: repeated HELP for {name!r}"
                )
            if pending_help is not None:
                raise ExpositionError(
                    f"line {lineno}: HELP for {name!r} while "
                    f"{pending_help[0]!r} still lacks a TYPE"
                )
            pending_help = (name, parts[1] if len(parts) > 1 else "")
            continue
        if line.startswith("# TYPE "):
            parts = line[len("# TYPE ") :].split()
            if len(parts) != 2 or parts[1] not in TYPES:
                raise ExpositionError(f"line {lineno}: malformed TYPE line")
            name, mtype = parts
            if pending_help is None or pending_help[0] != name:
                raise ExpositionError(
                    f"line {lineno}: TYPE for {name!r} without a preceding "
                    "HELP (HELP must come first)"
                )
            if name in families:
                raise ExpositionError(
                    f"line {lineno}: repeated TYPE for {name!r}"
                )
            current = Family(name, mtype, pending_help[1])
            families[name] = current
            pending_help = None
            continue
        if line.startswith("#"):
            continue  # plain comment
        sample = _parse_sample(line, lineno)
        base, suffix = _strip_suffix(sample.name)
        if current is None:
            raise ExpositionError(
                f"line {lineno}: sample before any HELP/TYPE declaration"
            )
        if current.mtype == "histogram":
            if base != current.name or suffix == "":
                raise ExpositionError(
                    f"line {lineno}: sample {sample.name!r} outside its "
                    f"declared family {current.name!r}"
                )
        elif sample.name != current.name:
            raise ExpositionError(
                f"line {lineno}: sample {sample.name!r} outside its "
                f"declared family {current.name!r}"
            )
        for lname in sample.labels:
            if not _LABEL_NAME_RE.match(lname):
                raise ExpositionError(
                    f"line {lineno}: invalid label name {lname!r}"
                )
        series = (sample.name, tuple(sorted(sample.labels.items())))
        if series in seen_series:
            raise ExpositionError(
                f"line {lineno}: duplicate series {sample.name} "
                f"{sample.labels}"
            )
        seen_series.add(series)
        if current.mtype == "counter" and sample.value < 0:
            raise ExpositionError(
                f"line {lineno}: counter {sample.name} is negative"
            )
        current.samples.append(sample)
    if pending_help is not None:
        raise ExpositionError(f"HELP for {pending_help[0]!r} without a TYPE")
    for fam in families.values():
        if fam.mtype == "histogram":
            _check_histogram(fam)
    return families


def require_series(
    families: dict[str, Family], names: list[str]
) -> list[str]:
    """Missing family names out of ``names`` (empty list = all present) —
    the bench smoke scrape's required-series check."""
    return [n for n in names if n not in families]
