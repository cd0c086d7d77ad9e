"""Tenant vocabulary, share/cap config, and host-side bookkeeping.

A copy of ``tpu_faas/tenancy/config.py`` for the PyTorch port, which imports
nothing of the JAX package: the store hash's key is this module's own
``TENANT_CONF_KEY`` (the same string as ``tpu_faas/store/base.py``'s).

A tenant is a short operator-facing name riding every task record
(``FIELD_TENANT``, stamped by the gateway from ``X-Tenant-Id``). The
device tick works on dense ROW INDICES instead: :class:`TenantTable` maps
names to rows (row 0 is always the default tenant, where every legacy /
header-less task lands), hands the tick its share / cap / inflight
vectors, and keeps the metrics-label vocabulary BOUNDED — only tenants
named in the operator's share config get their own label value; every
dynamically-discovered tenant aggregates under ``"other"`` so a client
minting random tenant names cannot explode series cardinality.

Config surface:

- ``--tenant-shares "a=3,b=1"`` — positive weights; tenants not listed
  (the default tenant included) weigh ``1.0``. Shares are RELATIVE: under
  contention, admitted work per backlogged tenant tracks the weights.
- ``--tenant-caps "a=100"`` — hard per-tenant inflight ceilings enforced
  where placement happens (a tenant at its cap keeps its surplus QUEUED
  on device; capacity spills to other tenants). Unlisted = uncapped.
- Hot reload: the same two spec strings live in the ``fleet:tenant_conf``
  store hash (``TENANT_CONF_KEY``), stamped so the freshest
  publication wins on sharded stacks; dispatchers poll at ~1 Hz and
  apply in place — no restart, no tick-kernel recompile (the vectors are
  VALUES, only ``max_tenants`` is a static).
"""

from __future__ import annotations

import re
import time

import numpy as np

#: the fleet hash holding the hot-reloadable share and cap specs
TENANT_CONF_KEY = "fleet:tenant_conf"

#: Row 0 of every tenant table; where header-less / legacy traffic lands.
DEFAULT_TENANT = "default"

#: The metrics-label bucket for tenants outside the configured vocabulary.
OTHER_LABEL = "other"

#: Tenant names become store-hash content, share-table keys, and candidate
#: metric labels: short, printable, no spec/merge delimiters (":" is the
#: conf-stamp separator, "," and "=" the spec separators).
_TENANT_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


def valid_tenant(name: object) -> bool:
    return isinstance(name, str) and bool(_TENANT_RE.match(name))


def _parse_spec(spec: str, what: str, lo: float) -> dict[str, float]:
    out: dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, raw = part.partition("=")
        name = name.strip()
        if not sep or not valid_tenant(name):
            raise ValueError(f"malformed {what} entry {part!r}")
        try:
            value = float(raw)
        except ValueError:
            raise ValueError(f"{what} for {name!r} must be a number") from None
        if not (value > lo) or value != value or value == float("inf"):
            raise ValueError(f"{what} for {name!r} must be finite and > {lo:g}")
        if name in out:
            raise ValueError(f"duplicate tenant {name!r} in {what} spec")
        out[name] = value
    return out


def parse_shares(spec: str) -> dict[str, float]:
    """``"a=3,b=1"`` -> {"a": 3.0, "b": 1.0}. Raises ValueError with a
    operator-facing message on malformed input (fail at flag parse, not at
    the first device tick)."""
    return _parse_spec(spec, "share", 0.0)


def parse_caps(spec: str) -> dict[str, int]:
    """``"a=100"`` -> {"a": 100}; caps are whole inflight-slot counts.
    Fractional values are rejected rather than truncated: ``a=0.5`` would
    silently become 0 — which the table defines as UNCAPPED, the exact
    inverse of the operator's tightest-possible ask."""
    out = {}
    for name, value in _parse_spec(spec, "cap", 0.0).items():
        if value != int(value):
            raise ValueError(
                f"cap for {name!r} must be a whole slot count, got {value:g}"
            )
        out[name] = int(value)
    return out


def encode_conf(spec: str, now: float | None = None) -> str:
    """A conf-hash field value: ``<spec>:<wall stamp>`` (the stamp drives
    the sharded store's freshest-wins fleet-hash merge)."""
    stamp = time.time() if now is None else now
    return f"{spec}:{stamp!r}"


def decode_conf(value: str | None) -> tuple[str, float] | None:
    """(spec, stamp) off a conf-hash field, or None for absent/garbled."""
    if not value:
        return None
    spec, _sep, raw = value.rpartition(":")
    try:
        return spec, float(raw)
    except ValueError:
        return None


class TenantTable:
    """Host mirror of the tick's tenant dimension: name<->row registry,
    share/cap vectors, live inflight counts, and the bounded label map.

    ``max_tenants`` is a STATIC of the compiled tick (the vectors' padded
    length), defaulting far above any sane simultaneous-tenant count on
    one dispatcher. When more distinct names than rows appear, the
    overflow accounts to the default row — fairness degrades gracefully
    to "everyone unnamed shares one bucket" instead of failing dispatch.
    """

    def __init__(
        self,
        shares: dict[str, float] | None = None,
        caps: dict[str, int] | None = None,
        max_tenants: int = 32,
    ) -> None:
        if max_tenants < 1:
            raise ValueError("max_tenants must be >= 1")
        self.max_tenants = int(max_tenants)
        self._rows: dict[str, int] = {DEFAULT_TENANT: 0}
        self._names: list[str] = [DEFAULT_TENANT]
        self.share = np.ones(self.max_tenants, dtype=np.float32)
        self.cap = np.zeros(self.max_tenants, dtype=np.int32)  # 0 = uncapped
        self.inflight = np.zeros(self.max_tenants, dtype=np.int32)
        #: tasks handed to workers per row since start (host counter — the
        #: /stats tenancy block and the bench's share-ratio leg read it)
        self.dispatched = np.zeros(self.max_tenants, dtype=np.int64)
        self.overflowed = 0  # distinct names that didn't fit a row
        self._shares_spec: str | None = None
        self._caps_spec: str | None = None
        #: label vocabulary = configured names only (bounded by the
        #: operator); grows only via apply_shares/apply_caps
        self._labelled: set[str] = set()
        if shares:
            self._apply_shares(shares)
        if caps:
            self._apply_caps(caps)

    # -- rows ---------------------------------------------------------------
    def row_for(self, name: str | None, register: bool = True) -> int:
        """The dense row of a tenant name (None/invalid -> default row 0).
        Unknown names register a fresh row while capacity lasts; past
        ``max_tenants`` they account to the default row (counted)."""
        if not name or name == DEFAULT_TENANT:
            return 0
        row = self._rows.get(name)
        if row is not None:
            return row
        if not register or not valid_tenant(name):
            return 0
        if len(self._names) >= self.max_tenants:
            self.overflowed += 1
            return 0
        row = len(self._names)
        self._rows[name] = row
        self._names.append(name)
        return row

    def name_of(self, row: int) -> str:
        return self._names[row] if 0 <= row < len(self._names) else DEFAULT_TENANT

    def label_for(self, name: str | None) -> str:
        """Bounded metric-label value: the name itself when the operator's
        config vocabulary contains it, ``default`` for header-less
        traffic, ``other`` for everything dynamically discovered."""
        if not name or name == DEFAULT_TENANT:
            return DEFAULT_TENANT
        return name if name in self._labelled else OTHER_LABEL

    @property
    def n_tenants(self) -> int:
        return len(self._names)

    @property
    def labels(self) -> list[str]:
        """Full label vocabulary (pre-register metric children so the
        families render with stable series from the first scrape)."""
        return [DEFAULT_TENANT, OTHER_LABEL, *sorted(self._labelled)]

    # -- config -------------------------------------------------------------
    def _config_row(self, name: str) -> int | None:
        """The row a CONFIG entry applies to, or None when the table is
        full and the name couldn't be placed: writing an unplaceable
        tenant's share/cap onto the returned default row would silently
        retune every header-less client instead. (``default`` itself is
        legitimately configurable and returns row 0.)"""
        row = self.row_for(name)
        if row == 0 and name != DEFAULT_TENANT:
            return None
        return row

    def _apply_shares(self, shares: dict[str, float]) -> None:
        self.share[:] = 1.0
        for name, weight in shares.items():
            row = self._config_row(name)
            if row is None:
                continue  # overflowed (counted by row_for); config skipped
            self.share[row] = np.float32(weight)
            self._labelled.add(name)

    def _apply_caps(self, caps: dict[str, int]) -> None:
        self.cap[:] = 0
        for name, ceiling in caps.items():
            row = self._config_row(name)
            if row is None:
                continue
            self.cap[row] = np.int32(max(ceiling, 0))
            self._labelled.add(name)

    def apply_specs(
        self, shares_spec: str | None, caps_spec: str | None
    ) -> bool:
        """Apply spec STRINGS (CLI flags or the conf hash); no-op (False)
        when both match what is already applied. Raises ValueError on a
        malformed spec — hot-reload callers catch and keep the old table,
        CLI callers fail startup. BOTH specs parse before EITHER applies:
        a retune pairing valid shares with a typo'd caps spec must fail
        whole, not leave new shares silently live beside old caps."""
        new_shares = (
            parse_shares(shares_spec)
            if shares_spec is not None and shares_spec != self._shares_spec
            else None
        )
        new_caps = (
            parse_caps(caps_spec)
            if caps_spec is not None and caps_spec != self._caps_spec
            else None
        )
        changed = False
        if new_shares is not None:
            self._apply_shares(new_shares)
            self._shares_spec = shares_spec
            changed = True
        if new_caps is not None:
            self._apply_caps(new_caps)
            self._caps_spec = caps_spec
            changed = True
        return changed

    def publish(self, store, now: float | None = None) -> None:
        """Write this table's spec strings to the fleet conf hash (the
        hot-reload source of truth); one tiny hash write."""
        fields = {}
        if self._shares_spec is not None:
            fields["shares"] = encode_conf(self._shares_spec, now)
        if self._caps_spec is not None:
            fields["caps"] = encode_conf(self._caps_spec, now)
        if fields:
            store.hset(TENANT_CONF_KEY, fields)

    def maybe_reload(self, store) -> bool:
        """Pull the conf hash and apply any newer spec; True when the
        table changed. Malformed published specs are ignored (the fleet
        keeps serving on the last good config). Raises only on a store
        outage — callers share the serve loop's outage handling."""
        fields = store.hgetall(TENANT_CONF_KEY)
        shares = decode_conf(fields.get("shares"))
        caps = decode_conf(fields.get("caps"))
        try:
            return self.apply_specs(
                shares[0] if shares else None, caps[0] if caps else None
            )
        except ValueError:
            return False

    # -- inflight accounting (enforced in-tick via the `ahead` vector) -----
    def note_dispatched(self, row: int) -> None:
        if 0 <= row < self.max_tenants:
            self.inflight[row] += 1
            self.dispatched[row] += 1

    def note_done(self, row: int) -> None:
        if 0 <= row < self.max_tenants and self.inflight[row] > 0:
            self.inflight[row] -= 1

    # -- observability ------------------------------------------------------
    def stats(self, deficits: np.ndarray | None = None) -> dict:
        """The /stats tenancy block: per-tenant share / cap / inflight /
        dispatched (+ device deficit when the caller read one back)."""
        rows = {}
        for row, name in enumerate(self._names):
            rows[name] = {
                "share": float(self.share[row]),
                "cap": int(self.cap[row]) or None,
                "inflight": int(self.inflight[row]),
                "dispatched": int(self.dispatched[row]),
            }
            if deficits is not None and row < len(deficits):
                rows[name]["deficit"] = round(float(deficits[row]), 3)
        return {
            "tenants": rows,
            "max_tenants": self.max_tenants,
            "overflowed": self.overflowed,
        }
