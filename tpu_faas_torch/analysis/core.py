"""The AST-walking framework under the project checkers.

Deliberately small: a :class:`Module` (one parsed file plus its per-line
suppressions), a :class:`Checker` base (per-module pass + cross-module
``finalize``), a :class:`Finding` record, and the two report-shaping
mechanisms — inline ``# faas: allow(<rule>)`` suppressions for deliberate
sites (justify them in the same comment) and a JSON baseline file for
grandfathered findings that should not fail CI but must not grow.

Checkers are pure functions of source text: nothing here imports or executes
the code under analysis, so the pass runs identically on a broken tree, in
CI without a TPU, and over fixture snippets in tests.
"""

from __future__ import annotations

import ast
import io
import json
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Sequence

#: ``# faas: allow(rule-a, rule-b)`` — a REAL comment token that STARTS
#: with the directive (matched against tokenize COMMENT tokens, so the
#: spelling quoted inside a docstring or a doc comment never registers a
#: suppression — which matters now that stale suppressions are findings).
_ALLOW_RE = re.compile(r"^#\s*faas:\s*allow\(\s*([^)]*?)\s*\)")

SEVERITIES = ("error", "warning")


@dataclass(frozen=True)
class Finding:
    """One diagnostic, anchored to a file:line."""

    path: str  # posix-style, relative to the scan root when possible
    line: int
    rule: str  # "<checker>.<kebab-id>", e.g. "locks.blocking-call-under-lock"
    severity: str  # "error" | "warning"
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.severity} [{self.rule}] {self.message}"

    def baseline_key(self) -> tuple[str, str, str]:
        """Identity for baseline matching: line numbers are excluded so an
        unrelated edit above a grandfathered site doesn't un-baseline it."""
        return (self.path, self.rule, self.message)


@dataclass
class Module:
    """One parsed source file handed to every checker."""

    path: Path  # absolute
    relpath: str  # as reported in findings
    source: str
    tree: ast.Module
    #: line number -> suppression tokens from a ``# faas: allow(...)`` comment
    allows: dict[int, frozenset[str]] = field(default_factory=dict)
    #: line number -> tokens that actually absorbed a finding this run —
    #: the complement is the stale-suppression report
    used: dict[int, set[str]] = field(default_factory=dict)

    @classmethod
    def parse(cls, path: Path, relpath: str, source: str) -> "Module":
        tree = ast.parse(source, filename=str(path))
        allows: dict[int, frozenset[str]] = {}
        try:
            comments = [
                (tok.start[0], tok.string)
                for tok in tokenize.generate_tokens(
                    io.StringIO(source).readline
                )
                if tok.type == tokenize.COMMENT
            ]
        except (tokenize.TokenError, IndentationError):  # pragma: no cover
            # ast.parse succeeded, so this is near-unreachable; fall back
            # to the line scan rather than losing suppressions entirely
            comments = [
                (lineno, line[line.index("#"):])
                for lineno, line in enumerate(source.splitlines(), start=1)
                if "#" in line
            ]
        for lineno, comment in comments:
            m = _ALLOW_RE.match(comment)
            if m:
                tokens = frozenset(
                    t.strip() for t in m.group(1).split(",") if t.strip()
                )
                if tokens:
                    allows[lineno] = tokens
        return cls(path=path, relpath=relpath, source=source, tree=tree, allows=allows)

    def _matching_tokens(self, line: int, rule: str) -> frozenset[str]:
        tokens = self.allows.get(line)
        if not tokens:
            return frozenset()
        checker = rule.split(".", 1)[0]
        return tokens & {"*", rule, checker}

    def suppressed(self, line: int, rule: str) -> bool:
        """True when ``rule`` is allowed on ``line``. A token matches its
        exact rule, a whole checker (``allow(locks)``), or everything
        (``allow(*)``)."""
        return bool(self._matching_tokens(line, rule))

    def consume_suppression(self, line: int, rule: str) -> bool:
        """:meth:`suppressed`, but recording which tokens did the work —
        what the stale-suppression pass reports against."""
        matched = self._matching_tokens(line, rule)
        if matched:
            self.used.setdefault(line, set()).update(matched)
            return True
        return False

    def stale_allow_tokens(self) -> Iterable[tuple[int, str]]:
        """(line, token) pairs whose suppression absorbed nothing this
        run — comments that have outlived their reason (the rule was
        fixed, the code moved, or the token was a typo all along)."""
        for line in sorted(self.allows):
            for token in sorted(self.allows[line] - self.used.get(line, set())):
                yield line, token


class Checker:
    """Base class: subclass, set ``name``, override :meth:`check`.

    One checker instance sees every module of a run, so state accumulated in
    :meth:`check` is available to :meth:`finalize` for cross-module rules
    (e.g. lock-order consistency)."""

    name: str = "base"

    def check(self, module: Module) -> Iterable[Finding]:
        return ()

    def finalize(self) -> Iterable[Finding]:
        """Called once after every module has been checked."""
        return ()

    def finding(
        self,
        module: Module,
        node: ast.AST,
        rule: str,
        severity: str,
        message: str,
    ) -> Finding:
        assert severity in SEVERITIES, severity
        return Finding(
            path=module.relpath,
            line=getattr(node, "lineno", 1),
            rule=f"{self.name}.{rule}",
            severity=severity,
            message=message,
        )


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def iter_py_files(paths: Sequence[str | Path]) -> list[tuple[Path, Path]]:
    """(file, anchor) pairs for every ``.py`` under ``paths``, where the
    anchor is the argument path's parent — finding paths computed against
    it are stable across working directories (``tpu_faas/store/client.py``
    whether the gate runs from the repo root or anywhere else), which is
    what keeps baseline keys portable.

    A path that does not exist (or an explicit file argument that is not
    Python) raises instead of being skipped: a typo'd target must fail the
    gate, never pass it vacuously."""
    files: list[tuple[Path, Path]] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            anchor = p.resolve().parent
            files.extend((f, anchor) for f in sorted(p.resolve().rglob("*.py")))
        elif p.is_file() and p.suffix == ".py":
            files.append((p.resolve(), p.resolve().parent))
        elif p.is_file():
            raise ValueError(f"not a Python file: {p}")
        else:
            raise FileNotFoundError(f"no such file or directory: {p}")
    # de-duplicate while keeping order (overlapping path arguments)
    seen: set[Path] = set()
    out: list[tuple[Path, Path]] = []
    for f, anchor in files:
        if f not in seen:
            seen.add(f)
            out.append((f, anchor))
    return out


def _relpath(path: Path, root: Path) -> str:
    try:
        return path.resolve().relative_to(root).as_posix()
    except ValueError:
        return path.as_posix()


def run_paths(
    paths: Sequence[str | Path],
    checker_classes: Sequence[type[Checker]] | None = None,
    root: Path | None = None,
) -> list[Finding]:
    """Parse every ``.py`` under ``paths`` and run the checker suite.

    Returns suppression-filtered findings sorted by (path, line, rule).
    Unparseable files yield a single ``core.syntax-error`` error finding —
    a file the pass cannot see is a failure, not a silent skip. Finding
    paths are relative to each scan argument's parent (or to ``root`` when
    given), independent of the process working directory."""
    # a narrowed run (--only / explicit checker_classes) cannot judge
    # staleness for the checkers it skipped — their suppressions absorbed
    # nothing only because the rule never ran
    narrowed = checker_classes is not None
    if checker_classes is None:
        from tpu_faas_torch.analysis import ALL_CHECKERS

        checker_classes = ALL_CHECKERS
    forced_root = root.resolve() if root is not None else None
    checkers = [cls() for cls in checker_classes]
    findings: list[Finding] = []
    modules: list[Module] = []
    for path, anchor in iter_py_files(paths):
        relpath = _relpath(path, forced_root or anchor)
        try:
            source = path.read_text(encoding="utf-8")
            modules.append(Module.parse(path, relpath, source))
        except (SyntaxError, UnicodeDecodeError, OSError) as exc:
            line = getattr(exc, "lineno", None) or 1
            findings.append(
                Finding(relpath, line, "core.syntax-error", "error", str(exc))
            )
    for checker in checkers:
        for module in modules:
            for f in checker.check(module):
                if not module.consume_suppression(f.line, f.rule):
                    findings.append(f)
        # finalize sees suppressions through the checker's own bookkeeping;
        # cross-module findings carry their module context in the checker
    by_rel = {m.relpath: m for m in modules}
    for checker in checkers:
        for f in checker.finalize():
            m = by_rel.get(f.path)
            if m is None or not m.consume_suppression(f.line, f.rule):
                findings.append(f)
    # stale-suppression pass: an allow token that absorbed nothing has
    # outlived its reason. Deliberately NOT itself suppressible (an
    # allow(*) that suppresses nothing would otherwise suppress its own
    # staleness report); warning severity, promoted by --strict.
    active = {c.name for c in checkers}
    for module in modules:
        for line, token in module.stale_allow_tokens():
            if narrowed and token.split(".", 1)[0] not in active:
                continue
            findings.append(
                Finding(
                    module.relpath,
                    line,
                    "core.stale-suppression",
                    "warning",
                    f"suppression 'faas: allow({token})' no longer matches "
                    f"any finding on this line: the rule was fixed, the "
                    f"code moved, or the token never named a firing rule — "
                    f"remove the comment so suppressions cannot outlive "
                    f"their reason",
                )
            )
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return findings


# -- baseline ----------------------------------------------------------------

BASELINE_VERSION = 1


def load_baseline(path: str | Path) -> list[dict]:
    data = json.loads(Path(path).read_text(encoding="utf-8"))
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(f"unsupported baseline version in {path}")
    return list(data.get("findings", []))


def write_baseline(path: str | Path, findings: Iterable[Finding]) -> None:
    """Persist current error-severity findings as the accepted debt set."""
    entries = [
        {"path": f.path, "rule": f.rule, "message": f.message}
        for f in findings
        if f.severity == "error"
    ]
    payload = {"version": BASELINE_VERSION, "findings": entries}
    Path(path).write_text(
        json.dumps(payload, indent=2, sort_keys=True) + "\n", encoding="utf-8"
    )


def subtract_baseline(
    findings: Sequence[Finding], baseline: Sequence[dict]
) -> list[Finding]:
    """Drop findings matching baseline entries (multiset semantics: each
    entry absorbs one finding, so a grandfathered rule can't mask NEW
    instances of the same message elsewhere)."""
    budget: dict[tuple[str, str, str], int] = {}
    for e in baseline:
        key = (e.get("path", ""), e.get("rule", ""), e.get("message", ""))
        budget[key] = budget.get(key, 0) + 1
    out: list[Finding] = []
    for f in findings:
        key = f.baseline_key()
        if budget.get(key, 0) > 0:
            budget[key] -= 1
        else:
            out.append(f)
    return out
