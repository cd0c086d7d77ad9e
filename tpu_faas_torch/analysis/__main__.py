"""CLI: ``python -m tpu_faas_torch.analysis [paths] [options]``.

Exit status is the gate contract: 0 when every error-severity finding is
suppressed or baselined, 1 otherwise (2 on bad usage). Warnings never fail
the gate unless ``--strict``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import tpu_faas_torch
from tpu_faas_torch.analysis import (
    ALL_CHECKERS,
    load_baseline,
    run_paths,
    subtract_baseline,
    write_baseline,
)
from tpu_faas_torch.analysis.core import Finding, iter_py_files

_SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)


def to_sarif(findings: list[Finding]) -> dict:
    """SARIF 2.1.0 for the findings that survived baseline subtraction —
    the shape GitHub code scanning ingests to annotate PR diffs inline.
    Rule metadata is derived from the findings themselves (the suite has
    no separate rule registry to drift from)."""
    rules: dict[str, dict] = {}
    results: list[dict] = []
    for f in findings:
        rules.setdefault(
            f.rule,
            {
                "id": f.rule,
                "shortDescription": {"text": f.rule},
                "defaultConfiguration": {
                    "level": "error" if f.severity == "error" else "warning"
                },
            },
        )
        results.append(
            {
                "ruleId": f.rule,
                "level": "error" if f.severity == "error" else "warning",
                "message": {"text": f.message},
                "locations": [
                    {
                        "physicalLocation": {
                            "artifactLocation": {
                                "uri": f.path,
                                "uriBaseId": "%SRCROOT%",
                            },
                            "region": {"startLine": f.line},
                        }
                    }
                ],
            }
        )
    return {
        "version": "2.1.0",
        "$schema": _SARIF_SCHEMA,
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "tpu-faas-analysis",
                        "informationUri": (
                            "https://github.com/tpu-faas/tpu-faas"
                            "/blob/main/docs/ANALYSIS.md"
                        ),
                        "rules": [rules[k] for k in sorted(rules)],
                    }
                },
                "results": results,
            }
        ],
    }


def main(argv: list[str] | None = None) -> int:
    checker_names = [cls.name for cls in ALL_CHECKERS]
    parser = argparse.ArgumentParser(
        prog="python -m tpu_faas_torch.analysis",
        description="Static protocol / trace-safety / lock / event-loop / "
        "registry-completeness / shard-routing / metrics-discipline / "
        "kernel-binding / device-snapshot / plane-gating checks for the "
        "PyTorch/CUDA port's tree (see docs/ANALYSIS.md for the rules it "
        "shares with the JAX package's analysers).",
    )
    parser.add_argument(
        "paths",
        nargs="*",
        help="files or directories to scan (default: the installed "
        "tpu_faas_torch package)",
    )
    parser.add_argument(
        "--baseline",
        metavar="FILE",
        help="JSON baseline of grandfathered findings to subtract",
    )
    parser.add_argument(
        "--write-baseline",
        metavar="FILE",
        help="write current error findings to FILE and exit 0",
    )
    parser.add_argument(
        "--only",
        metavar="CHECKER[,CHECKER]",
        help="run only the named checker(s), comma-separated, for fast "
        f"targeted iteration (available: {', '.join(checker_names)}); "
        "note the stale-suppression pass then only sees the selected "
        "rules' tokens",
    )
    parser.add_argument(
        "--strict",
        action="store_true",
        help="warnings also fail the gate",
    )
    parser.add_argument(
        "--json",
        action="store_true",
        dest="as_json",
        help="emit findings as a JSON array instead of text",
    )
    parser.add_argument(
        "--sarif",
        metavar="FILE",
        help="additionally write findings (after baseline subtraction) "
        "as SARIF 2.1.0 to FILE, for inline PR annotation",
    )
    args = parser.parse_args(argv)

    checker_classes = None
    if args.only:
        by_name = {cls.name: cls for cls in ALL_CHECKERS}
        wanted = [t.strip() for t in args.only.split(",") if t.strip()]
        unknown = [t for t in wanted if t not in by_name]
        if unknown or not wanted:
            print(
                f"tpu_faas_torch.analysis: unknown checker(s) "
                f"{', '.join(unknown) or '<empty>'} "
                f"(available: {', '.join(checker_names)})",
                file=sys.stderr,
            )
            return 2
        checker_classes = [by_name[t] for t in wanted]

    paths = args.paths or [Path(tpu_faas_torch.__file__).parent]
    try:
        if not iter_py_files(paths):
            print(
                f"no Python files found under {', '.join(map(str, paths))}",
                file=sys.stderr,
            )
            return 2
        findings = run_paths(paths, checker_classes=checker_classes)
    except (FileNotFoundError, ValueError) as exc:
        # a typo'd target must fail the gate, never pass it vacuously
        print(f"tpu_faas_torch.analysis: {exc}", file=sys.stderr)
        return 2

    if args.write_baseline:
        write_baseline(args.write_baseline, findings)
        errors = sum(1 for f in findings if f.severity == "error")
        print(f"baseline: {errors} error finding(s) -> {args.write_baseline}")
        return 0

    if args.baseline:
        try:
            findings = subtract_baseline(findings, load_baseline(args.baseline))
        except (OSError, ValueError, json.JSONDecodeError) as exc:
            print(f"cannot load baseline {args.baseline}: {exc}", file=sys.stderr)
            return 2

    if args.sarif:
        Path(args.sarif).write_text(
            json.dumps(to_sarif(findings), indent=2) + "\n", encoding="utf-8"
        )

    if args.as_json:
        print(
            json.dumps(
                [
                    {
                        "path": f.path,
                        "line": f.line,
                        "rule": f.rule,
                        "severity": f.severity,
                        "message": f.message,
                    }
                    for f in findings
                ],
                indent=2,
            )
        )
    else:
        for f in findings:
            print(f)

    errors = sum(1 for f in findings if f.severity == "error")
    warnings = sum(1 for f in findings if f.severity == "warning")
    if not args.as_json:
        print(
            f"tpu_faas_torch.analysis: {errors} error(s), {warnings} warning(s)"
            + (" (strict)" if args.strict else "")
        )
    failed = errors > 0 or (args.strict and warnings > 0)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
