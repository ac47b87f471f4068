"""Command-line front end: ``python -m repro_torch.analysis <paths>``."""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Sequence, TextIO

from .core import RULES, Report, analyze


def _split(v: Optional[str]) -> Optional[List[str]]:
    if not v:
        return None
    return [s.strip() for s in v.split(",") if s.strip()]


def _render_github(report: Report, out: TextIO) -> None:
    """GitHub Actions workflow-command annotations: each finding renders as
    an ``::error`` line that CI overlays on the diff at file:line.  The
    trailing plain-text summary line is NOT a workflow command, so it shows
    in the raw log without extra annotations.  Exit codes are unchanged
    (0 clean / 1 findings / 2 usage error)."""
    for f in report.findings:
        # messages must be single-line for the workflow-command grammar
        msg = f.message.replace("\n", " ")
        print(
            f"::error file={f.path},line={f.line},col={f.col},"
            f"title=repro_torch.analysis[{f.rule}]::{msg}",
            file=out,
        )
    status = "OK" if report.ok else f"{len(report.findings)} finding(s)"
    print(
        f"repro_torch.analysis: {status} "
        f"({report.n_files} files, {len(report.rules)} rules, "
        f"{len(report.waived)} waived)",
        file=out,
    )


def _render_text(report: Report, out: TextIO) -> None:
    for f in report.findings:
        print(f.render(), file=out)
    if report.waived:
        print(f"-- {len(report.waived)} waived:", file=out)
        for f, w in report.waived:
            print(f"   {f.render()}  (waived: {w.reason})", file=out)
    status = "OK" if report.ok else f"{len(report.findings)} finding(s)"
    print(
        f"repro_torch.analysis: {status} "
        f"({report.n_files} files, {len(report.rules)} rules)",
        file=out,
    )


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST-based invariant analyzer for the METL repo "
        "(rule catalog: python -m repro_torch.analysis --list-rules).",
    )
    parser.add_argument("paths", nargs="*", help="files or directories to analyze")
    parser.add_argument(
        "--select", metavar="IDS", help="comma-separated rule ids to run (only)"
    )
    parser.add_argument(
        "--ignore", metavar="IDS", help="comma-separated rule ids to skip"
    )
    parser.add_argument(
        "--output", choices=("text", "json", "github"), default="text",
        help="stdout format (default: text); 'github' emits "
        "::error workflow-command annotations for CI logs",
    )
    parser.add_argument(
        "--report", metavar="FILE",
        help="also write the JSON report to FILE (any --output)",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print the rule catalog and exit"
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        from . import rules as _rules  # noqa: F401

        for rid, rule in sorted(RULES.items()):
            print(f"{rid}\n    {rule.title}\n    why: {rule.motivation}")
            if rule.reference_id:
                print(f"    reference: {rule.reference_id}")
        return 0

    if not args.paths:
        parser.print_usage(sys.stderr)
        print("error: no paths given", file=sys.stderr)
        return 2

    try:
        report = analyze(
            args.paths, select=_split(args.select), ignore=_split(args.ignore)
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.report:
        with open(args.report, "w") as fh:
            json.dump(report.as_dict(), fh, indent=2)
            fh.write("\n")

    if args.output == "json":
        json.dump(report.as_dict(), sys.stdout, indent=2)
        print()
    elif args.output == "github":
        _render_github(report, sys.stdout)
    else:
        _render_text(report, sys.stdout)
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
