"""Analyzer framework: file contexts, rule registry, waivers, reports.

The port's copy of ``repro.analysis.core`` (it imports nothing of the
reference).  What differs is the waiver marker: the port reads
``# metl-torch: allow[rule-id] reason`` and only that, so the reference's
``# metl: allow[...]`` waivers (which the reference analyzer reads in the
same files) are invisible here, and the reverse.

The moving parts:

  * :class:`FileCtx` -- one parsed source file (path, source, AST, waivers)
    plus package predicates (``in_package("repro_torch", "etl")``) so rules can
    scope themselves to the packages that own an invariant;
  * :class:`Rule` -- one invariant.  Per-file rules implement
    :meth:`Rule.check_file`; cross-file rules (kernel/ref parity) implement
    :meth:`Rule.check_project` and run once over the whole file set;
  * the waiver machinery -- ``# metl-torch: allow[rule-id] reason`` suppresses a
    finding on the same line, the line below a standalone waiver comment,
    or (when the comment sits on a ``def`` line) the whole function body.
    A waiver without a reason is itself a finding (``bad-waiver``): the
    reason is the reviewable artifact;
  * :func:`analyze` -- collect files, run rules, apply waivers, return a
    :class:`Report` (text/JSON rendering lives in :mod:`repro_torch.analysis.cli`).

Rules register through :func:`register`; importing
:mod:`repro_torch.analysis.rules` pulls in every built-in rule module.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

__all__ = [
    "Finding",
    "Waiver",
    "FileCtx",
    "Rule",
    "RULES",
    "register",
    "Report",
    "analyze",
    "collect_files",
]

# the port's marker; "metl-torch:" can never read as the reference's
# "metl:" (the hyphen stands where its colon must), nor the reverse
WAIVER_RE = re.compile(r"#\s*metl-torch:\s*allow\[([A-Za-z0-9_,\- ]+)\]\s*(.*)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"


@dataclasses.dataclass(frozen=True)
class Waiver:
    """One inline ``# metl-torch: allow[rule-id] reason`` comment.

    ``span`` is the inclusive line range the waiver suppresses: the comment
    line and the line below it, widened to the whole function body when the
    comment sits on a ``def`` line.
    """

    line: int
    rules: Tuple[str, ...]
    reason: str
    span: Tuple[int, int]

    def covers(self, rule: str, line: int) -> bool:
        return rule in self.rules and self.span[0] <= line <= self.span[1]


class FileCtx:
    """One parsed source file, shared by every rule."""

    def __init__(self, path: Path, rel: str, source: str, tree: ast.Module) -> None:
        self.path = path
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.waivers: List[Waiver] = []
        # the owning repro.analysis.project.Module once a Project is built
        # over this file set (set by Project.__init__; None for a bare ctx)
        self.module: Optional[object] = None
        self._func_spans = _function_spans(tree)
        self._parse_waivers()

    # -- package predicates ---------------------------------------------------
    def in_package(self, *parts: str) -> bool:
        """True when ``parts`` appear as consecutive path components, e.g.
        ``ctx.in_package("repro_torch", "etl")`` for
        src/repro_torch/etl/engines.py."""
        p = self.path.parts
        n = len(parts)
        return any(p[i : i + n] == parts for i in range(len(p) - n + 1))

    # -- source access --------------------------------------------------------
    def segment(self, node: ast.AST) -> str:
        """The source text of a node ('' when unavailable)."""
        return ast.get_source_segment(self.source, node) or ""

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        return Finding(
            rule=rule,
            path=self.rel,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0) + 1,
            message=message,
        )

    # -- waivers --------------------------------------------------------------
    def _parse_waivers(self) -> None:
        # real COMMENT tokens only -- a waiver example quoted in a docstring
        # is documentation, not a waiver
        try:
            tokens = list(
                tokenize.generate_tokens(io.StringIO(self.source).readline)
            )
        except (tokenize.TokenError, IndentationError):
            return
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            i = tok.start[0]
            m = WAIVER_RE.search(tok.string)
            if not m:
                continue
            rules = tuple(
                r.strip() for r in m.group(1).split(",") if r.strip()
            )
            reason = m.group(2).strip()
            span = self._func_spans.get(i, (i, i + 1))
            self.waivers.append(
                Waiver(line=i, rules=rules, reason=reason, span=span)
            )

    def waived(self, f: Finding) -> Optional[Waiver]:
        for w in self.waivers:
            if w.covers(f.rule, f.line):
                return w
        return None


def _function_spans(tree: ast.Module) -> Dict[int, Tuple[int, int]]:
    """def-line -> (first body line incl. decorators, last line) for every
    function, so a waiver on a ``def`` covers the whole body."""
    spans: Dict[int, Tuple[int, int]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            start = min(
                [node.lineno] + [d.lineno for d in node.decorator_list]
            )
            spans[node.lineno] = (start, node.end_lineno or node.lineno)
    return spans


# -- rule registry ------------------------------------------------------------


class Rule:
    """One static invariant.

    Subclasses set ``id`` (the waiver/--select key), ``title`` and
    ``motivation`` (the PR/regression that made the invariant worth a
    gate), ``reference_id`` when the reference names its counterpart
    otherwise, and implement :meth:`check_file` and/or :meth:`check_project`.
    """

    id: str = ""
    title: str = ""
    motivation: str = ""
    # the id of the reference analyzer's counterpart, where it differs
    reference_id: str = ""

    def check_file(self, ctx: FileCtx) -> Iterator[Finding]:
        return iter(())

    def check_project(self, ctxs: Sequence[FileCtx]) -> Iterator[Finding]:
        return iter(())


RULES: Dict[str, Rule] = {}


def register(cls: type) -> type:
    """Class decorator: instantiate and register a :class:`Rule`."""
    rule = cls()
    if not rule.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    RULES[rule.id] = rule
    return cls


# -- the run ------------------------------------------------------------------


@dataclasses.dataclass
class Report:
    """The outcome of one analyzer run."""

    paths: List[str]
    rules: List[str]
    n_files: int
    findings: List[Finding]
    waived: List[Tuple[Finding, Waiver]]

    @property
    def ok(self) -> bool:
        return not self.findings

    def as_dict(self) -> Dict[str, object]:
        counts: Dict[str, int] = {}
        for f in self.findings:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        return {
            "version": 1,
            "ok": self.ok,
            "paths": self.paths,
            "rules": self.rules,
            "n_files": self.n_files,
            "counts": counts,
            "findings": [f.as_dict() for f in self.findings],
            "waived": [
                {**f.as_dict(), "reason": w.reason, "waiver_line": w.line}
                for f, w in self.waived
            ],
        }


def collect_files(paths: Sequence[str]) -> List[Path]:
    """Expand files/directories to the sorted set of .py files under them."""
    out: List[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            out.extend(
                f
                for f in sorted(path.rglob("*.py"))
                if "__pycache__" not in f.parts
            )
        elif path.suffix == ".py":
            out.append(path)
    seen = set()
    uniq = []
    for f in out:
        if f not in seen:
            seen.add(f)
            uniq.append(f)
    return uniq


def _load(path: Path) -> Tuple[Optional[FileCtx], Optional[Finding]]:
    try:
        source = path.read_text()
        tree = ast.parse(source, filename=str(path))
    except (SyntaxError, UnicodeDecodeError, OSError) as e:
        line = getattr(e, "lineno", 1) or 1
        return None, Finding(
            rule="parse-error",
            path=str(path),
            line=line,
            col=1,
            message=f"{type(e).__name__}: {e}",
        )
    return FileCtx(path, str(path), source, tree), None


def _selected(
    select: Optional[Sequence[str]], ignore: Optional[Sequence[str]]
) -> List[str]:
    ids = list(RULES)
    if select:
        unknown = sorted(set(select) - set(ids))
        if unknown:
            raise ValueError(f"unknown rule id(s): {', '.join(unknown)}")
        ids = [r for r in ids if r in set(select)]
    if ignore:
        unknown = sorted(set(ignore) - set(RULES))
        if unknown:
            raise ValueError(f"unknown rule id(s): {', '.join(unknown)}")
        ids = [r for r in ids if r not in set(ignore)]
    return ids


def analyze(
    paths: Sequence[str],
    *,
    select: Optional[Sequence[str]] = None,
    ignore: Optional[Sequence[str]] = None,
) -> Report:
    """Run the (selected) rule set over ``paths``; apply waivers."""
    from . import rules as _rules  # noqa: F401  (imports register built-ins)

    rule_ids = _selected(select, ignore)
    active = [RULES[r] for r in rule_ids]

    ctxs: List[FileCtx] = []
    raw: List[Finding] = []
    for path in collect_files(paths):
        ctx, err = _load(path)
        if err is not None:
            raw.append(err)
            continue
        ctxs.append(ctx)
        if "bad-waiver" not in rule_ids:
            continue
        for w in ctx.waivers:
            if not w.reason:
                raw.append(
                    Finding(
                        rule="bad-waiver",
                        path=ctx.rel,
                        line=w.line,
                        col=1,
                        message=(
                            "waiver without a reason: write "
                            "'# metl-torch: allow[rule-id] why it is safe'"
                        ),
                    )
                )
            for r in w.rules:
                if r not in RULES:
                    raw.append(
                        Finding(
                            rule="bad-waiver",
                            path=ctx.rel,
                            line=w.line,
                            col=1,
                            message=f"waiver names unknown rule {r!r}",
                        )
                    )

    # the whole-program model, built ONCE per run; rules receive it as their
    # check_project argument (it is Sequence[FileCtx]-compatible) and every
    # ctx gets its .module set for import-aware per-file rules
    from .project import Project

    project = Project(ctxs)

    by_rel = {ctx.rel: ctx for ctx in ctxs}
    for rule in active:
        for ctx in ctxs:
            raw.extend(rule.check_file(ctx))
        raw.extend(rule.check_project(project))

    # bad-waiver (and the post-hoc unused-waiver below) are unwaivable: the
    # waiver machinery can't excuse its own misuse
    _UNWAIVABLE = {"bad-waiver", "unused-waiver"}
    findings: List[Finding] = []
    waived: List[Tuple[Finding, Waiver]] = []
    used_waivers: set = set()
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.col, f.rule)):
        ctx = by_rel.get(f.path)
        if ctx is not None and f.rule not in _UNWAIVABLE:
            # usage is any-cover: a waiver "suppresses something" when any
            # raw finding falls in its span, even if an earlier overlapping
            # waiver claimed the finding first
            for w in ctx.waivers:
                if w.covers(f.rule, f.line):
                    used_waivers.add((ctx.rel, w.line, w.rules))
        w = ctx.waived(f) if ctx is not None and f.rule not in _UNWAIVABLE else None
        if w is not None:
            waived.append((f, w))
        else:
            findings.append(f)

    if "unused-waiver" in rule_ids:
        selected = set(rule_ids)
        for ctx in ctxs:
            for w in ctx.waivers:
                if not w.reason or any(r not in RULES for r in w.rules):
                    continue  # already a bad-waiver finding
                if not set(w.rules) <= selected:
                    continue  # a named rule didn't run: can't judge usage
                if (ctx.rel, w.line, w.rules) in used_waivers:
                    continue
                findings.append(
                    Finding(
                        rule="unused-waiver",
                        path=ctx.rel,
                        line=w.line,
                        col=1,
                        message=(
                            f"waiver for {', '.join(w.rules)} suppresses "
                            "nothing -- the code it excused is gone; "
                            "delete the comment"
                        ),
                    )
                )
        findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))

    return Report(
        paths=list(paths),
        rules=rule_ids,
        n_files=len(ctxs),
        findings=findings,
        waived=waived,
    )
