"""control-plane-purity: the single-writer control plane stays single-writer.

Schema changes are typed, in-band control events whose registry
mutation runs ONLY inside :meth:`StateCoordinator.apply` -- that is the
whole replayability story: ``apply`` appends every applied event to the
epoch-ordered ``control_log``, so replaying the log over a seed registry
reconstructs state bit-exactly.  A ``event.mutate(registry)`` call
anywhere else mutates the registry *without* logging it, silently breaking
log replay (a fresh instance joining from the log would diverge).
Likewise, a mutable ControlEvent subclass lets a caller edit an event
after it was logged, corrupting the already-written history.

Two checks:

  * ``.mutate(...)`` may be called only inside ``StateCoordinator.apply``
    -- resolved through the call graph, not textual match: a private
    helper whose every caller chain terminates at ``apply``
    (:meth:`Project.only_called_from`) inherits the privilege, so
    ``apply`` can be refactored into steps without waivers, while a
    helper also reachable from public code is refused;
  * every class deriving (transitively, within a file) from
    ``ControlEvent`` must be decorated ``@dataclasses.dataclass(frozen=
    True)``.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Sequence, Set, Tuple

from ..core import FileCtx, Finding, Rule, register
from ..project import as_project


def _dataclass_frozen(dec: ast.expr) -> bool:
    """True for @dataclass(frozen=True) / @dataclasses.dataclass(frozen=True)."""
    if not isinstance(dec, ast.Call):
        return False
    f = dec.func
    name = f.id if isinstance(f, ast.Name) else (
        f.attr if isinstance(f, ast.Attribute) else None
    )
    if name != "dataclass":
        return False
    for kw in dec.keywords:
        if kw.arg == "frozen" and isinstance(kw.value, ast.Constant):
            return bool(kw.value.value)
    return False


@register
class ControlPlanePurity(Rule):
    id = "control-plane-purity"
    title = "mutate() only inside StateCoordinator.apply; ControlEvents frozen"
    motivation = (
        "the control_log replay is bit-exact only because every registry "
        "mutation is logged by the one writer; an unlogged mutate() or a "
        "mutable logged event silently corrupts replay"
    )

    def check_file(self, ctx: FileCtx) -> Iterator[Finding]:
        yield from self._check_frozen_events(ctx)
        # module-level .mutate() calls: no enclosing function, so the call
        # graph has nothing to resolve -- always a violation
        for cls, fn, node in _calls_with_context(ctx.tree):
            if fn is None and self._is_mutate(node):
                yield self._mutate_finding(ctx, node, cls or "<module>")

    def check_project(self, ctxs: Sequence[FileCtx]) -> Iterator[Finding]:
        # check 1, resolved through the call graph: .mutate() only inside
        # StateCoordinator.apply or a private helper of it
        project = as_project(ctxs)
        apply_qnames = {
            info.qname
            for info in project.functions.values()
            if info.cls == "StateCoordinator" and info.name == "apply"
        }
        for info in project.functions.values():
            if info.qname in apply_qnames:
                continue
            if apply_qnames and any(
                project.only_called_from(info.qname, a) for a in apply_qnames
            ):
                continue
            for node in ast.walk(info.node):
                if isinstance(node, ast.Call) and self._is_mutate(node):
                    where = f"{info.cls}.{info.name}" if info.cls else info.name
                    yield self._mutate_finding(info.ctx, node, where)

    @staticmethod
    def _is_mutate(node: ast.Call) -> bool:
        return isinstance(node.func, ast.Attribute) and node.func.attr == "mutate"

    def _mutate_finding(self, ctx: FileCtx, node: ast.Call, where: str) -> Finding:
        return ctx.finding(
            self.id,
            node,
            f".mutate() called from {where}: registry mutations must go "
            "through StateCoordinator.apply(event) so they land in the "
            "replayable control_log",
        )

    # -- check 2: ControlEvent subclasses are frozen dataclasses --------------
    def _check_frozen_events(self, ctx: FileCtx) -> Iterator[Finding]:
        # transitive within the file: class X(ControlEvent) seeds, then
        # class Y(X) inherits the obligation
        event_classes: Set[str] = {"ControlEvent"}
        classes = [
            n for n in ast.walk(ctx.tree) if isinstance(n, ast.ClassDef)
        ]
        changed = True
        while changed:
            changed = False
            for cls in classes:
                if cls.name in event_classes:
                    continue
                for base in cls.bases:
                    base_name = (
                        base.id
                        if isinstance(base, ast.Name)
                        else base.attr if isinstance(base, ast.Attribute) else None
                    )
                    if base_name in event_classes:
                        event_classes.add(cls.name)
                        changed = True
                        break
        for cls in classes:
            if cls.name not in event_classes or cls.name == "ControlEvent":
                continue
            if not any(_dataclass_frozen(d) for d in cls.decorator_list):
                yield ctx.finding(
                    self.id,
                    cls,
                    f"ControlEvent subclass {cls.name} is not a frozen "
                    "dataclass; logged events must be immutable "
                    "(@dataclasses.dataclass(frozen=True))",
                )


def _calls_with_context(
    tree: ast.Module,
) -> Iterator[Tuple[Optional[str], Optional[str], ast.Call]]:
    """Yield (enclosing_class, enclosing_function, Call) for every call."""

    def walk(
        node: ast.AST, cls: Optional[str], fn: Optional[str]
    ) -> Iterator[Tuple[Optional[str], Optional[str], ast.Call]]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from walk(child, child.name, fn)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from walk(child, cls, child.name)
            else:
                if isinstance(child, ast.Call):
                    yield (cls, fn, child)
                yield from walk(child, cls, fn)

    yield from walk(tree, None, None)
