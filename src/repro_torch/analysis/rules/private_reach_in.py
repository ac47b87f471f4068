"""private-reach-in: no private METLApp/engine/Registry access outside the
owning package (the AST successor of the two ci.sh ``git grep`` gates).

The grep gates had three failure modes this rule closes:

  * **aliases** -- ``shadow = app; shadow._fused`` never contains the
    literal ``app._`` and slipped the first grep; the rule tracks names
    bound to app/engine/registry values through assignments, annotations
    and call results, so the alias is as private as the original;
  * **strings/comments** -- docstrings describing ``app._fused`` tripped
    regexes; an AST attribute node cannot be a comment;
  * **receiver blindness** -- ``registry._[a-z]`` missed receivers named
    anything else; the rule types receivers, and keeps the known private
    attribute names (``._fused``, ``._seen``, ...) as an any-receiver
    backstop exactly like the second grep pattern did.

Ownership (the port's): METLApp/engine internals belong to
``repro_torch.etl``; Registry internals belong to ``repro_torch.core``.  Files inside the owning package are
exempt; ``self.`` access is always exempt.

Project model: constructor calls and annotations additionally resolve
through the file's import table (``FileCtx.module``), so ``from
repro_torch.etl.metl import METLApp as App; a = App(...)`` types ``a`` exactly
like the unaliased name -- the one alias form the original rule still
missed.
"""

from __future__ import annotations

import ast
from typing import Any, Dict, Iterator, Optional, Set

from ..core import FileCtx, Finding, Rule, register

# receiver kinds and the package that owns their privates
_OWNER = {
    "app": ("repro_torch", "etl"),
    "engine": ("repro_torch", "etl"),
    "registry": ("repro_torch", "core"),
}

_PUBLIC_API = {
    "app": "app.engine.info() / app.reset_dedup() / app.consume()",
    "engine": "engine.info()",
    "registry": "coordinator.apply(ControlEvent) / Registry.bump_state()",
}

# constructors / factories whose result has a known kind
_CALL_KINDS = {
    "METLApp": "app",
    "Registry": "registry",
    "make_engine": "engine",
    "MappingEngine": "engine",
    "FusedEngine": "engine",
    "ShardedEngine": "engine",
    "BlocksEngine": "engine",
}

# annotation names -> kind (params and AnnAssign)
_ANNOT_KINDS = {
    "METLApp": "app",
    "Registry": "registry",
    "MappingEngine": "engine",
    "FusedEngine": "engine",
    "ShardedEngine": "engine",
    "BlocksEngine": "engine",
}

# the port's METLApp and engine private names, on ANY receiver -- the
# backstop pattern of the old second grep (catches app_rep._seen,
# eng2._arenas).  METLApp: the dedup window, the parked and replayed rows
# and the snapshot; the engines (etl/engines.py): the host arenas, the
# readback buffer and the per-registry uid tables.  The reference's
# ``_fused`` / ``_sharded`` / ``_compiled`` / ``_is_duplicate`` name
# nothing in the port.
_KNOWN_APP_PRIVATE = frozenset(
    {
        "_seen",
        "_parked",
        "_replay_rows",
        "_snapshot",
        "_dedup_window",
        "_arenas",
        "_readback",
        "_stats_uid_col",
        "_uid_col_global",
    }
)


def _name_hint(name: str) -> Optional[str]:
    """Conventional-name fallback for unannotated, untracked receivers."""
    if name == "app" or name.startswith("app_") or name.endswith("_app"):
        return "app"
    if name == "registry" or name.endswith("_registry"):
        return "registry"
    if name == "engine" or name.endswith("_engine"):
        return "engine"
    return None


def _resolved_kind(name: str, module: Any, table: Dict[str, str]) -> Optional[str]:
    """Map a local name through the kind table, resolving import aliases
    via the project model's module import table when one is attached."""
    kind = table.get(name)
    if kind is not None:
        return kind
    if module is not None:
        qname = module.resolve(name)
        if qname is not None:
            return table.get(qname.rsplit(".", 1)[-1])
    return None


def _annot_kind(node: Optional[ast.expr], module: Any = None) -> Optional[str]:
    if isinstance(node, ast.Name):
        return _resolved_kind(node.id, module, _ANNOT_KINDS)
    if isinstance(node, ast.Attribute):
        return _ANNOT_KINDS.get(node.attr)
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return _ANNOT_KINDS.get(node.value.strip().rsplit(".", 1)[-1])
    return None


class _Scope:
    def __init__(self, parent: Optional["_Scope"] = None) -> None:
        self.parent = parent
        self.kinds: Dict[str, str] = {}

    def get(self, name: str) -> Optional[str]:
        scope: Optional[_Scope] = self
        while scope is not None:
            if name in scope.kinds:
                return scope.kinds[name]
            scope = scope.parent
        return _name_hint(name)

    def set(self, name: str, kind: Optional[str]) -> None:
        if kind is None:
            # an explicit rebind to an unknown value clears the tracking
            self.kinds.pop(name, None)
        else:
            self.kinds[name] = kind


@register
class PrivateReachIn(Rule):
    id = "private-reach-in"
    title = "no private METLApp/engine/Registry access outside the owner (repro_torch.etl / repro_torch.core)"
    motivation = (
        "launchers and benchmarks run on the public engine "
        "protocol; the grep gates that enforced it missed aliases and "
        "false-positived on docstrings"
    )

    def check_file(self, ctx: FileCtx) -> Iterator[Finding]:
        exempt = {
            kind for kind, pkg in _OWNER.items() if ctx.in_package(*pkg)
        }
        if len(exempt) == len(_OWNER):
            return
        yield from self._visit(ctx, ctx.tree, _Scope(), exempt)

    # -- scoped walk ----------------------------------------------------------
    def _infer(self, ctx: FileCtx, scope: _Scope, node: ast.expr) -> Optional[str]:
        if isinstance(node, ast.Name):
            return scope.get(node.id)
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Name):
                return _resolved_kind(fn.id, ctx.module, _CALL_KINDS)
            if isinstance(fn, ast.Attribute):
                return _CALL_KINDS.get(fn.attr)
        if isinstance(node, ast.Attribute):
            # pipeline.app, cluster.apps[0].engine, ... -- type by the
            # conventional attribute name (public attrs only)
            if not node.attr.startswith("_"):
                return _name_hint(node.attr)
        return None

    def _bind(self, scope: _Scope, target: ast.expr, kind: Optional[str]) -> None:
        if isinstance(target, ast.Name):
            scope.set(target.id, kind)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._bind(scope, el, None)

    def _visit(
        self, ctx: FileCtx, node: ast.AST, scope: _Scope, exempt: Set[str]
    ) -> Iterator[Finding]:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            inner = _Scope(scope)
            args = node.args
            for a in args.posonlyargs + args.args + args.kwonlyargs:
                kind = _annot_kind(a.annotation, ctx.module)
                if kind is not None:
                    inner.set(a.arg, kind)
            for child in node.body:
                yield from self._visit(ctx, child, inner, exempt)
            return
        if isinstance(node, ast.ClassDef):
            inner = _Scope(scope)
            for child in node.body:
                yield from self._visit(ctx, child, inner, exempt)
            return
        if isinstance(node, ast.Attribute):
            yield from self._check_attr(ctx, node, scope, exempt)
            yield from self._visit(ctx, node.value, scope, exempt)
            return
        if isinstance(node, ast.Assign):
            yield from self._visit(ctx, node.value, scope, exempt)
            kind = self._infer(ctx, scope, node.value)
            for t in node.targets:
                self._bind(scope, t, kind)
            return
        if isinstance(node, ast.AnnAssign):
            if node.value is not None:
                yield from self._visit(ctx, node.value, scope, exempt)
            kind = _annot_kind(node.annotation, ctx.module)
            if kind is None and node.value is not None:
                kind = self._infer(ctx, scope, node.value)
            if isinstance(node.target, ast.Name):
                scope.set(node.target.id, kind)
            return
        for child in ast.iter_child_nodes(node):
            yield from self._visit(ctx, child, scope, exempt)

    def _check_attr(
        self, ctx: FileCtx, node: ast.Attribute, scope: _Scope, exempt: Set[str]
    ) -> Iterator[Finding]:
        attr = node.attr
        if not attr.startswith("_") or attr.startswith("__"):
            return
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            return
        kind = self._infer(ctx, scope, node.value)
        if kind is None and attr in _KNOWN_APP_PRIVATE:
            kind = "app"  # any-receiver backstop (old grep pattern 2)
        if kind is None or kind in exempt:
            return
        recv = ctx.segment(node.value) or "<expr>"
        yield ctx.finding(
            self.id,
            node,
            f"private {kind} attribute {recv}.{attr} reached from outside "
            f"{'.'.join(_OWNER[kind])}; use {_PUBLIC_API[kind]}",
        )
