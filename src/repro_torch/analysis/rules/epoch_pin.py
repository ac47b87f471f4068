"""epoch-pin-escape: in-flight dense chunks carry their epoch pin and are
not read through across a coordinator mutation.

In-flight chunks are epoch-pinned: ``DenseChunk``/``ColumnarDense``
hold the ``plan`` they were densified under, so a chunk dispatched before
a control event drains on the OLD table while the coordinator moves on --
that is the whole correctness story for applying control at chunk
boundaries (and the mechanism the ROADMAP's online-compaction item
publishes new plans through).  The pin escapes two ways, both silent:

  * a construction that drops the pin (``ColumnarDense(plan=None, ...)``
    or no ``plan`` at all) produces a chunk whose ``.epoch``/table
    resolution follows the *live* plan;
  * reading plan state THROUGH a chunk (``chunk.plan...`` or
    ``chunk.epoch``) after a coordinator mutation in the same scope: the
    read observes post-mutation state for a chunk densified pre-mutation.

Checks: every ``DenseChunk``/``ColumnarDense``/``BlockDense`` call (the
port's three in-flight chunk types; resolved through
imports; ``dataclasses.replace`` is exempt) must bind ``plan`` positionally
or by keyword, to something other than ``None``; and in each function,
a ``.plan``/``.epoch`` load through a variable bound from ``.densify()``
or a chunk constructor is flagged when a coordinator mutation
(``.apply``/``.freeze``/``.thaw``/``.apply_update``/``.set_dpm`` on a
coordinator-typed receiver) sits between the bind and the read --
rebinding the chunk after the mutation re-pins it and clears the flag.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Sequence

from ..core import FileCtx, Finding, Rule, register
from ..project import FunctionInfo, Project, as_project, attr_chain

# the port's in-flight chunks: each carries the plan it was densified
# against as its first field (etl/engines.py)
_CHUNK_TYPES = frozenset({"DenseChunk", "ColumnarDense", "BlockDense"})
_MUTATORS = frozenset({"apply", "freeze", "thaw", "apply_update", "set_dpm"})


def _chunk_ctor(func: ast.expr) -> Optional[str]:
    """The chunk type name when ``func`` is a DenseChunk/ColumnarDense
    reference (possibly dotted / aliased by import handled by caller)."""
    chain = attr_chain(func)
    if chain is None:
        return None
    tail = chain.split(".")[-1]
    return tail if tail in _CHUNK_TYPES else None


def _coordinatorish(chain: Optional[str]) -> bool:
    if chain is None:
        return False
    leaf = chain.split(".")[-1]
    return (
        leaf in ("coordinator", "coord")
        or leaf.endswith("_coordinator")
        or leaf.endswith("_coord")
    )


@register
class EpochPinEscape(Rule):
    id = "epoch-pin-escape"
    title = "dense chunks carry their epoch pin; no plan read through a chunk across a mutation"
    motivation = (
        "chunk-boundary control application is only correct because "
        "in-flight chunks are pinned to the plan they were densified under; "
        "an unpinned chunk or a post-mutation read through one follows the "
        "live plan and maps rows with the wrong table"
    )

    def check_project(self, ctxs: Sequence[FileCtx]) -> Iterator[Finding]:
        project = as_project(ctxs)
        for info in project.functions.values():
            yield from self._check_ctors(project, info)
            yield from self._check_cross_mutation_reads(info)

    # -- check 1: every construction binds the pin ----------------------------
    def _check_ctors(self, project: Project, info: FunctionInfo) -> Iterator[Finding]:
        ctx = info.ctx
        for node in ast.walk(info.node):
            if not isinstance(node, ast.Call):
                continue
            tname = _chunk_ctor(node.func)
            if tname is None:
                # import alias: From x import ColumnarDense as CD
                chain = attr_chain(node.func)
                if chain is not None and info.module is not None:
                    q = info.module.resolve(chain)
                    if q is not None and q.split(".")[-1] in _CHUNK_TYPES:
                        tname = q.split(".")[-1]
            if tname is None:
                continue
            plan: Optional[ast.expr] = node.args[0] if node.args else None
            for kw in node.keywords:
                if kw.arg == "plan":
                    plan = kw.value
                if kw.arg is None:
                    plan = plan or kw.value  # **kwargs: assume it carries plan
            if plan is None:
                yield ctx.finding(
                    self.id,
                    node,
                    f"{tname}(...) constructed without its epoch pin in "
                    f"{info.name}(): pass plan= so the in-flight chunk drains "
                    "on the table it was densified under",
                )
            elif isinstance(plan, ast.Constant) and plan.value is None:
                yield ctx.finding(
                    self.id,
                    node,
                    f"{tname}(plan=None, ...) in {info.name}() drops the "
                    "epoch pin: the chunk would resolve against the live "
                    "plan after the next control event",
                )

    # -- check 2: no plan read through a chunk across a mutation --------------
    def _check_cross_mutation_reads(self, info: FunctionInfo) -> Iterator[Finding]:
        ctx = info.ctx

        chunk_binds: Dict[str, List[int]] = {}
        for node in ast.walk(info.node):
            if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)):
                continue
            fchain = attr_chain(node.value.func) or ""
            tail = fchain.split(".")[-1]
            if tail == "densify" or tail in _CHUNK_TYPES:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        chunk_binds.setdefault(tgt.id, []).append(node.lineno)
        if not chunk_binds:
            return

        mutations: List[int] = []
        for node in ast.walk(info.node):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _MUTATORS
                and _coordinatorish(attr_chain(node.func.value))
            ):
                mutations.append(node.lineno)
        if not mutations:
            return

        for node in ast.walk(info.node):
            if not (
                isinstance(node, ast.Attribute)
                and node.attr in ("plan", "epoch")
                and isinstance(node.ctx, ast.Load)
                and isinstance(node.value, ast.Name)
                and node.value.id in chunk_binds
            ):
                continue
            binds = [b for b in chunk_binds[node.value.id] if b <= node.lineno]
            if not binds:
                continue
            last_bind = max(binds)
            crossed = [m for m in mutations if last_bind < m <= node.lineno]
            if not crossed:
                continue
            yield ctx.finding(
                self.id,
                node,
                f"{node.value.id}.{node.attr} read after a coordinator "
                f"mutation on line {crossed[0]} in {info.name}(): the chunk "
                f"was densified before the mutation (line {last_bind}), so "
                "plan state read through it is no longer the pinned epoch -- "
                "capture it before applying control, or re-densify",
            )
