"""hot-path-python-loop: densification must stay vectorised -- no per-event
python loops or payload-dict walks in densify/dispatch functions.

The fused engine replaced the per-block, per-event python mapping walk
with one dispatch, and the columnar densify replaced the per-event
payload-dict densification walk with columnar numpy (8.5x densify events/s at 512-event chunks).  Both
regressions re-enter the codebase the same way: an innocent ``for ev in
events`` or ``ev.payload().items()`` inside a densify function, correct
and quietly 10x slower.  This rule makes the loop itself the violation.

Scope (project model): the union of functions whose NAME contains
``densify``/``dispatch`` plus the hot routing helpers
(``_chunk_layout``/``_pack_columnar``) -- the pre-project textual
scoping, kept so a hot-named function with no resolvable caller is still
covered -- and everything in :meth:`Project.hot_path`: transitive callees
of the engine ``densify``/``dispatch``/``consume`` entry points, resolved
through the call graph.  The reachability half is what closes the
wrapper-indirection false negative: a per-event walk in an innocently
named helper called from ``consume_groups`` is on the hot path whatever
it is called.  Both halves restricted to ``repro_torch.etl`` and
``repro_torch.kernels`` files.

Per-COLUMN and per-SHARD/per-BLOCK loops are fine (columns and shards are
few and bounded); what is flagged is iteration whose trip count scales
with the chunk: loops over events/items and any ``.payload()`` call (the
dict-walk marker).  The deliberate per-event paths carry function-level
waivers on their ``def`` lines, as the reference's: the dict-walk oracle
(:func:`repro_torch.etl.engines.densify_chunk_dicts`), the legacy
``Groups`` lift at the consume boundary
(:func:`repro_torch.etl.engines.as_triaged`), the source-boundary payload
flatten (:func:`repro_torch.etl.events.columnarize` and
``ColumnarChunk.meta_columns``) and the per-block engine's group payload
view (``BlockDense.payload``).
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, Sequence, Set, Tuple

from ..core import FileCtx, Finding, Rule, register
from ..project import HOT_PACKAGES, as_project

_HOT_NAME = re.compile(r"densify|dispatch|_chunk_layout|_pack_columnar")

# iterable source text that scales with the chunk's event/item count
_EVENTISH = re.compile(
    r"\bevents\b|\bevs\b|\.payload\(|chunk\.keys|chunk\.uids|chunk\.vals"
    r"|chunk\.events|\bitem_idx\b|\bev_rows\b"
)


@register
class HotPathPythonLoop(Rule):
    id = "hot-path-python-loop"
    title = "no per-event python loops / payload-dict walks in densify or dispatch"
    motivation = (
        "the regression class of the per-block python mapping walk and the "
        "per-event payload-dict densify walk (8.5x once vectorised)"
    )

    def check_project(self, ctxs: Sequence[FileCtx]) -> Iterator[Finding]:
        project = as_project(ctxs)
        hot = project.hot_path()
        seen: Set[Tuple[str, int]] = set()
        # reachability half: functions on the hot path through the call
        # graph, whatever their name
        for qname in sorted(hot):
            info = project.functions[qname]
            if self._in_scope(info.ctx):
                seen.add((info.ctx.rel, info.node.lineno))
                yield from self._check_fn(info.ctx, info.node)
        # textual half: hot-NAMED functions the call graph could not reach
        # (an entry point nothing analyzed calls yet is still hot)
        for ctx in ctxs:
            if not self._in_scope(ctx):
                continue
            for node in ast.walk(ctx.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if _HOT_NAME.search(node.name) and (ctx.rel, node.lineno) not in seen:
                        yield from self._check_fn(ctx, node)

    @staticmethod
    def _in_scope(ctx: FileCtx) -> bool:
        return any(ctx.in_package(*p) for p in HOT_PACKAGES)

    def _check_fn(self, ctx: FileCtx, fn: ast.FunctionDef) -> Iterator[Finding]:
        where = f"in hot-path function {fn.name}()"
        for node in ast.walk(fn):
            # the dict-walk marker: ANY payload() call means per-event dicts
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "payload"
            ):
                yield ctx.finding(
                    self.id,
                    node,
                    f".payload() {where}: per-event payload-dict walk "
                    "(the walk the columnar densify removed); densify from the chunk's "
                    "columnar uids/vals arrays instead",
                )
                continue
            iters = []
            if isinstance(node, ast.For):
                iters = [node.iter]
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)):
                iters = [g.iter for g in node.generators]
            for it in iters:
                src = ctx.segment(it)
                if _EVENTISH.search(src):
                    yield ctx.finding(
                        self.id,
                        node,
                        f"python loop over '{src}' {where} scales with the "
                        "chunk's event/item count; vectorise it (see "
                        "_segmented_arange / _event_items) or waive with a "
                        "reason if it is an oracle path",
                    )
                    break
