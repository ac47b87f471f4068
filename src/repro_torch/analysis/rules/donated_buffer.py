"""arena-reuse-in-flight: no write to a host arena after it was handed to
an asynchronous copy, until it is taken again.

The port's counterpart of the reference's buffer donation
(``donated-buffer-reuse``).  The engines densify each chunk into a pinned
host arena (``_HostArenas.take``: ``dense.host`` and its views
``dense.vals`` / ``mask`` / ``rows`` / ``blks`` / ``packed``, a
``BlockDense``'s ``chunk.host``, an ``arena_views(...)`` result), and the
chunk's one C call (``ops.dmm_apply_dense`` / ``dmm_apply_packed`` /
``dmm_apply_blocks``, the ``*_chunk`` entries, the per-block launcher)
issues ``cudaMemcpyAsync`` from it and returns before the copy has run.
After the call the arena is IN FLIGHT -- but only on the card.  On the
CPU the plain version copies synchronously, so a write to the arena after
the call returns the right answer in every test and races the copy on the
card, exactly as ``donate_argnums`` is a no-op on the reference's CPU
backend.  The arena is free again only when ``_HostArenas.take`` hands
it out after waiting on the copies' event.

Mechanics (project model): the async-copy map of
:meth:`repro_torch.analysis.project.Project._build_async_copy_map` knows
the entries, the wrappers that hand a parameter's arena to one (``FusedEngine
.dispatch`` copies from ``dense`` through ``_dispatch``) and the
parameters bound to an entry at a call site.  Within each function the
rule records the arena each copying call receives (``dense.host``, or
``dense`` whole: then every arena view of ``dense``; or a bare arena
``host`` and the names bound from it: ``raw = host.numpy()``, ``v, m, r, b
= arena_views(host, ...)``) and flags every later WRITE to it -- a
subscript store, a torch in-place method (``zero_``, ``copy_``,
``fill_``, ...), ``np.copyto`` -- unless the root name was rebound in
between (``slot, turn, host = arenas.take(n)`` is the retake).  Reads are
free.  Textual order approximates execution order, as in the reference.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from ..core import FileCtx, Finding, Rule, register
from ..project import ARENA_VIEWS, FunctionInfo, Project, as_project, attr_chain


def _pos(node: ast.AST) -> Tuple[int, int]:
    return (node.lineno, node.col_offset)


def _end(node: ast.AST) -> Tuple[int, int]:
    return (node.end_lineno or node.lineno, node.end_col_offset or 0)


_VIEW_CALLS = frozenset({"numpy", "view", "reshape", "narrow", "flatten", "ravel",
                         "contiguous", "__getitem__"})


def _written_chain(node: ast.expr) -> Optional[str]:
    """The dotted chain of the object a written expression lies in:
    ``dense.host[:16]`` -> ``dense.host``, ``raw.view(np.int32)[i]`` ->
    ``raw``."""
    while True:
        if isinstance(node, ast.Subscript):
            node = node.value
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr in _VIEW_CALLS):
            node = node.func.value
        else:
            return attr_chain(node)


def _writes(fn: ast.AST) -> Iterator[Tuple[ast.AST, str]]:
    """(node, written chain) for every write in ``fn``."""
    for node in ast.walk(fn):
        targets: List[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets = [t for t in node.targets if isinstance(t, ast.Subscript)]
        elif isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Subscript):
            targets = [node.target]
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            f = node.func
            if f.attr.endswith("_") and not f.attr.startswith("_"):
                targets = [f.value]  # torch's in-place convention
            elif attr_chain(f) in ("np.copyto", "numpy.copyto") and node.args:
                targets = [node.args[0]]
        for t in targets:
            chain = _written_chain(t)
            if chain is not None:
                yield node, chain


@register
class ArenaReuseInFlight(Rule):
    id = "arena-reuse-in-flight"
    reference_id = "donated-buffer-reuse"
    title = "no write to a host arena after it is handed to an asynchronous copy"
    motivation = (
        "the C entries copy a chunk's pinned arena with cudaMemcpyAsync and "
        "return at once; on the CPU the copy is synchronous, so a write to the "
        "arena after the call passes every test and races the copy on the card "
        "(the port's donate_argnums)"
    )

    def check_project(self, ctxs: Sequence[FileCtx]) -> Iterator[Finding]:
        project = as_project(ctxs)
        for info in project.functions.values():
            yield from self._check_fn(project, info)

    def _check_fn(self, project: Project, info: FunctionInfo) -> Iterator[Finding]:
        ctx = info.ctx
        # (end of the copying call, the arena's tracked chains, callee)
        events: List[Tuple[Tuple[int, int], Set[str], str]] = []
        for node in info.call_nodes:
            for arg in project.arena_args(info, node):
                chain = attr_chain(arg)
                if chain is None:
                    continue
                callee = ctx.segment(node.func) or "<copy>"
                root, _, rest = chain.partition(".")
                if rest in ("host", "chunk") or (not rest and self._holder(info, root)):
                    holder = chain.rsplit(".", 1)[0] if rest else chain
                    tracked = {f"{holder}.{v}" for v in ARENA_VIEWS}
                else:
                    tracked = {chain} | self._aliases(info, chain)
                events.append((_end(node), tracked, callee))
        if not events:
            return

        rebinds: Dict[str, List[int]] = {}

        def bind(tgt: ast.expr, line: int) -> None:
            if isinstance(tgt, ast.Name):
                rebinds.setdefault(tgt.id, []).append(line)
            elif isinstance(tgt, (ast.Tuple, ast.List)):
                for el in tgt.elts:
                    bind(el, line)

        for node in ast.walk(info.node):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    bind(tgt, node.lineno)
            elif isinstance(node, (ast.AnnAssign, ast.NamedExpr)):
                bind(node.target, node.lineno)
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                bind(node.target, node.lineno)

        for node, chain in _writes(info.node):
            for call_end, tracked, callee in events:
                hit = next((t for t in tracked
                            if chain == t or chain.startswith(t + ".")), None)
                if hit is None or _pos(node) < call_end:
                    continue
                root = hit.split(".")[0]
                if any(call_end[0] <= ln <= node.lineno for ln in rebinds.get(root, ())):
                    continue
                yield ctx.finding(
                    self.id,
                    node,
                    f"'{chain}' written after its arena was handed to {callee}() in "
                    f"{info.name}(): the copy from the pinned arena is still in flight "
                    "on the card (the CPU copies at once, so every CPU test passes) -- "
                    "write before the call, or into the arena the next take() hands out",
                )
                break

    @staticmethod
    def _holder(info: FunctionInfo, name: str) -> bool:
        """A bare name handed whole to a copy is an arena holder (a chunk)
        unless it was bound as an arena (``host`` / ``buf``) itself."""
        return not any(k in name for k in ("host", "buf", "arena"))

    @staticmethod
    def _aliases(info: FunctionInfo, chain: str) -> Set[str]:
        """Names bound from the arena: ``raw = host.numpy()[:n]``, ``v, m, r,
        b = arena_views(host, ...)``."""
        out: Set[str] = set()
        for node in ast.walk(info.node):
            if not isinstance(node, ast.Assign):
                continue
            value = node.value
            src = None
            if (isinstance(value, ast.Call) and value.args
                    and (attr_chain(value.func) or "").endswith("arena_views")):
                src = attr_chain(value.args[0])
            else:
                src = _written_chain(value)
            if src != chain:
                continue
            for tgt in node.targets:
                elts = tgt.elts if isinstance(tgt, (ast.Tuple, ast.List)) else [tgt]
                out.update(e.id for e in elts if isinstance(e, ast.Name))
        return out
