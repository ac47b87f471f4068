"""host-sync-in-hot-path: no implicit device synchronisation inside the
async consume machinery.

The port's engine contract (``etl/engines.py`` / ``kernels/ops.py``
docstrings) is that ``dispatch`` and the ``dmm_apply*`` ops return
UNBLOCKED handles -- no ``.item()``, ``.cpu()``, ``.tolist()`` or
``torch.cuda.synchronize()`` -- and ``emit`` is the ONE deliberate sync
point.  That asymmetry is what lets the pipeline's double-buffered async
consume overlap chunk N+1's host densification with chunk N's kernel, and
what the one-C-call-a-chunk route rests on.  A stray ``.cpu()`` anywhere
in ``dispatch`` keeps every row correct and passes every test on the CPU,
where nothing is asynchronous; on the card the overlap just stops.  A
deliberate sync carries a waiver with its reason, so the next reader (and
this rule) can tell it from an accident::

    host.copy_(raw)  # metl-torch: allow[host-sync-in-hot-path] emit's one readback

The sync set is torch's: ``.cpu()``, ``.to("cpu")``, ``.synchronize()``
on any receiver (a CUDA ``Event`` or ``Stream``) and
``torch.cuda.synchronize()``, ``.copy_()`` into a host tensor without
``non_blocking=True``; and the readbacks of a tensor's values --
``.numpy()``, ``.item()``, ``.tolist()``, ``float()`` / ``int()`` /
``bool()`` of a tensor and ``np.asarray`` / ``np.array`` of one.  The
readbacks are no sync on a host array (numpy, a CPU or pinned tensor), so
they are flagged only where the operand is not provably host
(:class:`~repro_torch.analysis.project.Placement`): the C calls'
parameter arrays and the arenas' numpy views are host work.  Code under a
CPU guard (``if dev.type == "cpu":``) is skipped: nothing there waits for
the card.

Scope: functions named ``dispatch`` / ``emit`` / ``_run_async`` and the
``dmm_apply*`` ops, in ``repro_torch.etl`` and ``repro_torch.kernels``,
checked strictly -- a readback there is flagged unless its operand is
provably host -- except ``emit``, whose host work is routine;
PLUS (project model) every function of those packages *reachable* from a
``dispatch`` / ``_run_async`` / ``dmm_apply*`` seed through the call graph
-- the wrapper-indirection hole: a ``.cpu()`` hoisted into an innocently
named helper called from dispatch is on the path whatever it is called.
In ``emit`` and the reached helpers a readback is flagged when its operand
is provably on the card (bound from ``.to(device)``, ``.cuda()`` or a
torch factory given a device); the blocking calls always are.
Unlike the reference's, ``_run_async`` seeds reachability: the torch sync
set does not fire on host numpy, so the densify subtree it reaches is
checked for real syncs (``_HostArenas.take``'s wait) without the
reference's false positives.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, Sequence

from ..core import FileCtx, Finding, Rule, register
from ..project import (HOT_PACKAGES, Placement, as_project, attr_chain, is_cpu_move,
                       walk_card)

_HOT_NAME = re.compile(r"^(dispatch|emit|_run_async|dmm_apply\w*)$")
_REACH_SEED = re.compile(r"^(dispatch|_run_async|dmm_apply\w*)$")

# methods that block on the card whatever their receiver holds
_ALWAYS_SYNC = frozenset({"cpu", "synchronize"})
# methods that read a tensor's values back: flagged in dispatch/_run_async/
# dmm_apply* unless the receiver is provably host, elsewhere (emit, reached
# helpers) when it is provably on the card -- on numpy they are host work
_READBACK = frozenset({"numpy", "item", "tolist"})
# np-namespace calls that read their operand back
_NP_SYNC = frozenset({"asarray", "array", "ascontiguousarray", "copyto"})


@register
class HostSyncInHotPath(Rule):
    id = "host-sync-in-hot-path"
    title = (
        "no implicit device sync inside dispatch/_run_async/dmm_apply*; "
        "emit's syncs are annotated"
    )
    motivation = (
        "the port's async double buffer and one-C-call-a-chunk dispatch both "
        "die silently if a .cpu()/.item()/synchronize() sneaks into the "
        "dispatch path (results stay correct and the CPU tests pass; on the "
        "card the overlap just stops)"
    )

    def check_file(self, ctx: FileCtx) -> Iterator[Finding]:
        if not self._in_scope(ctx):
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if _HOT_NAME.match(node.name):
                    yield from self._check(ctx, node, strict=node.name != "emit",
                                           where=f"in hot-path function {node.name}()")

    def check_project(self, ctxs: Sequence[FileCtx]) -> Iterator[Finding]:
        # helpers REACHED from the seeds (not name-matched: those ran in
        # check_file) get the sync set without the scalar heuristics
        project = as_project(ctxs)
        seeds = project.seeds_matching(_REACH_SEED, packages=HOT_PACKAGES)
        for qname in sorted(project.reachable(seeds)):
            info = project.functions[qname]
            if _HOT_NAME.match(info.name) or not self._in_scope(info.ctx):
                continue
            yield from self._check(
                info.ctx, info.node, strict=False,
                where=f"in {info.name}(), reachable from the dispatch path",
            )

    @staticmethod
    def _in_scope(ctx: FileCtx) -> bool:
        return any(ctx.in_package(*p) for p in HOT_PACKAGES)

    def _check(
        self, ctx: FileCtx, fn: ast.FunctionDef, *, strict: bool, where: str
    ) -> Iterator[Finding]:
        module = ctx.module
        place = Placement(module, fn)
        for node in walk_card(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute):
                chain = attr_chain(f) or ""
                resolved = (module.resolve(chain) if module is not None and chain
                            else None) or chain
                recv = ctx.segment(f.value) or "<expr>"
                if resolved == "torch.cuda.synchronize":
                    yield ctx.finding(self.id, node,
                                      f"torch.cuda.synchronize() {where} blocks the host "
                                      "on the card; keep the dispatch path unblocked")
                elif f.attr in _ALWAYS_SYNC:
                    yield ctx.finding(
                        self.id, node,
                        f"{recv}.{f.attr}() {where} blocks the host on the card; "
                        "the dispatch path must stay unblocked (the sync belongs "
                        "in emit, annotated '# metl-torch: "
                        "allow[host-sync-in-hot-path] ...')",
                    )
                elif f.attr == "to" and is_cpu_move(node):
                    yield ctx.finding(self.id, node,
                                      f"{recv}.to(cpu) {where} is a readback that blocks "
                                      "on the card")
                elif f.attr == "copy_" and not _non_blocking(node) and place.is_host(f.value) \
                        and node.args and not place.is_host(node.args[0]):
                    yield ctx.finding(
                        self.id, node,
                        f"{recv}.copy_(...) {where} copies into host memory and waits "
                        "for it (no non_blocking=True)",
                    )
                elif f.attr in _READBACK and not place.is_host(f.value) and (
                        strict or place.on_card(f.value)):
                    yield ctx.finding(
                        self.id, node,
                        f"{recv}.{f.attr}() {where} reads a tensor's values back "
                        "(a sync when it lies on the card); keep the handle "
                        "unblocked, or show the operand is host memory",
                    )
                elif (
                    isinstance(f.value, ast.Name) and f.value.id in ("np", "numpy")
                    and f.attr in _NP_SYNC and node.args
                    and not place.is_host(node.args[0])
                    and (strict or place.on_card(node.args[0]))
                ):
                    yield ctx.finding(
                        self.id, node,
                        f"np.{f.attr}() {where} of a tensor forces a host readback; "
                        "the dispatch path must stay unblocked",
                    )
            elif isinstance(f, ast.Name) and f.id in ("float", "int", "bool") and node.args:
                arg = node.args[0]
                if place.is_host(arg):
                    continue
                if place.on_card(arg) or (strict and isinstance(arg, (ast.Attribute,
                                                                      ast.Subscript))):
                    yield ctx.finding(
                        self.id, node,
                        f"{f.id}({ctx.segment(arg)}) {where} is a scalar device "
                        "readback if the operand is a tensor on the card; hoist it "
                        "out of the hot path or annotate the sync point",
                    )


def _non_blocking(call: ast.Call) -> bool:
    return any(
        kw.arg == "non_blocking" and not (isinstance(kw.value, ast.Constant)
                                          and not kw.value.value)
        for kw in call.keywords
    )
