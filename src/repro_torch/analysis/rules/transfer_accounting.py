"""transfer-accounting: the per-chunk path crosses host->device at the
accounted sites only.

The port's consume contract is one C call a chunk that copies the chunk's
arena to the card and launches the kernel, and REPORTS its copies: 4 a
chunk with host densify, 1 with device densify, 2 a group on the
per-block engine.  ``_dispatch`` (``etl/engines.py``) and
``BlocksEngine.dispatch`` add what the call reports to
``stats["transfers"]``, and the roofline and the chip checks price chunks
by that count.  A stray ``.to(device)`` on the per-chunk path is double
trouble: it adds a copy the accounting never sees (the count silently
diverges from the traffic) and it puts PCIe traffic back on the path the
C entries took it off.

Scope (project model): functions inside :meth:`Project.hot_path` --
transitive callees of the engine ``densify``/``dispatch``/``consume``
entry points -- restricted to ``repro_torch.etl`` files (the C entries'
own copies happen in C and report themselves).  The flagged conversions:
``.to(<device>)`` (not a dtype, not the CPU), ``.cuda()``,
``torch.as_tensor`` / ``torch.tensor`` / ``torch.asarray`` with a device
that is not the CPU, and ``.copy_(src)`` into a tensor that is not
provably host from one that is.  Code under a CPU guard is skipped.  A
deliberate copy outside the accounted sites carries a waiver that says
why.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Sequence

from ..core import FileCtx, Finding, Rule, register
from ..project import (Placement, as_project, attr_chain, is_cpu_literal, to_device_arg,
                       walk_card)

_TORCH_CONVERT = frozenset({"as_tensor", "tensor", "asarray"})


def _conversion(call: ast.Call, resolved: str, place: Placement) -> Optional[str]:
    """The pretty name of a host->device conversion call, or None."""
    f = call.func
    if not isinstance(f, ast.Attribute):
        return None
    if f.attr == "cuda":
        return ".cuda()"
    if f.attr == "to" and to_device_arg(call) is not None:
        return ".to(<device>)"
    if resolved.startswith("torch.") and f.attr in _TORCH_CONVERT:
        for kw in call.keywords:
            if kw.arg == "device" and not is_cpu_literal(kw.value):
                return f"torch.{f.attr}(..., device=...)"
    if (
        f.attr == "copy_" and call.args
        and not place.is_host(f.value) and place.is_host(call.args[0])
    ):
        return ".copy_(<host tensor>)"
    return None


@register
class TransferAccounting(Rule):
    id = "transfer-accounting"
    title = "no host->device conversion on the per-chunk path outside the accounted sites"
    motivation = (
        "the port's one-C-call-a-chunk contract and the roofline's transfer "
        "pricing both assume every host->device copy is one the C entry "
        "reports into stats['transfers']; a stray .to(device) on the hot "
        "path is unaccounted PCIe traffic"
    )

    def check_project(self, ctxs: Sequence[FileCtx]) -> Iterator[Finding]:
        project = as_project(ctxs)
        for qname in sorted(project.hot_path()):
            info = project.functions[qname]
            if not info.ctx.in_package("repro_torch", "etl"):
                continue
            ctx = info.ctx
            place = Placement(info.module, info.node)
            for node in walk_card(info.node):
                if not isinstance(node, ast.Call):
                    continue
                chain = attr_chain(node.func)
                resolved = (info.module.resolve(chain) if chain is not None else None) \
                    or chain or ""
                conv = _conversion(node, resolved, place)
                if conv is None:
                    continue
                yield ctx.finding(
                    self.id,
                    node,
                    f"{conv} in hot-path function {info.name}() is a host->device "
                    "copy the per-chunk accounting never sees; copy through the "
                    "chunk's C entry (which reports into stats['transfers']) or "
                    "move it out of the per-chunk path",
                )
