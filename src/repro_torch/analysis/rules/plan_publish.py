"""plan-publish-single-site: fused plans have ONE construction/publish site.

The epoched plan lifecycle keeps every fused-plan build behind
``repro_torch.etl.plan.PlanManager``: ``acquire``/``repartition`` are the only
doors, ``_install`` is the only place a ``PlanPublished`` control event is
cut, and the lowering primitives (``compile_fused`` /
``compile_fused_sharded`` / ``recompile_columns`` / ``splice_fused`` and
the ``FusedDMM`` / ``ShardedFusedDMM`` constructors) belong to
``repro_torch.core.dmm_torch`` (the counterpart of the reference's
``repro.core.dmm_jax``).  A plan built anywhere else is an unmanaged epoch:
it carries no epoch number, its residency skips the tiering policy, its
cutover is never published for replay, and the manager's ``rebuilds`` /
``bytes_resident`` accounting silently lies.  The incremental/full
bit-exactness contract is only enforced on builds the manager performs.

Like ``single-writer-control``, the name is the contract: a call whose
(import-resolved) target name is one of the restricted symbols fires on
any receiver, so ``dmm_torch.compile_fused(...)``, a ``from ... import
compile_fused as cf`` alias, and a bare ``compile_fused(...)`` are all the
same finding.  ``compile_dpm`` is deliberately NOT restricted -- the
host-side compacted form is a free intermediate (benchmarks A/B it
directly); only the device-resident fused lowering and the publish event
are single-site.

Exempt: ``repro_torch.core.dmm_torch`` (the lowering layer itself) and
``repro_torch.etl.plan`` (the manager).  Tests exercise the primitives directly
through their own sweep, which does not select this rule.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from ..core import FileCtx, Finding, Rule, register
from ..project import attr_chain, module_name

_RESTRICTED = frozenset(
    {
        "compile_fused",
        "compile_fused_sharded",
        "recompile_columns",
        "splice_fused",
        "FusedDMM",
        "ShardedFusedDMM",
        "PlanPublished",
    }
)
_OWNERS = ("repro_torch.core.dmm_torch", "repro_torch.etl.plan")


def _target_name(ctx: FileCtx, func: ast.expr) -> Optional[str]:
    """The restricted symbol a call targets, or None.

    Checks the raw dotted chain's tail AND the import-resolved qname's
    tail, so both ``dmm_torch.compile_fused(...)`` and an aliased
    ``cf(...)`` (``from ... import compile_fused as cf``) resolve.
    """
    chain = attr_chain(func)
    if chain is None:
        return None
    tail = chain.split(".")[-1]
    if tail in _RESTRICTED:
        return tail
    mod = getattr(ctx, "module", None)
    if mod is not None:
        resolved = mod.resolve(chain)
        if resolved:
            rtail = resolved.split(".")[-1]
            if rtail in _RESTRICTED:
                return rtail
    return None


@register
class PlanPublishSingleSite(Rule):
    id = "plan-publish-single-site"
    title = "only PlanManager (repro_torch.etl.plan) builds/publishes fused plans"
    motivation = (
        "the epoch counter, tiering residency, rebuild accounting and "
        "PlanPublished replay all hang off one build path; a plan "
        "constructed elsewhere is an unmanaged epoch that dodges every "
        "one of those contracts"
    )

    def check_file(self, ctx: FileCtx) -> Iterator[Finding]:
        if module_name(ctx) in _OWNERS:
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _target_name(ctx, node.func)
            if name is None:
                continue
            yield ctx.finding(
                self.id,
                node,
                f"{name}(...) outside {' / '.join(_OWNERS)}: fused plans "
                "have one construction/publish site -- acquire an epoch "
                "lease through PlanManager.acquire/repartition (or "
                "PlanManager.repartition for a residency re-cut) instead "
                "of lowering or publishing a plan by hand",
            )
