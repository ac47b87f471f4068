"""bad-waiver / unused-waiver: the waiver machinery audits itself.

Both rules are enforced inside :func:`repro_torch.analysis.core.analyze` rather
than in ``check_file`` -- ``bad-waiver`` fires while waivers are parsed
(before any rule runs), and ``unused-waiver`` can only be judged AFTER
every selected rule has run and the raw findings are matched against the
waiver spans.  The classes here exist so the two ids are first-class
rules: selectable (``--select bad-waiver,unused-waiver``), listed by
``--list-rules``, and counted in the report's rule set.

``unused-waiver`` is the ``warn_unused_ignores`` shape: a ``# metl-torch:
allow[rule-id] reason`` comment that suppresses nothing is itself a
finding, so waivers cannot rot in place after the code they excused is
refactored away.  A waiver is "used" when ANY raw finding falls inside
its span -- even one claimed by an earlier overlapping waiver -- and is
only judged when every rule it names actually ran in this invocation
(under ``--select``, a waiver for an unselected rule is skipped, not
flagged).  Neither rule can itself be waived: the machinery can't excuse
its own misuse.
"""

from __future__ import annotations

from ..core import Rule, register


@register
class BadWaiver(Rule):
    id = "bad-waiver"
    title = "every waiver carries a reason and names known rule ids"
    motivation = (
        "the reason text is the reviewable artifact -- a bare allow[] is "
        "indistinguishable from a silenced accident; enforced during waiver "
        "parsing in core.analyze, unwaivable"
    )


@register
class UnusedWaiver(Rule):
    id = "unused-waiver"
    title = "a waiver that suppresses nothing is a stale waiver"
    motivation = (
        "waivers rot: the excused code gets refactored away and the comment "
        "keeps silently licensing the next accident on that line; judged "
        "after waiver matching in core.analyze (mypy's warn_unused_ignores "
        "shape), unwaivable"
    )
