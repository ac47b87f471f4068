"""single-writer-control: only ``StateCoordinator.apply`` writes the control
plane.

The replayability story has ONE writer: ``StateCoordinator.apply``
applies a control event, appends the ``ControlRecord`` to ``control_log``
and advances ``_dpm``/``_frozen``/``_deferred`` -- replaying the log over
a seed registry reconstructs state bit-exactly, which is what the
cluster (and the ROADMAP's distributed coordinator, where the log IS the
replication transport) rely on.  ``control-plane-purity`` already pins
``event.mutate()`` call sites; this rule pins the *state itself*: an
append to ``control_log`` or an assignment to coordinator state from
anywhere else produces unlogged history -- a follower replaying the log
diverges silently.

Resolution is through the call graph, not textual match: a helper is
allowed to write iff every one of its caller chains terminates at
``StateCoordinator.apply`` (:meth:`Project.only_called_from`) -- so
``apply`` can be refactored into private steps without waivers, while a
"wrapper" also reachable from public code is correctly refused.

Checks (project-wide):

  * mutating method calls on ``control_log`` (``.append``/``.extend``/
    ``.insert``/``.pop``/``.remove``/``.clear``) and assignments to a
    ``control_log`` attribute, on ANY receiver -- the name is the contract;
  * assignments/augmented assignments to ``._dpm``/``._frozen``/
    ``._deferred`` on a coordinator-typed receiver (``self`` inside
    ``StateCoordinator``, names bound from ``StateCoordinator(...)`` or
    conventionally named ``coordinator``/``*_coord``, or attribute chains
    ending ``.coordinator``).

``__init__`` constructs the state and is exempt alongside ``apply``.
Reading any of these (``len(coordinator.control_log)``, replay) is free.

**Replication scope.**  The distributed control plane
(:mod:`repro_torch.etl.replication` / :mod:`repro_torch.etl.transport`) splits the
single writer across processes: the LEADER path owns
``StateCoordinator.apply``; follower code rebuilds state exclusively
through ``replay_control_log(..., coordinator=...)``.  Inside those two
modules this rule therefore also flags ``.apply()`` / ``.apply_update()``
calls on any coordinator-typed receiver outside the ``LeaderNode`` class
-- a follower (or transport helper) applying directly would produce
writes the replicated log never shipped, the cross-process version of
unlogged history.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Sequence, Set, Tuple

from ..core import FileCtx, Finding, Rule, register
from ..project import FunctionInfo, Project, as_project, attr_chain

_LOG_MUTATORS = frozenset({"append", "extend", "insert", "pop", "remove", "clear"})
_COORD_STATE = frozenset({"_dpm", "_frozen", "_deferred", "control_log"})
_WRITERS = ("__init__", "apply")
# replicated control plane: modules where coordinator.apply itself is
# leader-only (follower code replays; see module docstring)
_REPLICATED_MODULES = frozenset(
    {"repro_torch.etl.replication", "repro_torch.etl.transport"}
)
_APPLY_CALLS = frozenset({"apply", "apply_update"})
_LEADER_CLASSES = frozenset({"LeaderNode"})


def _coordinator_receiver(chain: Optional[str], coord_names: Set[str]) -> bool:
    """Is this dotted receiver chain coordinator-typed?"""
    if chain is None:
        return False
    root = chain.split(".")[0]
    leaf = chain.split(".")[-1]
    if leaf in ("coordinator", "coord") or leaf.endswith("_coordinator") or leaf.endswith("_coord"):
        return True
    return chain == root and root in coord_names


@register
class SingleWriterControl(Rule):
    id = "single-writer-control"
    title = "only StateCoordinator.apply appends control_log / mutates coordinator state"
    motivation = (
        "the control_log is the replication primitive: a write outside "
        "the single writer is unlogged history, and every instance "
        "reconstructing state from the log silently diverges"
    )

    def check_project(self, ctxs: Sequence[FileCtx]) -> Iterator[Finding]:
        project = as_project(ctxs)
        writer_qnames = {
            info.qname
            for info in project.functions.values()
            if info.cls == "StateCoordinator" and info.name in _WRITERS
        }
        apply_qnames = {q for q in writer_qnames if q.endswith(".apply")}
        for info in project.functions.values():
            if info.qname in writer_qnames:
                continue
            if apply_qnames and any(
                project.only_called_from(info.qname, a) for a in apply_qnames
            ):
                # a private step of apply: every caller chain ends at apply
                continue
            yield from self._check_fn(project, info)
            if (
                info.module.name in _REPLICATED_MODULES
                and info.cls not in _LEADER_CLASSES
            ):
                yield from self._check_replica_apply(info)

    def _check_replica_apply(self, info: FunctionInfo) -> Iterator[Finding]:
        """Inside the replication modules only LeaderNode may call
        ``coordinator.apply``; everything else replays."""
        ctx = info.ctx
        where = f"{info.cls + '.' if info.cls else ''}{info.name}"
        coord_names = _bound_coordinators(info)
        for node in ast.walk(info.node):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _APPLY_CALLS
            ):
                continue
            if _coordinator_receiver(attr_chain(node.func.value), coord_names):
                recv = ctx.segment(node.func.value) or "<expr>"
                yield ctx.finding(
                    self.id,
                    node,
                    f"{recv}.{node.func.attr}() in {where}(): in the "
                    "replicated control plane only the leader path "
                    "(LeaderNode) may call StateCoordinator.apply; follower "
                    "code rebuilds state through replay_control_log(..., "
                    "coordinator=...) so every write ships on the log",
                )

    def _check_fn(self, project: Project, info: FunctionInfo) -> Iterator[Finding]:
        ctx = info.ctx
        where = f"{info.cls + '.' if info.cls else ''}{info.name}"
        coord_names = _bound_coordinators(info)

        for node in ast.walk(info.node):
            # coordinator.control_log.append(...) -- any receiver: the
            # attribute name IS the contract
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _LOG_MUTATORS
                and (
                    (
                        isinstance(node.func.value, ast.Attribute)
                        and node.func.value.attr == "control_log"
                    )
                    or (
                        isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "control_log"
                    )
                )
            ):
                yield ctx.finding(
                    self.id,
                    node,
                    f"control_log.{node.func.attr}() in {where}(): only "
                    "StateCoordinator.apply may write the control log -- "
                    "route the event through coordinator.apply(event) so it "
                    "is recorded for replay",
                )
                continue
            targets: List[Tuple[ast.expr, str]] = []
            if isinstance(node, ast.Assign):
                targets = [(t, "assignment") for t in _flat_targets(node.targets)]
            elif isinstance(node, ast.AugAssign):
                targets = [(node.target, "augmented assignment")]
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = [(node.target, "assignment")]
            for tgt, what in targets:
                if not (isinstance(tgt, ast.Attribute) and tgt.attr in _COORD_STATE):
                    continue
                if tgt.attr == "control_log":
                    # rebinding the log itself rewrites history: flagged on
                    # any receiver, like the mutator calls above
                    pass
                elif not _coordinator_receiver(attr_chain(tgt.value), coord_names):
                    continue
                recv = ctx.segment(tgt.value) or "<expr>"
                yield ctx.finding(
                    self.id,
                    tgt,
                    f"{what} to {recv}.{tgt.attr} in {where}(): coordinator "
                    "state has one writer (StateCoordinator.apply); anything "
                    "else is unlogged history that breaks control-log replay",
                )


def _bound_coordinators(info: FunctionInfo) -> Set[str]:
    """Names bound from StateCoordinator(...) / replay_control_log(...) /
    from_dusb(...) in this function (plus ``self`` inside the class)."""
    coord_names: Set[str] = set()
    if info.cls == "StateCoordinator":
        coord_names.add("self")
    for node in ast.walk(info.node):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            fchain = attr_chain(node.value.func) or ""
            tail = fchain.split(".")[-1]
            if tail in ("StateCoordinator", "replay_control_log", "from_dusb"):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        coord_names.add(tgt.id)
    return coord_names


def _flat_targets(targets: Sequence[ast.expr]) -> Iterator[ast.expr]:
    for t in targets:
        if isinstance(t, (ast.Tuple, ast.List)):
            yield from _flat_targets(t.elts)
        else:
            yield t
