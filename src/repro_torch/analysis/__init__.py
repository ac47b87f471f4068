"""repro_torch.analysis -- the port's AST-based invariant analyzer.

The counterpart of ``repro.analysis``, with its rules keyed to the port's
own contracts (``repro_torch.etl`` / ``core`` / ``kernels``, torch's syncs
and copies, the C entries' host arenas) and run over the port.  It imports
nothing of the reference.  Run it as::

    python -m repro_torch.analysis src/repro_torch chip_smoke.py examples/*_torch.py
    python -m repro_torch.analysis --list-rules
    python -m repro_torch.analysis src/repro_torch --select host-sync-in-hot-path --output json

Exit codes: 0 clean, 1 findings, 2 usage/internal error.

The rule catalog (the reference's id, where the port's differs, in
brackets):

``private-reach-in``
    No private METLApp/engine/Registry attribute access outside the owning
    package (``repro_torch.etl`` / ``repro_torch.core``); aliases tracked,
    strings and comments ignored, the port's own private names
    (``_seen``, ``_arenas``, ...) kept as an any-receiver backstop.
    Guards: the public engine protocol (``app.engine.info()``).

``host-sync-in-hot-path``
    ``dispatch`` / ``_run_async`` / ``dmm_apply*`` and everything they reach
    never block on the card: no ``.cpu()``, ``.to("cpu")``,
    ``.synchronize()``, ``torch.cuda.synchronize()``, ``.copy_()`` into
    host memory, and no ``.item()`` / ``.tolist()`` / ``.numpy()`` /
    ``float()`` / ``np.asarray`` of a tensor that is not provably host;
    ``emit``'s deliberate syncs carry a waiver.  Guards: ROADMAP's ground
    rule "``dispatch`` and ``ops`` return unblocked handles" and "emit is
    the only sync point" -- the async double buffer's overlap.

``hot-path-python-loop``
    No per-event python loops or ``.payload()`` dict walks on the
    densify/dispatch path; per-column/per-shard loops are fine.  Guards:
    vectorised densify (the per-block and per-event walks it replaced).

``control-plane-purity``
    ``ControlEvent.mutate()`` only from ``StateCoordinator.apply``, and
    every ControlEvent subclass a frozen dataclass.  Guards: the bit-exact
    control-log replay.

``jit-cache-hygiene``
    Cached builders of compiled artifacts (``lru_cache`` or a module-level
    dict cache around ``build.load`` / ``build.build`` / ``ctypes.CDLL`` /
    ``torch.compile`` / a CUDA graph) take only annotated, hashable keys;
    no ``*args``, no tensor annotations, no unhashable literals at call
    sites.  Guards: one library load / compile / capture per key, not per
    chunk.

``kernel-ref-parity``
    Every public ``kernels/*.py`` function that launches through a
    ``build.load(...)`` ctypes entry has a plain twin in ``kernels/ref.py``
    (``flash_attention`` -> ``attention_ref``; ``*_shard`` / ``*_chunk`` /
    ``*_blocks`` -> the base kernel's) and a ``tests/test_torch_*.py``
    naming both.  Guards: each hand-written kernel held against its plain
    version.

The cross-module rules ride the whole-program model in
:mod:`repro_torch.analysis.project` (import-aware symbol resolution, an
approximate call graph, hot-path reachability and the async-copy map,
built ONCE per run):

``arena-reuse-in-flight`` [``donated-buffer-reuse``]
    No write to a host arena after it was handed to an asynchronous copy
    (``ops.dmm_apply_dense`` / ``dmm_apply_packed`` / ``dmm_apply_blocks``,
    the ``*_chunk`` C entries, the per-block launcher) until it is taken
    again.  Guards: the C entries' ``cudaMemcpyAsync`` from a pinned arena
    -- synchronous on the CPU, so a reuse passes every CPU test and races
    on the card.

``single-writer-control``
    Only ``StateCoordinator.apply`` (resolved through wrappers) appends to
    ``control_log`` or writes coordinator state; in
    ``repro_torch.etl.replication`` / ``transport`` only ``LeaderNode``
    calls ``coordinator.apply``.  Guards: one writer of the replicated log.

``epoch-pin-escape``
    Every ``DenseChunk`` / ``ColumnarDense`` / ``BlockDense`` carries its
    ``plan=`` pin, and no ``.plan`` / ``.epoch`` is read through a chunk
    across a coordinator mutation.  Guards: in-flight chunks drain on the
    plan they were densified against.

``transfer-accounting``
    No host->device conversion (``.to(device)``, ``.cuda()``,
    ``torch.as_tensor(..., device=)``, ``.copy_`` from host) on the
    per-chunk path of ``repro_torch.etl``: its copies are the ones the C
    entries report into ``stats["transfers"]``.  Guards: the transfer
    counts the roofline and the chip checks price chunks by.

``plan-publish-single-site``
    Only ``repro_torch.etl.plan`` (the PlanManager) and
    ``repro_torch.core.dmm_torch`` (the lowering layer) build fused plans
    or cut ``PlanPublished``.  Guards: every plan is a managed epoch.

``bad-waiver`` / ``unused-waiver``
    The waiver machinery audits itself.

Waivers: append ``# metl-torch: allow[rule-id] reason`` to the offending
line (or the line above as a standalone comment; on a ``def`` line it
covers the whole function).  The reason is mandatory.  The reference's
``# metl: allow[...]`` marker is a different marker: this analyzer never
reads it and the reference's never reads this one, so the two analyzers
can run over the same files.
"""

from .core import (  # noqa: F401
    Finding,
    FileCtx,
    Report,
    Rule,
    RULES,
    Waiver,
    analyze,
    collect_files,
    register,
)
from .project import Project, as_project  # noqa: F401

__all__ = [
    "Finding",
    "FileCtx",
    "Project",
    "Report",
    "Rule",
    "RULES",
    "Waiver",
    "analyze",
    "as_project",
    "collect_files",
    "register",
]
