"""(Port copy of ``repro.core.search``: the same code, kept here so that
``repro_torch`` imports nothing of the reference package.)

Mapping-inspection queries (paper §6.3, the User Interface features).

The paper's data owners asked for two searches, both served from the DMM's
set structure without decompacting the matrix:

  * **reverse search** -- "which im' different Kafka messages with extracting
    schema versions are mapping to one Kafka message with one business
    entity version" -- served from the row super-set ``iDRPM``;
  * **version progression** -- "how the version progression is functioning"
    for one extracting schema across its versions -- served from the column
    super-sets, with per-version diffs computed over attribute-equivalence
    roots (so a renamed copy of the same attribute is *not* a change).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from .dmm import DPM, BlockKey
from .registry import Registry

__all__ = [
    "reverse_search",
    "version_progression",
    "MappingProvenance",
    "VersionDiff",
]


@dataclasses.dataclass(frozen=True)
class MappingProvenance:
    """One source feeding a business-entity version."""

    schema_id: int
    version: int
    # cdm attribute uid -> (extraction attribute uid, extraction attr name)
    bindings: Tuple[Tuple[int, Tuple[int, str]], ...]

    def attrs(self) -> Dict[int, Tuple[int, str]]:
        return dict(self.bindings)


def reverse_search(dpm: DPM, registry: Registry, r: int, w: int) -> List[MappingProvenance]:
    """All (schema, version) sources that map into business entity (r, w),
    with per-attribute provenance.  Uses the row super-set iDRPM: the DPM
    filtered by (r, w)."""
    out: List[MappingProvenance] = []
    name_of = {a.uid: a.name for sv in registry.domain.blocks() for a in sv.attributes}
    for (o, v, rr, ww), elements in sorted(dpm.items()):
        if (rr, ww) != (r, w) or not elements:
            continue
        bindings = tuple(
            sorted((q, (p, name_of.get(p, "?"))) for q, p in elements)
        )
        out.append(MappingProvenance(schema_id=o, version=v, bindings=bindings))
    return out


@dataclasses.dataclass(frozen=True)
class VersionDiff:
    """Mapping change between consecutive versions of one extracting schema,
    in equivalence-root space (renamed copies are not changes)."""

    schema_id: int
    from_version: int
    to_version: int
    added: FrozenSet[Tuple[int, int]]  # (cdm uid, extraction root uid)
    removed: FrozenSet[Tuple[int, int]]

    @property
    def is_stable(self) -> bool:
        return not (self.added or self.removed)


def _root_pairs(
    dpm: DPM, registry: Registry, o: int, v: int
) -> Set[Tuple[int, int]]:
    pairs: Set[Tuple[int, int]] = set()
    dom = registry.domain
    for (oo, vv, r, w), elements in dpm.items():
        if (oo, vv) != (o, v):
            continue
        for q, p in elements:
            pairs.add((q, dom.equivalence_root(p)))
    return pairs


def version_progression(
    dpm: DPM, registry: Registry, o: int
) -> List[VersionDiff]:
    """Per-version mapping diffs for one extracting schema.

    A healthy progression (paper §5.4.1: values copied along equivalences)
    shows mostly-stable diffs; a shrinking permutation matrix appears as
    ``removed`` entries -- exactly what the UI flags for user review."""
    versions = registry.domain.versions(o)
    out: List[VersionDiff] = []
    for a, b in zip(versions, versions[1:]):
        pa = _root_pairs(dpm, registry, o, a)
        pb = _root_pairs(dpm, registry, o, b)
        out.append(
            VersionDiff(
                schema_id=o,
                from_version=a,
                to_version=b,
                added=frozenset(pb - pa),
                removed=frozenset(pa - pb),
            )
        )
    return out
