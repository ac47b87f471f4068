"""(Port copy of ``repro.core.registry``: the same code, kept here so that
``repro_torch`` imports nothing of the reference package.)

Schema registry: the metadata side of the METL mapping system.

The paper models the mapping system as a *distributed dynamic network* whose
two sub-graphs are trees:

  - the extraction-schema tree ``iD`` (domain):   d -> schema o -> version v -> attribute a_p
  - the CDM tree              ``iR`` (range):     r -> business-entity r -> version w -> attribute c_q

Every attribute is a leaf.  Versions duplicate attributes: when schema ``o``
goes from version ``v`` to ``v+1``, unchanged attributes are *re-issued* with
new ids but an explicit equivalence link ``a_p' == a_p`` (paper Fig. 3/6, the
``==`` columns).  These equivalence links are the basis of the automated
update algorithm (paper SS5.4.1).

This module is the in-process stand-in for the Apicurio registry in the
paper's pipeline.  It owns the system state ``i`` (paper SS3.4): every
component (messages, matrix, METL app) inherits the state and must present
the same ``i`` to interoperate.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Attribute",
    "SchemaVersion",
    "SchemaTree",
    "Registry",
    "StaleStateError",
]


class StaleStateError(RuntimeError):
    """A component presented a state ``i`` that differs from the registry's.

    Paper SS3.4: "we are thus checking at several points if the METL app is in
    sync with the other components of the pipeline ... and throw an error if
    this is not the case."
    """


@dataclass(frozen=True)
class Attribute:
    """A leaf of one of the two schema trees.

    ``uid``    -- globally unique attribute id (matrix row/col identity).
    ``name``   -- human label, e.g. ``"time"`` or ``"Time of the payment"``.
    ``equiv``  -- uid of the equivalent attribute in the *previous* version of
                  the same schema (``a_p' == a_p``), or ``None`` if the
                  attribute is new in this version.
    """

    uid: int
    name: str
    equiv: Optional[int] = None


@dataclass
class SchemaVersion:
    """A versioned block of attributes: ``iD_v^o`` or ``iR_w^r``."""

    schema_id: int
    version: int
    attributes: List[Attribute]

    @property
    def uids(self) -> List[int]:
        return [a.uid for a in self.attributes]

    def attr_by_uid(self, uid: int) -> Attribute:
        for a in self.attributes:
            if a.uid == uid:
                return a
        raise KeyError(uid)


class SchemaTree:
    """One of the two sub-graphs of the dynamic network (domain or range).

    Maintains insertion order of (schema, version) pairs -- the matrix block
    layout is derived from this order.
    """

    def __init__(self, root: str) -> None:
        self.root = root
        # {schema_id: {version: SchemaVersion}} with ordered dicts throughout.
        self._schemas: Dict[int, Dict[int, SchemaVersion]] = {}
        # lazily-built uid -> equiv index; rebuilt only after a version
        # add/delete (equivalence_root is called per attribute inside the
        # automated-update and scenario-build loops, so rebuilding it per
        # call made those quadratic in total attributes)
        self._equiv_cache: Optional[Dict[int, Optional[int]]] = None

    # -- construction -------------------------------------------------------
    def add_version(self, sv: SchemaVersion) -> None:
        versions = self._schemas.setdefault(sv.schema_id, {})
        if sv.version in versions:
            raise ValueError(
                f"{self.root}: schema {sv.schema_id} already has version {sv.version}"
            )
        if versions and sv.version <= max(versions):
            raise ValueError(
                f"{self.root}: versions must be added in ascending order "
                f"(schema {sv.schema_id}: have {sorted(versions)}, got {sv.version})"
            )
        versions[sv.version] = sv
        self._equiv_cache = None

    def delete_version(self, schema_id: int, version: int) -> SchemaVersion:
        sv = self._schemas[schema_id].pop(version)
        if not self._schemas[schema_id]:
            del self._schemas[schema_id]
        self._equiv_cache = None
        return sv

    # -- lookup -------------------------------------------------------------
    def schema_ids(self) -> List[int]:
        return list(self._schemas)

    def versions(self, schema_id: int) -> List[int]:
        return sorted(self._schemas.get(schema_id, ()))

    def get(self, schema_id: int, version: int) -> SchemaVersion:
        return self._schemas[schema_id][version]

    def has(self, schema_id: int, version: int) -> bool:
        return schema_id in self._schemas and version in self._schemas[schema_id]

    def blocks(self) -> List[SchemaVersion]:
        """All versioned attribute blocks in canonical (schema, version) order."""
        out: List[SchemaVersion] = []
        for o in self._schemas:
            for v in sorted(self._schemas[o]):
                out.append(self._schemas[o][v])
        return out

    def all_attributes(self) -> List[Attribute]:
        """The flattened attribute set  iA  (or iC) in matrix axis order."""
        return [a for sv in self.blocks() for a in sv.attributes]

    def latest_version(self, schema_id: int) -> int:
        return max(self._schemas[schema_id])

    # -- equivalences (paper SS5.4.1) ----------------------------------------
    def equivalence_root(self, uid: int) -> int:
        """Follow ``equiv`` links to the oldest equivalent attribute.

        Used to decide whether two attributes in different versions denote the
        same underlying column ("generalisation of the attributes per schema
        across versions").
        """
        chain = self._equiv_index()
        seen = set()
        while uid in chain and chain[uid] is not None:
            if uid in seen:  # defensive: cycles are construction bugs
                raise ValueError(f"equivalence cycle at uid {uid}")
            seen.add(uid)
            uid = chain[uid]  # type: ignore[assignment]
        return uid

    def _equiv_index(self) -> Dict[int, Optional[int]]:
        if self._equiv_cache is None:
            self._equiv_cache = {
                a.uid: a.equiv for sv in self.blocks() for a in sv.attributes
            }
        return self._equiv_cache

    def equivalent_in(
        self, uid: int, schema_id: int, version: int
    ) -> Optional[Attribute]:
        """Find the attribute in (schema_id, version) equivalent to ``uid``."""
        root = self.equivalence_root(uid)
        if not self.has(schema_id, version):
            return None
        for a in self.get(schema_id, version).attributes:
            if self.equivalence_root(a.uid) == root:
                return a
        return None


class Registry:
    """The two trees + the monotone system state ``i``.

    Mutations bump ``state``; consumers carrying an older state get a
    :class:`StaleStateError` from :meth:`check_state`.
    """

    def __init__(self) -> None:
        self.domain = SchemaTree("d")  # extraction schemata  iD
        self.range = SchemaTree("r")  # CDM business entities iR
        self.state: int = 0
        # next uid to issue; a plain int (not itertools.count) so snapshots
        # can serialize the counter and a restored replica keeps issuing the
        # exact uid sequence the original would have (replay bit-exactness).
        self._next_uid: int = 1

    # -- state protocol ------------------------------------------------------
    def check_state(self, i: int) -> None:
        if i != self.state:
            raise StaleStateError(
                f"component state {i} != registry state {self.state}; "
                "component must refresh before mapping"
            )

    def bump_state(self) -> int:
        """Advance the system state ``i`` without a tree mutation.

        The public transition for matrix-level edits (a manual DPM upload
        changes what every instance maps, so consumers must re-sync even
        though neither tree moved) and for test harnesses that need to
        leave a component behind on purpose.  Tree mutations (``evolve`` /
        ``add_schema`` / ``delete_version``) bump implicitly.
        """
        self.state += 1
        return self.state

    def _bump(self) -> int:
        return self.bump_state()

    # -- attribute fabrication ----------------------------------------------
    def new_attribute(self, name: str, equiv: Optional[int] = None) -> Attribute:
        uid = self._next_uid
        self._next_uid += 1
        return Attribute(uid=uid, name=name, equiv=equiv)

    def evolve(
        self,
        tree: SchemaTree,
        schema_id: int,
        *,
        keep: Sequence[str] = (),
        add: Sequence[str] = (),
    ) -> SchemaVersion:
        """Create version v+1 of ``schema_id`` keeping ``keep`` names (with
        equivalence links) and adding fresh attributes ``add``.

        This reproduces the paper's versioning pattern: "if we have a version
        1 with attributes a1 and a2 and we add a3, then version 2 consists of
        a4==a1, a5==a2 and a3" -- note every kept attribute gets a NEW uid
        plus an equiv link, matching Fig. 6.
        """
        v = tree.latest_version(schema_id)
        prev = tree.get(schema_id, v)
        attrs: List[Attribute] = []
        prev_by_name = {a.name: a for a in prev.attributes}
        for name in keep:
            if name not in prev_by_name:
                raise KeyError(f"attribute {name!r} not in v{v} of schema {schema_id}")
            attrs.append(self.new_attribute(name, equiv=prev_by_name[name].uid))
        for name in add:
            attrs.append(self.new_attribute(name))
        sv = SchemaVersion(schema_id=schema_id, version=v + 1, attributes=attrs)
        tree.add_version(sv)
        self.bump_state()
        return sv

    def add_schema(
        self, tree: SchemaTree, schema_id: int, names: Sequence[str], version: int = 1
    ) -> SchemaVersion:
        sv = SchemaVersion(
            schema_id=schema_id,
            version=version,
            attributes=[self.new_attribute(n) for n in names],
        )
        tree.add_version(sv)
        self.bump_state()
        return sv

    def delete_version(self, tree: SchemaTree, schema_id: int, version: int) -> None:
        tree.delete_version(schema_id, version)
        self.bump_state()

    # -- snapshots (replication seed / follower catch-up) ---------------------
    def to_dict(self) -> Dict[str, Any]:
        """Serialize the full registry to plain JSON-able data.

        Both trees are emitted in :meth:`SchemaTree.blocks` order, which is a
        pure function of tree structure, so :meth:`from_dict` reconstructs an
        identical structure *and* identical matrix block layout.  ``state``
        and ``next_uid`` ride along so a restored replica resumes the exact
        state/uid sequence — required for bit-exact ``control_log`` replay
        on top of the snapshot.
        """

        def tree(t: SchemaTree) -> List[Dict[str, Any]]:
            return [
                {
                    "schema_id": sv.schema_id,
                    "version": sv.version,
                    "attributes": [[a.uid, a.name, a.equiv] for a in sv.attributes],
                }
                for sv in t.blocks()
            ]

        return {
            "state": self.state,
            "next_uid": self._next_uid,
            "domain": tree(self.domain),
            "range": tree(self.range),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Registry":
        """Rebuild a registry from :meth:`to_dict` output (exact round-trip)."""
        reg = cls()
        for tree, blocks in ((reg.domain, d["domain"]), (reg.range, d["range"])):
            for b in blocks:
                tree.add_version(
                    SchemaVersion(
                        schema_id=b["schema_id"],
                        version=b["version"],
                        attributes=[
                            Attribute(uid=u, name=n, equiv=e)
                            for u, n, e in b["attributes"]
                        ],
                    )
                )
        reg.state = d["state"]
        reg._next_uid = d["next_uid"]
        return reg

    # -- matrix axis layout ---------------------------------------------------
    def row_axis(self) -> List[int]:
        """uids of all CDM attributes iC in matrix row order (q axis)."""
        return [a.uid for a in self.range.all_attributes()]

    def col_axis(self) -> List[int]:
        """uids of all extraction attributes iA in matrix column order (p axis)."""
        return [a.uid for a in self.domain.all_attributes()]

    def block_layout(
        self,
    ) -> Tuple[Dict[Tuple[int, int], Tuple[int, int]], Dict[Tuple[int, int], Tuple[int, int]]]:
        """Row/col extents of every (schema, version) block.

        Returns ({(r, w): (row_start, row_stop)}, {(o, v): (col_start, col_stop)}).
        """
        rows: Dict[Tuple[int, int], Tuple[int, int]] = {}
        cols: Dict[Tuple[int, int], Tuple[int, int]] = {}
        q = 0
        for sv in self.range.blocks():
            rows[(sv.schema_id, sv.version)] = (q, q + len(sv.attributes))
            q += len(sv.attributes)
        p = 0
        for sv in self.domain.blocks():
            cols[(sv.schema_id, sv.version)] = (p, p + len(sv.attributes))
            p += len(sv.attributes)
        return rows, cols
