"""(Port copy of ``repro.core.dmm``: the same code, kept here so that
``repro_torch`` imports nothing of the reference package.)

The Dynamic Mapping Matrix (DMM) -- paper-faithful Algorithms 1-6.

This module is the *reference* implementation of the paper's contribution,
kept at the same abstraction level as the paper (schema attributes, Kafka
messages, sets of mapping elements).  It is deliberately numpy/pure-Python:
the tensorised, device-resident form lives in :mod:`repro_torch.core.dmm_torch`, and
property tests assert the two agree.

Vocabulary (paper SS4.4):

  ``iM``      the m x n sparse 0/1 mapping matrix, m = |iC|, n = |iA|
  ``MB``      mapping block: sub-matrix for one (schema o, version v) x
              (business entity r, version w)
  ``PM``      largest permutation sub-matrix of an MB
  ``NB``      1x1 null block
  ``DPM``     dense set of 1-elements of a PM
  ``iDPM``    super-set of all DPM blocks          (balanced strategy, Alg. 2)
  ``iDUSB``   super-set of unique square blocks    (aggressive strategy, Alg. 3)

All indices are attribute *uids* (stable across matrix re-layout), not
positions: positions change whenever a version is added or deleted, uids
never do.  The matrix form is materialised on demand from the registry's
axis layout.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from .registry import Registry, SchemaVersion, StaleStateError

__all__ = [
    "Message",
    "MappingMatrix",
    "BlockKey",
    "DPM",
    "DUSB",
    "OneToOneViolation",
    "map_message_sparse",
    "transform_to_dpm",
    "transform_to_dusb",
    "decompact_dpm",
    "decompact_dusb",
    "auto_update_dpm",
    "UpdateReport",
    "map_message_dense",
    "compaction_ratio",
]

# (schema o, version v, business-entity r, version w)
BlockKey = Tuple[int, int, int, int]
# A mapping element im_qp identified by attribute uids (q_uid, p_uid).
Element = Tuple[int, int]
# A dense block: only the 1-elements survive.  Empty frozenset == dense null
# block (the DNB of SS5.3.2, realised "with the help of a hierarchical object
# structure ... a block without mapping elements is a special null block").
DenseBlock = FrozenSet[Element]

DPM = Dict[BlockKey, DenseBlock]
# Per version-super-block (o, r, w): ascending-version list of unique square
# blocks.  Empty frozenset entries are stored dense null blocks.
DUSB = Dict[Tuple[int, int, int], List[Tuple[int, DenseBlock]]]


class OneToOneViolation(ValueError):
    """A mapping block violates the paper's 1:1 attribute-mapping constraint
    (SS4.5: "we restrain the blocks to 1:1 attribute mappings")."""


# ---------------------------------------------------------------------------
# Messages
# ---------------------------------------------------------------------------


@dataclass
class Message:
    """A schematized Kafka-message stand-in.

    ``payload`` maps attribute uid -> data object; ``None`` is the explicit
    "null" object.  A *sparse* message carries every attribute of its schema
    version (possibly None); a *dense* message carries only non-null ones
    (SS5.5: "only attributes with data objects that are not null are present
    in any dense Kafka-message").
    """

    state: int
    schema_id: int
    version: int
    payload: Dict[int, Optional[object]]

    def densify(self) -> "Message":
        return Message(
            state=self.state,
            schema_id=self.schema_id,
            version=self.version,
            payload={k: v for k, v in self.payload.items() if v is not None},
        )

    @property
    def is_empty(self) -> bool:
        return all(v is None for v in self.payload.values())


# ---------------------------------------------------------------------------
# The full sparse matrix iM
# ---------------------------------------------------------------------------


class MappingMatrix:
    """The sparse 0/1 matrix ``iM`` materialised against a registry layout.

    Used by the *baseline* system (SS4) and as the decompaction target of the
    optimized system (SS5.3.3).  Real deployments never hold this beyond
    updates -- that is the point of the paper.
    """

    def __init__(self, registry: Registry, dense: Optional[np.ndarray] = None) -> None:
        self.registry = registry
        self.state = registry.state
        self.row_uids = registry.row_axis()  # q axis (CDM attributes iC)
        self.col_uids = registry.col_axis()  # p axis (extraction attributes iA)
        self.row_pos = {u: k for k, u in enumerate(self.row_uids)}
        self.col_pos = {u: k for k, u in enumerate(self.col_uids)}
        self.rows_by_block, self.cols_by_block = registry.block_layout()
        if dense is None:
            dense = np.zeros((len(self.row_uids), len(self.col_uids)), dtype=np.int8)
        assert dense.shape == (len(self.row_uids), len(self.col_uids))
        self.M = dense

    # -- element access by uid ------------------------------------------------
    def set(self, q_uid: int, p_uid: int, value: int) -> None:
        self.M[self.row_pos[q_uid], self.col_pos[p_uid]] = value

    def get(self, q_uid: int, p_uid: int) -> int:
        return int(self.M[self.row_pos[q_uid], self.col_pos[p_uid]])

    # -- block access -----------------------------------------------------------
    def block_keys(self) -> List[BlockKey]:
        return [
            (o, v, r, w)
            for (o, v) in self.cols_by_block
            for (r, w) in self.rows_by_block
        ]

    def block(self, key: BlockKey) -> np.ndarray:
        o, v, r, w = key
        r0, r1 = self.rows_by_block[(r, w)]
        c0, c1 = self.cols_by_block[(o, v)]
        return self.M[r0:r1, c0:c1]

    def block_elements(self, key: BlockKey) -> DenseBlock:
        """1-elements of a block as (q_uid, p_uid) pairs."""
        o, v, r, w = key
        r0, _ = self.rows_by_block[(r, w)]
        c0, _ = self.cols_by_block[(o, v)]
        qs, ps = np.nonzero(self.block(key))
        return frozenset(
            (self.row_uids[r0 + int(q)], self.col_uids[c0 + int(p)])
            for q, p in zip(qs, ps)
        )

    def validate_one_to_one(self) -> None:
        """Enforce the 1:1 block constraint: within every mapping block each
        row and each column carries at most one 1.  This is the invariant
        that guarantees a largest permutation sub-matrix exists (SS5.3.1)."""
        for key in self.block_keys():
            b = self.block(key)
            if b.size == 0:
                continue
            if (b.sum(axis=0) > 1).any() or (b.sum(axis=1) > 1).any():
                raise OneToOneViolation(f"block {key} is not a 1:1 mapping")

    def column_super_block(self, o: int, v: int) -> List[BlockKey]:
        """iCMB_v^o -- all blocks in the column of one extraction version."""
        return [(o, v, r, w) for (r, w) in self.rows_by_block]

    def nnz(self) -> int:
        return int(self.M.sum())


# ---------------------------------------------------------------------------
# Algorithm 1: sparse, sequential baseline mapping
# ---------------------------------------------------------------------------


def map_message_sparse(matrix: MappingMatrix, msg: Message) -> List[Message]:
    """Paper Algorithm 1: map one sparse ``iMIn_v^o`` to im' sparse
    ``iMOut_w^r`` -- one per CDM version block, pre-filled with nulls.

    The mapping function is ``ncd_q <- m_qp * nad_p`` (SS4.2); the data object
    rides along when the product is 1.
    """
    matrix.registry.check_state(msg.state)
    if matrix.state != msg.state:
        raise StaleStateError(
            f"matrix state {matrix.state} != message state {msg.state}"
        )
    reg = matrix.registry
    outs: List[Message] = []
    # "get iCMB_v^o from iMB that matches the indices of the incoming message"
    for key in matrix.column_super_block(msg.schema_id, msg.version):
        o, v, r, w = key
        cdm_block: SchemaVersion = reg.range.get(r, w)
        # create message with pairs of all CDM attributes and "null" objects
        out = Message(
            state=msg.state,
            schema_id=r,
            version=w,
            payload={c.uid: None for c in cdm_block.attributes},
        )
        # single-element partition of the block; only m_qp != 0 participate
        for q_uid, p_uid in matrix.block_elements(key):
            ad_p = msg.payload.get(p_uid)
            nad_p = 0 if ad_p is None else 1
            ncd_q = 1 * nad_p  # m_qp is 1 for every surviving element
            if ncd_q == 1:
                out.payload[q_uid] = ad_p  # replace the "null" object
        outs.append(out)
    return outs


# ---------------------------------------------------------------------------
# Algorithm 2: balanced compaction  iM -> iDPM
# ---------------------------------------------------------------------------


def _largest_permutation_matrix(matrix: MappingMatrix, key: BlockKey) -> DenseBlock:
    """Largest permutation sub-matrix of a 1:1 block == its 1-elements.

    Because each row/col holds at most one 1, deleting all-zero rows and
    columns leaves a k x k permutation matrix whose 1-coordinates are exactly
    the block's 1-elements.  (The equivalence highlighted in SS5.3.1.)
    """
    return matrix.block_elements(key)


def transform_to_dpm(matrix: MappingMatrix, *, validate: bool = True) -> DPM:
    """Paper Algorithm 2: partition iM into blocks, drop null blocks, shrink
    to largest permutation matrices, keep only 1-elements."""
    if validate:
        matrix.validate_one_to_one()
    dpm: DPM = {}
    for key in matrix.block_keys():
        elements = _largest_permutation_matrix(matrix, key)
        if elements:  # "for all MB != 0"
            dpm[key] = elements
    return dpm


def decompact_dpm(dpm: DPM, registry: Registry) -> MappingMatrix:
    """SS5.3.3: create an m x n null matrix and write back the stored 1s."""
    matrix = MappingMatrix(registry)
    for elements in dpm.values():
        for q_uid, p_uid in elements:
            matrix.set(q_uid, p_uid, 1)
    return matrix


# ---------------------------------------------------------------------------
# Algorithm 3: aggressive compaction  iM -> iDUSB
# ---------------------------------------------------------------------------


def _canonical_pattern(
    elements: DenseBlock, registry: Registry
) -> FrozenSet[Tuple[int, int]]:
    """Version-invariant fingerprint of a square block.

    Columns are generalised across versions by following equivalence links to
    their root uid (SS5.4.1) -- two blocks of adjacent versions are "equivalent"
    iff they map the same CDM attributes from equivalent extraction attributes.
    """
    dom = registry.domain
    return frozenset((q, dom.equivalence_root(p)) for q, p in elements)


def transform_to_dusb(matrix: MappingMatrix, *, validate: bool = True) -> DUSB:
    """Paper Algorithm 3: per version-super-block (one schema o x one CDM
    version (r, w)), walk versions ascending and keep only *unique* square
    blocks: permutation matrices that differ from the previously kept one,
    plus 1x1 null blocks that terminate a PM run (never in the lowest
    position -- the "non-saved special null block")."""
    if validate:
        matrix.validate_one_to_one()
    reg = matrix.registry
    dusb: DUSB = {}
    for o in reg.domain.schema_ids():
        versions = reg.domain.versions(o)
        for (r, w) in matrix.rows_by_block:
            vusb: List[Tuple[int, DenseBlock]] = []
            last_pattern: Optional[FrozenSet] = None
            for v in versions:  # "in ascending v"
                elements = matrix.block_elements((o, v, r, w))
                if elements:
                    pattern = _canonical_pattern(elements, reg)
                    if not vusb or last_pattern != pattern:
                        vusb.append((v, elements))
                        last_pattern = pattern
                else:
                    # NB: only stored when it terminates a PM run; a leading
                    # NB (lowest version) is the non-saved special null block.
                    if vusb and last_pattern is not None and len(vusb[-1][1]) > 0:
                        vusb.append((v, frozenset()))
                        last_pattern = frozenset()
            if vusb:
                dusb[(o, r, w)] = vusb
    # drop version-super-blocks that ended up all-null (defensive; the loop
    # above never stores a lone NB, so this is a no-op kept for clarity)
    return {k: v for k, v in dusb.items() if any(len(b) for _, b in v)}


def decompact_dusb(dusb: DUSB, registry: Registry) -> MappingMatrix:
    """Paper Algorithm 4: rebuild iM by replaying each stored unique block
    across the ascending version run until the next stored block (or the
    highest version in the super-block)."""
    matrix = MappingMatrix(registry)
    dom = registry.domain
    for (o, r, w), vusb in dusb.items():
        versions = dom.versions(o)
        for idx, (v, elements) in enumerate(vusb):
            if idx + 1 < len(vusb):
                v2 = vusb[idx + 1][0]
            else:
                v2 = versions[-1] + 1  # replay through the highest version
            for u in versions:
                if not (v <= u < v2):
                    continue
                for q_uid, p_uid in elements:
                    # translate the element's column to version u via the
                    # attribute equivalences (identity when u == v)
                    a_u = dom.equivalent_in(p_uid, o, u)
                    if a_u is not None:
                        matrix.set(q_uid, a_u.uid, 1)
    return matrix


# ---------------------------------------------------------------------------
# Algorithm 5: automated DPM updates
# ---------------------------------------------------------------------------


@dataclass
class UpdateReport:
    """What the system "informs the user" about after an automated update."""

    new_blocks: List[BlockKey] = field(default_factory=list)
    shrunk_blocks: List[BlockKey] = field(default_factory=list)  # smaller PM
    null_blocks: List[BlockKey] = field(default_factory=list)  # no value copied
    deleted_blocks: List[BlockKey] = field(default_factory=list)

    @property
    def needs_user_review(self) -> bool:
        return bool(self.shrunk_blocks or self.null_blocks)


def _copy_block_to_version(
    elements: DenseBlock, registry: Registry, o: int, v_new: int
) -> DenseBlock:
    """Copy known values across attribute equivalences (SS5.4.1)."""
    out: Set[Element] = set()
    for q_uid, p_uid in elements:
        a_new = registry.domain.equivalent_in(p_uid, o, v_new)
        if a_new is not None:
            out.add((q_uid, a_new.uid))
    return frozenset(out)


def _copy_block_to_cdm_version(
    elements: DenseBlock, registry: Registry, r: int, w_new: int
) -> DenseBlock:
    out: Set[Element] = set()
    for q_uid, p_uid in elements:
        c_new = registry.range.equivalent_in(q_uid, r, w_new)
        if c_new is not None:
            out.add((c_new.uid, p_uid))
    return frozenset(out)


def auto_update_dpm(
    dpm: DPM,
    registry: Registry,
    change: Tuple[str, int, int],
) -> Tuple[DPM, UpdateReport]:
    """Paper Algorithm 5: transition iDPM -> i+1DPM for one of the four
    triggers.  ``change`` is (kind, schema_id, version) with kind one of
    ``deleted_domain | deleted_range | added_domain | added_range``.

    The registry must already reflect the change (it is the source of the
    trigger); the DPM is brought up to the registry's state.
    """
    kind, sid, ver = change
    report = UpdateReport()
    new: DPM = dict(dpm)

    if kind == "deleted_domain":  # case (1): deleted iD_v^o
        for key in list(new):
            if key[0] == sid and key[1] == ver:
                del new[key]
                report.deleted_blocks.append(key)

    elif kind == "deleted_range":  # case (2): deleted iR_w^r
        for key in list(new):
            if key[2] == sid and key[3] == ver:
                del new[key]
                report.deleted_blocks.append(key)

    elif kind == "added_domain":  # case (3): added i+1D_{v+1}^o
        prev_v = ver - 1
        # iterate the column super-set of the previous version
        for key in list(dpm):
            o, v, r, w = key
            if o != sid or v != prev_v:
                continue
            copied = _copy_block_to_version(dpm[key], registry, sid, ver)
            new_key = (sid, ver, r, w)
            if copied:
                new[new_key] = copied
                report.new_blocks.append(new_key)
                if len(copied) < len(dpm[key]):
                    # "we may create new smaller permutation matrices ...
                    # finally, we inform the user"
                    report.shrunk_blocks.append(new_key)
            else:
                report.null_blocks.append(new_key)

    elif kind == "added_range":  # case (4): added i+1R_{w+1}^r
        prev_w = ver - 1
        for key in list(dpm):
            o, v, r, w = key
            if r != sid or w != prev_w:
                continue
            copied = _copy_block_to_cdm_version(dpm[key], registry, sid, ver)
            new_key = (o, v, sid, ver)
            if copied:
                new[new_key] = copied
                report.new_blocks.append(new_key)
                if len(copied) < len(dpm[key]):
                    report.shrunk_blocks.append(new_key)
            else:
                report.null_blocks.append(new_key)
        # clean-up business rule (SS5.1/SS5.4.3): only one live CDM version --
        # delete the previous version's row blocks
        for key in list(new):
            if key[2] == sid and key[3] == prev_w:
                del new[key]
                report.deleted_blocks.append(key)

    else:
        raise ValueError(f"unknown change kind {kind!r}")

    return new, report


# ---------------------------------------------------------------------------
# Algorithm 6: parallel, dense mapping with iDPM
# ---------------------------------------------------------------------------


def map_message_dense(
    dpm: DPM, registry: Registry, msg: Message, *, state: Optional[int] = None
) -> List[Message]:
    """Paper Algorithm 6 (sequential semantics; the tensor/SPMD realisation
    is :mod:`repro_torch.core.dmm_torch`).

    Dense in, dense out: the mapping function degenerates to a set lookup --
    if index p of an incoming non-null object appears in the block's dense
    set, then m_qp = 1 and nad_p = 1, so the product is 1 and we emit
    ``(c_q, ad_p)``.  Messages with empty payloads are not sent.
    """
    registry.check_state(state if state is not None else msg.state)
    outs: List[Message] = []
    # iDCPM_v^o: the column super-set for the message's (o, v)
    for (o, v, r, w), elements in dpm.items():
        if o != msg.schema_id or v != msg.version:
            continue
        payload: Dict[int, Optional[object]] = {}
        for q_uid, p_uid in elements:  # independent => parallel on device
            if p_uid in msg.payload and msg.payload[p_uid] is not None:
                payload[q_uid] = msg.payload[p_uid]
        if payload:  # "if payload not empty then send"
            outs.append(Message(state=msg.state, schema_id=r, version=w, payload=payload))
    return outs


# ---------------------------------------------------------------------------
# Compaction accounting (paper: ">99%" / ">99.9%")
# ---------------------------------------------------------------------------


def compaction_ratio(matrix: MappingMatrix, stored_elements: int) -> float:
    """Fraction of the full matrix representation eliminated."""
    total = matrix.M.size
    if total == 0:
        return 0.0
    return 1.0 - stored_elements / total


def dpm_size(dpm: DPM) -> int:
    return sum(len(v) for v in dpm.values())


def dusb_size(dusb: DUSB) -> int:
    # each stored block costs its elements plus one index record; dense null
    # blocks cost the index record only -- count 1 for it
    return sum(max(1, len(b)) for seq in dusb.values() for _, b in seq)
