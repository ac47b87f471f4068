"""The traffic's CDC side, made by the benchmark: the paper's scenario (a
registry of versioned extraction schemas and CDM entities, and the
ground-truth mapping of their attributes) and its CDC event stream, both
from the traffic file's parameters and the seed.

The generators are a copy of the port's ``core.synthetic.build_scenario``
and ``etl.events.EventSource`` (themselves copies of the JAX package's),
so that no change to the program changes the inputs.  The scenario is
written down here as names (an attribute keeps its name across versions,
so a name is its equivalence root); the program gets it through its
public registry API (``Registry.add_schema``, ``evolve``,
``MappingMatrix.set``) and its events as ``CDCEvent`` lists through
``slice_columnar``; the plain reference gets the same scenario and events
as plain lookups and columns.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Scenario:
    """The registry and mapping as the benchmark made them, and the
    program's objects built from them."""

    entities: Dict[int, List[str]]  # r -> its attribute names (one version, 1)
    schemas: Dict[int, List[List[str]]]  # o -> its versions' attribute names (1, 2, ...)
    slot: Dict[Tuple[int, str], int]  # (o, name) -> position in entity o mod n, or -1
    uids: Dict[Tuple[int, int], List[int]]  # (o, v) -> its attributes' uids, in order
    state: int  # the registry's state once built
    registry: Any  # the program's Registry
    dpm: Any  # the program's DPM of the ground-truth matrix


def scenario(params: Dict[str, Any]) -> Scenario:
    """The scenario of ``params`` (``n_schemas``, ``versions_per_schema``,
    ``attrs_per_version``, ``n_entities``, ``cdm_attrs``, ``seed``; the drop,
    add and density rates at their defaults unless given)."""
    from repro_torch.core.dmm import MappingMatrix, transform_to_dpm
    from repro_torch.core.registry import Registry

    p = {"p_drop": 0.15, "p_add": 0.5, "map_density": 0.6, **params}
    rng = np.random.default_rng(p["seed"])
    entities = {r: [f"be{r}.c{k}" for k in range(p["cdm_attrs"])]
                for r in range(p["n_entities"])}
    schemas: Dict[int, List[List[str]]] = {}
    for o in range(p["n_schemas"]):
        versions = [[f"s{o}.a{k}" for k in range(p["attrs_per_version"])]]
        fresh = p["attrs_per_version"]
        for _ in range(p["versions_per_schema"] - 1):
            prev = versions[-1]
            keep = [a for a in prev if rng.random() > p["p_drop"]]
            add: List[str] = []
            while rng.random() < p["p_add"] and len(add) < 3:
                add.append(f"s{o}.a{fresh}")
                fresh += 1
            if not keep and not add:  # never cut an empty version
                keep = [prev[0]]
            versions.append(keep + add)
        schemas[o] = versions
    # each schema maps to entity o mod n_entities; a name (its root) takes a
    # distinct CDM position the first time it appears, or none
    slot: Dict[Tuple[int, str], int] = {}
    for o, versions in schemas.items():
        free = list(range(p["cdm_attrs"]))
        rng.shuffle(free)
        for names in versions:
            for a in names:
                if (o, a) not in slot:
                    slot[(o, a)] = free.pop() if free and rng.random() < p["map_density"] else -1

    reg = Registry()
    for r, names in entities.items():
        reg.add_schema(reg.range, r, names)
    for o, versions in schemas.items():
        reg.add_schema(reg.domain, o, versions[0])
        for names in versions[1:]:
            prev = {a.name for a in reg.domain.get(o, reg.domain.latest_version(o)).attributes}
            reg.evolve(reg.domain, o, keep=[a for a in names if a in prev],
                       add=[a for a in names if a not in prev])
    uids = {(o, v): [a.uid for a in reg.domain.get(o, v).attributes]
            for o in schemas for v in range(1, len(schemas[o]) + 1)}
    matrix = MappingMatrix(reg)
    for o, versions in schemas.items():
        row = reg.range.get(o % p["n_entities"], 1).uids
        for v, names in enumerate(versions, start=1):
            for a, uid in zip(names, uids[(o, v)]):
                if slot[(o, a)] >= 0:
                    matrix.set(row[slot[(o, a)]], uid, 1)
    return Scenario(entities, schemas, slot, uids, reg.state, reg, transform_to_dpm(matrix))


def mapping(sc: Scenario) -> Dict[Tuple[int, int], List[Tuple[Tuple[int, int], int,
                                                                Dict[int, int]]]]:
    """For each extraction schema version (o, v): its routes, each a CDM
    entity version (r, 1) with its width and {uid: position}."""
    n = len(sc.entities)
    out = {}
    for o, versions in sc.schemas.items():
        r = o % n
        for v, names in enumerate(versions, start=1):
            pos = {uid: sc.slot[(o, a)] for a, uid in zip(names, sc.uids[(o, v)])
                   if sc.slot[(o, a)] >= 0}
            out[(o, v)] = [((r, 1), len(sc.entities[r]), pos)] if pos else []
    return out


class Events:
    """The CDC stream of a scenario from a seed: events [start, start +
    count) are a pure function of (seed, state, position), with the same
    rates of null attributes, updates, deletes and duplicate deliveries as
    the port's generator."""

    def __init__(self, sc: Scenario, seed: int, p_duplicate: float, p_null: float = 0.25,
                 p_update: float = 0.3, p_delete: float = 0.05):
        self.sc = sc
        self.seed = seed
        self.p_null, self.p_duplicate = p_null, p_duplicate
        self.p_update, self.p_delete = p_update, p_delete
        self.blocks = [(o, v) for o in sorted(sc.schemas)
                       for v in range(1, len(sc.schemas[o]) + 1)]

    def _payload(self, rng, o: int, v: int) -> Dict[int, Optional[float]]:
        return {uid: (None if rng.random() < self.p_null else float(rng.integers(1, 1_000_000)))
                for uid in self.sc.uids[(o, v)]}

    def events(self, start: int, count: int) -> List[Dict[str, Any]]:
        """Each event as a dict: key, op, state, schema_id, version, before,
        after, ts."""
        out: List[Dict[str, Any]] = []
        state = self.sc.state
        pos = start
        while len(out) < count:
            rng = np.random.default_rng((self.seed, state, pos))
            o, v = self.blocks[int(rng.integers(len(self.blocks)))]
            u = rng.random()
            op = "c" if u >= self.p_update + self.p_delete else ("u" if u >= self.p_delete else "d")
            after = self._payload(rng, o, v)
            before = None
            if op == "u":
                before = self._payload(rng, o, v)
            elif op == "d":
                before, after = after, None
            ev = {"key": pos, "op": op, "state": state, "schema_id": o, "version": v,
                  "before": before, "after": after, "ts": pos}
            out.append(ev)
            if rng.random() < self.p_duplicate and len(out) < count:  # at-least-once
                out.append(dict(ev))
            pos += 1
        return out[:count]

    def columns(self, start: int, count: int) -> Dict[str, np.ndarray]:
        """Events [start, start + count) as plain columns: the mapped payload
        (the after image; a delete's before) as (uid, value) items with the
        nulls left out, each event's items at [offsets[e], offsets[e + 1])."""
        evs = self.events(start, count)
        uids: List[int] = []
        vals: List[float] = []
        off = np.zeros(len(evs) + 1, np.int64)
        for e, ev in enumerate(evs):
            items = ev["after"] if ev["after"] is not None else (ev["before"] or {})
            for uid, val in items.items():
                if val is not None:
                    uids.append(uid)
                    vals.append(val)
            off[e + 1] = len(uids)
        col = {k: np.array([ev[k] for ev in evs], np.int64)
               for k in ("key", "state", "schema_id", "version")}
        return {"keys": col["key"], "bad": np.zeros(len(evs), bool), "states": col["state"],
                "schema_ids": col["schema_id"], "versions": col["version"],
                "event_offsets": off, "uids": np.asarray(uids, np.int64),
                "vals": np.asarray(vals, np.float32)}

    # the program's source interface (``EventChunkSource`` slices through it)
    def slice_columnar(self, start: int, count: int):
        from repro_torch.etl.events import CDCEvent, columnarize

        return columnarize([CDCEvent(**ev) for ev in self.events(start, count)])
