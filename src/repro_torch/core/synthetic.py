"""(Port copy of ``repro.core.synthetic``: the same code, kept here so that
``repro_torch`` imports nothing of the reference package.)

Synthetic mapping-system scenarios shaped like the paper's estimates.

Paper SS3.5 numbers we scale down from (controllable via parameters):
  >10,000 extraction attributes, >1,000 CDM attributes, >=10 versions per
  schema, ~10 attributes per version, matrix up to 1e9 elements, row:column
  ratio ~1:100.

The generator builds a registry whose version chains carry realistic
equivalence links (attributes survive across versions, occasionally get
dropped or added) and a ground-truth 1:1 mapping matrix in which each
extraction schema maps predominantly to one business entity (paper SS6.4:
"many extracting schemata versions map to one business entity version only").
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .dmm import DPM, MappingMatrix, transform_to_dpm
from .registry import Registry

__all__ = [
    "ScenarioConfig",
    "Scenario",
    "build_scenario",
    "churn_schedule",
    "scenario_event_chunks",
    "soak_config",
]


@dataclasses.dataclass
class ScenarioConfig:
    n_schemas: int = 8  # extraction schemas (microservice tables)
    versions_per_schema: int = 4
    attrs_per_version: int = 10
    n_entities: int = 2  # CDM business entities
    cdm_attrs: int = 12  # attributes per business entity version
    # probability an attribute is dropped when a new version is cut
    p_drop: float = 0.15
    # probability a fresh attribute is added in a new version
    p_add: float = 0.5
    # fraction of a schema's attributes that map into the CDM
    map_density: float = 0.6
    seed: int = 0


@dataclasses.dataclass
class Scenario:
    config: ScenarioConfig
    registry: Registry
    matrix: MappingMatrix
    dpm: DPM

    @property
    def shape(self) -> Tuple[int, int]:
        return self.matrix.M.shape


def build_scenario(config: Optional[ScenarioConfig] = None) -> Scenario:
    cfg = config or ScenarioConfig()
    rng = np.random.default_rng(cfg.seed)
    reg = Registry()

    # -- CDM business entities (one live version each; paper SS5.1 rule) ------
    for r in range(cfg.n_entities):
        names = [f"be{r}.c{k}" for k in range(cfg.cdm_attrs)]
        reg.add_schema(reg.range, r, names)

    # -- extraction schemas with version chains -------------------------------
    for o in range(cfg.n_schemas):
        names = [f"s{o}.a{k}" for k in range(cfg.attrs_per_version)]
        reg.add_schema(reg.domain, o, names)
        fresh = cfg.attrs_per_version
        for _ in range(cfg.versions_per_schema - 1):
            prev = reg.domain.get(o, reg.domain.latest_version(o))
            keep = [a.name for a in prev.attributes if rng.random() > cfg.p_drop]
            add: List[str] = []
            while rng.random() < cfg.p_add and len(add) < 3:
                add.append(f"s{o}.a{fresh}")
                fresh += 1
            if not keep and not add:  # never cut an empty version
                keep = [prev.attributes[0].name]
            reg.evolve(reg.domain, o, keep=keep, add=add)

    # -- ground-truth 1:1 mapping ----------------------------------------------
    # Each schema o maps to entity (o mod n_entities).  The *root* attributes
    # of the schema are assigned distinct CDM slots; versioned copies inherit
    # the assignment through equivalence -- which is exactly why the matrix
    # explodes with versions and why equivalence-copying works (SS5.4.1).
    matrix = MappingMatrix(reg)
    for o in reg.domain.schema_ids():
        r = o % cfg.n_entities
        entity = reg.range.get(r, reg.range.latest_version(r))
        cdm_slots = list(entity.uids)
        rng.shuffle(cdm_slots)
        root_to_slot: Dict[int, int] = {}
        for v in reg.domain.versions(o):
            block = reg.domain.get(o, v)
            for a in block.attributes:
                root = reg.domain.equivalence_root(a.uid)
                if root not in root_to_slot:
                    if cdm_slots and rng.random() < cfg.map_density:
                        root_to_slot[root] = cdm_slots.pop()
                    else:
                        root_to_slot[root] = -1  # filtered
                slot = root_to_slot[root]
                if slot != -1:
                    matrix.set(slot, a.uid, 1)
    matrix.validate_one_to_one()
    return Scenario(config=cfg, registry=reg, matrix=matrix, dpm=transform_to_dpm(matrix))


def scenario_event_chunks(
    scenario: Scenario,
    *,
    seed: int = 0,
    start: int = 0,
    chunk_size: int = 256,
    n_chunks: int = 4,
    columnar: bool = True,
    **source_kwargs,
) -> List:
    """The scenario's deterministic CDC stream as ready-to-consume chunks.

    With ``columnar=True`` (the default) each chunk is generated straight
    into a :class:`~repro_torch.etl.events.ColumnarChunk` -- payload (uid, value)
    columns built once at the source boundary, never re-walked downstream --
    which is the form benchmarks and the streaming pipeline consume.  Extra
    kwargs (``p_null`` / ``p_duplicate`` / ...) pass through to the
    :class:`~repro_torch.etl.events.EventSource`.
    """
    from ..etl.events import EventSource  # local: core must not import etl at load

    src = EventSource(scenario.registry, seed=seed, **source_kwargs)
    slicer = src.slice_columnar if columnar else src.slice
    return [slicer(start + k * chunk_size, chunk_size) for k in range(n_chunks)]


def soak_config(smoke: bool = False) -> ScenarioConfig:
    """The plan-lifecycle soak shape (``benchmarks/bench_compaction.py``).

    Full size is 80 extraction schemas x 6 versions -- ~480 live version
    columns, the "hundreds of live versions" regime the epoched plan
    lifecycle has to survive under continuous churn.  ``smoke=True`` is the
    CI miniature (16 x 3) that keeps the same gates at a fraction of the
    build cost.
    """
    if smoke:
        return ScenarioConfig(
            n_schemas=16, versions_per_schema=3, attrs_per_version=6,
            n_entities=4, cdm_attrs=10, seed=7,
        )
    return ScenarioConfig(
        n_schemas=80, versions_per_schema=6, attrs_per_version=8,
        n_entities=20, cdm_attrs=30, seed=7,
    )


def churn_schedule(
    registry: Registry,
    *,
    steps: int,
    first_chunk: int = 1,
    every: int = 1,
    seed: int = 0,
    tag: str = "churn",
) -> Dict[int, object]:
    """A deterministic ``{chunk_index: SchemaEvolved}`` churn schedule.

    Each step cuts a new version for one extraction schema (round-robin,
    attribute keep/add choices drawn from ``seed``).  The events are built
    eagerly against a *simulated* view of each schema's live attribute
    names -- the registry itself is not mutated here -- so a schedule can
    target several arms of an A/B soak that each apply it to their own
    coordinator.  Repeated evolutions of the same schema stay valid because
    the simulation tracks the names every earlier step kept or added.
    """
    from ..etl.control import SchemaEvolved  # local: core must not import etl at load

    rng = np.random.default_rng(seed)
    sids = sorted(registry.domain.schema_ids())
    # Live attribute names per schema, as of the latest version -- the
    # simulated state each synthesized evolution advances.
    names: Dict[int, List[str]] = {
        o: [a.name for a in registry.domain.get(o, registry.domain.latest_version(o)).attributes]
        for o in sids
    }
    sched: Dict[int, object] = {}
    for i in range(steps):
        o = sids[i % len(sids)]
        keep = [n for n in names[o] if rng.random() > 0.25]
        add = [f"s{o}.{tag}{i}"]
        if not keep:  # never cut an empty version
            keep = names[o][:1]
        names[o] = keep + add
        sched[first_chunk + i * every] = SchemaEvolved(
            tree="domain", schema_id=o, keep=tuple(keep), add=tuple(add)
        )
    return sched
