"""The traffic's METL side: the scenario and CDC stream the benchmark
makes from the seed (:mod:`metlbench.cdc`), the program's pipeline that
maps them (the system under test), and the same inputs laid out as plain
lookups and columns for the reference.  What is judged is what the METL
app derives from them.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from reference import etl as ref_etl

from . import cdc


def scenario(traffic: Dict[str, Any]) -> cdc.Scenario:
    return cdc.scenario(traffic["scenario"])


def event_source(sc: cdc.Scenario, traffic: Dict[str, Any], seed: int) -> cdc.Events:
    return cdc.Events(sc, seed, traffic["p_duplicate"])


def pipeline(sc, traffic: Dict[str, Any], seed: int, device, sinks):
    """``EventChunkSource -> METLApp -> sinks`` on the app's device, as the
    traffic file sets it (engine, densify route, async consume)."""
    from repro_torch.core.state import StateCoordinator
    from repro_torch.etl import EventChunkSource, METLApp, Pipeline

    app = METLApp(StateCoordinator(sc.registry, sc.dpm), device=device,
                  engine=traffic["engine"], device_densify=traffic["device_densify"])
    pipe = Pipeline(EventChunkSource(event_source(sc, traffic, seed),
                                     chunk_size=traffic["chunk_events"]),
                    app, sinks, async_consume=traffic["async_consume"])
    return app, pipe


def prompts(sc, traffic: Dict[str, Any], seed: int, device, vocab: int, n: int) -> np.ndarray:
    """``n`` prompts of ``prompt_len`` tokens (n, P) int32: the rows of the
    stream through ``TokenizerSink(vocab, max_len=row_tokens)``, each row's
    tokens cut at ``row_tokens``, laid end to end and cut into P-token
    prompts."""
    from repro_torch.etl import TokenizerSink

    P = traffic["prompt_len"]

    class Enough(TokenizerSink):
        counted, tokens = 0, 0  # the prompts counted so far and their tokens

        def full(self) -> bool:  # asked once a row: count only the new prompts
            for p in self.prompts[self.counted:]:
                self.tokens += len(p)
            self.counted = len(self.prompts)
            return self.tokens >= n * P

    sink = Enough(vocab, max_len=traffic["row_tokens"])
    _, pipe = pipeline(sc, traffic, seed, device, [sink])
    try:
        while not sink.full():
            pipe.run()
    finally:
        pipe.close()
    flat = [t for p in sink.prompts for t in p][: n * P]
    return np.asarray(flat, np.int32).reshape(n, P)


def mapping(sc: cdc.Scenario) -> ref_etl.Mapping:
    """The scenario's ground-truth mapping as the reference's lookups."""
    return ref_etl.Mapping(cdc.mapping(sc), sc.state)


def chunks(sc: cdc.Scenario, traffic: Dict[str, Any], seed: int
           ) -> Iterator[Dict[str, np.ndarray]]:
    """The stream's chunks in order, each as plain columns."""
    src = event_source(sc, traffic, seed)
    size = traffic["chunk_events"]
    k = 0
    while True:
        yield src.columns(k * size, size)
        k += 1


def token_stream(sc, traffic: Dict[str, Any], seed: int, vocab: int, need: int,
                 per_row: Optional[int] = None) -> List[int]:
    """The reference's first ``need`` tokens of the stream."""
    return ref_etl.token_stream(mapping(sc), chunks(sc, traffic, seed), vocab, need,
                                traffic["dedup_window"], per_row)
