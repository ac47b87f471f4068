"""Pipeline quickstart: one CDC stream fanned out to two sinks, on the
PyTorch port.

The paper's deployment (SS5.5) feeds *multiple* consumers from one METL
instance -- the data warehouse and the ML platform.  This example is that
topology on the streaming Pipeline API:

    EventChunkSource --> METLApp(engine="fused") --> TableSink      (the DW)
                                                 \\-> TokenizerSink (the ML side)

with double-buffered async consume: chunk N+1 is triaged + densified on the
host while chunk N's fused dispatch runs on the card (one C call copies the
chunk's pinned arena and launches ``segmented_gather``; ``--engine blocks``
launches ``masked_gather`` per block), and the bounded tokenizer sink demonstrates backpressure -- once
it has ``--prompts`` prompts the pipeline stops pulling.  The source yields
columnar chunks (payloads flattened once into (uid, value) arrays at the
source boundary), so the per-chunk densification is pure numpy.

The port's copy of ``examples/pipeline_stream.py``: the reference's flags
and lines, plus ``--device`` (default ``cuda``; raises without a card).

    PYTHONPATH=src python examples/pipeline_stream_torch.py
    PYTHONPATH=src python examples/pipeline_stream_torch.py --chunks 32 --sync
    PYTHONPATH=src python examples/pipeline_stream_torch.py --device cpu
"""

import argparse

from repro_torch.core.state import StateCoordinator
from repro_torch.core.synthetic import ScenarioConfig, build_scenario
from repro_torch.etl import (
    EventChunkSource,
    EventSource,
    METLApp,
    Pipeline,
    TableSink,
    TokenizerSink,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, default=12, help="event chunks to pull")
    ap.add_argument("--chunk-size", type=int, default=256)
    ap.add_argument("--prompts", type=int, default=2000,
                    help="TokenizerSink limit (the backpressure bound)")
    ap.add_argument("--engine", default="fused", choices=["fused", "blocks"])
    ap.add_argument("--sync", action="store_true", help="disable the double buffer")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    sc = build_scenario(ScenarioConfig(n_schemas=8, versions_per_schema=3, seed=3))
    coord = StateCoordinator(sc.registry, sc.dpm)
    app = METLApp(coord, engine=args.engine, device=args.device)
    print(f"engine: {app.engine.info()}")

    source = EventChunkSource(
        EventSource(sc.registry, seed=3, p_duplicate=0.05),
        chunk_size=args.chunk_size,
        max_chunks=args.chunks,
    )
    dw = TableSink()
    ml = TokenizerSink(vocab=8192, max_len=16, limit=args.prompts)
    pipe = Pipeline(source, app, [dw, ml], async_consume=not args.sync)

    st = pipe.run()
    pipe.close()
    print(
        f"run: {st.chunks} chunks, {st.events} events -> {st.rows} canonical "
        f"rows in {app.stats['dispatches']} dispatches "
        f"({'sync' if args.sync else 'async double-buffered'} consume)"
    )

    tables = dw.to_arrays()
    print(f"DW sink: {len(tables)} business-entity tables")
    for (r, w), t in sorted(tables.items())[:4]:
        print(f"  entity ({r}, v{w}): {t['values'].shape[0]} rows x "
              f"{t['values'].shape[1]} attrs")
    print(f"ML sink: {len(ml.prompts)} token prompts "
          f"(backpressure stopped the pull: {ml.full()})")
    print(f"app stats: {dict(app.stats)}")

    if ml.full() and st.chunks < args.chunks:
        print(f"note: pipeline stopped after {st.chunks}/{args.chunks} chunks -- "
              f"the bounded sink gated the stream")


if __name__ == "__main__":
    main()
