"""Live schema evolution ON the stream, through the typed control plane, on
the PyTorch port.

The paper's operational core: extraction schemas change several times a day;
every change triggers the automated Algorithm-5 update, cache eviction, and
a state bump that all horizontally-scaled consumers observe.  Since the
control-plane redesign the whole workflow is IN-BAND: typed
:class:`~repro_torch.etl.control.ControlEvent`\\ s ride the same stream as the CDC
data (``EventChunkSource(control={chunk: event})``), the coordinator is the
single state writer appending every applied event to its replayable
``control_log``, and the pipeline applies each event at the chunk boundary
where it arrives -- evict, lazy recompile, parked replay, all mid-stream.

This example trains on the METL stream while the stream itself carries

  * a ``SchemaEvolved`` (version v -> v+1 with equivalence links),
  * a ``Freeze``/``Thaw`` initial-load window with a second evolution
    arriving INSIDE the window (deferred, re-admitted by the thaw,
    exactly the SS3.4 rule), and
  * a ``VersionDeleted`` retirement,

then proves the single-writer story: replaying ``coordinator.control_log``
over a fresh seed registry reproduces the final state ``i`` and the DPM
bit-exactly.  ``--instances N`` runs the same scripted stream over a
multi-instance :class:`~repro_torch.etl.cluster.Cluster` instead of one
pipeline.

The port's copy of ``examples/schema_evolution.py``: the reference's flags,
lines and asserts, plus ``--device`` (default ``cuda``; raises without a
card).  The weights are drawn from the train config's seed on the host.

    PYTHONPATH=src python examples/schema_evolution_torch.py
    PYTHONPATH=src python examples/schema_evolution_torch.py --steps 4 --instances 4
    PYTHONPATH=src python examples/schema_evolution_torch.py --steps 3 --device cpu
"""

import argparse

from repro_torch.core.state import StateCoordinator
from repro_torch.core.synthetic import ScenarioConfig, build_scenario
from repro_torch.etl import (
    BatcherSink,
    CanonicalBatcher,
    Cluster,
    EventChunkSource,
    EventSource,
    Freeze,
    METLApp,
    Pipeline,
    SchemaEvolved,
    Thaw,
    VersionDeleted,
    replay_control_log,
)


def scripted_control(registry):
    """The day's schema-registry workflow, scheduled on the chunk grid."""
    schemas = registry.domain.schema_ids()

    def evolve(o, tag):
        v = registry.domain.latest_version(o)
        keep = tuple(a.name for a in registry.domain.get(o, v).attributes)[1:]
        return SchemaEvolved(tree="domain", schema_id=o, keep=keep, add=(tag,))

    return {
        2: evolve(schemas[0], "evolved_a"),
        5: Freeze(),
        # arrives inside the initial-load window -> deferred until the Thaw
        6: evolve(schemas[1], "evolved_b"),
        7: Thaw(),
        9: VersionDeleted(tree="domain", schema_id=schemas[0], version=1),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=12, help="train steps")
    ap.add_argument("--chunk-size", type=int, default=256)
    ap.add_argument("--instances", type=int, default=0,
                    help="run the scripted stream over an N-instance Cluster")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    import repro_torch.configs as C
    from repro_torch.models import model as M
    from repro_torch.train.loop import TrainConfig, train
    from repro_torch.train.optimizer import AdamWConfig

    sc = build_scenario(ScenarioConfig(n_schemas=8, versions_per_schema=3, seed=1))
    coord = StateCoordinator(sc.registry, sc.dpm)
    vocab = 4096
    batcher = CanonicalBatcher(vocab=vocab, seq_len=32, batch_size=4)
    sink = BatcherSink(batcher)
    control = scripted_control(coord.registry)
    stream = EventSource(sc.registry, seed=0)

    if args.instances > 1:
        runtime = Cluster.over_stream(
            coord, stream, instances=args.instances,
            chunk_size=args.chunk_size, control=control, sinks=[sink],
            device=args.device,
        )
        pull = runtime.run
    else:
        app = METLApp(coord, device=args.device)
        source = EventChunkSource(
            stream, chunk_size=args.chunk_size, control=control
        )
        runtime = Pipeline(source, app, [sink])
        pull = runtime.run

    seen_log = {"n": 0}

    def batch_fn(step):
        while not batcher.ready():
            pull()  # backpressured: BatcherSink is full once a batch is ready
        for rec in coord.control_log[seen_log["n"]:]:
            print(f"  [state {rec.state}] applied {rec.event!r}")
        seen_log["n"] = len(coord.control_log)
        return batcher.next_batch()

    cfg = C.get_smoke("olmo_1b").replace(vocab=vocab)
    tc = TrainConfig(steps=args.steps, batch=4, seq=32, log_every=5,
                     opt=AdamWConfig(lr=1e-3, warmup_steps=5))
    params = M.init_params(cfg, tc.seed, device="cpu")
    train(cfg, tc, batch_fn=batch_fn,
          on_step=lambda s, m: print(f"step {s:3d} loss {m['loss']:.4f}"),
          device=args.device, params=params)

    # drain the rest of the day's schedule: a short training run may stop
    # before the stream reaches the later control positions, and every
    # scheduled event (including the deferred one) must apply exactly once
    n_scheduled = len(control)
    for _ in range(50):
        if len(coord.control_log) >= n_scheduled:
            break
        while batcher.ready():
            batcher.next_batch()  # release the BatcherSink backpressure
        if args.instances > 1:
            runtime.run(max_rounds=args.instances)
        else:
            runtime.run(max_chunks=1)
    for rec in coord.control_log[seen_log["n"]:]:
        print(f"  [state {rec.state}] applied {rec.event!r}")
    assert len(coord.control_log) == n_scheduled

    if args.instances > 1:
        print(f"cluster info: { {k: v for k, v in runtime.info().items() if k != 'per_instance'} }")
        stats = {k: sum(int(a.stats[k]) for a in runtime.apps)
                 for k in ("events", "mapped", "stale", "parked")}
    else:
        stats = {k: int(app.stats[k]) for k in ("events", "mapped", "stale", "parked")}
    print(f"final ETL stats: {stats} | final state i={coord.registry.state}")

    # the single-writer story: a fresh instance reconstructs the exact state
    # by replaying the control log over the deterministic seed registry
    seed = build_scenario(ScenarioConfig(n_schemas=8, versions_per_schema=3, seed=1))
    replayed = replay_control_log(coord.control_log, seed.registry, seed.dpm)
    assert replayed.registry.state == coord.registry.state
    assert replayed.snapshot().dpm == coord.snapshot().dpm
    print(f"control-log replay: {len(coord.control_log)} events -> "
          f"state i={replayed.registry.state}, DPM bit-exact ✓")


if __name__ == "__main__":
    main()
