"""Serving launcher: batched greedy decoding with the continuous-batching
server, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo_1b \\
        --requests 8 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo_1b --smoke \\
        --device cpu

Counterpart of ``python -m repro.launch.serve``: without ``--etl`` the
prompts are random, 2-7 tokens from ``np.random.default_rng(0)``, and the
parameters come from ``init_params`` with seed 0.

With ``--etl`` the prompts are not random: a CDC stream flows through the
streaming METL pipeline (``EventChunkSource -> METLApp -> TokenizerSink``,
:mod:`repro_torch.etl.pipeline`) with the *fused* mapping engine (one
launch a chunk of 256 events, :mod:`repro_torch.etl.engines`), and the
bounded tokenizer sink backpressures the pull once serving has enough
prompts -- the paper's pipeline (CDC -> DMM -> CDM) fronting the model
server.  The mapping runs on ``--device`` as the model does: the card's
kernels by default, their plain PyTorch versions with ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo_1b --smoke \\
        --device cpu --etl

The ETL flags compose as in the reference:

- ``--async-consume``: the double-buffered pipeline (chunk N+1 is triaged
  and densified on the host while chunk N's copies and kernel run on the
  stream; see :mod:`repro_torch.etl.pipeline`);
- ``--device-densify``: the raw columnar items cross to the device in one
  packed copy a chunk and are densified and mapped inside the one
  ``densify_map`` launch;
- ``--shards N``: ``engine="sharded"``, the block table partitioned over N
  shards of :func:`repro_torch.launch.mesh.make_etl_mesh`, spread over the
  visible cards with the shards that share a card adjacent (on one card all
  N share it; with ``--device cpu``, N CPU shards);
- ``--instances N``: a multi-instance :class:`~repro_torch.etl.cluster.
  Cluster`, N pipelines over deterministic round-robin slices of one chunk
  grid, one coordinator as the single state writer, the bounded tokenizer
  sink as the merge fan-in (paper SS5.5); composes with the three above.

``--etl --instances N --replicated`` runs the fan-out as the distributed
control plane (:mod:`repro_torch.etl.replication`): an in-process leader on
slot 0 of the chunk grid streams fenced control records to N-1 follower
processes (``python -m repro_torch.etl.replication --role follower``) over
the socket transport, every node mapping its chunks on ``--device`` (on
the card they share it).  It composes with ``--instances`` only; without
``--etl`` it is ignored, as in the reference.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional


def _shard_devices(shards: int, device: str) -> List[str]:
    """The sharded engine's device list: ``shards`` shards over the visible
    cards, those on one card adjacent (all on it when there is one card);
    CPU shards for a CPU ``device``."""
    import torch

    if torch.device(device).type == "cpu":
        return ["cpu"] * shards
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"--shards {shards} on {device!r} but torch.cuda.is_available() is "
            "False; pass --device cpu to run the plain PyTorch versions"
        )
    cards = min(torch.cuda.device_count(), shards)
    return [f"cuda:{s * cards // shards}" for s in range(shards)]


def _etl_prompts(
    n_requests: int,
    vocab: int,
    max_len: int = 16,
    shards: int = 0,
    async_consume: bool = False,
    instances: int = 0,
    device_densify: bool = False,
    device: str = "cuda",
):
    """Stream CDC events through the METL pipeline into token prompts.

    The pull topology is ``EventChunkSource -> METLApp -> TokenizerSink``:
    the bounded sink (``limit=n_requests``) backpressures the stream, so the
    pipeline pulls exactly as many chunks as serving needs.  With
    ``instances > 1`` the stream is sliced deterministically over a
    multi-instance :class:`~repro_torch.etl.cluster.Cluster` (one
    coordinator as the single state writer, the bounded sink as the merge
    fan-in).  The mapping runs on ``device`` (raises without a card unless
    it is ``"cpu"``)."""
    from ..core.state import StateCoordinator
    from ..core.synthetic import ScenarioConfig, build_scenario
    from ..etl import (
        Cluster,
        EventChunkSource,
        EventSource,
        METLApp,
        Pipeline,
        TokenizerSink,
    )

    sc = build_scenario(ScenarioConfig(n_schemas=6, versions_per_schema=3, seed=7))
    coord = StateCoordinator(sc.registry, sc.dpm)
    engine, mesh = "fused", None
    if shards > 1:
        from .mesh import make_etl_mesh

        engine, mesh = "sharded", make_etl_mesh(devices=_shard_devices(shards, device))
    sink = TokenizerSink(vocab, max_len=max_len, limit=n_requests)
    stream = EventSource(sc.registry, seed=7)
    if instances > 1:
        # columnar chunks, sliced round-robin over the instances; lockstep
        # rounds keep every instance at the same state i (paper SS5.5)
        cluster = Cluster.over_stream(
            coord, stream, instances=instances, chunk_size=256,
            sinks=[sink], engine=engine, mesh=mesh, device=device,
            device_densify=device_densify,
            async_consume=async_consume,
        )
        # pull until the bounded sink gates the stream; a whole window of
        # rounds with zero canonical rows means the stream is unmappable --
        # bail out instead of spinning on an unbounded source forever
        total = 0
        while not sink.full():
            st = cluster.run(max_rounds=16 * instances)
            total += st.rows
            if st.rows == 0:
                raise RuntimeError(
                    f"ETL cluster produced no canonical rows in {st.events} "
                    f"events this window"
                )
        info = cluster.info()
        print(
            f"etl: cluster of {info['instances']} instances "
            f"(engine={info['engine']}, state i={info['state']}, "
            f"per-instance states {info['states']}): {info['events']} events "
            f"-> {total} canonical rows in {info['dispatches']} dispatches"
            f"{', async double-buffered' if async_consume else ''}"
        )
        return sink.prompts
    app = METLApp(coord, engine=engine, mesh=mesh, device=device,
                  device_densify=device_densify)
    if device_densify:
        print(
            "etl: device densify on -- raw columnar items cross host->device "
            "in one packed transfer, densified inside the fused dispatch"
        )
    if shards > 1:
        info = app.engine.info()
        print(
            f"etl: sharded engine over {info['n_shards']} shards, "
            f"{info['table_bytes_per_shard']} table bytes/shard "
            f"({info['n_blocks']} blocks, {info['blocks_per_shard']}/shard)"
        )
    # columnar=True (the default): payloads flatten to (uid, value) arrays
    # once at the source boundary; consume densifies in pure numpy
    source = EventChunkSource(stream, chunk_size=256, columnar=True)
    pipe = Pipeline(source, app, [sink], async_consume=async_consume)
    # pull until serving has enough prompts; a whole 16-chunk window with
    # zero canonical rows means the stream is unmappable -- bail out
    total_rows = 0
    while not sink.full():
        st = pipe.run(max_chunks=16)
        total_rows += st.rows
        if st.rows == 0:
            raise RuntimeError(
                f"ETL stream produced no canonical rows in {st.events} "
                f"events (total {app.stats['events']})"
            )
    print(
        f"etl: {app.stats['events']} events -> {total_rows} canonical rows "
        f"in {app.stats['dispatches']} device dispatches "
        f"({app.stats['events'] / max(1, app.stats['dispatches']):.0f} events/dispatch"
        f"{', async double-buffered' if async_consume else ''})"
    )
    return sink.prompts


def _src_path() -> str:
    """PYTHONPATH for follower subprocesses: the tree this repro_torch
    package was imported from, plus whatever the parent already had."""
    import repro_torch

    src = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
    have = os.environ.get("PYTHONPATH", "")
    return src + (os.pathsep + have if have else "")


def _etl_replicated(n_requests: int, vocab: int, max_len: int = 16,
                    instances: int = 2, device: str = "cuda") -> list:
    """Leader/follower multi-process METL: the ``--replicated`` path.

    One in-process :class:`~repro_torch.etl.replication.LeaderNode` (slot 0
    of the chunk grid) + ``instances - 1`` follower subprocesses (``python
    -m repro_torch.etl.replication --role follower --device <device>``)
    over the socket transport.  A small churn schedule exercises live schema
    evolution across the replicated control plane; rows merge in global
    chunk order.  Every node maps on ``device`` (raises without a card
    unless it is ``"cpu"``); on the card the kernel library is built here,
    before any follower starts, so the followers load it instead of each
    compiling it."""
    import json
    import subprocess
    import sys
    import tempfile

    from ..core.dmm_torch import resolve_device
    from ..core.state import StateCoordinator
    from ..core.synthetic import ScenarioConfig, build_scenario, churn_schedule
    from ..etl import EventSource, TokenizerSink
    from ..etl.replication import DataPlane, LeaderNode
    from ..etl.transport import SocketServer, row_from_wire

    if resolve_device(device).type == "cuda":
        from ..kernels import build

        build.build(["segmented_gather"])
    instances = max(2, instances)
    max_chunks, chunk_size = 4 * instances, 256
    sc = build_scenario(ScenarioConfig(n_schemas=6, versions_per_schema=3, seed=7))
    coord = StateCoordinator(sc.registry, sc.dpm)
    leader = LeaderNode(coord, term=1)
    churn = churn_schedule(sc.registry, steps=2, first_chunk=2,
                           every=instances, seed=8)
    leader.set_schedule({k: [v] for k, v in churn.items()})

    srv = SocketServer(port=0)
    procs, by_chunk = [], {}
    with tempfile.TemporaryDirectory(prefix="serve-repl-") as tmp:
        outs = [os.path.join(tmp, f"follower{slot}.jsonl") for slot in range(1, instances)]
        try:
            for slot, out in enumerate(outs, start=1):
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.etl.replication",
                     "--role", "follower", "--host", "127.0.0.1",
                     "--port", str(srv.port), "--slot", str(slot),
                     "--instances", str(instances),
                     "--max-chunks", str(max_chunks),
                     "--chunk-size", str(chunk_size),
                     "--stream-seed", "7", "--out", out, "--device", str(device)],
                    env={**os.environ, "PYTHONPATH": _src_path()},
                ))
            for _ in procs:
                transport = srv.accept(timeout=60.0)
                if transport is None:
                    raise RuntimeError(
                        "a replicated follower never connected (exit codes "
                        f"{[p.poll() for p in procs]})")
                leader.attach(transport, timeout=60.0)

            plane = DataPlane(coord, EventSource(sc.registry, seed=7), slot=0,
                              instances=instances, max_chunks=max_chunks,
                              chunk_size=chunk_size, device=device)
            leader.run(plane, on_chunk=lambda h, rows: by_chunk.__setitem__(h, rows))
            leader.finish(end=max_chunks - 1, wait_done=True, timeout=120.0)
            for p in procs:
                if p.wait(timeout=120) != 0:
                    raise RuntimeError(f"replicated follower exited {p.returncode}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            leader.close()
            srv.close()
        for out in outs:
            with open(out) as f:
                for line in f:
                    d = json.loads(line)
                    by_chunk[d["chunk"]] = [row_from_wire(r) for r in d["rows"]]

    sink = TokenizerSink(vocab, max_len=max_len, limit=n_requests)
    for h in sorted(by_chunk):
        sink.write(by_chunk[h])
        if sink.full():
            break
    if not sink.full():
        raise RuntimeError(
            f"replicated ETL produced only {len(sink.prompts)} prompts of "
            f"{n_requests} over {max_chunks} chunks"
        )
    info = leader.coordinator.replication_info()
    print(
        f"etl: replicated control plane, 1 leader + {instances - 1} followers "
        f"(term {info['term']}, log_offset {info['log_offset']}, "
        f"state i={coord.registry.state}): "
        f"{sum(len(v) for v in by_chunk.values())} canonical rows over "
        f"{len(by_chunk)} chunks"
    )
    return sink.prompts


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; the hand-written kernels) or cpu "
                         "(their plain PyTorch versions)")
    ap.add_argument("--etl", action="store_true",
                    help="feed prompts from the fused METL mapping path")
    ap.add_argument("--shards", type=int, default=0,
                    help="with --etl: shard the DMM block table over N shards "
                         "(engine='sharded'); 0/1 = replicated")
    ap.add_argument("--instances", type=int, default=0,
                    help="with --etl: fan the stream over N horizontally-"
                         "scaled METL instances (a Cluster with one "
                         "coordinator as the single state writer); 0/1 = "
                         "one pipeline")
    ap.add_argument("--replicated", action="store_true",
                    help="with --etl --instances N: run the fan-out as a "
                         "distributed control plane -- an in-process leader "
                         "streams fenced control records to N-1 follower "
                         "processes over the socket transport "
                         "(repro_torch.etl.replication)")
    ap.add_argument("--async-consume", action="store_true",
                    help="with --etl: double-buffered pipeline consume "
                         "(chunk N+1 densifies while chunk N is on the device)")
    ap.add_argument("--device-densify", action="store_true",
                    help="with --etl: densify on the device (one packed "
                         "copy + one fused launch per chunk; no host scatter)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    args = ap.parse_args(argv)

    import numpy as np

    from .. import configs
    from ..models import model as M
    from ..serve.decode import ServeConfig, Server

    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    params = M.init_params(cfg, 0, device=args.device)
    sc = ServeConfig(batch=args.batch, cache_len=args.cache_len, max_new=args.max_new)
    server = Server(params, cfg, sc, device=args.device)
    if args.etl and args.replicated:
        if args.shards > 1 or args.device_densify or args.async_consume:
            raise SystemExit(
                "--replicated composes with --instances only (follower "
                "processes run the plain fused engine)"
            )
        prompts = _etl_replicated(
            args.requests, cfg.vocab, instances=max(2, args.instances),
            device=args.device,
        )
    elif args.etl:
        prompts = _etl_prompts(
            args.requests, cfg.vocab, shards=args.shards,
            async_consume=args.async_consume, instances=args.instances,
            device_densify=args.device_densify, device=args.device,
        )
    else:
        rng = np.random.default_rng(0)
        prompts = [
            rng.integers(2, cfg.vocab, size=rng.integers(2, 8)).tolist()
            for _ in range(args.requests)
        ]
    rids = [server.submit(p) for p in prompts]
    server.run(n_steps=args.requests * (args.max_new + 8))
    for rid in rids:
        toks = server.done.get(rid)
        print(f"request {rid}: {len(toks or [])} tokens -> {toks[:12] if toks else 'PENDING'}")


if __name__ == "__main__":
    main()
