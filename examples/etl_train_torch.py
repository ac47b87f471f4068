"""End-to-end driver: CDC events -> METL (DMM) -> canonical batches -> LM,
on the PyTorch port.

The full pipeline of DESIGN §2: synthetic microservice databases emit CDC
events; METL maps them to the canonical data model with the compacted DMM;
the batcher tokenizes canonical rows into the trainer's canonical batch
schema; an LM trains on the mapped stream, with checkpoint/restart.  The
ETL side runs on the streaming Pipeline API (EventChunkSource -> METLApp ->
BatcherSink) with double-buffered async consume; BatcherSink backpressure
stops the pull whenever the trainer has a full batch buffered.

The port's copy of ``examples/etl_train.py``: the reference's flags,
``SCALES`` and lines, plus ``--device`` (default ``cuda``; raises without a
card).  On the card each chunk of the feed is one ``segmented_gather``
launch.  The weights are drawn from the train config's seed on the host
and then moved, so every device trains the same model.  ``--model-scale
100m`` builds a ~100M-parameter model (the paper-kind end-to-end target).

    PYTHONPATH=src python examples/etl_train_torch.py --steps 30
    PYTHONPATH=src python examples/etl_train_torch.py --model-scale 100m --steps 300
    PYTHONPATH=src python examples/etl_train_torch.py --steps 3 --device cpu
"""

import argparse

import repro_torch.configs as C
from repro_torch.core.state import StateCoordinator
from repro_torch.core.synthetic import ScenarioConfig, build_scenario
from repro_torch.etl import (
    BatcherSink,
    CanonicalBatcher,
    EventChunkSource,
    EventSource,
    METLApp,
    Pipeline,
)
from repro_torch.models import model as M
from repro_torch.train.loop import TrainConfig, train
from repro_torch.train.optimizer import AdamWConfig

SCALES = {
    # n_layers, d_model, heads, d_ff  (~params with 8k vocab)
    "smoke": (2, 64, 4, 256),
    "10m": (6, 384, 6, 1536),
    "100m": (12, 768, 12, 3072),
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--model-scale", default="smoke", choices=list(SCALES))
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    # -- the ETL side: CDC stream -> METL pipeline -> BatcherSink -------------
    sc = build_scenario(ScenarioConfig(n_schemas=12, versions_per_schema=4, seed=0))
    coord = StateCoordinator(sc.registry, sc.dpm)
    app = METLApp(coord, device=args.device)

    vocab = 8192
    batcher = CanonicalBatcher(vocab=vocab, seq_len=args.seq, batch_size=args.batch)
    # BatcherSink reports full() once a batch is buffered, so each
    # pipe.run() pulls exactly until the trainer can step; the source
    # cursor persists across calls (double-buffered async consume)
    pipe = Pipeline(
        EventChunkSource(
            EventSource(sc.registry, seed=0, p_duplicate=0.05), chunk_size=512
        ),
        app,
        [BatcherSink(batcher)],
        async_consume=True,
    )

    def batch_fn(step):
        while not batcher.ready():
            pipe.run()
        return batcher.next_batch()

    # -- the model side -------------------------------------------------------
    L, D, H, F = SCALES[args.model_scale]
    cfg = C.get("olmo_1b").replace(
        n_layers=L, d_model=D, n_heads=H, n_kv_heads=H, d_ff=F, vocab=vocab
    )
    print(f"model: {cfg.param_count()/1e6:.1f}M params | ETL state i={coord.registry.state}")
    tc = TrainConfig(
        steps=args.steps, batch=args.batch, seq=args.seq, log_every=5,
        ckpt_dir=args.ckpt_dir, ckpt_every=(20 if args.ckpt_dir else 0),
        opt=AdamWConfig(lr=1e-3, warmup_steps=10),
    )
    params = M.init_params(cfg, tc.seed, device="cpu")
    out = train(cfg, tc, batch_fn=batch_fn,
                on_step=lambda s, m: print(f"step {s:4d} loss {m['loss']:.4f}"),
                device=args.device, params=params)
    first, last = out["history"][0]["loss"], out["history"][-1]["loss"]
    print(f"ETL stats: {dict(app.stats)}")
    print(f"loss {first:.3f} -> {last:.3f} on METL-mapped stream "
          f"({'improved' if last < first else 'NOT improved'})")


if __name__ == "__main__":
    main()
