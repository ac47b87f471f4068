"""Serving launcher: batched greedy decoding with the continuous-batching
server, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo_1b \\
        --requests 8 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo_1b --smoke \\
        --device cpu

Counterpart of ``python -m repro.launch.serve`` without ``--etl``: random
prompts of 2-7 tokens from ``np.random.default_rng(0)``, parameters from
``init_params`` with seed 0.  The ETL-fed modes of the reference
(``--etl``, ``--shards``, ``--instances``, ``--replicated``,
``--async-consume``, ``--device-densify``) need the streaming pipeline and
its ``TokenizerSink``, which are not ported yet (ROADMAP queue 1 items
11-13); they are accepted as flags and refused.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

# the reference's ETL flags, refused until the pipeline is ported
_ETL_FLAGS = ("etl", "shards", "instances", "replicated", "async_consume", "device_densify")


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; the hand-written kernels) or cpu "
                         "(their plain PyTorch versions)")
    ap.add_argument("--etl", action="store_true")
    ap.add_argument("--shards", type=int, default=0)
    ap.add_argument("--instances", type=int, default=0)
    ap.add_argument("--replicated", action="store_true")
    ap.add_argument("--async-consume", action="store_true")
    ap.add_argument("--device-densify", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    args = ap.parse_args(argv)

    used = [f for f in _ETL_FLAGS if getattr(args, f)]
    if used:
        flags = ", ".join("--" + f.replace("_", "-") for f in used)
        raise SystemExit(
            f"{flags}: ETL-fed serving is not ported yet (ROADMAP queue 1 items "
            "11-13: the streaming pipeline, cluster and sharded engine)"
        )

    import numpy as np

    from .. import configs
    from ..models import model as M
    from ..serve.decode import ServeConfig, Server

    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    params = M.init_params(cfg, 0, device=args.device)
    sc = ServeConfig(batch=args.batch, cache_len=args.cache_len, max_new=args.max_new)
    server = Server(params, cfg, sc, device=args.device)
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
