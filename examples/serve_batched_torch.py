"""Batched serving example: continuous batching over a static window, on
the PyTorch port.

Eight requests share four decode slots; retired slots admit queued requests.

The port's copy of ``examples/serve_batched.py``: the reference's flags and
lines, plus ``--device`` (default ``cuda``; raises without a card).  The
weights are drawn from seed 0 on the host and then moved, so every device
serves the same model.

    PYTHONPATH=src python examples/serve_batched_torch.py [--arch rwkv6_3b]
    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu
"""

import argparse

import numpy as np
import torch

import repro_torch.configs as C
from repro_torch.core.dmm_torch import resolve_device
from repro_torch.core.tree import tree_map
from repro_torch.models import model as M
from repro_torch.serve.decode import ServeConfig, Server, greedy_decode


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = C.get_smoke(args.arch)
    params = tree_map(lambda t: t.to(dev), M.init_params(cfg, 0, device="cpu"))
    rng = np.random.default_rng(0)

    # one-shot batched greedy decode
    prompt = rng.integers(2, cfg.vocab, size=(2, 5)).astype(np.int32)
    toks = greedy_decode(params, cfg, torch.from_numpy(prompt), max_new=8, cache_len=64,
                         device=dev)
    print("greedy_decode:", toks.cpu().tolist())

    # continuous batching server
    server = Server(params, cfg, ServeConfig(batch=4, cache_len=128, max_new=args.max_new),
                    device=dev)
    rids = [
        server.submit(rng.integers(2, cfg.vocab, size=int(rng.integers(2, 6))).tolist())
        for _ in range(args.requests)
    ]
    server.run(n_steps=args.requests * (args.max_new + 8))
    done = sum(1 for r in rids if r in server.done)
    print(f"completed {done}/{len(rids)} requests")
    for rid in rids[:4]:
        print(f"  request {rid}: {server.done.get(rid, 'PENDING')}")


if __name__ == "__main__":
    main()
