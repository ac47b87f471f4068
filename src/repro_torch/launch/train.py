"""Training launcher, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b --smoke \\
        --steps 50 --batch 8 --seq 128 --device cpu [--ckpt-dir ckpts/run0]
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b \\
        --steps 20 --batch 8 --seq 2048

Counterpart of ``python -m repro.launch.train``: the real loop
(:func:`repro_torch.train.loop.train`: synthetic ETL batches, AdamW,
checkpoints and restart) with the reference's flags, plus ``--device``
(default ``cuda``; ``cpu`` runs the plain PyTorch versions).  The
parameters come from ``init_params`` with seed 0.  ``--mesh``,
``--compress-grads`` and ``--moe-impl ep`` need the model mesh and the
data-parallel collectives (ROADMAP item 15.3) and are refused with a
message, never ignored.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

REFUSED = "needs the model mesh, ROADMAP item 15.3; the port trains on one device"


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--mesh", default=None, help="refused: " + REFUSED)
    ap.add_argument("--compress-grads", action="store_true", help="refused: " + REFUSED)
    ap.add_argument("--moe-impl", default=None, choices=["dense", "dmm", "ep"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    for flag, given in (("--mesh", args.mesh), ("--compress-grads", args.compress_grads),
                        ("--moe-impl ep", args.moe_impl == "ep")):
        if given:
            ap.error(f"{flag} {REFUSED}")

    import repro_torch.configs as configs
    from repro_torch.train.loop import TrainConfig, train
    from repro_torch.train.optimizer import AdamWConfig

    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    if args.moe_impl:
        cfg = cfg.replace(moe_impl=args.moe_impl)
    tc = TrainConfig(
        steps=args.steps,
        batch=args.batch,
        seq=args.seq,
        n_micro=args.n_micro,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        opt=AdamWConfig(lr=args.lr),
    )

    def on_step(step, m):
        print(
            f"step {step:5d}  loss {m['loss']:8.4f}  gnorm {m['grad_norm']:8.3f}  "
            f"lr {m['lr']:.2e}  wall {m['wall']:7.1f}s",
            flush=True,
        )

    out = train(cfg, tc, on_step=on_step, device=args.device)
    if out["history"]:
        print(f"final loss: {out['history'][-1]['loss']:.4f}")
    else:  # restored at or past --steps
        print(f"no step to run: the checkpoint under {args.ckpt_dir} is at --steps")


if __name__ == "__main__":
    main()
