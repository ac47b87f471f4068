"""Training launcher, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b --smoke \\
        --steps 50 --batch 8 --seq 128 --device cpu [--ckpt-dir ckpts/run0]
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b \\
        --steps 20 --batch 8 --seq 2048 [--mesh 2x2] [--compress-grads]
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh 2x2 ...

Counterpart of ``python -m repro.launch.train``: the real loop
(:func:`repro_torch.train.loop.train`: synthetic ETL batches, AdamW,
checkpoints and restart) with the reference's flags, plus ``--device``
(default ``cuda``; ``cpu`` runs the plain PyTorch versions over gloo).  The
parameters come from ``init_params`` with seed 0.

``--mesh DxM`` trains over a (data, model) mesh of D*M processes
(:func:`repro_torch.launch.mesh.run_on_mesh`: spawned here, or the ranks of
``torchrun`` when it started this command): parameters and optimizer
state sharded by the reference's specs, data-parallel compute.
``--compress-grads`` trains through the explicit data-parallel step with
the int8 all-reduce (``train(..., dp=True)``; a 1x1 mesh when ``--mesh``
is not given).  ``--moe-impl ep`` runs expert parallelism over the mesh's
``model`` axis (the dense path without a mesh, as in the reference).  Rank
0 prints the step lines and the final loss.
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def _train_rank(mesh, cfg, tc, device, dp):
    """One rank of a mesh run (on the card its own, set by ``run_on_mesh``):
    its history, the same on every rank."""
    from repro_torch.train.loop import train

    return train(cfg, tc, mesh=mesh, on_step=_print_step, device=device, dp=dp)["history"]


def _print_step(step, m):
    print(
        f"step {step:5d}  loss {m['loss']:8.4f}  gnorm {m['grad_norm']:8.3f}  "
        f"lr {m['lr']:.2e}  wall {m['wall']:7.1f}s",
        flush=True,
    )


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
    ap.add_argument("--mesh", default=None, help="DxM mesh of D*M processes, e.g. 2x2")
    ap.add_argument("--compress-grads", action="store_true",
                    help="the data-parallel step with the int8 all-reduce")
    ap.add_argument("--moe-impl", default=None, choices=["dense", "dmm", "ep"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    import os

    import repro_torch.configs as configs
    from repro_torch.launch.mesh import run_on_mesh
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
        opt=AdamWConfig(lr=args.lr, compress_grads=args.compress_grads),
    )
    mesh = args.mesh or ("1x1" if args.compress_grads else None)
    if mesh is None:
        history = train(cfg, tc, on_step=_print_step, device=args.device)["history"]
    else:
        try:
            d, m = map(int, mesh.split("x"))
        except ValueError:
            d = m = 0
        if d < 1 or m < 1:
            ap.error(f"--mesh {mesh!r}: expected DxM with D, M >= 1, e.g. 2x2")
        history = run_on_mesh(_train_rank, d, m, device=args.device,
                              args=(cfg, tc, args.device, args.compress_grads))[0]
        if int(os.environ.get("RANK", 0)) != 0:
            return
    if history:
        print(f"final loss: {history[-1]['loss']:.4f}")
    else:  # restored at or past --steps
        print(f"no step to run: the checkpoint under {args.ckpt_dir} is at --steps")


if __name__ == "__main__":
    main()
