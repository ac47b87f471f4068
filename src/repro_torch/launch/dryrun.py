"""Dry-run entry point over the production meshes, on shapes alone.

Counterpart of ``repro.launch.dryrun``: for every (architecture x input
shape x mesh) cell, one step of the port's own code is traced on the
``meta`` device (:mod:`repro_torch.launch.dryrun_lib`) over the
single-pod (16, 16) = 256-device mesh or the multi-pod (2, 16, 16) =
512-device one, and its per-device memory, cost and collective bytes are
written as ``<out>/<arch>.<shape>.<mesh>.json``, the reference's record.
No XLA, no placeholder devices, no process group: it runs on the CPU in
seconds a cell and allocates nothing.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo_1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]

It exits 1 if any cell failed.
"""

import argparse
import json
import os


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args()

    import repro_torch.configs as configs
    from repro_torch.launch.dryrun_lib import production_mesh, run_cell

    if args.both_meshes:
        meshes = [production_mesh(multi_pod=False), production_mesh(multi_pod=True)]
    else:
        meshes = [production_mesh(multi_pod=args.multi_pod)]

    if args.all:
        cells = configs.cells()
    else:
        archs = [args.arch] if args.arch else configs.ARCHS
        shapes = [args.shape] if args.shape else list(configs.SHAPES)
        cells = [(a, s) for a in archs for s in shapes]

    os.makedirs(args.out, exist_ok=True)
    n_fail = 0
    for mesh in meshes:
        for arch, shape in cells:
            res = run_cell(arch, shape, mesh)
            n_fail += 0 if res.ok else 1
            fn = os.path.join(args.out, f"{arch}.{shape}.{res.mesh}.json")
            with open(fn, "w") as f:
                json.dump(res.to_json(), f, indent=1)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
