"""Perf hillclimb runner: dry-run named config variants of one cell and
compare their roofline terms side by side.

Counterpart of ``repro.launch.perf``, with its variants:

    PYTHONPATH=src python -m repro_torch.launch.perf --cell llama3_405b:train_4k \
        --variants baseline,chunked_attn --out experiments/perf_torch

Each variant is a named config override of :data:`VARIANTS` (``_n_micro``
sets the microbatch count); each run is a full dry-run cell
(:func:`repro_torch.launch.dryrun_lib.run_cell`: memory, traced cost,
collectives) written to ``<out>/<arch>.<shape>.<variant>.json`` and
summarised as a table.
"""

import argparse
import json
import os

VARIANTS = {
    "baseline": {},
    # flash-style online-softmax attention: no (S,T) score materialisation
    "chunked_attn": {"attn_impl": "chunked"},
    # remat policy: keep matmul outputs, recompute elementwise only
    "remat_dots": {"remat": "dots"},
    "no_remat": {"remat": "none"},
    "chunked_attn_remat_dots": {"attn_impl": "chunked", "remat": "dots"},
    # MoE dispatch paths
    "moe_ep": {"moe_impl": "ep"},
    "moe_dmm": {"moe_impl": "dmm"},
    # rwkv time-mix form
    "rwkv_chunked": {"rwkv_impl": "chunked"},
    # microbatch count: fewer weight re-gathers vs larger live activations
    "n_micro4": {"_n_micro": 4},
    "n_micro16": {"_n_micro": 16},
    "moe_ep_chunked": {"moe_impl": "ep", "attn_impl": "chunked"},
    # EP padding waste scales with per-shard capacity; tighten it
    "moe_ep_cap1": {"moe_impl": "ep", "capacity_factor": 1.0},
    # the reference's sequence-parallel remat storage; the port ignores it
    "sp_carry": {"sp_carry": True},
    "sp_carry_nm16": {"sp_carry": True, "_n_micro": 16},
    "rwkv_scan_nm4": {"rwkv_impl": "scan", "_n_micro": 4},
    "rwkv_chunked_nm1": {"rwkv_impl": "chunked", "_n_micro": 1},
}


def run(arch: str, shape, variants, mesh, out: str, *, smoke: bool = False):
    """Dry-run each variant of ``arch:shape`` on ``mesh`` (``shape`` a name
    or a ``ShapeCell``; ``smoke``: the arch's smoke config), write its
    record under ``out``; returns the analysed rows of those that ran."""
    import dataclasses

    import repro_torch.configs as configs
    from repro_torch.launch.dryrun_lib import run_cell
    from repro_torch.launch.roofline import analyze

    base = {}
    if smoke:
        sm = configs.get_smoke(arch)
        base = {f.name: getattr(sm, f.name) for f in dataclasses.fields(sm)}
    shape_name = shape if isinstance(shape, str) else shape.name
    os.makedirs(out, exist_ok=True)
    rows = []
    for name in variants:
        res = run_cell(arch, shape, mesh, overrides={**base, **VARIANTS[name]})
        rec = res.to_json()
        rec["variant"] = name
        with open(os.path.join(out, f"{arch}.{shape_name}.{name}.json"), "w") as f:
            json.dump(rec, f, indent=1)
        if res.ok and not res.skipped:
            row = analyze(rec)
            row["variant"] = name
            row["temp_gb"] = res.memory["temp_bytes"] / 1e9
            rows.append(row)
        else:
            print(f"{name}: FAILED {res.error[:200]}")
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch:shape")
    ap.add_argument("--variants", default="baseline")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="experiments/perf_torch")
    ap.add_argument("--smoke", action="store_true", help="the arch's smoke config")
    args = ap.parse_args()

    from repro_torch.launch.dryrun_lib import production_mesh

    arch, shape = args.cell.split(":")
    mesh = production_mesh(multi_pod=args.multi_pod)
    rows = run(arch, shape, args.variants.split(","), mesh, args.out, smoke=args.smoke)

    print(f"\n== {arch} {shape} mesh={mesh.name} ==")
    print(f"{'variant':28s} {'compute_s':>10s} {'memory_s':>10s} {'coll_s':>10s} "
          f"{'bottleneck':>11s} {'roofline':>9s} {'temp_GB':>8s}")
    for r in rows:
        print(f"{r['variant']:28s} {r['compute_s']:10.3e} {r['memory_s']:10.3e} "
              f"{r['collective_s']:10.3e} {r['bottleneck']:>11s} "
              f"{r['roofline_fraction']:9.3f} {r['temp_gb']:8.1f}")


if __name__ == "__main__":
    main()
