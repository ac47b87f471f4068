"""Roofline analysis over dry-run artifacts, priced for the NVIDIA H100.

Counterpart of ``repro.launch.roofline``, with the same functions and
record keys: it reads the port's dry-run artifacts
(:mod:`repro_torch.launch.dryrun`) and the reference's alike.

Hardware model (one H100 SXM5 80GB HBM3):
    peak compute   989 TFLOP/s dense bf16 (NVIDIA's datasheet)
    HBM bandwidth  measured: a device-to-device copy of 1 GiB, bytes read
                   plus written over its time (``chip_smoke.py`` phase 9)
    PCIe link      measured: a pinned host-to-device copy of 256 MiB
                   (phase 9)
    launch         measured: host seconds a launch of an empty kernel, 4096
                   launches issued from one C call, as the engines' chunk
                   launchers issue theirs (phase 9)
    NVLink         450 GB/s a direction a GPU (NVLink 4, 900 GB/s both
                   directions; NVIDIA's datasheet).  Intra-node: a
                   collective that crosses nodes runs slower.  Phase 8's
                   gloo collectives go through host memory and do not
                   calibrate this term.

Each measured constant names the card and power limit it was read on, as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
them; phase 9 prints each beside its measurement on every run and fails if
one is off by more than a factor 2.

Terms (seconds per step, per device -- dry-run numbers are per device):
    compute    = flops / PEAK_FLOPS
    memory     = bytes_accessed / HBM_BW
    collective = sum(collective result bytes) / NVLINK_BW

The roofline *fraction* reported is ideal/achievable:
    ideal      = MODEL_FLOPS / (devices * PEAK_FLOPS)   (the 6*N*D floor)
    achievable = max(compute, memory, collective)       (the dominant wall)
so fraction == 1.0 means the step is pure useful matmul at peak.  The
useful-FLOPs ratio, MODEL_FLOPS over the flops of every device together,
exposes remat, attention and repeated compute (the parts of a step that
the port does not split over ``model``, :mod:`repro_torch.launch.dryrun_lib`).

**ETL mode** (``--etl ARTIFACT.json``) puts mapping-engine configurations
on the same card.  An artifact's ``engines`` entries carry, per chunk,
``dispatches`` (kernel launches), ``host_bytes`` (host-to-device bytes),
``device_bytes`` (bytes the launches must move on the card),
``chunk_events`` and the measured ``events_per_s`` (``chip_smoke.py`` phase
9 writes one from its consume paths).  A consume chunk does no meaningful
FLOPs, so the walls are

    transfer = host_bytes / PCIE_BW
    memory   = device_bytes / HBM_BW
    launch   = dispatches * LAUNCH_S

and ``roof_events_per_s`` = chunk_events / max(walls): the most a path
could map if the card and its link did nothing else.  A measured rate above
it is impossible; far below it, the host holds the card back.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional

PEAK_FLOPS = 989e12  # H100 SXM5 dense bf16, NVIDIA's datasheet
# measured by chip_smoke.py phase 9 (a) on NVIDIA H100 80GB HBM3, 700.00 W:
HBM_BW = 2.908e12  # device-to-device copy of 1 GiB, read + write bytes (2.9078e12)
PCIE_BW = 5.032e10  # pinned host-to-device copy of 256 MiB (5.0318e10)
LAUNCH_S = 2.918e-6  # host s a launch, 4096 empty-kernel launches from one C call
NVLINK_BW = 450e9  # NVLink 4, one direction a GPU, intra-node; NVIDIA's datasheet

__all__ = [
    "analyze",
    "analyze_dir",
    "render_table",
    "analyze_etl",
    "render_etl_table",
]


def analyze(rec: Dict) -> Optional[Dict]:
    if not rec.get("ok") or rec.get("skipped"):
        return None
    cost = rec.get("cost") or rec.get("cost_scanned")
    if not cost:
        return None
    n = rec["n_devices"]
    coll = sum((rec.get("collectives") or {}).values())
    compute_t = cost["flops"] / PEAK_FLOPS
    memory_t = cost["bytes_accessed"] / HBM_BW
    coll_t = coll / NVLINK_BW
    terms = {"compute": compute_t, "memory": memory_t, "collective": coll_t}
    bottleneck = max(terms, key=terms.get)
    ideal = rec["model_flops_global"] / (n * PEAK_FLOPS)
    achievable = max(terms.values())
    frac = ideal / achievable if achievable > 0 else 0.0
    useful = rec["model_flops_global"] / (cost["flops"] * n) if cost["flops"] else 0.0
    hints = {
        "compute": "cut repeated and non-model FLOPs: split what is still repeated over "
        "model (the SSM parts, heads that do not divide), remat policy, fused CE",
        "memory": "raise arithmetic intensity: fuse elementwise chains, "
        "bf16 intermediates, flash attention in place of the score matrix",
        "collective": "cut the bytes moved: overlap the layer gathers with compute, "
        "sequence-parallel all-reduces, fewer microbatch regathers",
    }
    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "mesh": rec["mesh"],
        "compute_s": compute_t,
        "memory_s": memory_t,
        "collective_s": coll_t,
        "bottleneck": bottleneck,
        "ideal_s": ideal,
        "roofline_fraction": frac,
        "useful_flops_ratio": useful,
        "hbm_gb": (rec.get("memory") or {}).get("temp_bytes", 0) / 1e9
        + (rec.get("memory") or {}).get("argument_bytes", 0) / 1e9,
        "hint": hints[bottleneck],
    }


def analyze_dir(path: str, mesh: Optional[str] = None) -> List[Dict]:
    rows = []
    for fn in sorted(glob.glob(os.path.join(path, "*.json"))):
        with open(fn) as f:
            rec = json.load(f)
        if mesh and rec.get("mesh") != mesh:
            continue
        row = analyze(rec)
        if row:
            rows.append(row)
    return rows


def render_table(rows: List[Dict]) -> str:
    hdr = (
        "| arch | shape | mesh | compute s | memory s | collective s | "
        "bottleneck | ideal s | roofline frac | useful-FLOPs | HBM GB/dev |\n"
        "|---|---|---|---|---|---|---|---|---|---|---|\n"
    )
    lines = []
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['compute_s']:.3e} | {r['memory_s']:.3e} | {r['collective_s']:.3e} "
            f"| **{r['bottleneck']}** | {r['ideal_s']:.3e} "
            f"| {r['roofline_fraction']:.2f} | {r['useful_flops_ratio']:.2f} "
            f"| {r['hbm_gb']:.1f} |"
        )
    return hdr + "\n".join(lines) + "\n"


def analyze_etl(artifact: Dict) -> List[Dict]:
    """Place every engine configuration of an artifact's ``engines`` on the
    ETL roofline (module docstring): the walls, the bottleneck, the
    ceiling ``roof_events_per_s`` and the measured ``events_per_s``."""
    rows = []
    for e in artifact.get("engines", []):
        transfer_t = e["host_bytes"] / PCIE_BW
        memory_t = e["device_bytes"] / HBM_BW
        launch_t = e["dispatches"] * LAUNCH_S
        terms = {"transfer": transfer_t, "memory": memory_t, "launch": launch_t}
        bottleneck = max(terms, key=terms.get)
        wall = max(terms.values())
        rows.append(
            {
                "engine": e["engine"],
                "chunk_events": e["chunk_events"],
                "dispatches": e["dispatches"],
                "host_bytes": e["host_bytes"],
                "device_bytes": e["device_bytes"],
                "transfer_s": transfer_t,
                "memory_s": memory_t,
                "launch_s": launch_t,
                "bottleneck": bottleneck,
                "roof_events_per_s": e["chunk_events"] / wall if wall > 0 else 0.0,
                "measured_events_per_s": e.get("events_per_s"),
            }
        )
    return rows


def render_etl_table(rows: List[Dict]) -> str:
    hdr = (
        "| engine | disp/chunk | host B/chunk | device B/chunk | "
        "transfer s | memory s | launch s | bottleneck | roof ev/s | "
        "measured ev/s |\n"
        "|---|---|---|---|---|---|---|---|---|---|\n"
    )
    lines = []
    for r in rows:
        meas = (
            f"{r['measured_events_per_s']:.0f}"
            if r.get("measured_events_per_s")
            else "-"
        )
        lines.append(
            f"| {r['engine']} | {r['dispatches']} | {r['host_bytes']} "
            f"| {r['device_bytes']} | {r['transfer_s']:.2e} "
            f"| {r['memory_s']:.2e} | {r['launch_s']:.2e} "
            f"| **{r['bottleneck']}** | {r['roof_events_per_s']:.3e} | {meas} |"
        )
    return hdr + "\n".join(lines) + "\n"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--etl", default=None, metavar="ARTIFACT_JSON",
                    help="ETL mode: roofline the engine configurations of an artifact "
                         "with an 'engines' list instead of the dry-run directory")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()
    if args.etl:
        with open(args.etl) as f:
            artifact = json.load(f)
        rows = analyze_etl(artifact)
        if args.json:
            print(json.dumps(rows, indent=1))
        else:
            print(render_etl_table(rows))
            for r in rows:
                print(f"- {r['engine']}: {r['bottleneck']}-bound")
        return
    rows = analyze_dir(args.dir, args.mesh)
    if args.json:
        print(json.dumps(rows, indent=1))
    else:
        print(render_table(rows))
        for r in rows:
            print(f"- {r['arch']}/{r['shape']}/{r['mesh']}: {r['bottleneck']}-bound; {r['hint']}")


if __name__ == "__main__":
    main()
