"""One run of one cell: the manifest, the cell's files, the result line.

The cell's kind (``kinds/<kind>.py``, named by its traffic file) runs the
set-up, the measured window and the comparison with the plain reference
and returns an :class:`Outcome`; this module turns it into the result line.
Nothing here knows a cell by name: every file is found from the names in
``BENCHMARK.json``.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # the set-up clock: from the harness's import, torch's included

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict[str, Any]  # bench/configs/<config>.json
    traffic: Dict[str, Any]  # bench/traffic/<traffic>.json
    limits: Dict[str, float]  # bench/limits/<workload>.json "checks"
    chips: int
    end_to_end: List[Dict[str, Any]]  # the manifest's metrics this cell reports
    per_layer: List[Dict[str, Any]]


@dataclasses.dataclass
class Outcome:
    """What a kind's ``run`` returns."""

    end_to_end: Dict[str, float]
    checks: List[Tuple[str, float, float]]  # (name, reading, limit): correct iff reading <= limit
    attempted: int
    failed: int
    memory_peak_bytes: int
    window: Dict[str, Any]  # what the per-layer readers read outside the trace
    trace: Optional[Any] = None  # trace.Stretch of the traced run
    readings: Dict[str, Any] = dataclasses.field(default_factory=dict)  # extra diagnostics


@dataclasses.dataclass
class Run:
    """What a kind gets: the cell, its sizes and seeds, the device, and the
    per-layer metric readers (whose ranges and probes the traced stretch
    opens)."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    smoke: bool
    device: torch.device
    readers: Dict[str, Any]
    t_start: float  # host clock at the start of set-up
    control: bool = False  # also read the control (the reference one precision lower)

    @property
    def traffic(self) -> Dict[str, Any]:
        t = dict(self.cell.traffic)
        if self.smoke:
            t.update(t.get("smoke", {}))
        return t

    def seeds(self, n: int) -> List[int]:
        """``n`` sub-seeds of ``--seed`` (each below 2**31)."""
        return [int(s) for s in np.random.SeedSequence(self.seed).generate_state(n) % (2**31)]

    def model_fields(self) -> Dict[str, Any]:
        """The configuration's model fields (smoke sizes under ``--smoke``)."""
        f = dict(self.cell.config["model"])
        if self.smoke:
            f.update(self.cell.config.get("smoke", {}))
        return f

    def model_config(self):
        from repro_torch.models.config import ModelConfig

        return ModelConfig(**self.model_fields())

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def manifest() -> Dict[str, Any]:
    return load_json(ROOT / "BENCHMARK.json")


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, man: Optional[Dict[str, Any]] = None,
              limits: Optional[Dict[str, float]] = None) -> Cell:
    """The cell ``name`` of the manifest (``BENCHMARK.json`` unless given),
    with its files read (its limits file unless ``limits`` are given)."""
    man = man or manifest()
    work = {w["name"]: w for w in man["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    configs = {c["name"]: c for c in man["configs"]}
    return Cell(
        name=name,
        config=load_json(ROOT / configs[w["config"]]["file"]),
        traffic=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        limits=(limits if limits is not None
                else load_json(BENCH / "limits" / f"{name}.json")["checks"]),
        chips=int(w["chips"]),
        end_to_end=[m for m in man["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in man["per_layer"] if _applies(m, name)],
    )


def load_reader(name: str):
    """``bench/metrics/<name>.py`` as a module (its ``read(run)`` returns
    the metric or None, its ``RANGES`` and ``PROBES`` say what the traced
    stretch has to open)."""
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card_info(device: torch.device, chips: int, peak: int) -> Dict[str, Any]:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": peak}


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unread"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unread"


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def result_line(run: Run, out: Outcome) -> Dict[str, Any]:
    """The result as the driver reads it: ``correct`` from the checks, the
    cell's end-to-end metrics (``--trace 0``) or the per-layer metrics its
    readers find (``--trace 1``), the device, the breakdown, and the checks
    last."""
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in out.checks) and out.failed == 0
    metrics = {}
    if not run.trace:
        for m in run.cell.end_to_end:
            v = out.end_to_end.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in run.cell.per_layer:
            v = run.readers[m["name"]].read(out)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    line = {"correct": bool(correct), "attempted": int(out.attempted), "failed": int(out.failed),
            "metrics": metrics,
            "device": card_info(run.device, run.cell.chips, out.memory_peak_bytes)}
    if run.trace and out.trace is not None:
        line["device"]["busy_s"] = out.trace.busy_s
        line["device"]["window_s"] = out.trace.window_s
        line["breakdown"] = out.trace.breakdown()
    line["readings"] = out.readings
    line["checks"] = {n: {"value": float(v), "limit": lim} for n, v, lim in out.checks}
    return line


def parse(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="one cell of the repro_torch benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--smoke", action="store_true",
                   help="the configuration's smoke sizes (the CPU tests)")
    p.add_argument("--device", default="cuda", help="cuda (the benchmark) or cpu (tests)")
    p.add_argument("--control", action="store_true",
                   help="also read the control in the program's place (the control tests)")
    return p.parse_args(argv)


def execute(argv: List[str], t_start: Optional[float] = None,
            cell: Optional[Cell] = None) -> Tuple[Run, Outcome]:
    """Set up and run the cell named in ``argv`` (or ``cell``, one assembled
    outside the manifest); returns the run and its outcome.  On ``--device
    cuda`` raises ``SystemExit(2)`` without enough cards."""
    a = parse(argv)
    cell = cell or find_cell(a.workload)
    device = torch.device(a.device)
    if device.type == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < cell.chips):
        print(f"bench: {a.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        raise SystemExit(2)
    readers = {m["name"]: load_reader(m["name"]) for m in cell.per_layer}
    run = Run(cell=cell, seed=a.seed, seconds=a.seconds, trace=bool(a.trace), smoke=a.smoke,
              device=device, readers=readers, control=a.control,
              t_start=time.perf_counter() if t_start is None else t_start)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    kind = importlib.import_module(f"metlbench.kinds.{cell.traffic['kind']}")
    return run, kind.run(run)


def main(argv: List[str]) -> int:
    run, out = execute(argv, t_start=T0)
    bad = forbidden_modules()
    if bad:
        print(f"bench: modules of JAX or of the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    line = result_line(run, out)
    if run.device.type == "cuda":
        line["readings"]["card"] = power_limit()
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
