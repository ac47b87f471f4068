"""The control of each cell's comparison: the plain reference in fp8
products (one precision below the configurations' bfloat16) put in the
program's place must come out not correct, while the program, read in the
same run, stays within every limit.  On the CPU at the smoke sizes; on the
card (marked ``gpu``) at the cell's own sizes on three seeds:

    python -m pytest -q -s -m gpu bench/test_bench_control.py
"""

import json
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

from metlbench import harness  # noqa: E402

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MAN["workloads"]]
CARD_SEEDS = (2147483713, 2718281828, 3141592653)


def control_run(cell, seed, seconds, device, smoke):
    argv = ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds), "--trace", "0",
            "--device", device, "--control"] + (["--smoke"] if smoke else [])
    run, out = harness.execute(argv)
    limits = run.cell.limits
    program = {name: value for name, value, _ in out.checks}
    control = dict(out.readings["control"])
    if "gap" in control:  # a generation cell: the numbers its limits file names
        control = {"logit_gap": control["gap"]["max"], "logit_gap_mean": control["gap"]["mean"]}
    control = {k: v for k, v in control.items() if k in limits}
    print(json.dumps({"cell": cell, "seed": seed, "program": program, "control": control,
                      "limits": limits, "readings": out.readings}, default=str), flush=True)
    return program, control, limits


def _judge(program, control, limits):
    assert all(v <= limits.get(k, 0) for k, v in program.items()), (program, limits)
    assert any(control[k] > limits[k] for k in control), (control, limits)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_at_smoke_size(cell):
    _judge(*control_run(cell, 2**31 + 3, 0.5, "cpu", True))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_on_the_card(cell, card):
    for seed in CARD_SEEDS:  # a whole window: as many rows judged as a run judges
        _judge(*control_run(cell, seed, MAN["run_seconds"], "cuda", False))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
