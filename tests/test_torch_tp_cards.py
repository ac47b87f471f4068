"""The tensor-split train step and decode step over four cards: one NCCL
rank a card, a (1, 4) and a (2, 2) mesh, olmo-1b at full width and depth
(``tests/_torch_tp_ranks.py`` ``time_rank``; decode at batch 8,
``tests/_torch_decode_ranks.py`` ``decode_time_rank``).  Each rank's step seconds, the
host seconds inside its collective calls and their bytes by kind are
printed beside the card's name and power limit; the ranks must agree on
the loss (decode: on every row's token).  Correctness of the split is held
on the CPU (``tests/test_torch_tensor_parallel.py``,
``tests/test_torch_decode_mesh.py``) and on four cards by
``tests/test_torch_mesh.py -k several_cards``.  This file imports no JAX.

Run on a host with four cards:
``PYTHONPATH=src python -m pytest -q -s -m gpu tests/test_torch_tp_cards.py``.
"""

import json
import math
import subprocess

import pytest
import torch

import _torch_decode_ranks as DR
import _torch_tp_ranks as TP
from repro_torch.launch.mesh import run_on_mesh


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi failed: {err}"


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_split_step_times_over_several_cards(shape):
    n = torch.cuda.device_count()
    if n < 4:
        print(f"skip: the split step's times need 4 CUDA devices, this host has {n}")
        pytest.skip(f"needs 4 CUDA devices, this host has {n}")
    ranks = run_on_mesh(TP.time_rank, *shape, device="cuda", timeout=600)
    card = _card()
    for r in ranks:
        print(f"split step olmo-1b {TP.TIMED_BATCH}x{TP.TIMED_SEQ} mesh={shape} [{card}]: "
              + json.dumps(r), flush=True)
    losses = [r["loss"] for r in ranks]
    assert all(math.isfinite(x) for x in losses) and max(losses) - min(losses) <= 1e-6 * abs(
        losses[0]), losses
    assert all(r["bytes"].get("all-reduce", 0) > 0 for r in ranks)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_split_decode_times_over_several_cards(shape):
    n = torch.cuda.device_count()
    if n < 4:
        print(f"skip: the split decode's times need 4 CUDA devices, this host has {n}")
        pytest.skip(f"needs 4 CUDA devices, this host has {n}")
    ranks = run_on_mesh(DR.decode_time_rank, *shape, device="cuda", timeout=600)
    card = _card()
    for r in ranks:
        ms = sorted(s * 1e3 for s in r["step_s"])
        print(f"split decode olmo-1b batch {DR.TIMED['batch']} at position "
              f"{DR.TIMED['fill']} mesh={shape} [{card}]: " + json.dumps(
                  {**{k: r[k] for k in ("rank", "coordinate", "bytes")},
                   "ms_per_step_median": ms[len(ms) // 2], "ms_per_step_range": [ms[0], ms[-1]],
                   "comm_ms_per_step_median": sorted(r["comm_s"])[len(ms) // 2] * 1e3}),
              flush=True)
    assert all(r["tokens"] == ranks[0]["tokens"] for r in ranks)
    assert len(ranks[0]["tokens"]) == DR.TIMED["batch"]
    assert all(r["bytes"].get("all-reduce", 0) > 0 for r in ranks)
