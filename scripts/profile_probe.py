#!/usr/bin/env python3
"""Whether ``torch.profiler`` records every flash launch of whisper-tiny's
bf16 prefill, with and without a profiler warm-up step.

    python3 scripts/profile_probe.py [--tries 6]

Builds ``flash_attention``, runs whisper-tiny at full width and depth in
bfloat16 with ``attn_impl="pallas"`` on ``chip_smoke.py`` phase 5d's inputs
(a (2, 448) prefill over (2, 1,500) frames: 8 flash launches), and profiles
the prefill ``--tries`` times each way: a plain ``profile`` around one call,
with and without phase 5d's ``av.*`` ranges, and a ``profile`` whose
``schedule`` runs one warm-up call (its events dropped) before the recorded
one.  Prints one line a profile: the flash events found, their device µs
and start offsets, and the trace's device event count.  Needs a CUDA
device.
"""

import argparse
import contextlib
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def _summary(prof) -> dict:
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    flash = sorted((e.start_ns(), e.duration_ns() / 1e3) for e in events
                   if "flash_attention" in e.name())
    first = flash[0][0] if flash else 0
    return {"flash": len(flash), "flash_us": [round(d, 1) for _, d in flash],
            "flash_at_us": [round((s - first) / 1e3, 1) for s, _ in flash],
            "device_events": len(events)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tries", type=int, default=6)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_probe: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.models import model as M

    build.build(["flash_attention"])
    dev = torch.device("cuda")
    cfg = configs.get("whisper_tiny")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    fa = cfg.replace(attn_impl="pallas")
    batch = C.av_inputs(cfg, C.SERVE_BATCH, C.WHISPER_TOKENS, seed=5, device=dev)
    for _ in range(3):
        M.forward(params, fa, batch)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    print(C.card_line(), flush=True)
    for i in range(args.tries):
        for way in ("av_ranges", "plain"):
            ranges = C.av_ranges if way == "av_ranges" else contextlib.nullcontext
            with ranges(), profile(activities=acts) as prof:
                M.forward(params, fa, batch)
                torch.cuda.synchronize()
            print(f"profile {i} {way}: " + json.dumps(_summary(prof)), flush=True)
        with C.av_ranges(), profile(activities=acts, schedule=schedule(
                wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                M.forward(params, fa, batch)
                torch.cuda.synchronize()
                prof.step()
        print(f"profile {i} warm-up step: " + json.dumps(_summary(prof)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
