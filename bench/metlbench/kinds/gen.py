"""A generation cell: batch jobs through ``make_serve_step``'s step, driven
as ``greedy_decode`` drives it (one token a row a step, greedy tokens fed
back on the device, no host sync in the loop).

A job is ``rows`` requests that each come through ``prompt_len`` positions
of canonical METL rows and then get ``new_tokens`` greedy tokens, over a
decode state of ``cache_len`` positions.  The traffic's ``prefill`` says
how a job gets through its first positions: ``"step"`` steps them in the
window, a fresh decode state a job (as ``greedy_decode`` does); ``"forward"``
builds them once in set-up with the program's full-sequence forward
(:mod:`metlbench.context`), and every job in the window starts from that
context, its position set back to the context's end (slots past the
position are masked), so that the window serves the last ``new_tokens``
of a long job.  Jobs follow each other until the window closes.  A step
counts when its device work ended inside the window (the rate: the
generated tokens of those steps over the time to the last one's end).
Where no job ran to its end inside the window, one more runs after the
close, uncounted, so that there are answers to judge.  After the window a
sample of rows drawn from the seed out of every finished job is judged by
the plain reference run over each row's context with its served tokens.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Dict, List

import numpy as np
import torch

from reference import decoder

from .. import compare, context, etl, weights
from ..clock import Marks
from ..harness import Outcome, Run
from ..trace import Stretch, host_range, patched, readers_hooks


def run(r: Run) -> Outcome:
    from repro_torch.models import model as M
    from repro_torch.serve import decode

    tr, dev = r.traffic, r.device
    cfg = r.model_config()
    w_seed, s_seed, pick_seed = r.seeds(3)
    R, P, N, T = tr["rows"], tr["prompt_len"], tr["new_tokens"], tr["cache_len"]
    J = tr["prepared_jobs"]
    built = tr["prefill"] == "forward"
    start = P - 1 if built else 0  # the position a job's first window step feeds
    laps: Dict[str, float] = {"import": time.perf_counter() - r.t_start}

    def lap(name: str) -> None:
        r.sync()
        laps[name] = time.perf_counter() - r.t_start - sum(laps.values())

    sc = etl.scenario(tr)
    lap("scenario")
    prompts = etl.prompts(sc, tr, s_seed, dev, cfg.vocab, J * R)  # (J * R, P)
    jobs_prompts = torch.as_tensor(prompts).to(dev).view(J, R, P)
    lap("prompts")
    params = weights.make(cfg, w_seed, dev)
    lap("weights")
    step = decode.make_serve_step(cfg)
    state = M.init_decode_state(cfg, R, T, device=dev)
    if built:  # one context for every job, kept through the window
        state = context.fill(params, cfg, state, jobs_prompts[0][:, :start], tr["prefill_rows"])
        lap("context")
    tok = jobs_prompts[0][:, start]
    for _ in range(2):  # warm-up: this cell's shapes
        tok, _, state = step(params, state, tok)
    ctx = {**state, "pos": start} if built else None
    del state
    lap("warmup")
    setup_s = time.perf_counter() - r.t_start

    def fresh() -> Dict[str, Any]:
        return dict(ctx) if built else M.init_decode_state(cfg, R, T, device=dev)

    def job(j: int, budget: float, marks: Marks, log: Dict[str, Any]) -> None:
        """Job ``j`` until its end or until the host clock passes
        ``budget``; marks each step and keeps the tokens it generates."""
        prompt = jobs_prompts[j % J]
        state = fresh()
        tok = prompt[:, start]
        for t in range(start + 1, P + N):
            nxt, _, state = step(params, state, tok)
            log["marks"].append(marks.mark())
            if t >= P:
                log["tokens"].append(nxt)
                tok = nxt
            else:
                tok = prompt[:, t]
            if time.perf_counter() > budget:
                return

    # the window
    per_job = P + N - 1 - start  # steps a job takes
    marks = Marks(dev)
    jobs: List[Dict[str, Any]] = []
    marks.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < r.seconds:
        log = {"index": len(jobs), "marks": [], "tokens": []}
        jobs.append(log)
        job(log["index"], t0 + r.seconds, marks, log)
    wall = time.perf_counter() - t0
    if all(len(log["marks"]) < per_job for log in jobs):
        # no job finished inside the window: one more runs to its end after
        # the close, so that answers are judged (late, not wrong; not counted)
        log = {"index": len(jobs), "marks": [], "tokens": []}
        jobs.append(log)
        job(log["index"], float("inf"), marks, log)
    times = marks.seconds()
    decode_steps, gaps, step_pos = 0, [], []
    for log in jobs:
        ts = [times[i] for i in log["marks"]]
        inside = [t for t in ts if t <= r.seconds]
        gaps += list(np.diff(inside))
        step_pos += [start + i for i in range(len(inside))]
        decode_steps += sum(1 for t in ts[P - 1 - start:] if t <= r.seconds)
    finished = [log for log in jobs if len(log["marks"]) == per_job]
    # the rate's time: from the window's start to the end of its last step
    span = max((t for t in times if t <= r.seconds), default=r.seconds)
    window = {"kind": "gen", "cfg": cfg, "traffic": tr, "seconds": span,
              "steps": len(step_pos), "step_pos": step_pos, "decode_steps": decode_steps,
              "wall_s": wall}

    stretch = None
    if r.trace:
        probe_state: Dict[str, Any] = {}
        ranges, probes = readers_hooks(r.readers, probe_state)
        stretch = Stretch(dev)
        # steady decode steps at a job's middle position
        state = fresh()
        state["pos"] = start + per_job // 2
        tok = jobs_prompts[len(jobs) % J][:, 0]
        with patched(ranges, probes), stretch.record():
            for _ in range(tr["trace_steps"]):
                with host_range("bench.serve_step", True):
                    tok, _, state = step(params, state, tok)
        stretch.steps = tr["trace_steps"]
        window["probes"] = probe_state
        # host time to enqueue one step, with the launch queue drained first
        host = []
        for _ in range(tr["host_steps"]):
            r.sync()
            h0 = time.perf_counter()
            tok, _, state = step(params, state, tok)
            host.append(time.perf_counter() - h0)
        window["host_step_s"] = host
        del state
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    # the sample: rows drawn from the seed out of every finished job, each
    # row's context and prompt with its served tokens
    rng = np.random.default_rng(pick_seed)
    seqs = []
    for log in finished:
        pick = sorted(rng.choice(R, size=min(tr["sample_rows"], R), replace=False).tolist())
        seqs.append(torch.cat([jobs_prompts[log["index"] % J][pick].long(),
                               torch.stack(log["tokens"], dim=1)[pick].long()], dim=1))
    seqs = torch.cat(seqs) if seqs else None
    del params, step, jobs_prompts, ctx
    for log in jobs:
        log["tokens"] = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref_prompts = etl.token_stream(sc, tr, s_seed, cfg.vocab, J * R * P, per_row=tr["row_tokens"])
    mismatch = compare.mismatches(prompts, np.asarray(ref_prompts, np.int32).reshape(J * R, P))
    readings: Dict[str, Any] = {"setup_s": setup_s, "setup_laps": laps,
                                "jobs_finished": len(finished), "jobs_started": len(jobs),
                                "decode_steps": decode_steps,
                                "judged_rows": 0 if seqs is None else int(seqs.shape[0])}
    gap = {"max": float("inf"), "mean": float("inf")}
    if seqs is not None:
        W = weights.make(cfg, w_seed, dev)
        fields = r.model_fields()
        gap = readings["gap"] = compare.gaps_summary(decoder.token_gaps(W, fields, seqs, P)[0])
        if r.control:  # the token the reference in fp8 products puts first, judged
            readings["control"] = {"gap": compare.gaps_summary(
                decoder.token_gaps(W, fields, seqs, P, quant=True)[0])}
            if fields.get("n_experts"):  # the reference with its router fed bf16 inputs
                readings["control"]["router_bf16_gap"] = compare.gaps_summary(
                    decoder.token_gaps(W, fields, seqs, P, router_bf16=True)[0])
        del W
    # the widest gap, and where a configuration's own routing makes the widest
    # swing (PERF.md), the mean gap: the cell's limits file names its numbers
    numbers = {"logit_gap": gap["max"], "logit_gap_mean": gap["mean"]}
    checks = [("etl_mismatch", mismatch, 0)]
    checks += [(k, numbers[k], lim) for k, lim in r.cell.limits.items()]
    interval = float(np.percentile(np.asarray(gaps) * 1e3, 95)) if gaps else None
    return Outcome(
        end_to_end={"gen_tokens_per_s": decode_steps * R / span,
                    "token_interval_p95_ms": interval, "setup_s": setup_s},
        checks=checks, attempted=len(jobs) * R, failed=0,
        memory_peak_bytes=int(peak), window=window, trace=stretch, readings=readings)
