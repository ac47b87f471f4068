#!/usr/bin/env python3
"""Drive the PyTorch port's consume paths (fused, sharded and per-block),
its streaming pipeline, cluster and initial load, and its olmo-1b server,
alone and fed by the pipeline, on one NVIDIA card and check them.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs a CUDA device and the repository's ``src/repro_torch``; without
either it exits non-zero before printing any result.  Phases, in order (any
failure raises and the script exits non-zero):

1. print the card's name and power limit (``nvidia-smi``);
2. build the six CUDA libraries from ``src/repro_torch/kernels/csrc`` into
   ``build/`` (one ``nvcc`` per source, started together; eight kernels:
   ``segmented_gather.cu`` and ``densify_map.cu`` also hold the sharded
   engine's ``segmented_gather_shard`` and ``densify_map_shard``; the
   per-block libraries also hold the engine's chunk launchers), and the
   empty kernel of ``launch_floor.cu``, and print their
   ``ptxas`` register and spill lines, and the count of ``HGMMA`` (tensor-
   core ``wgmma``) instructions in the ``flash_attention`` library's SASS
   (``cuobjdump -sass``; 0 fails);
3. hold each kernel against its plain PyTorch version on the card:
   ``segmented_gather`` bit for bit over a shape sweep with ``fill`` 0 and
   0.25; ``densify_map`` bit for bit over random packed chunks with
   duplicate slots, unknown, out-of-range and foreign-column uids and up to
   32 items per event; ``masked_gather`` bit for bit and ``onehot_map``
   (masks bit for bit, values within ``atol=1e-5``: its float32 sum runs in
   another order) over the sweep of ``tests/test_kernels.py`` (shapes
   (1, 1, 128) to (130, 1000, 384), float32 and bfloat16, densities 0 to 1,
   ``fill`` 0 and 0.25), plus a non-finite event row for ``onehot_map``;
   ``flash_attention`` over the shapes of ``tests/test_kernels_flash.py`` in
   float32 (its FFMA kernel) and bfloat16 (its tensor-core kernel), ragged
   non-causal T, causal S > T with ragged T, head dims 8, 16, 24, 40, 72
   and 120, and the olmo-1b, phi3-medium (n_rep 4) and llama3-405b (n_rep
   16) head layouts at hd 128 (float32 atol 3e-5 / rtol 1e-4, the reference
   tests' tolerance; bfloat16 atol 5e-3 / rtol 1e-2, a limit that three
   planted faults -- p in float8, a skipped key tile, an off-by-one
   diagonal -- must fail at the largest causal shape and at the prefill's);
   ``moe_combine`` over the sweep of ``tests/test_kernels.py`` and the
   qwen3-moe group shape (T 512, E 128, C 40, D 2048), each at 1, 2, 4 and
   8 weights a token, every weight and none, then with inf and NaN planted
   in expert_out and in combine (float32 atol 1e-4, bfloat16 0.1, rtol
   1e-2; non-finite outputs exactly where the plain version has them; a
   repeat call bit-identical); ``segmented_gather_shard`` and
   ``densify_map_shard`` bit for bit over random cases with 2-8 shards,
   padded and empty ones (``SHARD_*_CASES``), each also on a sub-range of
   its shards and, shard by shard, against its base kernel; and
   ``densify_map`` / ``densify_map_shard`` bit for bit on the edges of their
   warp-per-row body (``DENSIFY_EDGE_CASES``: K 1 to 64, widths 3, 127, 130
   and 384, 1-8 shards and a sub-range, a table 4 bytes off alignment),
   each case also through ``densify_map_chunk`` (the engines' route: copy
   from a pinned arena and launch in one C call, which must report 1 copy
   and 1 launch); ``segmented_gather`` / ``segmented_gather_shard`` bit for
   bit on the edges of their warp-per-row body (``GATHER_EDGE_CASES``:
   widths 3, 127, 130, 256 and 384, one payload column, operands off
   alignment, out-of-range routing and table entries held against the
   plain version on the clamped ones, NaN and inf payloads, a shard with no
   live rows), each case also through ``segmented_gather_chunk`` (four
   copies from a pinned arena and the launch in one C call, which must
   report 4 copies and 1 launch);
4. consume 64 chunks of 512 events of the paper-scale scenario (128 schemas
   x 10 versions x 10 attributes, 40 business entities of 25 attributes)
   through ``METLApp`` on the card six ways -- the fused engine with host
   densify and with ``device_densify=True``, the sharded engine
   (``engine="sharded"``, 4 shards on the card) with each, and the
   per-block engine with ``engine="blocks"`` (``masked_gather``) and with
   ``impl="onehot"`` (``onehot_map``) -- with one ``SchemaEvolved`` applied
   at chunk 32; check each chunk's accounting (fused and sharded: one
   dispatch, 4 or 1 transfers; per-block: one call into the kernel
   library's launcher a chunk, one dispatch per block its groups touch, 2
   transfers per group, as the launcher reports them; on the card one
   launch of the path's kernel per dispatch, the sharded paths' of its
   shard kernel); then
   compare every row and every stats counter with the same stream through
   ``device="cpu"`` apps (the plain versions), and the sharded and
   per-block rows with the fused rows (the fused and sharded paths' counts
   are the ones the chunk's one C call reports); each path's line also
   prints the plan layer after the evolution's build (``plan at chunk
   32``: its epoch, ``rebuild_ms``, ``incremental``, ``touched_columns``
   and ``bytes_resident``, per shard too on the sharded paths), and the run
   fails unless the default plan manager spliced it;
4b. the plan lifecycle at the full size of ``benchmarks/bench_compaction.
   py``'s soak (``soak_config()``: 80 schemas x 6 versions, 36 chunks of
   256 events, 16 schema evolutions every 2 chunks from chunk 1): arm A
   (incremental), arm B (full rebuilds), arm C (incremental and tiered,
   only the latest versions resident) and arm A with the background build
   on the card, and arm A on the CPU; one ``plan lifecycle arm`` line each
   (churn rebuild ms in all and per cutover, first build ms, chunk ms p50
   and p99, events/s, bytes resident) and one for arm C's cold path (cold
   columns, tier misses, ``masked_gather`` launches, the copies to the card
   and readbacks it made); the run fails unless A's row keys equal B's in
   order, A's rows and stats equal the CPU run's, C's and the background
   arm's rows equal A's (C by key), A made 16 incremental builds and B
   none, and C kept columns cold, missed, holds fewer resident bytes than
   A and launched ``masked_gather`` and no other kernel but the resident
   path's;
4c. the streaming pipeline on step 4's stream, the evolution now delivered
   in band (``EventChunkSource(control={32: ev})``): ``Pipeline`` sync,
   async and async with ``densify_thread=True`` on fused host densify, and
   async on fused device densify, both sharded paths and ``engine=
   "blocks"``; rows and ``stats`` must equal step 4's run of the path bit
   for bit (so each async run equals its sync run), each dispatch's
   accounting must be step 4's (``check_accounting``, through an observer
   on ``engine.dispatch``) and ``PipelineStats.control`` 1; backpressure:
   async fused host densify into a bounded ``CollectSink`` that fills
   mid-stream, drained and resumed until the source ends, rows equal to the
   unbounded run's (a stop keeps its lookahead chunk for the resume to
   flush); ``Cluster.over_stream`` with 4 async instances, rows equal to
   one instance's in order, one state; ``initial_load`` of 8,192 events
   over 4 instances with threads on the card, rows equal to a sequential
   load on the card and one on the CPU; the launcher once at olmo-1b's full
   width with ``--etl --instances 2 --shards 4 --async-consume
   --device-densify`` (every request completes), and ``_etl_prompts`` on
   the card equal to the CPU's for six ETL flag combinations; then the
   ``pipeline rates`` line: events/s of sync, async and the densify thread
   over chunks 33-63 of fused host, fused device and sharded host densify,
   5 interleaved passes each on a fresh app (median, min, max), and the
   device busy share of one async pass under ``torch.profiler``;
5. serve olmo-1b at full width (16 layers, d_model 2048, random weights
   from a seeded ``torch.Generator``): (a) the prefill ``forward`` with
   ``attn_impl="pallas"`` over a (2, 2048) prompt batch, 16 launches of
   ``flash_attention`` per call and no other kernel, held against the
   dense ``forward`` in bfloat16 (max abs error and argmax agreement
   printed; agreement >= 0.9 required) and in float32 (atol 2e-3, rtol
   1e-3), the bfloat16 prefill's 16 flash launches all going to the
   tensor-core kernel (the profiler's device events name it 16 times and
   no other flash kernel); (b) 32
   ``decode_step`` logits against the prefill's (teacher
   forcing; float32 at the same tolerance); (c) a ``Server`` (batch 8,
   cache 1024, 32 new tokens) answering 16 requests of 4-32 prompt tokens,
   each with 32 tokens; (d) the same path at 2 layers in float32 on the card
   and on the CPU (plain versions): logits within atol 1e-3 / rtol 1e-3 and
   equal ``Server`` tokens; then prefill tokens/s, decode ms per step and
   tokens/s at batch 8, and from ``torch.profiler`` the device busy share of
   a prefill and ``flash_attention``'s share of its device time;
   the consume stage split of every path under ``torch.profiler`` (the
   ``stages`` lines), and for the per-block paths, without the profiler,
   host microseconds per dispatched block through the launcher and through
   the op-level route (per group ``pin_memory`` and ``.to``, per block
   ``ops.dmm_apply``) (``per-block host``); for the device-densify paths,
   without the profiler, host microseconds per chunk of dispatch and emit
   through the engine's route (pinned arena, one C call, one readback) and
   through the op-level route (``pin_memory``, ``.to``,
   ``ops.dmm_apply_columnar*``, two ``.cpu()``), in turns chunk by chunk
   (``device-densify host``); the same for the host-densify paths, whose
   engine route is a pinned arena, one C call for four copies and the
   launch and one readback, and whose op-level route is ``np.pad``,
   ``pin_memory`` and ``.to`` of four arrays, ``ops.dmm_apply_fused`` /
   ``dmm_apply_sharded`` and two ``.cpu()`` (``host-densify host``);
6. time each kernel at the main path's shapes beside its plain version and
   a PyTorch yardstick, L2-hot and cold, count the bytes and the operations
   each call must do on this data for its bound, and print the ``kernels``
   line with all eight; ``flash_attention`` also with its TFLOP/s and its
   share of the bound; ``moe_combine`` also at the dbrx group and with a
   fully dense combine, each beside ``torch.matmul``; time an empty kernel
   the same way (the ``launch floor`` line) and state each kernel's time as
   a multiple of it (``floor_multiple`` in its ``timing`` line); time
   ``segmented_gather``, ``densify_map`` and their shard kernels also on an
   8,192-event chunk after the evolution (the ``timing ... 8192`` lines,
   bit for bit against the plain version there too).

The last line of standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ctypes
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet
FP32_LANES_PER_SM = 128  # Hopper: 128 float32 FMA units per SM (each FMA is 2 operations)
CHUNKS, CHUNK_EVENTS, EVOLVE_AT = 64, 512, 32
BIG_CHUNK_EVENTS = 8192  # the fused and sharded kernels' second timing shape
ONEHOT_ATOL = 1e-5  # float32 sum order; tests/test_kernels.py holds the Pallas kernel so
# the per-block stage split runs under the profiler, whose cost grows with
# the ~1,200 device operations a per-block chunk makes: fewer chunks there
BLOCK_STAGE_CHUNKS = 8
START = time.perf_counter()


def elapsed() -> str:
    return f"[{time.perf_counter() - START:.1f} s]"
COLD_COPIES = 192  # operand copies rotated for a cold time: ~190 MB, past the 50 MB L2
SG_SWEEP = [  # (b, n_in, w) x (n_blocks, s), as the reference kernel tests
    (b, n_in, w, nb, s)
    for (b, n_in, w) in [(8, 64, 128), (37, 300, 256), (64, 128, 128)]
    for (nb, s) in [(8, 16), (16, 130)]
]
# (B, N_in, N_out) as tests/test_kernels.py, plus an output width that is no
# multiple of 128 (the port lifts the reference's tiling rule)
BLOCK_SHAPES = [(1, 1, 128), (8, 10, 128), (37, 300, 256), (130, 1000, 384),
                (256, 128, 128), (9, 20, 130)]
KERNEL_NAMES = ("segmented_gather", "densify_map", "masked_gather", "onehot_map",
                "flash_attention", "moe_combine", "segmented_gather_shard",
                "densify_map_shard")
SHARDS = 4  # the sharded paths' shards, all on the one card
PEAK_BF16_PER_S = 989e12  # H100 SXM bf16 dense tensor-core peak, NVIDIA's data sheet
COLD_BYTES = 190e6  # operands rotated for a cold time: past the 50 MB L2
# flash_attention against its plain version: float32 (the FFMA kernel) at the
# reference tests' tolerance (tests/test_kernels_flash.py); bfloat16 (the
# tensor-core kernel) at a limit set from its arithmetic, tighter than the
# reference's 3e-2: rtol covers one bf16 ulp of the output (at most 2^-7 of
# it), atol the rounding of p to bf16 before p.v (2^-9 of each weight; at
# most 0.0027 over FLASH_CASES in the CPU emulation of
# tests/test_torch_flash_tc.py).  Every planted fault of flash_fault_ref fails
# it (flash_limit_power).
FLASH_TOL = {torch.float32: (3e-5, 1e-4), torch.bfloat16: (5e-3, 1e-2)}
REF_BF16_TOL = (3e-2, 3e-2)  # tests/test_kernels_flash.py's, for the library call
FLASH_FAULTS = ("p_fp8", "skip_tile", "diag_plus_1")
# the reference tests' tolerances (tests/test_kernels.py)
MOE_TOL = {torch.float32: (1e-4, 1e-2), torch.bfloat16: (0.1, 1e-2)}
# the serving path: float32 logits of two algorithms or two devices (sums in
# other orders through 16 layers, logits of O(10))
SERVE_F32_TOL = (2e-3, 1e-3)
CARD_CPU_TOL = (1e-3, 1e-3)
BF16_ARGMAX_AGREE = 0.9


def _paper_config():
    from repro_torch.core.synthetic import ScenarioConfig

    # the paper's deployment: >80 microservices, >10,000 extraction
    # attributes, >1,000 CDM attributes, >=10 versions per schema
    return ScenarioConfig(
        n_schemas=128, versions_per_schema=10, attrs_per_version=10,
        n_entities=40, cdm_attrs=25, seed=11,
    )


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    elif a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return bool(torch.equal(a, b))


def _smi(query: str, fmt: str = "csv,noheader") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def card_line() -> str:
    return _smi("name,power.limit")


def sass_count(name: str, opcode: str) -> int:
    """Lines holding ``opcode`` in the SASS of kernel ``name``'s built
    library (``cuobjdump -sass``, from the CUDA toolkit)."""
    from repro_torch.kernels import build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build.library_path(name))], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    return sum(opcode in line for line in sass.splitlines())


def fp32_peak_per_s() -> tuple:
    """The card's float32 CUDA-core peak, operations per second: SMs x
    128 FMA lanes x 2 operations x the maximum SM clock ``nvidia-smi``
    reports.  Returns (peak, SM count, clock MHz)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(_smi("clocks.max.sm", "csv,noheader,nounits"))
    return sms * FP32_LANES_PER_SM * 2 * mhz * 1e6, sms, mhz


# -- phase 3: kernels against their plain versions ---------------------------


def check_segmented_gather(device: torch.device) -> int:
    from repro_torch.kernels.ref import segmented_gather_ref
    from repro_torch.kernels.segmented_gather import segmented_gather

    n = 0
    for b, n_in, w, n_blocks, s in SG_SWEEP:
        rng = np.random.default_rng(hash((b, n_in, w, n_blocks, s)) % 2**31)
        vals = rng.normal(size=(b, n_in)).astype(np.float32)
        mask = (rng.random((b, n_in)) < 0.7).astype(np.int8)
        src2d = np.full((n_blocks, w), -1, np.int32)
        for blk in range(n_blocks):
            k = int(0.5 * min(n_in, w))
            src2d[blk, rng.choice(w, size=k, replace=False)] = rng.choice(
                n_in, size=k, replace=False
            )
        rows = rng.integers(b, size=s).astype(np.int32)
        blks = rng.integers(n_blocks, size=s).astype(np.int32)
        args = [torch.from_numpy(a).to(device) for a in (vals, mask, rows, blks, src2d)]
        for fill in (0.0, 0.25):
            kv, km = segmented_gather(*args, fill=fill)
            rv, rm = segmented_gather_ref(*args, fill=fill)
            if not (_bits_equal(kv, rv) and _bits_equal(km, rm)):
                raise AssertionError(
                    f"segmented_gather != plain at b={b} n_in={n_in} w={w} "
                    f"n_blocks={n_blocks} s={s} fill={fill}"
                )
            n += 1
    return n


def _random_packed(rng, *, n_events, k_max, k, n_uid, n_cols, n_rows, n_blocks, w=128):
    """A packed device-densify chunk with every drop case: duplicate slots in
    one event, unknown uids (table holes), out-of-range and negative uids,
    uids of another column, and CSR padding; and a (n_blocks, w) table."""
    uid_slot = rng.integers(0, 40, size=n_uid).astype(np.int32)
    uid_col = rng.integers(0, n_cols, size=n_uid).astype(np.int32)
    holes = rng.random(n_uid) < 0.1
    uid_slot[holes] = -1
    uid_col[holes] = -1
    counts = rng.integers(0, k_max + 1, size=n_events).astype(np.int32)
    uids, vals, starts = [], [], []
    for e in range(n_events):
        starts.append(len(uids))
        for j in range(counts[e]):
            r = rng.random()
            if r < 0.1 or n_uid == 0:
                u = int(rng.choice([-3, n_uid, n_uid + 7, 2**31 - 1]))
            elif r < 0.25 and j > 0:
                u = uids[-1]  # duplicate slot: the last writer must win
            else:
                u = int(rng.integers(0, n_uid))
            uids.append(u)
            vals.append(np.float32(rng.normal()))
    ev_col = rng.integers(0, n_cols, size=n_events).astype(np.int32)
    ni = max(8, len(uids))
    items_u = np.full(ni, -1, np.int32)
    items_u[: len(uids)] = uids
    items_v = np.zeros(ni, np.float32)
    items_v[: len(vals)] = vals
    src2d = rng.integers(-1, 40, size=(n_blocks, w)).astype(np.int32)
    rows = rng.integers(0, n_events, size=n_rows).astype(np.int32)
    blks = rng.integers(0, n_blocks, size=n_rows).astype(np.int32)
    packed = np.concatenate([
        items_u, items_v.view(np.int32), np.asarray(starts, np.int32), counts,
        ev_col, rows, blks,
    ]).astype(np.int32)
    return packed, uid_slot, uid_col, src2d, dict(
        n_items=ni, n_events=n_events, n_rows=n_rows, k=k
    )


def check_densify_map(device: torch.device) -> int:
    from repro_torch.kernels.densify_map import densify_map
    from repro_torch.kernels.ref import densify_map_packed_ref

    n = 0
    # (events, most items in an event, K, uid-table size, output rows); K
    # below the most items checks that items past K are ignored
    for seed, (n_events, k_max, k, n_uid, n_rows) in enumerate(
        [(24, 7, 8, 60, 50), (64, 32, 32, 200, 512), (130, 16, 16, 1, 260),
         (9, 32, 32, 0, 16), (200, 3, 4, 500, 1000), (50, 20, 8, 100, 64)]
    ):
        rng = np.random.default_rng(1000 + seed)
        packed, slot, col, src2d, sizes = _random_packed(
            rng, n_events=n_events, k_max=k_max, k=k, n_uid=n_uid, n_cols=5,
            n_rows=n_rows, n_blocks=16,
        )
        args = [torch.from_numpy(a).to(device) for a in (packed, slot, col, src2d)]
        for fill in (0.0, 0.25):
            kv, km = densify_map(*args, fill=fill, **sizes)
            rv, rm = densify_map_packed_ref(*args, fill=fill, **sizes)
            if not (_bits_equal(kv, rv) and _bits_equal(km, rm)):
                raise AssertionError(f"densify_map != plain at case {seed} fill={fill}")
            n += 1
    # last writer wins: one event, K items all on slot 3, values 0..K-1
    k = 32
    packed = np.concatenate([
        np.zeros(k, np.int32), np.arange(k, dtype=np.float32).view(np.int32),
        np.int32([0]), np.int32([k]), np.int32([0]), np.int32([0]), np.int32([0]),
    ]).astype(np.int32)
    src2d = np.full((8, 128), -1, np.int32)
    src2d[0, 5] = 3
    args = [torch.from_numpy(a).to(device) for a in (
        packed, np.int32([3]), np.int32([0]), src2d)]
    kv, km = densify_map(*args, n_items=k, n_events=1, n_rows=1, k=k)
    if float(kv[0, 5]) != float(k - 1) or int(km[0, 5]) != 1 or int(km.sum()) != 1:
        raise AssertionError("densify_map: the last writer did not win")
    return n + 1


# the edges of densify_map's warp-per-row body: K across its 32-item tile
# (1 to 64), widths with no multiple of 4 (scalar accesses) and 384 (three
# passes of a warp), 1-8 shards
DENSIFY_EDGE_CASES = [  # (events, most items, K, uid-table size, rows a shard, W, shards)
    (40, 64, 64, 300, 100, 128, 1), (12, 1, 1, 20, 30, 128, 1),
    (30, 40, 64, 200, 77, 384, 1), (50, 33, 64, 100, 64, 127, 1),
    (20, 12, 16, 60, 70, 130, 1), (9, 5, 8, 30, 9, 3, 1),
    (60, 48, 64, 250, 40, 384, 3), (64, 20, 32, 120, 64, 130, 8),
    (25, 64, 64, 90, 16, 127, 2), (100, 7, 8, 150, 128, 128, 5),
]


def random_edge_packed(rng, n_events, k_max, k, n_uid, n_rows, w, n_shards):
    """A :data:`DENSIFY_EDGE_CASES` case: ``_random_packed``'s chunk routed
    over ``n_shards`` shards of ``n_rows`` rows each, and a table stack
    (n_shards, 16, w)."""
    packed, slot, col, src2d, sizes = _random_packed(
        rng, n_events=n_events, k_max=k_max, k=k, n_uid=n_uid, n_cols=5,
        n_rows=n_shards * n_rows, n_blocks=16, w=w)
    src3d = np.concatenate(
        [src2d[None], rng.integers(-1, 40, size=(n_shards - 1, 16, w)).astype(np.int32)])
    return packed, slot, col, src3d, dict(sizes, n_rows=n_rows)


def check_densify_edges(device: torch.device) -> int:
    """``densify_map`` (one shard) or ``densify_map_shard`` (all shards, and
    the upper half from ``shard_lo``), and ``densify_map_chunk`` from a
    pinned arena, bit for bit against the plain version over
    :data:`DENSIFY_EDGE_CASES` with ``fill`` 0 and 0.25, also on a table
    whose rows are not 16-byte aligned; every chunk call reports 1 copy
    and 1 launch.  Returns the number of cases."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.densify_map import (densify_map, densify_map_chunk,
                                                 densify_map_shard, split_outputs)

    n_cases = 0
    for i, (*case, n) in enumerate(DENSIFY_EDGE_CASES):
        packed, slot, col, src3d, sizes = random_edge_packed(
            np.random.default_rng(5000 + i), *case, n)
        p, sl, cl, t = (torch.from_numpy(a).to(device) for a in (packed, slot, col, src3d))
        skew = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)[1:].view(t.shape)
        skew.copy_(t)  # 4 bytes past an aligned address
        host = torch.from_numpy(packed.view(np.uint8).copy()).pin_memory()
        lo = n // 2
        for fill in (0.0, 0.25):
            rv, rm = ref.densify_map_shard_ref(p, sl, cl, t, n_shards=n, fill=fill, **sizes)
            for table in (t, skew):
                if n == 1:
                    kv, km = densify_map(p, sl, cl, table[0], fill=fill, **sizes)
                    kv, km = kv[None], km[None]
                else:
                    kv, km = densify_map_shard(p, sl, cl, table, n_shards=n, fill=fill,
                                               **sizes)
                    sv, sm = densify_map_shard(p, sl, cl, table[lo:], n_shards=n,
                                               shard_lo=lo, fill=fill, **sizes)
                    if not (_bits_equal(sv, rv[lo:]) and _bits_equal(sm, rm[lo:])):
                        raise AssertionError(f"densify_map_shard != plain on shards "
                                             f"[{lo}, {n}) of edge case {i} fill={fill}")
                raw, copies, launched = densify_map_chunk(host, sl, cl, table, n_route=n,
                                                          fill=fill, **sizes)
                cv, cm = split_outputs(raw, n, sizes["n_rows"], t.shape[2])
                if (copies, launched) != (1, 1):
                    raise AssertionError(f"densify_map_chunk issued {copies} copies and "
                                         f"{launched} launches at edge case {i}")
                if not all(_bits_equal(a, b) for a, b in ((kv, rv), (km, rm), (cv, rv),
                                                          (cm, rm))):
                    raise AssertionError(f"densify_map != plain at edge case {i} "
                                         f"fill={fill}")
            n_cases += 1
    return n_cases


# the edges of segmented_gather's warp-per-row body, each with fill 0 and
# 0.25: widths with no multiple of 4 (scalar accesses) and above 128 (passes
# of a warp), one payload column, operands off 16-byte alignment, routing
# and table entries out of range (clamped), NaN and inf payloads, a shard
# with no live rows
GATHER_EDGE_CASES = [  # (B, N_in, W, blocks a shard, rows a shard, shards, edge)
    (8, 64, 3, 4, 16, 1, "width"), (37, 300, 127, 8, 40, 1, "width"),
    (16, 200, 130, 8, 33, 2, "width"), (20, 500, 384, 6, 25, 1, "width"),
    (9, 1, 128, 4, 20, 1, "one column"), (30, 100, 128, 8, 64, 3, "misaligned"),
    (24, 90, 128, 8, 50, 1, "out of range"), (24, 90, 130, 8, 50, 4, "out of range"),
    (40, 128, 128, 8, 64, 4, "non-finite"), (12, 64, 256, 8, 32, 4, "empty shard"),
]
# payload bit patterns the body must move untouched: quiet and signalling
# NaNs with payloads, both infinities, -0.0, the smallest subnormal
NONFINITE_BITS = np.array([0x7FC00001, 0xFFC12345, 0x7F800001, 0x7F800000, 0xFF800000,
                           0x80000000, 0x00000001], dtype=np.uint32).view(np.int32)


def random_edge_gather(rng, b, n_in, w, n_blocks, s, n, edge):
    """A :data:`GATHER_EDGE_CASES` case: values (b, n_in) float32, mask int8,
    rows and blks (n, s) int32 and src3d (n, n_blocks, w) int32, with the
    case's edge planted; and the routing and table the plain version maps
    to the same result (out-of-range entries clamped into the shard's
    slice, as the kernel clamps them)."""
    vals = rng.normal(size=(b, n_in)).astype(np.float32)
    if edge == "non-finite":
        hit = rng.random((b, n_in)) < 0.3
        vals.view(np.int32)[hit] = rng.choice(NONFINITE_BITS, size=int(hit.sum()))
    mask = (rng.random((b, n_in)) < 0.7).astype(np.int8)
    src3d = np.where(rng.random((n, n_blocks, w)) < 0.3, -1,
                     rng.integers(0, n_in, size=(n, n_blocks, w))).astype(np.int32)
    rows = rng.integers(0, b, size=(n, s)).astype(np.int32)
    blks = rng.integers(0, n_blocks, size=(n, s)).astype(np.int32)
    if edge == "empty shard":
        rows[1], blks[1], src3d[1] = 0, 0, -1
    clamped = rows, blks, src3d
    if edge == "out of range":
        for arr, lo, hi, bad in ((rows, 0, b, (-5, b, b + 100)),
                                 (blks, 0, n_blocks, (-1, n_blocks, n_blocks + 3)),
                                 (src3d, -1, n_in, (n_in, n_in + 50, -7))):
            at = rng.random(arr.shape) < 0.1
            arr[at] = rng.choice(bad, size=int(at.sum()))
        clamped = (np.clip(rows, 0, b - 1), np.clip(blks, 0, n_blocks - 1),
                   np.clip(src3d, -1, n_in - 1))
    return (vals, mask, rows, blks, src3d), clamped


def _skewed(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied to an address one element past an aligned one."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return out.copy_(t)


def check_gather_edges(device: torch.device) -> int:
    """``segmented_gather`` (one shard) or ``segmented_gather_shard`` (all
    shards, and the upper half of them), and ``segmented_gather_chunk`` from
    a pinned arena, bit for bit against the plain version over
    :data:`GATHER_EDGE_CASES` with ``fill`` 0 and 0.25; every chunk call
    reports 4 copies and 1 launch.  Returns the number of cases."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.densify_map import split_outputs
    from repro_torch.kernels.segmented_gather import (arena_layout, arena_views,
                                                      segmented_gather,
                                                      segmented_gather_chunk,
                                                      segmented_gather_shard)

    n_cases = 0
    for i, (b, n_in, w, n_blocks, s, n, edge) in enumerate(GATHER_EDGE_CASES):
        arrays, clamped = random_edge_gather(np.random.default_rng(6000 + i), b, n_in, w,
                                             n_blocks, s, n, edge)
        v, m, r, bl, t = (torch.from_numpy(a).to(device) for a in arrays)
        cr, cb, ct = (torch.from_numpy(a).to(device) for a in clamped)
        if edge == "misaligned":
            v, m, r, bl, t = (_skewed(x) for x in (v, m, r, bl, t))
        _, n_bytes = arena_layout(b, n_in, n, s)
        host = torch.zeros(n_bytes, dtype=torch.uint8).pin_memory()
        for view, a in zip(arena_views(host, b, n_in, n, s), arrays[:4]):
            view.copy_(torch.from_numpy(a))
        lo = n // 2
        for fill in (0.0, 0.25):
            rv, rm = ref.segmented_gather_shard_ref(v, m, cr, cb, ct, fill=fill)
            if n == 1:
                kv, km = segmented_gather(v, m, r[0], bl[0], t[0], fill=fill)
                kv, km = kv[None], km[None]
            else:
                kv, km = segmented_gather_shard(v, m, r, bl, t, fill=fill)
                sv, sm = segmented_gather_shard(v, m, r[lo:], bl[lo:], t[lo:], fill=fill)
                if not (_bits_equal(sv, rv[lo:]) and _bits_equal(sm, rm[lo:])):
                    raise AssertionError(f"segmented_gather_shard != plain on shards "
                                         f"[{lo}, {n}) of edge case {i} ({edge}) fill={fill}")
            raw, copies, launched = segmented_gather_chunk(
                host, t if n > 1 else t[0], n_events=b, n_in=n_in, n_rows=s, n_route=n,
                fill=fill)
            cv, cm = split_outputs(raw, n, s, w)
            if (copies, launched) != (4, 1):
                raise AssertionError(f"segmented_gather_chunk issued {copies} copies and "
                                     f"{launched} launches at edge case {i}")
            if not all(_bits_equal(x, y) for x, y in ((kv, rv), (km, rm), (cv, rv),
                                                      (cm, rm))):
                raise AssertionError(f"segmented_gather != plain at edge case {i} ({edge}) "
                                     f"fill={fill}")
            n_cases += 1
    return n_cases


# sharded kernels' random cases: shards' live routing lengths (0: an empty
# shard), as ShardedEngine._shard_split pads them, over a padded S_loc
SHARD_GATHER_CASES = [  # (b, n_in, w, n_blocks_loc, s_loc, live entries a shard)
    (37, 300, 256, 16, 130, (130, 77, 0, 3)),
    (64, 128, 128, 8, 64, (64, 64, 64, 64)),
    (8, 64, 128, 8, 16, (0, 16)),
    (130, 250, 128, 24, 256, (200, 0, 256, 1, 17, 90, 0, 255)),
]
SHARD_DENSIFY_CASES = [  # (events, most items, K, uid-table size, n_blocks_loc, s_loc, live)
    (24, 7, 8, 60, 16, 16, (16, 5, 0, 9)),
    (64, 32, 32, 200, 16, 128, (128, 100, 0, 128)),
    (130, 16, 16, 1, 8, 256, (0, 256)),
    (200, 3, 4, 500, 16, 128, (128, 0, 1, 64, 128, 7, 0, 100)),
    (9, 32, 32, 0, 8, 8, (8, 0, 3)),
]


def _shard_tables(rng, lens, n_blocks, w, n_src):
    """Per shard z, a table slice (n_blocks, w) with a random count of live
    blocks (none for an empty shard, whose ``lens[z]`` is 0; pad rows -1)
    naming payload slots below ``n_src``.  Returns (src3d, live blocks a
    shard)."""
    n = len(lens)
    src3d = np.full((n, n_blocks, w), -1, np.int32)
    live = [int(rng.integers(1, n_blocks + 1)) if ln else 0 for ln in lens]
    for z, nb in enumerate(live):
        for t in range(nb):
            k = int(0.5 * min(n_src, w))
            src3d[z, t, rng.choice(w, size=k, replace=False)] = rng.choice(
                n_src, size=k, replace=False)
    return src3d, live


def random_sharded_gather(rng, b, n_in, w, n_blocks, s_loc, lens):
    """A sharded host-densify case: shared (b, n_in) values and mask, rows
    and shard-local blks (n_shards, s_loc), src3d (n_shards, n_blocks, w)."""
    vals = rng.normal(size=(b, n_in)).astype(np.float32)
    mask = (rng.random((b, n_in)) < 0.7).astype(np.int8)
    src3d, live = _shard_tables(rng, lens, n_blocks, w, n_in)
    rows = np.zeros((len(lens), s_loc), np.int32)
    blks = np.zeros((len(lens), s_loc), np.int32)
    for z, (ln, nb) in enumerate(zip(lens, live)):
        rows[z, :ln] = rng.integers(b, size=ln)
        blks[z, :ln] = rng.integers(nb, size=ln) if nb else 0
    return vals, mask, rows, blks, src3d


def random_sharded_packed(rng, n_events, k_max, k, n_uid, n_blocks, s_loc, lens):
    """A sharded device-densify case: ``_random_packed``'s items with the
    flattened (n_shards, s_loc) routing pair (live entries, then padding) and
    src3d (n_shards, n_blocks, 128)."""
    n = len(lens)
    packed, slot, col, _, sizes = _random_packed(
        rng, n_events=n_events, k_max=k_max, k=k, n_uid=n_uid, n_cols=5,
        n_rows=n * s_loc, n_blocks=n_blocks)
    src3d, live = _shard_tables(rng, lens, n_blocks, 128, 40)
    o = 2 * sizes["n_items"] + 3 * n_events
    rows = packed[o : o + n * s_loc].reshape(n, s_loc)
    blks = packed[o + n * s_loc :].reshape(n, s_loc)
    for z, (ln, nb) in enumerate(zip(lens, live)):
        rows[z, ln:] = 0
        blks[z, :ln] = rng.integers(nb, size=ln) if nb else 0
        blks[z, ln:] = 0
    return packed, slot, col, src3d, dict(sizes, n_rows=s_loc, n_shards=n)


def check_shard_kernels(device: torch.device) -> tuple:
    """``segmented_gather_shard`` and ``densify_map_shard`` bit for bit
    against their plain versions over ``SHARD_*_CASES`` (padded and empty
    shards, ``fill`` 0 and 0.25), each also launched on a sub-range of its
    shards (as a device of a mesh over several cards maps its own) and,
    shard by shard, against the base kernel.  Returns the case counts."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.densify_map import densify_map, densify_map_shard
    from repro_torch.kernels.segmented_gather import (segmented_gather,
                                                      segmented_gather_shard)

    n_sg = n_dm = 0
    for i, case in enumerate(SHARD_GATHER_CASES):
        arrays = random_sharded_gather(np.random.default_rng(3000 + i), *case)
        v, m, r, b, t = (torch.from_numpy(a).to(device) for a in arrays)
        for fill in (0.0, 0.25):
            kv, km = segmented_gather_shard(v, m, r, b, t, fill=fill)
            rv, rm = ref.segmented_gather_shard_ref(v, m, r, b, t, fill=fill)
            lo = 1
            sv, sm = segmented_gather_shard(v, m, r[lo:], b[lo:], t[lo:], fill=fill)
            base = [segmented_gather(v, m, r[z], b[z], t[z], fill=fill)
                    for z in range(r.shape[0])]
            if not (_bits_equal(kv, rv) and _bits_equal(km, rm)
                    and _bits_equal(sv, rv[lo:]) and _bits_equal(sm, rm[lo:])
                    and all(_bits_equal(kv[z], bv) and _bits_equal(km[z], bm)
                            for z, (bv, bm) in enumerate(base))):
                raise AssertionError(f"segmented_gather_shard != plain at case {i} fill={fill}")
            n_sg += 1
    for i, case in enumerate(SHARD_DENSIFY_CASES):
        packed, slot, col, src3d, sizes = random_sharded_packed(
            np.random.default_rng(4000 + i), *case)
        p, sl, cl, t = (torch.from_numpy(a).to(device) for a in (packed, slot, col, src3d))
        n, s_loc = sizes["n_shards"], sizes["n_rows"]
        o = 2 * sizes["n_items"] + 3 * sizes["n_events"]
        for fill in (0.0, 0.25):
            kv, km = densify_map_shard(p, sl, cl, t, fill=fill, **sizes)
            rv, rm = ref.densify_map_shard_ref(p, sl, cl, t, fill=fill, **sizes)
            lo = n - 1
            sv, sm = densify_map_shard(p, sl, cl, t[lo:], shard_lo=lo, fill=fill, **sizes)
            ok = (_bits_equal(kv, rv) and _bits_equal(km, rm)
                  and _bits_equal(sv, rv[lo:]) and _bits_equal(sm, rm[lo:]))
            for z in range(n):  # shard z alone, as a one-shard packed chunk
                one = torch.cat([p[:o], p[o + z * s_loc : o + (z + 1) * s_loc],
                                 p[o + (n + z) * s_loc : o + (n + z + 1) * s_loc]])
                bv, bm = densify_map(one, sl, cl, t[z], fill=fill, n_items=sizes["n_items"],
                                     n_events=sizes["n_events"], n_rows=s_loc, k=sizes["k"])
                ok = ok and _bits_equal(kv[z], bv) and _bits_equal(km[z], bm)
            if not ok:
                raise AssertionError(f"densify_map_shard != plain at case {i} fill={fill}")
            n_dm += 1
    return n_sg, n_dm


def _block_case(rng, b, n_in, n_out, density):
    """tests/test_kernels.py::_mk_case: each of ``density * min(n_in,
    n_out)`` output slots names a distinct input slot."""
    vals = rng.normal(size=(b, n_in)).astype(np.float32)
    mask = (rng.random((b, n_in)) < 0.7).astype(np.int8)
    src = np.full((n_out,), -1, np.int32)
    k = int(density * min(n_in, n_out))
    if k:
        src[rng.choice(n_out, size=k, replace=False)] = rng.choice(n_in, size=k, replace=False)
    return vals, mask, src


def _close(kv, km, rv, rm, atol) -> bool:
    """Masks bit for bit; values bit for bit (``atol`` None) or within
    ``atol`` with NaN where the plain version has NaN."""
    if not torch.equal(km, rm):
        return False
    if atol is None:
        return _bits_equal(kv, rv)
    return kv.dtype == rv.dtype and bool(torch.allclose(
        kv.float(), rv.float(), rtol=0.0, atol=atol, equal_nan=True))


def check_per_block(device: torch.device, name: str) -> int:
    """``masked_gather`` (bit for bit) or ``onehot_map`` (values within
    ``ONEHOT_ATOL``) against its plain version over the reference's sweep."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.masked_gather import masked_gather
    from repro_torch.kernels.onehot_map import onehot_map

    kernel, plain, atol = {
        "masked_gather": (masked_gather, ref.masked_gather_ref, None),
        "onehot_map": (onehot_map, ref.onehot_map_ref, ONEHOT_ATOL),
    }[name]
    n = 0
    for i, (b, n_in, n_out) in enumerate(BLOCK_SHAPES):
        for density in (0.0, 0.3, 1.0):
            rng = np.random.default_rng(2000 + 10 * i + int(10 * density))
            case = _block_case(rng, b, n_in, n_out, density)
            for dtype in (torch.float32, torch.bfloat16):
                v, m, src = (torch.from_numpy(a).to(device) for a in case)
                v = v.to(dtype)
                for fill in (0.0, 0.25):
                    kv, km = kernel(v, m, src, fill=fill)
                    rv, rm = plain(v, m, src, fill=fill)
                    if not _close(kv, km, rv, rm, atol):
                        raise AssertionError(
                            f"{name} != plain at B={b} N_in={n_in} N_out={n_out} "
                            f"density={density} {dtype} fill={fill}")
                    n += 1
    if name == "onehot_map":
        # a non-finite value anywhere in an event row reaches every
        # mask-set output of that row, as through a matrix unit
        vals, mask, src = _block_case(np.random.default_rng(7), 8, 10, 128, 0.5)
        mask[:] = 1
        vals[2, 0], vals[5, 9] = np.inf, np.nan
        src[src == 0] = -1
        v, m, s_ = (torch.from_numpy(a).to(device) for a in (vals, mask, src))
        kv, km = kernel(v, m, s_, fill=0.25)
        rv, rm = plain(v, m, s_, fill=0.25)
        hit = km.bool()
        if not (_close(kv, km, rv, rm, atol) and bool(kv[2][hit[2]].isnan().all())
                and bool(kv[5][hit[5]].isnan().all()) and bool(kv[0].isfinite().all())):
            raise AssertionError("onehot_map: a non-finite row did not spread as in the plain version")
        n += 1
    return n


# -- phase 4: the main path ----------------------------------------------------


class Stream:
    """The scenario's CDC stream as columnar chunks, generated once and
    shared by every run (chunks are pure in registry state and position, so
    each run's coordinator would generate the same ones)."""

    def __init__(self, chunk_events: int) -> None:
        self.chunk_events = chunk_events
        self.chunks = {}

    def get(self, k: int, registry):
        from repro_torch.etl.events import EventSource

        if k not in self.chunks:
            src = EventSource(registry, seed=1)
            self.chunks[k] = src.slice_columnar(k * self.chunk_events, self.chunk_events)
        return self.chunks[k]


class DispatchLog:
    """An observer on the engine's public ``dispatch``: per call, the
    dispatches, transfers and kernel launches it made and, on the per-block
    engine, the groups and blocks its chunk touches (from the chunk's
    columns and plan), in the form :func:`check_accounting` reads."""

    def __init__(self, engine) -> None:
        self.engine = engine
        self.inner = engine.dispatch
        self.per_chunk = []
        engine.dispatch = self

    def __call__(self, dense):
        stats = self.engine.stats
        before = (stats["dispatches"], stats["transfers"], _launch_counts())
        handle = self.inner(dense)
        launched = _launch_counts()
        acct = {"dispatches": stats["dispatches"] - before[0],
                "transfers": stats["transfers"] - before[1],
                **{n: launched[n] - before[2][n] for n in KERNEL_NAMES}}
        if self.engine.plan_kind == "blocks":
            acct["groups"] = len(dense.columns)
            acct["blocks_touched"] = sum(len(dense.plan.column(*ov)) for ov in dense.columns)
        self.per_chunk.append(acct)
        return handle

    def close(self) -> None:
        del self.engine.dispatch  # the class's own method again


def _counters():
    """(wrapper module, counter name) of each kernel, in ``KERNEL_NAMES``
    order: a shard kernel's wrapper sits beside its base kernel's."""
    from repro_torch.kernels import (densify_map, flash_attention, masked_gather,
                                     moe_combine, onehot_map, segmented_gather)
    return ((segmented_gather, "launches"), (densify_map, "launches"),
            (masked_gather, "launches"), (onehot_map, "launches"),
            (flash_attention, "launches"), (moe_combine, "launches"),
            (segmented_gather, "shard_launches"), (densify_map, "shard_launches"))


def _launch_counts():
    return {name: getattr(mod, attr)
            for name, (mod, attr) in zip(KERNEL_NAMES, _counters())}


def _zero_launch_counts() -> None:
    from repro_torch.kernels import ops
    for mod, attr in _counters():
        setattr(mod, attr, 0)
    ops.dispatch_count = 0


def plan_layer(app, first_build_s: float) -> dict:
    """The plan layer of the app's serving lease: the build's time (beside
    the first build's), whether it spliced, the columns it re-lowered and
    the device-resident table bytes (per shard too on the sharded paths)."""
    lease = app.engine.lease
    out = {"epoch": lease.epoch, "rebuild_ms": lease.rebuild_s * 1e3,
           "first_build_ms": first_build_s * 1e3,
           "incremental": lease.incremental, "touched_columns": lease.touched_columns,
           "columns": len(lease.compiled.by_column), "bytes_resident": lease.bytes_resident}
    if hasattr(lease.plan, "table_bytes_per_shard"):
        out["bytes_resident_per_shard"] = lease.plan.table_bytes_per_shard
    return out


# step 4's consume paths, as path_app keywords
MAIN_PATHS = {
    "host": {"device_densify": False},
    "device": {"device_densify": True},
    "blocks-gather": {"engine": "blocks"},
    "blocks-onehot": {"impl": "onehot"},
    "sharded-host": {"engine": "sharded", "shards": SHARDS},
    "sharded-device": {"engine": "sharded", "shards": SHARDS, "device_densify": True},
}


def main_path_world(cfg):
    """A fresh coordinator of ``cfg``'s scenario and the schema evolution of
    chunk ``EVOLVE_AT`` (``churn_schedule(steps=1, seed=0)``)."""
    from repro_torch.core.state import StateCoordinator
    from repro_torch.core.synthetic import build_scenario, churn_schedule

    sc = build_scenario(cfg)
    coord = StateCoordinator(sc.registry, sc.dpm)
    return coord, churn_schedule(coord.registry, steps=1, first_chunk=EVOLVE_AT,
                                 seed=0)[EVOLVE_AT]


def path_app(device, path, coord):
    """A new METLApp on ``device`` configured by ``path``
    (``engine``/``impl``/``device_densify`` keywords, and ``shards``: that
    many shards of a mesh on ``device``)."""
    from repro_torch.etl.metl import METLApp
    from repro_torch.launch.mesh import make_etl_mesh

    kwargs = dict(path)
    if "shards" in kwargs:
        kwargs["mesh"] = make_etl_mesh(devices=[device] * kwargs.pop("shards"))
    return METLApp(coord, device=device, **kwargs)


def main_path_app(device, path, cfg):
    """:func:`main_path_world` and a :func:`path_app` on its coordinator."""
    coord, ev = main_path_world(cfg)
    return coord, ev, path_app(device, path, coord)


def run_main_path(device, path, cfg, stream, *, n_chunks, evolve_at):
    """One METLApp over the stream on ``device``, configured by ``path``
    (see :func:`path_app`); returns (rows, stats, consume seconds per
    chunk, kernel launch counts, per-chunk accounting, the app, the plan
    layer after the evolution chunk's rebuild)."""
    from repro_torch.kernels import ops

    coord, ev, app = main_path_app(device, path, cfg)
    sched = {evolve_at: ev}
    first_build_s = app.engine.lease.rebuild_s
    log = DispatchLog(app.engine)  # every chunk here maps: one dispatch call a chunk
    rows, chunk_s = [], []
    _zero_launch_counts()
    for k in range(n_chunks):
        if k in sched:
            coord.apply(sched[k])
        chunk = stream.get(k, coord.registry)  # set-up, outside the clock
        t0 = time.perf_counter()
        out = app.consume(chunk)
        chunk_s.append(time.perf_counter() - t0)
        rows.extend(out)
        if k == evolve_at:
            plan = plan_layer(app, first_build_s)
    log.close()
    if len(log.per_chunk) != n_chunks:
        raise AssertionError(f"{len(log.per_chunk)} dispatch calls for {n_chunks} chunks")
    launches = {**_launch_counts(), "dispatch_count": ops.dispatch_count}
    return rows, dict(app.stats), chunk_s, launches, log.per_chunk, app, plan


def check_accounting(name, per_chunk, path, on_card):
    """Fused and sharded: 1 dispatch and 4 (host) or 1 (device) transfers
    per chunk.  Per-block: one dispatch per block the chunk's groups touch,
    2 transfers per group.  On the card, one launch of the path's kernel per
    dispatch (the sharded paths: of its shard kernel, every shard on the one
    card) and none of the others."""
    blocks = path.get("engine") == "blocks" or path.get("impl") == "onehot"
    if blocks:
        kernel = "onehot_map" if path.get("impl") == "onehot" else "masked_gather"
    else:
        kernel = "densify_map" if path.get("device_densify") else "segmented_gather"
        if path.get("engine") == "sharded":
            kernel += "_shard"
    for k, a in enumerate(per_chunk):
        if blocks:
            want = (a["blocks_touched"], 2 * a["groups"])
        else:
            want = (1, 1 if path.get("device_densify") else 4)
        if (a["dispatches"], a["transfers"]) != want:
            raise AssertionError(
                f"{name} chunk {k}: {a['dispatches']} dispatches, {a['transfers']} "
                f"transfers (want {want[0]} and {want[1]})")
        if on_card:
            got = {n: a[n] for n in KERNEL_NAMES}
            if got != {n: (a["dispatches"] if n == kernel else 0) for n in KERNEL_NAMES}:
                raise AssertionError(f"{name} chunk {k}: launches {got}, want "
                                     f"{a['dispatches']} of {kernel} only")


def compare_rows(name, got, want, atol=None) -> int:
    """Routes, keys and masks equal; values bit for bit (``atol`` None) or
    within ``atol``.  Returns the number of rows whose values differ in
    any bit."""
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} rows, reference {len(want)}")
    n_bits = 0
    for i, (x, y) in enumerate(zip(got, want)):
        if x[0] != y[0] or x[3] != y[3]:
            raise AssertionError(f"{name} row {i}: route/key {x[0]},{x[3]} != {y[0]},{y[3]}")
        if x[1].dtype != np.float32 or not np.isfinite(x[1]).all():
            raise AssertionError(f"{name} row {i}: values not finite float32")
        if not np.array_equal(x[2], y[2]):
            raise AssertionError(f"{name} row {i}: mask differs from reference")
        if not np.array_equal(x[1].view(np.int32), y[1].view(np.int32)):
            n_bits += 1
            if atol is None or not np.allclose(x[1], y[1], rtol=0.0, atol=atol):
                raise AssertionError(f"{name} row {i}: values differ from reference")
    return n_bits


# -- phase 4b: the plan lifecycle -------------------------------------------------

SOAK_CHUNKS, SOAK_EVENTS, SOAK_CHURN, SOAK_EVERY = 36, 256, 16, 2  # bench_compaction.py's


def soak_arm(device, *, incremental=True, tiering=None, background=False) -> dict:
    """One arm of ``benchmarks/bench_compaction.py``'s soak on ``device``: a
    fresh ``soak_config()`` world served by an explicit fused
    ``PlanManager``, ``SOAK_CHURN`` schema evolutions from ``churn_schedule
    (first_chunk=1, every=2, seed=13)`` applied at chunk boundaries,
    ``SOAK_CHUNKS`` chunks of ``SOAK_EVENTS`` events of ``EventSource(seed=5)``
    consumed on the host clock (chunks made outside it).  Returns the rows,
    the manager's and the engine's ``info()``, the app's ``stats``, the
    build time of each cutover and the consume time of each chunk; the
    kernels' counts are zeroed just before the arm and read just after."""
    from repro_torch.core.state import StateCoordinator
    from repro_torch.core.synthetic import build_scenario, churn_schedule, soak_config
    from repro_torch.etl import EventSource, METLApp, PlanManager

    sc = build_scenario(soak_config())
    coord = StateCoordinator(sc.registry, sc.dpm)
    mgr = PlanManager(device=device, coordinator=coord, incremental=incremental,
                      tiering=tiering, background=background)
    try:
        _zero_launch_counts()
        app = METLApp(coord, plan_manager=mgr)  # builds and serves epoch 1
        first_s = mgr.info()["total_rebuild_s"]
        sched = churn_schedule(coord.registry, steps=SOAK_CHURN, first_chunk=1,
                               every=SOAK_EVERY, seed=13)
        src = EventSource(sc.registry, seed=5)
        rows, chunk_s, cutover_s = [], [], []
        for k in range(SOAK_CHUNKS):
            if k in sched:
                coord.apply(sched[k])
            chunk = src.slice_columnar(k * SOAK_EVENTS, SOAK_EVENTS)
            t0 = time.perf_counter()
            rows.extend(app.consume(chunk))
            chunk_s.append(time.perf_counter() - t0)
            if k in sched:
                cutover_s.append(app.engine.lease.rebuild_s)
        if device != "cpu":
            torch.cuda.synchronize()
        launches = _launch_counts()
    finally:
        mgr.close()
    return {"rows": rows, "minfo": mgr.info(), "einfo": app.engine.info(),
            "stats": dict(app.stats), "first_s": first_s, "cutover_s": cutover_s,
            "chunk_s": chunk_s, "launches": launches}


def soak_summary(arm: dict) -> dict:
    """The numbers a soak arm's line prints: churn rebuild ms (all cutovers
    and each), first build ms, chunk ms p50 / p99, events/s, bytes resident."""
    chunk_ms = np.asarray(arm["chunk_s"]) * 1e3
    return {"churn_rebuild_ms": sum(arm["cutover_s"]) * 1e3,
            "cutover_ms": [t * 1e3 for t in arm["cutover_s"]],
            "first_build_ms": arm["first_s"] * 1e3,
            "chunk_ms_p50": float(np.percentile(chunk_ms, 50)),
            "chunk_ms_p99": float(np.percentile(chunk_ms, 99)),
            "events_per_s": SOAK_CHUNKS * SOAK_EVENTS / (chunk_ms.sum() / 1e3),
            "rows": len(arm["rows"]), "bytes_resident": arm["einfo"]["bytes_resident"],
            "rebuilds": arm["minfo"]["rebuilds"],
            "incremental_rebuilds": arm["minfo"]["incremental_rebuilds"]}


def plan_lifecycle(dev) -> None:
    """The plan lifecycle at the reference soak's full size, on the card:
    arm A incremental, arm B full rebuilds, arm C incremental and tiered
    (only the latest versions pinned), arm A again with the background
    build, and arm A on the CPU.  Fails unless A's row keys equal B's in
    order, A's rows equal the CPU run's bit for bit, C's rows sorted equal
    A's, the background arm's rows equal A's, A made 16 incremental builds
    and B none, and C kept columns cold, missed, holds fewer resident bytes
    than A and mapped its misses through the ``masked_gather`` kernel."""
    from repro_torch.etl import TieringPolicy

    arms = {"A": soak_arm(dev), "B": soak_arm(dev, incremental=False),
            "C": soak_arm(dev, tiering=TieringPolicy(min_hits=10**9, pin_latest=True)),
            "A background": soak_arm(dev, background=True), "A cpu": soak_arm("cpu")}
    for name, arm in arms.items():
        print(f"{elapsed()} plan lifecycle arm {name}: " + json.dumps(soak_summary(arm)),
              flush=True)
    a, b, c = arms["A"], arms["B"], arms["C"]
    if not a["rows"]:
        raise AssertionError("plan lifecycle: arm A emitted no rows")
    if [r[3] for r in a["rows"]] != [r[3] for r in b["rows"]]:
        raise AssertionError("plan lifecycle: arm A's row keys differ from arm B's")
    compare_rows("plan lifecycle A vs cpu", a["rows"], arms["A cpu"]["rows"])
    compare_rows("plan lifecycle A background vs A", arms["A background"]["rows"], a["rows"])

    def by_key(rows):
        return sorted(rows, key=lambda r: (r[3], r[0]))

    compare_rows("plan lifecycle C vs A (sorted)", by_key(c["rows"]), by_key(a["rows"]))
    if a["stats"] != arms["A cpu"]["stats"]:
        raise AssertionError(f"plan lifecycle: arm A stats {a['stats']} != cpu "
                             f"{arms['A cpu']['stats']}")
    if (a["minfo"]["incremental_rebuilds"], b["minfo"]["incremental_rebuilds"]) != (SOAK_CHURN, 0):
        raise AssertionError(f"plan lifecycle: {a['minfo']['incremental_rebuilds']} / "
                             f"{b['minfo']['incremental_rebuilds']} incremental builds "
                             f"(want {SOAK_CHURN} / 0)")
    cold_transfers = c["stats"]["transfers"] - 4 * c["stats"]["dispatches"]
    cold = {"cold_columns": c["minfo"]["cold_columns"],
            "tier_misses": c["stats"].get("tier_misses", 0),
            "masked_gather_launches": c["launches"]["masked_gather"],
            "other_launches": {n: v for n, v in c["launches"].items()
                               if n not in ("masked_gather", "segmented_gather") and v},
            # per cold column a chunk maps: the reference's 2 counted transfers;
            # the port copies values, mask and the index vectors (3), and reads
            # each block's values and mask back (2 a launch)
            "counted_cold_transfers": cold_transfers,
            "cold_copies_to_card": cold_transfers // 2 * 3,
            "cold_readbacks": 2 * c["launches"]["masked_gather"],
            "bytes_resident": c["einfo"]["bytes_resident"],
            "bytes_resident_A": a["einfo"]["bytes_resident"]}
    print(f"plan lifecycle arm C cold path: {json.dumps(cold)}", flush=True)
    if not (cold["cold_columns"] > 0 and cold["tier_misses"] > 0
            and cold["bytes_resident"] < cold["bytes_resident_A"]
            and cold["masked_gather_launches"] > 0 and not cold["other_launches"]):
        raise AssertionError(f"plan lifecycle: arm C's tiering did not hold: {cold}")
    speedup = soak_summary(b)["churn_rebuild_ms"] / soak_summary(a)["churn_rebuild_ms"]
    print(f"plan lifecycle: rows of A, B, C, A background equal (A bit for bit with the cpu, "
          f"C by key); churn rebuild B / A = {speedup:.2f}x", flush=True)


# -- phase 4c: the streaming pipeline -------------------------------------------

PIPELINE_RUNS = {"sync": {}, "async": {"async_consume": True},
                 "thread": {"async_consume": True, "densify_thread": True}}
# (path, pipeline mode) of the phase's correctness runs: every mode on fused
# host densify, async on the other paths
PIPELINE_CASES = [("host", "sync"), ("host", "async"), ("host", "thread"),
                  ("device", "async"), ("sharded-host", "async"),
                  ("sharded-device", "async"), ("blocks-gather", "async")]
RATE_PATHS = ("host", "device", "sharded-host")
RATE_PASSES = 5
LOAD_EVENTS, LOAD_INSTANCES = 8192, 4
# the launcher's ETL flag combinations, as _etl_prompts keywords
SERVE_ETL_FLAGS = {
    "--etl": {},
    "--etl --async-consume": {"async_consume": True},
    "--etl --device-densify": {"device_densify": True},
    "--etl --shards 4": {"shards": 4},
    "--etl --instances 2": {"instances": 2},
    "--etl --instances 2 --shards 4 --async-consume --device-densify": {
        "instances": 2, "shards": 4, "async_consume": True, "device_densify": True},
}


def _stream_source(coord, ev):
    """Step 4's stream as a pipeline pulls it: ``CHUNKS`` chunks of
    ``CHUNK_EVENTS`` events of ``EventSource(seed=1)``, the evolution in
    band before chunk ``EVOLVE_AT``."""
    from repro_torch.etl import EventChunkSource, EventSource

    return EventChunkSource(EventSource(coord.registry, seed=1), chunk_size=CHUNK_EVENTS,
                            max_chunks=CHUNKS, control={EVOLVE_AT: ev})


def run_pipeline(device, path, cfg, mode):
    """Step 4's stream through ``Pipeline`` on one fresh app of ``path``,
    in ``mode`` (``PIPELINE_RUNS``); the kernels' counts are zeroed just
    before the run and read just after.  Returns (rows, stats, the run's
    PipelineStats, per-dispatch accounting, launches, seconds)."""
    from repro_torch.etl import CollectSink, Pipeline

    coord, ev, app = main_path_app(device, MAIN_PATHS[path], cfg)
    sink = CollectSink()
    log = DispatchLog(app.engine)
    pipe = Pipeline(_stream_source(coord, ev), app, [sink], **PIPELINE_RUNS[mode])
    try:
        _zero_launch_counts()
        t0 = time.perf_counter()
        st = pipe.run()
        seconds = time.perf_counter() - t0
        launches = _launch_counts()
    finally:
        pipe.close()
        log.close()
    return sink.rows, dict(app.stats), st, log.per_chunk, launches, seconds


def pipeline_backpressure(dev, cfg, want) -> dict:
    """Async fused host densify into a bounded ``CollectSink`` that fills
    mid-stream, drained and resumed until the source ends: the rows must be
    the unbounded run's, none lost or repeated, and each stop must keep its
    lookahead chunk (``_pending``) for the resume to flush first."""
    from repro_torch.etl import CollectSink, Pipeline

    coord, ev, app = main_path_app(dev, MAIN_PATHS["host"], cfg)
    limit = len(want) // 7 + 1
    sink = CollectSink(limit=limit)
    pipe = Pipeline(_stream_source(coord, ev), app, [sink], async_consume=True)
    got, stops, kept, runs, chunks = [], 0, 0, 0, 0
    try:
        while True:
            st = pipe.run()
            runs += 1
            chunks += st.chunks
            got.extend(sink.rows)
            if not sink.full():
                break
            stops += 1
            # a stop keeps its lookahead unless it fell on a control
            # boundary (the drain pulls nothing ahead) or the stream's end
            kept += pipe._pending is not None
            sink.rows = []  # the consumer drains the sink
    finally:
        pipe.close()
    if pipe._pending is not None or stops < 2 or kept < 1 or chunks != CHUNKS:
        raise AssertionError(f"pipeline backpressure: {stops} stops, {kept} with a "
                             f"lookahead kept, {chunks} chunks, pending left "
                             f"{pipe._pending is not None}")
    compare_rows("pipeline backpressure vs unbounded", got, want)
    return {"limit": limit, "stops": stops, "stops_with_lookahead_kept": kept,
            "runs": runs, "chunks": chunks, "rows": len(got)}


def pipeline_cluster(dev, cfg, want) -> dict:
    """``Cluster.over_stream`` over step 4's stream, 4 async instances of
    fused host densify on the card: the merged rows equal the one-instance
    rows in order, and every instance serves one state."""
    from repro_torch.etl import Cluster, CollectSink, EventSource

    coord, ev = main_path_world(cfg)
    sink = CollectSink()
    cluster = Cluster.over_stream(coord, EventSource(coord.registry, seed=1), instances=4,
                                  chunk_size=CHUNK_EVENTS, max_chunks=CHUNKS,
                                  control={EVOLVE_AT: ev}, sinks=[sink],
                                  async_consume=True, device=dev)
    try:
        _zero_launch_counts()
        t0 = time.perf_counter()
        st = cluster.run()
        seconds = time.perf_counter() - t0
        launches = _launch_counts()
    finally:
        cluster.close()
    info = cluster.info()
    if (st.chunks, st.control, len(info["states"]), info["dispatches"],
            launches["segmented_gather"]) != (CHUNKS, 1, 1, CHUNKS, CHUNKS):
        raise AssertionError(f"pipeline cluster: {st}, states {info['states']}, "
                             f"{info['dispatches']} dispatches, launches {launches}")
    compare_rows("pipeline cluster vs one instance", sink.rows, want)
    return {"instances": info["instances"], "states": info["states"],
            "dispatches": info["dispatches"],
            "segmented_gather_launches": launches["segmented_gather"],
            "rows": len(sink.rows), "seconds": seconds}


def pipeline_initial_load(dev, cfg) -> dict:
    """``initial_load`` of ``LOAD_EVENTS`` events of ``EventSource(seed=1)``
    over ``LOAD_INSTANCES`` instances in chunks of ``CHUNK_EVENTS``: on the
    card with threads, on the card in turn and on the CPU; the rows must be
    equal.  The threaded load is held by its rows: the launch counters are
    plain ints that threads may miscount."""
    from repro_torch.etl import EventSource
    from repro_torch.etl.initial_load import initial_load

    coord, _ = main_path_world(cfg)  # a load freezes and thaws; it changes no state
    rows, seconds = {}, {}
    for name, kw in (("threads", {"threads": True, "device": dev}),
                     ("sequential", {"threads": False, "device": dev}),
                     ("cpu", {"threads": False, "device": "cpu"})):
        t0 = time.perf_counter()
        rows[name] = initial_load(coord, EventSource(coord.registry, seed=1),
                                  count=LOAD_EVENTS, instances=LOAD_INSTANCES,
                                  chunk=CHUNK_EVENTS, **kw)
        seconds[name] = time.perf_counter() - t0
        if coord.frozen:
            raise AssertionError(f"initial load {name}: the coordinator stayed frozen")
    if not rows["cpu"]:
        raise AssertionError("initial load: no rows")
    compare_rows("initial load threads vs sequential", rows["threads"], rows["sequential"])
    compare_rows("initial load card vs cpu", rows["sequential"], rows["cpu"])
    return {"events": LOAD_EVENTS, "instances": LOAD_INSTANCES, "rows": len(rows["cpu"]),
            "seconds": seconds}


def pipeline_serve() -> dict:
    """The launcher once at olmo-1b's full width on the card, fed by the ETL
    cluster (2 instances, 4 shards, async, device densify): every request
    completes.  Then, for each ETL flag combination, the prompts of
    ``_etl_prompts`` on the card must equal those on the CPU."""
    import contextlib
    import io

    from repro_torch import configs
    from repro_torch.launch import serve

    argv = ["--arch", "olmo_1b", "--etl", "--instances", "2", "--shards", "4",
            "--async-consume", "--device-densify"]
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        serve.main(argv)
    seconds = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    requests = [line for line in lines if line.startswith("request ")]
    done = [line for line in requests if ": 16 tokens -> " in line]
    etl = [line for line in lines if line.startswith("etl: ")]
    if len(requests) != 8 or len(done) != 8 or not etl:
        raise AssertionError("serve --etl: not every request completed:\n" + out.getvalue())
    vocab = configs.get("olmo_1b").vocab
    with contextlib.redirect_stdout(io.StringIO()):  # their etl: lines
        for flags, kw in SERVE_ETL_FLAGS.items():
            got = serve._etl_prompts(300, vocab, device="cuda", **kw)
            want = serve._etl_prompts(300, vocab, device="cpu", **kw)
            if len(got) != 300 or got != want:
                raise AssertionError(f"_etl_prompts {flags}: the card's prompts differ "
                                     "from the cpu's")
    return {"argv": " ".join(argv), "requests_done": len(done), "seconds": seconds,
            "etl_line": etl[-1], "prompt_combinations_equal_cpu": len(SERVE_ETL_FLAGS)}


def _pipeline_pass(dev, path, coord, mode, chunks, profiled=False):
    """One timed ``Pipeline.run`` over ``chunks`` (made beforehand, at the
    evolved state) on a new app of ``coord`` (evolved): events/s on the
    host clock or, ``profiled``, the device's busy share of the wall time
    from ``torch.profiler`` (None when it records no device time)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.etl import CollectSink, ListSource, Pipeline

    app = path_app(dev, MAIN_PATHS[path], coord)
    pipe = Pipeline(ListSource(chunks), app, [CollectSink()], **PIPELINE_RUNS[mode])
    torch.cuda.synchronize()
    try:
        if profiled:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                st = pipe.run()
                wall = time.perf_counter() - t0
        else:
            t0 = time.perf_counter()
            st = pipe.run()
            wall = time.perf_counter() - t0
    finally:
        pipe.close()
    if st.chunks != len(chunks):
        raise AssertionError(f"pipeline rates {path}/{mode}: {st.chunks} chunks")
    if not profiled:
        return st.events / wall
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy_us * 1e-6 / wall if busy_us > 0 else None


def pipeline_rates(dev, cfg, chunks) -> dict:
    """ev/s of sync, async and async with the densify thread over
    ``chunks`` (33-63 of step 4's stream) on fused host densify, fused
    device densify and sharded host densify: ``RATE_PASSES`` interleaved
    passes (the mode order rotating each pass) after one uncounted warm-up
    pass of each, each pass on a new app of one evolved coordinator; the
    median with the min-max spread, and the device busy share of one
    async pass under ``torch.profiler``."""
    coord, ev = main_path_world(cfg)
    coord.apply(ev)
    modes = list(PIPELINE_RUNS)
    rates = {p: {m: [] for m in modes} for p in RATE_PATHS}
    for path in RATE_PATHS:
        for m in modes:
            _pipeline_pass(dev, path, coord, m, chunks)
    for k in range(RATE_PASSES):
        for path in RATE_PATHS:
            for m in modes[k % 3:] + modes[:k % 3]:
                rates[path][m].append(_pipeline_pass(dev, path, coord, m, chunks))
    out = {}
    for path in RATE_PATHS:
        out[path] = {m: {"median_ev_s": statistics.median(v), "min_ev_s": min(v),
                         "max_ev_s": max(v)} for m, v in rates[path].items()}
        for m in ("async", "thread"):
            out[path][f"{m}_over_sync"] = (out[path][m]["median_ev_s"]
                                           / out[path]["sync"]["median_ev_s"])
        out[path]["device_busy_share_async"] = _pipeline_pass(dev, path, coord, "async",
                                                              chunks, profiled=True)
    return {"chunks": f"{EVOLVE_AT + 1}-{CHUNKS - 1}",
            "events_per_pass": sum(len(c) for c in chunks), "passes": RATE_PASSES,
            "paths": out}


def streaming_pipeline(dev, cfg, stream, runs) -> None:
    """Phase 4c: step 4's stream through the pipeline, the cluster, the
    initial load and the ETL-fed launcher on the card, held against step
    4's rows and stats, the sync run and the CPU; then the rates."""
    import dataclasses

    sync_rows = {}
    for path, mode in PIPELINE_CASES:
        name = f"pipeline cuda/{path} {mode}"
        rows, stats, st, per_chunk, launches, seconds = run_pipeline(dev, path, cfg, mode)
        if (st.chunks, st.events, st.control, st.rows) != (
                CHUNKS, CHUNKS * CHUNK_EVENTS, 1, len(rows)):
            raise AssertionError(f"{name}: {st}")
        if len(per_chunk) != CHUNKS:
            raise AssertionError(f"{name}: {len(per_chunk)} dispatch calls")
        check_accounting(name, per_chunk, MAIN_PATHS[path], on_card=True)
        step4_rows, step4_stats = runs[f"cuda/{path}"][0], runs[f"cuda/{path}"][1]
        compare_rows(f"{name} vs step 4", rows, step4_rows)
        if stats != step4_stats:
            raise AssertionError(f"{name}: stats {stats} != step 4's {step4_stats}")
        if mode == "sync":
            sync_rows[path] = rows
        elif path in sync_rows:
            compare_rows(f"{name} vs sync", rows, sync_rows[path])
        print(f"{elapsed()} {name}: {json.dumps(dataclasses.asdict(st))} in {seconds:.3f} s "
              f"({CHUNKS * CHUNK_EVENTS / seconds:.0f} ev/s, the source's slicing "
              f"included); rows and stats equal step 4's; launches "
              f"{json.dumps(launches)}", flush=True)
    want = runs["cuda/host"][0]
    later = [stream.chunks[k] for k in range(EVOLVE_AT + 1, CHUNKS)]
    for name, run in (("backpressure", lambda: pipeline_backpressure(dev, cfg, want)),
                      ("cluster", lambda: pipeline_cluster(dev, cfg, want)),
                      ("initial load", lambda: pipeline_initial_load(dev, cfg)),
                      ("serve --etl", pipeline_serve),
                      ("rates", lambda: pipeline_rates(dev, cfg, later))):
        result = run()  # the line's time stamp is the step's end
        print(f"{elapsed()} pipeline {name}: " + json.dumps(result), flush=True)


# -- phase 5: timing -------------------------------------------------------------


def stage_breakdown(app, chunks):
    """Host seconds per consume stage (triage, densify, dispatch, emit; emit
    includes the wait for the device) over ``chunks``, re-consumed after a
    dedup reset, plus the device's busy share of that wall time from
    ``torch.profiler`` (None when the profiler records no device time)."""
    from torch.profiler import ProfilerActivity, profile

    stages = {"triage": 0.0, "densify": 0.0, "dispatch": 0.0, "emit": 0.0}
    eng = app.engine
    app.reset_dedup()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_start = time.perf_counter()
        for chunk in chunks:
            t0 = time.perf_counter()
            tri = app.triage(chunk)
            t1 = time.perf_counter()
            dense = eng.densify(tri)
            t2 = time.perf_counter()
            handle = eng.dispatch(dense)
            t3 = time.perf_counter()
            eng.emit(handle)
            t4 = time.perf_counter()
            for name, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                stages[name] += dt
        wall = time.perf_counter() - t_start
    # device-side entries only (kernels, copies): the host ops that issued
    # them carry the same device time again
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in device)
    busy = busy_us * 1e-6 / wall if busy_us > 0 else None
    kernels = sorted(((e.key[:60], e.self_device_time_total, e.count) for e in device),
                     key=lambda x: -x[1])[:6]
    return {"events": sum(len(c) for c in chunks), "wall_s": wall, "stages_s": stages,
            "device_busy_share": busy, "top_device_us": kernels}




def time_ms(*fns, iters=100, reps=7):
    """Median device time per call: ``iters`` calls captured in one CUDA
    graph, call i running ``fns[i % len(fns)]``, replayed ``reps`` times
    between CUDA events (launch overhead of the eager loop is not in it);
    also the same loop run eagerly."""
    calls = [fns[i % len(fns)] for i in range(iters)]
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fns[0]()  # warm the allocator pool on the capture stream
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph_ms, eager_ms = [], []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        graph_ms.append(a.elapsed_time(b) / iters)
        a.record()
        for fn in calls:
            fn()
        b.record()
        b.synchronize()
        eager_ms.append(a.elapsed_time(b) / iters)
    return statistics.median(graph_ms), statistics.median(eager_ms)


def hot_and_cold_ms(fn, operands, iters=100):
    """``fn(*operands)`` timed two ways: L2-hot (every call on the same
    operands, which stay in the card's 50 MB L2 where they fit) and cold
    (the calls rotate over copies of the operands, ``COLD_COPIES`` or as
    many as hold ``COLD_BYTES``, more than the L2 holds in all, so each
    call reads its operands from HBM).  Returns (hot graph ms, hot eager ms,
    cold graph ms) per call."""
    hot, eager = time_ms(lambda: fn(*operands), iters=iters)
    nbytes = sum(x.nbytes for x in operands)
    n = int(min(COLD_COPIES, max(2, -(-COLD_BYTES // nbytes))))
    copies = [tuple(x.clone() for x in operands) for _ in range(n)]
    cold, _ = time_ms(*[functools.partial(fn, *c) for c in copies], iters=n)
    del copies
    return hot, eager, cold


def segmented_gather_bytes(values, mask, rows, blks, src2d) -> int:
    """Bytes one ``segmented_gather`` call must move on this data: the
    routing, each distinct block-table row it names, 1 B of mask for each
    distinct (event row, input column) that those table rows point at and
    4 B of value where that mask is set, and the outputs.  Payload the table
    names nowhere (lane padding, attributes of other versions) is not read,
    so it is not counted.  Every routed pair counts, the bucket padding's
    included, since the kernel computes those output rows too."""
    r, b = rows.cpu().numpy(), blks.cpu().numpy()
    src, m = src2d.cpu().numpy(), mask.cpu().numpy()
    pairs = np.unique(np.stack([r, b], axis=1), axis=0)
    p = src[pairs[:, 1]]
    ev = np.broadcast_to(pairs[:, :1], p.shape)
    named = p >= 0
    cells = np.unique(ev[named].astype(np.int64) * m.shape[1] + p[named])
    hits = np.count_nonzero(m.reshape(-1)[cells])
    s, w = r.size, src.shape[1]
    return int(r.nbytes + b.nbytes + np.unique(b).size * w * 4 + cells.size + 4 * hits
               + s * w * 5)


def densify_map_bytes(packed, uid_slot, uid_col, src2d, *, n_items, n_events, n_rows,
                      k) -> int:
    """Bytes one ``densify_map`` call must move on this data: the routing;
    ``starts``/``counts``/``ev_col`` of each event the routing names; the uid
    of each item those events hold (up to ``k``); the ``uid_slot`` entry of
    each distinct in-range uid, the ``uid_col`` entry of each with a slot, the
    value of each item that resolves; each distinct block-table row named;
    and the outputs.  Bucket padding of the item and event sections that no
    routed event reaches is not read, so it is not counted."""
    pk, slot, col = (x.cpu().numpy() for x in (packed, uid_slot, uid_col))
    o = 2 * n_items
    starts, counts = pk[o : o + n_events], pk[o + n_events : o + 2 * n_events]
    ev_col = pk[o + 2 * n_events : o + 3 * n_events]
    o += 3 * n_events
    rows, blks = pk[o : o + n_rows], pk[o + n_rows : o + 2 * n_rows]
    evs = np.unique(np.clip(rows, 0, n_events - 1))
    n = np.clip(counts[evs], 0, k)
    ev = np.repeat(evs, n)
    j = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
    ix = np.clip(starts[ev].astype(np.int64) + j, 0, n_items - 1)
    uid = pk[ix]
    in_range = (uid >= 0) & (uid < slot.size)
    u = uid[in_range]
    has_slot = slot[u] >= 0
    resolves = np.zeros(ix.size, bool)
    resolves[np.flatnonzero(in_range)[has_slot]] = col[u[has_slot]] == ev_col[ev[in_range][has_slot]]
    w = src2d.shape[1]
    return int(2 * n_rows * 4 + evs.size * 12 + np.unique(ix).size * 4
               + np.unique(u).size * 4 + np.unique(u[has_slot]).size * 4
               + np.unique(ix[resolves]).size * 4 + np.unique(blks).size * w * 4
               + n_rows * w * 5)


def _live_routes(n_loc, s_loc, live):
    """(n_loc, s_loc) bool: the first ``live[z]`` routing entries of each
    shard z (every entry when ``live`` is None)."""
    if live is None:
        return torch.ones((n_loc, s_loc), dtype=torch.bool)
    return torch.arange(s_loc)[None, :] < torch.as_tensor(live)[:, None]


def segmented_gather_shard_bytes(values, mask, rows, blks, src3d, live=None) -> int:
    """Bytes one ``segmented_gather_shard`` call must move on this data:
    ``segmented_gather_bytes`` over the shards' tables taken as one (shard
    z's block t is row z * P + t), so a payload byte that several shards'
    blocks name is read once; every shard's routing and outputs count.
    With ``live`` (each shard's true routing length) only the live entries
    count, as if no shard were padded to the longest."""
    n, p, w = src3d.shape
    glob = blks + torch.arange(n, dtype=blks.dtype, device=blks.device)[:, None] * p
    keep = _live_routes(n, rows.shape[1], live).to(rows.device)
    return segmented_gather_bytes(values, mask, rows[keep], glob[keep],
                                  src3d.reshape(n * p, w))


def densify_map_shard_bytes(packed, uid_slot, uid_col, src3d, *, n_items, n_events,
                            n_rows, k, n_shards, shard_lo=0, live=None) -> int:
    """Bytes one ``densify_map_shard`` call must move on this data:
    ``densify_map_bytes`` of the same chunk with the launch's shards routed
    as one table (shard z's block t is row z * P + t), so an item, a uid
    entry or an event that several shards read counts once.  ``live`` as
    for :func:`segmented_gather_shard_bytes`."""
    n_loc, p, w = src3d.shape
    pk = packed.cpu()
    o = 2 * n_items + 3 * n_events
    route = pk[o : o + 2 * n_shards * n_rows].view(2, n_shards, n_rows)
    rows = route[0, shard_lo : shard_lo + n_loc]
    blks = route[1, shard_lo : shard_lo + n_loc] + torch.arange(
        n_loc, dtype=pk.dtype)[:, None] * p
    keep = _live_routes(n_loc, n_rows, live)
    flat = torch.cat([pk[:o], rows[keep], blks[keep]])
    return densify_map_bytes(flat, uid_slot, uid_col, src3d.reshape(n_loc * p, w),
                             n_items=n_items, n_events=n_events, n_rows=int(keep.sum()), k=k)


def main_path_operands(app, chunk):
    """The device operands ``app``'s engine builds for ``chunk`` (the
    sharded engine's: its per-shard routing)."""
    from repro_torch.etl.engines import ColumnarDense

    dense = app.engine.densify(app.triage(chunk))
    plan, dev = dense.plan, app.device
    if isinstance(dense, ColumnarDense):
        return dense, plan, (torch.from_numpy(dense.packed).to(dev),)
    route = (dense.rows, dense.blks) if dense.shard_sel is not None else (
        dense.rows[0], dense.blks[0])
    return dense, plan, tuple(torch.from_numpy(a).to(dev) for a in (
        dense.vals, dense.mask, *route))


def measure_segmented_gather(app, chunk):
    from repro_torch.kernels.ref import segmented_gather_ref
    from repro_torch.kernels.segmented_gather import segmented_gather

    dense, plan, (v, m, r, b) = main_path_operands(app, chunk)
    t = plan.src2d
    kv, km = segmented_gather(v, m, r, b, t)
    rv, rm = segmented_gather_ref(v, m, r, b, t)
    if not (_bits_equal(kv, rv) and _bits_equal(km, rm)):
        raise AssertionError("segmented_gather != plain at the main-path shape")
    err = float((kv - rv).abs().max())

    def yardstick(v, m, r, b, t):
        src = t[b]
        safe = src.clamp(min=0)
        hit = (m[r].gather(1, safe) != 0) & (src >= 0)
        return torch.where(hit, v[r].gather(1, safe), 0.0), hit

    yv, ym = yardstick(v, m, r, b, t)
    if not (_bits_equal(yv, rv) and torch.equal(ym.to(torch.int8), rm)):
        raise AssertionError("yardstick != plain at the main-path shape")
    ops = (v, m, r, b, t)
    ms, eager, cold = hot_and_cold_ms(segmented_gather, ops)
    plain_ms, _, plain_cold = hot_and_cold_ms(segmented_gather_ref, ops)
    lib_ms, _, lib_cold = hot_and_cold_ms(yardstick, ops)
    return {
        "shape": {"S": int(r.numel()), "S_true": int(dense.row_ids.size),
                  "W": int(t.shape[1]), "B": int(v.shape[0]), "N_in": int(v.shape[1]),
                  "n_blocks_pad": int(t.shape[0]),
                  "blocks_touched": int(torch.unique(b).numel())},
        "max_abs_err": err, "ms": ms, "eager_ms": eager, "cold_ms": cold,
        "plain_ms": plain_ms, "plain_cold_ms": plain_cold,
        "library_ms": lib_ms, "library_cold_ms": lib_cold,
        "operand_bytes": int(sum(x.nbytes for x in ops)),
        "bytes": segmented_gather_bytes(*ops),
    }


def measure_densify_map(app, chunk):
    from repro_torch.kernels.densify_map import densify_map
    from repro_torch.kernels.ref import densify_map_packed_ref, route_offset

    dense, plan, (p,) = main_path_operands(app, chunk)
    sizes = dict(n_items=dense.n_items, n_events=dense.n_events,
                 n_rows=dense.n_rows, k=dense.k)
    tabs = (plan.uid_slot_dev, plan.uid_col_dev, plan.src2d)
    kv, km = densify_map(p, *tabs, **sizes)
    rv, rm = densify_map_packed_ref(p, *tabs, **sizes)
    if not (_bits_equal(kv, rv) and _bits_equal(km, rm)):
        raise AssertionError("densify_map != plain at the main-path shape")
    err = float((kv - rv).abs().max())
    ops = (p, *tabs)
    ms, eager, cold = hot_and_cold_ms(functools.partial(densify_map, **sizes), ops)
    plain_ms, _, plain_cold = hot_and_cold_ms(
        functools.partial(densify_map_packed_ref, **sizes), ops)
    o = route_offset(dense.n_items, dense.n_events)
    touched = np.unique(dense.packed[o + dense.n_rows : o + 2 * dense.n_rows]).size
    return {
        "shape": {"S": dense.n_rows, "S_true": int(dense.row_ids.size),
                  "W": plan.width, "NI": dense.n_items, "B": dense.n_events,
                  "K": dense.k, "packed_bytes": int(p.nbytes),
                  "blocks_touched": int(touched)},
        "max_abs_err": err, "ms": ms, "eager_ms": eager, "cold_ms": cold,
        "plain_ms": plain_ms, "plain_cold_ms": plain_cold,
        "library_ms": None, "library_cold_ms": None,
        "operand_bytes": int(sum(x.nbytes for x in ops)),
        "bytes": densify_map_bytes(*ops, **sizes),
    }


def measure_segmented_gather_shard(app, chunk):
    from repro_torch.kernels.ref import segmented_gather_shard_ref
    from repro_torch.kernels.segmented_gather import segmented_gather_shard

    dense, plan, (v, m, r, b) = main_path_operands(app, chunk)
    (t,) = plan.src3d  # every shard on the one card: one stack
    kv, km = segmented_gather_shard(v, m, r, b, t)
    rv, rm = segmented_gather_shard_ref(v, m, r, b, t)
    if not (_bits_equal(kv, rv) and _bits_equal(km, rm)):
        raise AssertionError("segmented_gather_shard != plain at the main-path shape")
    err = float((kv - rv).abs().max())

    def yardstick(v, m, r, b, t):  # batched gather + where
        src = t[torch.arange(t.shape[0], device=t.device)[:, None], b.long()]  # (n, S, W)
        safe = src.clamp(min=0).long()
        hit = (m[r].gather(2, safe) != 0) & (src >= 0)
        return torch.where(hit, v[r].gather(2, safe), 0.0), hit

    yv, ym = yardstick(v, m, r, b, t)
    if not (_bits_equal(yv, rv) and torch.equal(ym.to(torch.int8), rm)):
        raise AssertionError("yardstick != plain at the main-path shape")
    ops = (v, m, r, b, t)
    ms, eager, cold = hot_and_cold_ms(segmented_gather_shard, ops)
    plain_ms, _, plain_cold = hot_and_cold_ms(segmented_gather_shard_ref, ops)
    lib_ms, _, lib_cold = hot_and_cold_ms(yardstick, ops)
    return {
        "shape": {"shards": int(t.shape[0]), "S_loc": int(r.shape[1]),
                  "S_true": int(dense.row_ids.size),
                  "S_true_by_shard": [int(i.size) for i in dense.shard_sel],
                  "W": int(t.shape[2]), "B": int(v.shape[0]), "N_in": int(v.shape[1]),
                  "n_blocks_pad_loc": int(t.shape[1])},
        "max_abs_err": err, "ms": ms, "eager_ms": eager, "cold_ms": cold,
        "plain_ms": plain_ms, "plain_cold_ms": plain_cold,
        "library_ms": lib_ms, "library_cold_ms": lib_cold,
        "operand_bytes": int(sum(x.nbytes for x in ops)),
        "bytes": segmented_gather_shard_bytes(*ops),
        "live_bytes": segmented_gather_shard_bytes(
            *ops, live=[int(i.size) for i in dense.shard_sel]),
    }


def measure_densify_map_shard(app, chunk):
    from repro_torch.kernels.densify_map import densify_map_shard
    from repro_torch.kernels.ref import densify_map_shard_ref

    dense, plan, (p,) = main_path_operands(app, chunk)
    sizes = dict(n_items=dense.n_items, n_events=dense.n_events,
                 n_rows=dense.n_rows, k=dense.k, n_shards=dense.n_shards)
    tabs = (plan.uid_slot_dev[0], plan.uid_col_dev[0], plan.src3d[0])
    kv, km = densify_map_shard(p, *tabs, **sizes)
    rv, rm = densify_map_shard_ref(p, *tabs, **sizes)
    if not (_bits_equal(kv, rv) and _bits_equal(km, rm)):
        raise AssertionError("densify_map_shard != plain at the main-path shape")
    err = float((kv - rv).abs().max())
    ops = (p, *tabs)
    ms, eager, cold = hot_and_cold_ms(functools.partial(densify_map_shard, **sizes), ops)
    plain_ms, _, plain_cold = hot_and_cold_ms(
        functools.partial(densify_map_shard_ref, **sizes), ops)
    return {
        "shape": {"shards": dense.n_shards, "S_loc": dense.n_rows,
                  "S_true": int(dense.row_ids.size),
                  "S_true_by_shard": [int(i.size) for i in dense.shard_sel],
                  "W": plan.width, "NI": dense.n_items, "B": dense.n_events,
                  "K": dense.k, "packed_bytes": int(p.nbytes)},
        "max_abs_err": err, "ms": ms, "eager_ms": eager, "cold_ms": cold,
        "plain_ms": plain_ms, "plain_cold_ms": plain_cold,
        "library_ms": None, "library_cold_ms": None,
        "operand_bytes": int(sum(x.nbytes for x in ops)),
        "bytes": densify_map_shard_bytes(*ops, **sizes),
        "live_bytes": densify_map_shard_bytes(
            *ops, **sizes, live=[int(i.size) for i in dense.shard_sel]),
    }


def block_groups(app, chunk):
    """The per-block engine's device operands for ``chunk``: per (o, v)
    group with blocks, (B, values, mask, src of its first block), sorted by
    B."""
    app.reset_dedup()
    dense = app.engine.densify(app.triage(chunk))
    dev = app.device
    out = []
    for g, ov in enumerate(dense.columns):
        blocks = dense.plan.column(*ov)
        if blocks:
            vals, mask = dense.payload(g)
            out.append((vals.shape[0], torch.from_numpy(vals).to(dev),
                        torch.from_numpy(mask).to(dev), blocks[0].src_dev))
    out.sort(key=lambda g: g[0])
    return out


def per_block_bytes(values, mask, src, *, reads_all: bool) -> int:
    """Bytes one per-block call must move on this data: ``src``; the
    outputs; and either (``masked_gather``) 1 B of mask for each event row
    and distinct input column a live ``src`` entry names plus the value
    where that mask is set, or (``onehot_map``, whose contraction reads
    every payload slot) the whole values and mask."""
    v, m, s = (x.cpu() for x in (values, mask, src))
    b, e = v.shape[0], v.element_size()
    out = b * s.numel() * (e + 1)
    if reads_all:
        return int(s.nbytes + v.nbytes + m.nbytes + out)
    named = torch.unique(s[s >= 0]).long()
    hits = int((m[:, named] != 0).sum())
    return int(s.nbytes + b * named.numel() + hits * e + out)


def measure_per_block(name, group, fp32_peak):
    """Time one per-block kernel on a group's operands beside its plain
    version and a PyTorch yardstick, hot and cold, with its bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.masked_gather import masked_gather
    from repro_torch.kernels.onehot_map import onehot_map

    b, v, m, src = group
    ops = (v, m, src)
    if name == "masked_gather":
        kernel, plain, atol = masked_gather, ref.masked_gather_ref, None
        valid = src >= 0
        safe = torch.where(valid, src, 0).long()

        def yardstick(v, m, safe, valid):  # index_select + where
            hit = (m.index_select(1, safe) != 0) & valid
            return torch.where(hit, v.index_select(1, safe), 0.0), hit

        lib_ops = (v, m, safe, valid)
    else:
        kernel, plain, atol = onehot_map, ref.onehot_map_ref, ONEHOT_ATOL
        cols = torch.arange(v.shape[1], dtype=src.dtype, device=src.device)
        onehot_t = (src[:, None] == cols[None, :]).float().t().contiguous()  # (N_in, N_out)

        def yardstick(v, mf, onehot_t):  # two IEEE float32 matmuls
            return torch.matmul(v, onehot_t), torch.matmul(mf, onehot_t)

        lib_ops = (v, m.float(), onehot_t)
    kv, km = kernel(*ops)
    rv, rm = plain(*ops)
    if not _close(kv, km, rv, rm, atol):
        raise AssertionError(f"{name} != plain at the main-path shape B={b}")
    err = float((kv.float() - rv.float()).abs().max())
    yv, ym = yardstick(*lib_ops)
    if name == "masked_gather":
        ok = _bits_equal(yv, rv) and torch.equal(ym.to(torch.int8), rm)
    else:
        ok = torch.equal((ym > 0.5).to(torch.int8), rm) and bool(torch.allclose(
            torch.where(ym > 0.5, yv, 0.0), rv, rtol=0.0, atol=ONEHOT_ATOL))
    if not ok:
        raise AssertionError(f"{name} yardstick != plain at the main-path shape")
    ms, eager, cold = hot_and_cold_ms(kernel, ops)
    plain_ms, _, plain_cold = hot_and_cold_ms(plain, ops)
    lib_ms, _, lib_cold = hot_and_cold_ms(yardstick, lib_ops)
    n_bytes = per_block_bytes(v, m, src, reads_all=name == "onehot_map")
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    flops = 2 * 2 * v.shape[0] * v.shape[1] * src.numel() if name == "onehot_map" else 0
    ops_ms = flops / fp32_peak * 1e3
    return {
        "shape": {"B": int(b), "N_in": int(v.shape[1]), "N_out_pad": int(src.numel())},
        "max_abs_err": err, "ms": ms, "eager_ms": eager, "cold_ms": cold,
        "plain_ms": plain_ms, "plain_cold_ms": plain_cold,
        "library_ms": lib_ms, "library_cold_ms": lib_cold,
        "bytes": n_bytes, "flops": flops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
    }


def launch_floor() -> dict:
    """Device time per launch of an empty kernel (``csrc/launch_floor.cu``,
    built with the kernels' flags and bound with ctypes as they are), by
    :func:`time_ms`: what any launch costs the card."""
    from repro_torch.kernels import build

    fn = build.load("launch_floor").metl_empty
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int

    def empty():
        if fn(torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("the empty kernel did not launch")

    ms, eager = time_ms(empty, iters=200)
    return {"ms": ms, "eager_ms": eager}


def per_block_host(app, chunks) -> dict:
    """Host microseconds per dispatched block over ``chunks`` (no profiler),
    two routes in one run.  The launcher: the engine's own stages, dispatch
    time over its dispatches.  The op-level route, as the engine dispatched
    before it had the launcher: per group ``pin_memory`` and ``.to`` of values
    and mask, per block ``ops.dmm_apply``; timed as one eager loop."""
    from repro_torch.kernels import ops

    eng, dev = app.engine, app.engine.device
    impl = eng.impl
    pc = time.perf_counter
    stages = dict.fromkeys(("triage", "densify", "dispatch", "emit"), 0.0)
    d0, t0_copies = app.stats["dispatches"], app.stats["transfers"]
    app.reset_dedup()
    torch.cuda.synchronize()
    t_wall = pc()
    for chunk in chunks:
        t0 = pc()
        tri = app.triage(chunk)
        t1 = pc()
        dense = eng.densify(tri)
        t2 = pc()
        handle = eng.dispatch(dense)
        t3 = pc()
        eng.emit(handle)
        t4 = pc()
        for name, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            stages[name] += dt
    wall = pc() - t_wall
    n_disp = app.stats["dispatches"] - d0
    out = {"events": sum(len(c) for c in chunks), "dispatches": n_disp,
           "transfers": app.stats["transfers"] - t0_copies, "wall_s": wall,
           "stages_s": stages, "launcher_us_per_block": stages["dispatch"] * 1e6 / n_disp}

    # the op-level route: per group pin_memory and .to, per block ops.dmm_apply
    total, n = 0.0, 0
    app.reset_dedup()
    for chunk in chunks:
        dense = eng.densify(app.triage(chunk))
        # fresh pageable arrays per group, as that route's densify made them
        payloads = [[a.copy() for a in dense.payload(g)]
                    for g in range(len(dense.columns))]
        torch.cuda.synchronize()
        t_loop = pc()
        for ov, (vals, mask) in zip(dense.columns, payloads):
            jv, jm = (torch.from_numpy(a).pin_memory().to(dev, non_blocking=True)
                      for a in (vals, mask))
            for block in dense.plan.column(*ov):
                ops.dmm_apply(jv, jm, block.src_dev, impl=impl)
                n += 1
        total += pc() - t_loop
        torch.cuda.synchronize()
    out["op_level_us_per_block"] = total * 1e6 / n
    return out


def _to_device(device, *arrays):
    """The engines' host->device copy site before the arenas: each array
    copied into fresh pinned memory and sent with ``non_blocking=True``.
    Returns the device tensors and the pinned buffers, which live until the
    chunk is emitted."""
    staging = tuple(torch.from_numpy(a).pin_memory() for a in arrays)
    return tuple(h.to(device, non_blocking=True) for h in staging), staging


def _op_level_emit(eng, dense, outputs):
    """Emit as the engines did before the one readback: a pageable
    ``.cpu()`` of the values and one of the mask, then the row emission."""
    from repro_torch.etl.engines import _emit_rows, _emit_shards

    if dense.shard_sel is None:
        s = dense.row_ids.size
        ov, om = (x[:s].cpu().numpy() for x in outputs)
        return _emit_rows(dense.plan, ov, om, dense.blk_ids, dense.out_keys, eng.stats)
    return _emit_shards(dense, *(x.cpu().numpy() for x in outputs), eng.stats)


def _device_densify_op_level(eng, dense):
    """Device densify's op-level route: ``_to_device`` of a fresh copy of
    the packed buffer, then ``ops.dmm_apply_columnar*``."""
    from repro_torch.kernels import ops

    (p,), staging = _to_device(eng.device, dense.packed.copy())
    plan, sizes = dense.plan, dense.sizes()
    if dense.n_shards == 1:
        return ops.dmm_apply_columnar(p, plan.uid_slot_dev, plan.uid_col_dev, plan.src2d,
                                      **sizes), staging
    return ops.dmm_apply_columnar_sharded(
        p, plan.uid_slot_dev, plan.uid_col_dev, plan.src3d, mesh=eng.mesh,
        n_shards=dense.n_shards, **sizes), staging


def _host_densify_operands(dense):
    """What host densify handed its dispatch before the arenas, made
    outside the clock: fresh pageable payload arrays and, for the fused
    engine, the unpadded routing (its dispatch padded it)."""
    if dense.shard_sel is None:
        return dense.vals.copy(), dense.mask.copy(), dense.row_ids, dense.blk_ids
    return dense.vals.copy(), dense.mask.copy(), dense.rows.copy(), dense.blks.copy()


def _host_densify_op_level(eng, dense, vals, mask, rows, blks):
    """Host densify's op-level route: (fused) ``np.pad`` of the routing,
    ``_to_device`` of the four arrays, then ``ops.dmm_apply_fused`` /
    ``dmm_apply_sharded``."""
    from repro_torch.core.dmm_torch import bucket_rows
    from repro_torch.kernels import ops

    plan = dense.plan
    if dense.shard_sel is None:
        pad = bucket_rows(rows.size) - rows.size
        operands, staging = _to_device(eng.device, vals, mask, np.pad(rows, (0, pad)),
                                       np.pad(blks, (0, pad)))
        return ops.dmm_apply_fused(*operands, plan.src2d), staging
    operands, staging = _to_device(eng.device, vals, mask, rows, blks)
    return ops.dmm_apply_sharded(*operands, plan.src3d, mesh=eng.mesh), staging


def host_split(app, chunks) -> dict:
    """Host microseconds per chunk of ``dispatch`` and ``emit`` over
    ``chunks`` (no profiler), two routes in one run, in turns chunk by
    chunk (engine first on even chunks, op-level first on odd ones).  The
    engine's: one op call from the pinned arena (four copies or one, and
    the launch, in one C call), emit's one readback.  The op-level route it
    replaced: ``_to_device`` (``pin_memory`` and ``.to`` of each array;
    device densify: of a fresh copy of the packed buffer), the op
    (``ops.dmm_apply_fused`` / ``dmm_apply_sharded``, or
    ``ops.dmm_apply_columnar*``), and emit's two ``.cpu()`` readbacks before
    the same row emission.  Each chunk is re-triaged after a dedup reset;
    the op-level route's rows are counted in a throwaway counter."""
    import collections

    from repro_torch.etl.engines import ColumnarDense

    eng, pc = app.engine, time.perf_counter
    stats = eng.stats
    times = {f"{route}_{stage}": 0.0 for route in ("engine", "op_level")
             for stage in ("dispatch", "emit")}
    for i, chunk in enumerate(chunks):
        for route in (("engine", "op_level") if i % 2 == 0 else ("op_level", "engine")):
            app.reset_dedup()
            dense = eng.densify(app.triage(chunk))
            device = isinstance(dense, ColumnarDense)
            operands = () if device or route == "engine" else _host_densify_operands(dense)
            eng.stats = stats if route == "engine" else collections.Counter()
            torch.cuda.synchronize()
            t0 = pc()
            if route == "engine":
                handle = eng.dispatch(dense)
                t1 = pc()
                eng.emit(handle)
            else:
                out, staging = (_device_densify_op_level(eng, dense) if device
                                else _host_densify_op_level(eng, dense, *operands))
                t1 = pc()
                _op_level_emit(eng, dense, out)
                del staging  # the readbacks waited for the copies that read it
            t2 = pc()
            times[f"{route}_dispatch"] += t1 - t0
            times[f"{route}_emit"] += t2 - t1
    eng.stats = stats
    return {"chunks": len(chunks), **{f"{k}_us": t * 1e6 / len(chunks) for k, t in times.items()}}


# -- phase 3 (model kernels) ---------------------------------------------------

# (N, S, T, hd, n_rep, causal): tests/test_kernels_flash.py's shapes, then the
# cases the port adds: ragged non-causal T, causal S > T with ragged T, the
# smoke configs' head dims, many key tiles, and the olmo-1b (16 heads), phi3
# -medium (40 on 10 KV heads) and llama3-405b (128 on 8) layouts at hd 128
FLASH_CASES = [
    (1, 64, 64, 64, 1, True), (4, 128, 128, 64, 1, True), (8, 300, 300, 64, 2, True),
    (2, 256, 256, 128, 1, False), (6, 64, 512, 64, 3, True), (4, 257, 257, 128, 4, True),
    (2, 100, 100, 64, 1, False), (3, 37, 130, 128, 1, False), (2, 100, 50, 64, 1, True),
    (3, 40, 40, 8, 1, True), (4, 33, 33, 16, 2, True), (1, 64, 2048, 64, 1, True),
    (32, 1024, 1024, 128, 1, True), (40, 512, 512, 128, 4, True),
    (128, 256, 256, 128, 16, True),
    # head dims the tensor-core kernel pads to 64 (24, 40) or 128 (72, 120),
    # causal and ragged non-causal
    (2, 130, 130, 24, 1, True), (2, 100, 77, 24, 1, False),
    (4, 257, 257, 40, 2, True), (2, 64, 190, 40, 1, False),
    (2, 200, 200, 72, 1, True), (3, 90, 133, 72, 3, False),
    (4, 160, 160, 120, 2, True), (2, 37, 150, 120, 1, False),
]
# (T, E, C, D): tests/test_kernels.py's sweep, then the qwen3-moe group
MOE_CASES = [(8, 2, 4, 32), (64, 8, 16, 96), (130, 4, 8, 256), (256, 16, 8, 128),
             (512, 128, 40, 2048)]
# combine's density sweep, weights a token: one, the reference tests' two,
# dbrx's four, qwen3-moe's eight, every weight (None), none (0)
MOE_DENSITIES = (1, 2, 4, 8, None, 0)
# the timing groups: (T, E, C, D, weights a token; None: every weight); C is
# repro/models/moe.py's _capacity(512) at capacity factor 1.25
MOE_GROUPS = {
    "qwen3-moe": (512, 128, 40, 2048, 8),
    "dbrx": (512, 16, 160, 6144, 4),
    "qwen3-moe dense": (512, 128, 40, 2048, None),
}


def _allclose(got, want, atol, rtol, equal_nan=False) -> bool:
    return got.dtype == want.dtype and got.shape == want.shape and bool(torch.allclose(
        got.float(), want.float(), atol=atol, rtol=rtol, equal_nan=equal_nan))


def flash_operands(device, n, s, t, hd, n_rep, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device, dtype)
                 for shape in ((n, s, hd), (n // n_rep, t, hd), (n // n_rep, t, hd)))


def limit_share(got, want, atol, rtol) -> float:
    """Largest |got - want| / (atol + rtol |want|): below 1 is allclose."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() / (atol + rtol * w.abs())).max())


def flash_fault_ref(q, k, v, fault: str) -> torch.Tensor:
    """The plain version (causal, n_rep 1) with one planted fault of the kind
    a wrong tensor-core kernel makes, each where outputs are small: ``p_fp8``
    rounds p to float8 e4m3 where the kernel rounds it to bfloat16;
    ``skip_tile`` drops keys 0-127 for the second warpgroup's 64 rows of
    every 128-row block from row 512 on; ``diag_plus_1`` counts key i + 1
    for every row i from 512 on."""
    s, t, hd = q.shape[1], k.shape[1], q.shape[2]
    x = torch.matmul(q.float(), k.float().transpose(1, 2)) / math.sqrt(hd)
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(t, device=q.device)[None, :]
    keep = i >= j
    if fault == "diag_plus_1":
        keep = keep | ((j == i + 1) & (i >= 512))
    elif fault == "skip_tile":
        keep = keep & ~((i >= 512) & (i % 128 >= 64) & (j < 128))
    elif fault != "p_fp8":
        raise ValueError(f"no fault {fault!r}")
    x = torch.where(keep[None], x, -1e30)
    p = torch.exp(x - x.amax(-1, keepdim=True))
    pv = p.to(torch.float8_e4m3fn).float() if fault == "p_fp8" else p
    return (torch.matmul(pv, v.float()) / p.sum(-1, keepdim=True)).to(q.dtype)


def flash_limit_power(q, k, v, got, want) -> dict:
    """The bfloat16 limit's reading (``limit_share``) of the kernel's output
    and of each planted fault, beside the reference's 3e-2; raises unless the
    kernel passes the limit and every fault fails it."""
    tol = FLASH_TOL[torch.bfloat16]
    outs = {"kernel": got, **{f: flash_fault_ref(q, k, v, f) for f in FLASH_FAULTS}}
    out = {name: {"limit": limit_share(o, want, *tol), "ref_tol": limit_share(o, want, *REF_BF16_TOL)}
           for name, o in outs.items()}
    if out["kernel"]["limit"] >= 1 or min(out[f]["limit"] for f in FLASH_FAULTS) <= 1:
        raise AssertionError(f"the bf16 limit {tol} does not split the kernel from its faults: {out}")
    return out


def check_flash_attention(device: torch.device) -> int:
    """Every case in float32 (the FFMA kernel) and bfloat16 (the tensor-core
    kernel: every head dim here is a multiple of 8); prints each bfloat16
    case's largest error and its share of the limit, and the limit's power
    against planted faults at the largest causal case."""
    from repro_torch.kernels.flash_attention import flash_attention, kernel_variant
    from repro_torch.kernels.ref import attention_ref

    n_cases, readings = 0, {}
    for n, s, t, hd, n_rep, causal in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            variant = kernel_variant(dtype, hd)
            if variant != ("wgmma" if dtype == torch.bfloat16 else "ffma"):
                raise AssertionError(f"flash_attention {dtype} hd {hd} would run {variant}")
            q, k, v = flash_operands(device, n, s, t, hd, n_rep, dtype)
            got = flash_attention(q, k, v, causal=causal, n_rep=n_rep)
            want = attention_ref(q, k, v, causal=causal, n_rep=n_rep)
            atol, rtol = FLASH_TOL[dtype]
            if t >= 2048:
                atol = 5e-5 if dtype == torch.float32 else atol  # the reference's own
            err = float((got.float() - want.float()).abs().max())
            if not _allclose(got, want, atol, rtol):
                raise AssertionError(
                    f"flash_attention != plain at N={n} S={s} T={t} hd={hd} n_rep={n_rep} "
                    f"causal={causal} {dtype}: max abs err {err}")
            if dtype == torch.bfloat16:
                readings[f"{n},{s},{t},{hd},{n_rep},{int(causal)}"] = (
                    err, limit_share(got, want, atol, rtol))
                if causal and n_rep == 1 and s >= 1024:
                    power = flash_limit_power(q, k, v, got, want)
                    print(f"flash bf16 limit {FLASH_TOL[dtype]} at N={n} S={s} T={t} hd={hd}: "
                          + json.dumps(power), flush=True)
            n_cases += 1
    print("flash bf16 (max abs err, share of the limit) by N,S,T,hd,n_rep,causal: "
          + json.dumps(readings), flush=True)
    return n_cases


def moe_arrays(t, e, c, d, *, top_k=2, seed=None, plant=()):
    """numpy float32 (combine (T, E, C), expert_out (E, C, D)): expert_out
    normal; combine with ``top_k`` router weights a token (as the reference
    test builds it: random slots, weights in [0, 1)), every weight non-zero
    for ``top_k=None``.  ``plant`` adds, by name: ``"empty_token"`` token 0
    without a weight; ``"nonfinite_expert"`` a NaN in column 5 % D and an
    inf in column 1 % D of two expert_out slots that no weight names (any
    slots if every one is named); ``"nonfinite_weight"`` a NaN in place of
    one of token 1's weights and an inf weight of token 2 % T in a slot no
    weight names."""
    rng = np.random.default_rng(hash((t, e, c, d)) % 2**31 if seed is None else seed)
    eo = rng.normal(size=(e, c, d)).astype(np.float32)
    if top_k is None:
        cw = rng.random((t, e, c), dtype=np.float32) + np.float32(1e-3)
    else:
        cw = np.zeros((t, e, c), np.float32)
        for ti in range(t):
            for _ in range(top_k):
                cw[ti, rng.integers(e), rng.integers(c)] = rng.random()
    flat, rows = cw.reshape(t, e * c), eo.reshape(e * c, d)
    unnamed = np.flatnonzero(~(flat != 0).any(0))
    spare = unnamed if unnamed.size >= 2 else np.arange(e * c)
    for kind in plant:
        if kind == "empty_token":
            flat[0] = 0
        elif kind == "nonfinite_expert":
            rows[spare[0], 5 % d] = np.nan
            rows[spare[-1], 1 % d] = np.inf
        elif kind == "nonfinite_weight":
            named = np.flatnonzero(flat[1 % t])
            flat[1 % t, named[0] if named.size else 0] = np.nan
            flat[2 % t, spare[0]] = np.inf
        else:
            raise ValueError(f"no plant {kind!r}")
    return cw, eo


def check_moe_case(cw, eo) -> float:
    """``moe_combine`` on the card against its plain version on the same
    operands: inf and NaN exactly where the plain version has them, every
    other output within ``MOE_TOL``, and a second call bit-identical to the
    first.  Raises on a mismatch; returns the largest |error| over the
    outputs the two agree are finite."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import moe_combine_ref

    got = ops.moe_combine(eo, cw)
    again = ops.moe_combine(eo, cw)
    want = moe_combine_ref(eo, cw)
    where = (f"T,E,C,D={tuple(cw.shape) + (eo.shape[-1],)} combine {cw.dtype} "
             f"expert_out {eo.dtype}")
    if not _allclose(got, want, *MOE_TOL[eo.dtype], equal_nan=True):
        raise AssertionError(f"moe_combine != plain at {where}: non-finite outputs "
                             f"{int((~got.isfinite()).sum())} against "
                             f"{int((~want.isfinite()).sum())}")
    if not _bits_equal(got, again):
        raise AssertionError(f"moe_combine differs between two calls at {where}")
    finite = want.isfinite()
    return float((got.float() - want.float())[finite].abs().max()) if finite.any() else 0.0


def check_moe_combine(device: torch.device) -> dict:
    """Every ``MOE_CASES`` shape at every ``MOE_DENSITIES`` density with a
    weightless token, then with non-finite values planted in expert_out
    and in combine (whose NaNs must reach where the plain version puts
    them), in three dtype pairs.  Returns the case counts and largest
    errors."""
    pairs = ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
             (torch.bfloat16, torch.bfloat16))
    nonfinite = [(shape, 8 if shape[1] == 128 else 2, (kind,)) for shape in MOE_CASES
                 for kind in ("nonfinite_expert", "nonfinite_weight")]
    cases = [(shape, top_k, ("empty_token",)) for shape in MOE_CASES
             for top_k in MOE_DENSITIES] + nonfinite
    worst = {str(edt): 0.0 for edt in (torch.float32, torch.bfloat16)}
    for shape, top_k, plant in cases:
        arrays = moe_arrays(*shape, top_k=top_k, plant=plant)
        for cdt, edt in pairs:
            cw, eo = (torch.from_numpy(a).to(device, dt) for a, dt in zip(arrays, (cdt, edt)))
            worst[str(edt)] = max(worst[str(edt)], check_moe_case(cw, eo))
    return {"cases": len(cases) * len(pairs), "nonfinite_cases": len(nonfinite) * len(pairs),
            "max_abs_err": worst}


# -- phase 5: serving olmo-1b --------------------------------------------------

SERVE_BATCH, PROMPT_LEN = 2, 2048
TEACHER_STEPS = 32


def _to(tree, device, dtype=None):
    if isinstance(tree, dict):
        return {k: _to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device, dtype) for v in tree]
    return tree.to(device, dtype) if dtype is not None else tree.to(device)


def _logit_stats(got, want) -> dict:
    g, w = got.float(), want.float()
    return {"max_abs_err": float((g - w).abs().max()),
            "max_abs_logit": float(w.abs().max()),
            "argmax_agree": float((g.argmax(-1) == w.argmax(-1)).float().mean()),
            "finite": bool(torch.isfinite(g).all())}


def _check_close(name, got, want, tol) -> dict:
    stats = _logit_stats(got, want)
    if not (stats["finite"] and bool(torch.allclose(got.float(), want.float(),
                                                    atol=tol[0], rtol=tol[1]))):
        raise AssertionError(f"{name}: not within atol={tol[0]} rtol={tol[1]}: {stats}")
    return stats


def _prompts(vocab, n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=int(rng.integers(lo, hi + 1))).tolist()
            for _ in range(n)]


def _timed(fn, reps=3):
    """Median host seconds of ``fn()`` ending in a device sync, after one
    warm-up call; returns (seconds, last result)."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def prefill_profile(params, cfg, batch) -> dict:
    """Device busy share of one prefill's wall time, ``flash_attention``'s
    share of its device time and the flash kernels by name (device µs,
    launches), from ``torch.profiler`` (None where the profiler records no
    device time)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model as M

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        M.forward(params, cfg, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in device)
    flash_us = sum(e.self_device_time_total for e in device if "flash_attention" in e.key)
    top = sorted(((e.key[:60], e.self_device_time_total, e.count) for e in device),
                 key=lambda x: -x[1])[:6]
    flash = {e.key: (e.self_device_time_total, e.count) for e in device
             if "flash_attention" in e.key}
    return {"wall_s": wall, "device_us": busy_us, "flash_attention_us": flash_us,
            "flash_kernels": flash,
            "device_busy_share": busy_us * 1e-6 / wall if busy_us > 0 else None,
            "flash_attention_share": flash_us / busy_us if busy_us > 0 else None,
            "top_device_us": top}


def run_server(params, cfg, device, sc, prompts):
    """A ``Server`` on ``device`` answering ``prompts``; returns (done,
    seconds, device steps, launch counts over the run)."""
    from repro_torch.serve.decode import Server

    server = Server(params, cfg, sc, device=device)
    rids = [server.submit(p) for p in prompts]
    _zero_launch_counts()
    t0 = time.perf_counter()
    server.run(n_steps=len(prompts) * (sc.max_new + 40))
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launch_counts()
    for rid in rids:
        if len(server.done.get(rid, ())) != sc.max_new:
            raise AssertionError(f"server on {device}: request {rid} got "
                                 f"{len(server.done.get(rid, ()))} of {sc.max_new} tokens")
    return [server.done[r] for r in rids], seconds, server.steps, launches


def decode_step_ms(params, cfg, device, batch, cache_len, fill) -> float:
    """Median device ms of one batch-``batch`` serve step on a cache already
    holding ``fill`` positions (host clock around synchronised steps)."""
    from repro_torch.models import model as M
    from repro_torch.serve.decode import make_serve_step

    step = make_serve_step(cfg)
    state = M.init_decode_state(cfg, batch, cache_len, device=device)
    state["pos"] = fill
    tok = torch.full((batch,), 7, dtype=torch.int32, device=device)
    times = []
    for i in range(25):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, _, state = step(params, state, tok)
        torch.cuda.synchronize()
        if i >= 5:
            times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def serving_path(dev: torch.device) -> dict:
    """Phase 5 (see the module docstring); returns the numbers it measured
    and ``flash_attention``'s launches in the bf16 prefill."""
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.serve.decode import ServeConfig

    cfg = configs.get("olmo_1b")  # bfloat16, 16 layers, full width
    fa = cfg.replace(attn_impl="pallas")
    out = {"config": {"name": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                      "n_heads": cfg.n_heads, "hd": cfg.hd, "d_ff": cfg.d_ff,
                      "vocab_padded": cfg.vocab_padded, "params": cfg.param_count()}}
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(2, cfg.vocab, (SERVE_BATCH, PROMPT_LEN))).to(dev)
    batch = {"tokens": tokens}

    # (a) the prefill, bfloat16: counts zeroed just before, read just after
    _zero_launch_counts()
    logits, _ = M.forward(params, fa, batch)
    torch.cuda.synchronize()
    launches = _launch_counts()
    want = {n: (cfg.n_layers if n == "flash_attention" else 0) for n in KERNEL_NAMES}
    if launches != want:
        raise AssertionError(f"prefill launches {launches}, want {want}")
    dense, _ = M.forward(params, cfg, batch)
    out["prefill_bf16_vs_dense"] = _logit_stats(logits, dense)
    if not (out["prefill_bf16_vs_dense"]["finite"]
            and out["prefill_bf16_vs_dense"]["argmax_agree"] >= BF16_ARGMAX_AGREE):
        raise AssertionError(f"bf16 prefill vs dense: {out['prefill_bf16_vs_dense']}")
    if logits.shape != (SERVE_BATCH, PROMPT_LEN, cfg.vocab_padded):
        raise AssertionError(f"prefill logits {tuple(logits.shape)}")
    del logits, dense
    prefill_s, _ = _timed(lambda: M.forward(params, fa, batch))
    dense_s, _ = _timed(lambda: M.forward(params, cfg, batch))
    out["prefill_flash_attention_launches"] = launches["flash_attention"]
    out["prefill_s"], out["prefill_dense_s"] = prefill_s, dense_s
    out["prefill_tokens_per_s"] = SERVE_BATCH * PROMPT_LEN / prefill_s
    out["prefill_dense_tokens_per_s"] = SERVE_BATCH * PROMPT_LEN / dense_s
    out["prefill_profile"] = prefill_profile(params, fa, batch)
    flash_kernels = out["prefill_profile"]["flash_kernels"]
    print(f"{elapsed()} prefill flash kernels (bf16): " + json.dumps(flash_kernels), flush=True)
    counts = [c for name, (_, c) in flash_kernels.items()
              if "flash_attention_wgmma_kernel" in name]
    if len(flash_kernels) != 1 or counts != [cfg.n_layers]:
        raise AssertionError(f"the bf16 prefill's flash kernels {flash_kernels}: want "
                             f"{cfg.n_layers} launches of the tensor-core kernel and no other")
    print(f"{elapsed()} serving (a) bf16 prefill: " + json.dumps(
        {k: out[k] for k in ("prefill_bf16_vs_dense", "prefill_flash_attention_launches",
                             "prefill_s", "prefill_tokens_per_s", "prefill_dense_s",
                             "prefill_profile")}), flush=True)

    # (c) serving: 16 requests through a batch-8 server
    sc = ServeConfig(batch=8, cache_len=1024, max_new=32, eos=-1)
    prompts = _prompts(cfg.vocab, 16, 4, 32, seed=1)
    _, seconds, steps, launches = run_server(params, cfg, dev, sc, prompts)
    out["server"] = {"requests": len(prompts), "prompt_tokens": sum(map(len, prompts)),
                     "new_tokens": len(prompts) * sc.max_new, "seconds": seconds,
                     "steps": steps, "ms_per_step": seconds / steps * 1e3,
                     "new_tokens_per_s": len(prompts) * sc.max_new / seconds,
                     "launches": launches}
    step_ms = decode_step_ms(params, cfg, dev, sc.batch, sc.cache_len, fill=512)
    out["decode_ms_per_step_b8"] = step_ms
    out["decode_tokens_per_s_b8"] = sc.batch / step_ms * 1e3
    print(f"{elapsed()} serving (c) server: " + json.dumps(
        {k: out[k] for k in ("server", "decode_ms_per_step_b8", "decode_tokens_per_s_b8")}),
        flush=True)
    del params

    # (a) float32 and (b) teacher forcing
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    fa32 = cfg32.replace(attn_impl="pallas")
    params32 = M.init_params(cfg32, torch.Generator(device=dev).manual_seed(0), device=dev)
    _zero_launch_counts()
    logits, _ = M.forward(params32, fa32, batch)
    torch.cuda.synchronize()
    if _launch_counts()["flash_attention"] != cfg.n_layers:
        raise AssertionError("float32 prefill: flash_attention launches != 16")
    dense, _ = M.forward(params32, cfg32, batch)
    out["prefill_f32_vs_dense"] = _check_close("f32 prefill vs dense", logits, dense,
                                               SERVE_F32_TOL)
    del logits, dense
    head = {"tokens": tokens[:, :TEACHER_STEPS]}
    full, _ = M.forward(params32, fa32, head)
    state = M.init_decode_state(cfg32, SERVE_BATCH, TEACHER_STEPS, device=dev)
    steps = []
    for t in range(TEACHER_STEPS):
        step_logits, state = M.decode_step(params32, cfg32, state, tokens[:, t])
        steps.append(step_logits)
    out["teacher_forcing_f32"] = _check_close("f32 decode vs prefill",
                                              torch.stack(steps, 1), full, SERVE_F32_TOL)
    print(f"{elapsed()} serving (a, b) float32: " + json.dumps(
        {k: out[k] for k in ("prefill_f32_vs_dense", "teacher_forcing_f32")}), flush=True)
    del params32, full, steps, state

    # (d) card against CPU: 2 layers at full width, float32
    cfg2 = cfg32.replace(n_layers=2, attn_impl="pallas")
    cpu = torch.device("cpu")
    params_cpu = M.init_params(cfg2, 0, device=cpu)
    params_dev = _to(params_cpu, dev)
    short = {"tokens": tokens[:, :256]}
    l_dev, _ = M.forward(params_dev, cfg2, short)
    l_cpu, _ = M.forward(params_cpu, cfg2, _to(short, cpu))
    out["card_vs_cpu_f32"] = _check_close("card vs cpu prefill", l_dev.cpu(), l_cpu,
                                          CARD_CPU_TOL)
    sc2 = ServeConfig(batch=4, cache_len=64, max_new=8, eos=-1)
    prompts2 = _prompts(cfg.vocab, 6, 2, 7, seed=2)
    done_dev, _, _, _ = run_server(params_dev, cfg2, dev, sc2, prompts2)
    done_cpu, _, _, _ = run_server(params_cpu, cfg2, cpu, sc2, prompts2)
    if done_dev != done_cpu:
        raise AssertionError(f"server tokens differ: card {done_dev} cpu {done_cpu}")
    out["card_vs_cpu_f32"]["server_tokens_equal"] = len(done_dev)
    print(f"{elapsed()} serving (d) card vs cpu: " + json.dumps(out["card_vs_cpu_f32"]),
          flush=True)
    return out


# -- phase 6: timing of the model kernels ----------------------------------------


def measure_flash_attention():
    """``flash_attention`` (its tensor-core kernel) at the olmo-1b prefill's
    shape (N = 2 x 16 heads, S = T = 2048, hd 128, bfloat16, causal) beside
    its plain version and ``F.scaled_dot_product_attention`` (timed here
    only), with the rate of causal work and the share of the bound each
    reaches, and the bfloat16 limit's power at this shape."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref

    n, s, hd = SERVE_BATCH * 16, PROMPT_LEN, 128
    q, k, v = flash_operands(torch.device("cuda"), n, s, s, hd, 1, torch.bfloat16, seed=5)
    got = flash_attention(q, k, v)
    want = attention_ref(q, k, v)
    if not _allclose(got, want, *FLASH_TOL[torch.bfloat16]):
        raise AssertionError("flash_attention != plain at the prefill shape")
    err = float((got.float() - want.float()).abs().max())
    power = flash_limit_power(q, k, v, got, want)

    def library(q, k, v):
        return F.scaled_dot_product_attention(q[None], k[None], v[None], is_causal=True)[0]

    lib_out = library(q, k, v)
    if not _allclose(lib_out, want, *REF_BF16_TOL):
        raise AssertionError("scaled_dot_product_attention != plain at the prefill shape")
    lib_share = limit_share(lib_out, want, *FLASH_TOL[torch.bfloat16])
    del lib_out
    ops = (q, k, v)
    ms, eager, cold = hot_and_cold_ms(flash_attention, ops, iters=20)
    plain_ms, _, plain_cold = hot_and_cold_ms(attention_ref, ops, iters=10)
    lib_ms, _, lib_cold = hot_and_cold_ms(library, ops, iters=20)
    # the same loop without the causal skip, masks and load imbalance: the
    # rate of the kernel's steady state (twice the work)
    full_ms, _ = time_ms(lambda: flash_attention(q, k, v, causal=False), iters=20)
    n_bytes = 4 * n * s * hd * 2  # q, k, v read once, out written once
    flops = 4 * n * hd * (s * (s + 1) // 2)  # q.k and p.v over the causal half
    bytes_ms, ops_ms = n_bytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_PER_S * 1e3
    bound = max(bytes_ms, ops_ms)
    return {
        "shape": {"N": n, "S": s, "T": s, "hd": hd, "dtype": "bfloat16", "causal": True},
        "max_abs_err": err, "ms": ms, "eager_ms": eager, "cold_ms": cold,
        "plain_ms": plain_ms, "plain_cold_ms": plain_cold,
        "library_ms": lib_ms, "library_cold_ms": lib_cold,
        "limit": FLASH_TOL[torch.bfloat16], "limit_power": power,
        "library_limit_share": lib_share,
        "tflops": flops / ms * 1e-9, "cold_tflops": flops / cold * 1e-9,
        "library_tflops": flops / lib_ms * 1e-9,
        "noncausal_ms": full_ms, "noncausal_tflops": 4 * n * hd * s * s / full_ms * 1e-9,
        "bound_share": bound / ms, "cold_bound_share": bound / cold,
        "library_bound_share": bound / lib_ms,
        "bytes": n_bytes, "flops": flops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
        "bound_ms": bound, "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
    }


def moe_bound(cw, eo, fp32_peak) -> dict:
    """The least time one ``moe_combine`` call could take on this data.
    Bytes: every element of combine and of expert_out read once and the
    output written once.  A NaN or inf anywhere in ``expert_out[:, :, d]``
    makes column d NaN in every row (the function multiplies every weight,
    zeros included), so the function needs every element of expert_out,
    not only the rows a weight names.  Operations: 2 D for each non-zero
    weight (a NaN weight is one)."""
    t, d = cw.shape[0], eo.shape[-1]
    n_bytes = cw.nbytes + eo.nbytes + t * d * eo.element_size()
    nnz = int((cw != 0).sum())
    flops = 2 * nnz * d
    bytes_ms, ops_ms = n_bytes / PEAK_BYTES_PER_S * 1e3, flops / fp32_peak * 1e3
    return {"bytes": n_bytes, "nonzero_weights": nnz, "flops": flops, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes"}


def device_us_by_kernel(fn, operands, calls=10) -> dict:
    """Device µs per call of ``fn(*operands)`` by kernel (the port's by
    their names, PyTorch's by the first 40 characters of theirs), from
    ``torch.profiler`` over ``calls`` calls; empty where the profiler
    records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn(*operands)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*operands)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        name = next((k for k in ("moe_scan_kernel", "moe_product_kernel") if k in e.key),
                    e.key[:40])
        out[name] = out.get(name, 0.0) + e.self_device_time_total / calls
    return out


def measure_moe_combine(fp32_peak):
    """``moe_combine`` at each ``MOE_GROUPS`` group (float32), L2-hot and
    cold, beside one IEEE float32 ``torch.matmul`` of the reshaped operands
    (timed here only) and the bound of :func:`moe_bound`, with the device
    time of each of its kernels; at the qwen3-moe group also beside its
    plain version.  Returns the qwen3-moe group's numbers with the others
    under ``"groups"``."""
    from repro_torch.kernels.moe_combine import moe_combine
    from repro_torch.kernels.ref import moe_combine_ref

    groups = {}
    for name, (t, e, c, d, top_k) in MOE_GROUPS.items():
        cw, eo = (torch.from_numpy(a).cuda() for a in moe_arrays(t, e, c, d, top_k=top_k, seed=9))
        want = moe_combine_ref(eo, cw)
        got = moe_combine(cw, eo)
        if not _allclose(got, want, *MOE_TOL[torch.float32]):
            raise AssertionError(f"moe_combine != plain at the {name} group")
        err = float((got - want).abs().max())

        def library(cw, eo, t=t, k=e * c, d=d):
            return torch.matmul(cw.reshape(t, k), eo.reshape(k, d))

        if not _allclose(library(cw, eo), want, *MOE_TOL[torch.float32]):
            raise AssertionError(f"torch.matmul != plain at the {name} group")
        del got, want
        ops = (cw, eo)
        ms, eager, cold = hot_and_cold_ms(moe_combine, ops, iters=20)
        lib_ms, _, lib_cold = hot_and_cold_ms(library, ops, iters=20)
        bound = moe_bound(cw, eo, fp32_peak)
        m = {"shape": {"T": t, "E": e, "C": c, "D": d, "dtype": "float32",
                       "weights_a_token": top_k if top_k is not None else e * c},
             "max_abs_err": err, "ms": ms, "eager_ms": eager, "cold_ms": cold,
             "library_ms": lib_ms, "library_cold_ms": lib_cold,
             "library_over_kernel": lib_ms / ms, **bound,
             "bound_share": bound["bound_ms"] / ms,
             "cold_bound_share": bound["bound_ms"] / cold,
             "dense_ops_ms": 2 * t * e * c * d / fp32_peak * 1e3,
             "device_us_by_kernel": device_us_by_kernel(moe_combine, ops)}
        if name == "qwen3-moe":
            m["plain_ms"], _, m["plain_cold_ms"] = hot_and_cold_ms(
                lambda cw, eo: moe_combine_ref(eo, cw), ops, iters=5)
        groups[name] = m
        del cw, eo, ops
        torch.cuda.empty_cache()
    main = groups.pop("qwen3-moe")
    return {**main, "groups": groups}


# -- main --------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    if not (REPO / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch under {REPO}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.etl.events import EventSource
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    # every float32 product here is IEEE float32, the yardsticks' included
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    secs = build.build(build.KERNELS + ("launch_floor",))
    print(f"build: {time.perf_counter() - t0:.2f} s wall "
          + json.dumps({k: round(v, 2) for k, v in secs.items()}), flush=True)
    for name in build.KERNELS:
        for line in build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas {name}: {line.strip()}")
    n_hgmma = sass_count("flash_attention", "HGMMA")
    print(f"sass flash_attention: {n_hgmma} HGMMA instructions", flush=True)
    if n_hgmma == 0:
        raise AssertionError("the flash_attention library holds no HGMMA instruction")

    n_sg = check_segmented_gather(dev)
    n_dm = check_densify_map(dev)
    n_mg = check_per_block(dev, "masked_gather")
    n_oh = check_per_block(dev, "onehot_map")
    n_fa = check_flash_attention(dev)
    mc = check_moe_combine(dev)
    n_sgs, n_dms = check_shard_kernels(dev)
    n_edge = check_densify_edges(dev)
    n_gedge = check_gather_edges(dev)
    torch.cuda.synchronize()
    print(f"{elapsed()} kernels vs plain versions: segmented_gather {n_sg} cases, "
          f"densify_map {n_dm} cases, densify_map and densify_map_shard {n_edge} edge "
          f"cases (K 1-64, W 3, 127, 130, 384, 1-8 shards, a misaligned table; each "
          f"also through densify_map_chunk from a pinned arena, 1 copy and 1 launch), "
          f"segmented_gather and segmented_gather_shard {n_gedge} edge cases (W 3, 127, "
          f"130, 256, 384, N_in 1, misaligned operands, out-of-range routing and table "
          f"entries clamped, NaN and inf payloads, a shard with no live rows; each also "
          f"through segmented_gather_chunk from a pinned arena, 4 copies and 1 launch), "
          f"masked_gather {n_mg} cases, "
          f"segmented_gather_shard {n_sgs} cases and densify_map_shard {n_dms} cases "
          f"(padded and empty shards; each also on a sub-range of its shards and "
          f"against the base kernel shard by shard) bit-exact; "
          f"onehot_map {n_oh} cases, masks bit-exact, values within "
          f"atol={ONEHOT_ATOL}; flash_attention {n_fa} cases within "
          f"{FLASH_TOL[torch.float32]} (float32) / {FLASH_TOL[torch.bfloat16]} (bfloat16); "
          f"moe_combine {mc['cases']} cases within {MOE_TOL[torch.float32]} (float32) / "
          f"{MOE_TOL[torch.bfloat16]} (bfloat16 expert_out) (atol, rtol), "
          f"{mc['nonfinite_cases']} of them with inf and NaN planted, non-finite "
          f"outputs where the plain version has them, every repeat call bit-identical; "
          f"max abs err by expert_out dtype {json.dumps(mc['max_abs_err'])}", flush=True)

    cfg = _paper_config()
    stream = Stream(CHUNK_EVENTS)
    paths = MAIN_PATHS
    runs = {}
    for where, device in (("cuda", dev), ("cpu", "cpu")):
        for pname, path in paths.items():
            name = f"{where}/{pname}"
            rows, stats, chunk_s, launches, per_chunk, app, plan = run_main_path(
                device, path, cfg, stream, n_chunks=CHUNKS, evolve_at=EVOLVE_AT
            )
            if device == dev:
                torch.cuda.synchronize()
            check_accounting(name, per_chunk, path, on_card=device == dev)
            # the default manager splices the evolution, as the reference's does
            if not (plan["incremental"] and plan["epoch"] == 2
                    and 0 < plan["touched_columns"] < plan["columns"]):
                raise AssertionError(f"{name}: the evolution's build was not a splice: {plan}")
            runs[name] = (rows, stats, launches, app)
            info = app.engine.info()
            seconds, median_s = sum(chunk_s), statistics.median(chunk_s)
            per = {k: sum(a[k] for a in per_chunk) / CHUNKS
                   for k in ("dispatches", "transfers")}
            print(f"{elapsed()} main path {name}: {CHUNKS} x {CHUNK_EVENTS} events in "
                  f"{seconds:.3f} s consume = {CHUNKS * CHUNK_EVENTS / seconds:.0f} ev/s "
                  f"(median chunk {median_s * 1e3:.3f} ms = "
                  f"{CHUNK_EVENTS / median_s:.0f} ev/s; first chunk "
                  f"{chunk_s[0] * 1e3:.1f} ms, chunk {EVOLVE_AT} {chunk_s[EVOLVE_AT] * 1e3:.1f} ms); "
                  f"rows {len(rows)}; dispatches {stats['dispatches']} "
                  f"({per['dispatches']:.2f}/chunk); transfers {stats['transfers']} "
                  f"({per['transfers']:.2f}/chunk); launches {json.dumps(launches)}; "
                  f"engine {info['engine']} impl {info['impl']} "
                  f"n_blocks {info['n_blocks']} table_bytes {info['table_bytes']}; "
                  f"plan at chunk {EVOLVE_AT} {json.dumps(plan)}",
                  flush=True)
    for pname in paths:
        got, want = runs[f"cuda/{pname}"], runs[f"cpu/{pname}"]
        atol = ONEHOT_ATOL if pname == "blocks-onehot" else None
        n_bits = compare_rows(f"cuda/{pname}", got[0], want[0], atol)
        if got[1] != want[1]:
            raise AssertionError(f"cuda/{pname} stats {got[1]} != cpu {want[1]}")
        print(f"main path cuda/{pname}: rows and stats equal to the cpu run "
              f"({n_bits} rows not bit-identical)", flush=True)
    host_rows = runs["cuda/host"][0]
    compare_rows("cuda/device vs cuda/host", runs["cuda/device"][0], host_rows)
    compare_rows("cuda/sharded-host vs cuda/host", runs["cuda/sharded-host"][0], host_rows)
    compare_rows("cuda/sharded-device vs cuda/host", runs["cuda/sharded-device"][0], host_rows)
    compare_rows("cuda/blocks-gather vs cuda/host", runs["cuda/blocks-gather"][0], host_rows)
    n_bits = compare_rows("cuda/blocks-onehot vs cuda/host", runs["cuda/blocks-onehot"][0],
                          host_rows, ONEHOT_ATOL)
    for key in ("events", "mapped", "empty", "unknown_uid"):
        if len({runs[f"cuda/{p}"][1].get(key) for p in paths}) != 1:
            raise AssertionError(f"stats[{key!r}] differs between the paths")
    origin = {  # kernel: (source, the TPU kernel it replaces, the path that runs it)
        "segmented_gather": ("src/repro_torch/kernels/csrc/segmented_gather.cu",
                             "src/repro/kernels/segmented_gather.py:91", "cuda/host"),
        "densify_map": ("src/repro_torch/kernels/csrc/densify_map.cu",
                        "src/repro/kernels/densify_map.py:95", "cuda/device"),
        "masked_gather": ("src/repro_torch/kernels/csrc/masked_gather.cu",
                          "src/repro/kernels/masked_gather.py:73", "cuda/blocks-gather"),
        "onehot_map": ("src/repro_torch/kernels/csrc/onehot_map.cu",
                       "src/repro/kernels/onehot_map.py:61", "cuda/blocks-onehot"),
        "segmented_gather_shard": ("src/repro_torch/kernels/csrc/segmented_gather.cu",
                                   "src/repro/kernels/segmented_gather.py:159",
                                   "cuda/sharded-host"),
        "densify_map_shard": ("src/repro_torch/kernels/csrc/densify_map.cu",
                              "src/repro/kernels/densify_map.py:166", "cuda/sharded-device"),
    }
    for name, (_, _, run) in origin.items():
        if runs[run][2][name] < 1:
            raise AssertionError(f"{name}, a kernel of the main path, never launched")
    print("main path: fused, sharded and per-block rows equal (sharded and "
          f"blocks-gather bit-exact, blocks-onehot within atol={ONEHOT_ATOL}, {n_bits} "
          "rows not bit-identical); every kernel launched", flush=True)

    # where the consume time goes, on chunks after the evolution; first the
    # per-block host cost of a dispatch, before the serving path and the
    # profiler have run in this process
    later = [stream.chunks[k] for k in range(EVOLVE_AT + 1, CHUNKS)]
    for pname in ("blocks-gather", "blocks-onehot"):
        print(f"{elapsed()} per-block host cuda/{pname}: " + json.dumps(
            per_block_host(runs[f"cuda/{pname}"][3], later[:BLOCK_STAGE_CHUNKS])), flush=True)
    for pname in ("device", "sharded-device"):
        print(f"{elapsed()} device-densify host cuda/{pname}: " + json.dumps(
            host_split(runs[f"cuda/{pname}"][3], later)), flush=True)
    for pname in ("host", "sharded-host"):
        print(f"{elapsed()} host-densify host cuda/{pname}: " + json.dumps(
            host_split(runs[f"cuda/{pname}"][3], later)), flush=True)

    plan_lifecycle(dev)

    streaming_pipeline(dev, cfg, stream, runs)

    serving = serving_path(dev)

    for pname in paths:
        name = f"cuda/{pname}"
        chunks = later[:BLOCK_STAGE_CHUNKS] if pname.startswith("blocks") else later
        print(f"{elapsed()} stages {name}: "
              + json.dumps(stage_breakdown(runs[name][3], chunks)), flush=True)

    # timing at the main path's shapes, on a chunk after the evolution
    probe = stream.chunks[EVOLVE_AT + 1]
    for name in ("cuda/host", "cuda/device", "cuda/sharded-host", "cuda/sharded-device"):
        runs[name][3].reset_dedup()
    meas = {"segmented_gather": measure_segmented_gather(runs["cuda/host"][3], probe),
            "densify_map": measure_densify_map(runs["cuda/device"][3], probe),
            "segmented_gather_shard": measure_segmented_gather_shard(
                runs["cuda/sharded-host"][3], probe),
            "densify_map_shard": measure_densify_map_shard(
                runs["cuda/sharded-device"][3], probe)}
    # the fused and sharded kernels at a large chunk too, where the body and
    # not the launch sets their time
    big_chunk = EventSource(runs["cuda/device"][3].coordinator.registry,
                            seed=1).slice_columnar((EVOLVE_AT + 1) * CHUNK_EVENTS,
                                                   BIG_CHUNK_EVENTS)
    for name in ("cuda/host", "cuda/device", "cuda/sharded-host", "cuda/sharded-device"):
        runs[name][3].reset_dedup()
    meas_big = {"segmented_gather": measure_segmented_gather(runs["cuda/host"][3], big_chunk),
                "densify_map": measure_densify_map(runs["cuda/device"][3], big_chunk),
                "segmented_gather_shard": measure_segmented_gather_shard(
                    runs["cuda/sharded-host"][3], big_chunk),
                "densify_map_shard": measure_densify_map_shard(
                    runs["cuda/sharded-device"][3], big_chunk)}
    for m in (*meas.values(), *meas_big.values()):
        m["bound_ms"] = m["bytes"] / PEAK_BYTES_PER_S * 1e3
        m["bound_by"] = "bytes"
        if "live_bytes" in m:  # the shard kernels: the bound without routing padding
            m["live_bound_ms"] = m["live_bytes"] / PEAK_BYTES_PER_S * 1e3
    peak, sms, mhz = fp32_peak_per_s()
    print(f"float32 CUDA-core peak: {sms} SMs x {FP32_LANES_PER_SM} lanes x 2 x "
          f"{mhz:.0f} MHz = {peak / 1e12:.3f} TFLOP/s", flush=True)
    for name, run in (("masked_gather", "cuda/blocks-gather"),
                      ("onehot_map", "cuda/blocks-onehot")):
        groups = block_groups(runs[run][3], probe)
        sizes = [g[0] for g in groups]
        median, largest = groups[len(groups) // 2], groups[-1]
        print(f"groups {name}: {len(groups)} groups with blocks, B median "
              f"{median[0]} largest {largest[0]} (B histogram "
              f"{json.dumps({int(k): sizes.count(k) for k in sorted(set(sizes))})})",
              flush=True)
        meas[name] = measure_per_block(name, median, peak)
        big = measure_per_block(name, largest, peak)
        print(f"{elapsed()} timing {name} largest group: " + json.dumps(big), flush=True)
    meas["flash_attention"] = measure_flash_attention()
    meas["moe_combine"] = measure_moe_combine(peak)
    floor = launch_floor()
    print(f"launch floor: {json.dumps(floor)} (an empty kernel, graph-replayed)", flush=True)
    for m in (*meas.values(), *meas_big.values()):
        m["floor_multiple"] = m["ms"] / floor["ms"]
    for name, m in meas_big.items():
        print(f"timing {name} {BIG_CHUNK_EVENTS}: " + json.dumps(m), flush=True)
    torch.cuda.synchronize()
    print("serving: " + json.dumps(serving), flush=True)
    origin["flash_attention"] = ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                 "src/repro/kernels/flash_attention.py:93", "prefill")
    origin["moe_combine"] = ("src/repro_torch/kernels/csrc/moe_combine.cu",
                             "src/repro/kernels/moe_combine.py:53", None)
    # launches on the main paths: the consume paths' runs, the olmo-1b
    # prefill's (16 per forward); moe_combine is on no path (op only)
    path_launches = {name: runs[run][2][name] for name, (_, _, run) in origin.items()
                     if run in runs}
    path_launches["flash_attention"] = serving["prefill_flash_attention_launches"]
    path_launches["moe_combine"] = 0
    kernels = []
    for name, m in meas.items():
        source, replaces, _ = origin[name]
        print(f"timing {name}: " + json.dumps(m), flush=True)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path_launches[name], "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
