"""CPU tests of the readers of the program's decode spans: their bounds
worked out by hand, their shares over the spans' device time, and that
they read nothing off the card or from a program that has no spans."""

import sys
import types
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

from metlbench import harness  # noqa: E402


@pytest.mark.parametrize("reader, args, bytes_, flop", [
    # rows 2, 6 valid slots, 2 KV heads of 4, 4 query heads, bf16: K and V
    # 2*2*6*2*4 = 192 elements, 384 bytes; 4*2*6*4*4 = 768 FLOPs
    ("cache_read_roofline.gen", (2, 6, 2, 4, 4, 2), 384, 768),
    # 512 query heads over 1 KV head: 2*10*100*8*2 = 32,000 bytes against
    # 4*10*100*512*8 = 16,384,000 FLOPs, which bound it
    ("cache_read_roofline.gen", (10, 100, 1, 8, 512, 2), 32_000, 16_384_000),
    # 3 tokens, D 8, F 12, top 2, 3 experts hit, bf16: 3*3*8*12*2 = 1,728
    # bytes; 2*3*2*3*8*12 = 3,456 FLOPs
    ("moe_experts_roofline.gen", (3, 8, 12, 2, 3, 2), 1728, 3456),
    # 1,000 tokens at F 1,000: 3*3*8*1000*2 = 144,000 bytes against
    # 2*1000*2*3*8*1000 = 96,000,000 FLOPs, which bound it
    ("moe_experts_roofline.gen", (1000, 8, 1000, 2, 3, 2), 144_000, 96_000_000),
])
def test_span_reader_bounds_by_hand(reader, args, bytes_, flop):
    from metlbench import peaks

    want = max(bytes_ / peaks.HBM_BYTES_PER_S, flop / peaks.BF16_FLOP_PER_S)
    assert harness.load_reader(reader).bound_s(*args) == pytest.approx(want)


def _span(name, parent, ms, **counts):
    from repro_torch.spans import Span

    return Span(name, parent, 0, 0, 1, counts, ms[0], ms[1])


def test_span_readers_share_over_the_spans_device_time():
    """Each reader's bound over the summed device intervals of its spans:
    two cache reads of 1 and 3 ms; one expert product of 2 ms under a
    ``moe`` span of 10 ms whose route, dispatch and combine take 1, 2 and
    0.5 ms, its children leaving 4.5 ms uncovered."""
    from repro_torch.models.config import ModelConfig

    cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=16, n_heads=4,
                      n_kv_heads=2, d_ff=32, vocab=64, compute_dtype="bfloat16")
    cr = harness.load_reader("cache_read_roofline.gen")
    reads = [_span("attn.cache_read", -1, (0.0, 1.0), rows=2, slots_valid=6),
             _span("attn.out_proj", -1, (1.0, 9.0)),
             _span("attn.cache_read", -1, (9.0, 12.0), rows=2, slots_valid=6)]
    assert cr.share(reads, cfg) == pytest.approx(100 * 2 * cr.bound_s(2, 6, 2, 4, 4, 2) / 4e-3)
    assert cr.share(reads[1:2], cfg) is None

    moe = [_span("moe", -1, (0.0, 10.0), tokens=3), _span("moe.route", 0, (0.5, 1.5)),
           _span("moe.dispatch", 0, (1.5, 3.5)), _span("moe.experts", 0, (3.5, 5.5)),
           _span("moe.combine", 0, (5.5, 6.0)), _span("moe.combine", 0, (6.0, 6.0))]
    router = torch.eye(8)[:, :4] * 10  # token t goes to its two largest of x[t, :4]
    x = torch.tensor([[1.0, 0.9, 0, 0], [0, 1.0, 0.9, 0], [1.0, 0.9, 0, 0]])
    x = torch.cat([x, torch.zeros(3, 4)], 1)
    me = harness.load_reader("moe_experts_roofline.gen")
    call = (router, x, 2, (4, 8, 12), 2)
    assert me.hit(router, x, 2) == 3
    assert me.share(moe, [call]) == pytest.approx(100 * me.bound_s(3, 8, 12, 2, 3, 2) / 2e-3)
    assert me.share(moe, [call, call]) is None  # calls and spans do not pair up

    from repro_torch import spans

    share = harness.load_reader("moe_overhead_share.gen").share
    summary = {"moe": {"device_ms": 10.0, "device_self_ms": 4.5},
               "moe.route": {"device_ms": 1.0}, "moe.dispatch": {"device_ms": 2.0},
               "moe.experts": {"device_ms": 2.0}, "moe.combine": {"device_ms": 0.5}}
    assert share(summary) == pytest.approx(100 * (4.5 + 1.0 + 2.0 + 0.5) / 10.0)
    assert share({"moe.route": {"device_ms": 1.0}}) is None
    assert spans._covered(0.0, 10.0, [(s.device_start_ms, s.device_end_ms)
                                      for s in moe[1:]]) == pytest.approx(5.5)


@pytest.mark.parametrize("reader", ["cache_read_roofline.gen", "moe_experts_roofline.gen",
                                    "moe_overhead_share.gen"])
def test_span_readers_read_nothing_off_the_card_or_from_a_program_without_spans(
        reader, monkeypatch):
    import repro_torch
    import repro_torch.spans  # noqa: F401

    mod = harness.load_reader(reader)
    trace = types.SimpleNamespace(device=torch.device("cpu"))
    out = types.SimpleNamespace(trace=trace, window={"probes": {"moe_ffn": [()]}})
    assert mod.read(out) is None  # the CPU: no device intervals
    trace.device = torch.device("cuda")
    monkeypatch.delattr(repro_torch, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert mod.read(out) is None  # a program from before the spans
