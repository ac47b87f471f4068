"""The port's spans (``repro_torch.spans``) on the decode path: recorded
only while a torch profiler records, the span tree of a decode step with
its parents, step ids and counts, the profiler's clock, no change to any
token or logit, and (on the card) no sync and no kernel added."""

import ast
import gc
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import repro_torch.configs as TC
from repro_torch import spans
from repro_torch.kernels.decode_attention import plan_splits, sm_count
from repro_torch.models import model as M
from repro_torch.models.moe import _capacity
from repro_torch.serve.decode import make_serve_step

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
ARCHS = ["olmo_1b", "dbrx_132b"]  # the benchmark's two families: dense, sparse experts
B, T = 2, 8


@pytest.fixture(autouse=True)
def no_spans_before():
    spans.clear()


def _setup(arch, device="cpu", dtype="float32"):
    cfg = TC.get_smoke(arch).replace(param_dtype=dtype, compute_dtype=dtype)
    params = M.init_params(cfg, 0, device=device)
    state = M.init_decode_state(cfg, B, T, device=device)
    tok = torch.tensor([3, 4], device=device)
    return cfg, params, state, tok, make_serve_step(cfg)


def _profiled(device):
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    return profile(activities=acts)


def _tree(cfg, pos, splits=0):
    """[(name, parent's name, counts)] of one decode step at ``pos``;
    ``splits``: the decode kernel's split over the slots (0 on the CPU,
    which reads the cache through the einsum)."""
    attn = [("attn", "model.decode", {}), ("attn.qkv", "attn", {}),
            ("attn.cache_write", "attn", {}),
            ("attn.cache_read", "attn", {"rows": B, "slots_valid": min(pos + 1, T), "slots": T,
                                         "splits": splits}),
            ("attn.out_proj", "attn", {})]
    if cfg.is_moe:
        rows = cfg.n_experts * B * _capacity(1, cfg)
        ffn = [("moe", "model.decode", {"tokens": B}), ("moe.route", "moe", {}),
               ("moe.dispatch", "moe", {"buffer_rows": rows}), ("moe.experts", "moe", {}),
               ("moe.combine", "moe", {})]
    else:
        ffn = [("mlp", "model.decode", {})]
    return ([("serve.step", None, {"rows": B, "pos": pos}),
             ("model.decode", "serve.step", {"layers": cfg.n_layers})]
            + (attn + ffn) * cfg.n_layers + [("model.head", "model.decode", {})])


def _seen(recs):
    return [(s.name, recs[s.parent].name if s.parent >= 0 else None, s.counts) for s in recs]


def test_off_records_nothing_and_creates_no_event(monkeypatch):
    cfg, params, state, tok, step = _setup("dbrx_132b")

    def no_event(*args, **kwargs):
        raise AssertionError("a CUDA event was created with the profiler off")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    for _ in range(2):
        tok, _, state = step(params, state, tok)
    assert spans.records() == [] and spans.summary() == {}


@pytest.mark.parametrize("arch", ARCHS)
def test_a_decode_step_records_the_span_tree(arch):
    cfg, params, state, tok, step = _setup(arch)
    tok, _, state = step(params, state, tok)  # pos 0, off
    with _profiled("cpu"):
        for _ in range(2):
            tok, _, state = step(params, state, tok)
    recs = spans.records()
    assert _seen(recs) == _tree(cfg, 1) + _tree(cfg, 2)
    per_step = len(recs) // 2
    assert [s.step for s in recs] == [0] * per_step + [1] * per_step
    for s in recs:  # nested on both clocks
        assert s.host_start_ns <= s.host_end_ns and s.device_start_ms <= s.device_end_ms
        if s.parent >= 0:
            p = recs[s.parent]
            assert p.host_start_ns <= s.host_start_ns and s.host_end_ns <= p.host_end_ns
    names = spans.summary()
    assert names["serve.step"]["calls"] == 2
    assert names["attn.cache_read"]["calls"] == 2 * cfg.n_layers
    assert not any(n.startswith("bench.") for n in names)


def test_a_span_is_stamped_on_the_profilers_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("x"):
            time.sleep(0.002)
            with spans.span("inside"):
                time.sleep(0.002)
            time.sleep(0.002)
    (x,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "x"]
    (s,) = spans.records()
    assert s.name == "inside" and s.parent == -1
    assert x.start_ns() <= s.host_start_ns < s.host_end_ns <= x.start_ns() + x.duration_ns()


@pytest.mark.parametrize("arch", ARCHS)
def test_tokens_and_logits_are_the_same_bits_with_recording_on(arch):
    cfg, params, s_off, tok_off, step = _setup(arch)
    _, _, s_on, tok_on, _ = _setup(arch)
    for i in range(3):
        tok_off, logits_off, s_off = step(params, s_off, tok_off)
        with _profiled("cpu"):
            tok_on, logits_on, s_on = step(params, s_on, tok_on)
        assert torch.equal(tok_off, tok_on) and torch.equal(logits_off, logits_on), i
    assert torch.equal(s_off["k"], s_on["k"]) and torch.equal(s_off["v"], s_on["v"])


def test_each_profiled_stretch_starts_a_fresh_list():
    """A stretch ends at a span the profiler did not record, or where it is
    read; what is read stays until the next stretch is recorded."""
    for name in ("first", "second"):
        with spans.span("between"):  # the profiler off
            pass
        with profile(activities=[ProfilerActivity.CPU]):
            with spans.span(name):
                pass
        with spans.span("after"):
            pass
        assert [s.name for s in spans.records()] == [name]
    for name in ("third", "fourth"):  # back to back, read in between
        with profile(activities=[ProfilerActivity.CPU]):
            with spans.span(name):
                pass
        assert [s.name for s in spans.records()] == [name]
        assert [s.name for s in spans.records()] == [name]
    spans.clear()
    assert spans.records() == []


def test_self_time_is_the_interval_less_its_children():
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("outer"):
            time.sleep(0.002)
            for _ in range(2):
                with spans.span("inner"):
                    time.sleep(0.003)
    outer, a, b = spans.records()
    got = spans.summary()
    whole = outer.device_end_ms - outer.device_start_ms
    kids = sum(s.device_end_ms - s.device_start_ms for s in (a, b))
    assert got["outer"]["device_self_ms"] == pytest.approx(whole - kids)
    assert got["inner"]["calls"] == 2 and got["inner"]["device_self_ms"] == pytest.approx(kids)
    assert got["outer"]["host_ms"] == pytest.approx(whole)  # the CPU: host stands for device


def test_a_count_is_a_host_int_on_the_innermost_span():
    spans.note("ignored", 1)  # the profiler off, no span open: nothing
    with profile(activities=[ProfilerActivity.CPU]):
        spans.note("nowhere", 1)  # no span open: nothing
        with spans.span("outer"):
            spans.note("n", 3)
            with spans.span("inner"):
                spans.note("m", 4)
                with pytest.raises(TypeError, match="Python int"):
                    spans.note("bad", torch.tensor(5))
    assert [(s.name, s.counts) for s in spans.records()] == [("outer", {"n": 3}),
                                                              ("inner", {"m": 4})]


def test_a_recorded_span_allocates_no_python_container():
    """Each container allocated counts toward the garbage collector's next
    pass, which could then land inside the profiled steps."""
    gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with spans.span("first"):  # starts the stretch's lists
                spans.note("n", 1)
            before = gc.get_count()[0]
            for _ in range(100):
                with spans.span("outer"):
                    spans.note("n", 1)
                    with spans.span("inner"):
                        pass
            made = gc.get_count()[0] - before
    finally:
        gc.enable()
    assert made == 0 and len(spans.records()) == 201


def _calls(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            yield (f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")), node


def test_no_port_file_opens_a_profiler_range_or_a_bench_span():
    """Ranges in the profiler's stream would be counted by its readers as
    kernels; ``bench.`` is the benchmark's own prefix."""
    named = []
    for path in sorted(PORT.rglob("*.py")):
        for fn, node in _calls(ast.parse(path.read_text())):
            assert fn != "record_function", path
            if fn == "span" and node.args and isinstance(node.args[0], ast.Constant):
                named.append(node.args[0].value)
    assert {"serve.step", "attn.cache_read", "moe.experts"} <= set(named)
    assert not [n for n in named if n.startswith("bench.")]


# ---------------------------------------------------------------------------
# on the card (marker gpu; skipped without a Hopper card)
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    """The Hopper card, or a skip: decided when the test runs."""
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper card (compute capability 9.0) with CUDA")
    return torch.device("cuda")


def _kernels(prof):
    cuda = torch.autograd.DeviceType.CUDA
    return sorted(e.name() for e in prof.profiler.kineto_results.events()
                  if e.device_type() == cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def _allocations_of_a_second_step(step, params, state, tok):
    """Python containers allocated by the second of two profiled steps (the
    first starts the stretch's lists), the profile of the two, and the
    spans read after it (which ends the stretch)."""
    with _profiled("cuda") as prof:
        with record_function("x"):
            tok, _, state = step(params, state, tok)
        gc.disable()
        try:
            before = gc.get_count()[0]
            tok, _, state = step(params, state, tok)
            made = gc.get_count()[0] - before
        finally:
            gc.enable()
        torch.cuda.synchronize()
    return made, prof, state, tok, spans.records()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_on_the_card_spans_add_no_sync_no_event_off_and_no_kernel(arch, card, monkeypatch):
    """bf16 steps: with the profiler off no CUDA event is made; with it on
    no span synchronises (sync debug mode raises on one), the device
    intervals nest, the host intervals are on the clock of the profiler's
    own range, and against steps with the spans patched out the kernels
    are the same and the Python containers allocated the same but the
    root's stream object."""
    cfg, params, state, tok, step = _setup(arch, "cuda", "bfloat16")
    tok, _, state = step(params, state, tok)
    torch.cuda.synchronize()
    made = []
    real_event = torch.cuda.Event
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: made.append(1) or real_event(*a, **k))
    tok, _, state = step(params, state, tok)
    assert not made
    with _profiled("cuda") as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            with record_function("x"):
                tok, _, state = step(params, state, tok)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    recs = spans.records()
    assert _seen(recs) == _tree(cfg, 2, plan_splits(B * cfg.n_kv_heads, 3, sm_count(card)))
    for s in recs:
        assert s.device_start_ms <= s.device_end_ms
        if s.parent >= 0:
            p = recs[s.parent]
            assert p.device_start_ms <= s.device_start_ms and s.device_end_ms <= p.device_end_ms
    (x,) = [e for e in prof.profiler.kineto_results.events()
            if e.name() == "x" and e.device_type() != torch.autograd.DeviceType.CUDA]
    assert x.start_ns() <= recs[0].host_start_ns
    assert recs[0].host_end_ns <= x.start_ns() + x.duration_ns()
    _, _, state, tok, _ = _allocations_of_a_second_step(step, params, state, tok)  # grows the pool
    made_on, on, state, tok, two = _allocations_of_a_second_step(step, params, state, tok)
    assert len(two) == 2 * len(recs)
    monkeypatch.setattr(spans, "span", lambda name: spans._OFF)
    made_off, off, state, tok, _ = _allocations_of_a_second_step(step, params, state, tok)
    assert _kernels(on) == _kernels(off)
    assert made_on - made_off <= 4, (made_on, made_off)
