"""CPU runs of the benchmark: every cell at its configuration's smoke sizes
through the whole harness (set-up, window, traced stretch, reference), the
faults each cell can have planted under the timed path (``correct`` must
come out false), and the refusals (no card, no program beside the
benchmark, JAX loaded)."""

import json
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

from metlbench import harness  # noqa: E402

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MAN["workloads"]]
BIG_SEED = 2**31 + 11


@pytest.fixture(autouse=True)
def one_thread():
    """Smoke sizes run fastest on one thread, and a window's count of steps
    then does not hang on how many other test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke(cell, seed=BIG_SEED, trace=0, seconds=0.5):
    run, out = harness.execute(["--workload", cell, "--seed", str(seed), "--seconds",
                                str(seconds), "--trace", str(trace), "--smoke",
                                "--device", "cpu"])
    return harness.result_line(run, out)


@pytest.mark.parametrize("cell", CELLS)
def test_a_smoke_run_of_each_cell_is_correct(cell):
    line = smoke(cell, seconds=2)  # long enough for a step to end inside it
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    want = {m["name"] for m in harness.find_cell(cell).end_to_end}
    assert set(line["metrics"]) == want
    assert all(v["value"] > 0 for v in line["metrics"].values())
    again = smoke(cell, seconds=2)  # the same seed, the same inputs and readings
    assert again["checks"] == line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_smoke_run_reports_per_layer_metrics(cell):
    line = smoke(cell, seed=5, trace=1)
    assert line["correct"], line["checks"]
    names = {m["name"] for m in harness.find_cell(cell).per_layer}
    assert set(line["metrics"]) <= names and line["metrics"]  # the CPU has no device trace
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def _altered_rows(orig):
    def emit(plan, ov, om, blk_ids, out_keys, stats):
        rows = orig(plan, ov, om, blk_ids, out_keys, stats)
        if rows:
            route, vals, mask, key = rows[0]
            rows[0] = (route, vals + mask.astype(vals.dtype), mask, key)
        return rows
    return emit


def _stale_cache(orig):
    def attend(p, x, cache_k, cache_v, *args, **kwargs):
        return orig(p, x, cache_k.clone(), cache_v.clone(), *args, **kwargs)
    return attend


def _altered_tokens(orig):
    def make(cfg, sh=None):
        step = orig(cfg, sh)
        count = [0]

        def altered(params, state, token):
            nxt, logits, state = step(params, state, token)
            count[0] += 1
            if count[0] % 7 == 0:
                nxt = (nxt + 1) % cfg.vocab
            return nxt, logits, state
        return altered
    return make


def _altered_after(calls):
    """Every token altered once the step has been called ``calls`` times:
    the warm-up's two steps and the first job's pass, so that only later
    jobs serve wrong tokens."""
    def wrap(orig):
        def make(cfg, sh=None):
            step = orig(cfg, sh)
            count = [0]

            def altered(params, state, token):
                nxt, logits, state = step(params, state, token)
                count[0] += 1
                if count[0] > calls:
                    nxt = (nxt + 1) % cfg.vocab
                return nxt, logits, state
            return altered
        return make
    return wrap


def _steps_a_job(cell, smoke=True):
    t = harness.find_cell(cell).traffic
    t = {**t, **t["smoke"]} if smoke else t
    start = t["prompt_len"] - 1 if t["prefill"] == "forward" else 0
    return t["prompt_len"] + t["new_tokens"] - 1 - start


FAULTS = [
    ("repro_torch.etl.engines", "_emit_rows", _altered_rows),
    ("repro_torch.models.model", "attention_decode", _stale_cache),
    ("repro_torch.serve.decode", "make_serve_step", _altered_tokens),
]


@pytest.mark.parametrize("cell,fault", [(c, f) for f in FAULTS for c in CELLS],
                         ids=lambda x: x if isinstance(x, str) else x[1])
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    import importlib

    mod = importlib.import_module(fault[0])
    monkeypatch.setattr(mod, fault[1], fault[2](getattr(mod, fault[1])))
    line = smoke(cell)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_in_a_later_job_alone_is_not_correct(cell, monkeypatch):
    """The judged rows come from every finished job, not the first alone."""
    from repro_torch.serve import decode

    monkeypatch.setattr(decode, "make_serve_step",
                        _altered_after(2 + _steps_a_job(cell))(decode.make_serve_step))
    line = smoke(cell, seconds=6)
    assert line["readings"]["jobs_finished"] >= 2
    assert not line["correct"], line["checks"]


FORWARD = sorted({w["config"] for w in MAN["workloads"]
                  if harness.find_cell(w["name"]).traffic["prefill"] == "forward"})


@pytest.mark.parametrize("config", FORWARD)
def test_the_context_built_in_set_up_is_where_stepping_leaves_the_state(config):
    """The program's forward writes the caches that stepping the same tokens
    through ``serve_step`` writes (float32, the smoke sizes)."""
    from metlbench import context, weights
    from repro_torch.models import model as M
    from repro_torch.models.config import ModelConfig
    from repro_torch.serve import decode

    c = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    cfg = ModelConfig(**{**c["model"], **c["smoke"]})
    dev = torch.device("cpu")
    params = weights.make(cfg, 7, dev)
    R, S, T = 5, 9, 12
    tokens = torch.randint(2, cfg.vocab, (R, S), generator=torch.Generator().manual_seed(3))
    built = context.fill(params, cfg, M.init_decode_state(cfg, R, T, device=dev), tokens, 2)
    step = decode.make_serve_step(cfg)
    stepped = M.init_decode_state(cfg, R, T, device=dev)
    for t in range(S):
        _, _, stepped = step(params, stepped, tokens[:, t])
    assert built["pos"] == stepped["pos"] == S
    for name in ("k", "v"):
        torch.testing.assert_close(built[name], stepped[name], rtol=1e-4, atol=1e-5)


def test_a_context_is_not_built_through_capacity_drops():
    """A sparse-expert forward drops tokens beyond an expert's capacity,
    which decode never does: such a configuration steps its prompts."""
    from metlbench import context
    from repro_torch.models import model as M
    from repro_torch.models.config import ModelConfig

    c = json.loads((BENCH / "configs" / "dbrx-132b-s8.json").read_text())
    cfg = ModelConfig(**{**c["model"], **c["smoke"]})
    state = M.init_decode_state(cfg, 2, 8, device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        context.fill({}, cfg, state, torch.zeros((2, 4), dtype=torch.long), 1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell,fault", [(c, f) for f in FAULTS + [None] for c in CELLS],
                         ids=lambda x: x if isinstance(x, str) else
                         (x[1] if x else "later_job"))
def test_a_fault_is_not_correct_on_the_card(cell, fault, card, monkeypatch):
    """The faults at the cell's own sizes, over a whole window (so that a
    later job finishes):

        python -m pytest -q -s -m gpu bench/test_bench_runs.py
    """
    import importlib

    if fault is None:
        from repro_torch.serve import decode

        monkeypatch.setattr(decode, "make_serve_step", _altered_after(
            2 + _steps_a_job(cell, smoke=False))(decode.make_serve_step))
    else:
        mod = importlib.import_module(fault[0])
        monkeypatch.setattr(mod, fault[1], fault[2](getattr(mod, fault[1])))
    run, out = harness.execute(["--workload", cell, "--seed", "2718281829", "--seconds",
                                str(MAN["run_seconds"]), "--trace", "0"])
    line = harness.result_line(run, out)
    print(json.dumps({"cell": cell, "fault": fault[1] if fault else "later_job",
                      "checks": line["checks"], "jobs_finished": out.readings["jobs_finished"],
                      "gap": out.readings.get("gap"),
                      "setup_laps": out.readings["setup_laps"]}), flush=True)
    assert not line["correct"], line["checks"]
    del run, out
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_and_the_reference_get_the_same_events(cell):
    """The program's chunks (``slice_columnar``, through the program's own
    ``columnarize``) carry the columns the reference reads."""
    import numpy as np

    from metlbench import cdc

    t = harness.find_cell(cell).traffic
    sc = cdc.scenario(t["smoke"]["scenario"])
    src = cdc.Events(sc, BIG_SEED, t["p_duplicate"])
    chunk, cols = src.slice_columnar(100, 64), src.columns(100, 64)
    states, schema_ids, versions = chunk.meta_columns()
    for name, got in (("keys", chunk.keys), ("states", states), ("schema_ids", schema_ids),
                      ("versions", versions), ("event_offsets", chunk.event_offsets),
                      ("uids", chunk.uids), ("vals", chunk.vals), ("bad", chunk.bad)):
        assert np.array_equal(np.asarray(got), cols[name]), name


def test_the_scenario_maps_each_version_one_to_one():
    from metlbench import cdc

    sc = cdc.scenario(harness.find_cell(CELLS[0]).traffic["scenario"])
    routes = cdc.mapping(sc)
    assert len(routes) == sum(len(v) for v in sc.schemas.values())
    for (o, v), rs in routes.items():
        for (r, w), width, pos in rs:
            assert r == o % len(sc.entities) and width == len(sc.entities[r])
            assert len(set(pos.values())) == len(pos) and set(pos) <= set(sc.uids[(o, v)])
    assert sum(bool(rs) for rs in routes.values()) > len(routes) // 2


def _run_py(args, cwd):
    return subprocess.run([sys.executable, "bench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_without_a_card_the_run_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run_py(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"], ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_the_benchmark_alone_fails_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_py(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0",
                 "--smoke", "--device", "cpu"], tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_run_with_jax_loaded_fails_and_prints_no_result(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = harness.main(["--workload", CELLS[0], "--seed", "3", "--seconds", "0.5", "--trace", "0",
                       "--smoke", "--device", "cpu"])
    captured = capsys.readouterr()
    assert rc != 0 and captured.out.strip() == "" and "jax" in captured.err
