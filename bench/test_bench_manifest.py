"""CPU tests of the benchmark's files: the manifest against its contract,
each cell's files found by name, the FLOP and byte counts worked out by
hand, and the imports that no run may make."""

import ast
import importlib
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

from metlbench import harness  # noqa: E402

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]


def test_manifest_keeps_to_its_contract():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["paths"] == ["bench"] and MAN["command"] == ["python3", "bench/run.py"]
    assert 1 <= MAN["run_seconds"] <= 51
    names = []
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4) and len(w["why"]) <= 200
        names += [w["name"], w["traffic"]]
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    assert "setup_s" in {m["name"] for m in MAN["end_to_end"]}
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
        if m["name"].endswith("_roofline") or "roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(json.dumps(MAN)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_each_cells_files_are_found_by_name(cell):
    c = harness.find_cell(cell)
    assert (BENCH / "metlbench" / "kinds" / f"{c.traffic['kind']}.py").is_file()
    importlib.import_module(f"metlbench.kinds.{c.traffic['kind']}")
    assert (BENCH / "reference" / f"{c.config['reference']}.py").is_file()
    assert c.end_to_end and c.per_layer
    others = {m["name"] for m in c.end_to_end} - {"setup_s"}
    assert others
    for m in c.per_layer:  # every reader loads, and reads a metric its cell reports
        assert callable(harness.load_reader(m["name"]).read)
        assert m["moves"] in others
    assert all(isinstance(v, (int, float)) for v in c.limits.values())


def test_attention_bytes_by_hand():
    """B 2, T 16 slots, 2 KV heads of 4, 4 query heads, D 16, position 5,
    bf16: K and V of the 6 valid slots (2*2*6*2*4 = 192 elements), the new
    K and V (2*2*2*4 = 32), the weights (16*16 + 2*16*8 + 16*16 = 768), x and
    out (2*2*16 = 64): 1,056 elements, 2,112 bytes."""
    att = harness.load_reader("attention_roofline.gen")
    from metlbench import peaks

    assert att.bound_s(2, 16, 2, 4, 4, 16, 5, 2) == pytest.approx(2112 / peaks.HBM_BYTES_PER_S)
    # position past the cache: only the T slots are there to read
    assert att.bound_s(2, 16, 2, 4, 4, 16, 99, 2) == pytest.approx(
        (2112 + 2 * 2 * 2 * 2 * 4 * 10) / peaks.HBM_BYTES_PER_S)


def test_moe_bytes_and_flops_by_hand():
    """3 tokens, D 8, F 12, E 4 experts, top 2, 3 experts hit, bf16: bytes
    3*3*8*12*2 + 8*4*4 + 2*3*8*2 = 1,952, the bound.  1,000 tokens at F
    1,000: FLOPs 2*1000*(2*3*8*1000 + 8*4) = 96,064,000 bound it (bytes
    176,128)."""
    moe = harness.load_reader("moe_roofline.gen")
    from metlbench import peaks

    assert moe.bound_s(3, 8, 12, 4, 2, 3, 2) == pytest.approx(1952 / peaks.HBM_BYTES_PER_S)
    assert moe.bound_s(1000, 8, 1000, 4, 2, 3, 2) == pytest.approx(
        96_064_000 / peaks.BF16_FLOP_PER_S)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), path
        if path.parent.name == "reference":
            assert "repro_torch" not in tops and "metlbench" not in tops, path


def test_a_run_loads_no_jax_and_the_reference_nothing_of_the_program():
    """In fresh processes: everything a run imports (the harness, both
    kinds, every reader) leaves no module named jax, jaxlib, flax or repro,
    by whole top-level names; the reference alone loads no repro_torch."""
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from metlbench import harness\n"
            "import metlbench.kinds.gen, metlbench.context\n"
            "for m in %r: harness.load_reader(m)\n"
            "import repro_torch.models.model, repro_torch.serve.decode, repro_torch.etl\n"
            "bad = harness.forbidden_modules(); print(bad); sys.exit(1 if bad else 0)\n"
            % (str(BENCH), str(ROOT / "src"), [m["name"] for m in MAN["per_layer"]]))
    assert subprocess.run([sys.executable, "-c", code], capture_output=True).returncode == 0
    code = ("import sys; sys.path[:0] = [%r]\n"
            "import reference.decoder, reference.etl\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('repro_torch', 'repro', 'jax', 'metlbench')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n" % str(BENCH))
    assert subprocess.run([sys.executable, "-c", code], capture_output=True).returncode == 0


def test_fp8_rounding_of_the_control():
    from reference import decoder

    x = torch.tensor([448.0, 1.0, 0.3, -17.0])
    q = decoder.fp8(x)
    assert q[0] == 448.0 and q[1] == 1.0
    assert abs(float(q[2]) - 0.3) <= 0.3 * 2**-4 and q[3] == -16.0
