"""The port's launch tools (``repro_torch.launch.dryrun_lib``, ``dryrun``,
``roofline``, ``perf``, ``hlo_breakdown``) against the reference's.

The reference's dry run (``repro.launch.dryrun_lib.run_cell``, XLA's
memory analysis of the compiled step) runs in one subprocess with 8
forced CPU devices, started first so that it runs while the port's cases
do; the port traces its own steps on the ``meta`` device in this process.

What is held, and how closely:
  * ``memory.argument_bytes``, ``output_bytes`` and ``alias_bytes``,
    ``model_flops_global`` and ``n_devices``: equal to the reference's,
    for a smoke config of every family on a (2, 4) mesh (train and decode
    shapes, cut in sequence and batch so that XLA compiles them in
    seconds), and for full olmo-1b on (16, 16) against the checked-in
    ``experiments/dryrun/olmo_1b.*.16x16.json`` (a reference run of this
    tree gives the same four fields; its ``temp_bytes`` and ``cost`` have
    moved since those files were written, so they are not compared);
  * counted flops of olmo-1b ``train_4k``, over every data rank (the
    port's per-device flops times the data ranks, since the ``model``
    ranks repeat them): at least ``model_flops_global`` (the 6ND floor,
    which every step must do) and at most 1.1 times the reference's HLO
    flops over all devices.  The port counts matrix products alone
    (``FlopCounterMode``'s rules) where XLA counts elementwise work too,
    and both recompute the layers under remat "full"; 1.1 leaves room for
    the port's dense attention over the full score matrix;
  * the traced cost at L layers: the affine extrapolation from L = 1 and
    L = 2 within 1e-9 relative (the trace visits every layer, and the
    layers repeat);
  * the trace's shape cache and its microbatch repeats: the same counts as
    a trace without them, exactly; its flops equal ``FlopCounterMode``'s;
  * ``hlo_breakdown``'s groups sum to the traced step's result bytes;
  * llama3-405b ``train_4k`` on (16, 16): every result of every
    operation of its step is a meta tensor, and it takes under 20 s of
    CPU time.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time

import pytest
from torch.utils.flop_counter import FlopCounterMode

import repro_torch.configs as TC
from repro_torch.configs import ShapeCell
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import dryrun, hlo_breakdown, perf, roofline
from repro_torch.launch import dryrun_lib as D
from repro_torch.models import model as TM
from repro_torch.sharding.specs import ShardingPolicy, param_spec_tree
from repro_torch.train.loop import TrainConfig

REPO = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(REPO, "src")
REF_TIMEOUT = 300

# the smoke cells: every family, a train and a decode shape (cut so that the
# reference's XLA compiles stay in seconds)
SMALL = {"train_s": ShapeCell("train_s", 64, 8, "train"),
         "decode_s": ShapeCell("decode_s", 128, 8, "decode")}
CELLS = [("olmo_1b", "train_s"), ("olmo_1b", "decode_s"),
         ("qwen3_moe_30b_a3b", "train_s"), ("qwen3_moe_30b_a3b", "decode_s"),
         ("rwkv6_3b", "decode_s"), ("hymba_1_5b", "decode_s"),
         ("whisper_tiny", "decode_s"), ("internvl2_1b", "train_s")]
MESH = (2, 4)
FIELDS = ("argument_bytes", "output_bytes", "alias_bytes")

REF_CODE = """
import dataclasses, json
import repro.configs as C
from repro.configs import ShapeCell
from repro.launch.dryrun_lib import run_cell
from repro.launch.mesh import make_local_mesh
small = {small}
for name, (seq, batch, kind) in small.items():
    C.SHAPES[name] = ShapeCell(name, seq, batch, kind)
mesh = make_local_mesh(*{mesh})
out = {{}}
for arch, shape in {cells}:
    sm = C.get_smoke(arch)
    ov = {{f.name: getattr(sm, f.name) for f in dataclasses.fields(sm)}}
    r = run_cell(arch, shape, mesh, cost_extrapolation=False, overrides=ov, verbose=False)
    assert r.ok and not r.error, (arch, shape, r.error)
    out[arch + ":" + shape] = {{"memory": r.memory, "model_flops_global": r.model_flops_global,
                               "n_devices": r.n_devices}}
print("REF " + json.dumps(out))
"""


def _smoke_overrides(arch):
    sm = TC.get_smoke(arch)
    return {f.name: getattr(sm, f.name) for f in dataclasses.fields(sm)}


@pytest.fixture(scope="module", autouse=True)
def ref_proc():
    """The reference's subprocess, started before the module's first test."""
    small = {k: (v.seq_len, v.global_batch, v.kind) for k, v in SMALL.items()}
    code = REF_CODE.format(small=small, mesh=MESH, cells=CELLS)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


@pytest.fixture(scope="module")
def ref(ref_proc):
    out, err = ref_proc.communicate(timeout=REF_TIMEOUT)
    assert ref_proc.returncode == 0, out + err[-3000:]
    line = [x for x in out.splitlines() if x.startswith("REF ")][-1]
    return json.loads(line[4:])


def _olmo_artifact(shape):
    with open(os.path.join(REPO, "experiments", "dryrun", f"olmo_1b.{shape}.16x16.json")) as f:
        return json.load(f)


def _reduced(arch, layers, **kw):
    return D._reduced(TC.get_smoke(arch).replace(**kw), layers)


# ---------------------------------------------------------------------------
# the reference's unit tests, at the port's constants
# ---------------------------------------------------------------------------


class TestRoofline:
    def _rec(self, flops=roofline.PEAK_FLOPS, byts=0.0, coll=0.0):
        return {
            "ok": True,
            "skipped": "",
            "arch": "x", "shape": "y", "mesh": "16x16",
            "n_devices": 256,
            "cost": {"flops": flops, "bytes_accessed": byts},
            "collectives": {"all-reduce": coll},
            "model_flops_global": flops * 256,  # perfectly useful compute
            "memory": {"temp_bytes": 0, "argument_bytes": 0},
        }

    def test_perfect_compute_bound_is_fraction_one(self):
        row = roofline.analyze(self._rec())
        assert row["bottleneck"] == "compute"
        assert abs(row["roofline_fraction"] - 1.0) < 1e-6
        assert abs(row["useful_flops_ratio"] - 1.0) < 1e-6
        assert row["compute_s"] == pytest.approx(1.0)

    def test_memory_bound_detection(self):
        row = roofline.analyze(self._rec(byts=roofline.HBM_BW * 10))
        assert row["bottleneck"] == "memory"
        assert row["memory_s"] == pytest.approx(10.0)

    def test_collective_bound_detection(self):
        row = roofline.analyze(self._rec(coll=roofline.NVLINK_BW * 99))
        assert row["bottleneck"] == "collective"
        assert row["collective_s"] == pytest.approx(99.0)

    def test_skipped_cells_yield_none(self):
        rec = self._rec()
        rec["skipped"] = "sub-quadratic only"
        assert roofline.analyze(rec) is None

    def test_etl_walls_and_roof(self):
        art = {"engines": [
            {"engine": "a", "chunk_events": 512, "dispatches": 1,
             "host_bytes": roofline.PCIE_BW * 1e-3, "device_bytes": 0, "events_per_s": 1e3},
            {"engine": "b", "chunk_events": 512, "dispatches": 400, "host_bytes": 0,
             "device_bytes": roofline.HBM_BW * 1e-6, "events_per_s": None}]}
        a, b = roofline.analyze_etl(art)
        assert a["bottleneck"] == "transfer" and a["transfer_s"] == pytest.approx(1e-3)
        assert a["roof_events_per_s"] == pytest.approx(512e3)
        assert b["bottleneck"] == "launch"
        assert b["launch_s"] == pytest.approx(400 * roofline.LAUNCH_S)
        table = roofline.render_etl_table([a, b])
        assert "**transfer**" in table and "**launch**" in table and "| 1000 |" in table

    def test_constants_are_the_h100s(self):
        assert roofline.PEAK_FLOPS == 989e12
        assert 1e12 < roofline.HBM_BW < 3.35e12  # below the datasheet's 3.35 TB/s
        assert 1e10 < roofline.PCIE_BW < 64e9  # below PCIe 5 x16's 64 GB/s
        assert 1e-7 < roofline.LAUNCH_S < 2e-5


class TestModelFlops:
    def test_train_is_6nd(self):
        cfg = TC.get("olmo_1b")
        cell = TC.SHAPES["train_4k"]
        want = 6.0 * cfg.param_count() * cell.global_batch * cell.seq_len
        assert D._model_flops(cfg, cell) == pytest.approx(want)

    def test_moe_uses_active_params(self):
        cfg = TC.get("qwen3_moe_30b_a3b")
        cell = TC.SHAPES["train_4k"]
        got = D._model_flops(cfg, cell)
        assert got < 6.0 * cfg.param_count() * cell.global_batch * cell.seq_len
        assert got == pytest.approx(
            6.0 * cfg.active_param_count() * cell.global_batch * cell.seq_len)

    def test_decode_counts_one_token_per_seq(self):
        cfg = TC.get("olmo_1b")
        cell = TC.SHAPES["decode_32k"]
        assert D._model_flops(cfg, cell) == pytest.approx(
            2.0 * cfg.param_count() * cell.global_batch)


class TestTrainSettings:
    def test_size_tiers(self):
        assert D.train_settings(TC.get("llama3_405b"),
                                TC.SHAPES["train_4k"]).opt.moment_dtype == "bfloat16"
        assert D.train_settings(TC.get("olmo_1b"), TC.SHAPES["train_4k"]).n_micro == 1
        # per-arch override wins
        assert D.train_settings(TC.get("rwkv6_3b"), TC.SHAPES["train_4k"]).n_micro == 4
        assert D.train_settings(TC.get("llama3_405b"), TC.SHAPES["train_4k"]).n_micro == 16


class TestSpecTree:
    def test_divisibility_guard(self):
        sp = ShardingPolicy(mesh=D.ShapeMesh(16, 16))
        assert sp.dim(2048, "model") == "model"
        assert sp.dim(25, "model") is None  # hymba heads
        assert sp.dim(8, "model") is None  # llama kv heads < 16
        assert sp.dim(2048, ("data",)) == ("data",)

    def test_param_specs_shapes(self):
        sp = ShardingPolicy(mesh=D.ShapeMesh(16, 16))
        cfg = TC.get_smoke("llama3_405b").replace(d_model=256, d_ff=512, vocab=512)
        specs = param_spec_tree(TM.init_params(cfg, device="meta"), sp)
        # per-layer leaves: 2D projections are (fsdp, tp)
        wq = specs["layers"][0]["attn"]["wq"]
        assert wq[0] in ("data", ("data",)) and wq[1] == "model"
        cfg_r = TC.get_smoke("rwkv6_3b").replace(d_model=256, d_ff=512, vocab=512)
        wr = param_spec_tree(TM.init_params(cfg_r, device="meta"), sp)["layers"][0]["tm"]["wr"]
        assert wr[0] in ("data", ("data",)) and wr[1] is None

    def test_meta_parameters_have_the_real_shapes(self):
        cfg = TC.get_smoke("whisper_tiny")
        real = TM.init_params(cfg, 0, device="cpu")
        meta = TM.init_params(cfg, 0, device="meta")
        flat = lambda t: [(x.shape, x.dtype) for x in tree_leaves(t)]  # noqa: E731
        assert flat(meta) == flat(real)
        assert all(x.device.type == "meta" for x in tree_leaves(meta))


# ---------------------------------------------------------------------------
# parity with the reference's dry run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", list(TC.SHAPES))
def test_olmo_16x16_equals_the_checked_in_artifacts(shape):
    got = D.run_cell("olmo_1b", shape, D.production_mesh(), verbose=False).to_json()
    want = _olmo_artifact(shape)
    assert set(got) == set(want)  # the same record keys
    for k in ("arch", "shape", "mesh", "ok", "skipped", "model_flops_global", "n_devices"):
        assert got[k] == want[k], k
    if want["memory"] is None:
        assert got["memory"] is None and want["skipped"]
        return
    assert {k: got["memory"][k] for k in FIELDS} == {k: want["memory"][k] for k in FIELDS}


def test_olmo_train_flops_lie_between_6nd_and_the_reference_hlo():
    got = D.run_cell("olmo_1b", "train_4k", D.production_mesh(), verbose=False)
    want = _olmo_artifact("train_4k")
    data_ranks = 16  # the model ranks repeat each data rank's step
    counted = got.cost["flops"] * data_ranks
    hlo = want["cost"]["flops"] * want["n_devices"]
    print(f"olmo-1b train_4k: counted {counted:.6e} flops, 6ND {got.model_flops_global:.6e}, "
          f"reference HLO {hlo:.6e}, ratio to HLO {counted / hlo:.4f}")
    assert got.model_flops_global <= counted <= 1.1 * hlo


# ---------------------------------------------------------------------------
# the trace itself
# ---------------------------------------------------------------------------

_ADDITIVE = ("flops", "bytes_accessed", "transcendentals")


@pytest.mark.parametrize("arch,kind", [("olmo_1b", "train"), ("hymba_1_5b", "prefill"),
                                       ("qwen3_moe_30b_a3b", "train")])
def test_traced_cost_is_affine_in_layers(arch, kind):
    cell = ShapeCell("c", 32, 8, kind)
    mesh = D.ShapeMesh(2, 2)
    c1, c2, c5 = (D.trace_cell(_reduced(arch, n), cell, mesh) for n in (1, 2, 5))
    for k in (*_ADDITIVE, *(f"coll:{x}" for x in c5["collectives"])):
        a, b, got = c1["cost"].get(k, 0.0), c2["cost"].get(k, 0.0), c5["cost"][k]
        want = b + 3 * (b - a)
        assert abs(got - want) <= 1e-9 * abs(want), (k, got, want)


@pytest.mark.parametrize("arch", ["olmo_1b", "qwen3_moe_30b_a3b"])
def test_cache_and_microbatch_repeats_change_no_count(arch):
    cfg = TC.get_smoke(arch)
    cell = ShapeCell("t", 32, 16, "train")
    tc = TrainConfig(batch=16, seq=32, n_micro=4, accum_dtype="bfloat16")
    mesh = D.ShapeMesh(2, 2)
    fast = D.trace_cell(cfg, cell, mesh, tc)
    with FlopCounterMode(display=False) as fc:
        full = D.trace_cell(cfg, cell, mesh, tc, cache=False, micro_repeats=False)
    for k in ("memory", "cost", "collectives"):
        assert fast[k] == full[k], k
    assert fast["trace"].calls == full["trace"].calls
    assert fast["trace"].result_bytes == full["trace"].result_bytes
    assert fast["cost"]["flops"] == fc.get_total_flops()


def test_pallas_attention_is_refused_with_a_message():
    got = D.run_cell("olmo_1b", SMALL["train_s"], D.ShapeMesh(*MESH), verbose=False,
                     overrides={**_smoke_overrides("olmo_1b"), "attn_impl": "pallas"})
    assert not got.ok and got.error.startswith("NotImplementedError: attn_impl='pallas'")


def test_unsplittable_batch_is_a_cell_error_and_long_500k_skips():
    got = D.run_cell("olmo_1b", ShapeCell("odd", 64, 5, "train"), D.ShapeMesh(*MESH),
                     verbose=False, overrides=_smoke_overrides("olmo_1b"))
    assert not got.ok and got.error.startswith("ValueError")
    skip = D.run_cell("olmo_1b", "long_500k", D.production_mesh(), verbose=False)
    assert skip.ok and skip.skipped and skip.memory is None


def test_llama3_405b_train_allocates_nothing_and_takes_seconds():
    """Seconds of this process's CPU time: a loaded test run's wall clock
    would count the other workers' time too."""
    t0, c0 = time.perf_counter(), time.process_time()
    got = D.trace_cell(TC.get("llama3_405b"), TC.SHAPES["train_4k"], D.production_mesh())
    seconds, wall = time.process_time() - c0, time.perf_counter() - t0
    print(f"llama3-405b train_4k on 16x16: {seconds:.2f} CPU s ({wall:.2f} s wall), "
          f"{json.dumps(got['memory'])}")
    assert got["trace"].devices == {"meta"}  # every result of every operation
    assert got["memory"]["argument_bytes"] > 9e9 and got["cost"]["flops"] > 1e17
    assert seconds < 20


def test_hlo_breakdown_groups_sum_to_the_traced_result_bytes():
    cell = ShapeCell("t", 32, 8, "train")
    got = D.trace_cell(_reduced("qwen3_moe_30b_a3b", 2, moe_impl="ep"), cell, D.ShapeMesh(2, 2))
    tr = got["trace"]
    b, c = hlo_breakdown.breakdown(tr)
    assert sum(b.values()) == sum(tr.result_bytes.values())
    assert sum(c.values()) == sum(tr.calls.values())
    assert {"matmul", "elementwise", "layout", "collective"} <= set(b)
    assert b["collective"] == sum(got["collectives"].values()) - D._norm_all_reduce_bytes(
        len(tree_leaves(TM.init_params(_reduced("qwen3_moe_30b_a3b", 2), device="meta"))),
        D.ShapeMesh(2, 2))
    assert got["collectives"]["all-to-all"] > 0


def test_perf_runs_two_variants_of_a_smoke_cell(tmp_path, capsys):
    rows = perf.run("olmo_1b", SMALL["train_s"], ["baseline", "remat_dots"], D.ShapeMesh(*MESH),
                    str(tmp_path), smoke=True)
    assert [r["variant"] for r in rows] == ["baseline", "remat_dots"]
    base, dots = rows
    assert dots["compute_s"] < base["compute_s"]  # "dots" recomputes no matrix product
    assert sorted(os.listdir(tmp_path)) == ["olmo_1b.train_s.baseline.json",
                                            "olmo_1b.train_s.remat_dots.json"]


def test_roofline_reads_a_reference_and_a_port_artifact(tmp_path):
    mine = D.run_cell("olmo_1b", "decode_32k", D.production_mesh(), verbose=False).to_json()
    theirs = _olmo_artifact("decode_32k")
    rows = [roofline.analyze(mine), roofline.analyze(theirs)]
    assert all(r is not None and r["arch"] == "olmo_1b" for r in rows)
    (tmp_path / "olmo_1b.decode_32k.16x16.json").write_text(json.dumps(mine))
    assert len(roofline.analyze_dir(str(tmp_path))) == 1
    assert "| olmo_1b | decode_32k | 16x16 |" in roofline.render_table(rows)


def test_dryrun_cli_writes_the_records(tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "whisper_tiny", "--shape",
                                      "decode_32k", "--out", str(tmp_path)])
    with pytest.raises(SystemExit) as done:
        dryrun.main()
    assert done.value.code == 0
    rec = json.loads((tmp_path / "whisper_tiny.decode_32k.16x16.json").read_text())
    assert rec["ok"] and rec["memory"]["argument_bytes"] > 0


# the reference's subprocess has run beside the tests above


@pytest.mark.parametrize("arch,shape", CELLS)
def test_smoke_cells_equal_the_reference(ref, arch, shape):
    got = D.run_cell(arch, SMALL[shape], D.ShapeMesh(*MESH), verbose=False,
                     overrides=_smoke_overrides(arch))
    assert got.ok and not got.error, got.error
    want = ref[f"{arch}:{shape}"]
    assert {k: got.memory[k] for k in FIELDS} == {k: want["memory"][k] for k in FIELDS}
    assert got.model_flops_global == want["model_flops_global"]
    assert got.n_devices == want["n_devices"] == 8
    assert got.memory["temp_bytes"] > 0 and got.cost["flops"] > 0
