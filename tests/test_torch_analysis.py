"""repro_torch.analysis: the port's analyzer against the reference's on the
rules it carries over, firing and clean fixtures for the rules it re-keys
to the port, planted faults in copies of the real port files, the port's
self-check, the two waiver markers, and the CLI.  CPU only."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import RULES as REF_RULES
from repro.analysis import analyze as ref_analyze
from repro.analysis.core import WAIVER_RE as REF_WAIVER_RE
from repro_torch.analysis import RULES, analyze
from repro_torch.analysis.core import WAIVER_RE, _load, collect_files
from repro_torch.analysis.project import Project

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _write(root: Path, rel: str, source: str) -> Path:
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(source)
    return p


def _run(tmp_path, rel, source, **kw):
    _write(tmp_path, rel, source)
    return analyze([str(tmp_path)], **kw)


def _hit(report):
    return {f.rule for f in report.findings}


def _project(root: Path) -> Project:
    return Project([_load(p)[0] for p in collect_files([str(root)])])


# ---------------------------------------------- parity with the reference
#
# Each case is one fixture tree of tests/test_analysis.py, written once for
# each package: {pkg} is ``repro`` or ``repro_torch``, {m} the waiver
# marker (``metl`` / ``metl-torch``), {dmm} the lowering module
# (``dmm_jax`` / ``dmm_torch``).  Both analyzers must report the same
# (rule, file, line, col) set.

PARITY = {
    "private-direct": {"benchmarks/bench.py": "app = METLApp(coord)\nn = app._seen\n"},
    "private-alias": {"benchmarks/bench.py":
                      "shadow = METLApp(coord)\nmirror = shadow\nx = mirror._parked\n"},
    "private-backstop": {"benchmarks/b.py": "x = thing._dedup_window\n"},
    "private-clean": {"benchmarks/bench.py":
                      "app = METLApp(coord)\ninfo = app.engine.info()\napp.reset_dedup()\n"},
    "private-owner": {"src/{pkg}/etl/helper.py": "app = METLApp(coord)\nn = app._seen\n"},
    "private-strings": {"benchmarks/doc.py": '"""Docs: app._seen and registry._state_id."""\n'
                        "# app._seen is private\nx = 1\n"},
    "private-registry": {"examples/demo.py":
                         "registry = Registry(root)\nregistry._state_id += 1\n"},
    "private-import-alias": {"benchmarks/bench_new.py":
                             "from {pkg}.etl.metl import METLApp\n"
                             "def run(coord):\n"
                             "    application = METLApp(coord)\n"
                             "    handle = application\n"
                             "    return handle._replay_rows\n"},
    "loop-per-event": {"src/{pkg}/etl/e.py":
                       "def densify_chunk(plan, evs):\n    out = []\n    for ev in evs:\n"
                       "        out.append(ev.key)\n    return out\n"},
    "loop-payload": {"src/{pkg}/etl/e.py":
                     "def densify_chunk(plan, evs):\n    return [ev.payload() for ev in evs]\n"},
    "loop-per-column": {"src/{pkg}/etl/e.py":
                        "def densify_chunk(plan, tri):\n"
                        "    return {{ov: gather(idx) for ov, idx in tri.by_column.items()}}\n"},
    "loop-reached": {"src/{pkg}/etl/e.py":
                     "def consume_groups(groups):\n    return _walk(groups)\n"
                     "def _walk(evs):\n    return [e.key for e in evs]\n"},
    "purity-outside": {"src/{pkg}/etl/x.py":
                       "def sneak(event, registry):\n    event.mutate(registry)\n"},
    "purity-apply": {"src/{pkg}/core/state.py":
                     "class StateCoordinator:\n    def apply(self, event):\n"
                     "        event.mutate(self.registry)\n"},
    "purity-unfrozen": {"src/{pkg}/etl/control.py":
                        "import dataclasses\nclass ControlEvent:\n    pass\n"
                        "@dataclasses.dataclass(frozen=True)\nclass SchemaEvolved(ControlEvent):\n"
                        "    schema_id: int\nclass Grandchild(SchemaEvolved):\n    pass\n"},
    "writer-outside": {"src/{pkg}/etl/x.py":
                       "def sneak(coord, ev):\n    coord.control_log.append(ev)\n"},
    "writer-helper": {"src/{pkg}/core/state.py":
                      "class StateCoordinator:\n    def apply(self, event):\n"
                      "        self._log(event)\n    def _log(self, event):\n"
                      "        self.control_log.append(event)\n"},
    "writer-open-helper": {"src/{pkg}/core/state.py":
                           "class StateCoordinator:\n    def apply(self, event):\n"
                           "        self._log(event)\n    def _log(self, event):\n"
                           "        self.control_log.append(event)\n"
                           "def backdoor(coord, ev):\n    coord._log(ev)\n"},
    "writer-replica": {"src/{pkg}/etl/replication.py":
                       "class FollowerNode:\n    def catch_up(self, event):\n"
                       "        self.coordinator.apply(event)\n"
                       "class LeaderNode:\n    def apply(self, event):\n"
                       "        self.coordinator.apply(event)\n"},
    "writer-module-bound": {"src/{pkg}/etl/other.py":
                            "def drive(coordinator, event):\n    coordinator.apply(event)\n"},
    "pin-unpinned": {"src/{pkg}/etl/e.py":
                     "def make(vals, mask):\n    return DenseChunk(vals=vals, mask=mask)\n"},
    "pin-across-mutation": {"src/{pkg}/etl/e.py":
                            "def consume_guarded(coord, plan, evs, ev):\n"
                            "    dense = densify(plan, evs)\n    coord.apply(ev)\n"
                            "    return dense.plan\n"},
    "pin-redensify": {"src/{pkg}/etl/e.py":
                      "def consume_ok(coord, plan, evs, ev):\n    dense = densify(plan, evs)\n"
                      "    rows = dense.plan\n    coord.apply(ev)\n"
                      "    dense = densify(plan, evs)\n    return dense.plan, rows\n"},
    "publish-direct": {"benchmarks/bench.py":
                       "from {pkg}.core.{dmm} import compile_dpm, compile_fused\n"
                       "plan = compile_fused(compile_dpm(dpm, reg), reg)\n"},
    "publish-alias": {"src/{pkg}/etl/engines.py":
                      "from {pkg}.core.{dmm} import splice_fused as sf\n"
                      "plan = sf(old, compiled, reg, touched)\n"},
    "publish-owners": {"src/{pkg}/etl/plan.py":
                       "from {pkg}.core.{dmm} import compile_fused\n"
                       "def _build(compiled, reg):\n    return compile_fused(compiled, reg)\n",
                       "src/{pkg}/core/{dmm}.py":
                       "def compile_fused(compiled, reg):\n    return FusedDMM(state=0)\n"},
    "waiver-line-below": {"benchmarks/b.py":
                          "# {m}: allow[private-reach-in] exercising the private shim\n"
                          "x = thing._seen\n"},
    "waiver-def": {"src/{pkg}/etl/e.py":
                   "def densify_oracle(plan, evs):  # {m}: allow[hot-path-python-loop] oracle\n"
                   "    a = [ev.key for ev in evs]\n    b = [ev.payload() for ev in evs]\n"
                   "    return a, b\n"},
    "waiver-no-leak": {"src/{pkg}/etl/e.py":
                       "def densify_oracle(plan, evs):  # {m}: allow[hot-path-python-loop] oracle\n"
                       "    return [ev.key for ev in evs]\n\n"
                       "def densify_other(plan, evs):\n    return [ev.key for ev in evs]\n"},
    "waiver-no-reason": {"benchmarks/b.py": "x = thing._seen  # {m}: allow[private-reach-in]\n"},
    "waiver-unknown": {"benchmarks/b.py": "x = 1  # {m}: allow[no-such-rule] because\n"},
    "waiver-wrong-rule": {"benchmarks/b.py":
                          "x = thing._seen  # {m}: allow[hot-path-python-loop] wrong rule\n"},
    "waiver-docstring": {"benchmarks/b.py":
                         '"""Waive with ``# {m}: allow[rule-id] reason``."""\nx = 1\n'},
    "waiver-stale": {"benchmarks/b.py":
                     "x = 1  # {m}: allow[private-reach-in] excused code is long gone\n"},
    "waiver-audit-unwaivable": {"benchmarks/b.py":
                                "# {m}: allow[unused-waiver] excusing the audit\n"
                                "x = 1  # {m}: allow[private-reach-in] stale\n"},
    "parse-error": {"benchmarks/b.py": "def broken(:\n"},
    "select-ignore": {"src/{pkg}/etl/e.py":
                      "import numpy as np\ndef dispatch(dense):\n    return np.asarray(dense)\n"
                      "def densify_x(plan, evs):\n    return [ev.key for ev in evs]\n"},
}
PARITY_KW = {
    "select": {"select": ["host-sync-in-hot-path"]},
    "ignore": {"ignore": ["host-sync-in-hot-path"]},
    "scoped": {"select": ["private-reach-in", "bad-waiver", "unused-waiver"]},
}
PARITY_RUNS = [(case, kw) for case in PARITY for kw in ([None] if case != "select-ignore"
                                                        else [None, "select", "ignore"])]
PARITY_RUNS.append(("waiver-stale", "scoped"))


def _fixture(root: Path, files: dict, torch: bool) -> None:
    subs = dict(pkg="repro_torch" if torch else "repro", m="metl-torch" if torch else "metl",
                dmm="dmm_torch" if torch else "dmm_jax")
    for rel, src in files.items():
        _write(root, rel.format(**subs), src.format(**subs))


def _located(report, root: Path):
    return {(f.rule, Path(f.path).relative_to(root).as_posix()
             .replace("repro_torch", "PKG").replace("repro", "PKG")
             .replace("dmm_torch", "DMM").replace("dmm_jax", "DMM"), f.line, f.col)
            for f in report.findings}


@pytest.mark.parametrize("case,kw", PARITY_RUNS, ids=[f"{c}-{k}" for c, k in PARITY_RUNS])
def test_carried_over_rules_match_the_reference(case, kw, tmp_path):
    kwargs = PARITY_KW.get(kw, {})
    ref_root, port_root = tmp_path / "ref", tmp_path / "port"
    _fixture(ref_root, PARITY[case], torch=False)
    _fixture(port_root, PARITY[case], torch=True)
    want = _located(ref_analyze([str(ref_root)], **kwargs), ref_root)
    got = _located(analyze([str(port_root)], **kwargs), port_root)
    assert got == want


def test_select_of_an_unknown_rule_raises(tmp_path):
    with pytest.raises(ValueError):
        analyze([str(tmp_path)], select=["no-such-rule"])


# ------------------------------------------------ the re-keyed rules' fixtures


_SYNC_HELPERS = """\
import torch

class Engine:
    def dispatch(self, dense):
        _peek(dense)
        _drain()
        return launch(dense)

def _peek(dense):
    n = torch.zeros(1, device="cuda")
    return n.item()

def _drain():
    torch.cuda.synchronize()
"""

_SYNC_CLEAN = """\
import numpy as np
import torch

class Engine:
    def dispatch(self, dense):
        _layout(dense)
        return launch(dense)

    def emit(self, handle):
        # {m}: allow[host-sync-in-hot-path] the engine sync point
        out = handle.outputs.cpu().numpy()
        return out.tolist()

def _layout(dense):
    rows = np.zeros(4, np.int32)
    if dense.device.type == "cpu":
        dense.cpu()
    return rows.tolist(), dense.row_ids.size
"""


def test_host_sync_fires_on_item_and_synchronize_reached_from_dispatch(tmp_path):
    rep = _run(tmp_path, "src/repro_torch/etl/e.py", _SYNC_HELPERS)
    hits = sorted((f.line, f.rule) for f in rep.findings)
    assert hits == [(11, "host-sync-in-hot-path"), (14, "host-sync-in-hot-path")]


def test_host_sync_clean_on_host_numpy_cpu_guard_and_waived_emit(tmp_path):
    rep = _run(tmp_path, "src/repro_torch/etl/e.py", _SYNC_CLEAN.format(m="metl-torch"))
    assert rep.ok, [f.render() for f in rep.findings]
    assert [f.rule for f, _ in rep.waived] == ["host-sync-in-hot-path"]


@pytest.mark.parametrize("line", ["    x = dense.vals.cpu()\n",
                                  "    x = dense.vals.to('cpu')\n",
                                  "    ev.synchronize()\n",
                                  "    x = dense.count.item()\n",
                                  "    x = float(dense.vals[0])\n"])
def test_host_sync_fires_in_dispatch_itself(line, tmp_path):
    rep = _run(tmp_path, "src/repro_torch/kernels/ops.py",
               "def dmm_apply_dense(dense, ev):\n" + line + "    return dense\n")
    assert _hit(rep) == {"host-sync-in-hot-path"}


def test_host_sync_out_of_scope_module(tmp_path):
    rep = _run(tmp_path, "scripts_dir/tool.py", _SYNC_HELPERS)
    assert "host-sync-in-hot-path" not in _hit(rep)


_LAYOUT = """\
import numpy as np
import torch

def densify(plan, tri):
    return _chunk_layout(plan, tri)

def _chunk_layout(plan, tri):
    sel = np.concatenate(tri.idx)
{body}
    return sel
"""


def test_transfer_accounting_fires_on_to_cuda_in_chunk_layout(tmp_path):
    rep = _run(tmp_path, "src/repro_torch/etl/engines.py",
               _LAYOUT.format(body="    dev_sel = torch.from_numpy(sel).to('cuda')"))
    hits = [f for f in rep.findings]
    assert [(f.rule, f.line) for f in hits] == [("transfer-accounting", 9)]


@pytest.mark.parametrize("body", ["    sel = torch.from_numpy(sel).to(torch.int32)",
                                  "    t = torch.as_tensor(sel)",
                                  "    if plan.device.type == 'cpu':\n"
                                  "        sel = torch.from_numpy(sel).to(plan.device)"])
def test_transfer_accounting_clean_twins(body, tmp_path):
    rep = _run(tmp_path, "src/repro_torch/etl/engines.py", _LAYOUT.format(body=body))
    assert "transfer-accounting" not in _hit(rep)


def test_transfer_accounting_fires_on_cuda_and_device_tensor(tmp_path):
    rep = _run(tmp_path, "src/repro_torch/etl/engines.py",
               _LAYOUT.format(body="    a = torch.tensor(sel, device=plan.device)\n"
                                   "    b = torch.from_numpy(sel).cuda()"))
    assert [f.line for f in rep.findings if f.rule == "transfer-accounting"] == [9, 10]


_ARENA = """\
from repro_torch.kernels.ops import dmm_apply_dense

def _dispatch(arenas, stats, dense, op, *args):
    out = op(dense.host, *args)
    arenas.release(dense.slot)
    return out

class FusedEngine:
    def dispatch(self, dense):
{before}        h = _dispatch(self.arenas, self.stats, dense, dmm_apply_dense, dense.plan.src2d)
{after}        return h
"""


def test_arena_reuse_fires_on_write_after_dispatch(tmp_path):
    rep = _run(tmp_path, "src/repro_torch/etl/engines.py",
               _ARENA.format(before="", after="        dense.host[:16].zero_()\n"))
    hits = [(f.rule, f.line) for f in rep.findings]
    assert hits == [("arena-reuse-in-flight", 11)]
    assert "dense.host" in rep.findings[0].message


@pytest.mark.parametrize("after", ["        dense.vals[0, 0] = 1.0\n",
                                   "        np.copyto(dense.mask, 0)\n"])
def test_arena_reuse_fires_on_every_view_of_the_arena(after, tmp_path):
    rep = _run(tmp_path, "src/repro_torch/etl/engines.py",
               "import numpy as np\n" + _ARENA.format(before="", after=after))
    assert "arena-reuse-in-flight" in _hit(rep)


def test_arena_reuse_clean_before_the_copy_and_after_a_retake(tmp_path):
    rep = _run(tmp_path, "src/repro_torch/etl/engines.py",
               _ARENA.format(before="        dense.host[:16].zero_()\n",
                             after="        dense = self.densify_next()\n"
                                   "        dense.host[:16].zero_()\n"))
    assert "arena-reuse-in-flight" not in _hit(rep)


def test_arena_reuse_follows_a_bare_arena_and_its_views(tmp_path):
    rep = _run(tmp_path, "src/repro_torch/kernels/k.py",
               "from .segmented_gather import arena_views, segmented_gather_chunk\n"
               "def run(arenas, table):\n"
               "    slot, turn, host = arenas.take(64)\n"
               "    v, m, r, b = arena_views(host, 2, 4, 1, 2)\n"
               "    out = segmented_gather_chunk(host, table)\n"
               "    v[0] = 1.0\n"
               "    slot, turn, host = arenas.take(64)\n"
               "    host[0] = 1\n"
               "    return out\n")
    assert [(f.rule, f.line) for f in rep.findings] == [("arena-reuse-in-flight", 6)]


_CTYPES_KERNEL = """\
from . import build

def _fn():
    return build.load("my_map").metl_my_map

def my_map(x):
    return _fn()(x)

def my_map_shard(x):
    return _fn()(x)

def layout(n):
    return n * 4
"""


def _kernel_tree(tmp_path, ref_src, test_src=None):
    _write(tmp_path, "pkg/kernels/my_map.py", _CTYPES_KERNEL)
    _write(tmp_path, "pkg/kernels/build.py", "def load(name):\n    return name\n")
    _write(tmp_path, "pkg/kernels/ref.py", ref_src)
    (tmp_path / "tests").mkdir(exist_ok=True)
    if test_src is not None:
        _write(tmp_path, "tests/test_torch_k.py", test_src)
    return analyze([str(tmp_path / "pkg")])


def test_kernel_parity_fires_on_a_ctypes_kernel_without_twin(tmp_path):
    rep = _kernel_tree(tmp_path, "def other_ref(x):\n    return x\n")
    hits = sorted(f.message.split("(")[0] for f in rep.findings if f.rule == "kernel-ref-parity")
    assert hits == ["kernel my_map", "kernel my_map_shard"]  # layout() launches nothing


def test_kernel_parity_fires_when_the_test_names_only_the_kernel(tmp_path):
    rep = _kernel_tree(tmp_path, "def my_map_ref(x):\n    return x\n",
                       "from pkg.kernels.my_map import my_map\n")
    hits = [f for f in rep.findings if f.rule == "kernel-ref-parity"]
    assert len(hits) == 1 and "my_map_ref()" in hits[0].message


def test_kernel_parity_reads_only_the_torch_tests(tmp_path):
    rep = _kernel_tree(tmp_path, "def my_map_ref(x):\n    return x\n")
    _write(tmp_path, "tests/test_k.py", "my_map(1) == my_map_ref(1)\n")
    rep = analyze([str(tmp_path / "pkg")])
    assert "kernel-ref-parity" in _hit(rep)


def test_kernel_parity_clean_twin(tmp_path):
    rep = _kernel_tree(tmp_path, "def my_map_ref(x):\n    return x\n",
                       "def test_parity():\n    assert my_map(1) == my_map_ref(1)\n")
    assert "kernel-ref-parity" not in _hit(rep)


_CACHED_LOAD = """\
import functools
from repro_torch.kernels import build

@functools.lru_cache(maxsize=None)
def _lib({param}):
    return build.load(name)
"""


def test_jit_cache_fires_on_a_cached_build_load_with_an_unannotated_key(tmp_path):
    rep = _run(tmp_path, "src/repro_torch/kernels/k.py", _CACHED_LOAD.format(param="name"))
    hits = [f for f in rep.findings if f.rule == "jit-cache-hygiene"]
    assert hits and "'name'" in hits[0].message


@pytest.mark.parametrize("param", ["*names", "name: torch.Tensor"])
def test_jit_cache_fires_on_star_args_and_tensor_keys(param, tmp_path):
    rep = _run(tmp_path, "src/repro_torch/kernels/k.py",
               "import torch\n" + _CACHED_LOAD.format(param=param))
    assert _hit(rep) == {"jit-cache-hygiene"}


def test_jit_cache_sees_a_module_dict_cache_and_call_site_literals(tmp_path):
    rep = _run(tmp_path, "src/repro_torch/kernels/k.py",
               "import torch\n_progs = {}\n"
               "def program(shape, fn):\n"
               "    p = _progs.get(shape)\n"
               "    if p is None:\n"
               "        p = _progs[shape] = torch.compile(fn)\n"
               "    return p\n"
               "x = program([1, 2], abs)\n")
    assert sorted(f.line for f in rep.findings if f.rule == "jit-cache-hygiene") == [3, 3, 8]


def test_jit_cache_clean_annotated_key(tmp_path):
    rep = _run(tmp_path, "src/repro_torch/kernels/k.py", _CACHED_LOAD.format(param="name: str"))
    assert "jit-cache-hygiene" not in _hit(rep)


def test_epoch_pin_covers_the_per_block_chunk(tmp_path):
    rep = _run(tmp_path, "src/repro_torch/etl/e.py",
               "def make(chunk):\n    return BlockDense(chunk=chunk, plan=None)\n")
    assert _hit(rep) == {"epoch-pin-escape"}


def test_private_reach_in_backstop_names_the_ports_privates(tmp_path):
    rep = _run(tmp_path, "benchmarks/b.py", "a = eng2._arenas\nb = thing._fused\n")
    assert [(f.rule, f.line) for f in rep.findings] == [("private-reach-in", 1)]


def test_plan_publish_owners_are_the_ports(tmp_path):
    _write(tmp_path, "src/repro_torch/core/dmm_jax.py",
           "def compile_fused(compiled, reg):\n    return FusedDMM(state=0)\n")
    _write(tmp_path, "src/repro_torch/core/dmm_torch.py",
           "def compile_fused(compiled, reg):\n    return FusedDMM(state=0)\n")
    rep = analyze([str(tmp_path)], select=["plan-publish-single-site"])
    assert {Path(f.path).name for f in rep.findings} == {"dmm_jax.py"}


# ----------------------------------------------------------- the project model


def test_call_graph_has_no_edge_from_an_external_or_inherited_method(tmp_path):
    _write(tmp_path, "src/repro_torch/kernels/ref.py",
           "import torch\ndef gather_ref(v, i):\n    return torch.gather(v, 1, i)\n"
           "class _G(torch.autograd.Function):\n    pass\n"
           "def run(x):\n    return _G.apply(x)\n")
    _write(tmp_path, "src/repro_torch/sharding/comm.py", "def gather(x):\n    return x\n")
    _write(tmp_path, "src/repro_torch/etl/node.py",
           "class LeaderNode:\n    def apply(self, ev):\n        return ev\n")
    p = _project(tmp_path)
    assert p.calls["repro_torch.kernels.ref.gather_ref"] == set()
    assert p.calls["repro_torch.kernels.ref.run"] == set()


def test_async_copy_map_follows_wrappers_and_callables_passed_in(tmp_path):
    _write(tmp_path, "src/repro_torch/etl/engines.py", _ARENA.format(before="", after=""))
    p = _project(tmp_path)
    assert p.functions["repro_torch.etl.engines._dispatch"].copies_from == {2: "dense"}
    assert p.functions["repro_torch.etl.engines.FusedEngine.dispatch"].copies_from == {
        1: "dense"}


def test_port_dispatch_does_not_reach_the_sinks():
    """The scratch copy of the reference analyzer reached ``tokenize_row``
    from ``dmm_apply_fused`` through ``torch.gather`` -> ``comm.gather`` ->
    ``LeaderNode.apply``; the mended call graph does not."""
    p = _project(PORT)
    seeds = p.seeds_matching(re.compile(r"^(dispatch|dmm_apply\w*)$"),
                             packages=(("repro_torch", "etl"), ("repro_torch", "kernels")))
    reached = p.reachable(seeds)
    assert "repro_torch.etl.batcher.tokenize_row" not in reached
    assert "repro_torch.kernels.ops.dmm_apply_dense" in reached


# ------------------------------------- planted faults in copies of the real files


def _plant(src: str, old: str, new: str) -> str:
    assert src.count(old) == 1, f"mutation site moved: {old!r}"
    return src.replace(old, new)


MUTATIONS = {
    "host-sync": ("etl/engines.py", "host-sync-in-hot-path",
                  lambda s: _plant(s, "        fused = dense.plan\n",
                                   "        fused = dense.plan; torch.cuda.synchronize()\n")),
    "transfer": ("etl/engines.py", "transfer-accounting",
                 lambda s: _plant(s, "    bstart = plan.col_block_start[col_ids].astype(np.int64)\n",
                                  "    bstart = plan.col_block_start[col_ids].astype(np.int64); "
                                  "_ = torch.from_numpy(sel).to('cuda')\n")),
    "arena": ("etl/engines.py", "arena-reuse-in-flight",
              lambda s: s + "\n\ndef _reuse(arenas, stats, dense, table):\n"
                            "    out = _dispatch(arenas, stats, dense, dmm_apply_dense, table)\n"
                            "    dense.vals[0, 0] = 1.0\n    return out\n"),
    "pin": ("etl/engines.py", "epoch-pin-escape",
            lambda s: _plant(s, "    return DenseChunk(\n        plan=plan,\n        vals=vals,\n"
                                "        mask=mask,\n        row_ids=layout.row_ids,",
                             "    return DenseChunk(\n        plan=None,\n        vals=vals,\n"
                             "        mask=mask,\n        row_ids=layout.row_ids,")),
    "loop": ("etl/engines.py", "hot-path-python-loop",
             lambda s: s + "\n\ndef _densify_chunk(plan, evs):\n    out = {}\n"
                           "    for ev in evs:\n        for uid, val in ev.payload().items():\n"
                           "            out[uid] = val\n    return out\n"),
    "publish": ("etl/engines.py", "plan-publish-single-site",
                lambda s: s + "\n\ndef sneak_compile(compiled, registry):\n"
                              "    from ..core.dmm_torch import compile_fused\n"
                              "    return compile_fused(compiled, registry)\n"),
    "purity": ("etl/plan.py", "control-plane-purity",
               lambda s: s + "\n\ndef _sneak(event, registry):\n    event.mutate(registry)\n"),
    "replica": ("etl/replication.py", "single-writer-control",
                lambda s: s + "\n\nclass FollowerShortcut:\n    def catch_up(self, event):\n"
                              "        self.coordinator.apply(event)\n"),
    "writer": ("core/state.py", "single-writer-control",
               lambda s: s + "\n\ndef sneak_record(coordinator, record):\n"
                             "    coordinator.control_log.append(record)\n"),
}
_MUTATED_FILES = ("etl/engines.py", "etl/plan.py", "etl/replication.py", "core/state.py")


def _copy_tree(root: Path) -> None:
    for rel in _MUTATED_FILES:
        _write(root, f"src/repro_torch/{rel}", (PORT / rel).read_text())


@pytest.fixture(scope="module")
def unplanted(tmp_path_factory):
    root = tmp_path_factory.mktemp("unplanted")
    _copy_tree(root)
    rep = analyze([str(root)])
    return {(f.rule, Path(f.path).name, f.line) for f in rep.findings}


@pytest.mark.parametrize("name", list(MUTATIONS))
def test_a_planted_fault_fires_exactly_its_rule(name, unplanted, tmp_path):
    rel, rule, plant = MUTATIONS[name]
    _copy_tree(tmp_path)
    path = tmp_path / "src/repro_torch" / rel
    path.write_text(plant(path.read_text()))
    rep = analyze([str(tmp_path)])
    new = {(f.rule, Path(f.path).name, f.line) for f in rep.findings} - unplanted
    assert new and {r for r, _, _ in new} == {rule}, new


# ------------------------------------------------------------------ self-check


def test_port_tree_is_clean():
    """The port, chip_smoke.py and the port's examples pass the port's
    analyzer; the deliberate syncs and per-event oracles are waived, with
    reasons."""
    rep = analyze([str(PORT), str(REPO / "chip_smoke.py"),
                   *map(str, sorted((REPO / "examples").glob("*_torch.py")))])
    assert rep.ok, "\n".join(f.render() for f in rep.findings)
    waived = {f.rule for f, _ in rep.waived}
    assert {"host-sync-in-hot-path", "hot-path-python-loop"} <= waived
    assert all(w.reason for _, w in rep.waived)


# --------------------------------------------------------- the two markers


def test_the_two_waiver_markers_do_not_cross():
    port = "x = 1  # metl-torch: allow[private-reach-in] a reason"
    ref = "x = 1  # metl: allow[private-reach-in] a reason"
    assert WAIVER_RE.search(port) and not WAIVER_RE.search(ref)
    assert REF_WAIVER_RE.search(ref) and not REF_WAIVER_RE.search(port)


def test_each_analyzer_reads_only_its_own_marker(tmp_path):
    _write(tmp_path, "benchmarks/b.py",
           "x = thing._seen  # metl: allow[private-reach-in] the reference's waiver\n"
           "\n"
           "y = thing._seen  # metl-torch: allow[private-reach-in] the port's waiver\n")
    port = analyze([str(tmp_path)])
    ref = ref_analyze([str(tmp_path)])
    assert [(f.rule, f.line) for f in port.findings] == [("private-reach-in", 1)]
    assert [(f.rule, f.line) for f in ref.findings] == [("private-reach-in", 3)]


# ------------------------------------------------------------------------ CLI


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *args],
                          capture_output=True, text=True, cwd=REPO,
                          env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})


def test_cli_exit_codes_and_report(tmp_path):
    _write(tmp_path, "clean/b.py", "x = 1\n")
    _write(tmp_path, "dirty/b.py", "x = thing._seen\n")
    report = tmp_path / "ANALYSIS.json"
    clean = _cli(str(tmp_path / "clean"), "--output", "json", "--report", str(report))
    assert clean.returncode == 0, clean.stdout + clean.stderr
    assert json.loads(clean.stdout)["ok"] and json.loads(report.read_text())["ok"]
    dirty = _cli(str(tmp_path / "dirty"))
    assert dirty.returncode == 1 and "[private-reach-in]" in dirty.stdout
    assert "repro_torch.analysis: 1 finding(s)" in dirty.stdout
    assert _cli().returncode == 2
    assert _cli(str(tmp_path), "--select", "no-such-rule").returncode == 2


def test_cli_lists_a_counterpart_of_every_reference_rule():
    proc = _cli("--list-rules")
    assert proc.returncode == 0
    ids = set(re.findall(r"^(\S+)$", proc.stdout, re.M))
    counterparts = ids | set(re.findall(r"^    reference: (\S+)$", proc.stdout, re.M))
    assert set(REF_RULES) <= counterparts
    assert ids == set(RULES) and "arena-reuse-in-flight" in ids


def test_cli_github_output(tmp_path):
    _write(tmp_path, "b.py", "x = thing._seen\n")
    proc = _cli(str(tmp_path), "--output", "github")
    assert proc.returncode == 1
    assert "::error file=" in proc.stdout
    assert "title=repro_torch.analysis[private-reach-in]" in proc.stdout
    assert proc.stdout.splitlines()[-1].startswith("repro_torch.analysis: 1 finding(s)")
