"""The port stands alone: it imports neither JAX nor the reference package,
and it never falls back from the card to the CPU on its own."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return name in ("jax", "repro") or name.startswith(("jax.", "repro."))


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_jax_or_the_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"


def test_port_imports_and_consumes_without_jax_or_reference():
    code = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import pkgutil, importlib
        import repro_torch
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(m.name)
        from repro_torch.core.state import StateCoordinator
        from repro_torch.core.synthetic import (
            ScenarioConfig, build_scenario, scenario_event_chunks)
        from repro_torch.etl import METLApp
        sc = build_scenario(ScenarioConfig(n_schemas=4, versions_per_schema=3,
                                           attrs_per_version=6, n_entities=2,
                                           cdm_attrs=8, seed=1))
        rows = 0
        for dd in (False, True):
            app = METLApp(StateCoordinator(sc.registry, sc.dpm), device="cpu",
                          device_densify=dd)
            for chunk in scenario_event_chunks(sc, seed=2, chunk_size=64, n_chunks=2):
                rows += len(app.consume(chunk))
        assert rows > 0
        assert not any(k == "jax" or k.startswith("jax.") for k, v in sys.modules.items()
                       if v is not None)
        print("OK", rows)
        """
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK")


def test_port_serves_without_jax_or_reference():
    """The model stack, the serving layer and the launcher's modules run
    with JAX and the reference package blocked."""
    code = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import torch
        import repro_torch.configs as C
        from repro_torch.kernels import ops
        from repro_torch.launch import serve
        from repro_torch.models import model as M
        from repro_torch.serve.decode import ServeConfig, Server
        cfg = C.get_smoke("llama3_405b").replace(attn_impl="pallas")
        params = M.init_params(cfg, 0, device="cpu")
        logits, _ = M.forward(params, cfg, {"tokens": torch.arange(24).reshape(2, 12)})
        assert logits.shape == (2, 12, cfg.vocab_padded)
        server = Server(params, cfg, ServeConfig(batch=2, cache_len=16, max_new=3, eos=-1),
                        device="cpu")
        rids = [server.submit([3, 4, 5]) for _ in range(3)]
        server.run(n_steps=50)
        assert all(len(server.done[r]) == 3 for r in rids)
        out = ops.moe_combine(torch.ones(2, 3, 4), torch.ones(5, 2, 3))
        assert out.shape == (5, 4)
        assert not any(k == "jax" or k.startswith("jax.") for k, v in sys.modules.items()
                       if v is not None)
        print("OK")
        """
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK")


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    from repro_torch.core.dmm_torch import compile_fused, compile_dpm
    from repro_torch.core.state import StateCoordinator
    from repro_torch.core.synthetic import ScenarioConfig, build_scenario
    from repro_torch.etl import METLApp, FusedEngine, PlanManager

    sc = build_scenario(ScenarioConfig(n_schemas=2, versions_per_schema=2,
                                       attrs_per_version=4, n_entities=1,
                                       cdm_attrs=4, seed=1))
    coord = StateCoordinator(sc.registry, sc.dpm)
    for make in (lambda: METLApp(coord), lambda: METLApp(coord, device="cuda"),
                 lambda: FusedEngine(), lambda: PlanManager(),
                 lambda: compile_fused(compile_dpm(sc.dpm, sc.registry), sc.registry)):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            make()


def test_streaming_entry_points_default_to_the_card():
    """``Cluster``, ``initial_load`` and the launcher's ``_etl_prompts`` run
    on the card unless asked for the CPU, and raise without one; the
    pipeline runs on its app's device.  A refused load leaves the
    coordinator thawed."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    from repro_torch.core.state import StateCoordinator
    from repro_torch.core.synthetic import ScenarioConfig, build_scenario
    from repro_torch.etl import Cluster, CollectSink, EventChunkSource, EventSource
    from repro_torch.etl.initial_load import initial_load
    from repro_torch.launch.serve import _etl_prompts

    sc = build_scenario(ScenarioConfig(n_schemas=2, versions_per_schema=2,
                                       attrs_per_version=4, n_entities=1,
                                       cdm_attrs=4, seed=1))
    coord = StateCoordinator(sc.registry, sc.dpm)
    src = EventSource(sc.registry, seed=1)
    for make in (lambda: Cluster(coord, [EventChunkSource(src)], [CollectSink()]),
                 lambda: Cluster.over_stream(coord, src, instances=2),
                 lambda: initial_load(coord, src, count=16, instances=2),
                 lambda: _etl_prompts(2, 512),
                 lambda: _etl_prompts(2, 512, shards=4),
                 lambda: _etl_prompts(2, 512, instances=2)):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            make()
    assert not coord.frozen


def test_replication_entry_points_default_to_the_card(tmp_path):
    """``DataPlane``, the replication command line and the launcher's
    ``_etl_replicated`` run on the card unless asked for the CPU, and raise
    (or exit non-zero) without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    from repro_torch.core.state import StateCoordinator
    from repro_torch.core.synthetic import ScenarioConfig, build_scenario
    from repro_torch.etl import EventSource
    from repro_torch.etl.replication import DataPlane
    from repro_torch.launch.serve import _etl_replicated

    sc = build_scenario(ScenarioConfig(n_schemas=2, versions_per_schema=2,
                                       attrs_per_version=4, n_entities=1,
                                       cdm_attrs=4, seed=1))
    coord = StateCoordinator(sc.registry, sc.dpm)
    for make in (lambda: DataPlane(coord, EventSource(sc.registry, seed=1)),
                 lambda: DataPlane(coord, EventSource(sc.registry, seed=1), device="cuda"),
                 lambda: _etl_replicated(2, 512)):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            make()
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.etl.replication", "--role",
                           "oracle", "--max-chunks", "2", "--out", str(tmp_path / "o.jsonl")],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0
    assert "torch.cuda.is_available" in proc.stderr
    assert "oracle:" not in proc.stdout


def test_chip_smoke_refuses_to_run_without_the_card_or_the_repo(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(alone)], capture_output=True,
                          text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
