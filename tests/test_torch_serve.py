"""The port's serving layer against the JAX reference, on the CPU.

Both sides get the same float32 weights (the reference's ``init_params``
through ``params_from_jax``) and the same prompts from numpy seeds; the
generated tokens must be equal, since an argmax over float32 logits that
agree to ~1e-5 picks the same token.  The scenarios are those of
tests/test_serve.py, plus one that drives the shared decode position past
``cache_len`` (the reference clamps the cache write to the last slot).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import repro.configs as RC
from repro.models import model as RM
from repro.serve.decode import ServeConfig as RServeConfig
from repro.serve.decode import Server as RServer
from repro.serve.decode import greedy_decode as r_greedy_decode

import repro_torch.configs as TC
from repro_torch.core.convert import params_from_jax
from repro_torch.serve.decode import ServeConfig, Server, greedy_decode

REPO = os.path.join(os.path.dirname(__file__), "..")
F32 = dict(param_dtype="float32", compute_dtype="float32")


def _setup(arch="olmo_1b"):
    rcfg = RC.get_smoke(arch).replace(**F32)
    tcfg = TC.get_smoke(arch).replace(**F32)
    jp = RM.init_params(rcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return rcfg, tcfg, jp, tp


@pytest.mark.parametrize("arch", ["olmo_1b", "llama3_405b"])
def test_greedy_decode_matches_reference(arch):
    rcfg, tcfg, jp, tp = _setup(arch)
    prompt = np.random.default_rng(0).integers(2, rcfg.vocab, (2, 4)).astype(np.int32)
    want = np.asarray(r_greedy_decode(jp, rcfg, jnp.asarray(prompt), max_new=6, cache_len=32))
    got = greedy_decode(tp, tcfg, torch.from_numpy(prompt), max_new=6, cache_len=32,
                        device="cpu")
    assert got.shape == (2, 6) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    again = greedy_decode(tp, tcfg, torch.from_numpy(prompt), max_new=6, cache_len=32,
                          device="cpu")
    assert torch.equal(got, again)  # deterministic
    assert (got.numpy() < tcfg.vocab).all()


def _serve_both(rcfg, tcfg, jp, tp, sc_kw, prompts, n_steps):
    rs = RServer(jp, rcfg, RServeConfig(**sc_kw))
    ts = Server(tp, tcfg, ServeConfig(**sc_kw), device="cpu")
    r_ids = [rs.submit(p) for p in prompts]
    t_ids = [ts.submit(p) for p in prompts]
    assert r_ids == t_ids
    rs.run(n_steps=n_steps)
    ts.run(n_steps=n_steps)
    return rs, ts, t_ids


@pytest.mark.parametrize("scenario", ["all_requests", "slot_reuse", "past_cache_len", "eos"])
def test_server_matches_reference(scenario):
    """tests/test_serve.py's scenarios, token for token: five 3-token
    requests on 2 slots; two requests through one reused slot (which keeps
    the first request's K/V history, as the reference's one global position
    does); 40+ steps on an 8-slot cache, so every write past position 7
    lands in slot 7; and an EOS that retires a request early."""
    rcfg, tcfg, jp, tp = _setup()
    rng = np.random.default_rng(1)
    if scenario == "all_requests":
        sc_kw = dict(batch=2, cache_len=64, max_new=5, eos=-1)
        prompts = [rng.integers(2, rcfg.vocab, 3).tolist() for _ in range(5)]
    elif scenario == "slot_reuse":
        sc_kw = dict(batch=1, cache_len=64, max_new=3, eos=-1)
        prompts = [[5, 6], [7, 8, 9]]
    elif scenario == "past_cache_len":
        sc_kw = dict(batch=3, cache_len=8, max_new=6, eos=-1)
        prompts = [rng.integers(2, rcfg.vocab, int(n)).tolist() for n in (2, 5, 3, 4, 6)]
    else:
        sc_kw = dict(batch=2, cache_len=64, max_new=8, eos=-1)
        prompts = [rng.integers(2, rcfg.vocab, 3).tolist() for _ in range(3)]
        # the first token request 0 generates becomes the EOS
        probe = Server(tp, tcfg, ServeConfig(**sc_kw), device="cpu")
        for p in prompts:
            probe.submit(p)
        probe.run(n_steps=200)
        sc_kw["eos"] = probe.done[0][0]
    rs, ts, rids = _serve_both(rcfg, tcfg, jp, tp, sc_kw, prompts, n_steps=200)
    assert ts.done == rs.done
    assert all(rid in ts.done for rid in rids)
    if scenario == "eos":
        assert len(ts.done[0]) == 1  # retired at the EOS
    else:
        assert all(len(ts.done[rid]) == sc_kw["max_new"] for rid in rids)
    if scenario == "past_cache_len":
        assert ts.state["pos"] == int(rs.state["pos"]) > 2 * sc_kw["cache_len"]
    np.testing.assert_allclose(ts.state["k"].numpy(), np.asarray(rs.state["k"]),
                               atol=1e-4, rtol=1e-4)


def test_serving_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    _, tcfg, _, tp = _setup()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        Server(tp, tcfg, ServeConfig())
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        greedy_decode(tp, tcfg, torch.zeros((1, 2), dtype=torch.int32))


def test_server_refuses_parameters_on_another_device():
    _, tcfg, _, tp = _setup()
    meta = {"embed": {"tok": tp["embed"]["tok"].to("meta")}}
    with pytest.raises(ValueError, match="parameters are on meta"):
        Server(meta, tcfg, ServeConfig(), device="cpu")


def _launch(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                          capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)


def test_serve_launcher_runs_on_cpu():
    proc = _launch("--arch", "olmo_1b", "--smoke", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 8  # --requests 8
    assert all(line.startswith(f"request {i}: 16 tokens -> ") for i, line in enumerate(lines))


@pytest.mark.parametrize("flags", [["--replicated"], ["--etl", "--instances", "2", "--replicated"]])
def test_serve_launcher_refuses_replicated(flags):
    """The distributed control plane (transport and replication) is the
    one ETL-fed mode still to be ported."""
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match="ROADMAP queue 1 item 12"):
        serve.main(["--smoke", "--device", "cpu", *flags])


# _etl_prompts' keywords for the launcher's ETL flag combinations
ETL_FLAGS = {
    "etl": {},
    "async-consume": dict(async_consume=True),
    "device-densify": dict(device_densify=True),
    "instances-2": dict(instances=2),
    "all-but-shards": dict(instances=2, async_consume=True, device_densify=True),
}


@pytest.mark.parametrize("flags", list(ETL_FLAGS))
def test_etl_prompts_match_reference(flags):
    """``--etl`` prompts: the same scenario, stream and topology on both
    sides, so the tokenized prompts are equal."""
    from repro.launch.serve import _etl_prompts as r_etl_prompts
    from repro_torch.launch.serve import _etl_prompts

    vocab = TC.get("olmo_1b").vocab
    for n in (8, 300):  # one chunk, and several 16-chunk windows' worth
        want = r_etl_prompts(n, vocab, **ETL_FLAGS[flags])
        got = _etl_prompts(n, vocab, device="cpu", **ETL_FLAGS[flags])
        assert len(got) == n and got == want


def _shards_parity() -> None:
    """Run in a 4-device process: ``--shards 4``, alone and with every other
    ETL flag, against the reference's sharded prompts."""
    from repro.launch.serve import _etl_prompts as r_etl_prompts
    from repro_torch.launch.serve import _etl_prompts

    for kw in ({}, dict(instances=2, async_consume=True, device_densify=True)):
        want = r_etl_prompts(300, 50_304, shards=4, **kw)
        assert _etl_prompts(300, 50_304, shards=4, device="cpu", **kw) == want


def test_etl_prompts_with_shards_match_reference():
    from _subproc import run_sub

    out = run_sub(f"""
        import sys
        sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})
        import test_torch_serve as t
        t._shards_parity()
        print("subprocess OK")
    """, devices=4)
    assert "subprocess OK" in out
    assert out.count("etl: sharded engine over 4 shards") == 2  # reference and port


def test_serve_launcher_runs_etl_on_cpu():
    proc = _launch("--arch", "olmo_1b", "--smoke", "--device", "cpu", "--etl",
                   "--async-consume")
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("etl: ") and "async double-buffered" in lines[0]
    requests = [line for line in lines if line.startswith("request ")]
    assert len(requests) == 8  # --requests 8, every one completed
    assert all(line.startswith(f"request {i}: 16 tokens -> ") for i, line in enumerate(requests))


def test_serve_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    proc = _launch("--arch", "olmo_1b", "--smoke")
    assert proc.returncode != 0
    assert "torch.cuda.is_available" in proc.stderr
