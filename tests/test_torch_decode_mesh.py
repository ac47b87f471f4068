"""Decode, ``greedy_decode`` and the ``Server`` over the model mesh, and the
SSM parts split over ``model``, against the reference's GSPMD decode.

The reference serves over a mesh by placing its cache as its dry run's
``decode_state_specs`` does and letting GSPMD split the step; the port
holds each rank's shard of that cache (``init_decode_state(..., sh=...)``)
and splits the step by hand: the KV heads over ``model`` where they
divide, else the cache's time axis with the ranks' partial softmaxes
combined, else the attention repeated; Mamba over its inner width, RWKV's
time mix over its heads and its channel mix over the hidden; the greedy
token from the vocabulary shards (``sharding.specs.TensorSplit`` states
the rule).  The port runs in one 4-rank gloo spawn per mesh shape, (1, 4)
and (2, 2) (``tests/_torch_decode_ranks.py``); the reference in one
subprocess with 4 forced CPU devices; all three at once, from the same
weights (``params_from_jax``), in float32.

Held, and how closely:
  * ``greedy_decode(sh)``'s tokens equal the reference's and the port's
    mesh-free ones, and every step's logits (``make_serve_step(cfg, sh)``,
    the shards joined) lie within 1e-4 relative of both, for the cases of
    ``_torch_decode_ranks.CASES`` (heads split, time split with and
    without the heads, attention repeated, a rolling window that wraps
    across ranks beside Mamba, RWKV, MoE under ``ep``, whisper's memory
    split by heads and in time);
  * a ``Server`` over (2, 2), six requests of mixed lengths at batch 4:
    ``done`` equal on every rank and to the reference's and the mesh-free
    port's;
  * each rank's state leaves have the local shapes of
    ``decode_state_specs`` on its mesh, and that spec tree equals the
    reference's;
  * ``train(mesh=(1, 4))`` of hymba-1.5b's and rwkv6-3b's smoke configs
    (with the SSM parts split), 2 steps: losses and parameters within 1e-4
    relative of the reference's GSPMD ``train``;
  * one rank's gathered SSM leaves are 1/M of the whole (``tm`` whole),
    ``in_proj``'s the rank's columns of x and of z;
  * the dry run's decode cell on a (2, 2) shape mesh: its collective bytes
    by kind equal a real rank's step's (``comm.STATS``), its flops the
    rank's under ``FlopCounterMode``;
  * ``comm.vocab_argmax`` takes ties to the lowest index and leaves the
    pad columns out; ``comm.softmax_combine`` equals the softmax over every
    key with ranks that hold none;
  * chip_smoke.py phase 8 (f)'s rank function, rehearsed at the smoke
    sizes.
"""

import os
import subprocess
import sys
import tempfile
import textwrap

import jax
import numpy as np
import pytest

import _torch_decode_ranks as DR
import repro.configs as RC
from repro.launch import dryrun_lib as RD
from repro.models import model as RM
from repro.sharding import specs as RS
from repro_torch.configs import ShapeCell
from repro_torch.launch import dryrun_lib as D
from repro_torch.launch.mesh import run_on_mesh
from repro_torch.models import model as TM
from repro_torch.sharding import specs as TS
from repro_torch.sharding.specs import TensorSplit
from test_torch_mesh import _FakeMesh, _bits, _close, _flat, _ref_tree, _trees_close

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")
KEY = jax.random.PRNGKey(0)
TIMEOUT = 300
RTOL = 1e-4

REF_CODE = """
import sys
sys.path.insert(0, {tests!r})
import numpy as np, jax, jax.numpy as jnp
import _torch_decode_ranks as DR, _torch_mesh_ranks as R, _torch_tp_ranks as TP
import repro.configs as C
from repro.etl.batcher import make_token_batch
from repro.launch.mesh import make_local_mesh
from repro.models import model as M
from repro.serve.decode import Server, ServeConfig, greedy_decode, make_serve_step
from repro.sharding.specs import make_policy
from repro.train.loop import TrainConfig, train
from repro.train.optimizer import AdamWConfig

# greedy_decode jits its own serve step: the same program as the step loop's
# below, compiled once through the compilation cache
jax.config.update("jax_compilation_cache_dir", {cache!r})
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
out = {{}}
for name, arch, kw, cache_len, shapes in DR.CASES:
    cfg = C.get_smoke(arch).replace(**R.F32, **kw)
    params = M.init_params(cfg, jax.random.PRNGKey(0))
    prompt = jnp.asarray(DR.prompt(cfg))
    extras = {{"frames": jnp.asarray(DR.frames(cfg))}} if cfg.enc_dec else None
    for shape in shapes:
        tag = f"{{name}}/{{shape[0]}}x{{shape[1]}}"
        sh = make_policy(make_local_mesh(*shape))
        out[tag + "/greedy"] = np.asarray(greedy_decode(
            params, cfg, prompt, max_new=DR.MAX_NEW, cache_len=cache_len, sh=sh, extras=extras))
        state = M.init_decode_state(cfg, DR.BATCH, cache_len)
        if cfg.enc_dec:
            state = M.prefill_memory(params, cfg, extras["frames"], state, sh)
        step = jax.jit(make_serve_step(cfg, sh))
        logits, tok = [], prompt[:, 0]
        for t in range(1, DR.PROMPT + DR.MAX_NEW):
            nxt, lg, state = step(params, state, tok)
            logits.append(np.asarray(lg))
            tok = prompt[:, t] if t < DR.PROMPT else nxt
        out[tag + "/logits"] = np.stack(logits)
cfg = C.get_smoke("olmo_1b").replace(**R.F32)
server = Server(M.init_params(cfg, jax.random.PRNGKey(0)), cfg, ServeConfig(**DR.SERVE),
                make_policy(make_local_mesh(2, 2)))
for p in DR.serve_prompts(cfg.vocab):
    server.submit(p)
server.run(n_steps=200)
for rid, toks in server.done.items():
    out[f"serve/{{rid}}"] = np.asarray(toks)
for name, arch, kw in DR.SSM_TRAIN:
    cfg = C.get_smoke(arch).replace(**R.F32, **kw)
    res = train(cfg, TP.train_config(), mesh=make_local_mesh(1, 4),
                batch_fn=lambda s, c=cfg: R.weighted_batch(make_token_batch, c, s))
    out[name + "/losses"] = np.asarray([h["loss"] for h in res["history"]])
    for path, leaf in jax.tree_util.tree_flatten_with_path(res["params"])[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out["/".join([name + "/params", *keys])] = np.asarray(leaf, np.float32)
np.savez({path!r}, **out)
print("REF OK")
"""


def _init(cfg):
    return _bits(jax.tree_util.tree_map(np.asarray, RM.init_params(cfg, KEY)))


def _ref_cfg(name):
    _, arch, kw, _, _ = DR.case(name)
    return RC.get_smoke(arch).replace(**DR.R.F32, **kw)


@pytest.fixture(scope="module")
def runs():
    tmp = tempfile.mkdtemp(prefix="decode_mesh_")
    path = os.path.join(tmp, "ref.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    code = REF_CODE.format(tests=TESTS, path=path, cache=os.path.join(tmp, "xla"))
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    params = {name: _init(_ref_cfg(name)) for name, _, _, _, _ in DR.CASES}
    params.update({name: _init(RC.get_smoke(arch).replace(**DR.R.F32, **kw))
                   for name, arch, kw in DR.SSM_TRAIN})
    port = {(1, 4): run_on_mesh(DR.mesh_14, 1, 4, device="cpu", args=(params,),
                                timeout=TIMEOUT)[0],
            (2, 2): run_on_mesh(DR.mesh_22, 2, 2, device="cpu", args=(params,),
                                timeout=TIMEOUT)[0]}
    out, err = proc.communicate(timeout=TIMEOUT)
    assert proc.returncode == 0 and "REF OK" in out, out + err[-3000:]
    return {"port": port, "ref": np.load(path)}


DECODE_CASES = [(name, shape) for name, _, _, _, shapes in DR.CASES for shape in shapes]


@pytest.mark.parametrize("name,shape", DECODE_CASES,
                         ids=[f"{n}-{s[0]}x{s[1]}" for n, s in DECODE_CASES])
def test_decode_over_a_mesh_matches_the_reference(runs, name, shape):
    got = runs["port"][shape][name]
    tag = f"{name}/{shape[0]}x{shape[1]}"
    ref = runs["ref"]
    np.testing.assert_array_equal(got["greedy"], ref[tag + "/greedy"])
    np.testing.assert_array_equal(got["greedy"], got["free_greedy"])
    np.testing.assert_array_equal(got["steps"], got["greedy"])
    assert got["logits"].shape == ref[tag + "/logits"].shape
    _close(got["logits"], ref[tag + "/logits"], RTOL, what="logits vs the reference")
    _close(got["logits"], got["free_logits"], RTOL, what="logits vs mesh-free")


def test_server_over_a_mesh_matches_the_reference(runs):
    ranks = runs["port"][(2, 2)]["serve"]
    assert all(r == ranks[0] for r in ranks)
    ref = runs["ref"]
    want = {int(k.split("/")[1]): ref[k].tolist() for k in ref.files if k.startswith("serve/")}
    assert ranks[0] == want == runs["port"][(2, 2)]["serve_free"]
    assert len(want) == len(DR.SERVE_PROMPTS)


@pytest.mark.parametrize("name", [c[0] for c in DR.CASES])
def test_decode_state_is_placed_by_the_reference_specs(runs, name):
    _, _, _, cache_len, _ = DR.case(name)
    rcfg, tcfg = _ref_cfg(name), DR.case_cfg(name)
    ref_state = jax.eval_shape(lambda: RM.init_decode_state(rcfg, DR.BATCH, cache_len))
    whole = TM.init_decode_state(tcfg, DR.BATCH, cache_len, device="meta")
    for shape in ((1, 4), (2, 2)):
        mesh = _FakeMesh(shape)
        rsp, tsp = RS.make_policy(mesh), TS.make_policy(mesh)
        rspecs = RD.decode_state_specs(rcfg, rsp, ref_state)
        tspecs = TS.decode_state_specs(tcfg, tsp, whole)
        flat_r = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s)
                  for path, s in jax.tree_util.tree_flatten_with_path(
                      rspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
        flat_t = {k: tuple(v) for k, v in _spec_paths(tspecs).items()}
        assert flat_t == flat_r, shape
        want = {k: TS.local_shape(t.shape, _spec_paths(tspecs)[k], tsp)
                for k, t in DR.flat_state(whole).items()}
        for ranks in (runs["port"][shape]["state_shapes"],):
            assert all(r[name] == want for r in ranks), (shape, ranks[0][name], want)


def _spec_paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_spec_paths(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("name", [n for n, _, _ in DR.SSM_TRAIN])
def test_ssm_train_on_a_mesh_matches_the_reference(runs, name):
    losses, params = runs["port"][(1, 4)][name]
    ref = runs["ref"]
    _close(losses, ref[f"{name}/losses"], what="losses")
    _trees_close(_flat(params), _ref_tree(ref, f"{name}/params"))


@pytest.mark.parametrize("name", [n for n, _, _ in DR.SSM_TRAIN])
def test_a_ranks_gathered_ssm_leaves_are_its_slices(runs, name):
    M = 4
    for rank in runs["port"][(1, 4)]["ssm_leaves"]:
        shapes, err = rank[name]
        for leaf, (got, whole) in shapes.items():
            block, k = leaf.split("/")
            if block == "tm":  # the time mix's projections stay whole (FSDP-only specs)
                assert got == whole, leaf
            elif block == "mamba" and k in ("conv_w", "dt_proj", "in_proj"):
                assert got == (whole[0], whole[1] // M), leaf
            elif block == "mamba" or (block == "cm" and k == "wv"):
                assert got == (whole[0] // M, *whole[1:]), leaf
            elif block == "cm" and k == "wk":
                assert got == (whole[0], whole[1] // M), leaf
            else:  # the channel mix's gate and shifts
                assert got == whole, leaf
        assert err in (None, 0.0), err


@pytest.mark.parametrize("name", DR.DRY_CASES)
def test_dry_run_decode_counts_a_real_step(runs, name):
    """The dry run's decode cell on a (2, 2) shape mesh against one real
    ``make_serve_step(cfg, sh)`` step of rank 0 on gloo: the collective
    bytes by kind equal ``comm.STATS``'s, the flops ``FlopCounterMode``'s."""
    _, _, _, cache_len, _ = DR.case(name)
    got_bytes, got_flops = runs["port"][(2, 2)]["dry"][name]
    want = D.trace_cell(DR.case_cfg(name), ShapeCell("d", cache_len, DR.BATCH, "decode"),
                        D.ShapeMesh(2, 2))
    assert got_bytes == want["collectives"]
    assert got_bytes["all-gather"] > 0 and got_bytes["all-reduce"] > 0
    assert got_flops == want["cost"]["flops"], (got_flops, want["cost"]["flops"])


def test_vocab_argmax_takes_the_lowest_index_of_a_tie(runs):
    x = DR.argmax_logits()
    want = np.argmax(x[:, :4 * DR.ARGMAX_COLS - 2], axis=-1).tolist()
    assert want == [9, 19, int(np.argmax(x[2, :30]))]
    assert all(r == want for r in runs["port"][(1, 4)]["argmax"])


def test_softmax_combine_equals_the_softmax_over_every_key(runs):
    s, v = DR.combine_inputs()
    p = np.exp(s - s.max(-1, keepdims=True))
    want = (p / p.sum(-1, keepdims=True)) @ v
    for got in runs["port"][(1, 4)]["combine"]:
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kv,length,m,want", [
    (True, 16, 4, "heads"), (False, 16, 4, "time"), (False, 18, 4, "whole"),
    (False, 2, 4, "whole"), (False, 32768, 16, "time"), (False, 1500, 16, "whole")])
def test_kv_cache_split_rule(kv, length, m, want):
    ts = TensorSplit(size=m, rank=0, heads=kv, kv=kv, ff=True, vocab=True)
    assert ts.kv_cache(length) == want


def test_chip_smoke_phase_8f_rehearsed_on_the_cpu(runs):
    ranks = runs["port"][(1, 4)]["phase8f"]
    assert [r["coordinate"] for r in ranks] == [[0, m] for m in range(4)]
    lead = ranks[0]
    assert lead["bf16"]["prefill"]["flash_launches_checked"] == 2  # plain on the CPU: 0 launches
    assert lead["bf16"]["prefill"]["flash_attention_launches"] == 0
    assert lead["bf16"]["server"]["requests"] == 16
    gates = lead["gates"]
    assert sorted(gates) == ["hymba-1.5b", "olmo-1b", "rwkv6-3b"]
    for r in gates.values():
        assert r["tokens_equal"] and r["server_equal"]
        assert r["max_rel_err"] <= 1e-4
    assert gates["hymba-1.5b"]["split"]["mamba"] and gates["rwkv6-3b"]["split"]["wkv"]
