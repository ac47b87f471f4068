"""The port's model mesh against the reference's.

The port (``repro_torch.sharding``, ``launch.mesh``, ``train.loop``'s mesh
paths, ``train.optimizer.compress_grads_int8``, ``models.moe``'s expert
parallelism, ``train.checkpoint`` / ``train.elastic`` over a mesh) runs in
4-rank gloo spawns on the CPU, one a mesh shape ((2, 2), then (4, 1)),
every case inside it (``tests/_torch_mesh_ranks.py``).  The reference runs
in one subprocess with 4 forced CPU devices, on the same mesh shapes (the
int8 result depends on the shard count), and writes every output to an
npz.  Weights are the reference's (``params_from_jax``); inputs are made
from seeds with numpy.  Both run at once.

Tolerances:
  * spec trees, ``shard_assignment``, ``StragglerWatchdog``: equal;
  * ``compress_grads_int8``: bit for bit (the same float32 operations in
    the same order; the sums and maxima are exact);
  * DP step, ``train(mesh=...)``: losses and parameters within 1e-4
    relative (``|a - b| <= 1e-4 * (1 + |b|)``): the sums over the data
    ranks and over the sequence run in another order than XLA's;
  * compressed DP: losses within 1e-4 relative of the reference's
    compressed run, and within 0.1 of the port's float32 run (the
    reference's gate, tests/test_distributed.py).  Its parameters are held
    to 1e-4 except where the int8 rounding went the other way: the local
    gradients differ from the reference's by float32 noise, so a ``total /
    gscale`` within that noise of a half step rounds to the neighbouring
    step, the element's mean gradient moves by one quantization step, and
    AdamW (which normalises each element) can move that element by up to
    about one learning rate a step either way.  Such elements are held to
    ``2 * lr`` a step (``INT8_FLIP``), and at most ``INT8_FLIP_SHARE`` of
    the elements may need it (1.4% did on the CPU);
  * EP: output within atol/rtol 3e-2 of the reference's EP and of the
    port's ``dmm`` (the reference's gate, in bfloat16); aux within 1e-6
    of the reference's, which is shard (0, 0)'s;
  * checkpoints: every restored leaf bit for bit, files byte for byte;
  * the collectives of one ``train(mesh=(2, 2))`` step: their bytes by
    kind (``comm.STATS``) equal the dry run's count for that step.
"""

import filecmp
import json
import os
import subprocess
import sys
import tempfile
import textwrap
import threading

import jax
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as R
import repro.configs as RC
from repro.models import model as RM
from repro.models import moe as RMOE
from repro.sharding import specs as RS
from repro.train import checkpoint as RCK
from repro.train import elastic as RE
from repro.train import optimizer as ROPT
import repro_torch.configs as TC
from repro_torch.core.convert import params_from_jax
from repro_torch.launch.mesh import run_on_mesh
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.sharding import specs as TS
from repro_torch.train import checkpoint as TCK
from repro_torch.train import elastic as TE
from repro_torch.train import loop as TLOOP
from repro_torch.train import optimizer as TOPT

REPO = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(REPO, "src")
TESTS = os.path.dirname(os.path.abspath(__file__))
KEY = jax.random.PRNGKey(0)
LAUNCH_STEPS = 2
SPAWN_TIMEOUT = 240
INT8_FLIP = 2 * R.DP_STEPS * TOPT.AdamWConfig().lr  # see the module docstring
INT8_FLIP_SHARE = 0.05

# the reference's side, in one subprocess with 4 CPU devices
REF_CODE = """
import sys
sys.path.insert(0, {tests!r})
import numpy as np, jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
import _torch_mesh_ranks as R
import repro.configs as C
from repro.etl.batcher import make_token_batch
from repro.launch.mesh import make_local_mesh
from repro.models import model as M, moe as MOE
from repro.sharding.specs import make_policy
from repro.train.loop import TrainConfig, make_dp_train_step, train
from repro.train.optimizer import AdamWConfig, adamw_init, compress_grads_int8

out = {{}}
def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out["/".join([prefix, *keys])] = np.asarray(leaf, np.float32)

# compress_grads_int8 on (4, 1)
m41 = make_local_mesh(4, 1)
grads, efs, dts = R.grad_shards(4)
g = {{f"g{{i}}": jnp.asarray(a).astype(dt) for i, (a, dt) in enumerate(zip(grads, dts))}}
e = {{f"g{{i}}": jnp.asarray(a) for i, a in enumerate(efs)}}
def body(g, e):
    m, ef = compress_grads_int8({{k: v[0] for k, v in g.items()}}, {{k: v[0] for k, v in e.items()}},
                                ("data",))
    return m, {{k: v[None] for k, v in ef.items()}}
spec = {{k: P("data") for k in g}}
mean, ef = jax.jit(shard_map(body, mesh=m41, in_specs=(spec, spec),
                             out_specs=({{k: P() for k in g}}, spec), check_rep=False))(g, e)
put("compress/mean", mean)
put("compress/ef", ef)

# the DP step on (4, 1): one float32 step, 4 compressed steps
cfg = C.get_smoke("olmo_1b").replace(**R.configs("olmo_1b"))
params = M.init_params(cfg, jax.random.PRNGKey(0))
for name, compress, steps in (("dp1", False, 1), ("dp_int8", True, R.DP_STEPS)):
    tc = TrainConfig(batch=R.BATCH, seq=R.SEQ, opt=AdamWConfig(warmup_steps=1, compress_grads=compress))
    p, o = params, adamw_init(params, tc.opt)
    step = make_dp_train_step(cfg, tc, m41)
    losses = []
    with m41:
        for s in range(steps):
            b = {{k: jnp.asarray(v) for k, v in R.weighted_batch(make_token_batch, cfg, s).items()}}
            p, o, m = step(p, o, b)
            losses.append(float(m["loss"]))
    out[name + "/losses"] = np.asarray(losses)
    put(name + "/params", p)

# expert parallelism on (2, 2), bfloat16 as the reference's gate
m22 = make_local_mesh(2, 2)
ecfg = C.get_smoke("qwen3_moe_30b_a3b").replace(**R.configs("qwen3_moe_30b_a3b", "ep", "bf16"))
mp = MOE.moe_params(jax.random.PRNGKey(0), ecfg)
x = jnp.asarray(R.ep_input()).astype(ecfg.cdtype)
with m22:
    o_ep, aux = jax.jit(lambda p, x: MOE.moe_apply(p, x, ecfg, sh=make_policy(m22)))(mp, x)
out["ep/out"] = np.asarray(o_ep, np.float32)
out["ep/aux"] = np.asarray(aux, np.float32)

# mesh-free train over the weighted batches
for name, arch, impl in (("train_olmo", "olmo_1b", None), ("train_moe", "qwen3_moe_30b_a3b", "dmm")):
    c = C.get_smoke(arch).replace(**R.configs(arch, impl))
    tc = TrainConfig(steps=R.TRAIN_STEPS, batch=R.BATCH, seq=R.SEQ, log_every=1,
                     opt=AdamWConfig(warmup_steps=1))
    res = train(c, tc, batch_fn=lambda s, c=c: R.weighted_batch(make_token_batch, c, s))
    out[name + "/losses"] = np.asarray([h["loss"] for h in res["history"]])
    put(name + "/params", res["params"])
np.savez({path!r}, **out)
print("REF OK")
"""


def _bits(tree):
    """Nested dicts of numpy arrays with bfloat16 as its uint16 view (what
    pickles to the spawned ranks without ml_dtypes)."""
    if isinstance(tree, dict):
        return {k: _bits(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _flat(tree, prefix=""):
    """{'/'-joined path: float32 array} of a reference-layout tree (uint16
    leaves read as bfloat16 bits)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    a = np.asarray(tree)
    if a.dtype == np.uint16:
        a = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).float().numpy()
    return {prefix: a.astype(np.float32)}


def _ref_tree(ref, prefix):
    n = len(prefix) + 1
    return {k[n:]: ref[k] for k in ref.files if k.startswith(prefix + "/")}


def _close(got, want, rtol=1e-4, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want) - rtol * (1 + np.abs(want))
    assert np.all(err <= 0), (what, float(np.max(np.abs(got - want))))


def _trees_close(got_flat, want_flat, rtol=1e-4):
    assert sorted(got_flat) == sorted(want_flat)
    for k in want_flat:
        _close(got_flat[k], want_flat[k], rtol, what=k)


def _int8_params_close(got_flat, want_flat):
    """The compressed run's parameters (see the module docstring)."""
    assert sorted(got_flat) == sorted(want_flat)
    flipped = total = 0
    for k, want in want_flat.items():
        d = np.abs(got_flat[k].astype(np.float64) - want)
        assert np.all(d <= INT8_FLIP), (k, float(d.max()))
        flipped += int(np.sum(d > 1e-4 * (1 + np.abs(want))))
        total += d.size
    assert flipped <= INT8_FLIP_SHARE * total, (flipped, total)


def _ref_params():
    olmo = RC.get_smoke("olmo_1b").replace(**R.configs("olmo_1b"))
    qwen = RC.get_smoke("qwen3_moe_30b_a3b").replace(**R.configs("qwen3_moe_30b_a3b", "dmm"))
    ecfg = RC.get_smoke("qwen3_moe_30b_a3b").replace(**R.configs("qwen3_moe_30b_a3b", "ep",
                                                                 "bf16"))
    np_tree = lambda t: _bits(jax.tree_util.tree_map(np.asarray, t))  # noqa: E731
    return {"olmo": np_tree(RM.init_params(olmo, KEY)), "qwen3": np_tree(RM.init_params(qwen, KEY)),
            "moe": np_tree(RMOE.moe_params(KEY, ecfg))}


def _launcher(extra, tmp):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "olmo_1b", "--smoke",
         "--steps", str(LAUNCH_STEPS), "--device", "cpu", "--mesh", "2x2", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=tmp)


def _port_runs(device, params, base):
    p22 = run_on_mesh(R.mesh_22, 2, 2, device=device, args=(device, params, base, LAUNCH_STEPS),
                      timeout=SPAWN_TIMEOUT)[0]
    p41 = run_on_mesh(R.mesh_41, 4, 1, device=device, args=(device, params, base),
                      timeout=SPAWN_TIMEOUT)[0]
    return p22, p41


@pytest.fixture(scope="module")
def shared():
    """The reference's weights, and its subprocess, started here and
    waited for by :func:`_ref` (so it runs while the port's spawns do)."""
    tmp = tempfile.mkdtemp(prefix="mesh_")
    ref_path = os.path.join(tmp, "ref.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF_CODE.format(tests=TESTS, path=ref_path))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    return {"tmp": tmp, "params": _ref_params(), "proc": proc, "path": ref_path}


def _ref(shared):
    if "ref" not in shared:
        out, err = shared["proc"].communicate(timeout=SPAWN_TIMEOUT)
        assert shared["proc"].returncode == 0 and "REF OK" in out, out + err[-3000:]
        shared["ref"] = np.load(shared["path"])
    return shared["ref"]


@pytest.fixture(scope="module")
def runs(shared):
    """Everything of the CPU cases, run once: the two launcher runs in the
    background (beside the reference's subprocess) while the port's two
    spawns run here."""
    tmp, params = shared["tmp"], shared["params"]
    launchers = {name: _launcher(extra, tmp) for name, extra in
                 (("mesh", []), ("compress", ["--compress-grads"]))}
    rehearsal = {}
    thread = threading.Thread(target=_rehearse, args=(os.path.join(tmp, "phase8"), rehearsal))
    thread.start()
    base = os.path.join(tmp, "ckpt")
    p22, p41 = _port_runs("cpu", params, base)
    thread.join()
    launched = {}
    for name, proc in launchers.items():
        o, e = proc.communicate(timeout=SPAWN_TIMEOUT)
        launched[name] = (proc.returncode, o, e)
    return {"ref": _ref(shared), "p22": p22, "p41": p41, "params": params, "base": base,
            "launched": launched, "tmp": tmp, "phase8": rehearsal}


def _rehearse(base, out):
    """chip_smoke.py phase 8's rank function on a (2, 2) gloo mesh at the
    smoke sizes (run beside the other spawns; its test reads ``out``)."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke

    try:
        out["ranks"] = run_on_mesh(chip_smoke.mesh_rank, 2, 2, device="cpu", args=(True, base),
                                   timeout=SPAWN_TIMEOUT)
    except Exception as err:  # re-raised by the test that reads it
        out["error"] = err


# ---------------------------------------------------------------------------
# spec trees, in process
# ---------------------------------------------------------------------------


class _FakeMesh:
    """A mesh stand-in with the reference's ``shape`` dict and axis names."""

    def __init__(self, shape):
        names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
        self.shape = dict(zip(names, shape))
        self.axis_names = names


MESHES = [(16, 16), (4, 2), (2, 4), (8, 1), (2, 16, 16)]


def _port_shapes(ref_shapes):
    """The port's layout of a reference shape tree: each stacked layer
    list as one dict per layer, the leading L dim dropped."""
    def unstack(node, i):
        if isinstance(node, dict):
            return {k: unstack(v, i) for k, v in node.items()}
        return jax.ShapeDtypeStruct(node.shape[1:], node.dtype)

    out = {}
    for k, v in ref_shapes.items():
        if k in ("layers", "enc_layers"):
            n = jax.tree_util.tree_leaves(v)[0].shape[0]
            out[k] = [unstack(v, i) for i in range(n)]
        else:
            out[k] = v
    return out


def _assert_specs_equal(port, ref, stacked=False):
    if isinstance(ref, dict):
        assert list(port) == list(ref) or sorted(port) == sorted(ref)
        for k in ref:
            if k in ("layers", "enc_layers"):
                for lp in port[k]:
                    _assert_specs_equal(lp, ref[k], stacked=True)
            else:
                _assert_specs_equal(port[k], ref[k], stacked)
        return
    want = tuple(ref)
    if stacked:
        assert want[0] is None
        want = want[1:]
    assert tuple(port) == want, (port, ref)


@pytest.mark.parametrize("arch", RC.ARCHS)
def test_param_spec_tree_equals_the_reference(arch):
    """Smoke shapes (the port's own init tree) and full shapes (from the
    reference's eval_shape) over five fake meshes, the pod mesh included."""
    for smoke in (True, False):
        rcfg = RC.get_smoke(arch) if smoke else RC.get(arch)
        ref_shapes = jax.eval_shape(lambda k: RM.init_params(rcfg, k), KEY)
        if smoke:
            port_tree = TM.init_params(TC.get_smoke(arch), 0, device="cpu")
        else:
            port_tree = _port_shapes(ref_shapes)
        for shape in MESHES:
            mesh = _FakeMesh(shape)
            rsp, tsp = RS.make_policy(mesh), TS.make_policy(mesh)
            assert tsp.data_axes == rsp.data_axes
            _assert_specs_equal(TS.param_spec_tree(port_tree, tsp),
                                RS.param_spec_tree(ref_shapes, rsp))


def test_spec_divisibility_guard_and_rwkv_fsdp_only():
    """tests/test_launch.py's spec cases on the port."""
    sp = TS.ShardingPolicy(mesh=_FakeMesh((16, 16)))
    assert sp.dim(2048, "model") == "model"
    assert sp.dim(25, "model") is None  # hymba heads
    assert sp.dim(8, "model") is None  # llama kv heads < 16
    assert sp.dim(2048, ("data",)) == ("data",)
    cfg = TC.get_smoke("llama3_405b").replace(d_model=256, d_ff=512, vocab=512)
    specs = TS.param_spec_tree(TM.init_params(cfg, 0, device="cpu"), sp)
    wq = specs["layers"][0]["attn"]["wq"]
    assert wq[0] in ("data", ("data",)) and wq[1] == "model"
    cfg_r = TC.get_smoke("rwkv6_3b").replace(d_model=256, d_ff=512, vocab=512)
    wr = TS.param_spec_tree(TM.init_params(cfg_r, 0, device="cpu"), sp)["layers"][0]["tm"]["wr"]
    assert wr[0] in ("data", ("data",)) and wr[1] is None
    # the activation constraints are identities in the port
    x = torch.ones(2, 3, 4)
    for f in (sp.act_btd, sp.act_ff, sp.act_heads, sp.act_expert_ff, sp.logits):
        assert f(x) is x
    assert sp.batch_spec(2) == TS.P("data", None) == ("data", None)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    class Named:
        mesh_dim_names = ("pod", "data", "model")

    assert TS.placements(TS.P(("pod", "data"), "model"), Named()) == [Shard(0), Shard(0),
                                                                      Shard(1)]
    assert TS.placements(TS.P(None, ("data",)), Named()) == [Replicate(), Shard(1), Replicate()]


def test_mesh_needs_a_group_and_enough_ranks():
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh

    with pytest.raises(ValueError, match="need 4 devices, have 1"):
        make_local_mesh(2, 2, device="cpu")
    with pytest.raises(ValueError, match=r"Number of devices 1 must be >= the product of "
                                         r"mesh_shape \(2, 16, 16\)"):
        make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_local_mesh(1, 1, device="cpu")


def test_shard_assignment_and_watchdog_match_the_reference():
    hosts = ["h3", "h0", "h2", "h1"]
    for step in range(6):
        for n in (0, 1, 5, 16):
            assert TE.shard_assignment(step, hosts, n) == RE.shard_assignment(step, hosts, n)
    rng = np.random.default_rng(0)
    tw, rw = TE.StragglerWatchdog(factor=2.5, window=8), RE.StragglerWatchdog(factor=2.5, window=8)
    for i in range(40):
        host, d = f"h{i % 4}", float(rng.exponential(1.0))
        tw.report(host, d)
        rw.report(host, d)
        assert tw.deadline() == rw.deadline()
        inflight = {h: 100.0 - 3 * k for k, h in enumerate(hosts)}
        assert tw.stragglers(inflight, now=104.0) == rw.stragglers(inflight, now=104.0)
    assert tw.reassign(3, "h1", hosts, 7) == rw.reassign(3, "h1", hosts, 7)


# ---------------------------------------------------------------------------
# the mesh runs
# ---------------------------------------------------------------------------


def test_compress_grads_int8_equals_the_reference_bit_for_bit(runs):
    ref = runs["ref"]
    mean, efs = runs["p41"]["compress"]
    for k, v in mean.items():
        np.testing.assert_array_equal(v, ref[f"compress/mean/{k}"])
        for r in range(4):
            np.testing.assert_array_equal(efs[r][k], ref[f"compress/ef/{k}"][r])


@pytest.mark.parametrize("name", ["dp1", "dp_int8"])
def test_dp_step_matches_the_reference(runs, name):
    """The float32 DP step (1 step) and the compressed run (4 steps) on
    (4, 1): losses and parameters within 1e-4 (the compressed run's
    parameters as the module docstring says).  The loss is the mean of
    the local losses (the batch weights its halves unevenly, so it is not
    the global weighted mean)."""
    ref = runs["ref"]
    losses, params = runs["p41"]["dp"][name]
    _close(losses, ref[f"{name}/losses"], what="losses")
    close = _int8_params_close if name == "dp_int8" else _trees_close
    close(_flat(params), _ref_tree(ref, f"{name}/params"))


def test_pod_axes_fold_into_data_parallelism(runs):
    """A (2, 2, 1) ("pod", "data", "model") mesh over the same four ranks:
    the DP step over ("pod", "data") equals the reference's (4, 1) DP step
    (the same four shards, pod-major), and the sharded step the port's
    mesh-free step, within 1e-4."""
    pod = runs["p41"]["pod"]
    assert pod["data_axes"] == ("pod", "data")
    loss, params = pod["dp"]
    _close([loss], runs["ref"]["dp1/losses"], what="dp loss")
    _trees_close(_flat(params), _ref_tree(runs["ref"], "dp1/params"))
    cfg = TC.get_smoke("olmo_1b").replace(**R.configs("olmo_1b"))
    tc = TLOOP.TrainConfig(batch=R.BATCH, seq=R.SEQ, opt=TOPT.AdamWConfig(warmup_steps=1))
    from repro_torch.core.convert import params_to_jax
    from repro_torch.etl.batcher import make_token_batch

    p = params_from_jax(runs["params"]["olmo"], device="cpu")
    b = {k: torch.as_tensor(v) for k, v in R.weighted_batch(make_token_batch, cfg, 0).items()}
    want_p, _, m = TLOOP.make_train_step(cfg, tc)(p, TOPT.adamw_init(p, tc.opt), b)
    loss, params = pod["sharded"]
    _close([loss], [float(m["loss"])], what="sharded loss")
    _trees_close(_flat(params), _flat(params_to_jax(want_p)))


def test_compressed_dp_tracks_float32(runs):
    f32, _ = runs["p41"]["dp"]["dp_f32"]
    int8, _ = runs["p41"]["dp"]["dp_int8"]
    assert len(f32) == len(int8) == R.DP_STEPS
    assert all(abs(a - b) < 0.1 for a, b in zip(f32, int8)), (f32, int8)


def test_expert_parallel_moe_matches_the_reference_and_dmm(runs):
    ref = runs["ref"]
    out, aux = runs["p22"]["ep"]
    np.testing.assert_allclose(out, ref["ep/out"], atol=3e-2, rtol=3e-2)
    assert abs(aux - float(ref["ep/aux"])) <= 1e-6 * abs(float(ref["ep/aux"]))
    cfg = TC.get_smoke("qwen3_moe_30b_a3b").replace(**R.configs("qwen3_moe_30b_a3b", "dmm",
                                                                "bf16"))
    p = params_from_jax({"moe": runs["params"]["moe"]}, device="cpu")["moe"]
    x = torch.as_tensor(R.ep_input()).to(cfg.cdtype)
    dmm, _ = TMOE.moe_apply(p, x, cfg)
    np.testing.assert_allclose(out, dmm.float().numpy(), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("name,arch,impl", [("train_olmo", "olmo_1b", None),
                                            ("train_moe", "qwen3_moe_30b_a3b", "dmm")])
def test_train_over_a_mesh_matches_mesh_free_training(runs, name, arch, impl):
    """train(mesh=(2, 2)), 3 steps over batches whose two data halves are
    weighted unevenly, against the reference's and the port's mesh-free
    train: losses and parameters within 1e-4.  A gradient counted
    model-size times or a mean of the halves' weighted means would miss."""
    ref = runs["ref"]
    losses, params = runs["p22"][name]
    _close(losses, ref[f"{name}/losses"], what="losses vs reference")
    _trees_close(_flat(params), _ref_tree(ref, f"{name}/params"))
    cfg = TC.get_smoke(arch).replace(**R.configs(arch, impl))
    tc = TLOOP.TrainConfig(steps=R.TRAIN_STEPS, batch=R.BATCH, seq=R.SEQ, log_every=1,
                           opt=TOPT.AdamWConfig(warmup_steps=1))
    key = "olmo" if arch == "olmo_1b" else "qwen3"
    from repro_torch.etl.batcher import make_token_batch

    want = TLOOP.train(cfg, tc, device="cpu", params=params_from_jax(runs["params"][key],
                                                                     device="cpu"),
                       batch_fn=lambda s: R.weighted_batch(make_token_batch, cfg, s))
    _close(losses, [m["loss"] for m in want["history"]], what="losses vs port")
    from repro_torch.core.convert import params_to_jax

    _trees_close(_flat(params), _flat(params_to_jax(want["params"])))


@pytest.mark.parametrize("arch,impl", R.COLLECTIVE_CASES)
def test_dry_run_counts_the_collectives_of_a_real_step(runs, arch, impl):
    """The dry run's collective bytes by kind for one train step on a (2,
    2) shape mesh (``launch.dryrun_lib``, nothing issued) equal what
    ``comm.STATS`` recorded over one real ``train(mesh=(2, 2))`` step of
    the same config and batch on gloo."""
    from repro_torch.configs import ShapeCell
    from repro_torch.launch import dryrun_lib as D

    got = runs["p22"]["collectives"][f"{arch}/{impl}"]
    cfg = TC.get_smoke(arch).replace(**R.configs(arch, impl))
    tc = TLOOP.TrainConfig(steps=1, batch=R.BATCH, seq=R.SEQ, log_every=1,
                           opt=TOPT.AdamWConfig(warmup_steps=1))
    want = D.trace_cell(cfg, ShapeCell("mesh", R.SEQ, R.BATCH, "train"), D.ShapeMesh(2, 2),
                        tc)["collectives"]
    assert got == want
    assert got["all-gather"] > 0 and got["reduce-scatter"] > 0
    assert ("all-to-all" in got) == (impl == "ep")


def test_microbatched_step_over_a_mesh_matches_mesh_free(runs):
    """make_train_step with n_micro=2 on (2, 2) (the whole batch's
    microbatches, each split over the data ranks) against the port's
    mesh-free step: loss and parameters within 1e-4."""
    loss, params = runs["p22"]["micro"]
    cfg = TC.get_smoke("olmo_1b").replace(**R.configs("olmo_1b"))
    tc = TLOOP.TrainConfig(batch=R.BATCH, seq=R.SEQ, n_micro=2,
                           opt=TOPT.AdamWConfig(warmup_steps=1))
    from repro_torch.core.convert import params_to_jax
    from repro_torch.etl.batcher import make_token_batch

    p = params_from_jax(runs["params"]["olmo"], device="cpu")
    b = {k: torch.as_tensor(v) for k, v in R.weighted_batch(make_token_batch, cfg, 0).items()}
    want_p, _, m = TLOOP.make_train_step(cfg, tc)(p, TOPT.adamw_init(p, tc.opt), b)
    _close([loss], [float(m["loss"])], what="loss")
    _trees_close(_flat(params), _flat(params_to_jax(want_p)))


def test_checkpoint_saved_on_a_mesh_restores_on_other_meshes_bit_for_bit(runs):
    """Saved on (2, 2), resharded onto (1, 1) and (4, 1): every leaf bit
    for bit, meta kept, the (4, 1) leaves placed by its specs."""
    meta, want, got11 = runs["p22"]["elastic"]
    assert meta == {"step": R.CKPT_STEP}
    for w, g in zip(want, got11):
        wf, gf = _flat(w), _flat(g)
        assert sorted(wf) == sorted(gf)
        for k in wf:
            np.testing.assert_array_equal(gf[k], wf[k], err_msg=k)
    meta41, got41, placed = runs["p41"]["elastic"]
    assert meta41 == {"step": R.CKPT_STEP}
    assert "Shard(dim=0)" in placed
    for w, g in zip(want, got41):
        wf, gf = _flat(w), _flat(g)
        for k in wf:
            np.testing.assert_array_equal(gf[k], wf[k], err_msg=k)


def _files(base):
    root = os.path.join(base, f"step_{R.CKPT_STEP:07d}")
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_checkpoint_files_equal_a_mesh_free_save_and_the_reference(runs, tmp_path):
    base = runs["base"]
    jp = jax.tree_util.tree_map(jax.numpy.asarray, RM.init_params(
        RC.get_smoke("olmo_1b").replace(**R.configs("olmo_1b")), KEY))
    RCK.save(str(tmp_path / "ref"), R.CKPT_STEP, jp, ROPT.adamw_init(jp, ROPT.AdamWConfig()),
             {"step": R.CKPT_STEP})
    tp = params_from_jax(runs["params"]["olmo"], device="cpu")
    TCK.save(str(tmp_path / "plain"), R.CKPT_STEP, tp, TOPT.adamw_init(tp, TOPT.AdamWConfig()),
             {"step": R.CKPT_STEP})
    names = _files(base)
    assert names == _files(str(tmp_path / "ref")) == _files(str(tmp_path / "plain"))
    assert len(names) > 10
    for other in ("ref", "plain"):
        root = os.path.join(str(tmp_path / other), f"step_{R.CKPT_STEP:07d}")
        mine = os.path.join(base, f"step_{R.CKPT_STEP:07d}")
        _, mismatch, errors = filecmp.cmpfiles(mine, root, names, shallow=False)
        assert not mismatch and not errors, (other, mismatch, errors)
    assert os.path.exists(os.path.join(base, f"step_{R.CKPT_STEP:07d}.OK"))
    with open(os.path.join(base, f"step_{R.CKPT_STEP:07d}", "meta.json")) as f:
        assert json.load(f) == {"step": R.CKPT_STEP}


@pytest.mark.parametrize("name,index", [("mesh", 0), ("compress", 1)])
def test_launcher_trains_over_a_mesh(runs, name, index):
    """``launch.train --smoke --mesh 2x2 --device cpu`` (and with
    ``--compress-grads``) exits 0 and prints the final loss of
    ``train(mesh=...)`` (``dp=True`` with the int8 all-reduce)."""
    rc, out, err = runs["launched"][name]
    assert rc == 0, out + err[-3000:]
    lines = out.splitlines()
    assert lines[0].startswith("step     0  loss"), out
    assert lines[-1] == f"final loss: {runs['p22']['launcher'][index]:.4f}", out
    assert sum(line.startswith("step ") for line in lines) == LAUNCH_STEPS  # rank 0 alone


# ---------------------------------------------------------------------------
# over several cards: the same cases over NCCL
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cards(shared):
    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs 4 CUDA devices, this host has {torch.cuda.device_count()}")
    base = os.path.join(shared["tmp"], "ckpt_cards")
    p22, p41 = _port_runs("cuda", shared["params"], base)
    return {"p22": p22, "p41": p41, "ref": _ref(shared)}


@pytest.mark.gpu
def test_dp_steps_over_several_cards_match_the_reference(cards):
    ref = cards["ref"]
    for name in ("dp1", "dp_int8"):
        losses, params = cards["p41"]["dp"][name]
        _close(losses, ref[f"{name}/losses"], what=name)
        close = _int8_params_close if name == "dp_int8" else _trees_close
        close(_flat(params), _ref_tree(ref, f"{name}/params"))
    f32, _ = cards["p41"]["dp"]["dp_f32"]
    int8, _ = cards["p41"]["dp"]["dp_int8"]
    assert all(abs(a - b) < 0.1 for a, b in zip(f32, int8))
    mean, efs = cards["p41"]["compress"]
    for k, v in mean.items():
        np.testing.assert_array_equal(v, ref[f"compress/mean/{k}"])


@pytest.mark.gpu
def test_expert_parallel_over_several_cards_matches_the_reference(cards):
    out, aux = cards["p22"]["ep"]
    np.testing.assert_allclose(out, cards["ref"]["ep/out"], atol=3e-2, rtol=3e-2)
    assert abs(aux - float(cards["ref"]["ep/aux"])) <= 1e-6 * abs(float(cards["ref"]["ep/aux"]))


@pytest.mark.gpu
def test_train_over_several_cards_matches_the_reference(cards):
    for name in ("train_olmo", "train_moe"):
        losses, params = cards["p22"][name]
        _close(losses, cards["ref"][f"{name}/losses"], what=name)
        _trees_close(_flat(params), _ref_tree(cards["ref"], f"{name}/params"))


@pytest.mark.gpu
def test_elastic_restore_over_several_cards_is_bit_for_bit(cards):
    meta, want, got11 = cards["p22"]["elastic"]
    meta41, got41, _ = cards["p41"]["elastic"]
    assert meta == meta41 == {"step": R.CKPT_STEP}
    for got in (got11, got41):
        for w, g in zip(want, got):
            wf, gf = _flat(w), _flat(g)
            for k in wf:
                np.testing.assert_array_equal(gf[k], wf[k], err_msg=k)


# ---------------------------------------------------------------------------
# chip_smoke.py phase 8, rehearsed on the CPU at the smoke sizes
# ---------------------------------------------------------------------------


def test_chip_smoke_model_mesh_rehearsed_on_the_cpu(runs):
    """Phase 8's rank function on a (2, 2) gloo mesh of CPU ranks, smoke
    configs: every gate of (a)-(d) holds (its own asserts), each rank's
    METL feed ran, and the readings it prints are there."""
    if "error" in runs["phase8"]:
        raise runs["phase8"]["error"]
    ranks = runs["phase8"]["ranks"]
    lead = ranks[0]
    assert [r["coordinate"] for r in ranks] == [[0, 0], [0, 1], [1, 0], [1, 1]]
    assert all(r["etl_chunks"] >= 1 for r in ranks)
    assert lead["params_train_mesh"]["outside"] == lead["params_dp"]["outside"] == 0
    assert abs(lead["loss_train_mesh"] - lead["loss_one_process"]) <= 1e-4
    assert len(lead["dp_int8"]["losses"]) == 4 and max(lead["int8_loss_gaps"]) < 0.1
    assert lead["ep"]["experts_per_rank"] == lead["ep"]["experts"] // 2
    assert lead["checkpoint"]["meta"] == {"step": 1}
    assert lead["checkpoint"]["leaves_bit_equal"] > 10
    for r in ranks:
        assert r["train_step_collectives"][0]["calls"] > 0 and len(r["train_step_s"]) == 2
