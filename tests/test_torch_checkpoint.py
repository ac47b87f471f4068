"""The port's checkpoints, train loop restart and training launcher, on the
CPU, against the reference's.

The cases of tests/test_train_infra.py's ``TestCheckpoint`` and
``TestOptimizer``, mirrored on the port; then the two packages' files side
by side: a checkpoint written by either restores in the other bit for bit
(float32 and bfloat16 leaves, bfloat16 moments), the two write the same
bytes for the same state, and a run started by the reference's ``train``
resumes in the port's and ends where the reference's own resumed run ends;
last the launcher ``python -m repro_torch.launch.train``.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import repro.configs as RC
from repro.core.state import StateCoordinator as RCoordinator
from repro.core.synthetic import ScenarioConfig as RScenarioConfig
from repro.core.synthetic import build_scenario as r_build_scenario
from repro.models import model as RM
from repro.train import checkpoint as RCK
from repro.train import loop as RLOOP
from repro.train import optimizer as ROPT

import torch

import repro_torch.configs as TC
from repro_torch.core.convert import params_from_jax, params_to_jax
from repro_torch.core.state import StateCoordinator
from repro_torch.core.synthetic import ScenarioConfig, build_scenario
from repro_torch.etl.batcher import make_token_batch
from repro_torch.launch import train as TLAUNCH
from repro_torch.models import model as TM
from repro_torch.train import checkpoint as TCK
from repro_torch.train import loop as TLOOP
from repro_torch.train import optimizer as TOPT
from repro_torch.core.tree import tree_leaves

REPO = os.path.join(os.path.dirname(__file__), "..")
KEY = jax.random.PRNGKey(0)


def _bits(t: torch.Tensor) -> bytes:
    return t.detach().reshape(-1).contiguous().view(torch.uint8).numpy().tobytes()


def _tiny(dtype="float32", moments="float32"):
    """The olmo smoke config's parameters and a fresh optimizer state, in
    the port, with a step counter and moments that are not zero."""
    cfg = TC.get_smoke("olmo_1b").replace(param_dtype=dtype, compute_dtype=dtype)
    params = TM.init_params(cfg, 0, device="cpu")
    opt = TOPT.adamw_init(params, TOPT.AdamWConfig(moment_dtype=moments))
    gen = torch.Generator().manual_seed(1)
    for t in tree_leaves(opt["m"]) + tree_leaves(opt["v"]):
        t.copy_(torch.randn(t.shape, generator=gen).abs())
    opt["step"].fill_(7)
    return cfg, params, opt


def _paths(tree, prefix=""):
    """{path: leaf} of a port tree, whatever its dicts' key order."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _paths(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in _paths(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _assert_same_bits(a, b):
    pa, pb = _paths(a), _paths(b)
    assert sorted(pa) == sorted(pb)
    for k, x in pa.items():
        y = pb[k]
        assert x.dtype == y.dtype and x.shape == y.shape and _bits(x) == _bits(y), k


# ---------------------------------------------------------------------------
# tests/test_train_infra.py's TestCheckpoint, on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,moments", [("float32", "float32"), ("bfloat16", "float32"),
                                           ("bfloat16", "bfloat16")])
def test_save_restore_identity(tmp_path, dtype, moments):
    _, params, opt = _tiny(dtype, moments)
    final = TCK.save(str(tmp_path), 7, params, opt, {"step": 7})
    assert final == str(tmp_path / "step_0000007")
    assert TCK.latest_step(str(tmp_path)) == 7
    like = (TM.init_params(TC.get_smoke("olmo_1b").replace(param_dtype=dtype), 5,
                           device="cpu"),
            TOPT.adamw_init(params, TOPT.AdamWConfig(moment_dtype=moments)))
    p2, o2, meta = TCK.restore(str(tmp_path), 7, like)
    assert meta == {"step": 7}
    _assert_same_bits(p2, params)
    _assert_same_bits(o2, opt)
    assert isinstance(p2["layers"], list) and len(p2["layers"]) == 2
    assert o2["step"].dtype == torch.int32 and int(o2["step"]) == 7


def test_layout_is_the_references(tmp_path):
    """One stacked file per leaf path, bfloat16 as uint16 with its dtype in
    dtypes.json, and the publication marker."""
    _, params, opt = _tiny("bfloat16")
    TCK.save(str(tmp_path), 3, params, opt, {"step": 3})
    arrays = tmp_path / "step_0000003" / "arrays"
    wq = np.load(arrays / "params__layers__attn__wq.npy")
    assert wq.dtype == np.uint16 and wq.shape == (2, 64, 64)
    assert np.load(arrays / "opt__step.npy").dtype == np.int32
    import json

    dtypes = json.loads((tmp_path / "step_0000003" / "dtypes.json").read_text())
    assert dtypes["params/layers/attn/wq"] == "bfloat16"
    assert dtypes["opt/m/layers/attn/wq"] == "float32" and dtypes["opt/step"] == "int32"
    names = list(dtypes)  # params first, then opt, each in sorted key order
    n_params = sum(k.startswith("params/") for k in names)
    assert names[:n_params] == sorted(names[:n_params])
    assert names[n_params:] == sorted(names[n_params:]) and names[-1] == "opt/v/layers/mlp/w_out"
    assert (tmp_path / "step_0000003.OK").read_text() == "ok"


def test_unpublished_checkpoint_invisible(tmp_path):
    _, params, opt = _tiny()
    TCK.save(str(tmp_path), 3, params, opt, {"step": 3})
    os.remove(str(tmp_path) + "/step_0000003.OK")  # simulate crash mid-publish
    assert TCK.latest_step(str(tmp_path)) is None
    assert TCK.latest_step(str(tmp_path / "nowhere")) is None


def test_unpublished_temp_dirs_are_collected(tmp_path):
    _, params, opt = _tiny()
    (tmp_path / "step_0000002.tmp" / "arrays").mkdir(parents=True)
    TCK.save(str(tmp_path), 4, params, opt, {"step": 4})
    assert sorted(os.listdir(tmp_path)) == ["step_0000004", "step_0000004.OK"]


def test_restart_resumes_training(tmp_path):
    cfg = TC.get_smoke("olmo_1b")
    tc = TLOOP.TrainConfig(
        steps=6, batch=2, seq=16, ckpt_dir=str(tmp_path), ckpt_every=3,
        log_every=1, opt=TOPT.AdamWConfig(warmup_steps=1),
    )
    out1 = TLOOP.train(cfg, tc, device="cpu")
    assert [m["step"] for m in out1["history"]] == list(range(6))
    # second call restores from step 6 and immediately finishes
    out2 = TLOOP.train(cfg, tc, device="cpu")
    assert TCK.latest_step(str(tmp_path)) == 6
    assert out2["history"] == []
    _assert_same_bits(out2["params"], out1["params"])
    # a run that stops at step 3 and one resumed from its checkpoint end
    # where the uninterrupted run ends
    base = tmp_path / "split"
    TLOOP.train(cfg, TLOOP.TrainConfig(**{**tc.__dict__, "steps": 3, "ckpt_dir": str(base)}),
                device="cpu")
    assert TCK.latest_step(str(base)) == 3
    out3 = TLOOP.train(cfg, TLOOP.TrainConfig(**{**tc.__dict__, "ckpt_dir": str(base)}),
                       device="cpu")
    assert [m["step"] for m in out3["history"]] == [3, 4, 5]
    _assert_same_bits(out3["params"], out1["params"])
    _assert_same_bits(out3["opt_state"], out1["opt_state"])


def test_dmm_hybrid_persistence(tmp_path):
    """Checkpoint stores DUSB; restart rebuilds DPM via Alg.4 -> Alg.2
    (the paper's hybrid recreate path); the file equals the reference's."""
    sc = build_scenario(ScenarioConfig(seed=2))
    coord = StateCoordinator(sc.registry, sc.dpm)
    dusb = coord.to_dusb()
    path = str(tmp_path / "dmm.json")
    TCK.save_dmm(path, dusb)
    dusb2 = TCK.restore_dmm(path)
    assert dusb2 == dusb
    coord2 = StateCoordinator.from_dusb(sc.registry, dusb2)
    assert coord2.snapshot().dpm == coord.snapshot().dpm
    rsc = r_build_scenario(RScenarioConfig(seed=2))
    RCK.save_dmm(str(tmp_path / "ref.json"), RCoordinator(rsc.registry, rsc.dpm).to_dusb())
    assert (tmp_path / "ref.json").read_bytes() == (tmp_path / "dmm.json").read_bytes()
    _, params, opt = _tiny()
    TCK.save(str(tmp_path / "ck"), 1, params, opt, {"step": 1}, dusb=dusb)
    assert TCK.restore_dmm(str(tmp_path / "ck" / "step_0000001" / "dmm.json")) == dusb


# ---------------------------------------------------------------------------
# tests/test_train_infra.py's TestOptimizer, on the port
# ---------------------------------------------------------------------------


def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([4.0, -3.0])}
    cfg = TOPT.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1)
    state = TOPT.adamw_init(params, cfg)
    for _ in range(300):
        grads = {"w": 2 * params["w"]}
        params, state, _ = TOPT.adamw_update(grads, state, params, cfg)
    assert float(params["w"].abs().max()) < 1e-2


def test_grad_clip():
    params = {"w": torch.zeros(3)}
    cfg = TOPT.AdamWConfig(lr=1.0, grad_clip=1.0, warmup_steps=1, weight_decay=0.0)
    state = TOPT.adamw_init(params, cfg)
    _, _, m = TOPT.adamw_update({"w": torch.tensor([1e6, 0.0, 0.0])}, state, params, cfg)
    assert float(m["grad_norm"]) > 1e5  # reported pre-clip


def test_bf16_moments():
    params = {"w": torch.zeros(4)}
    state = TOPT.adamw_init(params, TOPT.AdamWConfig(moment_dtype="bfloat16"))
    assert state["m"]["w"].dtype == torch.bfloat16


def test_quantize_roundtrip_error_bounded():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))
    q, s = TOPT.quantize_int8(x)
    err = (TOPT.dequantize_int8(q, s) - x).abs().numpy()
    assert err.max() <= float(s) * 0.5 + 1e-7


def test_int8_error_feedback_converges():
    """The EF-SGD bound on the port's quantizer: the sum of dequantized
    values tracks the true sum within one step's residual."""
    rng = np.random.default_rng(1)
    true_sum = np.zeros(64, np.float32)
    sent_sum = np.zeros(64, np.float32)
    ef = np.zeros(64, np.float32)
    for _ in range(200):
        g = rng.normal(size=64).astype(np.float32)
        true_sum += g
        total = g + ef
        q, s = TOPT.quantize_int8(torch.from_numpy(total))
        sent = TOPT.dequantize_int8(q, s).numpy()
        ef = total - sent
        sent_sum += sent
    assert np.abs(true_sum - sent_sum).max() <= np.abs(ef).max() + 1e-5


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


def _ref_state(dtype, moments):
    """The reference's olmo smoke parameters and an optimizer state with
    random moments and step 5 (numpy leaves made jax arrays)."""
    cfg = RC.get_smoke("olmo_1b").replace(param_dtype=dtype, compute_dtype=dtype)
    params = RM.init_params(cfg, KEY)
    opt = ROPT.adamw_init(params, ROPT.AdamWConfig(moment_dtype=moments))
    rng = np.random.default_rng(4)
    rnd = lambda a: jnp.asarray(np.abs(rng.normal(size=a.shape)), a.dtype)  # noqa: E731
    opt = dict(opt, step=jnp.asarray(5, jnp.int32), m=jax.tree_util.tree_map(rnd, opt["m"]),
               v=jax.tree_util.tree_map(rnd, opt["v"]))
    return params, opt


def _port_state(params, opt):
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return (params_from_jax(np_tree(params), device="cpu"),
            {"step": torch.tensor(int(opt["step"]), dtype=torch.int32),
             "m": params_from_jax(np_tree(opt["m"]), device="cpu"),
             "v": params_from_jax(np_tree(opt["v"]), device="cpu")})


CROSS = [("float32", "float32"), ("bfloat16", "float32"), ("bfloat16", "bfloat16")]


@pytest.mark.parametrize("dtype,moments", CROSS)
def test_the_two_packages_write_the_same_bytes(tmp_path, dtype, moments):
    rp, ro = _ref_state(dtype, moments)
    tp, to = _port_state(rp, ro)
    RCK.save(str(tmp_path / "ref"), 5, rp, ro, {"step": 5})
    TCK.save(str(tmp_path / "port"), 5, tp, to, {"step": 5})
    ref, port = tmp_path / "ref" / "step_0000005", tmp_path / "port" / "step_0000005"
    names = sorted(os.listdir(ref / "arrays"))
    assert names == sorted(os.listdir(port / "arrays")) and len(names) > 10
    for name in names:
        assert (ref / "arrays" / name).read_bytes() == (port / "arrays" / name).read_bytes(), name
    for name in ("dtypes.json", "meta.json"):
        assert (ref / name).read_bytes() == (port / name).read_bytes(), name


@pytest.mark.parametrize("dtype,moments", CROSS)
def test_the_references_checkpoint_restores_in_the_port(tmp_path, dtype, moments):
    rp, ro = _ref_state(dtype, moments)
    RCK.save(str(tmp_path), 5, rp, ro, {"step": 5})
    want = _port_state(rp, ro)
    cfg = TC.get_smoke("olmo_1b").replace(param_dtype=dtype)
    like = (TM.init_params(cfg, 3, device="cpu"),
            TOPT.adamw_init(want[0], TOPT.AdamWConfig(moment_dtype=moments)))
    assert TCK.latest_step(str(tmp_path)) == 5
    p, o, meta = TCK.restore(str(tmp_path), 5, like)
    assert meta == {"step": 5}
    _assert_same_bits(p, want[0])
    _assert_same_bits(o, want[1])


@pytest.mark.parametrize("dtype,moments", CROSS)
def test_the_ports_checkpoint_restores_in_the_reference(tmp_path, dtype, moments):
    rp, ro = _ref_state(dtype, moments)
    tp, to = _port_state(rp, ro)
    TCK.save(str(tmp_path), 5, tp, to, {"step": 5})
    assert RCK.latest_step(str(tmp_path)) == 5
    cfg = RC.get_smoke("olmo_1b").replace(param_dtype=dtype)
    like_p = RM.init_params(cfg, jax.random.PRNGKey(9))
    p, o, meta = RCK.restore(str(tmp_path), 5, (like_p, ROPT.adamw_init(
        like_p, ROPT.AdamWConfig(moment_dtype=moments))))
    assert meta == {"step": 5}
    for got, want in ((p, rp), (o, ro)):
        fg = jax.tree_util.tree_flatten_with_path(got)[0]
        fw = jax.tree_util.tree_flatten_with_path(want)[0]
        assert [k for k, _ in fg] == [k for k, _ in fw]
        for (_, a), (_, b) in zip(fg, fw):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_a_reference_run_resumes_in_the_port(tmp_path):
    """The reference's ``train`` writes step 3; the port's ``train``
    resumes it to step 6, and the reference's resumes its own copy to step
    6: the final parameters agree within float32 1e-5 (6e-8 found), the
    resumed runs' losses at 1e-4."""
    rcfg = RC.get_smoke("olmo_1b").replace(param_dtype="float32", compute_dtype="float32")
    tcfg = TC.get_smoke("olmo_1b").replace(param_dtype="float32", compute_dtype="float32")
    kw = dict(batch=2, seq=16, ckpt_every=3, log_every=1)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    RLOOP.train(rcfg, RLOOP.TrainConfig(steps=3, ckpt_dir=str(ref_dir), **kw,
                                        opt=ROPT.AdamWConfig(warmup_steps=1)))
    assert RCK.latest_step(str(ref_dir)) == 3
    shutil.copytree(ref_dir, port_dir)
    got = TLOOP.train(tcfg, TLOOP.TrainConfig(steps=6, ckpt_dir=str(port_dir), **kw,
                                              opt=TOPT.AdamWConfig(warmup_steps=1)),
                      device="cpu")
    want = RLOOP.train(rcfg, RLOOP.TrainConfig(steps=6, ckpt_dir=str(ref_dir), **kw,
                                               opt=ROPT.AdamWConfig(warmup_steps=1)))
    assert TCK.latest_step(str(port_dir)) == RCK.latest_step(str(ref_dir)) == 6
    assert [m["step"] for m in got["history"]] == [m["step"] for m in want["history"]] \
        == [3, 4, 5]
    for g, w in zip(got["history"], want["history"]):
        assert abs(g["loss"] - w["loss"]) <= 1e-4 * (1 + abs(w["loss"])), (g, w)
    gp = params_to_jax(got["params"])
    wp = jax.tree_util.tree_map(np.asarray, want["params"])
    for path, w in jax.tree_util.tree_flatten_with_path(wp)[0]:
        node = gp
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, w, atol=1e-5, rtol=1e-5, err_msg=str(path))
    # the port's step-6 checkpoint restores in the reference too
    like = (want["params"], want["opt_state"])
    p, _, meta = RCK.restore(str(port_dir), 6, like)
    assert meta == {"step": 6}
    for a, b in zip(jax.tree_util.tree_leaves(p),
                    jax.tree_util.tree_leaves(jax.tree_util.tree_map(
                        jnp.asarray, params_to_jax(got["params"])))):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_trains_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "olmo_1b", "--smoke",
         "--steps", "2", "--device", "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("step     0  loss") and lines[-1].startswith("final loss:")
    assert TCK.latest_step(str(tmp_path)) == 2


@pytest.mark.parametrize("argv", [["--mesh", "2"], ["--compress-grads", "--mesh", "0x2"],
                                  ["--moe-impl", "ep", "--mesh", "2xm"]])
def test_launcher_refuses_the_mesh_flags(argv, capsys):
    """A malformed ``--mesh`` exits 2 before any process starts (the mesh
    flags themselves run in tests/test_torch_mesh.py)."""
    with pytest.raises(SystemExit) as err:
        TLAUNCH.main(["--arch", "olmo_1b", "--smoke", "--device", "cpu", *argv])
    assert err.value.code == 2
    msg = capsys.readouterr().err
    assert "--mesh" in msg and "DxM" in msg


# ---------------------------------------------------------------------------
# chip_smoke.py phase 7, rehearsed on the CPU at the smoke sizes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


def test_phase7_olmo_etl_rehearsed(smoke):
    """(a) at the olmo smoke config, batches of (2, 64) from the METL feed
    on the CPU: finite losses, the fixed batch's loss falls, the feed's
    first batches equal a second CPU feed's, no kernel launched."""
    r = smoke.train_olmo_etl("cpu", TC.get_smoke("olmo_1b"), batch=2, seq=64)
    assert len(r["losses"]) == smoke.TRAIN_WARMUP + smoke.TRAIN_TIMED
    assert len(r["step_s"]["all"]) == smoke.TRAIN_TIMED
    assert r["fixed_batch_losses"][-1] < r["fixed_batch_losses"][0]
    assert r["feed_batches_equal_cpu"] == smoke.TRAIN_FEED_CHECKED and r["etl_chunks"] >= 1
    assert not any(r["launches"].values()) and r["max_memory_allocated"] is None


def test_phase7_flop_bound_is_the_reckoned_one(smoke):
    b = smoke.train_flop_bound(TC.get("olmo_1b"), smoke.TRAIN_BATCH, smoke.TRAIN_SEQ)
    assert b["tokens"] == 16384 and abs(b["flop"] - 1.289e14) < 1e11
    assert abs(b["flop_with_remat"] - 1.685e14) < 1e11
    assert abs(b["bound_s"] - 0.1303) < 1e-3 and abs(b["bound_with_remat_s"] - 0.1704) < 1e-3


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "rwkv6_3b", "whisper_tiny"])
def test_phase7_card_vs_cpu_rehearsed(smoke, arch):
    """(b) with the CPU standing for the card: every comparison exact."""
    cfg = TC.get_smoke(arch).replace(param_dtype="float32", compute_dtype="float32")
    r = smoke.train_card_vs_cpu("cpu", arch, cfg, shape=(2, 16))
    assert r["loss_card"] == r["loss_cpu"]
    for k in ("grads", "params_after", "moments_after"):
        assert r[k]["max_abs_err"] == 0.0 and r[k]["outside"] == 0 and r[k]["elements"] > 0


def test_phase7_tree_check_fails_what_it_should(smoke):
    """``_tree_close``: a gradient off by 1e-3 fails; a parameter a step of
    lr off passes only as one of few flips, within the most they may move."""
    want = {"a": torch.zeros(1000), "b": [torch.ones(10)]}
    bad = {"a": torch.zeros(1000), "b": [torch.ones(10) + 1e-3]}
    with pytest.raises(AssertionError, match="outside"):
        smoke._tree_close("grads", bad, want, smoke.TRAIN_CUT_TOL)
    flip = {"a": torch.zeros(1000), "b": [torch.ones(10)]}
    flip["a"][3] = 6e-4
    r = smoke._tree_close("params", flip, want, smoke.TRAIN_CUT_TOL, flips=(1e-2, 1.8e-3))
    assert r["outside"] == 1
    with pytest.raises(AssertionError, match="outside"):
        smoke._tree_close("params", flip, want, smoke.TRAIN_CUT_TOL, flips=(1e-4, 1.8e-3))
    flip["a"][3] = 1e-2
    with pytest.raises(AssertionError, match="outside"):
        smoke._tree_close("params", flip, want, smoke.TRAIN_CUT_TOL, flips=(1e-2, 1.8e-3))


def test_phase7_first_gradients_are_make_train_steps(smoke):
    cfg = TC.get_smoke("olmo_1b").replace(param_dtype="float32", compute_dtype="float32")
    params = TM.init_params(cfg, 0, device="cpu")
    b = {k: torch.from_numpy(np.asarray(v))
         for k, v in make_token_batch(cfg, 2, 16, seed=0).items()}
    tc = TLOOP.TrainConfig()
    step = TLOOP.make_train_step(cfg, tc)
    with smoke.first_gradients() as first:
        step(params, TOPT.adamw_init(params, tc.opt), b)
        step(params, TOPT.adamw_init(params, tc.opt), b)
    _, want = TLOOP.value_and_grad(params, cfg, b)
    _assert_same_bits(first["grads"], want)
    assert TLOOP.adamw_update is TOPT.adamw_update


def test_phase7_checkpoint_round_trip_rehearsed(smoke, tmp_path):
    r = smoke.train_checkpoint_round_trip("cpu", base=tmp_path / "ck")
    assert r["restart_steps"] == list(range(*smoke.TRAIN_CKPT_STEPS))
    assert r["meta"] == {"step": smoke.TRAIN_CKPT_STEPS[0]} and r["leaves_bit_equal"] > 10
    assert not (tmp_path / "ck").exists()


def test_phase7_refusal_check_fails_without_a_refusal(smoke):
    """On the CPU the plain version differentiates, so (d)'s check, which
    asserts the refusal, fails there."""
    with pytest.raises(AssertionError, match="not refused"):
        smoke.train_flash_refusal("cpu", TC.get_smoke("olmo_1b"))
