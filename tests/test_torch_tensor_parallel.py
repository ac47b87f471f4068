"""The port's tensor split over ``model`` against the reference's GSPMD
sharding.

The reference shards the MLP hidden, the attention heads and the
vocabulary over ``model`` through its activation constraints; the port
splits the same products by hand (column- and row-split products, a
vocab-split embedding, head and loss; ``sharding.specs.TensorSplit`` states
which parts split).  The port runs in one 4-rank gloo spawn of a (1, 4)
mesh (``tests/_torch_tp_ranks.py``); the reference in one subprocess with 4
forced CPU devices on the same mesh shape; both at once, from the same
weights (``params_from_jax``) and the same weighted batches.

Held, and how closely:
  * ``train(mesh=(1, 4))``, 2 steps: losses and parameters within 1e-4
    relative of the reference's, for llama3-405b's smoke config (H 8, KV 2
    on M 4: each rank gathers ``wk``/``wv`` whole and keeps the KV head its
    query heads read), phi3-medium's smoke config with 6 heads (H % M != 0:
    attention repeated, the MLP and the vocabulary split) and whisper-tiny's
    (the cross-attention split); and on (2, 2) qwen3-moe's smoke config
    under ``ep`` (experts over ``model`` beside the split attention);
  * the vocab-split cross-entropy, the pad columns on the last rank: loss
    and its gradient within 1e-6 of ``cross_entropy`` on the whole logits;
    ``forward``'s logits on the mesh (the shards joined) within 1e-5 of
    the mesh-free ``forward``'s;
  * one rank's gathered layer: 1/M of each split leaf, ``wk``/``wv`` whole
    where the KV heads do not divide; a leaf whose spec does not fit the
    split raises;
  * the matrix-product flops of one real rank's step (``FlopCounterMode``):
    equal to the dry run's per-device flops, and for olmo-1b's smoke
    config (every product split) to the mesh-free step's over D * M;
  * ``TensorSplit.kv_heads``: the KV heads each rank's query heads read;
  * chip_smoke.py phase 8 (e)'s rank function, rehearsed at the smoke
    sizes: its own gates hold (loss and parameters against one process),
    and each rank reads its split and the ``model`` all-reduces.
"""

import os
import subprocess
import sys
import tempfile
import textwrap

import jax
import numpy as np
import pytest

import _torch_tp_ranks as TP
import repro.configs as RC
from repro.models import model as RM
from repro_torch.configs import ShapeCell
from repro_torch.launch import dryrun_lib as D
from repro_torch.launch.mesh import run_on_mesh
from repro_torch.sharding.specs import TensorSplit
from test_torch_mesh import _bits, _close, _flat, _ref_tree, _trees_close

REPO = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(REPO, "src")
TESTS = os.path.dirname(os.path.abspath(__file__))
KEY = jax.random.PRNGKey(0)
TIMEOUT = 240

REF_CODE = """
import sys
sys.path.insert(0, {tests!r})
import numpy as np, jax
import _torch_tp_ranks as TP, _torch_mesh_ranks as R
import repro.configs as C
from repro.etl.batcher import make_token_batch
from repro.launch.mesh import make_local_mesh
from repro.train.loop import TrainConfig, train
from repro.train.optimizer import AdamWConfig

out = {{}}
cases = [(n, a, k, TP.MESH) for n, a, k in TP.TRAIN_CASES]
cases += [(n, a, k, TP.EP_MESH) for n, a, k in TP.EP_CASES]
for name, arch, kw, shape in cases:
    mesh = make_local_mesh(*shape)
    cfg = C.get_smoke(arch).replace(**R.F32, **kw)
    tc = TrainConfig(steps=TP.STEPS, batch=R.BATCH, seq=R.SEQ, log_every=1,
                     opt=AdamWConfig(warmup_steps=1))
    res = train(cfg, tc, mesh=mesh, batch_fn=lambda s, c=cfg: R.weighted_batch(make_token_batch, c, s))
    out[name + "/losses"] = np.asarray([h["loss"] for h in res["history"]])
    for path, leaf in jax.tree_util.tree_flatten_with_path(res["params"])[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out["/".join([name + "/params", *keys])] = np.asarray(leaf, np.float32)
np.savez({path!r}, **out)
print("REF OK")
"""


def _init(arch, kw):
    cfg = RC.get_smoke(arch).replace(**TP.R.F32, **kw)
    return _bits(jax.tree_util.tree_map(np.asarray, RM.init_params(cfg, KEY)))


@pytest.fixture(scope="module")
def runs():
    tmp = tempfile.mkdtemp(prefix="tp_")
    path = os.path.join(tmp, "ref.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF_CODE.format(tests=TESTS, path=path))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    params = {name: _init(arch, kw) for name, arch, kw in TP.TRAIN_CASES + TP.EP_CASES}
    params.update({arch: _init(arch, kw) for arch, kw in TP.FLOP_CASES})
    port = run_on_mesh(TP.mesh_14, *TP.MESH, device="cpu", args=(params,), timeout=TIMEOUT)[0]
    port.update(run_on_mesh(TP.mesh_22, *TP.EP_MESH, device="cpu", args=(params,),
                            timeout=TIMEOUT)[0])
    free = TP.mesh_free_flops(params)
    out, err = proc.communicate(timeout=TIMEOUT)
    assert proc.returncode == 0 and "REF OK" in out, out + err[-3000:]
    return {"port": port, "ref": np.load(path), "free": free}


@pytest.mark.parametrize("name", [name for name, _, _ in TP.TRAIN_CASES + TP.EP_CASES])
def test_train_on_a_mesh_matches_the_reference(runs, name):
    losses, params = runs["port"][name]
    ref = runs["ref"]
    _close(losses, ref[f"{name}/losses"], what="losses")
    _trees_close(_flat(params), _ref_tree(ref, f"{name}/params"))


@pytest.mark.parametrize("kind", ["weighted", "mean"])
def test_vocab_split_cross_entropy_equals_the_whole(runs, kind):
    ranks = runs["port"]["ce"]
    assert [r["start"] for r in ranks] == [0, 128, 256, 384]  # pads 500-511 on rank 3
    for r in ranks:
        got, want, grad_err = r[kind]
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (got, want)
        assert grad_err <= 1e-6


def test_forward_on_the_mesh_joins_the_vocabulary_shards(runs):
    err, got, want = runs["port"]["forward"]
    assert got == want == (TP.R.BATCH, TP.R.SEQ, 512)
    assert err <= 1e-5, err


def test_a_ranks_gathered_layer_holds_its_slice(runs):
    shapes = runs["port"]["shapes"]
    D_, M = 64, TP.MESH[1]
    olmo = shapes["olmo_1b"]  # H 4, KV 4, F 256, V 512: everything splits
    assert olmo["split"] == TensorSplit(size=M, rank=0, heads=True, kv=True, ff=True,
                                        vocab=True)
    for k in ("attn/wq", "attn/wk", "attn/wv"):
        assert olmo[k] == (D_, D_ // M), k
    assert olmo["attn/wo"] == (D_ // M, D_)
    assert olmo["mlp/w_in"] == olmo["mlp/w_gate"] == (D_, 256 // M)
    assert olmo["mlp/w_out"] == (256 // M, D_)
    assert olmo["embed/tok"] == (512 // M, D_)
    llama = shapes["llama3_405b"]  # H 8, KV 2 (hd 8): wk/wv whole
    assert llama["split"].heads and not llama["split"].kv
    assert llama["attn/wq"] == (D_, 64 // M) and llama["attn/wo"] == (64 // M, D_)
    assert llama["attn/wk"] == llama["attn/wv"] == (D_, 16)
    assert "wk" in shapes["misfit"] and "splits dim 1" in shapes["misfit"]


@pytest.mark.parametrize("arch,kw", TP.FLOP_CASES)
def test_a_ranks_product_flops_equal_the_dry_run(runs, arch, kw):
    got = runs["port"]["flops"][arch]
    tc = TP.TrainConfig(batch=TP.R.BATCH, seq=TP.R.SEQ,
                        opt=TP.AdamWConfig(warmup_steps=1))
    want = D.trace_cell(TP.case_cfg(arch, kw), ShapeCell("t", TP.R.SEQ, TP.R.BATCH, "train"),
                        D.ShapeMesh(*TP.MESH), tc)["cost"]["flops"]
    assert got == want, (got, want)
    free = runs["free"][arch]
    if arch == "olmo_1b":  # every product splits: exactly the mesh-free step over D * M
        assert got * TP.MESH[0] * TP.MESH[1] == free
    else:  # the K/V products of the KV-gather case split by KV/KV_loc = 2, not 4
        assert free / 4 < got < free / 2


@pytest.mark.parametrize("h,kv,m,want", [
    (8, 2, 4, [([0], 2), ([0], 2), ([1], 2), ([1], 2)]),  # one KV head a rank, shared
    (16, 4, 4, [([0], 4), ([1], 4), ([2], 4), ([3], 4)]),
    (128, 8, 16, [([r // 2], 8) for r in range(16)]),  # llama3-405b on (16, 16)
    (12, 6, 4, [([0, 0, 1], 1), ([1, 2, 2], 1), ([3, 3, 4], 1), ([4, 5, 5], 1)]),
])
def test_kv_heads_follow_h_over_n_rep(h, kv, m, want):
    for r in range(m):
        ts = TensorSplit(size=m, rank=r, heads=True, kv=kv % m == 0, ff=True, vocab=True)
        heads, rep = ts.kv_heads(h, kv)
        assert (list(heads), rep) == want[r], r


def test_chip_smoke_phase_8e_rehearsed_on_the_cpu(runs):
    ranks = runs["port"]["phase8e"]
    assert [r["coordinate"] for r in ranks] == [[0, m] for m in range(4)]
    assert [r["split"]["rank"] for r in ranks] == [0, 1, 2, 3]
    assert all(r["split"]["heads"] and r["split"]["ff"] and r["split"]["vocab"] for r in ranks)
    lead = ranks[0]
    assert abs(lead["loss_train_mesh"] - lead["loss_one_process"]) <= 1e-4
    assert lead["params_train_mesh"]["outside"] == 0
    for r in ranks:  # no data ranks: the collectives are the model group's
        assert r["collectives"]["bytes"]["all-reduce"] > 0
        assert "reduce-scatter" not in r["collectives"]["bytes"]
