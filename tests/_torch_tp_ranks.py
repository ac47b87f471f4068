"""The port's side of tests/test_torch_tensor_parallel.py: the functions that
run on every rank of a (1, 4) gloo mesh (``run_on_mesh`` spawns them, so
they live in a module that imports neither JAX nor the reference), and the
inputs both sides share.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

import repro_torch.configs as TC
from repro_torch.core.convert import params_from_jax
from repro_torch.etl.batcher import make_token_batch
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.sharding.specs import make_policy
from repro_torch.train.loop import TrainConfig, init_all, make_train_step, train
from repro_torch.train.optimizer import AdamWConfig

import _torch_mesh_ranks as R

MESH = (1, 4)
STEPS = 2
# (name, arch, config overrides): the KV-gather case (H 8, KV 2 on M 4),
# heads that do not divide M (H 6: attention repeated, the MLP and the
# vocabulary split; H * hd = 48 divides, so the reference's GSPMD splits
# mid-head), and whisper's cross-attention split
TRAIN_CASES = [("llama", "llama3_405b", {}),
               ("phi3_h6", "phi3_medium_14b", dict(d_model=48, n_heads=6, n_kv_heads=2)),
               ("whisper", "whisper_tiny", {})]
# on (2, 2): qwen3-moe with its experts over ``model`` (ep) beside the
# split attention and vocabulary
EP_MESH = (2, 2)
EP_CASES = [("qwen3_ep", "qwen3_moe_30b_a3b", dict(moe_impl="ep", capacity_factor=8.0))]
CE_SHAPE, CE_VOCAB = (2, 8), 500  # pads 500 to 512: the pad columns on the last rank


def case_cfg(arch, kw):
    return TC.get_smoke(arch).replace(**R.F32, **kw)


def train_config():
    return TrainConfig(steps=STEPS, batch=R.BATCH, seq=R.SEQ, log_every=1,
                       opt=AdamWConfig(warmup_steps=1))


def ce_inputs():
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(*CE_SHAPE, 512)) * 3).astype(np.float32)
    labels = rng.integers(0, CE_VOCAB, CE_SHAPE).astype(np.int32)
    weight = rng.integers(0, 3, CE_SHAPE).astype(np.float32)
    return logits, labels, weight


def _rank0():
    return torch.distributed.get_rank() == 0


def _gathered(obj):
    out = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(out, obj)
    return out


def _train(mesh, arch, kw, params_np):
    cfg = case_cfg(arch, kw)
    out = train(cfg, train_config(), mesh=mesh,
                batch_fn=lambda s: R.weighted_batch(make_token_batch, cfg, s), device="cpu",
                params=params_from_jax(params_np, device="cpu"))
    return [m["loss"] for m in out["history"]], R._ref_layout(R._whole(out["params"]))


def _ce(mesh):
    """This rank's vocab-split cross-entropy and its gradient against the
    whole-vocabulary one."""
    cfg = TC.get_smoke("olmo_1b").replace(vocab=CE_VOCAB)
    sp = make_policy(mesh)
    logits, labels, weight = (torch.as_tensor(a) for a in ce_inputs())
    r, n = sp.model_index(), mesh.size(1)
    cols = logits.shape[-1] // n
    mine = logits[..., r * cols:(r + 1) * cols].clone().requires_grad_(True)
    whole = logits.clone().requires_grad_(True)
    out = {}
    for name, w in (("weighted", weight), ("mean", None)):
        got = TL.cross_entropy(mine, labels, cfg, w, sh=sp)
        want = TL.cross_entropy(whole, labels, cfg, w)
        g_got, = torch.autograd.grad(got, mine)
        g_want, = torch.autograd.grad(want, whole)
        out[name] = (float(got), float(want),
                     float((g_got - g_want[..., r * cols:(r + 1) * cols]).abs().max()))
    out["start"] = TL.vocab_start(cfg, sp)
    return out


def _forward(mesh, params_np):
    """``forward``'s logits on the mesh (the vocabulary shards joined over
    ``model``) against the mesh-free ``forward``'s: the largest difference,
    and the shapes."""
    cfg = case_cfg("olmo_1b", {})
    batch = {k: torch.as_tensor(v) for k, v in make_token_batch(cfg, R.BATCH, R.SEQ).items()}
    params, _, sp = init_all(cfg, train_config(), mesh, device="cpu",
                             params=params_from_jax(params_np, device="cpu"))
    with torch.no_grad():
        got = TM.forward(params, cfg, batch, sp)[0]
        want = TM.forward(params_from_jax(params_np, device="cpu"), cfg, batch)[0]
    return float((got - want).abs().max()), tuple(got.shape), tuple(want.shape)


def _layer_shapes(mesh):
    """Shapes of one rank's gathered layer and embedding, of each arch, and
    the error of a leaf its split does not fit."""
    out = {}
    for arch in ("olmo_1b", "llama3_405b"):
        cfg = case_cfg(arch, {})
        params, _, sp = init_all(cfg, train_config(), mesh, device="cpu")
        with torch.no_grad():
            lp = sp.gather_layer(params["layers"][0], cfg)
            emb = TM._gather_embed(params["embed"], cfg, sp)
        out[arch] = {f"{b}/{k}": tuple(v.shape) for b in ("attn", "mlp")
                     for k, v in lp[b].items()}
        out[arch].update({f"embed/{k}": tuple(v.shape) for k, v in emb.items()})
        out[arch]["split"] = sp.tensor_split(cfg)
    try:
        sp.gather_split(params["layers"][0]["attn"]["wk"], 0, "wk")
        out["misfit"] = None
    except ValueError as err:
        out["misfit"] = str(err)
    return out


def _step_flops(cfg, tc, mesh, params_np):
    """The matrix-product flops of one ``make_train_step`` (on ``mesh``, or
    mesh-free with ``mesh=None``), by ``FlopCounterMode``."""
    params, opt, sp = init_all(cfg, tc, mesh, device="cpu",
                               params=params_from_jax(params_np, device="cpu"))
    batch = {k: torch.as_tensor(v) for k, v in
             R.weighted_batch(make_token_batch, cfg, 0).items()}
    step = make_train_step(cfg, tc, sp if mesh is not None else None)
    with FlopCounterMode(display=False) as fc:
        step(params, opt, batch)
    return fc.get_total_flops()


FLOP_CASES = [("olmo_1b", {}), ("llama3_405b", {})]


def _flops(mesh, params):
    tc = TrainConfig(batch=R.BATCH, seq=R.SEQ, opt=AdamWConfig(warmup_steps=1))
    return {arch: _step_flops(case_cfg(arch, kw), tc, mesh, params[arch])
            for arch, kw in FLOP_CASES}


def mesh_14(mesh, params):
    """Every case of the (1, 4) mesh, in one spawn: rank 0 returns the
    trains, the shapes, the flops and every rank's cross-entropy."""
    out = {name: _train(mesh, arch, kw, params[name]) for name, arch, kw in TRAIN_CASES}
    out["shapes"] = _layer_shapes(mesh)
    out["flops"] = _flops(mesh, params)
    out["ce"] = _gathered(_ce(mesh))
    out["forward"] = _forward(mesh, params["olmo_1b"])
    out["phase8e"] = _gathered(_phase8e(mesh))
    return out if _rank0() else None


def mesh_22(mesh, params):
    """The ep cases on the (2, 2) mesh: rank 0 returns their trains."""
    out = {name: _train(mesh, arch, kw, params[name]) for name, arch, kw in EP_CASES}
    return out if _rank0() else None


def _phase8e(mesh):
    """chip_smoke.py phase 8 (e)'s rank function at the smoke sizes."""
    repo = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import chip_smoke

    return chip_smoke.mesh_tp_rank(mesh, True)


def mesh_free_flops(params):
    tc = TrainConfig(batch=R.BATCH, seq=R.SEQ, opt=AdamWConfig(warmup_steps=1))
    return {arch: _step_flops(case_cfg(arch, kw), tc, None, params[arch])
            for arch, kw in FLOP_CASES}


TIMED_BATCH, TIMED_SEQ, TIMED_STEPS = 8, 512, 3


def time_rank(mesh):
    """One rank's split train step of olmo-1b at full width and depth on
    the card, after a warm-up step: each timed step's seconds, the host
    seconds inside ``comm`` calls and their bytes by kind, the loss and
    ``max_memory_allocated``."""
    from repro_torch.sharding import comm

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = TC.get("olmo_1b")
    tc = TrainConfig(batch=TIMED_BATCH, seq=TIMED_SEQ)
    params, opt, sp = init_all(cfg, tc, mesh, device=dev)
    step = make_train_step(cfg, tc, sp)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in
             make_token_batch(cfg, TIMED_BATCH, TIMED_SEQ, step=0).items()}
    params, opt, _ = step(params, opt, batch)
    torch.cuda.synchronize()
    out = {"rank": torch.distributed.get_rank(), "coordinate": list(mesh.get_coordinate()),
           "step_s": [], "comm_s": [], "bytes": None}
    for _ in range(TIMED_STEPS):
        comm.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t0)
        out["comm_s"].append(comm.STATS["seconds"])
        out["bytes"] = dict(comm.STATS["bytes"])
    out["loss"] = float(m["loss"])
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return out
