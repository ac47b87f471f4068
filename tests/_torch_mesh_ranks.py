"""The port's side of tests/test_torch_mesh.py: functions that run on every
rank of a model mesh (``repro_torch.launch.mesh.run_on_mesh`` spawns them,
so they live in a module of their own, which imports neither JAX nor the
reference package), and the inputs both sides share.

Every function takes the mesh, a ``device`` ("cpu" over gloo, "cuda" over
NCCL) and plain data, and returns numpy results from rank 0 (``None`` on
the others) unless said otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

import repro_torch.configs as TC
from repro_torch.core.convert import params_from_jax, params_to_jax
from repro_torch.core.tree import tree_map
from repro_torch.etl.batcher import make_token_batch
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import moe as TMOE
from repro_torch.models.model import _gather_layer
from repro_torch.sharding import comm
from repro_torch.sharding.comm import full_tensor
from repro_torch.sharding.specs import is_dtensor, make_policy, param_spec_tree
from repro_torch.train import checkpoint as TCK
from repro_torch.train.elastic import reshard_checkpoint
from repro_torch.train.loop import (
    TrainConfig,
    init_all,
    make_dp_train_step,
    make_train_step,
    place_tree,
    train,
)
from repro_torch.train.optimizer import AdamWConfig, adamw_init, compress_grads_int8

F32 = dict(param_dtype="float32", compute_dtype="float32")
BATCH, SEQ = 8, 16
DP_STEPS = 4  # the compressed run's steps (the reference's gate)
TRAIN_STEPS = 3
EP_X = (4, 16)  # (B, S) of the expert-parallel input
CKPT_STEP = 5
GRAD_SHAPES = [((16, 8), "float32"), ((33,), "float32"), ((4, 5, 6), "bfloat16")]


def configs(arch: str, impl=None, dtype="float32"):
    """(kwargs of the smoke config, for ``configs.get_smoke(arch).replace``)."""
    kw = dict(F32) if dtype == "float32" else {}
    if impl is not None:
        kw["moe_impl"] = impl
    if impl == "ep":
        kw["capacity_factor"] = 8.0
    return kw


def weighted_batch(make_batch, cfg, step: int):
    """``make_batch(cfg, BATCH, SEQ, step=step)`` with a ``loss_weight``
    that differs between the two halves of the batch (the two data ranks
    of a (2, 2) mesh): 0-3 in the first half, 0 or 1 in the second."""
    b = dict(make_batch(cfg, BATCH, SEQ, step=step))
    rng = np.random.default_rng(100 + step)
    w = np.empty((BATCH, SEQ), np.float32)
    w[: BATCH // 2] = rng.integers(0, 4, (BATCH // 2, SEQ))
    w[BATCH // 2:] = rng.integers(0, 2, (BATCH // 2, SEQ))
    b["loss_weight"] = w
    return b


def grad_shards(n: int):
    """Per-shard gradients and residuals of the compression case: lists
    (one per leaf) of (n, *shape) float32 arrays, and each leaf's dtype."""
    rng = np.random.default_rng(7)
    grads, efs = [], []
    for shape, _ in GRAD_SHAPES:
        scale = np.array([0.5, 2.0, 1.0, 3.0][:n], np.float32).reshape(n, *[1] * len(shape))
        grads.append((rng.normal(size=(n, *shape)) * scale).astype(np.float32))
        efs.append((rng.normal(size=(n, *shape)) * 1e-2).astype(np.float32))
    return grads, efs, [dt for _, dt in GRAD_SHAPES]


def ep_input():
    return (np.random.default_rng(11).normal(size=(*EP_X, 64)) * 0.5).astype(np.float32)


# ---------------------------------------------------------------------------


def _dev(device):
    if device == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def _whole(tree):
    return tree_map(lambda t: full_tensor(t) if is_dtensor(t) else t, tree)


def _ref_layout(tree):
    """A port tree on the host in the reference's layout (bf16 as uint16)."""
    return params_to_jax(tree_map(lambda t: t.detach().cpu(), tree))


def _rank0():
    return torch.distributed.get_rank() == 0


def _feed(cfg):
    return lambda step: weighted_batch(make_token_batch, cfg, step)


def compress_case(mesh, device):
    """compress_grads_int8 from each rank's shard: (means, every rank's
    new ef) on rank 0."""
    dev = _dev(device)
    rank = mesh.get_coordinate()[0]
    grads, efs, dts = grad_shards(mesh.size(0))
    g = {f"g{i}": torch.as_tensor(a[rank]).to(dev, getattr(torch, dt))
         for i, (a, dt) in enumerate(zip(grads, dts))}
    e = {f"g{i}": torch.as_tensor(a[rank]).to(dev) for i, a in enumerate(efs)}
    mean, ef = compress_grads_int8(g, e, mesh.get_group("data"))
    mean = {k: v.float().cpu().numpy() for k, v in mean.items()}
    efs_all = [None] * mesh.size(0)
    torch.distributed.all_gather_object(efs_all, {k: v.cpu().numpy() for k, v in ef.items()})
    return (mean, efs_all) if _rank0() else None


def dp_case(mesh, device, params_np):
    """The explicit data-parallel step: one float32 step, then the float32
    and the compressed runs of DP_STEPS steps.  Returns {name: (losses,
    params in the reference's layout)} on rank 0."""
    cfg = TC.get_smoke("olmo_1b").replace(**configs("olmo_1b"))
    dev = _dev(device)
    out = {}
    for name, compress, steps in (("dp1", False, 1), ("dp_f32", False, DP_STEPS),
                                  ("dp_int8", True, DP_STEPS)):
        tc = TrainConfig(batch=BATCH, seq=SEQ, opt=AdamWConfig(warmup_steps=1,
                                                                compress_grads=compress))
        params = params_from_jax(params_np, device=dev)
        opt = adamw_init(params, tc.opt)
        step = make_dp_train_step(cfg, tc, mesh)
        losses = []
        for s in range(steps):
            b = {k: torch.as_tensor(v).to(dev) for k, v in
                 weighted_batch(make_token_batch, cfg, s).items()}
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
        out[name] = (losses, _ref_layout(params))
    return out if _rank0() else None


def ep_case(mesh, device, moe_np):
    """moe_apply under ep over the mesh: (out (B, S, D) float32, aux) on
    rank 0, every data rank's rows gathered."""
    cfg = TC.get_smoke("qwen3_moe_30b_a3b").replace(**configs("qwen3_moe_30b_a3b", "ep", "bf16"))
    dev = _dev(device)
    sp = make_policy(mesh)
    p = params_from_jax({"moe": moe_np}, device=dev)
    lp = place_tree(p, param_spec_tree(p, sp), mesh)
    x = torch.as_tensor(ep_input()).to(dev, cfg.cdtype)
    d, n = sp.data_index(), sp.data_size()
    rows = EP_X[0] // n
    out, aux = TMOE.moe_apply(_gather_layer(lp, cfg, sp)["moe"], x[d * rows:(d + 1) * rows], cfg,
                              sp)
    outs = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(outs, out.float().cpu().numpy())
    ranks = [int(r) for r in mesh.mesh[:, 0]]  # one rank of each data group
    full = np.concatenate([outs[r] for r in ranks])
    return (full, float(aux)) if _rank0() else None


def train_case(mesh, device, arch, impl, params_np):
    """``train(mesh=...)`` over TRAIN_STEPS weighted batches: (losses,
    final params in the reference's layout) on rank 0."""
    cfg = TC.get_smoke(arch).replace(**configs(arch, impl))
    dev = _dev(device)
    tc = TrainConfig(steps=TRAIN_STEPS, batch=BATCH, seq=SEQ, log_every=1,
                     opt=AdamWConfig(warmup_steps=1))
    out = train(cfg, tc, mesh=mesh, batch_fn=_feed(cfg), device=dev,
                params=params_from_jax(params_np, device=dev))
    losses = [m["loss"] for m in out["history"]]
    params = _ref_layout(_whole(out["params"]))
    return (losses, params) if _rank0() else None


def micro_case(mesh, device, params_np):
    """One sharded ``make_train_step`` with ``n_micro=2`` (each microbatch
    split over the data ranks): (loss, params in the reference's layout)
    on rank 0."""
    cfg = TC.get_smoke("olmo_1b").replace(**configs("olmo_1b"))
    dev = _dev(device)
    tc = TrainConfig(batch=BATCH, seq=SEQ, n_micro=2, opt=AdamWConfig(warmup_steps=1))
    params, opt, sp = init_all(cfg, tc, mesh, device=dev,
                               params=params_from_jax(params_np, device=dev))
    b = {k: torch.as_tensor(v).to(dev) for k, v in weighted_batch(make_token_batch, cfg, 0).items()}
    params, _, m = make_train_step(cfg, tc, sp)(params, opt, b)
    params = _ref_layout(_whole(params))
    return (float(m["loss"]), params) if _rank0() else None


def launcher_case(mesh, device, steps):
    """What ``launch.train --smoke --mesh`` computes (defaults: olmo-1b,
    batch 8, seq 128, seed-0 weights): the final loss of ``train(mesh=)``
    and of ``train(mesh=, dp=True)`` with the int8 all-reduce."""
    cfg = TC.get_smoke("olmo_1b")
    dev = _dev(device)
    got = []
    for dp in (False, True):
        tc = TrainConfig(steps=steps, batch=8, seq=128, opt=AdamWConfig(compress_grads=dp))
        got.append(train(cfg, tc, mesh=mesh, device=dev, dp=dp)["history"][-1]["loss"])
    return got if _rank0() else None


def _make_like(cfg, tc, dev):
    return lambda mesh: init_all(cfg, tc, mesh, device=dev)[:2]


def elastic_save(mesh, device, params_np, base):
    """init_all on this mesh from the reference's weights, save at
    CKPT_STEP, then reshard onto a (1, 1) mesh (rank 0): every restored
    leaf against the saved one, bit for bit."""
    cfg = TC.get_smoke("olmo_1b").replace(**configs("olmo_1b"))
    dev = _dev(device)
    tc = TrainConfig(batch=BATCH, seq=SEQ)
    params, opt, _ = init_all(cfg, tc, mesh, device=dev, params=params_from_jax(params_np,
                                                                               device=dev))
    TCK.save(base, CKPT_STEP, params, opt, {"step": CKPT_STEP})
    want = _ref_layout(_whole(params)), _ref_layout(_whole(opt))
    one = make_local_mesh(1, 1, device=dev)  # every rank builds it; rank 0 holds it
    if one.get_coordinate() is None:
        return None
    p2, o2, meta = reshard_checkpoint(base, cfg, _make_like(cfg, tc, dev), one)
    return meta, want, (_ref_layout(_whole(p2)), _ref_layout(_whole(o2)))


def elastic_restore(mesh, device, base):
    """reshard_checkpoint onto this mesh: (meta, params, opt in the
    reference's layout, the DTensor placements of one leaf) on rank 0."""
    cfg = TC.get_smoke("olmo_1b").replace(**configs("olmo_1b"))
    dev = _dev(device)
    tc = TrainConfig(batch=BATCH, seq=SEQ)
    p2, o2, meta = reshard_checkpoint(base, cfg, _make_like(cfg, tc, dev), mesh)
    placed = str(p2["layers"][0]["attn"]["wq"].placements)
    got = _ref_layout(_whole(p2)), _ref_layout(_whole(o2))
    return (meta, got, placed) if _rank0() else None


COLLECTIVE_CASES = [("olmo_1b", None), ("qwen3_moe_30b_a3b", "dmm"), ("qwen3_moe_30b_a3b", "ep")]


def collectives_case(mesh, device):
    """One ``train(mesh=...)`` step of each ``COLLECTIVE_CASES`` smoke
    config (seed-0 weights, the synthetic batch): the bytes by kind that
    ``comm.STATS`` records over the run, on rank 0."""
    dev = _dev(device)
    out = {}
    for arch, impl in COLLECTIVE_CASES:
        cfg = TC.get_smoke(arch).replace(**configs(arch, impl))
        tc = TrainConfig(steps=1, batch=BATCH, seq=SEQ, log_every=1,
                         opt=AdamWConfig(warmup_steps=1))
        comm.reset_stats()
        train(cfg, tc, mesh=mesh, device=dev)
        out[f"{arch}/{impl}"] = dict(comm.STATS["bytes"])
    return out if _rank0() else None


def mesh_22(mesh, device, params, base, launcher_steps):
    """Every case of the (2, 2) mesh, in one spawn."""
    return {
        "collectives": collectives_case(mesh, device),
        "ep": ep_case(mesh, device, params["moe"]),
        "train_olmo": train_case(mesh, device, "olmo_1b", None, params["olmo"]),
        "train_moe": train_case(mesh, device, "qwen3_moe_30b_a3b", "dmm", params["qwen3"]),
        "elastic": elastic_save(mesh, device, params["olmo"], base),
        "micro": micro_case(mesh, device, params["olmo"]),
        "launcher": launcher_case(mesh, device, launcher_steps),
    }


def pod_case(mesh, device, params_np):
    """The multi-pod axes on the same four ranks, a (2, 2, 1) ("pod",
    "data", "model") mesh: one ``make_dp_train_step`` over ("pod",
    "data") and one sharded ``make_train_step`` (the pod axis folded into
    the data-parallel group).  Returns {name: (loss, params in the
    reference's layout)} on rank 0."""
    from torch.distributed.device_mesh import DeviceMesh

    pod = DeviceMesh(mesh.device_type, torch.arange(4).reshape(2, 2, 1),
                     mesh_dim_names=("pod", "data", "model"))
    cfg = TC.get_smoke("olmo_1b").replace(**configs("olmo_1b"))
    dev = _dev(device)
    tc = TrainConfig(batch=BATCH, seq=SEQ, opt=AdamWConfig(warmup_steps=1))
    b = {k: torch.as_tensor(v).to(dev) for k, v in weighted_batch(make_token_batch, cfg, 0).items()}
    params = params_from_jax(params_np, device=dev)
    p_dp, _, m_dp = make_dp_train_step(cfg, tc, pod, data_axes=("pod", "data"))(
        params, adamw_init(params, tc.opt), b)
    params, opt, sp = init_all(cfg, tc, pod, device=dev, params=params_from_jax(params_np,
                                                                               device=dev))
    p_sh, _, m_sh = make_train_step(cfg, tc, sp)(params, opt, b)
    out = {"dp": (float(m_dp["loss"]), _ref_layout(p_dp)),
           "sharded": (float(m_sh["loss"]), _ref_layout(_whole(p_sh))),
           "data_axes": sp.data_axes}
    return out if _rank0() else None


def mesh_41(mesh, device, params, base):
    """Every case of the (4, 1) mesh, in one spawn."""
    return {
        "compress": compress_case(mesh, device),
        "dp": dp_case(mesh, device, params["olmo"]),
        "elastic": elastic_restore(mesh, device, base),
        "pod": pod_case(mesh, device, params["olmo"]),
    }
