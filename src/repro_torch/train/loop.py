"""The train steps and the training loop, on one device or over the model
mesh.

Counterpart of ``repro.train.loop``:

  * :func:`make_train_step` -- (params, opt_state, batch) -> (params,
    opt_state, metrics): the loss and its gradients by autograd (the
    reference's ``jax.value_and_grad`` of ``loss_fn``), microbatch
    accumulation in ``accum_dtype`` when ``n_micro > 1``, then
    :func:`~repro_torch.train.optimizer.adamw_update`; remat per
    ``cfg.remat``.  Given a sharding policy over a ``torch.distributed``
    mesh it computes the reference's GSPMD step -- the whole batch's loss
    and gradients -- with DTensor parameters and moments stored as
    :func:`~repro_torch.sharding.specs.param_spec_tree` shards them and
    data-parallel compute (:mod:`repro_torch.models.model`);
  * :func:`make_dp_train_step` -- the explicit data-parallel step:
    replicated parameters and state, each rank its batch rows, gradients
    averaged over the data axes in float32 or through the int8 all-reduce
    with error feedback (:func:`~repro_torch.train.optimizer.
    compress_grads_int8`);
  * :func:`train` -- the loop: batches from ``batch_fn`` (the ETL feed)
    or the synthetic :func:`~repro_torch.etl.batcher.make_token_batch`,
    checkpoints every ``ckpt_every`` steps and a restart from the latest
    published one.

Under a mesh every step takes the whole batch on every rank (batches are
pure functions of the step, the reference's elasticity contract) and each
rank takes its data rank's rows; every rank returns the same metrics.

The port adds ``device`` (the card by default; raises when there is none)
and ``params``, starting values for the parameters (the reference draws
them from ``jax.random``, which torch cannot reproduce; tests pass the
reference's through :func:`repro_torch.core.convert.params_from_jax`), and
``train(..., dp=True)``, the loop over :func:`make_dp_train_step`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.dmm_torch import DeviceLike, resolve_device
from ..core.tree import tree_leaves, tree_map, tree_unflatten
from ..models import model as M
from ..models.config import ModelConfig
from ..sharding.comm import all_reduce, all_reduce_sum, axes_group, place
from ..sharding.specs import (
    P,
    ShardingPolicy,
    axes_index,
    make_policy,
    param_spec_tree,
    placements,
)
from .optimizer import AdamWConfig, adamw_init, adamw_update, compress_grads_int8

__all__ = ["TrainConfig", "value_and_grad", "make_train_step", "make_dp_train_step",
           "init_all", "param_spec_tree_like", "train"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    batch: int = 8
    seq: int = 128
    n_micro: int = 1  # gradient-accumulation microbatches
    accum_dtype: str = "float32"  # bfloat16 halves the accumulator at >=100B
    log_every: int = 10
    ckpt_every: int = 0  # 0 = disabled
    ckpt_dir: Optional[str] = None
    seed: int = 0
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


def _split_micro(batch: Dict[str, torch.Tensor], n: int) -> Dict[str, torch.Tensor]:
    """Each (B, ...) entry as (n, B // n, ...)."""

    def f(x):
        b = x.shape[0]
        return x.reshape(n, b // n, *x.shape[1:])

    return {k: f(v) for k, v in batch.items()}


def _rows(batch: Dict[str, torch.Tensor], index: int, n: int) -> Dict[str, torch.Tensor]:
    """Data rank ``index`` of ``n``'s rows of each (B, ...) entry."""
    def f(x):
        b = x.shape[0] // n
        return x[index * b:(index + 1) * b]

    return {k: f(v) for k, v in batch.items()}


def value_and_grad(params: Any, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                   sh: Optional[ShardingPolicy] = None) -> Tuple[torch.Tensor, Any]:
    """(loss, gradients) of ``loss_fn`` at ``params``: every leaf a fresh
    leaf of the graph that requires grad, the gradients in its dtype (and,
    under a mesh, DTensors placed as their parameters)."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    with torch.enable_grad():
        loss = M.loss_fn(tree_unflatten(params, leaves), cfg, batch, sh)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(cfg: ModelConfig, tc: TrainConfig,
                    sh: Optional[ShardingPolicy] = None, *,
                    on_micro: Optional[Callable[[int], None]] = None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics), metrics
    ``{"loss", "grad_norm", "lr"}`` as float32 scalars on the device (no
    host sync).  ``batch`` holds tensors on the parameters' device.

    ``sh``: a sharding policy over a ``torch.distributed`` mesh (from
    :func:`init_all`), with DTensor parameters and state.  ``batch`` is then
    the whole batch on every rank: each microbatch (the whole batch's
    split, as the reference splits it) gives this data rank its rows, and
    the step returns the whole batch's loss and the parameters the
    reference's GSPMD step computes, on every rank.

    ``on_micro(i)``, when given, runs after microbatch ``i`` has been
    added to the accumulators (``n_micro > 1``; the dry run counts the
    microbatches with it)."""
    sharded = sh is not None and sh.sharded

    def local(b):
        return _rows(b, sh.data_index(), sh.data_size()) if sharded else b

    def train_step(params, opt_state, batch):
        if tc.n_micro > 1:
            adt = getattr(torch, tc.accum_dtype)
            micro = _split_micro(batch, tc.n_micro)
            gsum = tree_map(lambda p: torch.zeros_like(p, dtype=adt), params)
            lsum = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            for i in range(tc.n_micro):
                mb = local({k: v[i] for k, v in micro.items()})
                loss, grads = value_and_grad(params, cfg, mb, sh)
                gsum = tree_map(lambda a, g: a + g.to(adt), gsum, grads)
                lsum = lsum + loss  # from 0, as the reference's scan carry
                if on_micro is not None:
                    on_micro(i)
            grads = tree_map(lambda g: g / tc.n_micro, gsum)
            loss = lsum / tc.n_micro
        else:
            loss, grads = value_and_grad(params, cfg, local(batch), sh)
        params, opt_state, om = adamw_update(grads, opt_state, params, tc.opt)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def make_dp_train_step(cfg: ModelConfig, tc: TrainConfig, mesh,
                       data_axes: Tuple[str, ...] = ("data",)) -> Callable:
    """The explicit data-parallel step over ``mesh``: (params, opt_state,
    batch) -> (params, opt_state, metrics), as the reference's
    ``shard_map`` step.

    Parameters and state are plain tensors, the same on every rank;
    ``batch`` is the whole batch and each rank takes its rows along
    ``data_axes`` (ranks along the other axes repeat the work).  Each rank
    computes its local loss and gradients (``sh=None``), then averages the
    gradients over the data axes -- through :func:`compress_grads_int8`
    with ``opt_state["ef"]`` under ``tc.opt.compress_grads``, else as one
    float32 sum per gradient dtype divided by the rank count -- and the
    reported loss is the mean of the local losses (the reference's
    ``pmean``, not the global weighted mean).  Then ``adamw_update``."""
    group = axes_group(mesh, data_axes)
    n = dist.get_world_size(group)
    index = axes_index(mesh, data_axes)

    def step(params, opt_state, batch):
        loss, grads = value_and_grad(params, cfg, _rows(batch, index, n))
        if tc.opt.compress_grads:
            grads, ef = compress_grads_int8(grads, opt_state["ef"], group)
            opt_state = dict(opt_state, ef=ef)
        else:
            grads = _pmean(grads, group, n)
        loss = all_reduce_sum(loss, group) / n
        params, opt_state, om = adamw_update(grads, opt_state, params, tc.opt)
        return params, opt_state, {"loss": loss, **om}

    return step


def _pmean(tree: Any, group, n: int) -> Any:
    """The mean of ``tree`` over ``group``: one all-reduce a dtype over the
    leaves laid end to end, then a division by ``n`` in each leaf's dtype."""
    leaves = tree_leaves(tree)
    out = list(leaves)
    for dt in dict.fromkeys(t.dtype for t in leaves):
        idx = [i for i, t in enumerate(leaves) if t.dtype == dt]
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        all_reduce(flat, group)
        at = 0
        for i in idx:
            k = leaves[i].numel()
            out[i] = flat[at:at + k].view(leaves[i].shape) / n
            at += k
    return tree_unflatten(tree, out)


def param_spec_tree_like(opt_state: Dict[str, Any], pspecs: Any) -> Dict[str, Any]:
    """Optimizer-state specs: the moments and ``ef`` mirror the parameter
    specs; the rest (the step counter) replicates."""
    return {k: pspecs if k in ("m", "v", "ef") else tree_map(lambda _: P(), v)
            for k, v in opt_state.items()}


def place_tree(tree: Any, specs: Any, mesh) -> Any:
    """Each leaf of ``tree`` (the same full tensors on every rank) as this
    rank's DTensor shard by its spec; a 0-d leaf (the step counter) stays a
    plain tensor."""
    return tree_map(lambda t, s: place(t, mesh, placements(s, mesh)) if t.dim() else t,
                    tree, specs)


def _check_mesh(mesh) -> None:
    if mesh is not None and not hasattr(mesh, "mesh_dim_names"):
        raise TypeError(f"mesh: a torch.distributed DeviceMesh, not {type(mesh).__name__}")


def init_all(cfg: ModelConfig, tc: TrainConfig, mesh=None, *, device: DeviceLike = "cuda",
             params: Optional[Any] = None):
    """(params, opt_state, policy): parameters from ``init_params`` with
    seed ``tc.seed`` on ``device``, or ``params`` moved there (copies, so the
    caller's tree is left as it is), and fresh AdamW state.

    With a ``torch.distributed`` mesh every rank calls it: each leaf becomes
    a DTensor holding this rank's shard by :func:`param_spec_tree`, the
    moments and ``ef`` by :func:`param_spec_tree_like` (every rank draws or
    takes the same full values and keeps its shard).  The policy is
    ``make_policy(mesh)``."""
    _check_mesh(mesh)
    dev = resolve_device(device)
    if params is None:
        params = M.init_params(cfg, tc.seed, device=dev)
    else:
        params = tree_map(lambda t: t.detach().to(dev, copy=True), params)
    opt_state = adamw_init(params, tc.opt)
    sp = make_policy(mesh)
    if mesh is None:
        return params, opt_state, sp
    pspecs = param_spec_tree(params, sp)
    return (place_tree(params, pspecs, mesh),
            place_tree(opt_state, param_spec_tree_like(opt_state, pspecs), mesh), sp)


def _to_device(batch: Dict[str, Any], dev: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in batch.items()}


def train(
    cfg: ModelConfig,
    tc: TrainConfig,
    *,
    mesh=None,
    batch_fn: Optional[Callable[[int], Dict[str, np.ndarray]]] = None,
    on_step: Optional[Callable[[int, Dict[str, float]], None]] = None,
    device: DeviceLike = "cuda",
    params: Optional[Any] = None,
    dp: bool = False,
) -> Dict[str, Any]:
    """Run the loop from step 0, or from the latest checkpoint under
    ``tc.ckpt_dir``, to ``tc.steps``; returns ``{"params", "opt_state",
    "history"}``.  ``batch_fn(step)`` gives each step's batch as numpy
    arrays (default: ``make_token_batch(cfg, tc.batch, tc.seq, step=step,
    seed=tc.seed)``).  Every ``log_every`` steps and at the last, the
    metrics (``loss``, ``grad_norm``, ``lr``, ``step``, ``wall``) are read
    back as floats, appended to the history and passed to ``on_step``.

    ``mesh``: a ``torch.distributed`` mesh; every rank calls ``train``
    (``launch.mesh.run_on_mesh`` runs it on each), calls ``batch_fn(step)``
    and returns the same history; ``on_step`` runs on rank 0 alone and
    every rank takes part in each checkpoint's save.  ``dp=True`` (with a
    mesh) trains through :func:`make_dp_train_step`, parameters and state
    replicated."""
    from ..etl.batcher import make_token_batch
    from .checkpoint import latest_step, restore, save

    _check_mesh(mesh)
    dev = resolve_device(device)
    if dp and mesh is None:
        raise ValueError("dp=True needs a mesh")
    params, opt_state, sp = init_all(cfg, tc, None if dp else mesh, device=dev, params=params)
    start = 0
    if tc.ckpt_dir:
        step0 = latest_step(tc.ckpt_dir)
        if step0 is not None:
            params, opt_state, meta = restore(tc.ckpt_dir, step0, (params, opt_state))
            start = meta["step"]
    if dp:
        step_fn = make_dp_train_step(cfg, tc, mesh)
    else:
        step_fn = make_train_step(cfg, tc, sp if mesh is not None else None)
    lead = mesh is None or dist.get_rank() == 0

    history = []
    t0 = time.time()
    for step in range(start, tc.steps):
        batch = (
            batch_fn(step)
            if batch_fn is not None
            else make_token_batch(cfg, tc.batch, tc.seq, step=step, seed=tc.seed)
        )
        params, opt_state, metrics = step_fn(params, opt_state, _to_device(batch, dev))
        if step % tc.log_every == 0 or step == tc.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["wall"] = time.time() - t0
            history.append(m)
            if on_step and lead:
                on_step(step, m)
        if tc.ckpt_every and tc.ckpt_dir and (step + 1) % tc.ckpt_every == 0:
            save(tc.ckpt_dir, step + 1, params, opt_state, {"step": step + 1})
    return {"params": params, "opt_state": opt_state, "history": history}
