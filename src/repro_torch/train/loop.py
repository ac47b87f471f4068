"""The train step and the training loop, on one device.

Counterpart of ``repro.train.loop``'s mesh-free path:

  * :func:`make_train_step` -- (params, opt_state, batch) -> (params,
    opt_state, metrics): the loss and its gradients by autograd (the
    reference's ``jax.value_and_grad`` of ``loss_fn``), microbatch
    accumulation in ``accum_dtype`` when ``n_micro > 1``, then
    :func:`~repro_torch.train.optimizer.adamw_update`; remat per
    ``cfg.remat`` (:func:`repro_torch.models.model._remat`);
  * :func:`train` -- the loop: batches from ``batch_fn`` (the ETL feed)
    or the synthetic :func:`~repro_torch.etl.batcher.make_token_batch`,
    checkpoints every ``ckpt_every`` steps and a restart from the latest
    published one.

The port adds two arguments and no more: ``device`` (the card by default;
raises when there is none, as every entry point of the port does) and
``params``, starting values for the parameters (the reference draws them
from ``jax.random``, which torch cannot reproduce; tests pass the
reference's through :func:`repro_torch.core.convert.params_from_jax`).
A ``mesh``, the explicit data-parallel step (``make_dp_train_step``) and
the int8 gradient all-reduce need the model mesh (ROADMAP item 15.3): a
mesh raises.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.dmm_torch import DeviceLike, resolve_device
from ..models import model as M
from ..models.config import ModelConfig
from .optimizer import AdamWConfig, adamw_init, adamw_update
from ..core.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["TrainConfig", "value_and_grad", "make_train_step", "init_all", "train"]

MESH_ITEM = "ROADMAP item 15.3 (the model mesh)"


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


def value_and_grad(params: Any, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Any]:
    """(loss, gradients) of ``loss_fn`` at ``params``: every leaf a fresh
    leaf of the graph that requires grad, the gradients in its dtype."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    with torch.enable_grad():
        loss = M.loss_fn(tree_unflatten(params, leaves), cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(cfg: ModelConfig, tc: TrainConfig) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics), metrics
    ``{"loss", "grad_norm", "lr"}`` as float32 scalars on the device (no
    host sync).  ``batch`` holds tensors on the parameters' device.  The
    reference's ``sh`` (a sharding policy) has no counterpart."""

    def train_step(params, opt_state, batch):
        if tc.n_micro > 1:
            adt = getattr(torch, tc.accum_dtype)
            micro = _split_micro(batch, tc.n_micro)
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=adt, device=p.device), params)
            lsum = None
            for i in range(tc.n_micro):
                loss, grads = value_and_grad(params, cfg, {k: v[i] for k, v in micro.items()})
                gsum = tree_map(lambda a, g: a + g.to(adt), gsum, grads)
                lsum = loss if lsum is None else lsum + loss
            grads = tree_map(lambda g: g / tc.n_micro, gsum)
            loss = lsum / tc.n_micro
        else:
            loss, grads = value_and_grad(params, cfg, batch)
        params, opt_state, om = adamw_update(grads, opt_state, params, tc.opt)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def init_all(cfg: ModelConfig, tc: TrainConfig, mesh=None, *, device: DeviceLike = "cuda",
             params: Optional[Any] = None):
    """(params, opt_state, None): parameters from ``init_params`` with seed
    ``tc.seed`` on ``device``, or ``params`` moved there (copies, so the
    caller's tree is left as it is), and fresh AdamW state.  The third item
    stands for the reference's sharding policy; ``mesh`` must be None."""
    if mesh is not None:
        raise NotImplementedError(f"training over a mesh needs {MESH_ITEM}")
    dev = resolve_device(device)
    if params is None:
        params = M.init_params(cfg, tc.seed, device=dev)
    else:
        params = tree_map(lambda t: t.detach().to(dev, copy=True), params)
    return params, adamw_init(params, tc.opt), None


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
) -> Dict[str, Any]:
    """Run the loop from step 0, or from the latest checkpoint under
    ``tc.ckpt_dir``, to ``tc.steps``; returns ``{"params", "opt_state",
    "history"}``.  ``batch_fn(step)`` gives each step's batch as numpy
    arrays (default: ``make_token_batch(cfg, tc.batch, tc.seq, step=step,
    seed=tc.seed)``).  Every ``log_every`` steps and at the last, the
    metrics (``loss``, ``grad_norm``, ``lr``, ``step``, ``wall``) are read
    back as floats, appended to the history and passed to ``on_step``."""
    from ..etl.batcher import make_token_batch
    from .checkpoint import latest_step, restore, save

    dev = resolve_device(device)
    params, opt_state, _ = init_all(cfg, tc, mesh, device=dev, params=params)
    start = 0
    if tc.ckpt_dir:
        step0 = latest_step(tc.ckpt_dir)
        if step0 is not None:
            params, opt_state, meta = restore(tc.ckpt_dir, step0, (params, opt_state))
            start = meta["step"]
    step_fn = make_train_step(cfg, tc)

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
            if on_step:
                on_step(step, m)
        if tc.ckpt_every and tc.ckpt_dir and (step + 1) % tc.ckpt_every == 0:
            save(tc.ckpt_dir, step + 1, params, opt_state, {"step": step + 1})
    return {"params": params, "opt_state": opt_state, "history": history}
