"""The model mesh's collectives, on ``torch.distributed`` process groups.

Every collective of the sharded training path is issued here, explicitly,
with ``torch.distributed``'s plain calls (``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_reduce``, ``all_to_all_single``), never
through DTensor's own redistribution: the same code then runs on gloo
(CPU) and on NCCL (the card), and every rank issues the same calls in the
same order.  DTensors only hold the parameters' shards and placements.

  * :func:`gather` -- a DTensor's full value on this rank, differentiable:
    its backward reduce-scatters over the data axes (the data ranks'
    gradients are shares of one loss) and takes this rank's chunk over the
    others (compute over ``model`` is repeated, so its gradient is whole on
    every model rank and summing it would count it ``model``-size times);
  * :func:`full_tensor` -- the same without autograd (checkpoints);
  * :func:`place` -- this rank's shard of a full tensor, as a DTensor;
  * :func:`all_gather_rows` / :func:`all_to_all` -- activations, with
    their adjoints as backward;
  * :func:`value_with_grad` and :func:`scale_grad` -- a value with another
    tensor's gradient, and a gradient scaled.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from typing import Any, Dict, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["STATS", "axes_group", "gather", "full_tensor", "place", "all_gather_rows",
           "all_to_all", "value_with_grad", "scale_grad", "all_reduce", "all_reduce_sum",
           "barrier"]


# host seconds spent inside the collective calls of this module, and their
# count (on gloo a call returns when its data has arrived; on NCCL when it
# is enqueued on the stream)
STATS = {"calls": 0, "seconds": 0.0}


@contextlib.contextmanager
def _call():
    """Count and time one collective call.  Newer torch deprecates
    ``all_gather_into_tensor`` and ``reduce_scatter_tensor`` for names the
    card's torch lacks: the calls stay, the warning is silenced."""
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        yield
    STATS["calls"] += 1
    STATS["seconds"] += time.perf_counter() - t0


def all_reduce(x: torch.Tensor, group=None, op=None) -> torch.Tensor:
    """``dist.all_reduce`` in place (sum unless ``op``), counted in
    :data:`STATS`; returns ``x``."""
    with _call():
        dist.all_reduce(x, op=dist.ReduceOp.SUM if op is None else op, group=group)
    return x


def barrier(group=None) -> None:
    with _call():
        dist.barrier(group=group)


_GROUPS: Dict[Tuple[int, Tuple[str, ...]], Any] = {}  # (id(mesh), axes) -> group


def axes_group(mesh, axes: Sequence[str]):
    """The process group of this rank's peers along ``axes`` (one axis:
    the mesh's own group; several: one group over their product, created
    on first use by every rank of the mesh together)."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _GROUPS:
        names = tuple(mesh.mesh_dim_names)
        keep = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in keep]
        n_keep = 1
        for i in keep:
            n_keep *= mesh.size(i)
        ranks = mesh.mesh.permute(*rest, *keep).reshape(-1, n_keep).tolist()
        _GROUPS[key], _ = dist.new_subgroups_by_enumeration(ranks)
    return _GROUPS[key]


def _gather_dim(x: torch.Tensor, d: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    # the concatenated form (gloo takes no other): (n * x0, ...)
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    with _call():
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    if d == 0:
        return out
    return torch.cat(out.view(n, *x.shape).unbind(0), dim=d)


def _reduce_scatter_dim(g: torch.Tensor, d: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    parts = g.chunk(n, dim=d)
    out = torch.empty(parts[0].shape, dtype=g.dtype, device=g.device)
    with _call():
        dist.reduce_scatter_tensor(out, g.contiguous() if d == 0 else torch.cat(parts, 0),
                                   group=group)
    return out


def _plan(t, keep: Sequence[str]) -> Tuple:
    """(mesh dim, group size, tensor dim or None, this rank's index) for
    every mesh axis of ``t`` not in ``keep``, outermost first."""
    from torch.distributed.tensor import Shard

    mesh = t.device_mesh
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    out = []
    for i, pl in enumerate(t.placements):
        if names[i] in keep:
            continue
        out.append((i, mesh.size(i), pl.dim if isinstance(pl, Shard) else None, coord[i]))
    return tuple(out)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, mesh, plan, partial):
        ctx.mesh, ctx.plan, ctx.partial = mesh, plan, partial
        x = local
        for i, n, d, _ in reversed(plan):  # undo the innermost split first
            if d is not None and n > 1:
                x = _gather_dim(x, d, mesh.get_group(i))
        return x.view_as(x) if x is local else x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        for (i, n, d, c), partial in zip(ctx.plan, ctx.partial):
            if n == 1:
                continue
            group = ctx.mesh.get_group(i)
            if d is None:
                if partial:
                    g = all_reduce(g.clone(), group)
            elif partial:
                g = _reduce_scatter_dim(g, d, group)
            else:
                g = g.chunk(n, dim=d)[c].contiguous()
        return g, None, None, None


def gather(t, data_axes: Sequence[str], keep: Sequence[str] = ()) -> torch.Tensor:
    """DTensor ``t``'s full value as a plain tensor on this rank (mesh axes
    in ``keep`` stay split: this rank's part along them), through autograd:
    the gradient is summed over ``data_axes`` and taken as it is over the
    other axes (see the module docstring)."""
    plan = _plan(t, keep)
    names = tuple(t.device_mesh.mesh_dim_names)
    partial = tuple(names[i] in data_axes for i, _, _, _ in plan)
    return _Gather.apply(t.to_local(), t.device_mesh, plan, partial)


@torch.no_grad()
def full_tensor(t) -> torch.Tensor:
    """DTensor ``t``'s full value on this rank (a collective: every rank
    of its mesh calls it)."""
    x = t.to_local()
    for i, n, d, _ in reversed(_plan(t, ())):
        if d is not None and n > 1:
            x = _gather_dim(x, d, t.device_mesh.get_group(i))
    return x


def place(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of ``full`` (the same tensor on every rank) as a
    DTensor placed by ``placements``; no communication."""
    from torch.distributed.tensor import DTensor, Shard

    coord = mesh.get_coordinate()
    x = full
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard) and mesh.size(i) > 1:
            x = x.chunk(mesh.size(i), dim=pl.dim)[coord[i]]
    return DTensor.from_local(x.contiguous(), mesh, placements, run_check=False,
                              shape=full.shape, stride=full.contiguous().stride())


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_dim(x, 0, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_dim(g.contiguous(), 0, ctx.group), None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The group's ``x`` concatenated along dim 0 in group-rank order; the
    backward sums each rank's gradient of the whole into its own rows."""
    return _AllGatherRows.apply(x, group)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)  # contiguous, whatever x is
    with _call():
        dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk ``j`` of ``x`` (equal chunks along dim 0) to group rank ``j``;
    chunk ``j`` of the result came from rank ``j`` (the reference's
    non-tiled ``all_to_all``, split and concat on axis 0).  Its own
    adjoint is the backward."""
    return _AllToAll.apply(x, group)


class _ValueWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, share):
        return value.detach().clone()

    @staticmethod
    def backward(ctx, g):
        return None, g


def value_with_grad(value: torch.Tensor, share: torch.Tensor) -> torch.Tensor:
    """``value``'s bits with ``share``'s gradient."""
    return _ValueWithGrad.apply(value, share)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def scale_grad(x: torch.Tensor, factor: float) -> torch.Tensor:
    """``x`` unchanged; its gradient multiplied by ``factor``."""
    return _ScaleGrad.apply(x, factor)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, a new tensor (no autograd)."""
    return all_reduce(x.detach().clone(), group)
