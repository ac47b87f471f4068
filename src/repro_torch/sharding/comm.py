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

:data:`STATS` counts the calls, their host seconds and their bytes by kind
(``all-gather``, ``reduce-scatter``, ``all-reduce``, ``all-to-all``): the
result bytes of each call on this rank, the convention of the reference's
``collective_bytes``.  A call over a :class:`DryGroup` stand-in reaches
no ``torch.distributed``: the dry run (:mod:`repro_torch.launch.
dryrun_lib`) counts the collectives of a step that way.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["STATS", "reset_stats", "DryGroup", "group_size", "axes_group", "gather_plan",
           "gather", "gather_local", "full_tensor", "place", "all_gather_rows", "all_to_all",
           "value_with_grad", "scale_grad", "all_reduce", "all_reduce_sum", "barrier"]


# the collective calls of this module: their count, the host seconds spent
# inside them (on gloo a call returns when its data has arrived; on NCCL when
# it is enqueued on the stream) and their result bytes by kind
STATS: Dict[str, Any] = {"calls": 0, "seconds": 0.0, "bytes": {}}


def reset_stats() -> None:
    STATS.update(calls=0, seconds=0.0, bytes={})


class DryGroup:
    """A process group stand-in of ``n`` ranks.  A collective over it
    reaches neither ``torch.distributed`` nor :data:`STATS`: its result
    tensor keeps the shape it was allocated with, and ``hook(kind, result,
    args)`` sees the call (``args`` its positional arguments, the tensors it
    would read among them): the dry run's count."""

    def __init__(self, n: int, hook: Optional[Callable[[str, torch.Tensor, tuple], None]] = None):
        self.n = n
        self.hook = hook

    def size(self) -> int:
        return self.n


def group_size(group) -> int:
    """The rank count of ``group`` (a process group, None for the world, or
    a :class:`DryGroup`)."""
    return group.size() if isinstance(group, DryGroup) else dist.get_world_size(group)


def _issue(kind: str, result: Optional[torch.Tensor], fn: Callable, *args, group=None,
           **kwargs) -> None:
    """Issue one collective call ``fn(*args, group=group, **kwargs)``,
    counted in :data:`STATS` with ``result``'s bytes under ``kind`` (over a
    :class:`DryGroup`, only its hook sees it).  Newer torch deprecates
    ``all_gather_into_tensor`` and ``reduce_scatter_tensor`` for names the
    card's torch lacks: the calls stay, the warning is silenced."""
    if isinstance(group, DryGroup):
        if group.hook is not None:
            group.hook(kind, result, args)
        return
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        fn(*args, group=group, **kwargs)
    STATS["calls"] += 1
    STATS["seconds"] += time.perf_counter() - t0
    if result is not None:
        STATS["bytes"][kind] = STATS["bytes"].get(kind, 0) + result.numel() * result.element_size()


def all_reduce(x: torch.Tensor, group=None, op=None) -> torch.Tensor:
    """``dist.all_reduce`` in place (sum unless ``op``), counted in
    :data:`STATS`; returns ``x``."""
    _issue("all-reduce", x, dist.all_reduce, x,
           op=dist.ReduceOp.SUM if op is None else op, group=group)
    return x


def barrier(group=None) -> None:
    _issue("barrier", None, dist.barrier, group=group)


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
    n = group_size(group)
    # the concatenated form (gloo takes no other): (n * x0, ...)
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    _issue("all-gather", out, dist.all_gather_into_tensor, out, x.contiguous(), group=group)
    if d == 0:
        return out
    return torch.cat(out.view(n, *x.shape).unbind(0), dim=d)


def _reduce_scatter_dim(g: torch.Tensor, d: int, group) -> torch.Tensor:
    n = group_size(group)
    parts = g.chunk(n, dim=d)
    out = torch.empty(parts[0].shape, dtype=g.dtype, device=g.device)
    _issue("reduce-scatter", out, dist.reduce_scatter_tensor, out,
           g.contiguous() if d == 0 else torch.cat(parts, 0), group=group)
    return out


def gather_plan(placements: Sequence, sizes: Sequence[int], names: Sequence[str],
         coord: Sequence[int], keep: Sequence[str] = ()) -> Tuple:
    """(mesh dim, group size, tensor dim or None, this rank's index) for
    every mesh axis not in ``keep``, outermost first: how :func:`gather`
    rebuilds a tensor placed by ``placements`` over a mesh of axis
    ``sizes`` and ``names``, on the rank at ``coord``."""
    from torch.distributed.tensor import Shard

    return tuple((i, sizes[i], pl.dim if isinstance(pl, Shard) else None, coord[i])
                 for i, pl in enumerate(placements) if names[i] not in keep)


def _plan(t, keep: Sequence[str]) -> Tuple:
    mesh = t.device_mesh
    return gather_plan(t.placements, [mesh.size(i) for i in range(mesh.ndim)],
                tuple(mesh.mesh_dim_names), mesh.get_coordinate(), keep)


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
    return gather_local(t.to_local(), t.device_mesh, _plan(t, keep),
                        tuple(t.device_mesh.mesh_dim_names), data_axes)


def gather_local(local: torch.Tensor, mesh, plan: Tuple, names: Sequence[str],
                 data_axes: Sequence[str]) -> torch.Tensor:
    """:func:`gather` of a shard ``local`` by its :func:`gather_plan` over
    ``mesh``, whose ``get_group(i)`` gives mesh dim ``i``'s group (a
    :class:`DryGroup` in the dry run)."""
    partial = tuple(names[i] in data_axes for i, _, _, _ in plan)
    return _Gather.apply(local, mesh, plan, partial)


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
    _issue("all-to-all", out, dist.all_to_all_single, out, x.contiguous(), group=group)
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
