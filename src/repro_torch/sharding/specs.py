"""Parameter and input sharding specs for every architecture family.

Counterpart of ``repro.sharding.specs``.  The scheme (single-pod (data,
model) = (16, 16); multi-pod adds a leading ``pod`` axis folded into the
data-parallel group):

  * TP: the second (output) dim of projection weights over ``model``;
    vocab over ``model``; MoE experts over ``model`` (EP == TP axis);
  * FSDP/ZeRO-3: the first (input) dim of projection weights over
    ``data``: parameters and optimizer state are fully sharded;
  * inputs: batch over (pod, data).

Every rule is divisibility-guarded: a dim that does not divide by the axis
size is replicated.

A spec is a :class:`P`, a tuple with one entry per tensor dim: ``None``
(replicated), an axis name, or a tuple of axis names -- entry for entry
the reference's ``PartitionSpec``.  The port keeps ``params["layers"]``
(and ``enc_layers``) as a list of per-layer dicts where the reference
stacks them on a leading L axis, so a layer leaf's spec here is the
reference's without its leading ``None``.

In the port a spec decides *storage*: :func:`placements` turns it into
DTensor placements over a ``torch.distributed`` :class:`DeviceMesh`, and
:meth:`ShardingPolicy.gather` rebuilds the full tensor where the layer
loop needs it.  Compute is data-parallel (the batch over the data axes,
repeated on each ``model`` rank), so the reference's activation
constraints (``act_*``, ``logits``) return their input unchanged: they
only steer GSPMD's placement of the same values.  Splitting the products
over ``model`` is ROADMAP queue 2 item G.
"""

from __future__ import annotations

import dataclasses
import re
import sys
from typing import Any, Optional, Sequence, Tuple

import torch

from ..core.tree import tree_map
from .comm import axes_group, gather

__all__ = [
    "P",
    "ShardingPolicy",
    "make_policy",
    "param_spec_tree",
    "lax_axis_size",
    "placements",
    "axis_names",
    "is_dtensor",
    "axes_index",
]


def is_dtensor(t: Any) -> bool:
    """Whether ``t`` is a DTensor (without importing the DTensor module,
    which a mesh-free run never needs)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"), None)``.
    A one-name tuple entry is kept as the bare name, as ``PartitionSpec``
    keeps it: ``P(("data",)) == P("data")``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names: a :class:`DeviceMesh`'s ``mesh_dim_names``,
    or ``axis_names`` of a stand-in with a ``shape`` dict (the tests' and
    the reference's fake meshes)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def lax_axis_size(mesh_or_group, axes=None) -> int:
    """The size of a mesh axis (or the product over a tuple of axes), or of
    a process group when ``axes`` is None: the port's ``lax.axis_size``."""
    if axes is None:
        return torch.distributed.get_world_size(mesh_or_group)
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= _axis_size(mesh_or_group, a)
    return n


def _axis_size(mesh, name: str) -> int:
    if hasattr(mesh, "mesh_dim_names"):
        return mesh.size(axis_names(mesh).index(name))
    return mesh.shape[name]


@dataclasses.dataclass
class ShardingPolicy:
    mesh: Optional[Any]
    model_axis: str = "model"
    data_axis: str = "data"
    pod_axis: Optional[str] = None  # set on the multi-pod mesh

    # ---- axis helpers --------------------------------------------------------
    @property
    def data_axes(self) -> Tuple[str, ...]:
        """The data-parallel axes (pod folds into DP)."""
        if self.pod_axis:
            return (self.pod_axis, self.data_axis)
        return (self.data_axis,)

    def axis_size(self, name: str) -> int:
        if self.mesh is None:
            return 1
        return _axis_size(self.mesh, name)

    def _fits(self, dim: int, axis) -> bool:
        if self.mesh is None:
            return False
        if isinstance(axis, tuple):
            size = 1
            for a in axis:
                size *= self.axis_size(a)
        else:
            size = self.axis_size(axis)
        return dim % size == 0 and dim >= size

    def dim(self, dim_size: int, axis):
        """axis name if it divides dim_size, else None (replicate)."""
        return axis if self._fits(dim_size, axis) else None

    # ---- activation constraints: identities (compute is data-parallel) -------
    def act_btd(self, x):
        """(B, S, D) residual stream.  The reference pins batch over DP;
        here each rank holds its own batch rows already: returns ``x``."""
        return x

    def act_ff(self, x):
        """(..., F) MLP hidden.  The reference shards F over model; the
        port computes it whole on each model rank: returns ``x``."""
        return x

    def act_heads(self, x):
        """(B, S, H*hd) attention output: returns ``x`` (see :meth:`act_ff`)."""
        return x

    def act_expert_ff(self, x):
        """(E, C, F) expert hidden: returns ``x`` (see :meth:`act_ff`)."""
        return x

    def logits(self, x):
        """(B, S, V) logits: returns ``x`` (see :meth:`act_ff`)."""
        return x

    def batch_spec(self, ndim: int) -> P:
        """Input batch arrays: leading dim over DP."""
        return P(self.data_axes, *([None] * (ndim - 1)))

    # ---- the port's data-parallel compute over sharded storage ---------------
    @property
    def sharded(self) -> bool:
        """True under a ``torch.distributed`` mesh (not a stand-in)."""
        return self.mesh is not None and hasattr(self.mesh, "mesh_dim_names")

    def data_index(self) -> int:
        """This rank's position along the data axes (pod-major)."""
        return axes_index(self.mesh, self.data_axes)

    def data_size(self) -> int:
        return lax_axis_size(self.mesh, self.data_axes)

    def data_group(self):
        """The process group of this rank's data-parallel peers."""
        return axes_group(self.mesh, self.data_axes)

    def model_group(self):
        return self.mesh.get_group(self.model_axis)

    def gather(self, tree: Any, keep: Sequence[str] = ()) -> Any:
        """Each DTensor leaf of ``tree`` as a plain full tensor on this rank
        (other leaves as they are), through autograd: the backward sums the
        data ranks' gradients into each shard (a reduce-scatter) and takes
        the model ranks' gradient as it is, since compute over ``model`` is
        repeated, not split (:func:`repro_torch.sharding.comm.gather`).
        Mesh axes in ``keep`` stay split (expert parallelism keeps the
        experts over ``model``)."""
        return tree_map(lambda t: gather(t, self.data_axes, keep) if is_dtensor(t) else t, tree)


def axes_index(mesh, axes: Sequence[str]) -> int:
    """This rank's position along ``axes`` of a ``torch.distributed`` mesh,
    the first axis major."""
    coord = mesh.get_coordinate()
    names = axis_names(mesh)
    idx = 0
    for a in axes:
        i = names.index(a)
        idx = idx * mesh.size(i) + coord[i]
    return idx


def make_policy(mesh) -> ShardingPolicy:
    if mesh is None:
        return ShardingPolicy(mesh=None)
    pod = "pod" if "pod" in axis_names(mesh) else None
    return ShardingPolicy(mesh=mesh, pod_axis=pod)


def placements(spec: Sequence, mesh) -> list:
    """DTensor placements over ``mesh`` for ``spec``: mesh axis ``a`` is
    ``Shard(d)`` when entry ``d`` of the spec names ``a`` (alone or in a
    tuple), else ``Replicate()``.  An axis in a tuple entry shards that dim
    in the tuple's order, major first, as a ``PartitionSpec`` does."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(a)] = Shard(d)
    return out


# ---------------------------------------------------------------------------
# Parameter spec tree: rules keyed on (path, shape)
# ---------------------------------------------------------------------------

# path-suffix regex -> role
_RULES = [
    # embeddings
    (r"embed/tok$", "vocab_in"),
    (r"embed/head$", "vocab_out"),
    (r"embed/pos$", "replicate"),
    # rwkv time-mix: 40 heads do not divide a 16-wide model axis;
    # FSDP-only: weights shard over data
    (r"tm/w[rkvgo]$", "fsdp_first"),
    (r"cm/wr$", "fsdp_first"),  # channel-mix gate multiplies a replicated kv
    # attention / generic 2D projections: in-dim FSDP, out-dim TP
    (r"(wq|wk|wv|w_in|w_gate|in_proj)$", "proj_out_tp"),
    (r"(wo|w_out|out_proj)$", "proj_in_tp"),
    # rwkv
    (r"(wr|wg)$", "proj_out_tp"),
    (r"wA$", "fsdp_first"),
    (r"wB$", "fsdp_last"),
    # moe
    (r"router$", "fsdp_first"),
    # mamba
    (r"conv_w$", "last_tp"),
    (r"x_proj$", "first_tp"),
    (r"dt_proj$", "last_tp"),
    (r"A_log$", "first_tp"),
    # norms / scalars / biases
    (r".*", "replicate"),
]


def _spec_for(path: str, shape: Tuple[int, ...], sp: ShardingPolicy, n_stack: int = 0) -> P:
    """n_stack: number of leading stacked-layer dims to skip (None spec);
    0 for the port's per-layer leaves."""
    core = shape[n_stack:]
    lead = [None] * n_stack
    role = "replicate"
    for pat, r in _RULES:
        if re.search(pat, path):
            role = r
            break
    d, m = sp.data_axes, sp.model_axis  # FSDP folds the pod axis in
    is_expert = bool(re.search(r"(w_in|w_gate|w_out)$", path)) and len(core) == 3

    if is_expert:  # (E, D, F) / (E, F, D): experts over model, in-dim FSDP
        e, a, _ = core
        return P(*lead, sp.dim(e, m), sp.dim(a, d), None)
    if role == "vocab_in" and len(core) == 2:  # (V, D)
        return P(*lead, sp.dim(core[0], m), sp.dim(core[1], d))
    if role == "vocab_out" and len(core) == 2:  # (D, V)
        return P(*lead, sp.dim(core[0], d), sp.dim(core[1], m))
    if role == "proj_out_tp" and len(core) == 2:  # (D_in, D_out)
        return P(*lead, sp.dim(core[0], d), sp.dim(core[1], m))
    if role == "proj_in_tp" and len(core) == 2:  # (D_in, D_out) contracting TP
        return P(*lead, sp.dim(core[0], m), sp.dim(core[1], d))
    if role == "fsdp_first" and len(core) >= 1:
        return P(*lead, sp.dim(core[0], d), *([None] * (len(core) - 1)))
    if role == "fsdp_last" and len(core) >= 1:
        return P(*lead, *([None] * (len(core) - 1)), sp.dim(core[-1], d))
    if role == "first_tp" and len(core) >= 1:
        return P(*lead, sp.dim(core[0], m), *([None] * (len(core) - 1)))
    if role == "last_tp" and len(core) >= 1:
        return P(*lead, *([None] * (len(core) - 1)), sp.dim(core[-1], m))
    return P(*lead, *([None] * len(core)))


def param_spec_tree(params_shape: Any, sp: ShardingPolicy) -> Any:
    """A tree of :class:`P` mirroring a port parameter tree (or any tree of
    that structure whose leaves have a ``shape``).  A leaf's path joins its
    dict keys with ``/``, the layer lists' indices left out
    (``layers/attn/wq``), so every rule sees the reference's path."""

    def walk(node: Any, path: Tuple[str, ...]) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, (*path, str(k))) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path) for v in node]
        return _spec_for("/".join(path), tuple(getattr(node, "shape", ())), sp)

    return walk(params_shape, ())
