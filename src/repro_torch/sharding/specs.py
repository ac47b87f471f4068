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
DTensor placements over a ``torch.distributed`` :class:`DeviceMesh`.
Compute follows the reference's activation constraints: the batch is
split over the data axes, and the MLP hidden, the attention heads and the
vocabulary over ``model`` (Megatron's column- and row-split products).
:meth:`ShardingPolicy.gather_layer` gathers a layer's leaves over the data
axes and keeps the ``model`` split that the spec gives, so each rank holds
column slices (D, D_out/M) of ``wq``/``wk``/``wv``/``w_in``/``w_gate`` and
row slices (D_in/M, D) of ``wo``/``w_out``; :meth:`ShardingPolicy.
tensor_split` states which parts split (:class:`TensorSplit`, one rule
for the real step and the dry run).  The reference's ``act_*`` and
``logits`` constraints then have nothing to move: each rank's tensor is
already its slice, and they return their input.

The reference's ``dmm_table_sharding`` (an XLA ``NamedSharding`` of the
sharded mapping engine's block table over ``data``) has no counterpart
here: the port's sharded engine places shard ``s`` of the table on
``devices[s]`` of :func:`repro_torch.launch.mesh.make_etl_mesh`.
"""

from __future__ import annotations

import dataclasses
import re
import sys
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..core.tree import tree_map
from .comm import axes_group, gather

__all__ = [
    "P",
    "ShardingPolicy",
    "TensorSplit",
    "make_policy",
    "param_spec_tree",
    "lax_axis_size",
    "placements",
    "axis_names",
    "is_dtensor",
    "axes_index",
    "decode_state_specs",
    "local_shape",
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


@dataclasses.dataclass(frozen=True)
class TensorSplit:
    """How one rank's compute splits over ``model`` (``size`` ranks, this
    rank ``rank``), for a model config.  The rule, stated once here:

      * ``heads``: attention splits its query heads when ``n_heads`` divides
        by the axis (whole heads: a hand-written split cannot cut a head,
        where the reference's guard only asks that H * hd divide).  Then
        ``wq`` and ``wo`` are split leaves, and ``kv`` says whether the KV
        heads split too (``n_kv_heads`` divides); when they do not,
        ``wk``/``wv`` are gathered whole over ``model`` and each rank keeps
        the KV heads its query heads read (head ``h // n_rep``).  When the
        query heads do not divide, the layer's attention gathers its four
        projections whole and every rank repeats it;
      * ``ff``: the MLP (and RWKV's channel mix) splits its hidden when
        ``d_ff`` divides (exactly when the spec stores ``w_in``/``w_gate``/
        ``w_out``, or the channel mix's ``wk``, split);
      * ``vocab``: the embedding rows, the head's columns and the loss split
        when the padded vocabulary divides (exactly when the spec stores
        them split);
      * ``mamba``: a hybrid layer's Mamba splits its inner width Di when it
        divides (the spec then stores ``conv_w``, ``x_proj``, ``dt_proj``,
        ``A_log`` and ``out_proj`` split on Di);
      * ``wkv``: RWKV's time mix splits its heads when ``n_rwkv_heads``
        divides (its projections stay whole: the spec stores them over
        ``data`` alone);
      * decode's KV cache (:meth:`kv_cache`): over the heads when ``kv``,
        else over its time axis when its length divides, else whole.

    The MoE experts are not split here: they are gathered whole (they stay
    split under ``ep``)."""

    size: int
    rank: int
    heads: bool
    kv: bool
    ff: bool
    vocab: bool
    mamba: bool = False
    wkv: bool = False

    def kv_heads(self, n_heads: int, n_kv_heads: int) -> Tuple[Sequence[int], int]:
        """(the KV heads this rank's query heads read, in order, and how
        many adjacent query heads share each) when the query heads split:
        this rank's query heads are ``rank * H/M`` to ``(rank + 1) * H/M``
        and head ``h`` reads KV head ``h // n_rep``.  A share that is not
        uniform gives one KV head a query head, repeated as needed."""
        hl, n_rep = n_heads // self.size, n_heads // n_kv_heads
        first = self.rank * hl
        idx = [(first + j) // n_rep for j in range(hl)]
        heads = sorted(set(idx))
        rep = hl // len(heads)
        if rep * len(heads) == hl and idx == [h for h in heads for _ in range(rep)]:
            return heads, rep
        return idx, 1

    def kv_cache(self, length: int) -> str:
        """How a decode KV cache of ``length`` slots splits (the reference's
        ``decode_state_specs``): ``"heads"`` when the KV heads divide (the
        attention then splits as in training), ``"time"`` when the length
        does (rank ``r`` holds slots ``r * T/M`` to ``(r + 1) * T/M`` of
        every KV head), else ``"whole"`` (attention repeated)."""
        if self.kv:
            return "heads"
        return "time" if length % self.size == 0 and length >= self.size else "whole"

    def part(self, whole: int) -> slice:
        """This rank's slice of a dim of ``whole`` split in ``size`` parts."""
        n = whole // self.size
        return slice(self.rank * n, (self.rank + 1) * n)


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

    # ---- activation constraints: identities (each rank already holds its slice)
    def act_btd(self, x):
        """(B, S, D) residual stream.  The reference pins batch over DP;
        here each rank holds its own batch rows already: returns ``x``."""
        return x

    def act_ff(self, x):
        """(..., F/M) MLP hidden.  The reference shards F over model; here
        the column-split ``w_in``/``w_gate`` give each rank its F/M slice
        already (:meth:`tensor_split`): returns ``x``."""
        return x

    def act_heads(self, x):
        """(B, S, H/M * hd) attention output: each rank's query heads
        already (whole heads; see :class:`TensorSplit`): returns ``x``."""
        return x

    def act_expert_ff(self, x):
        """(E/M, C, F) expert hidden: under ``ep`` each rank runs its own
        experts already: returns ``x``."""
        return x

    def logits(self, x):
        """(B, S, V/M) logits: the vocab-split head gives each rank its
        columns already: returns ``x``."""
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

    def model_index(self) -> int:
        """This rank's position along ``model``."""
        return axes_index(self.mesh, (self.model_axis,))

    def data_rows(self, batch: int) -> slice:
        """This data rank's rows of a batch of ``batch`` rows: its share
        when the batch divides over the data axes (the reference's batch
        rule), else every row (each data rank then repeats the batch)."""
        if not self.sharded or not self._fits(batch, self.data_axes):
            return slice(0, batch)
        n = batch // self.data_size()
        return slice(self.data_index() * n, (self.data_index() + 1) * n)

    def tensor_split(self, cfg) -> Optional[TensorSplit]:
        """How compute splits over ``model`` for ``cfg`` (:class:`TensorSplit`),
        or None off a mesh or on a ``model`` axis of one rank."""
        if not self.sharded:
            return None
        m = self.axis_size(self.model_axis)
        if m == 1:
            return None
        fits = lambda n: self._fits(n, self.model_axis)  # noqa: E731
        return TensorSplit(size=m, rank=self.model_index(),
                           heads=fits(cfg.n_heads), kv=fits(cfg.n_kv_heads),
                           ff=fits(cfg.d_ff), vocab=fits(cfg.vocab_padded),
                           mamba=cfg.family == "hybrid" and fits(cfg.d_model),
                           wkv=cfg.family == "ssm" and fits(cfg.n_rwkv_heads))

    def split_group(self, cfg, part: str):
        """The ``model`` group when :meth:`tensor_split` splits ``part``
        (``"heads"``, ``"ff"``, ``"vocab"``, ``"mamba"`` or ``"wkv"``) of
        ``cfg``, else None."""
        ts = self.tensor_split(cfg)
        return self.model_group() if ts is not None and getattr(ts, part) else None

    def gather(self, tree: Any, keep: Sequence[str] = (), summed: Sequence[str] = ()) -> Any:
        """Each DTensor leaf of ``tree`` as a plain tensor on this rank
        (other leaves as they are), through autograd: whole, except along
        the mesh axes in ``keep``, which stay split.  The backward sums the
        data ranks' gradients into each shard (a reduce-scatter), and those
        of the axes in ``summed`` (a leaf gathered whole for a computation
        split over them); over the other axes compute is repeated and the
        gradient is taken as it is (:func:`repro_torch.sharding.comm.
        gather`)."""
        axes = (*self.data_axes, *summed)
        return tree_map(lambda t: gather(t, axes, keep) if is_dtensor(t) else t, tree)

    def model_dim(self, t: Any) -> Optional[int]:
        """The dim of leaf ``t`` that its placement splits over ``model``,
        or None."""
        pl = t.placements[axis_names(self.mesh).index(self.model_axis)]
        return getattr(pl, "dim", None)

    def gather_layer(self, lp: Any, cfg, caches: Optional[Dict[str, str]] = None) -> Any:
        """One layer's (or encoder layer's) weights for its compute on this
        rank, by :meth:`tensor_split`'s rule: the split leaves gathered over
        the data axes alone (column slices of ``wq``/``wk``/``wv``/``w_in``/
        ``w_gate``, row slices of ``wo``/``w_out``), ``wk``/``wv`` whole
        with their gradient summed over ``model`` when the KV heads do not
        split, under ``ep`` each rank's own experts, the SSM parts as
        :meth:`_gather_mamba` and :meth:`_gather_rwkv` say, the rest whole.
        ``caches``: in decode, how each attention block's cache splits
        (``{"attn": ..., "xattn": ...}``, :meth:`TensorSplit.kv_cache`); a
        ``"time"`` cache takes ``wq``/``wk``/``wv`` whole and ``wo``'s rows
        of this rank's query heads where they split, a ``"whole"`` one every
        projection whole.  A leaf the rule splits whose spec does not split
        it so raises."""
        ts = self.tensor_split(cfg)
        if ts is None:
            return self.gather(lp)
        m = (self.model_axis,)
        out = {}
        for name, block in lp.items():
            if name in ("attn", "xattn"):
                mode = (caches or {}).get(name, "heads" if ts.heads else "whole")
                out[name] = self._gather_attn(block, ts, mode)
            elif name == "mlp" and ts.ff:
                out[name] = {k: self.gather_split(v, self._split_dim(k), k)
                             for k, v in block.items()}
            elif name == "moe" and cfg.moe_impl == "ep":
                out[name] = {k: self.gather(v, keep=() if k == "router" else m)
                             for k, v in block.items()}
            elif name == "mamba" and ts.mamba:
                out[name] = self._gather_mamba(block, ts, cfg.d_model)
            elif name in ("tm", "cm"):
                out[name] = self._gather_rwkv(name, block, ts, cfg.d_ff)
            else:
                out[name] = self.gather(block)
        return out

    def _gather_attn(self, block: Any, ts: TensorSplit, mode: str) -> Any:
        m = (self.model_axis,)
        if mode == "heads":
            return {k: self.gather_split(v, self._split_dim(k), k)
                    if k in ("wq", "wo") or ts.kv else self.gather(v, summed=m)
                    for k, v in block.items()}
        if mode == "time":  # decode alone (no gradient): every head's q, k, v
            return {k: self.gather_split(v, 0, k) if k == "wo" and ts.heads else self.gather(v)
                    for k, v in block.items()}
        if mode != "whole":
            raise ValueError(f"attention split {mode!r}: expected 'heads', 'time' or 'whole'")
        return self.gather(block)

    def _gather_mamba(self, block: Any, ts: TensorSplit, di: int) -> Any:
        """Mamba over this rank's Di/M inner channels: ``conv_w``,
        ``dt_proj`` (columns), ``x_proj``, ``A_log``, ``out_proj`` (rows)
        keep their ``model`` slices.  ``in_proj`` (D, 2 Di) is stored as
        contiguous 2 Di/M columns, which hold x alone on the first ranks and
        z alone on the others: it is gathered whole, its gradient summed
        over ``model``, and this rank takes its columns of x and the same of
        z.  ``dt_bias`` and ``D``, replicated, are sliced likewise."""
        m = (self.model_axis,)
        mine = ts.part(di)
        out = {}
        for k, v in block.items():
            if k in ("conv_w", "dt_proj"):
                out[k] = self.gather_split(v, 1, k)
            elif k in ("x_proj", "A_log", "out_proj"):
                out[k] = self.gather_split(v, 0, k)
            elif k == "in_proj":
                w = self.gather(v, summed=m)
                out[k] = torch.cat([w[:, mine], w[:, di + mine.start:di + mine.stop]], dim=1)
            else:  # dt_bias, D
                out[k] = self.gather(v, summed=m)[mine]
        return out

    def _gather_rwkv(self, name: str, block: Any, ts: TensorSplit, d_ff: int) -> Any:
        """RWKV's time mix (``tm``) when its heads split: every leaf whole
        (the spec stores the projections over ``data`` alone), its gradient
        summed over ``model`` since each rank computes only its heads from
        them.  The channel mix (``cm``) when its hidden splits: ``wk``'s
        F/M columns kept; ``wv`` (F, D), which the spec splits on D, is
        gathered whole (gradient summed) and this rank takes its F/M rows;
        ``wr`` and ``mu`` whole."""
        m = (self.model_axis,)
        if name == "tm" and ts.wkv:
            return self.gather(block, summed=m)
        if name == "cm" and ts.ff:
            return {k: self.gather_split(v, 1, k) if k == "wk"
                    else self.gather(v, summed=m)[ts.part(d_ff)] if k == "wv"
                    else self.gather(v) for k, v in block.items()}
        return self.gather(block)

    @staticmethod
    def _split_dim(name: str) -> int:
        """Row slices (D_in/M, D) of ``wo``/``w_out``, column slices (D,
        D_out/M) of the other projections."""
        return 0 if name in ("wo", "w_out") else 1

    def gather_split(self, t: Any, dim: int, name: str = "leaf") -> Any:
        """Leaf ``t`` gathered over the data axes, its ``model`` split on
        ``dim`` kept (this rank's slice); raises when its placement does
        not split ``dim`` over ``model``."""
        got = self.model_dim(t)
        if got != dim:
            raise ValueError(f"{name}: the tensor split needs it split over "
                             f"{self.model_axis!r} on dim {dim}, its spec splits dim {got}")
        return self.gather(t, keep=(self.model_axis,))


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


def decode_state_specs(cfg, sp: ShardingPolicy, state: Any) -> Any:
    """Specs of the serving cache tree (``models.model.init_decode_state``),
    the reference's ``decode_state_specs`` leaf by leaf.

    KV caches (L, B, T, KV, hd): batch over DP; KV heads over model when
    divisible, otherwise the *time* axis over model (:meth:`TensorSplit.
    kv_cache`).  RWKV's ``wkv`` over its heads, Mamba's ``h`` and ``conv``
    over Di, each where it divides.  The port's ``pos`` is a host int; its
    spec is the reference's int32 scalar's, ``P()``."""
    dp = sp.data_axes
    m = sp.model_axis

    def spec(name: str, shp) -> P:
        if name == "pos":
            return P()
        b = dp if len(shp) > 1 and sp.dim(shp[1], dp) else None
        if name in ("k", "v", "xk", "xv"):  # (L, B, T, KV, hd)
            if sp.dim(shp[3], m):
                return P(None, b, None, m, None)
            return P(None, b, sp.dim(shp[2], m), None, None)
        if name == "wkv":  # (L, B, H, hd, hd)
            return P(None, b, sp.dim(shp[2], m), None, None)
        if name in ("x_tm", "x_cm"):  # (L, B, 1, D)
            return P(None, b, None, None)
        if name == "h":  # mamba (L, B, Di, N)
            return P(None, b, sp.dim(shp[2], m), None)
        if name == "conv":  # (L, B, 3, Di)
            return P(None, b, None, sp.dim(shp[3], m))
        return P(*([None] * len(shp)))

    def walk(node: Any, name: str) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return spec(name, tuple(getattr(node, "shape", ())))

    return walk(state, "")


def local_shape(shape: Sequence[int], spec: Sequence, sp: ShardingPolicy) -> Tuple[int, ...]:
    """``shape`` divided along every dim ``spec`` shards, by the axis sizes
    of ``sp``'s mesh: one rank's shard."""
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in (() if entry is None else entry if isinstance(entry, tuple) else (entry,)):
            out[d] //= sp.axis_size(a)
    return tuple(out)


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
