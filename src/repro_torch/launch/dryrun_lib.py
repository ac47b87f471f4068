"""Dry run of one (arch x shape x mesh) cell, on shapes alone.

Counterpart of ``repro.launch.dryrun_lib``.  The reference lowers and
compiles each cell with XLA over placeholder devices and reads the
compiled program's memory and cost analyses.  The port has no compiler to
ask: it traces one step of its own code on the ``meta`` device, where a
tensor has a shape, a dtype and no storage, so nothing is allocated
whatever the model's size, and counts what the step does as it runs.

The step is the port's own: ``make_train_step`` for train,
``forward`` for prefill, ``decode_step`` and an argmax for decode.  Kernel
wrappers cannot run on meta tensors, so the trace takes the plain
versions, as the reference's dry run does on its CPU backend; a cell with
``attn_impl="pallas"`` is refused with a message, not counted silently
through another path.

The port's scheme, which the per-device numbers follow (not the
reference's GSPMD program):

  * parameters and optimizer state are stored as
    :func:`~repro_torch.sharding.specs.param_spec_tree` shards them;
  * train and prefill gather each layer's weights whole before using them
    (:func:`repro_torch.sharding.comm.gather`), split the batch over the
    data axes and repeat the whole step on each ``model`` rank, so a
    device's flops are its data rank's share of the batch at full width,
    not a 1/256 slice of the step;
  * decode has no mesh path yet: its trace is one device's
    ``decode_step`` over a data rank's rows, with whole weights.

Per cell, every number per device:

  * ``memory``: ``argument_bytes`` -- parameters, optimizer state and the
    batch (train), parameters and the batch (prefill), or parameters, the
    decode state and the token (decode), each leaf divided along every
    dimension its spec shards (the batch by the reference's data-parallel
    rule); ``output_bytes`` and ``alias_bytes`` -- the outputs stored by
    the same specs (the prefill logits by the reference's logits spec),
    with the reference's donation (train donates parameters and state,
    decode the state) and, for a tuple of outputs, the reference's 8 bytes
    an output of its tuple's index table; ``temp_bytes`` -- the peak of
    live tensors that the traced step itself allocated (gathered weights,
    activations, gradients, new parameters and moments);
  * ``cost``: ``flops`` by the rules of :class:`torch.utils.flop_counter.
    FlopCounterMode` (its ``flop_registry``: matrix products, attention and
    convolutions, what the 6ND convention counts; the trace applies them
    itself, the same count as the mode's), ``bytes_accessed`` the operand
    and result bytes of every aten operation but views (which move none),
    ``transcendentals`` the elements out of exp, log, tanh and their kind,
    and ``coll:<kind>`` as in :attr:`CellResult.collectives`.  The port's
    layers are a list and the trace visits every one, so ``cost`` is the
    traced step itself; ``cost_scanned`` equals it and
    ``run_cell(cost_extrapolation=...)`` is accepted and changes nothing
    (the reference extrapolates from 1- and 2-layer compiles because XLA
    counts a scan body once).  Past the second, each microbatch of a
    train step repeats the second's operations on the same shapes: the
    trace runs two and counts the others as repeats of the second, an
    exact count (``trace_cell(micro_repeats=False)`` traces them all);
  * ``collectives``: the result bytes by kind (``all-gather``,
    ``reduce-scatter``, ``all-reduce``, ``all-to-all``) of every call that
    :mod:`repro_torch.sharding.comm` issues for the step on this mesh,
    counted by running the step over :class:`~repro_torch.sharding.comm.
    DryGroup` stand-ins, plus the gradient norm's all-reduce over each mesh
    axis (:func:`repro_torch.train.optimizer.global_norm` on DTensors).  The
    gathers sit outside remat's checkpoint, so a recompute issues none.
    No HLO is parsed.

The mesh is a :class:`ShapeMesh`: axis names and sizes, no process group
and no device memory.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
import weakref
from collections import Counter
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from .. import configs
from ..configs import ShapeCell
from ..core.tree import tree_leaves, tree_map
from ..models import model as M
from ..models.config import ModelConfig
from ..sharding import comm
from ..sharding.specs import P, ShardingPolicy, make_policy, param_spec_tree, placements
from ..train.loop import TrainConfig, make_train_step, param_spec_tree_like
from ..train.optimizer import AdamWConfig, adamw_init

__all__ = ["ShapeMesh", "production_mesh", "run_cell", "train_settings", "input_specs",
           "decode_state_specs", "CellResult", "trace_cell"]

META = torch.device("meta")
TUPLE_ENTRY_BYTES = 8  # the reference's output tuple index table: one pointer an output


# ---------------------------------------------------------------------------
# The mesh: shapes alone
# ---------------------------------------------------------------------------


class ShapeMesh:
    """A mesh of axis names and sizes (the tests' fake meshes): ``shape``
    maps each axis to its size."""

    def __init__(self, *sizes: int, axis_names: Optional[Tuple[str, ...]] = None):
        names = axis_names or (("pod", "data", "model") if len(sizes) == 3 else ("data", "model"))
        if len(names) != len(sizes):
            raise ValueError(f"{len(sizes)} axis sizes for axes {names}")
        self.axis_names = tuple(names)
        self.sizes = tuple(sizes)
        self.shape = dict(zip(self.axis_names, self.sizes))

    @property
    def n_devices(self) -> int:
        return math.prod(self.sizes)

    @property
    def name(self) -> str:
        return "x".join(str(s) for s in self.sizes)


def production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    """The production shapes, (16, 16) over ("data", "model") or (2, 16,
    16) over ("pod", "data", "model"), as shapes alone (the dry run needs
    no ranks; ``launch.mesh.make_production_mesh`` needs 256 of them)."""
    return ShapeMesh(2, 16, 16) if multi_pod else ShapeMesh(16, 16)


# ---------------------------------------------------------------------------
# Per-arch training settings (memory budget driven; the reference's tiers)
# ---------------------------------------------------------------------------


def train_settings(cfg: ModelConfig, cell: ShapeCell) -> TrainConfig:
    n = cfg.param_count()
    if n > 100e9:  # llama3-405b, dbrx-132b
        n_micro, mdt, adt = 8, "bfloat16", "bfloat16"
    elif n > 10e9:  # phi3, qwen3-moe
        n_micro, mdt, adt = 4, "float32", "float32"
    else:
        n_micro, mdt, adt = 1, "float32", "float32"
    if cfg.dryrun_n_micro:
        n_micro = cfg.dryrun_n_micro
    return TrainConfig(
        batch=cell.global_batch,
        seq=cell.seq_len,
        n_micro=n_micro,
        accum_dtype=adt,
        opt=AdamWConfig(moment_dtype=mdt),
    )


# ---------------------------------------------------------------------------
# Abstract inputs and their per-device bytes
# ---------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, torch.Tensor]:
    """Meta stand-ins for one global batch (train/prefill)."""
    B, S = cell.global_batch, cell.seq_len
    out = {
        "tokens": _meta((B, S), torch.int32),
        "labels": _meta((B, S), torch.int32),
        "loss_weight": _meta((B, S), torch.float32),
    }
    if cfg.family == "audio":
        out["frames"] = _meta((B, cfg.enc_seq, cfg.d_model), torch.float32)
    if cfg.family == "vlm":
        out["patches"] = _meta((B, cfg.frontend_tokens, cfg.d_model), torch.float32)
    return out


def _batch_pspec(sp: ShardingPolicy, b: int, ndim: int) -> P:
    dp = sp.data_axes
    lead = dp if sp.dim(b, dp) else None
    return P(lead, *([None] * (ndim - 1)))


def decode_state_specs(cfg: ModelConfig, sp: ShardingPolicy, state: Any) -> Any:
    """Specs of the serving cache tree (``models.model.init_decode_state``).

    KV caches (L, B, T, KV, hd): batch over DP; KV heads over model when
    divisible, otherwise the *time* axis over model.  The port's ``pos`` is
    a host int; its spec is the reference's int32 scalar's, ``P()``."""
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


def _local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """``shape`` divided along every dim ``spec`` shards."""
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in (() if entry is None else entry if isinstance(entry, tuple) else (entry,)):
            out[d] //= mesh.shape[a]
    return tuple(out)


def _leaf_bytes(leaf: Any, spec, mesh) -> int:
    if isinstance(leaf, int):  # the decode state's host ``pos``: the reference's int32
        return 4
    return math.prod(_local_shape(leaf.shape, spec, mesh)) * leaf.element_size()


def _tree_bytes(tree: Any, specs: Any, mesh) -> int:
    return sum(_leaf_bytes(leaf, s, mesh) for leaf, s in zip(tree_leaves(tree),
                                                             tree_leaves(specs)))


def _shards(tree: Any, specs: Any, mesh) -> Any:
    """Meta tensors of each leaf's per-device shape."""
    return tree_map(lambda t, s: _meta(_local_shape(t.shape, s, mesh), t.dtype), tree, specs)


# ---------------------------------------------------------------------------
# The trace: flops, bytes, transcendentals, live memory, ops
# ---------------------------------------------------------------------------

_TRANSCENDENTAL = frozenset((
    "exp", "exp2", "expm1", "log", "log1p", "log2", "tanh", "sigmoid", "rsqrt", "sqrt",
    "sin", "cos", "erf", "pow", "silu", "gelu", "_softmax", "_log_softmax", "logsumexp",
))


def _tensors(x: Any) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _scan(x: Any, found: list) -> Any:
    """What an operation's output shapes depend on, of one argument (a
    tensor's shape, strides and dtype; anything else as it is); the
    tensors met are appended to ``found``."""
    if isinstance(x, torch.Tensor):
        found.append(x)
        return (x.shape, x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        for v in x:
            if isinstance(v, (torch.Tensor, list, tuple)):
                return tuple([_scan(v, found) for v in x])
        return tuple(x)  # sizes and scalars
    return x


def _out_spec(out: Any, inputs: set) -> Any:
    """(shape, stride, dtype) of each fresh output tensor, or None when an
    output is not a tensor or shares an input's storage."""
    if isinstance(out, torch.Tensor):
        if out.untyped_storage()._cdata in inputs:
            return None
        return (tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (list, tuple)) and out:
        specs = [_out_spec(o, inputs) for o in out]
        return None if any(s is None for s in specs) else (type(out), specs)
    return None


def _make(spec: Any) -> Any:
    if isinstance(spec[0], type):
        return spec[0](_make(s) for s in spec[1])
    return torch.empty_strided(spec[0], spec[1], dtype=spec[2], device=META)


class Trace(TorchDispatchMode):
    """Counts one traced step's aten operations: flops (by
    ``FlopCounterMode``'s rules), operand and result bytes, transcendental
    elements, result bytes and calls by operation name (a view is a call
    with no bytes: it moves none), the device types of the results, and
    the bytes of the storages the step allocates that are live at once
    (``peak``).  Storages alive before the step (``before``: its
    arguments) are not counted; a storage is dropped from the live count
    when the last tensor on it dies.

    The layers repeat the same operations on the same shapes, and a meta
    kernel costs far more host time than an empty tensor: an operation
    that returns fresh tensors is run once for each distinct (operation,
    argument shapes, strides, dtypes and other arguments), and its later
    calls get new empty tensors of the shapes that run gave.  Views,
    in-place operations and outputs that share an input's storage always
    run."""

    def __init__(self, before: Any = (), cache: bool = True):
        super().__init__()
        self._cache: Optional[Dict[Any, Any]] = {} if cache else None
        self._ops: Dict[Any, Tuple] = {}  # func -> (name, view, cacheable, transcendental, flops)
        self._flop_rules = FlopCounterMode(display=False).flop_registry
        self._seen = {t.untyped_storage()._cdata for t in _tensors(before)}
        self._refs: Dict[int, weakref.ref] = {}
        self.read: set = set()  # storages some operation read
        self.live = self.peak = 0
        self.flops = 0
        self.bytes_accessed = 0
        self.transcendentals = 0
        self.result_bytes: Counter = Counter()
        self.calls: Counter = Counter()
        self.collectives: Counter = Counter()  # result bytes by kind
        self.devices: set = set()  # the device types of every result

    def _op(self, func) -> Tuple:
        info = self._ops.get(func)
        if info is None:
            name = func.overloadpacket.__name__
            info = self._ops[func] = (
                name, func.is_view,
                self._cache is not None and not (func.is_view or func._schema.is_mutable),
                name.rstrip("_") in _TRANSCENDENTAL, self._flop_rules.get(func._overloadpacket))
        return info

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name, view, cacheable, transcendental, rule = self._op(func)
        operands: list = []
        key = (func, _scan(args, operands), _scan(tuple(kwargs.items()), operands))
        spec = None
        if cacheable:
            try:
                spec = self._cache.get(key)
            except TypeError:  # an argument that does not hash
                cacheable = False
        if spec is not None:
            out = _make(spec)
        else:
            out = func(*args, **kwargs)
            if cacheable:
                spec = _out_spec(out, {t.untyped_storage()._cdata for t in operands})
                if spec is not None:
                    self._cache[key] = spec
        if rule is not None:
            self.flops += rule(*args, **kwargs, out_val=out)
        self.calls[name] += 1
        self.read.update(t.untyped_storage()._cdata for t in operands)
        res = _tensors(out)
        self.devices.update(t.device.type for t in res)
        if view:
            return out
        rb = sum(t.nbytes for t in res)
        self.result_bytes[name] += rb
        self.bytes_accessed += rb + sum(t.nbytes for t in operands)
        if transcendental:
            self.transcendentals += sum(t.numel() for t in res)
        for t in res:
            self._track(t)
        return out

    def collective(self, kind: str, result: Optional[torch.Tensor], args: tuple) -> None:
        """A collective call of the step (the ``DryGroup`` hook): its
        result bytes under ``kind``; the tensors it reads are read."""
        n = 0 if result is None else result.nbytes
        self.calls[kind] += 1
        self.result_bytes[kind] += n
        self.collectives[kind] += n
        self.read.update(t.untyped_storage()._cdata for t in _tensors(args) if t is not result)

    _COUNTS = ("flops", "bytes_accessed", "transcendentals")
    _COUNTERS = ("result_bytes", "calls", "collectives")

    def snapshot(self) -> Dict[str, Any]:
        """The counts so far (not the live memory)."""
        out: Dict[str, Any] = {k: getattr(self, k) for k in self._COUNTS}
        out.update({k: Counter(getattr(self, k)) for k in self._COUNTERS})
        return out

    def repeat(self, first: Dict[str, Any], last: Dict[str, Any], times: int) -> None:
        """Count ``times`` more of what ran between two snapshots."""
        for k in self._COUNTS:
            setattr(self, k, getattr(self, k) + times * (last[k] - first[k]))
        for k in self._COUNTERS:
            c = getattr(self, k)
            for op, v in last[k].items():
                c[op] += times * (v - first[k][op])

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        self._refs[key] = weakref.ref(st, functools.partial(self._free, key, n))

    def _free(self, key: int, n: int, _ref) -> None:
        self.live -= n
        self._seen.discard(key)
        self._refs.pop(key, None)


class _TracePolicy(ShardingPolicy):
    """A sharding policy over a :class:`ShapeMesh` that runs the port's
    sharded code paths on meta shards: this is rank 0 (data rank 0, model
    rank 0), every group is a :class:`~repro_torch.sharding.comm.DryGroup`
    whose calls ``hook`` counts, and :meth:`gather` rebuilds each shard
    through :func:`comm.gather_local` by its spec (found by its storage,
    which ``detach`` keeps)."""

    def __init__(self, mesh: ShapeMesh, specs: Dict[int, P], hook):
        base = make_policy(mesh)
        super().__init__(mesh=mesh, pod_axis=base.pod_axis)
        self.specs = specs
        self.hook = hook

    def get_group(self, i: int) -> comm.DryGroup:
        """Mesh dim ``i``'s group (for :func:`comm.gather_local`)."""
        return comm.DryGroup(self.mesh.sizes[i], self.hook)

    @property
    def sharded(self) -> bool:
        return True

    def data_index(self) -> int:
        return 0

    def data_size(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.data_axes)

    def data_group(self) -> comm.DryGroup:
        return comm.DryGroup(self.data_size(), self.hook)

    def model_group(self) -> comm.DryGroup:
        return comm.DryGroup(self.mesh.shape[self.model_axis], self.hook)

    def gather(self, tree: Any, keep=()) -> Any:
        names = self.mesh.axis_names

        def one(t):
            if not t.dim():
                return t
            spec = self.specs[t.untyped_storage()._cdata]
            plan = comm.gather_plan(placements(spec, self.mesh), self.mesh.sizes, names,
                                    (0,) * len(names), keep)
            return comm.gather_local(t, self, plan, names, self.data_axes)

        return tree_map(one, tree)


def _norm_all_reduce_bytes(n_leaves: int, mesh: ShapeMesh) -> int:
    """``optimizer.global_norm`` on DTensors: one float32 all-reduce of
    the (n_leaves,) sums of squares over each mesh axis wider than 1."""
    return 4 * n_leaves * sum(1 for s in mesh.sizes if s > 1)


def _stacked_count(tree: Any) -> int:
    """Leaves of ``tree`` in the reference's layout, where a layer list is
    one stack of leaves."""
    if isinstance(tree, dict):
        return sum(_stacked_count(v) for v in tree.values())
    if isinstance(tree, list):
        return _stacked_count(tree[0]) if tree else 0
    return 1


@dataclasses.dataclass
class _Arg:
    """One argument tree: the tensors the trace runs on (shards or a data
    rank's rows), the stored tree and its specs, and whether it is
    donated (its outputs alias it)."""
    traced: Any
    stored: Any
    specs: Any
    donated: bool = False

    def bytes(self, mesh: ShapeMesh, read: set) -> int:
        """Per-device bytes of the leaves the step reads (an argument it
        never reads is pruned, as ``jax.jit`` prunes it); a host int (the
        decode state's ``pos``) is always read."""
        return sum(_leaf_bytes(g, s, mesh) for t, g, s in zip(
            tree_leaves(self.traced), tree_leaves(self.stored), tree_leaves(self.specs))
            if not isinstance(t, torch.Tensor) or t.untyped_storage()._cdata in read)


def trace_cell(cfg: ModelConfig, cell: ShapeCell, mesh: ShapeMesh,
               tc: Optional[TrainConfig] = None, *, cache: bool = True,
               micro_repeats: bool = True) -> Dict[str, Any]:
    """Trace one step of ``cfg`` at ``cell`` on ``mesh`` (rank 0's view);
    returns ``{"memory", "cost", "collectives", "trace"}`` (``trace`` the
    :class:`Trace`).  ``cache=False`` runs every meta kernel and
    ``micro_repeats=False`` traces every microbatch (both slower; the same
    counts)."""
    if cfg.attn_impl == "pallas":
        raise NotImplementedError(
            "attn_impl='pallas': the flash_attention kernel has no meta-device form, and "
            "the dry run does not count it through another path; use 'dense' or 'chunked'")
    sp = make_policy(mesh)
    dp = math.prod(mesh.shape[a] for a in sp.data_axes)
    params = M.init_params(cfg, device=META)
    pspecs = param_spec_tree(params, sp)
    specs: Dict[int, P] = {}
    pol = _TracePolicy(mesh, specs, lambda *call: tr.collective(*call))

    def sharded(tree, tree_specs, donated=False):
        local = _shards(tree, tree_specs, mesh)
        for t, s in zip(tree_leaves(local), tree_leaves(tree_specs)):
            specs[t.untyped_storage()._cdata] = s
        return _Arg(local, tree, tree_specs, donated)

    def batch_arg(batch, rows):  # traced on a data rank's rows
        bspecs = {k: _batch_pspec(sp, v.shape[0], v.dim()) for k, v in batch.items()}
        return _Arg({k: _meta((rows, *v.shape[1:]), v.dtype) for k, v in batch.items()},
                    batch, bspecs)

    B = cell.global_batch
    if cell.kind == "train":
        tc = tc or train_settings(cfg, cell)
        cap = max(1, B // dp)  # each microbatch must still shard over DP
        if tc.n_micro > cap:
            tc = dataclasses.replace(tc, n_micro=cap)
        if (B // tc.n_micro) % dp:
            raise ValueError(f"a microbatch of {B // tc.n_micro} rows does not split over "
                             f"{dp} data ranks")
        opt = adamw_init(params, tc.opt)
        # the step takes the whole batch and keeps its data rank's rows; past
        # the second, each microbatch repeats the second's operations on the
        # same shapes, so two are traced and the rest counted as repeats
        n_rep = max(0, tc.n_micro - 2) if micro_repeats else 0
        traced_cell = dataclasses.replace(cell, global_batch=B // tc.n_micro * 2) if n_rep else cell
        batch = input_specs(cfg, cell)
        args = [sharded(params, pspecs, True),
                sharded(opt, param_spec_tree_like(opt, pspecs), True),
                _Arg(input_specs(cfg, traced_cell), batch,
                     {k: _batch_pspec(sp, v.shape[0], v.dim()) for k, v in batch.items()})]
        snaps: list = []
        step = make_train_step(cfg, dataclasses.replace(tc, n_micro=tc.n_micro - n_rep), pol,
                               on_micro=lambda i: snaps.append(tr.snapshot()))
        n_out = _stacked_count(params) + _stacked_count(opt) + 3  # + loss, grad_norm, lr

        def run():
            metrics = step(*(a.traced for a in args))[2]
            if n_rep:
                tr.repeat(snaps[0], snaps[1], n_rep)
            return metrics

        def outputs(metrics):
            return sum(t.nbytes for t in metrics.values()) + TUPLE_ENTRY_BYTES * n_out
    elif cell.kind == "prefill":
        if B % dp:
            raise ValueError(f"a batch of {B} rows does not split over {dp} data ranks")
        batch = input_specs(cfg, cell)
        del batch["labels"], batch["loss_weight"]
        args = [sharded(params, pspecs), batch_arg(batch, B // dp)]

        def run():
            with torch.no_grad():
                return M.forward(args[0].traced, cfg, args[1].traced, pol)[0]

        def outputs(logits):  # stored as the reference's logits spec shards them
            shape = (B, *logits.shape[1:])
            spec = P(sp.data_axes, None, sp.dim(shape[2], sp.model_axis))
            return math.prod(_local_shape(shape, spec, mesh)) * logits.element_size()
    else:
        rows = B // dp if B % dp == 0 else B
        state = M.init_decode_state(cfg, B, cell.seq_len, device=META)
        token = _meta((B,), torch.int32)
        args = [_Arg(params, params, pspecs),
                _Arg(M.init_decode_state(cfg, rows, cell.seq_len, device=META), state,
                     decode_state_specs(cfg, sp, state), True),
                batch_arg({"token": token}, rows)]
        n_out = 1 + len(tree_leaves(state))

        def run():
            with torch.no_grad():
                logits, _ = M.decode_step(params, cfg, args[1].traced, args[2].traced["token"])
                return torch.argmax(logits, dim=-1).to(torch.int32)

        def outputs(nxt):
            return args[2].bytes(mesh, tr.read) + TUPLE_ENTRY_BYTES * n_out

    tr = Trace(before=[a.traced for a in args], cache=cache)
    with tr:
        out = run()
    if cell.kind == "train":
        tr.collectives["all-reduce"] += _norm_all_reduce_bytes(len(tree_leaves(params)), mesh)
    collectives = {k: int(v) for k, v in sorted(tr.collectives.items()) if k != "barrier"}
    cost = {"flops": float(tr.flops), "bytes_accessed": float(tr.bytes_accessed),
            "transcendentals": float(tr.transcendentals),
            **{f"coll:{k}": float(v) for k, v in collectives.items()}}
    alias = sum(a.bytes(mesh, tr.read) for a in args if a.donated)
    memory = {"argument_bytes": float(sum(a.bytes(mesh, tr.read) for a in args)),
              "temp_bytes": float(tr.peak),
              "output_bytes": float(alias + outputs(out)), "alias_bytes": float(alias)}
    return {"memory": memory, "cost": cost, "collectives": collectives, "trace": tr}


# ---------------------------------------------------------------------------
# Cell runner
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    ok: bool
    skipped: str = ""
    error: str = ""
    seconds: float = 0.0
    memory: Optional[Dict[str, float]] = None
    # the reference's scanned-executable cost; the port traces every layer,
    # so this equals ``cost``
    cost_scanned: Optional[Dict[str, float]] = None
    # the traced step's cost, per device (module docstring)
    cost: Optional[Dict[str, float]] = None
    collectives: Optional[Dict[str, int]] = None
    model_flops_global: float = 0.0
    n_devices: int = 0

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


def _model_flops(cfg: ModelConfig, cell: ShapeCell) -> float:
    """MODEL_FLOPS = 6*N_active*D tokens (train: fwd+bwd; decode: 2*N_active
    per token forward-only => 2*N*D)."""
    n = cfg.active_param_count()
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * cell.global_batch


def _reduced(cfg: ModelConfig, layers: int) -> ModelConfig:
    kw = {"n_layers": layers, "scan_unroll": True}
    if cfg.enc_dec:
        kw["enc_layers"] = layers
    return cfg.replace(**kw)


def run_cell(
    arch: str,
    shape: Union[str, ShapeCell],
    mesh: ShapeMesh,
    *,
    verbose: bool = True,
    cost_extrapolation: bool = True,
    overrides: Optional[Dict[str, Any]] = None,
    train_config: Optional[TrainConfig] = None,
) -> CellResult:
    """The dry run of ``arch`` at ``shape`` (a name of ``configs.SHAPES``
    or a :class:`ShapeCell`) on ``mesh``.  ``overrides``: config fields,
    and ``_n_micro`` for the microbatch count; ``train_config`` replaces
    :func:`train_settings` (a training run's own).  ``cost_extrapolation``
    is the reference's and changes nothing here (module docstring)."""
    cfg = configs.get(arch)
    force_n_micro = None
    if overrides:
        overrides = dict(overrides)
        force_n_micro = overrides.pop("_n_micro", None)
        if overrides:
            cfg = cfg.replace(**overrides)
    cell = configs.SHAPES[shape] if isinstance(shape, str) else shape
    res = CellResult(arch=arch, shape=cell.name, mesh=mesh.name, ok=False,
                     n_devices=mesh.n_devices)
    ok, why = configs.runnable(cfg, cell)
    if not ok:
        res.skipped = why
        res.ok = True
        return res
    t0 = time.time()
    try:
        tc = train_config
        if cell.kind == "train" and force_n_micro is not None:
            tc = dataclasses.replace(tc or train_settings(cfg, cell), n_micro=force_n_micro)
        got = trace_cell(cfg, cell, mesh, tc)
        res.memory = got["memory"]
        res.cost = got["cost"]
        res.cost_scanned = dict(got["cost"])
        res.collectives = got["collectives"]
        res.model_flops_global = _model_flops(cfg, cell)
        res.ok = True
    except (TypeError, ValueError, RuntimeError, NotImplementedError) as e:
        # expected failure modes (a shape that does not split, a path the
        # trace refuses, an operation meta tensors lack): report per cell
        res.error = f"{type(e).__name__}: {e}"
    except Exception as e:
        # anything else (KeyError, AttributeError, ...) is a bug in the dry
        # run itself: surface it with the cell that triggered it
        raise RuntimeError(
            f"dryrun harness bug on {arch} {cell.name} mesh={mesh.name}: "
            f"unexpected {type(e).__name__}: {e}"
        ) from e
    res.seconds = time.time() - t0
    if verbose:
        status = "SKIP" if res.skipped else ("OK" if res.ok else "FAIL")
        print(f"[{status:4s}] {arch:22s} {cell.name:12s} mesh={mesh.name:8s} "
              f"{res.seconds:6.1f}s {res.error[:90]}", flush=True)
    return res
