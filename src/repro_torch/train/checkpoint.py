"""Step-granular checkpointing with atomic publication and DMM hybrid
storage, in the reference's layout.

Counterpart of ``repro.train.checkpoint``; each package restores the
other's checkpoints bit for bit.  Layout::

    <dir>/step_0000100/
        meta.json            the caller's metadata (the loop writes the step)
        dtypes.json          each leaf's true dtype, by leaf path
        dmm.json             the mapping state, stored as the aggressively
                             compacted iDUSB (paper SS6.2), when given
        arrays/<path>.npy    one file per leaf of the reference's layout:
                             ``params/layers/attn/wq`` ->
                             ``params__layers__attn__wq.npy``, the per-layer
                             tensors stacked on a leading axis
    <dir>/step_0000100.OK    publication marker

The port keeps one dict per layer; :func:`repro_torch.core.convert.
stack_layers` stacks them on save and :func:`restore` takes them apart
again.  Leaf paths join dict keys in sorted order, as ``jax.tree_util``
flattens a dict, so ``dtypes.json`` lists them in the reference's order.
numpy has no bfloat16 or float8 of its own (the reference takes them from
``ml_dtypes``, which the port does not use): such a leaf is written as its
same-width unsigned-integer view (:func:`repro_torch.core.convert.
tensor_to_numpy`), its true dtype in ``dtypes.json``, as the reference
writes it.

Fault tolerance: a checkpoint is visible only once its ``.OK`` marker
exists; an interrupted write leaves no marker, and its ``.tmp`` directory
is removed by the next save.  Arrays are written from the host.

Under a ``torch.distributed`` process group every rank calls :func:`save`:
each DTensor leaf (a parameter or moment sharded over the model mesh) is
gathered whole on every rank (a collective), rank 0 of the mesh (of the
group, for plain trees) writes and publishes, and the others wait at a
barrier until it has.  The files hold the whole arrays, so they are the
same bytes whatever the mesh; :func:`restore` places each leaf as its
``like`` leaf is placed, which is what lets a checkpoint saved on one mesh
resume on another (:mod:`repro_torch.train.elastic`).
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.convert import numpy_to_tensor, stack_layers, tensor_to_numpy
from ..core.tree import tree_leaves, tree_map
from ..sharding.comm import barrier, full_tensor, place
from ..sharding.specs import is_dtensor

__all__ = ["save", "restore", "latest_step", "save_dmm", "restore_dmm"]

def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _flatten(tree: Any) -> Dict[str, torch.Tensor]:
    """{'/'-joined path: leaf} of a reference-layout tree (nested dicts),
    dict keys sorted."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Any, path: Tuple[str, ...]) -> None:
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], (*path, str(k)))
        else:
            out["/".join(path)] = node

    walk(tree, ())
    return out


def _step_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step:07d}")


def _barrier(mesh) -> None:
    """Every rank of ``mesh`` (of the process group when None) waits for
    all the others."""
    if mesh is None:
        barrier()
        return
    for i in range(mesh.ndim):  # one barrier along each axis reaches every rank
        barrier(mesh.get_group(i))


def save(base: str, step: int, params: Any, opt_state: Any, meta: Dict, dusb=None) -> str:
    """Write (params, opt_state) at ``step`` under ``base`` and publish it;
    returns the step's directory.  ``dusb``: the mapping state to store
    beside it (:func:`save_dmm`).  Under a process group every rank calls
    it (see the module docstring)."""
    if not dist.is_initialized():
        return _write(base, step, params, opt_state, meta, dusb)
    dts = [t for t in tree_leaves(params) + tree_leaves(opt_state) if is_dtensor(t)]
    mesh = dts[0].device_mesh if dts else None
    whole = lambda t: full_tensor(t) if is_dtensor(t) else t  # noqa: E731
    params, opt_state = tree_map(whole, params), tree_map(whole, opt_state)
    writer = (not any(mesh.get_coordinate())) if mesh is not None else dist.get_rank() == 0
    final = _write(base, step, params, opt_state, meta, dusb) if writer else _step_dir(base, step)
    _barrier(mesh)
    return final


def _write(base: str, step: int, params: Any, opt_state: Any, meta: Dict, dusb) -> str:
    os.makedirs(base, exist_ok=True)
    final = _step_dir(base, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    arrays = os.path.join(tmp, "arrays")
    os.makedirs(arrays)
    dtypes: Dict[str, str] = {}
    leaves = {**{f"params/{k}": v for k, v in _flatten(stack_layers(params)).items()},
              **{f"opt/{k}": v for k, v in _flatten(stack_layers(opt_state)).items()}}
    for name, t in leaves.items():
        dtypes[name] = _dtype_name(t)
        np.save(os.path.join(arrays, name.replace("/", "__") + ".npy"), tensor_to_numpy(t))
    with open(os.path.join(tmp, "dtypes.json"), "w") as f:
        json.dump(dtypes, f)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if dusb is not None:
        save_dmm(os.path.join(tmp, "dmm.json"), dusb)
    # atomic publication
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(final + ".OK", "w") as f:
        f.write("ok")
    # GC any unpublished temp dirs
    for d in os.listdir(base):
        if d.endswith(".tmp"):
            shutil.rmtree(os.path.join(base, d), ignore_errors=True)
    return final


def latest_step(base: str) -> Optional[int]:
    """The latest published step under ``base``, or None."""
    if not os.path.isdir(base):
        return None
    steps = []
    for d in os.listdir(base):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(base, d + ".OK")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _load(arrays: str, dtypes: Dict[str, str], name: str) -> torch.Tensor:
    arr = np.load(os.path.join(arrays, name.replace("/", "__") + ".npy"))
    return numpy_to_tensor(arr, getattr(torch, dtypes.get(name, str(arr.dtype))))


def restore(base: str, step: int, like: Tuple[Any, Any]) -> Tuple[Any, Any, Dict]:
    """Restore (params, opt_state, meta) of ``step`` with the structure of
    ``like`` (a (params, opt_state) pair of port trees): each leaf takes the
    dtype and device of its ``like`` leaf (a DTensor ``like`` leaf: this
    rank's shard, placed as it is), and a ``layers`` / ``enc_layers`` list
    takes its layers apart from the stacked file."""
    final = _step_dir(base, step)
    arrays = os.path.join(final, "arrays")
    with open(os.path.join(final, "dtypes.json")) as f:
        dtypes = json.load(f)
    cache: Dict[str, torch.Tensor] = {}

    def leaf(name: str, like_t: torch.Tensor, layer: Optional[int]) -> torch.Tensor:
        if name not in cache:
            cache[name] = _load(arrays, dtypes, name)
        t = cache[name] if layer is None else cache[name][layer]
        t = t.to(device=like_t.device, dtype=like_t.dtype).clone()
        return place(t, like_t.device_mesh, like_t.placements) if is_dtensor(like_t) else t

    def build(node: Any, path: Tuple[str, ...], layer: Optional[int]) -> Any:
        if not isinstance(node, dict):
            return leaf("/".join(path), node, layer)
        out = {}
        for k, v in node.items():
            if isinstance(v, list):  # "layers" / "enc_layers": one stacked file a leaf
                out[k] = [build(lp, (*path, k), i) for i, lp in enumerate(v)]
            else:
                out[k] = build(v, (*path, k), layer)
        return out

    params = build(like[0], ("params",), None)
    opt_state = build(like[1], ("opt",), None)
    with open(os.path.join(final, "meta.json")) as f:
        meta = json.load(f)
    return params, opt_state, meta


# ---------------------------------------------------------------------------
# DMM hybrid persistence (paper SS6.2): store DUSB, rebuild DPM on restore
# ---------------------------------------------------------------------------


def save_dmm(path: str, dusb) -> None:
    ser = {
        f"{o},{r},{w}": [[v, sorted(map(list, elements))] for v, elements in seq]
        for (o, r, w), seq in dusb.items()
    }
    with open(path, "w") as f:
        json.dump(ser, f)


def restore_dmm(path: str):
    with open(path) as f:
        ser = json.load(f)
    out = {}
    for key, seq in ser.items():
        o, r, w = map(int, key.split(","))
        out[(o, r, w)] = [
            (v, frozenset(tuple(e) for e in elements)) for v, elements in seq
        ]
    return out
