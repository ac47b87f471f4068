"""One chunk of the per-block engine, mapped block by block in one call.

The per-block engine (:class:`repro_torch.etl.engines.BlocksEngine`) maps
each (schema, version) group of a chunk through each of its compacted
blocks: two host->device copies a group (values, mask) and one launch a
block, the counts the reference's ``stats`` fix.  A :class:`BlockChunk`
holds one chunk's payloads in one host arena and describes that work in two
int64 tables; :func:`apply_blocks` issues all of it at once:

- on a CUDA device through the kernel library's C launcher
  (``metl_<kernel>_blocks``, ``csrc/blocks.cuh``): for each group its two
  ``cudaMemcpyAsync`` copies, pinned host arena to device arena, then one
  launch of the kernel for each of its blocks, on the current stream; it
  reports how many copies and launches it issued;
- on the CPU by walking the same tables, copy by copy and block by block,
  through the kernel's plain version into the same output layout.

Layout (every offset and count an int64):

``groups[g] = (values offset, mask offset, B, N_in)``
    the group's (B, N_in) float32 values and int8 mask, at those byte
    offsets in the host arena and, after the copies, in the device arena;
    offsets are multiples of :data:`ALIGN`.
``blocks[k] = (group, src offset, N_out_pad, out offset)``, in group order
    the block's index vector is ``src_flat[src offset:][:N_out_pad]`` (the
    placed plan's flat table, :func:`repro_torch.core.dmm_torch.
    place_blocks`) and its (B, N_out_pad) outputs lie row-major in the
    chunk's float32 and int8 output arenas from ``out offset`` (elements).

A block of a group with B 0 has nothing to launch and is not counted; a
group with no block still makes its two copies.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from . import build

__all__ = ["ALIGN", "BlockChunk", "apply_blocks"]

ALIGN = 16  # byte alignment of every group's values and mask in the arenas


def _nbytes(b, n_in):
    """Bytes of a (B, N_in) group's float32 values and of its int8 mask."""
    return 4 * b * n_in, b * n_in


_VP = ctypes.c_void_p
_I64 = ctypes.c_int64


@dataclasses.dataclass
class BlockChunk:
    """One chunk's payloads (``host``, a uint8 arena, pinned when it feeds a
    CUDA device) and its descriptors (module docstring); ``n_bytes`` arena
    bytes and ``n_out`` output elements are in use.  :meth:`layout` is the
    one place that lays a chunk out; :meth:`payload` reads a group back."""

    host: torch.Tensor
    groups: np.ndarray  # int64 (G, 4)
    blocks: np.ndarray  # int64 (K, 4)
    n_bytes: int
    n_out: int

    @staticmethod
    def layout(rows: np.ndarray, n_in: np.ndarray, bgroup: np.ndarray,
               src_off: np.ndarray, n_out_pad: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, int, int]:
        """``(groups, blocks, n_bytes, n_out)`` of a chunk whose group g holds
        ``rows[g]`` x ``n_in[g]`` payload and whose block k, of group
        ``bgroup[k]`` (ascending), reads ``src_flat[src_off[k]:][:n_out_pad[k]]``:
        each group's float32 values then its int8 mask, every region
        :data:`ALIGN`-aligned; the blocks' outputs back to back."""
        rows, n_in = (np.asarray(a, dtype=np.int64) for a in (rows, n_in))
        bgroup, src_off, n_out_pad = (np.asarray(a, dtype=np.int64).reshape(-1)
                                      for a in (bgroup, src_off, n_out_pad))
        span_v, span_m = (-(-n // ALIGN) * ALIGN for n in _nbytes(rows, n_in))
        ends = np.cumsum(span_v + span_m)
        off_v = ends - span_v - span_m
        out_size = rows[bgroup] * n_out_pad
        out_off = np.cumsum(out_size) - out_size
        groups = np.stack([off_v, off_v + span_v, rows, n_in], axis=1).reshape(-1, 4)
        blocks = np.stack([bgroup, src_off, n_out_pad, out_off], axis=1).reshape(-1, 4)
        return groups, blocks, int(ends[-1]) if ends.size else 0, int(out_size.sum())

    def scatter(self, group: np.ndarray, elem: np.ndarray, vals: np.ndarray) -> None:
        """Set element ``elem[i]`` (row * N_in + column) of group
        ``group[i]``'s values to ``vals[i]`` and its mask to 1."""
        raw = self.host.numpy()[: self.n_bytes]
        raw.view(np.float32)[self.groups[group, 0] // 4 + elem] = vals
        raw[self.groups[group, 1] + elem] = 1

    def payload(self, g: int) -> Tuple[np.ndarray, np.ndarray]:
        """Group ``g``'s (B, N_in) float32 values and int8 mask: writable
        views of the host arena."""
        off_v, off_m, b, n_in = self.groups[g].tolist()
        n_v, n_m = _nbytes(b, n_in)
        raw = self.host.numpy()
        return (raw[off_v : off_v + n_v].view(np.float32).reshape(b, n_in),
                raw[off_m : off_m + n_m].view(np.int8).reshape(b, n_in))


def _launcher(name: str):
    fn = getattr(build.load(name), f"metl_{name}_blocks")
    if fn.argtypes is None:
        fn.argtypes = [_VP, _VP, _VP, _I64, _VP, _I64, _VP, _VP, _VP,
                       ctypes.c_float, _VP, _VP, _VP]
        fn.restype = ctypes.c_int
    return fn


def _check(name: str, chunk: BlockChunk, src_flat: torch.Tensor) -> None:
    """What :func:`apply_blocks` checks before it issues anything: table
    shapes, and that every copy, index vector and output lies inside its
    buffer (a kernel would read or write past it otherwise)."""
    g, k = chunk.groups, chunk.blocks
    for label, t in (("groups", g), ("blocks", k)):
        if (t.dtype != np.int64 or t.ndim != 2 or t.shape[1] != 4
                or not t.flags.c_contiguous):
            raise ValueError(f"{label} must be C-contiguous int64 (n, 4), got "
                             f"{t.dtype} {t.shape}")
    host = chunk.host
    if (host.device.type != "cpu" or host.dtype != torch.uint8 or host.dim() != 1
            or not host.is_contiguous() or host.numel() < chunk.n_bytes):
        raise ValueError("host must be a contiguous uint8 CPU arena of at least "
                         f"{chunk.n_bytes} bytes")
    if src_flat.dtype != torch.int32 or src_flat.dim() != 1 or not src_flat.is_contiguous():
        raise ValueError("src_flat must be a contiguous int32 vector")
    if g.size:
        off = g[:, :2]
        span = np.stack(_nbytes(g[:, 2], g[:, 3]), axis=1)
        if ((off % ALIGN).any() or (g < 0).any()
                or (off + span > chunk.n_bytes).any()):
            raise ValueError(f"group payloads must be {ALIGN}-byte aligned and "
                             f"inside the {chunk.n_bytes}-byte arena")
    if k.size:
        grp = k[:, 0]
        if (grp < 0).any() or (grp >= len(g)).any() or (np.diff(grp) < 0).any():
            raise ValueError("blocks must name their groups, in group order")
        rows, n_in = g[grp, 2], g[grp, 3]
        if ((k[:, 1:] < 0).any() or (k[:, 1] + k[:, 2] > src_flat.numel()).any()
                or (k[:, 3] + rows * k[:, 2] > chunk.n_out).any()):
            raise ValueError("a block's index vector or outputs lie outside "
                             "src_flat or the output arenas")
        if name == "masked_gather" and ((rows > 0) & (n_in == 0)).any():
            raise ValueError("masked_gather needs a non-empty payload")


def _walk(plain: Callable, chunk: BlockChunk, src_flat: torch.Tensor,
          out_v: torch.Tensor, out_m: torch.Tensor, fill: float) -> Tuple[int, int]:
    """The launcher's work on the CPU, in its order: per group the two
    copies into a device-side arena, then the plain version per block."""
    arena = dataclasses.replace(chunk, host=torch.empty(chunk.n_bytes, dtype=torch.uint8))
    copies = launches = 0
    blocks = chunk.blocks.tolist()
    k = 0
    for g, (off_v, off_m, b, n_in) in enumerate(chunk.groups.tolist()):
        for off, n in zip((off_v, off_m), _nbytes(b, n_in)):
            arena.host[off : off + n].copy_(chunk.host[off : off + n])
            copies += 1
        values, mask = map(torch.from_numpy, arena.payload(g))
        while k < len(blocks) and blocks[k][0] == g:
            _, src_off, n_out, out_off = blocks[k]
            k += 1
            if b == 0 or n_out == 0:
                continue
            v, m = plain(values, mask, src_flat[src_off : src_off + n_out], fill=fill)
            out_v[out_off : out_off + b * n_out] = v.reshape(-1)
            out_m[out_off : out_off + b * n_out] = m.reshape(-1)
            launches += 1
    return copies, launches


def apply_blocks(name: str, plain: Callable, chunk: BlockChunk,  # metl-torch: allow[kernel-ref-parity] the generic per-block launcher behind masked_gather_blocks / onehot_map_blocks; its plain version is the twin it is handed (masked_gather_ref / onehot_map_ref), run block by block
                 src_flat: torch.Tensor, *, fill: float = 0.0
                 ) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """Map every block of ``chunk`` with kernel ``name`` (``"masked_gather"``
    or ``"onehot_map"``) on ``src_flat``'s device: its library's launcher on
    a CUDA device (``chunk.host`` must be pinned), ``plain`` on the CPU.

    Returns ``(out_v, out_m, copies, launches)``: the float32 and int8
    output arenas (``chunk.n_out`` elements each, not synchronised) and how
    many copies and launches (plain-version calls on the CPU) were issued.
    On a CUDA device the caller keeps ``chunk.host`` unchanged until the
    copies have run (an event recorded after this call)."""
    _check(name, chunk, src_flat)
    dev = src_flat.device
    out_v = torch.empty(chunk.n_out, dtype=torch.float32, device=dev)
    out_m = torch.empty(chunk.n_out, dtype=torch.int8, device=dev)
    if dev.type == "cpu":
        return (out_v, out_m, *_walk(plain, chunk, src_flat, out_v, out_m, fill))
    if dev.type != "cuda":
        raise ValueError(f"no {name} kernel for device {dev}")
    if not chunk.host.is_pinned():
        raise ValueError("a CUDA dispatch needs a pinned host arena")
    arena = torch.empty(chunk.n_bytes, dtype=torch.uint8, device=dev)
    counts = np.zeros(2, dtype=np.int64)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher(name)(
            chunk.host.data_ptr(), arena.data_ptr(), chunk.groups.ctypes.data,
            len(chunk.groups), chunk.blocks.ctypes.data, len(chunk.blocks),
            src_flat.data_ptr(), out_v.data_ptr(), out_m.data_ptr(), float(fill),
            stream, counts.ctypes.data, counts.ctypes.data + 8,
        )
    if err != 0:
        raise RuntimeError(f"{name} blocks launcher failed: CUDA error {err} after "
                           f"{counts[0]} copies and {counts[1]} launches")
    return out_v, out_m, int(counts[0]), int(counts[1])
