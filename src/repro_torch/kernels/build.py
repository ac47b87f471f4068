"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C entry point and includes no PyTorch
header, so one ``nvcc`` call turns it into ``build/lib<name>-<hash>.so`` at
the repository root in seconds.  The hash is taken over the source, the
``csrc`` headers it includes (``#include "<header>"``, followed through
headers) and the flags, so an edited kernel or header is rebuilt and an
unchanged one is reused.
:func:`build` starts one ``nvcc`` per source, all at once, and waits for
them all; :func:`load` builds one kernel if it is missing and opens it.

Nothing here runs at import time: the CPU-only test environment imports
every module and has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

__all__ = [
    "KERNELS", "NVCC_FLAGS", "build_dir", "build", "load", "library_path",
    "ptxas_report", "check_operand", "check_arena",
]

_CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("segmented_gather", "densify_map", "masked_gather", "onehot_map",
           "flash_attention", "moe_combine", "decode_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """``build/`` at the repository root (``src/repro_torch/kernels`` is
    three levels below it)."""
    return Path(__file__).resolve().parents[3] / "build"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError(f"nvcc not found (looked on PATH and {found})")
    return found


def _inputs(name: str) -> list:
    """``csrc/<name>.cu`` and the ``csrc`` headers it includes, directly or
    through another header (each once)."""
    found, todo = [], [_CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            header = _CSRC / inc.decode()
            if header.is_file():
                todo.append(header)
    return found


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` is (or will be) built: named by
    a hash of its sources and the flags."""
    h = hashlib.sha256()
    for path in _inputs(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (all by default) that are not built yet,
    one ``nvcc`` process per source, started together.  Returns the seconds
    each build took (0.0 for a library already present); raises with the
    compiler's output when any build fails."""
    names = tuple(KERNELS if names is None else names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, target)
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        tmp.replace(target)  # atomic: a reader never sees a partial library
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def ptxas_report(name: str) -> str:
    """The compiler's ``-Xptxas -v`` output (registers, shared memory,
    spills) from the last build of ``name``, or "" if none was kept."""
    log = build_dir() / f"{name}.log"
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            target = library_path(name)
            if not target.exists():
                build([name])
            lib = ctypes.CDLL(str(target))
            _libs[name] = lib
        return lib


def check_operand(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
                  device: torch.device) -> None:
    """What a wrapper checks before it hands ``t.data_ptr()`` to a kernel:
    device, dtype, rank and contiguity."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has {t.dim()} dims, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def check_arena(host: torch.Tensor, n_bytes: int) -> None:
    """What a chunk entry checks of the host arena it copies from: a
    contiguous uint8 CPU tensor of at least ``n_bytes``."""
    if (host.device.type != "cpu" or host.dtype != torch.uint8 or host.dim() != 1
            or not host.is_contiguous() or host.numel() < n_bytes):
        raise ValueError(f"host must be a contiguous uint8 CPU arena of at least "
                         f"{n_bytes} bytes")
