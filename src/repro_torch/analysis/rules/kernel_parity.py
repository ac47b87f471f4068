"""kernel-ref-parity: every hand-written kernel's wrapper has a plain
PyTorch twin in ref.py and a parity test that exercises both.

The port's correctness story for its Hopper kernels is twin-based, as the
reference's is for its Pallas kernels: each public function of a
``kernels/*.py`` module that launches a kernel through a ``build.load(...)``
ctypes entry ships a plain PyTorch version in ``kernels/ref.py``, and a
test asserts the two agree.  The twin is what makes a kernel reviewable
(the plain version IS the spec), what the wrapper runs on a CPU tensor,
and what the CPU tests hold the reference against.  A kernel without a
twin, or a twin nothing compares against, is untested device code.

Project-level checks (this rule sees the whole file set at once):

  * a public top-level function of a module under a ``kernels/`` directory
    (``ref.py``, ``ops.py``, ``build.py`` and ``__init__.py`` aside) is a
    kernel wrapper when it, or a function it reaches in that directory,
    calls ``build.load`` -- the launch through the ctypes entry, not the
    text of the file, decides;
  * every wrapper has a ``<name>_ref`` twin in that directory's ``ref.py``
    (aliases: ``flash_attention`` -> ``attention_ref``; ``<base>_shard``,
    ``<base>_chunk`` and ``<base>_blocks`` -- the sharded kernel, the
    one-C-call chunk entry and the per-block launcher -- are covered by
    ``<base>``'s twin);
  * some ``test_torch_*.py`` under the repo's ``tests/`` directory (located
    by walking up from the kernels dir) names BOTH the wrapper and its twin
    -- the onehot regression this encodes: a test that called
    ``onehot_map`` but compared against ``masked_gather_ref``.  The
    variants' parity is asserted through their base kernel, as the
    reference's ``_shard`` is.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Set

from ..core import FileCtx, Finding, Rule, register
from ..project import FunctionInfo, Project, as_project, attr_chain

ALIASES = {"flash_attention": "attention_ref"}
_VARIANTS = ("_shard", "_chunk", "_blocks")
_SKIP_MODULES = {"ref.py", "__init__.py", "ops.py", "build.py"}


def _top_level_defs(tree: ast.Module) -> List[ast.FunctionDef]:
    return [n for n in tree.body if isinstance(n, ast.FunctionDef)]


def _base_name(kernel: str) -> str:
    for v in _VARIANTS:
        if kernel.endswith(v):
            return kernel[: -len(v)]
    return kernel


def _twin_name(kernel: str) -> str:
    base = _base_name(kernel)
    return ALIASES.get(base, base + "_ref")


def _find_tests_dir(kernels_dir: Path) -> Optional[Path]:
    for up in [kernels_dir, *kernels_dir.parents]:
        cand = up / "tests"
        if cand.is_dir():
            return cand
    return None


def _loads(info: FunctionInfo) -> bool:
    """True when ``info``'s body calls ``build.load`` (directly or through
    a ``from .build import load``)."""
    for node in ast.walk(info.node):
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if chain is None:
                continue
            resolved = info.module.resolve(chain) or chain
            if resolved.endswith("build.load"):
                return True
    return False


@register
class KernelRefParity(Rule):
    id = "kernel-ref-parity"
    title = "every ctypes-launched kernel has a ref.py twin and a torch test using both"
    motivation = (
        "the plain twin is the kernel's spec, its CPU path and its only CPU "
        "coverage; the reference's onehot test once compared against the "
        "WRONG twin without anything noticing"
    )

    def check_project(self, ctxs: Sequence[FileCtx]) -> Iterator[Finding]:
        project = as_project(ctxs)
        by_dir: Dict[Path, List[FileCtx]] = {}
        for ctx in project:
            if "kernels" not in ctx.path.parts or ctx.path.name in _SKIP_MODULES:
                continue
            by_dir.setdefault(ctx.path.parent, []).append(ctx)
        for kdir, kernel_ctxs in sorted(by_dir.items()):
            yield from self._check_dir(project, kdir, kernel_ctxs)

    @staticmethod
    def _launches(project: Project, kdir: Path, info: FunctionInfo) -> bool:
        for q in project.reachable([info.qname]):
            other = project.functions[q]
            if other.ctx.path.parent == kdir and _loads(other):
                return True
        return False

    def _check_dir(
        self, project: Project, kdir: Path, kernel_ctxs: List[FileCtx]
    ) -> Iterator[Finding]:
        ref_path = kdir / "ref.py"
        ref_names: Set[str] = set()
        if ref_path.is_file():
            try:
                ref_names = {d.name for d in _top_level_defs(ast.parse(ref_path.read_text()))}
            except SyntaxError:
                pass  # surfaced as parse-error when ref.py is in the run

        tests_dir = _find_tests_dir(kdir)
        test_text = ""
        if tests_dir is not None:
            for t in sorted(tests_dir.rglob("test_torch_*.py")):
                try:
                    test_text += t.read_text() + "\n"
                except OSError:
                    continue

        for ctx in kernel_ctxs:
            mod = ctx.module
            for fn in _top_level_defs(ctx.tree):
                if fn.name.startswith("_"):
                    continue
                info = project.functions.get(f"{mod.name}.{fn.name}" if mod else fn.name)
                if info is None or not self._launches(project, kdir, info):
                    continue
                twin = _twin_name(fn.name)
                if not ref_path.is_file():
                    yield ctx.finding(self.id, fn,
                                      f"kernel {fn.name}() has no {ref_path.name} next to "
                                      "it; add a plain PyTorch twin module")
                    continue
                if twin not in ref_names:
                    yield ctx.finding(
                        self.id, fn,
                        f"kernel {fn.name}() has no twin {twin}() in {ref_path.name}; "
                        "the plain version is the kernel's spec and its CPU path",
                    )
                    continue
                if fn.name != _base_name(fn.name):
                    continue  # parity is asserted through the base kernel
                if tests_dir is None:
                    yield ctx.finding(
                        self.id, fn,
                        f"no tests/ directory found above {kdir}; kernel {fn.name}() "
                        f"needs a parity test against {twin}()",
                    )
                    continue
                has_kernel = re.search(rf"\b{re.escape(fn.name)}\b", test_text)
                has_twin = re.search(rf"\b{re.escape(twin)}\b", test_text)
                if not (has_kernel and has_twin):
                    missing = f"{twin}()" if has_kernel else f"{fn.name}() and {twin}()"
                    yield ctx.finding(
                        self.id, fn,
                        f"no tests/test_torch_*.py references {missing}; add a "
                        f"parity test asserting {fn.name}() matches {twin}()",
                    )
