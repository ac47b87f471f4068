"""jit-cache-hygiene: cached builders of compiled artifacts take only
hashable, annotated static arguments.

The reference's subject is the ``lru_cache``-wrapped ``jax.jit`` program
builder; the port has no jit, and its counterpart is the cached function
that builds or loads a compiled artifact: a kernel library
(``kernels/build.py`` ``load`` / ``build``, and any cached ctypes entry
that calls them), a ``torch.compile``
program, or a captured CUDA graph (``torch.cuda.CUDAGraph`` /
``torch.cuda.graph``).  The failure mode is the reference's and just as
*silent*: a key that hashes differently every call (a fresh device object
per chunk, a float read from a tensor, a tuple rebuilt from a list) makes
every chunk load, build or capture again -- correctness untouched, the
cost moved onto every chunk.

A function is a cached builder when it is ``functools.lru_cache`` /
``cache``-decorated, or keeps a module-level dict cache (``_libs[name] =
lib`` of a module-level ``_libs = {}``, as ``build.load`` does), and its
body calls one of: ``build.load`` / ``build.build`` (also as ``load`` /
``build`` imported from ``kernels/build.py``), ``ctypes.CDLL``,
``torch.compile``, ``torch.cuda.CUDAGraph``, ``torch.cuda.graph``.
Today that is ``build.load`` alone (its ``_libs`` dict around
``ctypes.CDLL``); the rule ships for the next cached builder.  Checks, as
the reference's:

  * ``*args``/``**kwargs`` are flagged (unauditable cache key);
  * every parameter must be annotated -- the annotation is how the next
    reader (and this rule) audits the cache key;
  * annotations must name hashable-by-value types (str/int/float/bool/
    bytes/tuple/frozenset/Hashable/...); tensor and array annotations
    (``torch.Tensor``/``np.ndarray``) are flagged outright: tensors hash
    by identity, so "it worked" means the key churns every call.

Same-file call sites of a cached builder passing list/dict/set literals
are flagged too (unhashable at runtime).
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set

from ..core import FileCtx, Finding, Rule, register
from ..project import attr_chain

_HASHABLE = frozenset(
    {
        "str",
        "int",
        "float",
        "bool",
        "bytes",
        "complex",
        "tuple",
        "Tuple",
        "frozenset",
        "FrozenSet",
        "Hashable",
        "Optional",
        "Union",
        "Literal",
        "Callable",
        "None",
        "NoneType",
        "type",
        "Type",
        "Enum",
        "DTypeLike",
        "dtype",
    }
)

_ARRAYISH = frozenset({"Tensor", "ndarray", "ArrayLike"})

# the calls that build, load or capture a compiled artifact (resolved
# dotted names, or their tails once resolution ends in the kernels' build
# module)
_ARTIFACT_CALLS = frozenset(
    {"torch.compile", "torch.cuda.CUDAGraph", "torch.cuda.graph", "ctypes.CDLL",
     "ctypes.cdll.LoadLibrary"}
)
_BUILD_TAILS = frozenset({"build.load", "build.build"})


def _is_lru_cache(dec: ast.expr) -> bool:
    target = dec.func if isinstance(dec, ast.Call) else dec
    if isinstance(target, ast.Attribute):
        return target.attr in ("lru_cache", "cache")
    if isinstance(target, ast.Name):
        return target.id in ("lru_cache", "cache")
    return False


def _builds_artifact(fn: ast.AST, module) -> bool:
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        chain = attr_chain(node.func)
        if chain is None:
            continue
        resolved = (module.resolve(chain) if module is not None else None) or chain
        if resolved in _ARTIFACT_CALLS or chain in _ARTIFACT_CALLS:
            return True
        if any(resolved.endswith(t) or chain == t for t in _BUILD_TAILS):
            return True
    return False


def _module_dicts(tree: ast.Module) -> Set[str]:
    """Names bound to a dict literal (or ``dict()``) at module level."""
    out: Set[str] = set()
    for stmt in tree.body:
        value = getattr(stmt, "value", None)
        targets = stmt.targets if isinstance(stmt, ast.Assign) else (
            [stmt.target] if isinstance(stmt, ast.AnnAssign) else [])
        if isinstance(value, ast.Dict) or (
            isinstance(value, ast.Call) and attr_chain(value.func) == "dict"
        ):
            out.update(t.id for t in targets if isinstance(t, ast.Name))
    return out


def _stores_into(fn: ast.AST, dicts: Set[str]) -> bool:
    """True when ``fn`` writes ``D[key] = ...`` into a module-level dict."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                        and t.value.id in dicts):
                    return True
    return False


def _root_names(annot: ast.expr) -> List[str]:
    """The identifier(s) that decide hashability of an annotation."""
    if isinstance(annot, ast.Name):
        return [annot.id]
    if isinstance(annot, ast.Attribute):
        return [annot.attr]
    if isinstance(annot, ast.Constant):
        if annot.value is None:
            return ["None"]
        if isinstance(annot.value, str):
            return [annot.value.strip().rsplit(".", 1)[-1].split("[", 1)[0]]
        return []
    if isinstance(annot, ast.Subscript):
        # Optional[X] / Union[X, Y] delegate to the args; Tuple[...] etc.
        # are hashable by the root name alone
        roots = _root_names(annot.value)
        if roots and roots[0] in ("Optional", "Union"):
            sl = annot.slice
            elts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
            out: List[str] = []
            for el in elts:
                out.extend(_root_names(el))
            return out
        return roots
    if isinstance(annot, ast.BinOp) and isinstance(annot.op, ast.BitOr):
        return _root_names(annot.left) + _root_names(annot.right)
    return []


@register
class JitCacheHygiene(Rule):
    id = "jit-cache-hygiene"
    title = "cached kernel-library/compile/graph builders take only annotated hashable args"
    motivation = (
        "a churning cache key on a cached build.load / torch.compile / CUDA "
        "graph builder loads, compiles or captures again every chunk -- "
        "results stay correct, the card just quietly gets slower (the "
        "reference's near-miss with per-chunk Mesh objects)"
    )

    def check_file(self, ctx: FileCtx) -> Iterator[Finding]:
        cached: Set[str] = set()
        dicts = _module_dicts(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not (any(_is_lru_cache(d) for d in node.decorator_list)
                    or _stores_into(node, dicts)):
                continue
            if not _builds_artifact(node, ctx.module):
                continue
            cached.add(node.name)
            yield from self._check_builder(ctx, node)
        if cached:
            yield from self._check_call_sites(ctx, cached)

    def _check_builder(self, ctx: FileCtx, fn: ast.FunctionDef) -> Iterator[Finding]:
        args = fn.args
        if args.vararg is not None or args.kwarg is not None:
            star = args.vararg or args.kwarg
            yield ctx.finding(
                self.id,
                fn,
                f"cached builder {fn.name}() takes *{star.arg}: the "
                "cache key cannot be audited; spell every static arg out",
            )
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            yield from self._check_param(ctx, fn, a)

    def _check_param(
        self, ctx: FileCtx, fn: ast.FunctionDef, a: ast.arg
    ) -> Iterator[Finding]:
        if a.annotation is None:
            yield ctx.finding(
                self.id,
                a,
                f"parameter '{a.arg}' of cached builder {fn.name}() is "
                "unannotated; annotate it with a hashable type so the "
                "cache key is auditable",
            )
            return
        roots = _root_names(a.annotation)
        bad = self._bad_root(roots)
        if bad is not None:
            hint = (
                "a tensor hashes by identity, an array not at all"
                if bad in _ARRAYISH
                else "hash identity is not hash-by-value"
            )
            yield ctx.finding(
                self.id,
                a,
                f"parameter '{a.arg}: {ctx.segment(a.annotation)}' of cached "
                f"builder {fn.name}() is not a hashable static type "
                f"({hint}); pass a str/int/tuple key instead",
            )

    @staticmethod
    def _bad_root(roots: List[str]) -> Optional[str]:
        for r in roots:
            if r in _ARRAYISH:
                return r
            if r not in _HASHABLE:
                return r
        return None if roots else "?"

    def _check_call_sites(self, ctx: FileCtx, cached: Set[str]) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            name = (
                f.id
                if isinstance(f, ast.Name)
                else f.attr if isinstance(f, ast.Attribute) else None
            )
            if name not in cached:
                continue
            values = list(node.args) + [kw.value for kw in node.keywords]
            for v in values:
                if isinstance(v, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                                  ast.DictComp, ast.SetComp)):
                    yield ctx.finding(
                        self.id,
                        v,
                        f"unhashable literal passed to cached builder "
                        f"{name}(); use a tuple/frozenset",
                    )
