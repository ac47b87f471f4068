"""The whole-program model: import resolution, call graph, reachability,
asynchronous-copy dataflow.

The port's copy of ``repro.analysis.project``.  Per-file AST checks cannot
enforce a cross-module contract -- the single-writer coordinator,
epoch-pinned in-flight chunks, a host arena whose copy to the card runs
**asynchronously on the card and synchronously on the CPU** -- except
where a hard-coded function name happens to match.  :class:`Project` gives
rules the whole-program facts those contracts need:

  * **symbol resolution** through the module graph -- every analyzed file
    becomes a :class:`Module` with an import table, so ``from ..kernels.ops
    import dmm_apply_dense as X; X(...)`` resolves to the same function as
    the direct call;
  * an **approximate call graph** -- call edges resolve by import-aware
    qualified name first, then fall back to bare-name matching for
    attribute calls (``self.engine.dispatch(...)`` links to every known
    ``dispatch``).  Deliberately an over-approximation: reachability-scoped
    rules would rather scan one extra function than miss the hot path
    through a wrapper;
  * **reachability sets** -- :meth:`Project.reachable` (transitive callees
    of a seed set) and the derived :meth:`Project.hot_path` (everything
    reachable from engine ``densify``/``dispatch``/``consume``), and
    :meth:`Project.only_called_from`, the caller-side dual used to resolve
    wrappers of ``StateCoordinator.apply``;
  * the **async-copy map** (the counterpart of the reference's donation
    map) -- the entries that copy a chunk from a pinned host arena on the
    card's stream and return before the copy has run
    (:data:`ASYNC_COPY_ENTRIES`: the ``*_chunk`` C entries, the per-block
    launcher, ``ops.dmm_apply_dense`` / ``dmm_apply_packed`` /
    ``dmm_apply_blocks``); wrappers that hand a parameter's arena to one
    copy from that parameter in turn, and a parameter bound to such an
    entry at a call site (``_dispatch(..., dmm_apply_dense, ...)``) is a
    copying callable inside its function.
    :mod:`repro_torch.analysis.rules.donated_buffer` flags writes to the
    arena after the copying call.

``Project`` is itself a ``Sequence[FileCtx]``, so a plain
``check_project(ctxs)`` implementation (kernel-ref-parity) works on it;
rules that need the model call :func:`as_project` (a no-op for the
instance :func:`repro_torch.analysis.core.analyze` builds ONCE per run).
"""

from __future__ import annotations

import ast
import re
from typing import (
    Dict,
    Iterable,
    Iterator,
    List,
    Optional,
    Sequence,
    Set,
    Tuple,
)

from .core import FileCtx

__all__ = [
    "ARENA_VIEWS",
    "ASYNC_COPY_ENTRIES",
    "HOT_PACKAGES",
    "attr_chain",
    "as_project",
    "module_name",
    "FunctionInfo",
    "Module",
    "Project",
]


def attr_chain(node: ast.expr) -> Optional[str]:
    """The dotted source chain of a Name/Attribute tree (``a.b.c``), or None
    when any link is a call/subscript/literal -- the currency of the
    dataflow rules (chains compare textually)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def module_name(ctx: FileCtx) -> str:
    """Dotted module name for one analyzed file.

    Everything after the LAST ``src`` path component when present (so a
    tmp-dir fixture tree ``/tmp/x/src/repro_torch/etl/e.py`` names
    ``repro_torch.etl.e``
    exactly like the real one), otherwise every path component -- enough for
    repo-relative ``benchmarks/run.py`` -> ``benchmarks.run``.
    """
    parts = [p for p in ctx.path.parts if p not in ("/", "\\")]
    if "src" in parts:
        parts = parts[len(parts) - parts[::-1].index("src") :]
    if parts and parts[-1].endswith(".py"):
        parts[-1] = parts[-1][: -len(".py")]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


# the packages that own the per-chunk path: reachability is seeded there
HOT_PACKAGES: Tuple[Tuple[str, ...], ...] = (("repro_torch", "etl"), ("repro_torch", "kernels"))


class FunctionInfo:
    """One function or method definition in the analyzed set."""

    def __init__(
        self,
        qname: str,
        module: "Module",
        node: ast.FunctionDef,
        cls: Optional[str],
    ) -> None:
        self.qname = qname
        self.name = node.name
        self.cls = cls
        self.module = module
        self.node = node
        # parameter positions (``self`` counted) whose host arena this
        # function hands to an asynchronous copy -> parameter name (filled by
        # the async-copy fixpoint; empty for most functions)
        self.copies_from: Dict[int, str] = {}

    @property
    def ctx(self) -> FileCtx:
        return self.module.ctx

    def params(self) -> List[str]:
        a = self.node.args
        return [p.arg for p in a.posonlyargs + a.args]

    @property
    def call_nodes(self) -> List[ast.Call]:
        """Every call in the body (nested defs included), walked once."""
        calls = self.__dict__.get("_calls")
        if calls is None:
            calls = self.__dict__["_calls"] = [
                n for n in ast.walk(self.node) if isinstance(n, ast.Call)
            ]
        return calls

    @property
    def is_method(self) -> bool:
        """Called through an instance: the first parameter is not an argument."""
        ps = self.params()
        return self.cls is not None and bool(ps) and ps[0] in ("self", "cls")

    def __repr__(self) -> str:
        return f"FunctionInfo({self.qname})"


class Module:
    """One analyzed file as a module: import table + owned definitions."""

    def __init__(self, ctx: FileCtx) -> None:
        self.ctx = ctx
        self.name = module_name(ctx)
        self.is_package = ctx.path.name == "__init__.py"
        self.imports: Dict[str, str] = {}  # local name -> imported qname
        self.top_level: Set[str] = set()  # top-level def/class names
        self._parse_imports()

    def _parse_imports(self) -> None:
        for node in ast.walk(self.ctx.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.asname:
                        self.imports[alias.asname] = alias.name
                    else:
                        # `import a.b.c` binds only the root name `a`
                        root = alias.name.split(".")[0]
                        self.imports[root] = root
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    # relative import: level 1 is the containing package --
                    # which for an __init__.py is the module name itself
                    up = node.level - 1 if self.is_package else node.level
                    parts = self.name.split(".")
                    anchor = parts[: len(parts) - up] if up else parts
                    base = ".".join(anchor + ([node.module] if node.module else []))
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    local = alias.asname or alias.name
                    self.imports[local] = f"{base}.{alias.name}" if base else alias.name

    def resolve(self, chain: str) -> Optional[str]:
        """Resolve a dotted source chain to a qualified name through this
        module's imports and top-level definitions, or None."""
        head, _, rest = chain.partition(".")
        if head in self.imports:
            base = self.imports[head]
            return f"{base}.{rest}" if rest else base
        if head in self.top_level:
            return f"{self.name}.{chain}" if self.name else chain
        return None


class _DefCollector(ast.NodeVisitor):
    """Collect every function/method of a module with its class context."""

    def __init__(self, module: Module, out: Dict[str, FunctionInfo]) -> None:
        self.module = module
        self.out = out
        self._cls: Optional[str] = None

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.module.top_level.add(node.name)
        prev, self._cls = self._cls, node.name
        for child in node.body:
            self.visit(child)
        self._cls = prev

    def _visit_def(self, node: ast.FunctionDef) -> None:
        # function bodies are not descended into: nested defs (kernel
        # closures) are not separate functions in the model -- ast.walk over
        # the owner's node attributes their statements and call edges to the
        # enclosing function
        if self._cls is None:
            self.module.top_level.add(node.name)
        parts = [self.module.name] if self.module.name else []
        if self._cls:
            parts.append(self._cls)
        parts.append(node.name)
        qname = ".".join(parts)
        self.out[qname] = FunctionInfo(qname, self.module, node, self._cls)

    visit_FunctionDef = _visit_def
    visit_AsyncFunctionDef = _visit_def  # type: ignore[assignment]


# The entries that copy a chunk from a host arena on the stream and return
# before the copy has run (the C entries, the per-block launcher and the
# ops that wrap them): name -> the position of the arena, or of the object
# whose ``.host`` is the arena.  Wrappers are found by the fixpoint in
# Project._build_async_copy_map.
ASYNC_COPY_ENTRIES: Dict[str, int] = {
    "segmented_gather_chunk": 0,
    "densify_map_chunk": 0,
    "dmm_apply_dense": 0,
    "dmm_apply_packed": 0,
    "dmm_apply_blocks": 0,
    "apply_blocks": 2,
    "masked_gather_blocks": 0,
    "onehot_map_blocks": 0,
}
# what an arena-holding object exposes of its arena: the arena itself and
# its views (DenseChunk.vals/mask/rows/blks, ColumnarDense.packed,
# BlockDense.chunk)
ARENA_VIEWS = frozenset({"host", "vals", "mask", "rows", "blks", "packed", "chunk"})


class Project(Sequence[FileCtx]):
    """The whole-program model over one analyzer run's file set.

    Sequence protocol: iterating/indexing a Project yields its
    :class:`FileCtx` objects, so legacy ``check_project(ctxs)``
    implementations run unmodified.
    """

    def __init__(self, ctxs: Sequence[FileCtx]) -> None:
        self._ctxs = list(ctxs)
        self.modules: Dict[str, Module] = {}
        self.functions: Dict[str, FunctionInfo] = {}
        self.by_name: Dict[str, List[FunctionInfo]] = {}
        self.calls: Dict[str, Set[str]] = {}
        self.callers: Dict[str, Set[str]] = {}
        self._hot: Optional[Set[str]] = None
        for ctx in self._ctxs:
            mod = Module(ctx)
            self.modules[mod.name] = mod
            ctx.module = mod
            _DefCollector(mod, self.functions).visit(ctx.tree)
        for info in self.functions.values():
            self.by_name.setdefault(info.name, []).append(info)
        self._build_call_graph()
        self._build_async_copy_map()

    # -- Sequence[FileCtx] ----------------------------------------------------
    def __len__(self) -> int:
        return len(self._ctxs)

    def __getitem__(self, i: int) -> FileCtx:  # type: ignore[override]
        return self._ctxs[i]

    def __iter__(self) -> Iterator[FileCtx]:
        return iter(self._ctxs)

    # -- call graph -----------------------------------------------------------
    def _callees_of(self, info: FunctionInfo) -> Set[str]:
        out: Set[str] = set()
        for node in info.call_nodes:
            out.update(t.qname for t in self.resolve_call(info.module, node.func))
        return out

    def resolve_call(
        self, module: Module, func: ast.expr
    ) -> List[FunctionInfo]:
        """Candidate targets of one call expression.

        A chain that resolves through the module's imports/definitions to a
        known function (or a known class -- then its ``__init__``) is an
        exact edge; an unresolved attribute call falls back to every known
        function with the same bare name (over-approximate by design).
        """
        chain = attr_chain(func)
        if chain is None:
            return []
        qname = module.resolve(chain)
        if qname is not None:
            if qname in self.functions:
                return [self.functions[qname]]
            if f"{qname}.__init__" in self.functions:
                return [self.functions[f"{qname}.__init__"]]
            # imported-but-unanalyzed symbol: name-match on the RESOLVED tail
            # (`from ops import dmm_apply_dense as X` still finds every known
            # dmm_apply_dense even when `ops` isn't in the file set) -- but
            # only for a symbol of an analyzed package whose module is not in
            # the file set: `torch.gather(...)` is no edge to every `gather`,
            # and `_Gather.apply(...)` of an analyzed module (a method its
            # class inherits from torch) is no edge to every `apply`
            if self._unanalyzed_project_symbol(qname):
                return list(self.by_name.get(qname.rsplit(".", 1)[-1], []))
            return []
        if "." in chain:
            # unresolved attribute call (self.engine.dispatch): every known
            # function with the same bare name
            return list(self.by_name.get(chain.rsplit(".", 1)[-1], []))
        # a bare name that resolved nowhere is a local variable or builtin
        return []

    def _unanalyzed_project_symbol(self, qname: str) -> bool:
        """``qname`` lies in a package that has analyzed modules, and in no
        analyzed module itself."""
        parts = qname.split(".")
        if not any(m == parts[0] or m.startswith(parts[0] + ".") for m in self.modules):
            return False
        for i in range(len(parts) - 1, 0, -1):
            mod = self.modules.get(".".join(parts[:i]))
            if mod is not None:
                # the longest analyzed prefix: a symbol it defines is known
                # (and not a function); a package's unlisted name lies in a
                # submodule outside the file set
                return mod.is_package and parts[i] not in mod.top_level
        return True

    def _build_call_graph(self) -> None:
        for qname, info in self.functions.items():
            callees = self._callees_of(info)
            callees.discard(qname)
            self.calls[qname] = callees
            for c in callees:
                self.callers.setdefault(c, set()).add(qname)

    # -- reachability ---------------------------------------------------------
    def reachable(self, seeds: Iterable[str]) -> Set[str]:
        """Seeds plus every transitive callee (qualified names)."""
        seen: Set[str] = set()
        stack = [s for s in seeds if s in self.functions]
        while stack:
            q = stack.pop()
            if q in seen:
                continue
            seen.add(q)
            stack.extend(self.calls.get(q, ()))
        return seen

    def seeds_matching(
        self, pattern: "re.Pattern[str]", *, packages: Sequence[Tuple[str, ...]] = ()
    ) -> Set[str]:
        """qnames of functions whose bare NAME matches ``pattern``, optionally
        restricted to files inside any of ``packages`` (path-part tuples)."""
        out: Set[str] = set()
        for info in self.functions.values():
            if not pattern.search(info.name):
                continue
            if packages and not any(info.ctx.in_package(*p) for p in packages):
                continue
            out.add(info.qname)
        return out

    _HOT_SEED = re.compile(
        r"densify|dispatch|_chunk_layout|_pack_columnar|^(consume|consume_groups)$"
    )

    def hot_path(self) -> Set[str]:
        """The per-chunk path: transitive callees of the engine
        ``densify``/``dispatch``/``consume`` entry points (plus the hot
        routing helpers), seeded in ``repro_torch.etl``/``repro_torch.kernels`` -- or
        anywhere when neither package is in the file set, so bare fixture
        trees exercise the same scoping."""
        if self._hot is None:
            pkgs: Sequence[Tuple[str, ...]] = HOT_PACKAGES
            seeds = self.seeds_matching(self._HOT_SEED, packages=pkgs)
            if not seeds:
                seeds = self.seeds_matching(self._HOT_SEED)
            self._hot = self.reachable(seeds)
        return self._hot

    def only_called_from(self, qname: str, root: str) -> bool:
        """True when every caller path of ``qname`` terminates at ``root``
        (the wrapper-resolution dual of :meth:`reachable`): ``qname`` is a
        private helper of ``root`` and inherits its privileges.  A function
        with any caller chain escaping to another root -- or with no callers
        at all -- is not."""
        if qname == root:
            return True
        seen: Set[str] = set()
        stack = [qname]
        while stack:
            q = stack.pop()
            if q in seen or q == root:
                continue
            seen.add(q)
            callers = self.callers.get(q, set())
            if not callers:
                return False  # an open entry point, not a private helper
            stack.extend(callers)
        return True

    # -- asynchronous copies from host arenas --------------------------------
    def _build_async_copy_map(self) -> None:
        """A fixpoint over two facts: (1) a function copies from parameter
        ``p`` when it passes ``p`` (or ``p.host`` / ``p.chunk``) in the arena
        position of an entry of :data:`ASYNC_COPY_ENTRIES` or of another
        copying function; (2) a parameter that some call site binds to a
        copying function is itself a copying callable inside its function
        (``_dispatch(..., dmm_apply_dense, ...)`` makes ``_dispatch``'s
        ``op(dense.host, ...)`` a copy)."""
        # qname -> {param position: arena positions of the callables passed}
        self.async_params: Dict[str, Dict[int, Tuple[int, ...]]] = {}
        changed = True
        while changed:
            changed = False
            for info in self.functions.values():
                params = info.params()
                for node in info.call_nodes:
                    for arg in self.arena_args(info, node):
                        chain = attr_chain(arg)
                        if chain is None:
                            continue
                        root, _, rest = chain.partition(".")
                        if root in params and rest in ("", "host", "chunk"):
                            i = params.index(root)
                            if i not in info.copies_from:
                                info.copies_from[i] = root
                                changed = True
                    changed |= self._bind_async_params(info, node)

    def _bind_async_params(self, info: FunctionInfo, call: ast.Call) -> bool:
        """Record the parameters of ``call``'s targets that it binds to a
        copying callable; True when something new was learned."""
        passed = [
            (i, self.copy_positions(info, a)) for i, a in enumerate(call.args)
        ]
        passed = [(i, pos) for i, pos in passed if pos]
        if not passed:
            return False
        new = False
        for t in self.resolve_call(info.module, call.func):
            shift = 1 if t.is_method and isinstance(call.func, ast.Attribute) else 0
            slots = self.async_params.setdefault(t.qname, {})
            for i, pos in passed:
                if slots.get(i + shift) != pos:
                    slots[i + shift] = tuple(sorted(set(slots.get(i + shift, ())) | set(pos)))
                    new = True
        return new

    def copy_positions(self, info: FunctionInfo, func: ast.expr) -> Tuple[int, ...]:
        """Arena positions of calling ``func`` from ``info`` (call-argument
        positions), or () when the call copies from no arena."""
        chain = attr_chain(func)
        if chain is None:
            return ()
        resolved = info.module.resolve(chain) or chain
        tail = resolved.rsplit(".", 1)[-1]
        if tail in ASYNC_COPY_ENTRIES:
            return (ASYNC_COPY_ENTRIES[tail],)
        if isinstance(func, ast.Name) and func.id in info.params():
            held = self.async_params.get(info.qname, {})
            pos = held.get(info.params().index(func.id))
            if pos:
                return pos
        for t in self.resolve_call(info.module, func):
            if t.copies_from:
                shift = 1 if t.is_method and isinstance(func, ast.Attribute) else 0
                return tuple(sorted(i - shift for i in t.copies_from if i - shift >= 0))
        return ()

    def arena_args(self, info: FunctionInfo, call: ast.Call) -> List[ast.expr]:
        """The argument expressions ``call`` hands to an asynchronous copy."""
        out: List[ast.expr] = []
        for p in self.copy_positions(info, call.func):
            if p < len(call.args) and not isinstance(call.args[p], ast.Starred):
                out.append(call.args[p])
        return out


def as_project(ctxs: Sequence[FileCtx]) -> Project:
    """The Project for a ``check_project`` argument: identity for the one
    :func:`repro_torch.analysis.core.analyze` built, a fresh build for a plain
    FileCtx list (direct rule unit tests)."""
    return ctxs if isinstance(ctxs, Project) else Project(list(ctxs))


# -- where a value lives: the CPU or the card -----------------------------------
#
# The torch rules need to tell a host array (numpy, a CPU or pinned tensor)
# from a tensor on the card: ``x.tolist()`` is free on the first and a sync
# on the second.  The inference is local to one function and
# conservative: a value is *host* only when its binding shows it.

_NP_ROOTS = frozenset({"np", "numpy"})
# torch factories that allocate on the CPU unless given a device
_TORCH_FACTORIES = frozenset(
    {"empty", "zeros", "ones", "full", "arange", "tensor", "as_tensor",
     "empty_like", "zeros_like", "from_numpy", "frombuffer"}
)
# methods whose result lives where their receiver lives
_SAME_PLACE = frozenset(
    {"view", "reshape", "narrow", "contiguous", "flatten", "ravel", "astype",
     "clone", "copy", "sum", "any", "all", "__getitem__", "T", "squeeze",
     "unsqueeze", "split", "chunk", "max", "min", "cumsum", "nonzero"}
)
# methods that hand a host value back
_TO_HOST = frozenset({"numpy", "cpu", "tolist", "item"})
_HOSTISH_NAME = re.compile(r"(^|_)(host|cpu|np)($|_)")


def cpu_branch(test: ast.expr) -> Optional[str]:
    """Which branch of an ``if`` runs only on the CPU: "body" for
    ``x.type == "cpu"`` / ``device == "cpu"`` / ``x.type != "cuda"``,
    "orelse" for the negations, None when the test says nothing of the
    device."""
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1):
        return None
    a, b = test.left, test.comparators[0]
    if isinstance(a, ast.Constant):
        a, b = b, a
    if not (isinstance(b, ast.Constant) and b.value in ("cpu", "cuda")):
        return None
    chain = attr_chain(a) or ""
    leaf = chain.rsplit(".", 1)[-1]
    if leaf not in ("type", "device", "dev") and not leaf.endswith("device"):
        return None
    op = test.ops[0]
    if not isinstance(op, (ast.Eq, ast.NotEq)):
        return None
    body_is_cpu = isinstance(op, ast.Eq) == (b.value == "cpu")
    return "body" if body_is_cpu else "orelse"


def walk_card(node: ast.AST) -> Iterator[ast.AST]:
    """``ast.walk`` without the branches that run only on the CPU (see
    :func:`cpu_branch`): no copy there can wait for the card."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, ast.If):
            side = cpu_branch(n.test)
            stack.append(n.test)
            if side != "body":
                stack.extend(reversed(n.body))
            if side != "orelse":
                stack.extend(reversed(n.orelse))
            continue
        stack.extend(reversed(list(ast.iter_child_nodes(n))))


def _base(node: ast.expr) -> ast.expr:
    """Peel subscripts and same-place method calls: ``h.numpy()[:n]`` ->
    ``h``."""
    while True:
        if isinstance(node, ast.Subscript):
            node = node.value
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _SAME_PLACE | {"numpy"}
        ):
            node = node.func.value
        else:
            return node


class Placement:
    """Per-function knowledge of which names hold host values."""

    def __init__(self, module: Optional[Module], fn: ast.AST) -> None:
        self.module = module
        self.host_params: Set[str] = set()
        self.host: Set[str] = set()
        self.card: Set[str] = set()
        args = getattr(fn, "args", None)
        if args is not None:
            for a in args.posonlyargs + args.args + args.kwonlyargs:
                ann = attr_chain(a.annotation) if a.annotation is not None else None
                if ann and ann.rsplit(".", 1)[-1] == "ndarray":
                    self.host_params.add(a.arg)
        # a name is host (or on the card) only when EVERY binding of it in
        # the function is; recomputed so an alias of an alias is seen
        # whichever way round they are written
        for _ in range(3):
            kinds: Dict[str, Set[str]] = {}
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign):
                    self._bind(kinds, node.targets, node.value)
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    self._bind(kinds, [node.target], node.value)
                elif isinstance(node, (ast.For, ast.comprehension, ast.With)):
                    tgts = ([i.optional_vars for i in node.items if i.optional_vars]
                            if isinstance(node, ast.With) else [node.target])
                    self._bind(kinds, tgts, None)
            self.host = {n for n, k in kinds.items() if k == {"host"}} | self.host_params
            self.card = {n for n, k in kinds.items() if k == {"card"}}

    def _bind(self, kinds: Dict[str, Set[str]], targets: Sequence[ast.expr],
              value: Optional[ast.expr]) -> None:
        for t in targets:
            if isinstance(t, ast.Name):
                kind = ("other" if value is None else "host" if self.is_host(value)
                        else "card" if self.on_card(value) else "other")
                kinds.setdefault(t.id, set()).add(kind)
            elif isinstance(t, (ast.Tuple, ast.List)):
                if isinstance(value, (ast.Tuple, ast.List)) and len(value.elts) == len(t.elts):
                    for e, v in zip(t.elts, value.elts):
                        self._bind(kinds, [e], v)
                else:
                    self._bind(kinds, list(t.elts), None)

    def _resolved(self, func: ast.expr) -> str:
        chain = attr_chain(func) or ""
        if self.module is not None and chain:
            return self.module.resolve(chain) or chain
        return chain

    def is_host(self, e: ast.expr) -> bool:
        """True when ``e`` provably lives on the host."""
        if isinstance(e, (ast.Constant, ast.List, ast.Tuple, ast.Dict, ast.Set,
                          ast.ListComp, ast.DictComp, ast.SetComp, ast.JoinedStr)):
            return True
        if isinstance(e, ast.Name):
            return e.id in self.host or bool(_HOSTISH_NAME.search(e.id))
        if isinstance(e, ast.Attribute):
            return bool(_HOSTISH_NAME.search(e.attr)) or self.is_host_root(e)
        if isinstance(e, ast.Subscript):
            return self.is_host(e.value)
        if isinstance(e, ast.BinOp):
            return self.is_host(e.left) and self.is_host(e.right)
        if isinstance(e, ast.Call):
            f = e.func
            resolved = self._resolved(f)
            root = resolved.split(".", 1)[0]
            if root in _NP_ROOTS or (isinstance(f, ast.Name) and f.id in (
                    "len", "int", "float", "bool", "list", "tuple", "sorted", "range")):
                return True
            if isinstance(f, ast.Attribute):
                if f.attr in _TO_HOST:
                    return True
                if f.attr in ("to", "cuda"):
                    return False
                if resolved.startswith("torch.") and f.attr in _TORCH_FACTORIES:
                    return not any(
                        kw.arg == "device" and not is_cpu_literal(kw.value)
                        for kw in e.keywords
                    )
                if f.attr in _SAME_PLACE:
                    return self.is_host(f.value)
        return False

    def is_host_root(self, e: ast.Attribute) -> bool:
        chain = attr_chain(e)
        return chain is not None and chain.split(".", 1)[0] in self.host

    def on_card(self, e: ast.expr) -> bool:
        """True when ``e`` provably lives on the card."""
        if isinstance(e, ast.Name):
            return e.id in self.card
        if isinstance(e, ast.Subscript):
            return self.on_card(e.value)
        if isinstance(e, ast.Call):
            f = e.func
            if isinstance(f, ast.Attribute):
                if f.attr == "cuda":
                    return True
                if f.attr == "to":
                    return to_device_arg(e) is not None
                if f.attr in _TO_HOST:
                    return False
                resolved = self._resolved(f)
                if resolved.startswith("torch.") and any(
                    kw.arg == "device" and not is_cpu_literal(kw.value) for kw in e.keywords
                ):
                    return True
                if f.attr in _SAME_PLACE:
                    return self.on_card(f.value)
        return False


def is_cpu_literal(e: ast.expr) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(e, ast.Constant):
        return e.value == "cpu"
    if isinstance(e, ast.Call) and (attr_chain(e.func) or "").endswith("device"):
        return bool(e.args) and isinstance(e.args[0], ast.Constant) and e.args[0].value == "cpu"
    return False


_DTYPE_NAMES = re.compile(
    r"^(u?int\d*|float\d*|bfloat16|half|double|bool|long|short|complex\d*|dtype)$"
)


def to_device_arg(call: ast.Call) -> Optional[ast.expr]:
    """The device a ``.to(...)`` call moves its receiver to, or None when
    the call converts only the dtype or moves to the CPU."""
    cand: List[ast.expr] = [kw.value for kw in call.keywords if kw.arg == "device"]
    if call.args:
        cand.append(call.args[0])
    for a in cand:
        if is_cpu_literal(a):
            return None
        chain = attr_chain(a)
        if chain is not None:
            leaf = chain.rsplit(".", 1)[-1]
            if _DTYPE_NAMES.match(leaf):
                continue
            if "dev" in leaf or leaf in ("cuda",) or leaf.startswith("device"):
                return a
            continue
        if isinstance(a, ast.Constant) and isinstance(a.value, str) and a.value.startswith("cuda"):
            return a
        if isinstance(a, ast.Call) and (attr_chain(a.func) or "").endswith("device"):
            return a
        if isinstance(a, ast.Subscript):  # stacks[0][0]: a device of a table
            return a
    return None


def is_cpu_move(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(torch.device("cpu"))`` / ``x.to(device="cpu")``."""
    cand = [kw.value for kw in call.keywords if kw.arg == "device"] + call.args[:1]
    return any(is_cpu_literal(a) for a in cand)
