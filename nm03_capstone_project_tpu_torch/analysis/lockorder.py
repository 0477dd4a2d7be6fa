"""NM42x — static lock-order/deadlock analysis for the port's threaded stack.

The port's copy of the JAX package's ``analysis/lockorder.py``. NM331
makes *unguarded writes* checkable; this module checks lock **ordering**.
The port's serving tier holds locks across long device work by design
(the volume gang parks the batcher for a whole study on four lanes), which
makes acquisition order the one invariant that keeps the thread topology —
handler threads, batcher, lane workers, gang, follower, health poller,
drain threads — deadlock-free.

The analysis builds a **may-hold graph**: every ``with self._lock:`` /
bare ``acquire()`` is an acquisition; while one is held, every further
acquisition reachable through same-tree calls (methods on annotated
attributes, module functions through their imports, ``@contextmanager``
helpers) adds a directed edge ``held -> acquired``. Cross-thread
boundaries (``pool.submit``, ``Thread(target=...)``) deliberately do NOT
propagate the held set — the callee runs on another thread with an empty
stack.

Rules:
  NM421  lock-order cycle: two call paths acquire the same pair of locks in
         opposite order (or a non-reentrant lock may be re-acquired while
         held) — the static deadlock;
  NM422  blocking call while holding a lock: device dispatch
         (``WarmExecutor.run_batch``, ``DispatchSupervisor.run``, a
         ``BucketGraph``'s launch, fetch or capture, the kernel wrappers),
         a host sync (``torch.cuda.synchronize``, ``Event.synchronize``,
         ``.item()``, ``.cpu()``, ``.tolist()``), a CUDA graph
         ``.replay()``, a ``torch.distributed`` collective or barrier,
         HTTP/socket I/O, ``time.sleep``, ``subprocess``, unbounded
         ``.result()`` / ``.join()`` / ``.wait()``, blocking
         ``Queue.get/put`` — outside sanctioned homes (the gang's
         park-the-batcher hold is the canonical reasoned suppression);
  NM423  a bare ``acquire()`` whose ``release()`` is not in a
         ``try/finally`` in the same function.

The runtime twin is :mod:`nm03_capstone_project_tpu_torch.utils.lockdep`:
an instrumented-lock wrapper that records the *observed* acquisition graph
and dumps ``lockdep_witness.json``; :func:`explain_witness` is the gate
(``python -m nm03_capstone_project_tpu_torch.analysis.gate
--lockdep-witness``) — zero observed cycles or inversions, and every
observed edge either present in this module's static graph or targeting an
``obs/`` leaf lock (telemetry locks are verified leaves: they never acquire
outward, so they cannot participate in a cycle).

Stdlib-only like the rest of analysis/ (the gate gates itself).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from nm03_capstone_project_tpu_torch.analysis.core import Finding, SourceFile

PKG = "nm03_capstone_project_tpu_torch"
# telemetry locks are sanctioned leaves: counter bumps under a data lock
# are by design (cheap, bounded) and the leaf property — verified below —
# means they can never close a cycle
LEAF_PREFIX = f"{PKG}/obs/"

_FACTORY_KINDS = {"Lock", "RLock", "Condition"}

# (class, method) pairs that ARE a device dispatch: holding any lock across
# them serializes the fleet behind one mesh program
_DISPATCH_METHODS = {
    "WarmExecutor": {"run_batch"},
    "DispatchSupervisor": {"run"},
    "BucketGraph": {"launch", "fetch", "capture"},
}

# the port's kernel wrappers: a launch under a lock serializes every
# thread behind the card
_KERNEL_WRAPPERS = {
    "vector_median_filter_kernel", "fused_preprocess_kernel", "region_grow_kernel",
    "vector_median_select_kernel", "vector_median_wide_kernel", "region_grow_global_kernel",
    "sharpen_filter_kernel",
}

# host syncs on a tensor, an event or a stream, whatever the receiver
_SYNC_ATTRS = {"item", "cpu", "tolist", "synchronize"}

# torch.distributed entry points that wait on the other ranks
_COLLECTIVES = {
    "broadcast", "broadcast_object_list", "all_reduce", "all_gather",
    "all_gather_object", "all_gather_into_tensor", "reduce", "reduce_scatter",
    "gather", "scatter", "barrier", "monitored_barrier", "send", "recv",
    "batch_isend_irecv", "all_to_all",
}

# attribute calls that block on the network regardless of receiver type
_NET_ATTRS = {"urlopen", "getresponse", "create_connection"}

_MAX_DEPTH = 10

# calls that run a callable on another thread: no held set crosses them
_THREAD_HANDOFFS = {"submit", "map", "Thread", "Timer", "start_new_thread",
                    "run_in_executor"}


def _lockish(name: str) -> bool:
    low = name.lower()
    return "lock" in low or "cond" in low


def _is_property(fn) -> bool:
    """True for ``@property``/``@cached_property`` getters (not setters)."""
    for dec in fn.decorator_list:
        if isinstance(dec, ast.Name) and dec.id in ("property", "cached_property"):
            return True
        if isinstance(dec, ast.Attribute) and dec.attr == "cached_property":
            return True
    return False


# -- graph -------------------------------------------------------------------


class LockNode:
    """One lock identity: a creation site (class attr / module var / local)."""

    __slots__ = ("key", "path", "line", "kind")

    def __init__(self, key: str, path: str, line: int, kind: str):
        self.key = key
        self.path = path
        self.line = line
        self.kind = kind

    @property
    def is_rlock(self) -> bool:
        return self.kind == "RLock"

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"LockNode({self.key}, {self.kind})"


class LockGraph:
    """The static may-hold graph over every lock creation site in the tree.

    ``edges[(a, b)]`` holds the acquisition sites ``(path, line)`` where
    ``b`` may be acquired while ``a`` is held. ``by_site`` maps a creation
    site ``(path, line)`` — exactly what the runtime witness records — back
    to its node, including Condition-alias lines.
    """

    def __init__(self) -> None:
        self.nodes: Dict[str, LockNode] = {}
        self.by_site: Dict[Tuple[str, int], LockNode] = {}
        self.edges: Dict[Tuple[str, str], List[Tuple[str, int]]] = {}
        self.leaf_violations: List[str] = []

    @property
    def leaf_ok(self) -> bool:
        """True when no obs/ lock ever acquires a non-obs lock — the
        property that makes 'target is an obs/ leaf' a valid witness-edge
        explanation."""
        return not self.leaf_violations

    def add_edge(self, src: LockNode, dst: LockNode, site: Tuple[str, int]) -> None:
        sites = self.edges.setdefault((src.key, dst.key), [])
        if site not in sites:
            sites.append(site)
        if src.path.startswith(LEAF_PREFIX) and not dst.path.startswith(LEAF_PREFIX):
            self.leaf_violations.append(
                f"obs/ lock {src.key} acquires non-leaf {dst.key} at "
                f"{site[0]}:{site[1]}"
            )


# -- tree indexing -----------------------------------------------------------


class _Class:
    def __init__(self, mod: "_Module", node: ast.ClassDef):
        self.mod = mod
        self.node = node
        self.name = node.name
        self.methods: Dict[str, ast.FunctionDef] = {}
        self.lock_attrs: Dict[str, LockNode] = {}
        self.attr_types: Dict[str, str] = {}
        self.contextmanagers: Set[str] = set()
        for st in node.body:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods[st.name] = st
                for dec in st.decorator_list:
                    dn = dec.id if isinstance(dec, ast.Name) else (
                        dec.attr if isinstance(dec, ast.Attribute) else None
                    )
                    if dn == "contextmanager":
                        self.contextmanagers.add(st.name)


class _Module:
    def __init__(self, src: SourceFile):
        self.src = src
        self.path = src.relpath
        self.name = src.module_name
        self.imports: Dict[str, str] = {}
        self.functions: Dict[str, ast.FunctionDef] = {}
        self.classes: Dict[str, _Class] = {}
        self.module_locks: Dict[str, LockNode] = {}
        tree = src.tree
        if tree is None:
            return
        pkg_parts = self.name.split(".")
        if not src.is_package:
            pkg_parts = pkg_parts[:-1]
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    self.imports[alias.asname or alias.name.split(".")[0]] = (
                        alias.name if alias.asname else alias.name.split(".")[0]
                    )
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    base = pkg_parts[: len(pkg_parts) - (node.level - 1)]
                    mod_dots = ".".join(base + ([node.module] if node.module else []))
                else:
                    mod_dots = node.module or ""
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    self.imports[alias.asname or alias.name] = (
                        f"{mod_dots}.{alias.name}" if mod_dots else alias.name
                    )
        for st in tree.body:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[st.name] = st
            elif isinstance(st, ast.ClassDef):
                self.classes[st.name] = _Class(self, st)

    def is_factory(self, call: ast.Call) -> Optional[str]:
        """'Lock'/'RLock'/'Condition' when ``call`` creates a sync object."""
        f = call.func
        if (
            isinstance(f, ast.Attribute)
            and isinstance(f.value, ast.Name)
            and f.value.id == "threading"
            and f.attr in _FACTORY_KINDS
        ):
            return f.attr
        if isinstance(f, ast.Name) and self.imports.get(f.id) == f"threading.{f.id}":
            if f.id in _FACTORY_KINDS:
                return f.id
        return None


def _ann_name(node: Optional[ast.expr]) -> Optional[str]:
    """Terminal class name of an annotation, unwrapping Optional/List/etc."""
    if node is None:
        return None
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        head = node.value.strip().split("[")[0].split(".")[-1]
        return head or None
    if isinstance(node, ast.Subscript):
        outer = _ann_name(node.value)
        if outer in ("Optional", "List", "Sequence", "Tuple", "Dict", "Type"):
            inner = node.slice
            if isinstance(inner, ast.Tuple) and inner.elts:
                inner = inner.elts[-1] if outer == "Dict" else inner.elts[0]
            return _ann_name(inner)
        return outer
    return None


class _Index:
    """Cross-file resolution: modules by dotted name, classes by name, every
    function (at any nesting) with its enclosing class and local locks."""

    def __init__(self, files: Sequence[SourceFile]):
        self.graph = LockGraph()
        self.modules: Dict[str, _Module] = {}
        self.class_by_name: Dict[str, _Class] = {}
        self.roots: List[Tuple[_Module, Optional[_Class], ast.FunctionDef, str]] = []
        self.fn_local_locks: Dict[int, Dict[str, LockNode]] = {}
        self.fn_class: Dict[int, Optional[_Class]] = {}
        self.by_path: Dict[str, SourceFile] = {}
        for src in files:
            if src.tree is None or not src.relpath.endswith(".py"):
                continue
            mod = _Module(src)
            self.modules[mod.name] = mod
            self.by_path[src.relpath] = src
            for cname, cls in mod.classes.items():
                self.class_by_name.setdefault(cname, cls)
        for mod in self.modules.values():
            self._collect(mod)

    # -- lock registry --------------------------------------------------

    def _register(self, mod: _Module, key: str, call: ast.Call, kind: str) -> LockNode:
        node = self.graph.nodes.get(key)
        if node is None:
            node = LockNode(key, mod.path, call.lineno, kind)
            self.graph.nodes[key] = node
        self.graph.by_site.setdefault((mod.path, call.lineno), node)
        return node

    def _collect(self, mod: _Module) -> None:
        registered: Set[int] = set()

        def handle_assign(st: ast.stmt, cls: Optional[_Class], qual: str,
                          locals_map: Dict[str, LockNode], in_init: bool) -> None:
            if isinstance(st, ast.AnnAssign):
                targets, value = [st.target], st.value
            elif isinstance(st, ast.Assign):
                targets, value = st.targets, st.value
            else:
                return
            if isinstance(value, (ast.ListComp, ast.List)) and cls is not None:
                # one lock an element (a lane's lock): the list's attribute
                # names every element; the creation site is the factory call
                elt = value.elt if isinstance(value, ast.ListComp) else (
                    value.elts[0] if value.elts else None)
                tgt = targets[0]
                if (
                    isinstance(elt, ast.Call)
                    and mod.is_factory(elt) is not None
                    and isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"
                ):
                    node = self._register(
                        mod, f"{mod.path}:{cls.name}.{tgt.attr}[]", elt, mod.is_factory(elt)
                    )
                    registered.add(elt.lineno)
                    cls.lock_attrs[tgt.attr] = node
                return
            if not isinstance(value, ast.Call):
                # Condition alias of an alias / plain rebinds: ignore
                return
            kind = mod.is_factory(value)
            if kind is None:
                return
            tgt = targets[0]
            node: Optional[LockNode] = None
            if kind == "Condition" and value.args:
                arg = value.args[0]
                aliased: Optional[LockNode] = None
                if (
                    isinstance(arg, ast.Attribute)
                    and isinstance(arg.value, ast.Name)
                    and arg.value.id == "self"
                    and cls is not None
                ):
                    aliased = cls.lock_attrs.get(arg.attr)
                elif isinstance(arg, ast.Name):
                    aliased = locals_map.get(arg.id) or mod.module_locks.get(arg.id)
                if aliased is not None:
                    # the Condition IS the lock: same node, extra site/name
                    node = aliased
                    self.graph.by_site.setdefault((mod.path, value.lineno), node)
            if node is None:
                if (
                    in_init
                    and cls is not None
                    and isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"
                ):
                    node = self._register(
                        mod, f"{mod.path}:{cls.name}.{tgt.attr}", value, kind
                    )
                elif isinstance(tgt, ast.Name) and not qual:
                    node = self._register(mod, f"{mod.path}:{tgt.id}", value, kind)
                elif isinstance(tgt, ast.Name):
                    node = self._register(
                        mod, f"{mod.path}:{qual}.{tgt.id}", value, kind
                    )
                else:
                    node = self._register(
                        mod, f"{mod.path}:{value.lineno}", value, kind
                    )
            registered.add(value.lineno)
            if (
                in_init
                and cls is not None
                and isinstance(tgt, ast.Attribute)
                and isinstance(tgt.value, ast.Name)
                and tgt.value.id == "self"
            ):
                cls.lock_attrs[tgt.attr] = node
            elif isinstance(tgt, ast.Name):
                if qual:
                    locals_map[tgt.id] = node
                else:
                    mod.module_locks[tgt.id] = node

        def visit(stmts: Iterable[ast.stmt], cls: Optional[_Class], qual: str,
                  locals_map: Dict[str, LockNode], in_init: bool) -> None:
            for st in stmts:
                if isinstance(st, ast.ClassDef):
                    c = mod.classes.get(st.name) if not qual else _Class(mod, st)
                    visit(st.body, c, "", {}, False)
                    continue
                if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    fq = f"{qual}.{st.name}" if qual else (
                        f"{cls.name}.{st.name}" if cls else st.name
                    )
                    fl: Dict[str, LockNode] = {}
                    self.fn_local_locks[id(st)] = fl
                    self.fn_class[id(st)] = cls
                    self.roots.append((mod, cls, st, fq))
                    visit(
                        st.body, cls, fq, fl,
                        in_init=(cls is not None and st.name == "__init__"),
                    )
                    continue
                handle_assign(st, cls, qual, locals_map, in_init)
                for child in ast.iter_child_nodes(st):
                    if isinstance(child, ast.stmt):
                        visit([child], cls, qual, locals_map, in_init)
        if mod.src.tree is not None:
            visit(mod.src.tree.body, None, "", {}, False)
            # attr types AFTER lock registry (annotated __init__ params etc.)
            for cls in mod.classes.values():
                self._class_attr_types(mod, cls)
            # mop-up: factory calls not in a simple assignment still need a
            # node — the runtime witness maps every package creation site
            for node in ast.walk(mod.src.tree):
                if isinstance(node, ast.Call) and node.lineno not in registered:
                    kind = mod.is_factory(node)
                    if kind is not None:
                        self._register(mod, f"{mod.path}:{node.lineno}", node, kind)

    def _class_attr_types(self, mod: _Module, cls: _Class) -> None:
        init = cls.methods.get("__init__")
        if init is None:
            return
        param_types: Dict[str, str] = {}
        for arg in list(init.args.args) + list(init.args.kwonlyargs):
            t = _ann_name(arg.annotation)
            if t:
                param_types[arg.arg] = t
        for st in ast.walk(init):
            tgt = None
            value = None
            ann = None
            if isinstance(st, ast.Assign) and len(st.targets) == 1:
                tgt, value = st.targets[0], st.value
            elif isinstance(st, ast.AnnAssign):
                tgt, value, ann = st.target, st.value, st.annotation
            if (
                tgt is None
                or not isinstance(tgt, ast.Attribute)
                or not isinstance(tgt.value, ast.Name)
                or tgt.value.id != "self"
            ):
                continue
            t = _ann_name(ann) if ann is not None else None
            if t is None and isinstance(value, ast.Name):
                t = param_types.get(value.id)
            if t is None and isinstance(value, ast.Call):
                t = self._ctor_name(mod, value)
            if t is None and isinstance(value, ast.BoolOp):
                for v in value.values:
                    if isinstance(v, ast.Name) and v.id in param_types:
                        t = param_types[v.id]
                        break
                    if isinstance(v, ast.Call):
                        t = self._ctor_name(mod, v)
                        if t:
                            break
            if t:
                cls.attr_types.setdefault(tgt.attr, t)

    def _ctor_name(self, mod: _Module, call: ast.Call) -> Optional[str]:
        f = call.func
        name = None
        if isinstance(f, ast.Name):
            name = f.id
        elif isinstance(f, ast.Attribute):
            name = f.attr
        if name and name in self.class_by_name:
            return name
        if isinstance(f, ast.Name):
            dotted = mod.imports.get(f.id)
            if dotted and dotted.split(".")[-1] in self.class_by_name:
                return dotted.split(".")[-1]
        # method call with a return annotation (factory methods)
        if isinstance(f, ast.Attribute):
            target = None
            if isinstance(f.value, ast.Name) and f.value.id == "self":
                pass  # resolved at simulation time with a class context
            if target is None:
                for cls in self.class_by_name.values():
                    m = cls.methods.get(f.attr)
                    if m is not None and _ann_name(m.returns):
                        # ambiguous across classes; only accept unique names
                        candidates = {
                            _ann_name(c.methods[f.attr].returns)
                            for c in self.class_by_name.values()
                            if f.attr in c.methods
                        }
                        if len(candidates) == 1:
                            return candidates.pop()
                        break
        return None

    def resolve_dotted(self, dotted: str):
        """('fn', mod, cls, fndef) | ('module', mod) | ('class', cls) | None."""
        for _ in range(3):
            mod = self.modules.get(dotted)
            if mod is not None:
                return ("module", mod)
            head, _, tail = dotted.rpartition(".")
            if not head:
                return None
            parent = self.modules.get(head)
            if parent is None:
                return None
            if tail in parent.functions:
                return ("fn", parent, None, parent.functions[tail])
            if tail in parent.classes:
                return ("class", parent.classes[tail])
            re_export = parent.imports.get(tail)
            if re_export is None:
                return None
            dotted = re_export
        return None


# -- simulation --------------------------------------------------------------


class _Ctx:
    __slots__ = ("mod", "cls", "fn", "locals_types", "report", "depth",
                 "lock_aliases", "nested")

    def __init__(self, mod, cls, fn, report, depth, outer: Optional["_Ctx"] = None):
        self.mod = mod
        self.cls = cls
        self.fn = fn
        self.report = report
        self.depth = depth
        self.locals_types: Dict[str, str] = {}
        # local names bound to a lock (``lane_lock = self._lane_locks[i]``)
        # and the closures defined in this body; a closure sees its
        # enclosing function's
        self.lock_aliases: Dict[str, LockNode] = dict(outer.lock_aliases) if outer else {}
        self.nested: Dict[str, ast.FunctionDef] = dict(outer.nested) if outer else {}
        if outer is not None:
            self.locals_types.update(outer.locals_types)
        for arg in list(fn.args.args) + list(fn.args.kwonlyargs):
            t = _ann_name(arg.annotation)
            if t:
                self.locals_types[arg.arg] = t
        stack = list(fn.body)
        while stack:
            st = stack.pop()
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.nested[st.name] = st
                continue
            if isinstance(st, ast.ClassDef):
                continue
            stack.extend(c for c in ast.iter_child_nodes(st) if isinstance(c, ast.stmt))


class _Sim:
    def __init__(self, index: _Index):
        self.index = index
        self.graph = index.graph
        self.findings: List[Finding] = []
        self._reported: Set[Tuple[str, str, int]] = set()
        self._visited: Set[Tuple[int, Tuple[str, ...], bool]] = set()
        self._cm_memo: Dict[int, List[LockNode]] = {}

    # -- entry points ---------------------------------------------------

    def run_all_roots(self) -> None:
        for mod, cls, fn, _qual in self.index.roots:
            self.visit_fn(mod, cls, fn, held=[], report=True, depth=0)

    def visit_fn(self, mod, cls, fn, held: List[LockNode], report: bool,
                 depth: int, outer: Optional[_Ctx] = None) -> None:
        if depth > _MAX_DEPTH:
            return
        key = (id(fn), tuple(sorted({h.key for h in held})), report)
        if key in self._visited:
            return
        self._visited.add(key)
        ctx = _Ctx(mod, cls, fn, report, depth, outer)
        extra: List[LockNode] = []  # bare-acquire stack, popped at exit
        self._walk_body(ctx, fn.body, held, extra)
        for _ in extra:
            held.pop()

    # -- statements -----------------------------------------------------

    def _walk_body(self, ctx, stmts, held, extra) -> None:
        for st in stmts:
            self._walk_stmt(ctx, st, held, extra)

    def _walk_stmt(self, ctx, st, held, extra) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # nested defs do not execute here (closure != call)
        if isinstance(st, (ast.With, ast.AsyncWith)):
            acquired: List[LockNode] = []
            for item in st.items:
                self._walk_expr(ctx, item.context_expr, held)
                for node in self._with_locks(ctx, item.context_expr):
                    self._record_acquire(ctx, node, item.context_expr.lineno, held)
                    held.append(node)
                    acquired.append(node)
            self._walk_body(ctx, st.body, held, extra)
            for _ in acquired:
                held.pop()
            return
        if isinstance(st, ast.Try):
            self._walk_body(ctx, st.body, held, extra)
            for h in st.handlers:
                self._walk_body(ctx, h.body, held, extra)
            self._walk_body(ctx, st.orelse, held, extra)
            self._walk_body(ctx, st.finalbody, held, extra)
            return
        if isinstance(st, ast.Assign):
            self._walk_expr(ctx, st.value, held)
            self._infer_assign(ctx, st)
            # bare acquire/release tracked through _walk_expr; nothing else
            return
        if isinstance(st, (ast.Expr, ast.Return, ast.Raise, ast.Assert,
                           ast.AnnAssign, ast.AugAssign, ast.Delete)):
            for child in ast.iter_child_nodes(st):
                if isinstance(child, ast.expr):
                    self._walk_expr(ctx, child, held, extra)
            return
        # control flow: tests/iters are expressions, bodies are statements
        for child in ast.iter_child_nodes(st):
            if isinstance(child, ast.expr):
                self._walk_expr(ctx, child, held, extra)
            elif isinstance(child, ast.stmt):
                self._walk_stmt(ctx, child, held, extra)

    def _infer_assign(self, ctx, st: ast.Assign) -> None:
        if len(st.targets) != 1 or not isinstance(st.targets[0], ast.Name):
            return
        node = self._resolve_lock_expr(ctx, st.value)
        if node is not None:
            ctx.lock_aliases[st.targets[0].id] = node
            return
        t = self._expr_type(ctx, st.value)
        if t:
            ctx.locals_types[st.targets[0].id] = t

    # -- expressions ----------------------------------------------------

    def _walk_expr(self, ctx, expr, held, extra=None) -> None:
        # all calls in the expression, same-execution only (no lambdas)
        stack = [expr]
        calls: List[ast.Call] = []
        attrs: List[ast.Attribute] = []
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.Lambda, ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(node, ast.Call):
                calls.append(node)
            elif isinstance(node, ast.Attribute):
                attrs.append(node)
            stack.extend(ast.iter_child_nodes(node))
        for call in sorted(calls, key=lambda c: (c.lineno, c.col_offset)):
            self._handle_call(ctx, call, held, extra)
        if held:
            # @property getters execute on attribute ACCESS — the
            # lane_count-under-the-pool-lock edge is invisible to a
            # calls-only walk (the runtime witness caught exactly that)
            call_funcs = {id(c.func) for c in calls}
            for a in sorted(attrs, key=lambda a: (a.lineno, a.col_offset)):
                if id(a) not in call_funcs:
                    self._handle_property(ctx, a, held)

    def _handle_property(self, ctx, attr: ast.Attribute, held) -> None:
        bt = self._expr_type(ctx, attr.value)
        if not bt:
            return
        cls = self.index.class_by_name.get(bt)
        if cls is None:
            return
        fn = cls.methods.get(attr.attr)
        if fn is None or not _is_property(fn):
            return
        self.visit_fn(cls.mod, cls, fn, held, report=ctx.report,
                      depth=ctx.depth + 1)

    def _handle_call(self, ctx, call: ast.Call, held, extra) -> None:
        func = call.func
        # bare acquire/release on a lock-like receiver
        if isinstance(func, ast.Attribute) and func.attr in ("acquire", "release"):
            node = self._resolve_lock_expr(ctx, func.value)
            if node is None and _terminal_name(func.value) and _lockish(
                _terminal_name(func.value)
            ):
                node = None  # lockish but unresolved: NM423 still covers it
            if node is not None:
                if func.attr == "acquire":
                    self._record_acquire(ctx, node, call.lineno, held)
                    held.append(node)
                    if extra is not None:
                        extra.append(node)
                else:
                    for i in range(len(held) - 1, -1, -1):
                        if held[i].key == node.key:
                            held.pop(i)
                            if extra is not None and node in extra:
                                extra.remove(node)
                            break
                return
        blocking = self._blocking_reason(ctx, call)
        if blocking is not None:
            if held and ctx.report:
                self._emit_nm422(ctx, call, blocking, held)
            target = self._resolve_call(ctx, call)
            if target is not None and held:
                # keep walking for graph completeness, but the finding at
                # THIS site already covers everything the callee blocks on
                self.visit_fn(target[1], target[2], target[3], held,
                              report=False, depth=ctx.depth + 1)
            if held:
                self._inline_closures(ctx, call, held, report=False)
            return
        if not held:
            return  # the callee is simulated as its own root anyway
        self._inline_closures(ctx, call, held)
        target = self._resolve_call(ctx, call)
        if target is not None:
            self.visit_fn(target[1], target[2], target[3], held,
                          report=ctx.report, depth=ctx.depth + 1)

    def _inline_closures(self, ctx, call: ast.Call, held, report: bool = True) -> None:
        """A closure or lambda passed to a call may run on this thread,
        under ``held`` (a supervisor runs its primary inline when it has no
        deadline) — unless the call hands it to another thread."""
        func = call.func
        name = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else "")
        if name in _THREAD_HANDOFFS:
            return
        for arg in list(call.args) + [kw.value for kw in call.keywords
                                      if kw.arg != "target"]:
            if isinstance(arg, ast.Name) and arg.id in ctx.nested:
                self.visit_fn(ctx.mod, ctx.cls, ctx.nested[arg.id], held,
                              report=False, depth=ctx.depth + 1, outer=ctx)
            elif isinstance(arg, ast.Lambda):
                # the call site's finding (a blocking call) covers the body
                was, ctx.report = ctx.report, ctx.report and report
                try:
                    self._walk_expr(ctx, arg.body, held)
                finally:
                    ctx.report = was

    # -- lock resolution ------------------------------------------------

    def _resolve_lock_expr(self, ctx, expr) -> Optional[LockNode]:
        if isinstance(expr, ast.Subscript):
            # an element of a list of locks: ``self._lane_locks[lane]``
            return self._resolve_lock_expr(ctx, expr.value)
        if isinstance(expr, ast.Name) and expr.id in ctx.lock_aliases:
            return ctx.lock_aliases[expr.id]
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and ctx.cls is not None
        ):
            return ctx.cls.lock_attrs.get(expr.attr)
        if isinstance(expr, ast.Name):
            local = self.index.fn_local_locks.get(id(ctx.fn), {})
            node = local.get(expr.id)
            if node is not None:
                return node
            return ctx.mod.module_locks.get(expr.id)
        return None

    def _with_locks(self, ctx, expr) -> List[LockNode]:
        node = self._resolve_lock_expr(ctx, expr)
        if node is not None:
            return [node]
        if isinstance(expr, ast.Call):
            target = self._resolve_call(ctx, expr)
            if target is not None:
                _, mod, cls, fn = target
                if cls is not None and fn.name in cls.contextmanagers:
                    return self._cm_yield_locks(mod, cls, fn)
                if cls is None:
                    # module-level @contextmanager helpers
                    for dec in fn.decorator_list:
                        dn = dec.id if isinstance(dec, ast.Name) else (
                            dec.attr if isinstance(dec, ast.Attribute) else None
                        )
                        if dn == "contextmanager":
                            return self._cm_yield_locks(mod, cls, fn)
        return []

    def _cm_yield_locks(self, mod, cls, fn) -> List[LockNode]:
        """Locks held at the (first) ``yield`` of a @contextmanager — those
        stay held for the caller's entire with-body (gang_parked)."""
        memo = self._cm_memo.get(id(fn))
        if memo is not None:
            return memo
        ctx = _Ctx(mod, cls, fn, report=False, depth=_MAX_DEPTH)
        out: List[LockNode] = []

        def find(stmts, stack: List[LockNode]) -> bool:
            for st in stmts:
                if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                    continue
                if isinstance(st, (ast.With, ast.AsyncWith)):
                    acquired = []
                    for item in st.items:
                        for node in self._with_locks(ctx, item.context_expr):
                            stack.append(node)
                            acquired.append(node)
                    hit = find(st.body, stack)
                    for _ in acquired:
                        stack.pop()
                    if hit:
                        return True
                    continue
                for sub in ast.walk(st):
                    if isinstance(sub, (ast.Yield, ast.YieldFrom)):
                        out.extend(stack)
                        return True
                if isinstance(st, (ast.Try, ast.If, ast.For, ast.While)):
                    pass  # ast.walk above already searched the subtree
            return False

        find(fn.body, [])
        self._cm_memo[id(fn)] = out
        return out

    # -- call resolution ------------------------------------------------

    def _expr_type(self, ctx, expr) -> Optional[str]:
        if isinstance(expr, ast.Name):
            if expr.id == "self" and ctx.cls is not None:
                return ctx.cls.name
            return ctx.locals_types.get(expr.id)
        if isinstance(expr, ast.Attribute):
            bt = self._expr_type(ctx, expr.value)
            if bt:
                cls = self.index.class_by_name.get(bt)
                if cls is not None:
                    return cls.attr_types.get(expr.attr)
            return None
        if isinstance(expr, ast.Subscript):
            return self._expr_type(ctx, expr.value)
        if isinstance(expr, ast.Call):
            target = self._resolve_call(ctx, expr)
            if target is None:
                return None
            _, _mod, tcls, fn = target
            if fn.name == "__init__" and tcls is not None:
                return tcls.name
            return _ann_name(fn.returns)
        if isinstance(expr, ast.BoolOp):
            for v in expr.values:
                t = self._expr_type(ctx, v)
                if t:
                    return t
        return None

    def _resolve_call(self, ctx, call: ast.Call):
        """('fn', mod, cls_or_None, fndef) for same-tree callables."""
        func = call.func
        if isinstance(func, ast.Name):
            fn = ctx.mod.functions.get(func.id)
            if fn is not None:
                return ("fn", ctx.mod, None, fn)
            cls = ctx.mod.classes.get(func.id)
            if cls is None:
                dotted = ctx.mod.imports.get(func.id)
                if dotted:
                    resolved = self.index.resolve_dotted(dotted)
                    if resolved is None:
                        return None
                    if resolved[0] == "fn":
                        return resolved
                    if resolved[0] == "class":
                        cls = resolved[1]
            if cls is not None:
                init = cls.methods.get("__init__")
                if init is not None:
                    return ("fn", cls.mod, cls, init)
            return None
        if not isinstance(func, ast.Attribute):
            return None
        base, mname = func.value, func.attr
        # module.function()
        if isinstance(base, ast.Name):
            dotted = ctx.mod.imports.get(base.id)
            if dotted:
                resolved = self.index.resolve_dotted(f"{dotted}.{mname}")
                if resolved is not None and resolved[0] == "fn":
                    return resolved
                if resolved is not None and resolved[0] == "class":
                    cls = resolved[1]
                    init = cls.methods.get("__init__")
                    if init is not None:
                        return ("fn", cls.mod, cls, init)
        bt = self._expr_type(ctx, base)
        if bt:
            cls = self.index.class_by_name.get(bt)
            if cls is not None:
                m = cls.methods.get(mname)
                if m is not None:
                    return ("fn", cls.mod, cls, m)
        return None

    # -- blocking table --------------------------------------------------

    def _blocking_reason(self, ctx, call: ast.Call) -> Optional[str]:
        func = call.func
        noargs = not call.args and not call.keywords
        if isinstance(func, ast.Name):
            if func.id == "sleep" and ctx.mod.imports.get("sleep") == "time.sleep":
                return "time.sleep()"
            if func.id == "urlopen":
                return "urlopen() network I/O"
            if func.id in _KERNEL_WRAPPERS:
                return f"kernel launch {func.id}()"
            dotted = ctx.mod.imports.get(func.id, "")
            if dotted.startswith("torch.distributed.") and func.id in _COLLECTIVES:
                return f"torch.distributed.{func.id}() collective"
            return None
        if not isinstance(func, ast.Attribute):
            return None
        base, m = func.value, func.attr
        if isinstance(base, ast.Name):
            if base.id == "time" and m == "sleep":
                return "time.sleep()"
            if base.id == "subprocess":
                return f"subprocess.{m}()"
            if m in _COLLECTIVES and ctx.mod.imports.get(base.id) == "torch.distributed":
                return f"torch.distributed.{m}() collective"
        if m in _COLLECTIVES and _dotted_name(base) == "torch.distributed":
            return f"torch.distributed.{m}() collective"
        if m in _KERNEL_WRAPPERS:
            return f"kernel launch {m}()"
        if m == "synchronize" or (m in _SYNC_ATTRS and noargs):
            return f".{m}() host sync"
        if m == "replay" and noargs:
            return "CUDA graph .replay()"
        if m in _NET_ATTRS:
            return f".{m}() network I/O"
        if m == "result" and noargs:
            return ".result() with no timeout"
        if m == "join" and noargs:
            return ".join() with no timeout"
        if m == "wait" and noargs:
            return ".wait() with no timeout"
        if m in ("get", "put"):
            bt = self._expr_type(ctx, base)
            if bt in ("Queue", "SimpleQueue", "LifoQueue", "PriorityQueue"):
                for kw in call.keywords:
                    if kw.arg == "block" and isinstance(kw.value, ast.Constant) \
                            and kw.value.value is False:
                        return None
                    if kw.arg == "timeout":
                        return None
                return f"blocking Queue.{m}()"
            return None
        bt = self._expr_type(ctx, base)
        if bt and m in _DISPATCH_METHODS.get(bt, ()):
            return f"device dispatch {bt}.{m}()"
        return None

    # -- recording -------------------------------------------------------

    def _record_acquire(self, ctx, node: LockNode, line: int, held) -> None:
        site = (ctx.mod.path, line)
        for h in held:
            if h.key == node.key:
                if node.is_rlock:
                    continue  # reentrant by construction
                self._emit(
                    "NM421", ctx, line,
                    f"non-reentrant lock {node.key} may be re-acquired while "
                    "already held (self-deadlock); use an RLock or drop the "
                    "nested acquisition",
                )
                continue
            self.graph.add_edge(h, node, site)

    def _emit_nm422(self, ctx, call: ast.Call, desc: str, held) -> None:
        inner = held[-1]
        more = f" (+{len(held) - 1} more)" if len(held) > 1 else ""
        self._emit(
            "NM422", ctx, call.lineno,
            f"{desc} while holding {inner.key}{more} — blocking under a lock "
            "stalls every thread behind it; move it outside the critical "
            "section (or suppress with the reason the hold is by design)",
        )

    def _emit(self, rule: str, ctx, line: int, message: str) -> None:
        key = (rule, ctx.mod.path, line)
        if key in self._reported:
            return
        self._reported.add(key)
        self.findings.append(
            Finding(
                rule=rule,
                path=ctx.mod.path,
                line=line,
                message=message,
                source_line=ctx.mod.src.line_text(line),
            )
        )


def _dotted_name(expr) -> Optional[str]:
    """'torch.distributed' for a Name/Attribute chain; None otherwise."""
    parts: List[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if not isinstance(expr, ast.Name):
        return None
    parts.append(expr.id)
    return ".".join(reversed(parts))


def _terminal_name(expr) -> Optional[str]:
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return None


# -- NM421: cycles over the finished graph ------------------------------------


def _find_cycle(adj: Dict[str, Set[str]]) -> Optional[List[str]]:
    """One directed cycle (as a node path, first node repeated last)."""
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {n: WHITE for n in adj}
    path: List[str] = []

    def dfs(n: str) -> Optional[List[str]]:
        color[n] = GRAY
        path.append(n)
        for nxt in sorted(adj.get(n, ())):
            if color.get(nxt, WHITE) == GRAY:
                i = path.index(nxt)
                return path[i:] + [nxt]
            if color.get(nxt, WHITE) == WHITE:
                found = dfs(nxt)
                if found:
                    return found
        path.pop()
        color[n] = BLACK
        return None

    for n in sorted(adj):
        if color[n] == WHITE:
            found = dfs(n)
            if found:
                return found
    return None


def _cycle_findings(index: _Index) -> List[Finding]:
    graph = index.graph
    adj: Dict[str, Set[str]] = {}
    for (a, b) in graph.edges:
        if a != b:
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set())
    out: List[Finding] = []
    seen: Set[frozenset] = set()
    while True:
        cycle = _find_cycle(adj)
        if cycle is None:
            break
        nodes = cycle[:-1]
        key = frozenset(nodes)
        # break the cycle so the search can surface any OTHER cycle
        adj[nodes[-1]].discard(cycle[-1] if len(nodes) == 1 else nodes[0])
        if key in seen:
            continue
        seen.add(key)
        legs = []
        sites: List[Tuple[str, int]] = []
        for a, b in zip(cycle, cycle[1:]):
            at = graph.edges.get((a, b), [("?", 0)])[0]
            legs.append(f"{a} -> {b} (at {at[0]}:{at[1]})")
            sites.append(at)
        real = [s for s in sites if s[1]]
        anchor = min(real) if real else (legs and sites[0]) or ("?", 1)
        src = index.by_path.get(anchor[0])
        out.append(
            Finding(
                rule="NM421",
                path=anchor[0],
                line=anchor[1],
                message=(
                    "lock-order cycle — two paths acquire the same locks in "
                    "opposite order: " + "; ".join(legs)
                ),
                source_line=src.line_text(anchor[1]) if src else "",
            )
        )
    return out


# -- NM423: unbalanced bare acquire -------------------------------------------


def _balance_findings(files: Sequence[SourceFile]) -> List[Finding]:
    out: List[Finding] = []
    for src in files:
        if src.tree is None:
            continue
        for fn in ast.walk(src.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            acquires: List[Tuple[ast.Call, str]] = []
            released: Set[str] = set()
            for node in ast.walk(fn):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and node is not fn:
                    continue
                if isinstance(node, ast.Try):
                    for f_st in node.finalbody:
                        for sub in ast.walk(f_st):
                            if (
                                isinstance(sub, ast.Call)
                                and isinstance(sub.func, ast.Attribute)
                                and sub.func.attr == "release"
                            ):
                                released.add(ast.dump(sub.func.value))
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "acquire"
                ):
                    recv = _terminal_name(node.func.value)
                    if recv and _lockish(recv):
                        acquires.append((node, ast.dump(node.func.value)))
            for call, dump in acquires:
                if dump in released:
                    continue
                out.append(
                    Finding(
                        rule="NM423",
                        path=src.relpath,
                        line=call.lineno,
                        message=(
                            "bare acquire() without a release() in a "
                            "try/finally in the same function — an exception "
                            "between them wedges every later acquirer; use "
                            "'with' or a try/finally"
                        ),
                        source_line=src.line_text(call.lineno),
                    )
                )
    return out


# -- public API ---------------------------------------------------------------


def build_lock_graph(files: Sequence[SourceFile]) -> LockGraph:
    """The static may-hold graph alone (the witness gate's reference)."""
    index = _Index(files)
    sim = _Sim(index)
    sim.run_all_roots()
    return index.graph


def check_lock_order(files: Sequence[SourceFile]) -> List[Finding]:
    """NM421 + NM422 + NM423 over the whole file set."""
    files = [f for f in files if f.tree is not None]
    index = _Index(files)
    sim = _Sim(index)
    sim.run_all_roots()
    findings = list(sim.findings)
    findings.extend(_cycle_findings(index))
    findings.extend(_balance_findings(files))
    return findings


# -- the witness gate ---------------------------------------------------------


def explain_witness(witness: dict, graph: LockGraph) -> List[str]:
    """Problems that fail ``gate --lockdep-witness`` (empty = pass).

    A witness passes when it has zero recorded inversions, its observed
    acquisition-order graph is acyclic, every package lock site it saw is
    in the static registry, and every observed edge is *explained*: present
    in the static may-hold graph, or targeting an ``obs/`` leaf lock while
    the leaf discipline holds statically (obs/ locks never acquire outward,
    so a leaf edge cannot close a cycle).
    """
    problems: List[str] = []
    sitemap: Dict[str, Optional[str]] = {}
    for s in witness.get("sites", []):
        sid = s.get("id", f"{s.get('path')}:{s.get('line')}")
        node = graph.by_site.get((s.get("path"), int(s.get("line", 0))))
        if node is not None:
            sitemap[sid] = node.key
        elif str(s.get("path", "")).startswith(f"{PKG}/"):
            sitemap[sid] = None
            problems.append(
                f"witness lock site {s.get('path')}:{s.get('line')} is not in "
                "the static lock registry (analysis/lockorder.py cannot see "
                "this creation site — fix the registry, not the witness)"
            )
        else:
            sitemap[sid] = sid  # non-package site (fixtures): identity-mapped
    for inv in witness.get("inversions", []):
        problems.append(
            "observed lock-order inversion: "
            f"{inv.get('first')} -> {inv.get('second')} after the opposite "
            f"order was seen; stacks: {inv.get('stack')} vs "
            f"{inv.get('prior_stack')}"
        )
    adj: Dict[str, Set[str]] = {}
    observed: List[Tuple[str, str, dict]] = []
    for e in witness.get("edges", []):
        a = sitemap.get(e.get("src"))
        b = sitemap.get(e.get("dst"))
        if a is None or b is None:
            continue  # unregistered package site: already a problem above
        observed.append((a, b, e))
        if a != b:
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set())
    cycle = _find_cycle(adj)
    if cycle is not None:
        problems.append(
            "observed acquisition-order graph has a cycle: "
            + " -> ".join(cycle)
        )
    static_edges = set(graph.edges)
    for a, b, e in observed:
        if (a, b) in static_edges:
            continue
        na, nb = graph.nodes.get(a), graph.nodes.get(b)
        if na is None or nb is None:
            continue  # fixture locks have no static story to check
        if (
            nb.path.startswith(LEAF_PREFIX)
            and not na.path.startswith(LEAF_PREFIX)
            and graph.leaf_ok
        ):
            continue
        problems.append(
            f"observed edge {a} -> {b} (count {e.get('count', 1)}) is not "
            "explained by the static may-hold graph — either the static "
            "analysis is blind to this path (add the type annotation it "
            "needs) or the runtime took an unvetted lock order"
        )
    problems.extend(
        f"static leaf violation: {v}" for v in graph.leaf_violations
    )
    return problems
