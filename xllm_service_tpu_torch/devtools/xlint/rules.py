"""The xlint rule implementations (each a small pass over the whole tree)."""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Optional

from . import SourceFile, Violation

# Scopes where a lock attribute may legitimately be declared. `setup` is
# the socketserver handler analog of __init__.
DECL_METHODS = {"__init__", "setup", "__post_init__"}

# threading factories that produce a lock-like object.
LOCK_FACTORIES = {"Lock", "RLock", "Condition"}

# asyncio factories: `async with self._alock` participates in the same
# declaration/annotation/ordering machinery as the threaded locks (the
# event loop serializes coroutines, but await points inside an async
# critical section interleave other coroutines — ordering still matters).
ASYNC_LOCK_FACTORIES = {"Lock", "Semaphore", "BoundedSemaphore", "Condition"}

# EngineChannel control-plane methods: calling any of these is an RPC.
CHANNEL_METHODS = {"forward", "forward_status", "health", "link", "unlink",
                   "flip_role", "models"}

# Method names too generic to resolve to one project class for the
# call-graph half of the lock-order rule (dict/queue/socket/file methods
# would alias them and fabricate edges).
GENERIC_NAMES = {
    "get", "put", "pop", "set", "add", "clear", "close", "release", "start",
    "stop", "join", "wait", "send", "read", "write", "open", "run", "update",
    "append", "remove", "submit", "flush", "encode", "decode", "render",
    "value", "count", "mean", "stats", "meta", "register", "push", "cancel",
    "step", "fire", "check", "items", "keys", "values", "acquire", "copy",
    "extend", "discard", "setdefault", "sleep", "log",
}

LOG_METHODS = {"exception", "warning", "error", "info", "debug", "critical",
               "log"}

#: Dirs (path segments) where the broad-except rule is enforced.
EXCEPT_SCOPED_DIRS = {"scheduler", "rpc", "coordination", "engine"}


# --------------------------------------------------------------- AST helpers
def _expr_text(node: ast.AST) -> str:
    """Dotted-path text for Name/Attribute/Call chains ('' if unprintable)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _expr_text(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    if isinstance(node, ast.Call):
        base = _expr_text(node.func)
        return f"{base}()" if base else ""
    return ""


def _lock_factory_kind(node: ast.AST) -> Optional[str]:
    """'threading' | 'make_lock' when `node` constructs a lock; else None.
    Handles `A if cond else B` declarations (either arm a lock call)."""
    if isinstance(node, ast.IfExp):
        return _lock_factory_kind(node.body) or _lock_factory_kind(node.orelse)
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in LOCK_FACTORIES \
            and _expr_text(f.value) == "threading":
        return "threading"
    if isinstance(f, ast.Attribute) and f.attr in ASYNC_LOCK_FACTORIES \
            and _expr_text(f.value) == "asyncio":
        return "asyncio"
    if isinstance(f, ast.Name) and f.id in LOCK_FACTORIES:
        return "threading"
    if (isinstance(f, ast.Name) and f.id == "make_lock") or \
            (isinstance(f, ast.Attribute) and f.attr == "make_lock"):
        return "make_lock"
    return None


def _make_lock_order_kwarg(node: ast.AST) -> Optional[int]:
    if isinstance(node, ast.IfExp):
        return _make_lock_order_kwarg(node.body) \
            if _lock_factory_kind(node.body) == "make_lock" \
            else _make_lock_order_kwarg(node.orelse)
    if isinstance(node, ast.Call):
        for kw in node.keywords:
            if kw.arg == "order" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, int):
                return kw.value.value
    return None


def _first_str_arg(call: ast.Call) -> Optional[str]:
    if call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, str):
        return call.args[0].value
    return None


def _registry_dict(f: SourceFile, name: str) -> dict[str, int]:
    """Top-level ``NAME = {...}`` / ``NAME: dict[...] = {...}`` string-key
    registry → {key: lineno}. Handling AnnAssign matters: the real
    registries are type-annotated, and an Assign-only parse silently turns
    the whole rule into a no-op (which is exactly what happened to the
    fault/span rules between their landing and this helper)."""
    out: dict[str, int] = {}
    for node in f.tree.body:
        if isinstance(node, ast.Assign):
            targets = node.targets
            value = node.value
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
            value = node.value
        else:
            continue
        if not isinstance(value, ast.Dict) or not any(
                isinstance(t, ast.Name) and t.id == name for t in targets):
            continue
        for k in value.keys:
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                out[k.value] = k.lineno
    return out


def _registry_items(f: SourceFile, name: str) -> "dict[str, tuple[Optional[str], int]]":
    """Like :func:`_registry_dict` but also captures constant-string
    VALUES → {key: (value-or-None, lineno)} — for registries whose value
    carries machine-readable structure (the RCU publication specs)."""
    out: dict[str, tuple[Optional[str], int]] = {}
    for node in f.tree.body:
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign):
            targets, value = [node.target], node.value
        else:
            continue
        if not isinstance(value, ast.Dict) or not any(
                isinstance(t, ast.Name) and t.id == name for t in targets):
            continue
        for k, v in zip(value.keys, value.values):
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                val = v.value if isinstance(v, ast.Constant) \
                    and isinstance(v.value, str) else None
                out[k.value] = (val, k.lineno)
    return out


# ------------------------------------------------------------- project model
@dataclass
class LockDecl:
    key: tuple[str, str]          # (class name or "<module>", attr name)
    file: SourceFile
    line: int
    kind: str                     # "threading" | "make_lock"
    order: Optional[int]          # from the # lock-order comment
    kwarg_order: Optional[int]    # from make_lock(order=N)
    in_decl_scope: bool


class Project:
    """Cross-file indices shared by the rules (one parse, one set of
    walks — every rule reads these instead of re-walking the tree)."""

    def __init__(self, files: list[SourceFile]):
        self.files = files
        # (class, method) -> (FunctionDef, SourceFile, ClassDef)
        self.methods: dict[tuple[str, str], tuple[ast.AST, SourceFile]] = {}
        # method name -> set of class names defining it
        self.method_classes: dict[str, set[str]] = {}
        self.lock_decls: dict[tuple[str, str], LockDecl] = {}
        self.stray_lock_decls: list[LockDecl] = []   # declared outside scope
        # Same (class, attr) declared twice with a different order — the
        # graph would silently use the wrong order, so it is a violation.
        self.conflicting_lock_decls: list[tuple[LockDecl, LockDecl]] = []
        # Locks bound to function locals: invisible to the annotation /
        # ordering machinery, so their creation is itself a violation.
        self.local_lock_decls: list[LockDecl] = []
        # Cached per-function node walks (keyed by node identity; the
        # nodes stay alive for the project's lifetime via `files`).
        self._fn_nodes: dict[int, list[ast.AST]] = {}
        # Lazy shared call-site index, see call_contexts().
        self._call_contexts: "dict[tuple, list] | None" = None
        for f in files:
            self._index_file(f)
            self._index_local_locks(f)

    def fn_walk(self, fn: ast.AST) -> list[ast.AST]:
        """Cached ``ast.walk`` over one function — several rules walk the
        same methods; they share one traversal."""
        nodes = self._fn_nodes.get(id(fn))
        if nodes is None:
            nodes = self._fn_nodes[id(fn)] = list(ast.walk(fn))
        return nodes

    def call_contexts(self) -> "dict[tuple, list]":
        """Shared call-site index: resolvable call target ``(cls, meth)``
        -> list of ``(caller_key, frozenset(held lock attrs),
        caller_in_decl_scope)`` — the lock-context summaries the RCU and
        state-write rules both consume (computed once)."""
        if self._call_contexts is not None:
            return self._call_contexts
        ctx: dict[tuple, list] = {}

        def visit(node, f: SourceFile, cls_name, caller, in_decl,
                  outer_fn, stack: list[str]) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not outer_fn:
                # Nested defs run later: fresh lexical lock context, but
                # call sites still belong to the enclosing method.
                for child in ast.iter_child_nodes(node):
                    visit(child, f, cls_name, caller, in_decl, outer_fn, [])
                return
            entered = 0
            if isinstance(node, (ast.With, ast.AsyncWith)) \
                    and cls_name is not None:
                for key in _with_decl_locks(node, cls_name, self):
                    stack.append(key[1])
                    entered += 1
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute):
                recv = _expr_text(node.func.value)
                target = self.resolve_call(cls_name, recv == "self",
                                           node.func.attr)
                if target is not None:
                    ctx.setdefault(target, []).append(
                        (caller, frozenset(stack), in_decl))
            for child in ast.iter_child_nodes(node):
                visit(child, f, cls_name, caller, in_decl, outer_fn, stack)
            for _ in range(entered):
                stack.pop()

        for f in self.files:
            for cls_name, fn in _iter_functions(f):
                visit(fn, f, cls_name, (cls_name, fn.name),
                      fn.name in DECL_METHODS, fn, [])
        self._call_contexts = ctx
        return ctx

    def _index_file(self, f: SourceFile) -> None:
        for node in f.tree.body:
            if isinstance(node, ast.ClassDef):
                self._index_class(f, node)
            elif isinstance(node, ast.Assign):
                self._maybe_lock_decl(f, "<module>", node, targets_self=False,
                                      in_scope=True)

    def _index_class(self, f: SourceFile, cls: ast.ClassDef) -> None:
        for node in cls.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods[(cls.name, node.name)] = (node, f)
                self.method_classes.setdefault(node.name, set()).add(cls.name)
                in_scope = node.name in DECL_METHODS
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Assign):
                        self._maybe_lock_decl(f, cls.name, sub,
                                              targets_self=True,
                                              in_scope=in_scope)
            elif isinstance(node, ast.Assign):
                self._maybe_lock_decl(f, cls.name, node, targets_self=False,
                                      in_scope=True)

    def _maybe_lock_decl(self, f: SourceFile, owner: str, node: ast.Assign,
                         targets_self: bool, in_scope: bool) -> None:
        kind = _lock_factory_kind(node.value)
        if kind is None:
            return
        for tgt in node.targets:
            if targets_self:
                if not (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id in ("self", "cls")):
                    continue
                attr = tgt.attr
            else:
                if not isinstance(tgt, ast.Name):
                    continue
                attr = tgt.id
            decl = LockDecl(
                key=(owner, attr), file=f, line=node.lineno, kind=kind,
                order=f.line_comment_order(node.lineno),
                kwarg_order=_make_lock_order_kwarg(node.value),
                in_decl_scope=in_scope)
            if in_scope:
                prior = self.lock_decls.get(decl.key)
                if prior is None:
                    self.lock_decls[decl.key] = decl
                elif prior.line != decl.line and prior.order != decl.order:
                    self.conflicting_lock_decls.append((prior, decl))
            else:
                self.stray_lock_decls.append(decl)

    def _index_local_locks(self, f: SourceFile) -> None:
        """Lock factories assigned to plain names inside any function:
        a short-lived local lock protects nothing across threads unless it
        escapes, and escapes untracked — both are bugs."""
        for node in f.walk():
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign) \
                        and _lock_factory_kind(sub.value) is not None:
                    for tgt in sub.targets:
                        if isinstance(tgt, ast.Name):
                            self.local_lock_decls.append(LockDecl(
                                key=(node.name, tgt.id), file=f,
                                line=sub.lineno,
                                kind=_lock_factory_kind(sub.value),
                                order=f.line_comment_order(sub.lineno),
                                kwarg_order=None, in_decl_scope=False))

    # Resolution for the call-graph half of the lock-order rule.
    def resolve_call(self, cls_name: Optional[str],
                     is_self_call: bool, name: str
                     ) -> Optional[tuple[str, str]]:
        if is_self_call and cls_name and (cls_name, name) in self.methods:
            return (cls_name, name)
        if name in GENERIC_NAMES:
            return None
        owners = self.method_classes.get(name, set())
        if len(owners) == 1:
            return (next(iter(owners)), name)
        return None

    def class_lock_attrs(self, cls_name: str) -> set[str]:
        return {attr for (owner, attr) in self.lock_decls if owner == cls_name}


# ---------------------------------------------------------- lock discipline
def rule_lock_discipline(project: Project) -> list[Violation]:
    out: list[Violation] = []
    for decl in list(project.lock_decls.values()):
        f = decl.file
        if decl.order is None:
            if not f.allowed("lock-annotation", decl.line):
                out.append(Violation(
                    "lock-discipline", f.rel, decl.line,
                    f"lock {decl.key[0]}.{decl.key[1]} has no "
                    f"'# lock-order: N' annotation"))
        elif decl.kwarg_order is not None and decl.kwarg_order != decl.order:
            out.append(Violation(
                "lock-discipline", f.rel, decl.line,
                f"lock {decl.key[0]}.{decl.key[1]}: make_lock(order="
                f"{decl.kwarg_order}) disagrees with '# lock-order: "
                f"{decl.order}' annotation"))
    for decl in project.stray_lock_decls:
        out.append(Violation(
            "lock-discipline", decl.file.rel, decl.line,
            f"lock {decl.key[0]}.{decl.key[1]} created outside "
            f"__init__/setup/class scope (locks must be declared once, "
            f"at construction)"))
    for decl in project.local_lock_decls:
        if not decl.file.allowed("local-lock", decl.line):
            out.append(Violation(
                "lock-discipline", decl.file.rel, decl.line,
                f"lock bound to local {decl.key[1]!r} in {decl.key[0]}() — "
                f"locks must be long-lived attributes declared at "
                f"construction (annotation + ordering cannot track a "
                f"function local)"))
    for prior, dup in project.conflicting_lock_decls:
        out.append(Violation(
            "lock-discipline", dup.file.rel, dup.line,
            f"lock {dup.key[0]}.{dup.key[1]} re-declared with order "
            f"{dup.order} but {prior.file.rel}:{prior.line} declares "
            f"order {prior.order} (the graph check uses the first)"))

    # Bare .acquire()/.release() — locks are `with`-only.
    for f in project.files:
        for cls_name, fn in _iter_functions(f):
            lock_attrs = project.class_lock_attrs(cls_name) if cls_name else set()
            for node in project.fn_walk(fn):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)):
                    continue
                recv = _expr_text(node.func.value)
                recv_is_lock = (
                    "lock" in recv.lower()
                    or (recv.startswith("self.")
                        and recv[len("self."):] in lock_attrs))
                if not recv_is_lock:
                    continue
                if node.func.attr == "acquire" or (
                        node.func.attr == "release" and not node.args):
                    if not f.allowed("bare-acquire", node.lineno):
                        out.append(Violation(
                            "lock-discipline", f.rel, node.lineno,
                            f"bare {recv}.{node.func.attr}() — acquire "
                            f"locks via 'with' only"))
    return out


def _iter_functions(f: SourceFile):
    """Yields (enclosing class name or None, function node) for every
    top-level function and every method."""
    for node in f.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield None, node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield node.name, sub


# ------------------------------------------------------ blocking under lock
def _with_lock_items(with_node: ast.With, cls_name: Optional[str],
                     lock_attrs: set[str]) -> list[str]:
    """Names of lock-like context managers entered by this With."""
    hits = []
    for item in with_node.items:
        text = _expr_text(item.context_expr)
        last = text.rsplit(".", 1)[-1]
        if "lock" in last.lower():
            hits.append(text)
        elif text.startswith(("self.", "cls.")) \
                and text.split(".", 1)[1] in lock_attrs:
            hits.append(text)
    return hits


def _is_blocking_call(node: ast.Call) -> Optional[str]:
    if not isinstance(node.func, ast.Attribute):
        return None
    attr = node.func.attr
    recv = _expr_text(node.func.value)
    rlow = recv.lower()
    if attr == "sleep":
        return f"{recv}.sleep() sleeps"
    if recv in ("requests", "_requests") and attr in (
            "get", "post", "put", "delete", "head", "request"):
        return f"requests.{attr}() performs HTTP I/O"
    if "session" in rlow and attr in ("get", "post", "put", "delete",
                                      "request", "head"):
        return f"{recv}.{attr}() performs HTTP I/O"
    if attr in ("sendall", "recv", "recv_into"):
        return f"{recv}.{attr}() performs socket I/O"
    if attr == "create_connection" and rlow.endswith("socket"):
        return "socket.create_connection() performs socket I/O"
    if recv == "FAULTS" and attr in ("check", "fire"):
        return f"FAULTS.{attr}() marks a blocking-I/O fault point"
    if rlow.endswith("coord") or "._coord" in rlow or rlow == "coord":
        return f"coordination call {recv}.{attr}()"
    if attr in CHANNEL_METHODS:
        return f"engine-channel RPC {recv}.{attr}()"
    if attr == "cancel" and (rlow in ("ch", "chan", "channel")
                             or rlow.endswith(".channel")):
        return f"engine-channel RPC {recv}.cancel()"
    return None


def rule_no_blocking_under_lock(project: Project) -> list[Violation]:
    out: list[Violation] = []

    def visit(node: ast.AST, f: SourceFile, cls_name: Optional[str],
              lock_attrs: set[str], stack: list[tuple[str, int]]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and stack:
            # A def nested inside a with-block runs later, not under the
            # lock — its body starts a fresh lexical context.
            for child in ast.iter_child_nodes(node):
                visit(child, f, cls_name, lock_attrs, [])
            return
        entered = 0
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for name in _with_lock_items(node, cls_name, lock_attrs):
                stack.append((name, node.lineno))
                entered += 1
        elif isinstance(node, ast.Call) and stack:
            why = _is_blocking_call(node)
            if why is not None:
                with_lines = [ln for _, ln in stack]
                if not f.allowed("blocking-under-lock", node.lineno,
                                 *with_lines):
                    out.append(Violation(
                        "no-blocking-under-lock", f.rel, node.lineno,
                        f"{why} while holding {stack[-1][0]} "
                        f"(acquired line {stack[-1][1]})"))
        for child in ast.iter_child_nodes(node):
            visit(child, f, cls_name, lock_attrs, stack)
        for _ in range(entered):
            stack.pop()

    for f in project.files:
        for cls_name, fn in _iter_functions(f):
            attrs = project.class_lock_attrs(cls_name) if cls_name else set()
            visit(fn, f, cls_name, attrs, [])
    return out


# ------------------------------------------------------------- lock ordering
def _with_decl_locks(with_node, cls_name: Optional[str],
                     project: Project) -> list[tuple[str, str]]:
    """Declared-lock keys entered by this With (only declared locks
    participate in the acquisition graph)."""
    keys = []
    if cls_name is None:
        return keys
    for item in with_node.items:
        text = _expr_text(item.context_expr)
        if text.startswith(("self.", "cls.")):
            attr = text.split(".", 1)[1]
            if (cls_name, attr) in project.lock_decls:
                keys.append((cls_name, attr))
    return keys


@dataclass
class _Edge:
    src: tuple[str, str]
    dst: tuple[str, str]
    file: SourceFile
    line: int
    via: str


def rule_lock_order(project: Project) -> list[Violation]:
    out: list[Violation] = []

    # Pass 1: per-method direct acquisitions + call refs (anywhere in the
    # method, nested defs included — conservative for summaries).
    direct: dict[tuple[str, str], set[tuple[str, str]]] = {}
    calls: dict[tuple[str, str], set[tuple[bool, str]]] = {}
    for (cls_name, meth), (fn, _f) in project.methods.items():
        acq: set[tuple[str, str]] = set()
        refs: set[tuple[bool, str]] = set()
        for node in project.fn_walk(fn):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                acq.update(_with_decl_locks(node, cls_name, project))
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute):
                recv = _expr_text(node.func.value)
                refs.add((recv == "self", node.func.attr))
        direct[(cls_name, meth)] = acq
        calls[(cls_name, meth)] = refs

    # Pass 2: transitive summaries (which locks can a method acquire).
    summary = {k: set(v) for k, v in direct.items()}
    changed = True
    while changed:
        changed = False
        for key, refs in calls.items():
            cur = summary[key]
            for is_self, name in refs:
                target = project.resolve_call(key[0], is_self, name)
                if target is not None and target in summary:
                    before = len(cur)
                    cur |= summary[target]
                    if len(cur) != before:
                        changed = True

    # Pass 3: edges from with-block bodies (direct nesting + one level of
    # resolvable calls through the summaries).
    edges: list[_Edge] = []

    def visit(node, f: SourceFile, cls_name: str,
              stack: list[tuple[tuple[str, str], int]]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and stack:
            for child in ast.iter_child_nodes(node):
                visit(child, f, cls_name, [])
            return
        entered = 0
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for key in _with_decl_locks(node, cls_name, project):
                if stack:
                    src = stack[-1][0]
                    if src != key:
                        edges.append(_Edge(src, key, f, node.lineno,
                                           via="nested with"))
                stack.append((key, node.lineno))
                entered += 1
        elif isinstance(node, ast.Call) and stack \
                and isinstance(node.func, ast.Attribute):
            target = project.resolve_call(
                cls_name, _expr_text(node.func.value) == "self",
                node.func.attr)
            if target is not None:
                src = stack[-1][0]
                for dst in summary.get(target, ()):
                    if dst != src:
                        edges.append(_Edge(
                            src, dst, f, node.lineno,
                            via=f"call to {target[0]}.{target[1]}()"))
        for child in ast.iter_child_nodes(node):
            visit(child, f, cls_name, stack)
        for _ in range(entered):
            stack.pop()

    for f in project.files:
        for cls_name, fn in _iter_functions(f):
            if cls_name is not None:
                visit(fn, f, cls_name, [])

    # Check declared order along every edge.
    seen: set[tuple] = set()
    adj: dict[tuple[str, str], set[tuple[str, str]]] = {}
    for e in edges:
        adj.setdefault(e.src, set()).add(e.dst)
        so = project.lock_decls[e.src].order
        do = project.lock_decls[e.dst].order
        if so is None or do is None:
            continue   # annotation violation already reported
        if so >= do:
            sig = (e.src, e.dst, e.file.rel, e.line)
            if sig in seen:
                continue
            seen.add(sig)
            if not e.file.allowed("lock-order", e.line):
                out.append(Violation(
                    "lock-order", e.file.rel, e.line,
                    f"{'.'.join(e.src)} (order {so}) -> "
                    f"{'.'.join(e.dst)} (order {do}) via {e.via} "
                    f"violates the declared lock order"))

    # Cycle detection over the acquisition graph.
    WHITE, GREY, BLACK = 0, 1, 2
    color = {k: WHITE for k in adj}

    def dfs(k, path):
        color[k] = GREY
        for nxt in adj.get(k, ()):
            if color.get(nxt, WHITE) == GREY:
                cyc = path[path.index(nxt):] + [nxt] if nxt in path else [k, nxt]
                names = " -> ".join(".".join(c) for c in cyc)
                decl = project.lock_decls[nxt]
                out.append(Violation(
                    "lock-order", decl.file.rel, decl.line,
                    f"lock-acquisition cycle: {names}"))
            elif color.get(nxt, WHITE) == WHITE and nxt in adj:
                dfs(nxt, path + [nxt])
        color[k] = BLACK

    for k in list(adj):
        if color[k] == WHITE:
            dfs(k, [k])
    return out


# -------------------------------------------------------------- fault points
def rule_fault_point(project: Project) -> list[Violation]:
    registry: dict[str, int] = {}
    reg_file: Optional[SourceFile] = None
    for f in project.files:
        if f.path.name != "faults.py":
            continue
        found = _registry_dict(f, "FAULT_POINTS")
        if found:
            registry, reg_file = found, f
    if reg_file is None:
        return []   # partial tree (e.g. fixture subset without a registry)

    out: list[Violation] = []
    used: set[str] = set()
    for f in project.files:
        for node in f.walk():
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("check", "fire")
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "FAULTS"):
                continue
            point = _first_str_arg(node)
            if point is None:
                out.append(Violation(
                    "fault-point", f.rel, node.lineno,
                    "fault point must be a string literal"))
            elif point not in registry:
                out.append(Violation(
                    "fault-point", f.rel, node.lineno,
                    f"fault point {point!r} is not registered in "
                    f"common/faults.py FAULT_POINTS"))
            else:
                used.add(point)
    for point, line in sorted(registry.items()):
        if point not in used:
            out.append(Violation(
                "fault-point", reg_file.rel, line,
                f"registered fault point {point!r} has no call site "
                f"(dead fault point)"))
    return out


# ------------------------------------------------------------------- metrics
#: Write methods that must go through .labels() on a labeled instrument.
_METRIC_WRITERS = {"inc", "set", "observe"}


def _decl_labelnames(call: ast.Call) -> Optional[tuple[str, ...]]:
    """The labelnames=(...) tuple of an instrument declaration (None when
    absent, () when explicitly empty)."""
    for kw in call.keywords:
        if kw.arg != "labelnames":
            continue
        if isinstance(kw.value, (ast.Tuple, ast.List)):
            names = []
            for e in kw.value.elts:
                if isinstance(e, ast.Constant) and isinstance(e.value, str):
                    names.append(e.value)
            return tuple(names)
        return ()
    return None


def rule_metrics_registry(project: Project) -> list[Violation]:
    decl_file: Optional[SourceFile] = None
    # identifier -> (metric name, line, declared labelnames or None)
    instruments: dict[str, tuple[str, int, Optional[tuple[str, ...]]]] = {}
    top_names: set[str] = set()
    for f in project.files:
        if f.path.name != "metrics.py":
            continue
        names, found = set(), {}
        for node in f.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
                if isinstance(node.value, ast.Call) \
                        and isinstance(node.value.func, ast.Attribute) \
                        and node.value.func.attr in ("counter", "gauge",
                                                     "histogram"):
                    mname = _first_str_arg(node.value)
                    tgt = node.targets[0]
                    if mname and isinstance(tgt, ast.Name):
                        found[tgt.id] = (mname, node.lineno,
                                         _decl_labelnames(node.value))
        if found:
            decl_file, instruments, top_names = f, found, names
    if decl_file is None:
        return []

    out: list[Violation] = []
    dupes: dict[str, str] = {}
    for ident, (mname, line, _labels) in instruments.items():
        if mname in dupes:
            out.append(Violation(
                "metrics-registry", decl_file.rel, line,
                f"metric name {mname!r} declared twice "
                f"({dupes[mname]} and {ident})"))
        dupes[mname] = ident

    def check_instrument_call(f: SourceFile, node: ast.Call) -> None:
        """Labeled-instrument hygiene at a call site whose receiver is a
        declared instrument identifier: .labels() must pass exactly the
        declared labelnames (keyword-only), and writes on a labeled family
        must go through .labels()."""
        recv = node.func.value
        # Bare (TTFT_MS.observe) and module-qualified (metrics.TTFT_MS
        # .observe) receivers — same access styles the liveness scan
        # accepts as a use.
        if isinstance(recv, ast.Name):
            ident = recv.id
        elif isinstance(recv, ast.Attribute):
            ident = recv.attr
        else:
            return
        if ident not in instruments:
            return
        _mname, _line, labelnames = instruments[ident]
        if node.func.attr == "labels":
            if not labelnames:
                out.append(Violation(
                    "metrics-registry", f.rel, node.lineno,
                    f"labels() on {ident}, which declares no labelnames"))
                return
            if node.args:
                out.append(Violation(
                    "metrics-registry", f.rel, node.lineno,
                    f"{ident}.labels() takes keyword arguments only"))
                return
            got = {kw.arg for kw in node.keywords if kw.arg}
            if any(kw.arg is None for kw in node.keywords):
                return   # **kwargs: not statically checkable
            if got != set(labelnames):
                out.append(Violation(
                    "metrics-registry", f.rel, node.lineno,
                    f"{ident}.labels() passes {tuple(sorted(got))} but "
                    f"the instrument declares labelnames {labelnames}"))
        elif node.func.attr in _METRIC_WRITERS and labelnames:
            out.append(Violation(
                "metrics-registry", f.rel, node.lineno,
                f"{ident}.{node.func.attr}() on a labeled instrument — "
                f"write through .labels(...).{node.func.attr}()"))

    used: set[str] = set()
    for f in project.files:
        if f is decl_file:
            continue
        for node in f.walk():
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("counter", "gauge", "histogram") \
                    and _expr_text(node.func.value).endswith("REGISTRY"):
                out.append(Violation(
                    "metrics-registry", f.rel, node.lineno,
                    f"ad-hoc metric creation (REGISTRY.{node.func.attr}) — "
                    f"declare instruments in common/metrics.py"))
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute):
                check_instrument_call(f, node)
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.module.rsplit(".", 1)[-1] == "metrics":
                for alias in node.names:
                    if alias.name not in top_names and alias.name != "*":
                        out.append(Violation(
                            "metrics-registry", f.rel, node.lineno,
                            f"import of {alias.name!r} not declared in "
                            f"common/metrics.py"))
                    # An import alone is NOT a use: only Name/Attribute
                    # references keep an instrument off the dead list.
            elif isinstance(node, ast.Name) and node.id in instruments:
                used.add(node.id)
            elif isinstance(node, ast.Attribute) and node.attr in instruments:
                used.add(node.attr)
    for ident, (mname, line, _labels) in sorted(instruments.items()):
        if ident not in used:
            out.append(Violation(
                "metrics-registry", decl_file.rel, line,
                f"instrument {ident} ({mname!r}) is never used "
                f"(dead metric)"))
    return out


# --------------------------------------------------------------- span points
def rule_span_point(project: Project) -> list[Violation]:
    """Bidirectional span-point registry check (mirrors the fault-point
    rule): every ``TRACER.span("p")``/``TRACER.start_span("p")`` call site
    must name a point registered in ``common/tracing.py``'s ``SPAN_POINTS``,
    and every registered point must have at least one live call site."""
    registry: dict[str, int] = {}
    reg_file: Optional[SourceFile] = None
    for f in project.files:
        if f.path.name != "tracing.py":
            continue
        found = _registry_dict(f, "SPAN_POINTS")
        if found:
            registry, reg_file = found, f
    if reg_file is None:
        return []   # partial tree (e.g. fixture subset without a registry)

    out: list[Violation] = []
    used: set[str] = set()
    for f in project.files:
        for node in f.walk():
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("span", "start_span")):
                continue
            recv = _expr_text(node.func.value)
            if not (recv == "tracing" or recv.split(".")[-1] == "TRACER"):
                continue
            if f.allowed("span-point", node.lineno):
                # Hatched sites (e.g. a helper forwarding literal points)
                # are exempt from the literal/registered checks.
                continue
            point = _first_str_arg(node)
            if point is None:
                out.append(Violation(
                    "span-point", f.rel, node.lineno,
                    "span point must be a string literal"))
            elif point not in registry:
                out.append(Violation(
                    "span-point", f.rel, node.lineno,
                    f"span point {point!r} is not registered in "
                    f"common/tracing.py SPAN_POINTS"))
            else:
                used.add(point)
    for point, line in sorted(registry.items()):
        if point not in used:
            out.append(Violation(
                "span-point", reg_file.rel, line,
                f"registered span point {point!r} has no call site "
                f"(dead span point)"))
    return out


# ----------------------------------------------------------------- hot json
def rule_hot_json(project: Project) -> list[Violation]:
    """Hot-path dispatch sites must not hand-roll JSON. ``rpc/wire.py``
    registers the hot functions (``HOT_PATH_FUNCTIONS``: "Class.method" or
    a bare module-level function name); inside each, ``json.dumps(...)``
    calls and ``json=`` kwargs (requests/aiohttp implicit JSON encoding)
    are violations — encode through ``rpc.wire`` so the wire format stays
    negotiated in one place (hatch: ``# xlint: allow-hot-json(reason)``).
    Bidirectional: a registered name with no matching function is a
    violation too (stale registry)."""
    registry: dict[str, int] = {}
    reg_file: Optional[SourceFile] = None
    for f in project.files:
        if f.path.name != "wire.py":
            continue
        found = _registry_dict(f, "HOT_PATH_FUNCTIONS")
        if found:
            registry, reg_file = found, f
    if reg_file is None:
        return []   # partial tree (e.g. fixture subset without a registry)

    out: list[Violation] = []
    found: set[str] = set()
    for f in project.files:
        for cls_name, fn in _iter_functions(f):
            qual = f"{cls_name}.{fn.name}" if cls_name else fn.name
            if qual not in registry:
                continue
            found.add(qual)
            for node in project.fn_walk(fn):
                why = None
                # Any json.dumps REFERENCE (call or alias like
                # `dumps = json.dumps`) — an alias would otherwise launder
                # the encode past a call-only check.
                if isinstance(node, ast.Attribute) \
                        and node.attr == "dumps" \
                        and _expr_text(node.value) \
                        .rsplit(".", 1)[-1] == "json":
                    why = "json.dumps"
                elif isinstance(node, ast.Call) \
                        and any(kw.arg == "json" for kw in node.keywords):
                    why = "json= kwarg (implicit JSON encode)"
                if why is not None and not f.allowed("hot-json", node.lineno):
                    out.append(Violation(
                        "hot-json", f.rel, node.lineno,
                        f"{qual}: {why} on a registered hot dispatch path "
                        f"— encode via rpc.wire (or hatch with "
                        f"'# xlint: allow-hot-json(reason)')"))
    for qual, line in sorted(registry.items()):
        if qual not in found:
            out.append(Violation(
                "hot-json", reg_file.rel, line,
                f"registered hot-path function {qual!r} has no matching "
                f"function in the tree (stale registry entry)"))
    return out


# -------------------------------------------------------------- broad except
def _handler_is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    names = []
    if isinstance(t, ast.Name):
        names = [t.id]
    elif isinstance(t, ast.Tuple):
        names = [e.id for e in t.elts if isinstance(e, ast.Name)]
    return any(n in ("Exception", "BaseException") for n in names)


def _handler_logs_or_raises(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in LOG_METHODS \
                and "log" in _expr_text(node.func.value).lower():
            return True
    return False


def rule_broad_except(project: Project) -> list[Violation]:
    out: list[Violation] = []
    for f in project.files:
        # Scope on the absolute path, not the display-relative one: a
        # single-file invocation strips the parent dirs from f.rel and
        # would silently drop the scheduler/rpc/coordination/engine scope.
        scoped = bool(EXCEPT_SCOPED_DIRS & set(f.path.parts))
        for node in f.walk():
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                if not f.allowed("broad-except", node.lineno):
                    out.append(Violation(
                        "broad-except", f.rel, node.lineno,
                        "bare 'except:' — name the exception type"))
                continue
            if scoped and _handler_is_broad(node) \
                    and not _handler_logs_or_raises(node) \
                    and not f.allowed("broad-except", node.lineno):
                out.append(Violation(
                    "broad-except", f.rel, node.lineno,
                    "broad 'except Exception' neither logs nor re-raises "
                    "(add logging, re-raise, or "
                    "'# xlint: allow-broad-except(reason)')"))
    return out


def _rel_parts(rel: str) -> list[str]:
    return rel.replace("\\", "/").split("/")


# ------------------------------------------------------------ async blocking
def _is_async_blocking_call(node: ast.Call) -> Optional[str]:
    """Blocking primitives that stall the event loop when called from a
    coroutine. Reuses the under-lock detector and adds the raw channel
    helpers (`_get`/`_post` are requests-backed)."""
    why = _is_blocking_call(node)
    if why is not None:
        return why
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr in ("_get", "_post"):
        recv = _expr_text(node.func.value)
        return f"channel {recv}.{node.func.attr}() performs blocking HTTP I/O"
    return None


def rule_async_blocking(project: Project) -> list[Violation]:
    """No blocking calls lexically inside ``async def``: one
    ``time.sleep``/``requests.post`` in a handler freezes EVERY in-flight
    request on that loop, not just its own. Awaited calls and async-with/
    async-for operands are exempt (they are the async API); nested sync
    defs start a fresh execution context (they run wherever they are
    called — usually an executor)."""
    out: list[Violation] = []
    for f in project.files:
        for fn in [n for n in f.walk()
                   if isinstance(n, ast.AsyncFunctionDef)]:
            exempt: set[int] = set()
            for n in ast.walk(fn):
                if isinstance(n, ast.Await):
                    exempt.add(id(n.value))
                elif isinstance(n, ast.AsyncWith):
                    for item in n.items:
                        exempt.add(id(item.context_expr))
                elif isinstance(n, ast.AsyncFor):
                    exempt.add(id(n.iter))

            def visit(node, top=False):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda)) and not top:
                    return   # fresh execution context
                if isinstance(node, ast.Call) and id(node) not in exempt:
                    why = _is_async_blocking_call(node)
                    if why is not None \
                            and not f.allowed("async-blocking", node.lineno):
                        out.append(Violation(
                            "async-blocking", f.rel, node.lineno,
                            f"{why} inside 'async def {fn.name}' — "
                            f"blocking a coroutine stalls the whole event "
                            f"loop (await the async API or move to an "
                            f"executor)"))
                for child in ast.iter_child_nodes(node):
                    visit(child)

            visit(fn, top=True)
    return out


# ------------------------------------------------------- RCU publication
#: In-place container mutators: calling any of these on a published
#: value is a torn-state bug (readers hold the same object).
RCU_MUTATORS = {
    "append", "extend", "insert", "add", "update", "pop", "popitem",
    "clear", "remove", "discard", "setdefault", "sort", "reverse",
    "difference_update", "intersection_update",
    "symmetric_difference_update", "__setitem__",
}

#: Builtins whose call yields a FRESH container (safe to publish, safe
#: to mutate before publication even when fed a frozen source).
_FRESH_BUILTINS = {"dict", "list", "set", "tuple", "frozenset", "sorted"}

_FRESH_DISPLAYS = (ast.Dict, ast.List, ast.Set, ast.Tuple, ast.DictComp,
                   ast.ListComp, ast.SetComp)


@dataclass
class _RcuPub:
    cls: str
    attr: str
    type_name: str        # registered frozen type or builtin container
    lock_attr: str        # declared writer lock attribute
    line: int


class _RcuModel:
    """Parsed RCU registries + derived cross-file facts."""

    def __init__(self, project: Project, reg_file: SourceFile,
                 frozen: dict[str, int], pub_specs):
        self.project = project
        self.reg_file = reg_file
        self.frozen = frozen                       # type name -> line
        self.pubs: dict[tuple[str, str], _RcuPub] = {}
        self.spec_errors: list[Violation] = []
        for key, (val, line) in pub_specs.items():
            cls, _, attr = key.partition(".")
            tname, sep, lock = (val or "").partition("@")
            if not attr or not sep or not tname.strip() or not lock.strip():
                self.spec_errors.append(Violation(
                    "rcu-publish", reg_file.rel, line,
                    f"RCU publication {key!r} must be registered as "
                    f"'Class.attr': 'Type @ writer_lock'"))
                continue
            self.pubs[(cls, attr)] = _RcuPub(
                cls=cls, attr=attr, type_name=tname.strip(),
                lock_attr=lock.strip(), line=line)
        self.pub_attr_names = {attr for (_, attr) in self.pubs}
        # Accessors: (cls, meth) -> (cls, attr) it returns, for methods
        # whose body contains `return self.<registered pub attr>`; plus
        # frozen-returning methods (any `return FrozenType(...)`).
        self.accessors: dict[tuple[str, str], tuple[str, str]] = {}
        self.frozen_returning: set[tuple[str, str]] = set()
        for (cls, meth), (fn, _f) in project.methods.items():
            for node in project.fn_walk(fn):
                if not isinstance(node, ast.Return) or node.value is None:
                    continue
                v = node.value
                if isinstance(v, ast.Attribute) \
                        and isinstance(v.value, ast.Name) \
                        and v.value.id == "self" \
                        and (cls, v.attr) in self.pubs:
                    self.accessors[(cls, meth)] = (cls, v.attr)
                elif isinstance(v, ast.Call) \
                        and self.call_makes_frozen_type(v):
                    self.frozen_returning.add((cls, meth))

    def call_makes_frozen_type(self, call: ast.Call) -> bool:
        fn = call.func
        name = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else "")
        return name in self.frozen


def _is_thaw_call(call: ast.Call) -> bool:
    fn = call.func
    return (isinstance(fn, ast.Name) and fn.id == "thaw") or \
        (isinstance(fn, ast.Attribute) and fn.attr == "thaw")


def _is_publish_call(call: ast.Call) -> bool:
    fn = call.func
    return (isinstance(fn, ast.Name) and fn.id == "publish") or \
        (isinstance(fn, ast.Attribute) and fn.attr == "publish")


class _FnRcu:
    """Per-function frozen-value tracking (the one-level call summaries
    of the RCU pass: ctor calls, publication reads, accessor calls)."""

    def __init__(self, model: _RcuModel, f: SourceFile,
                 cls_name: Optional[str], fn) -> None:
        self.model = model
        self.f = f
        self.cls = cls_name
        self.fn = fn
        self.in_frozen_class = (cls_name in model.frozen
                                and fn.name not in DECL_METHODS)
        self.class_pubs = {attr for (c, attr) in model.pubs
                          if c == cls_name}
        self.frozen_names: set[str] = set()
        self.poisoned: set[str] = set()   # ever bound to a non-frozen RHS
        self._track_locals()

    def _track_locals(self) -> None:
        # Fixpoint over simple name bindings: a local is frozen iff every
        # binding it receives is a frozen source. Loop/with/aug targets
        # poison (conservative: no flow analysis).
        for node in ast.walk(self.fn):
            tgt = None
            if isinstance(node, ast.For):
                tgt = node.target
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    if item.optional_vars is not None:
                        self._poison(item.optional_vars)
            elif isinstance(node, ast.AugAssign):
                tgt = node.target
            if tgt is not None:
                self._poison(tgt)
        for _ in range(3):
            changed = False
            for node in ast.walk(self.fn):
                # AnnAssign counts as a binding too — an annotated alias
                # (`snap: RoutingSnapshot = self._snapshot`) must not
                # escape tracking (the AnnAssign lesson, again).
                if isinstance(node, ast.AnnAssign) and node.value is not None \
                        and isinstance(node.target, ast.Name):
                    name, value = node.target.id, node.value
                elif isinstance(node, ast.Assign) \
                        and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    name, value = node.targets[0].id, node.value
                else:
                    continue
                if name in self.poisoned:
                    continue
                if self.is_frozen_expr(value):
                    if name not in self.frozen_names:
                        self.frozen_names.add(name)
                        changed = True
                else:
                    self.poisoned.add(name)
                    if name in self.frozen_names:
                        self.frozen_names.discard(name)
                    changed = True
            if not changed:
                break

    def _poison(self, tgt: ast.AST) -> None:
        for n in ast.walk(tgt):
            if isinstance(n, ast.Name):
                self.poisoned.add(n.id)

    def is_frozen_expr(self, node: ast.AST) -> bool:
        """Is this expression a published / frozen value? (Fields of
        frozen values are frozen — the freeze is deep.)"""
        if isinstance(node, ast.Name):
            if node.id == "self" and self.in_frozen_class:
                return True
            return node.id in self.frozen_names
        if isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) \
                    and node.value.id in ("self", "cls"):
                if self.in_frozen_class:
                    return True
                return node.attr in self.class_pubs
            return self.is_frozen_expr(node.value)
        if isinstance(node, ast.Call):
            if _is_thaw_call(node):
                return False   # the declared-writer escape hatch
            if _is_publish_call(node):
                return True
            if self.model.call_makes_frozen_type(node):
                return True
            # Accessor / frozen-returning project methods (one level).
            fn = node.func
            if isinstance(fn, ast.Attribute):
                recv = _expr_text(fn.value)
                target = self.model.project.resolve_call(
                    self.cls, recv == "self", fn.attr)
                if target is not None and (
                        target in self.model.accessors
                        or target in self.model.frozen_returning):
                    return True
            return False
        return False


def rule_rcu(project: Project) -> list[Violation]:
    """The RCU publication-discipline pass (three rules over the
    ``devtools/rcu.py`` registries — see the module docstring table)."""
    frozen: dict[str, int] = {}
    pub_specs = {}
    reg_file: Optional[SourceFile] = None
    for f in project.files:
        if f.path.name != "rcu.py":
            continue
        fr = _registry_dict(f, "RCU_FROZEN_TYPES")
        pb = _registry_items(f, "RCU_PUBLICATIONS")
        if fr or pb:
            frozen, pub_specs, reg_file = fr, pb, f
    if reg_file is None:
        return []   # partial tree (e.g. fixture subset without a registry)

    model = _RcuModel(project, reg_file, frozen, pub_specs)
    out: list[Violation] = list(model.spec_errors)

    # ---- bidirectional registry checks
    class_index: dict[str, tuple[SourceFile, int]] = {}
    for f in project.files:
        for node in f.tree.body:
            if isinstance(node, ast.ClassDef):
                class_index.setdefault(node.name, (f, node.lineno))
    for tname, line in sorted(frozen.items()):
        if tname not in class_index:
            out.append(Violation(
                "rcu-frozen", reg_file.rel, line,
                f"registered frozen type {tname!r} has no class "
                f"definition in the tree (stale registry entry)"))
    attr_assigned: set[tuple[str, str]] = set()
    for (cls, meth), (fn, _f) in project.methods.items():
        for node in project.fn_walk(fn):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id in ("self", "cls"):
                        attr_assigned.add((cls, t.attr))
    for (cls, attr), pub in sorted(model.pubs.items()):
        if cls not in class_index:
            out.append(Violation(
                "rcu-publish", reg_file.rel, pub.line,
                f"registered publication {cls}.{attr} has no class "
                f"{cls!r} in the tree (stale registry entry)"))
            continue
        if (cls, attr) not in attr_assigned:
            out.append(Violation(
                "rcu-publish", reg_file.rel, pub.line,
                f"registered publication {cls}.{attr} is never assigned "
                f"in class {cls} (stale registry entry)"))
        if (cls, pub.lock_attr) not in project.lock_decls:
            out.append(Violation(
                "rcu-publish", reg_file.rel, pub.line,
                f"publication {cls}.{attr} declares writer lock "
                f"{pub.lock_attr!r}, which is not a declared lock of "
                f"{cls} (the lock registry has no {cls}.{pub.lock_attr})"))
        if pub.type_name not in frozen \
                and pub.type_name not in _FRESH_BUILTINS:
            out.append(Violation(
                "rcu-publish", reg_file.rel, pub.line,
                f"publication {cls}.{attr} declares type "
                f"{pub.type_name!r}, which is neither a registered "
                f"frozen type nor a builtin container"))

    # ---- per-function analysis
    # Publication-swap sites lacking a lexical lock, keyed by enclosing
    # method, checked against call sites afterwards (one-level summary
    # over the shared call-context index).
    pending_lock: dict[tuple[str, str], list[tuple[_RcuPub, SourceFile, int]]] = {}

    def fresh_rhs(node: ast.AST, fr: _FnRcu, fresh_names: set[str]) -> bool:
        if isinstance(node, _FRESH_DISPLAYS):
            return True
        if isinstance(node, ast.Name):
            return node.id in fresh_names
        if isinstance(node, ast.Call):
            if _is_publish_call(node):
                return bool(node.args) and fresh_rhs(node.args[0], fr,
                                                     fresh_names)
            fn = node.func
            name = fn.id if isinstance(fn, ast.Name) else (
                fn.attr if isinstance(fn, ast.Attribute) else "")
            if name in _FRESH_BUILTINS or name in model.frozen:
                return True
        return False

    def scan_function(f: SourceFile, cls_name: Optional[str], fn) -> None:
        fr = _FnRcu(model, f, cls_name, fn)
        # Locals bound (only) from fresh builders, for the swap check.
        fresh_names: set[str] = set()
        for node in project.fn_walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and fresh_rhs(node.value, fr, fresh_names):
                fresh_names.add(node.targets[0].id)
            elif isinstance(node, ast.AnnAssign) \
                    and node.value is not None \
                    and isinstance(node.target, ast.Name) \
                    and fresh_rhs(node.value, fr, fresh_names):
                fresh_names.add(node.target.id)
        in_decl = fn.name in DECL_METHODS

        def pub_of_target(t: ast.AST) -> Optional[_RcuPub]:
            if isinstance(t, ast.Attribute) \
                    and isinstance(t.value, ast.Name) \
                    and t.value.id in ("self", "cls"):
                return model.pubs.get((cls_name, t.attr))
            return None

        def flag_frozen(node: ast.AST, what: str) -> None:
            if not f.allowed("rcu-frozen", node.lineno):
                out.append(Violation(
                    "rcu-frozen", f.rel, node.lineno,
                    f"{what} — RCU-published values are immutable after "
                    f"publish; build a replacement and swap the "
                    f"reference (declared entry-level writers go through "
                    f"rcu.thaw(..., reason))"))

        def visit(node: ast.AST, lock_stack: list[str]) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not fn:
                # Nested defs: fresh lexical context for the lock stack
                # (the RCU mutation checks still apply — same values).
                for child in ast.iter_child_nodes(node):
                    visit(child, [])
                return
            entered = 0
            if isinstance(node, (ast.With, ast.AsyncWith)) \
                    and cls_name is not None:
                for key in _with_decl_locks(node, cls_name, project):
                    lock_stack.append(key[1])
                    entered += 1
            elif isinstance(node, ast.Assign) or (
                    isinstance(node, ast.AnnAssign)
                    and node.value is not None):
                # AnnAssign is a swap site too — an annotated publication
                # write must not escape the rule (the AnnAssign lesson).
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    pub = pub_of_target(t)
                    if pub is not None and not in_decl:
                        check_swap(node, t, pub, lock_stack)
            elif isinstance(node, ast.AugAssign):
                pub = pub_of_target(node.target)
                if pub is not None and not in_decl \
                        and not f.allowed("rcu-publish", node.lineno):
                    out.append(Violation(
                        "rcu-publish", f.rel, node.lineno,
                        f"augmented assignment to publication "
                        f"{pub.cls}.{pub.attr} — publish with one "
                        f"reference swap of a freshly built object"))
            elif isinstance(node, ast.Call) and _is_thaw_call(node):
                reason = None
                if len(node.args) >= 2:
                    reason = node.args[1]
                else:
                    for kw in node.keywords:
                        if kw.arg == "reason":
                            reason = kw.value
                if reason is None or (isinstance(reason, ast.Constant)
                                      and not reason.value):
                    flag_frozen(node, "rcu.thaw() without a reason "
                                      "(the hatch requires one, like "
                                      "# xlint: allow-*(reason))")
            # ---- in-place mutation checks
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    mut = mutated_frozen(t)
                    if mut:
                        flag_frozen(t, mut)
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    mut = mutated_frozen(t)
                    if mut:
                        flag_frozen(t, mut)
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in RCU_MUTATORS \
                    and fr.is_frozen_expr(node.func.value):
                flag_frozen(node, f"in-place .{node.func.attr}() on "
                                  f"published value "
                                  f"{_expr_text(node.func.value)!r}")
            for child in ast.iter_child_nodes(node):
                visit(child, lock_stack)
            for _ in range(entered):
                lock_stack.pop()

        def mutated_frozen(t: ast.AST) -> Optional[str]:
            """An assignment/delete target that mutates a frozen value:
            attribute store on a frozen expr, or subscript store whose
            container is frozen."""
            if isinstance(t, ast.Attribute) and fr.is_frozen_expr(t.value):
                # `self.<pub> = ...` swap sites were handled above — a
                # pub attr on `self` is only "frozen" through
                # in_frozen_class, which publication classes are not.
                return (f"attribute write to published value "
                        f"{_expr_text(t)!r}")
            if isinstance(t, ast.Subscript) and fr.is_frozen_expr(t.value):
                return (f"item write on published value "
                        f"{_expr_text(t.value)!r}")
            return None

        def check_swap(node: ast.Assign, t: ast.AST, pub: _RcuPub,
                       lock_stack: list[str]) -> None:
            if not fresh_rhs(node.value, fr, fresh_names) \
                    and not f.allowed("rcu-publish", node.lineno):
                out.append(Violation(
                    "rcu-publish", f.rel, node.lineno,
                    f"publication {pub.cls}.{pub.attr} must swap in a "
                    f"freshly built {pub.type_name} (ctor call, builtin "
                    f"copy, display, or a local bound from one) — not "
                    f"{_expr_text(node.value) or 'this expression'!r}"))
            if pub.lock_attr not in lock_stack:
                pending_lock.setdefault((cls_name, fn.name), []).append(
                    (pub, f, node.lineno))

        visit(fn, [])

    for f in project.files:
        for cls_name, fn in _iter_functions(f):
            scan_function(f, cls_name, fn)

    # ---- one-level call-site summaries for non-lexical lock holds
    # (read off the shared call-context index — same traversal the
    # state-write rule uses).
    contexts = project.call_contexts()
    for (cls, meth), sites in pending_lock.items():
        callers = [held for (_ck, held, _d) in contexts.get((cls, meth), [])]
        for pub, f, line in sites:
            ok = bool(callers) and all(pub.lock_attr in held
                                       for held in callers)
            if not ok and not f.allowed("rcu-publish", line):
                held_desc = "no resolvable call sites" if not callers \
                    else "a call site without it"
                out.append(Violation(
                    "rcu-publish", f.rel, line,
                    f"publication {pub.cls}.{pub.attr} swapped outside "
                    f"'with self.{pub.lock_attr}' and {held_desc} "
                    f"(writers must serialize on the declared lock)"))

    # ---- rcu-read: registered hot readers load each publication once
    hot_registry: dict[str, int] = {}
    for f in project.files:
        if f.path.name != "wire.py":
            continue
        found = _registry_dict(f, "HOT_PATH_FUNCTIONS")
        if found:
            hot_registry = found
    if hot_registry:
        for f in project.files:
            for cls_name, fn in _iter_functions(f):
                qual = f"{cls_name}.{fn.name}" if cls_name else fn.name
                if qual not in hot_registry:
                    continue
                loads: dict[str, list[int]] = {}
                for node in project.fn_walk(fn):
                    if isinstance(node, ast.Attribute) \
                            and isinstance(node.ctx, ast.Load) \
                            and node.attr in model.pub_attr_names:
                        loads.setdefault(node.attr, []).append(node.lineno)
                    elif isinstance(node, ast.Call) \
                            and isinstance(node.func, ast.Attribute):
                        recv = _expr_text(node.func.value)
                        target = project.resolve_call(
                            cls_name, recv == "self", node.func.attr)
                        acc = model.accessors.get(target) \
                            if target is not None else None
                        if acc is not None:
                            loads.setdefault(acc[1], []).append(node.lineno)
                for attr, lines in sorted(loads.items()):
                    if len(lines) > 1 \
                            and not f.allowed("rcu-read", *lines):
                        out.append(Violation(
                            "rcu-read", f.rel, lines[1],
                            f"hot-path reader {qual} loads publication "
                            f"{attr!r} {len(lines)} times (lines "
                            f"{', '.join(map(str, lines))}) — a double "
                            f"load is a torn read; load once into a "
                            f"local"))
    return out


# ------------------------------------------------- state-ownership rules
#: Teardown methods counted as declaration scope by the state rules
#: (mirrors devtools/ownership.py LIFECYCLE_METHODS): they run after the
#: worker threads are joined, so their rebinds are bookkeeping.
STATE_LIFECYCLE_METHODS = {"stop", "close", "shutdown"}

_STATE_KINDS = {"lock", "rcu", "confined", "init-only", "immutable",
                "owner"}

#: In-place mutators checked on lock:/immutable attrs (superset of the
#: RCU set: deque-style ends included).
STATE_MUTATORS = RCU_MUTATORS | {"appendleft", "popleft", "__ior__",
                                 "__iand__", "__isub__", "__ixor__"}


def _parse_discipline(spec: str) -> tuple[str, str]:
    kind, _, arg = spec.partition(":")
    return kind.strip(), arg.strip()


def _guard_calls_in_test(test: ast.AST) -> set[str]:
    """Method names called as ``self.<name>(...)``/``cls.<name>(...)``
    inside an if-test, EXCLUDING calls under a ``not`` — the positive
    guards whose if-body a write may rely on (``owner:`` discipline).
    A negated guard dominates the wrong branch and earns no credit."""
    found: set[str] = set()

    def walk(node: ast.AST, negated: bool) -> None:
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            walk(node.operand, not negated)
            return
        if isinstance(node, ast.Call) and not negated \
                and isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id in ("self", "cls"):
            found.add(node.func.attr)
        for child in ast.iter_child_nodes(node):
            walk(child, negated)

    walk(test, False)
    return found


def _parse_thread_roles(f: SourceFile) -> "dict[str, tuple[tuple[str, ...], int]]":
    """``THREAD_ROLES = {"role": {"threads": (...), "entries": (...)}}``
    → role -> (entry "Class.method" names, lineno)."""
    out: dict[str, tuple[tuple[str, ...], int]] = {}
    for node in f.tree.body:
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign):
            targets, value = [node.target], node.value
        else:
            continue
        if not isinstance(value, ast.Dict) or not any(
                isinstance(t, ast.Name) and t.id == "THREAD_ROLES"
                for t in targets):
            continue
        for k, v in zip(value.keys, value.values):
            if not (isinstance(k, ast.Constant)
                    and isinstance(k.value, str)):
                continue
            entries: tuple[str, ...] = ()
            if isinstance(v, ast.Dict):
                for kk, vv in zip(v.keys, v.values):
                    if isinstance(kk, ast.Constant) \
                            and kk.value == "entries" \
                            and isinstance(vv, (ast.Tuple, ast.List)):
                        entries = tuple(
                            e.value for e in vv.elts
                            if isinstance(e, ast.Constant)
                            and isinstance(e.value, str))
            out[k.value] = (entries, k.lineno)
    return out


def _parse_state_classes(f: SourceFile) -> "dict[str, int]":
    """``STATE_CLASSES = ("Scheduler", ...)`` → {class name: lineno}."""
    out: dict[str, int] = {}
    for node in f.tree.body:
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign):
            targets, value = [node.target], node.value
        else:
            continue
        if not isinstance(value, (ast.Tuple, ast.List)) or not any(
                isinstance(t, ast.Name) and t.id == "STATE_CLASSES"
                for t in targets):
            continue
        for e in value.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                out[e.value] = e.lineno
    return out


def _is_escape_call(node: ast.AST) -> bool:
    """``ownership.escape(...)`` / ``escape(...)`` — the unified hatch."""
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    return (isinstance(fn, ast.Name) and fn.id == "escape") or \
        (isinstance(fn, ast.Attribute) and fn.attr == "escape")


def _escape_reason_missing(call: ast.Call) -> bool:
    if not call.args:
        return True
    a = call.args[0]
    return isinstance(a, ast.Constant) and not a.value


@dataclass
class _StateDecl:
    cls: str
    attr: str
    kind: str            # lock | rcu | confined | init-only | immutable
    arg: str             # lock attr / role name
    line: int


@dataclass
class _StateSite:
    decl: "Optional[_StateDecl]"   # None = undeclared post-init assign
    cls: str
    attr: str
    shape: str                     # rebind | item | mut
    file: SourceFile
    meth: str
    line: int
    locks: frozenset
    escaped: bool
    guards: frozenset = frozenset()   # positive self.<guard>() if-tests
    #                                   dominating this write (owner:)


def rule_state(project: Project) -> list[Violation]:
    """The shared-state ownership pass: ``state-decl`` (bidirectional
    registry discipline), ``state-write`` (writes obey the declared
    discipline), ``state-read`` (registered hot-path functions do not
    read lock-guarded attrs without the lock). Driven by
    ``devtools/ownership.py``'s ``STATE_DISCIPLINES`` / ``STATE_CLASSES``
    / ``THREAD_ROLES``; inert on partial trees without the registry."""
    reg_file: Optional[SourceFile] = None
    specs: dict = {}
    roles: dict = {}
    strict_classes: dict = {}
    for f in project.files:
        if f.path.name != "ownership.py":
            continue
        found = _registry_items(f, "STATE_DISCIPLINES")
        if found:
            specs, reg_file = found, f
            roles = _parse_thread_roles(f)
            strict_classes = _parse_state_classes(f)
    if reg_file is None:
        return []   # partial tree (e.g. fixture subset without a registry)

    out: list[Violation] = []

    # ---- parse declarations
    decls: dict[tuple[str, str], _StateDecl] = {}
    for key, (val, line) in specs.items():
        cls, _, attr = key.partition(".")
        kind, arg = _parse_discipline(val or "")
        bad = (not attr or kind not in _STATE_KINDS
               or (kind in ("lock", "confined", "owner") and not arg)
               or (kind in ("rcu", "init-only", "immutable") and arg))
        if bad:
            out.append(Violation(
                "state-decl", reg_file.rel, line,
                f"state discipline {key!r}: {val!r} is not one of "
                f"lock:<attr> | rcu | confined:<role> | owner:<guard> | "
                f"init-only | immutable"))
            continue
        decls[(cls, attr)] = _StateDecl(cls, attr, kind, arg, line)
    registered_classes = {c for (c, _a) in decls}

    # ---- class index + per-class assigned/mutated attr sets
    class_index: dict[str, tuple[SourceFile, int]] = {}
    class_methods: dict[str, set[str]] = {}
    for f in project.files:
        for node in f.tree.body:
            if isinstance(node, ast.ClassDef):
                class_index.setdefault(node.name, (f, node.lineno))
                ms = class_methods.setdefault(node.name, set())
                for b in node.body:
                    if isinstance(b, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                        ms.add(b.name)

    touched: dict[str, set[str]] = {}      # cls -> attrs assigned/mutated
    sites: list[_StateSite] = []

    def scan_method(f: SourceFile, cls_name: str, fn) -> None:
        meth = fn.name
        cls_touched = touched.setdefault(cls_name, set())

        def visit(node, lock_stack: list[str], esc: int,
                  guards: frozenset = frozenset()) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not fn:
                for child in ast.iter_child_nodes(node):
                    visit(child, [], esc)
                return
            if isinstance(node, ast.If):
                # owner: discipline — writes inside the if-body of a
                # positive ``self.<guard>(...)`` test are guard-credited;
                # the test itself and the else branch are not.
                found = _guard_calls_in_test(node.test)
                visit(node.test, lock_stack, esc, guards)
                for child in node.body:
                    visit(child, lock_stack, esc, guards | found)
                for child in node.orelse:
                    visit(child, lock_stack, esc, guards)
                return
            entered = 0
            esc_entered = 0
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for key in _with_decl_locks(node, cls_name, project):
                    lock_stack.append(key[1])
                    entered += 1
                for item in node.items:
                    if _is_escape_call(item.context_expr):
                        esc_entered += 1
                        if _escape_reason_missing(item.context_expr) \
                                and not f.allowed("state-write",
                                                  node.lineno):
                            out.append(Violation(
                                "state-write", f.rel, node.lineno,
                                "ownership.escape() without a reason "
                                "(the hatch requires one, like "
                                "# xlint: allow-*(reason))"))
            esc += esc_entered

            def emit(attr: str, shape: str, line: int) -> None:
                cls_touched.add(attr)
                sites.append(_StateSite(
                    decl=decls.get((cls_name, attr)), cls=cls_name,
                    attr=attr, shape=shape, file=f, meth=meth, line=line,
                    locks=frozenset(lock_stack), escaped=esc > 0,
                    guards=guards))

            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                if isinstance(node, ast.AnnAssign) and node.value is None:
                    targets = []
                for t in targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id in ("self", "cls"):
                        emit(t.attr, "rebind", node.lineno)
                    elif isinstance(t, ast.Subscript) \
                            and isinstance(t.value, ast.Attribute) \
                            and isinstance(t.value.value, ast.Name) \
                            and t.value.value.id in ("self", "cls"):
                        emit(t.value.attr, "item", node.lineno)
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id in ("self", "cls"):
                        emit(t.attr, "rebind", node.lineno)
                    elif isinstance(t, ast.Subscript) \
                            and isinstance(t.value, ast.Attribute) \
                            and isinstance(t.value.value, ast.Name) \
                            and t.value.value.id in ("self", "cls"):
                        emit(t.value.attr, "item", node.lineno)
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in STATE_MUTATORS \
                    and isinstance(node.func.value, ast.Attribute) \
                    and isinstance(node.func.value.value, ast.Name) \
                    and node.func.value.value.id in ("self", "cls"):
                emit(node.func.value.attr, "mut", node.lineno)
            for child in ast.iter_child_nodes(node):
                visit(child, lock_stack, esc, guards)
            for _ in range(entered):
                lock_stack.pop()

        visit(fn, [], 0)

    for f in project.files:
        for cls_name, fn in _iter_functions(f):
            if cls_name in registered_classes \
                    or cls_name in strict_classes:
                scan_method(f, cls_name, fn)

    # ---- state-decl: registry liveness + cross-checks
    rcu_pubs: dict = {}
    for f in project.files:
        if f.path.name == "rcu.py":
            found = _registry_items(f, "RCU_PUBLICATIONS")
            if found:
                rcu_pubs = found
    role_used: set[str] = set()
    for (cls, attr), d in sorted(decls.items()):
        if cls not in class_index:
            out.append(Violation(
                "state-decl", reg_file.rel, d.line,
                f"registered state attribute {cls}.{attr} has no class "
                f"{cls!r} in the tree (stale registry entry)"))
            continue
        if attr not in touched.get(cls, set()):
            out.append(Violation(
                "state-decl", reg_file.rel, d.line,
                f"registered state attribute {cls}.{attr} is never "
                f"assigned or mutated in class {cls} (stale registry "
                f"entry)"))
        if d.kind == "lock" and (cls, d.arg) not in project.lock_decls:
            out.append(Violation(
                "state-decl", reg_file.rel, d.line,
                f"{cls}.{attr} declares discipline lock:{d.arg}, but "
                f"{cls}.{d.arg} is not a declared lock (no "
                f"# lock-order annotation in the lock registry)"))
        if d.kind == "confined":
            if d.arg not in roles:
                out.append(Violation(
                    "state-decl", reg_file.rel, d.line,
                    f"{cls}.{attr} declares confined:{d.arg}, but role "
                    f"{d.arg!r} is not defined in THREAD_ROLES"))
            else:
                role_used.add(d.arg)
        if d.kind == "rcu" and f"{cls}.{attr}" not in rcu_pubs:
            out.append(Violation(
                "state-decl", reg_file.rel, d.line,
                f"{cls}.{attr} declares discipline rcu, but is not "
                f"registered in RCU_PUBLICATIONS (devtools/rcu.py)"))
        if d.kind == "owner" and d.arg not in class_methods.get(cls, set()):
            out.append(Violation(
                "state-decl", reg_file.rel, d.line,
                f"{cls}.{attr} declares owner:{d.arg}, but {cls}.{d.arg} "
                f"is not a method of the class (the guard must be the "
                f"live ownership check its writes are dominated by)"))
    for role, (_entries, line) in sorted(roles.items()):
        if role not in role_used:
            out.append(Violation(
                "state-decl", reg_file.rel, line,
                f"thread role {role!r} has no confined:{role} "
                f"declaration (dead role — stale registry entry)"))
    # Reverse rcu cross-check: publications on state-registered classes
    # must be declared rcu here (one ownership model, no blind spots).
    for key, (_val, line) in sorted(rcu_pubs.items()):
        cls, _, attr = key.partition(".")
        if cls in registered_classes and (cls, attr) not in decls:
            out.append(Violation(
                "state-decl", reg_file.rel, 0,
                f"RCU publication {key} (rcu.py:{line}) belongs to "
                f"state-registered class {cls} but has no "
                f"STATE_DISCIPLINES entry (declare it 'rcu')"))
    # STATE_CLASSES liveness.
    for cls, line in sorted(strict_classes.items()):
        if cls not in class_index:
            out.append(Violation(
                "state-decl", reg_file.rel, line,
                f"STATE_CLASSES entry {cls!r} has no class definition "
                f"in the tree (stale registry entry)"))
        elif cls not in registered_classes:
            out.append(Violation(
                "state-decl", reg_file.rel, line,
                f"STATE_CLASSES entry {cls!r} has no STATE_DISCIPLINES "
                f"declarations at all (register its attributes or drop "
                f"it)"))

    # ---- state-decl: completeness over the strict classes — every
    # attribute assigned outside construction/lifecycle scope must carry
    # a discipline (the enforcement ratchet the registry exists for).
    decl_scope = DECL_METHODS | STATE_LIFECYCLE_METHODS
    for s in sites:
        if s.decl is not None or s.shape != "rebind":
            continue
        if s.cls not in strict_classes or s.meth in decl_scope:
            continue
        if s.escaped or s.file.allowed("state-decl", s.line):
            continue
        out.append(Violation(
            "state-decl", s.file.rel, s.line,
            f"{s.cls}.{s.attr} is assigned outside __init__ but has no "
            f"STATE_DISCIPLINES entry — declare its discipline "
            f"(lock:<attr> | rcu | confined:<role> | init-only | "
            f"immutable) in devtools/ownership.py"))

    # ---- state-write
    contexts = project.call_contexts()

    def held_at_all_callsites(meth_key, lock_attr, path) -> bool:
        # Greatest-fixpoint walk with one twist: a cycle edge (caller
        # already on the path) contributes NO independent entry — a
        # write reachable only through mutually recursive helpers with
        # no locked external call site must flag, not vacuously pass.
        callers = contexts.get(meth_key)
        if not callers:
            return False
        external = False
        for ck, held, is_decl in callers:
            if is_decl or lock_attr in held:
                external = True
                continue
            if ck in path:
                continue   # cycle edge: no independent entry
            if not held_at_all_callsites(ck, lock_attr, path | {ck}):
                return False
            external = True
        return external

    def confined_via_callers(meth_key, entries, path) -> bool:
        callers = contexts.get(meth_key)
        if not callers:
            return False
        external = False
        for ck, _held, is_decl in callers:
            if is_decl or f"{ck[0]}.{ck[1]}" in entries \
                    or ck[1] in STATE_LIFECYCLE_METHODS:
                external = True
                continue
            if ck in path:
                continue   # cycle edge: no independent entry
            if not confined_via_callers(ck, entries, path | {ck}):
                return False
            external = True
        return external

    for s in sites:
        d = s.decl
        if d is None:
            continue
        if s.escaped or s.file.allowed("state-write", s.line):
            continue
        if s.meth in DECL_METHODS:
            continue
        key = (d.cls, s.meth)
        if d.kind == "lock":
            if d.arg in s.locks:
                continue
            if held_at_all_callsites(key, d.arg, {key}):
                continue
            out.append(Violation(
                "state-write", s.file.rel, s.line,
                f"{d.cls}.{d.attr} (lock:{d.arg}) written outside "
                f"'with self.{d.arg}' and not all call sites of "
                f"{s.meth}() hold it (writers must serialize on the "
                f"declared lock)"))
        elif d.kind == "confined":
            if s.shape != "rebind" or s.meth in STATE_LIFECYCLE_METHODS:
                continue
            entries = set(roles.get(d.arg, ((), 0))[0])
            if f"{d.cls}.{s.meth}" in entries:
                continue
            if confined_via_callers(key, entries, {key}):
                continue
            out.append(Violation(
                "state-write", s.file.rel, s.line,
                f"{d.cls}.{d.attr} (confined:{d.arg}) rebound in "
                f"{s.meth}(), which is not an entry function of role "
                f"{d.arg!r} (and not every call site resolves into "
                f"one)"))
        elif d.kind == "owner":
            if d.arg in s.guards:
                continue
            out.append(Violation(
                "state-write", s.file.rel, s.line,
                f"{d.cls}.{d.attr} (owner:{d.arg}) written outside an "
                f"'if self.{d.arg}(...)' guard — only the rendezvous "
                f"owner may write sharded telemetry state (hatch: "
                f"ownership.escape(reason) for owner-neutral "
                f"bookkeeping)"))
        elif d.kind in ("init-only", "immutable"):
            if s.shape == "rebind":
                if s.meth in STATE_LIFECYCLE_METHODS:
                    continue
                out.append(Violation(
                    "state-write", s.file.rel, s.line,
                    f"{d.cls}.{d.attr} ({d.kind}) rebound in "
                    f"{s.meth}() — declared assign-once at "
                    f"construction"))
            elif d.kind == "immutable":
                out.append(Violation(
                    "state-write", s.file.rel, s.line,
                    f"{d.cls}.{d.attr} (immutable) mutated in place in "
                    f"{s.meth}() — immutable state is never written "
                    f"after construction"))
        # d.kind == "rcu": writes are governed by the rcu-publish rule.

    # ---- state-read: hot-path functions vs lock-guarded attrs
    hot_registry: dict[str, int] = {}
    for f in project.files:
        if f.path.name == "wire.py":
            found = _registry_dict(f, "HOT_PATH_FUNCTIONS")
            if found:
                hot_registry = found
    if hot_registry:
        for f in project.files:
            for cls_name, fn in _iter_functions(f):
                if cls_name not in registered_classes:
                    continue
                qual = f"{cls_name}.{fn.name}"
                if qual not in hot_registry:
                    continue

                def visit_read(node, lock_stack, esc,
                               _f=f, _cls=cls_name, _fn=fn, _qual=qual):
                    if isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef,
                                         ast.Lambda)) and node is not _fn:
                        for child in ast.iter_child_nodes(node):
                            visit_read(child, [], esc)
                        return
                    entered = 0
                    if isinstance(node, (ast.With, ast.AsyncWith)):
                        for key in _with_decl_locks(node, _cls, project):
                            lock_stack.append(key[1])
                            entered += 1
                        for item in node.items:
                            if _is_escape_call(item.context_expr):
                                esc += 1
                    elif isinstance(node, ast.Attribute) \
                            and isinstance(node.ctx, ast.Load) \
                            and isinstance(node.value, ast.Name) \
                            and node.value.id == "self":
                        d = decls.get((_cls, node.attr))
                        if d is not None and d.kind == "lock" \
                                and d.arg not in lock_stack \
                                and not esc \
                                and not _f.allowed("state-read",
                                                   node.lineno):
                            out.append(Violation(
                                "state-read", _f.rel, node.lineno,
                                f"hot-path function {_qual} reads "
                                f"{_cls}.{node.attr} (lock:{d.arg}) "
                                f"without the lock — read an RCU "
                                f"snapshot instead, or take "
                                f"self.{d.arg}"))
                    for child in ast.iter_child_nodes(node):
                        visit_read(child, lock_stack, esc)
                    for _ in range(entered):
                        lock_stack.pop()

                visit_read(fn, [], 0)
    return out


# ------------------------------------------------------------- effect pairs
def _pair_registry(project: Project):
    """The ``devtools/lifecycle.py`` EFFECT_PAIRS registry (detected by
    filename, like the other registries): returns ``(registry file,
    {name: (PairSpec, line)}, [(error, line)])`` — or ``(None, {}, [])``
    when the tree subset has no registry (fixture runs)."""
    from ..lifecycle import parse_spec
    for f in project.files:
        if f.path.name != "lifecycle.py":
            continue
        items = _registry_items(f, "EFFECT_PAIRS")
        if not items:
            continue
        specs: dict[str, tuple] = {}
        errors: list[tuple[str, int]] = []
        for name, (val, line) in items.items():
            spec, errs = parse_spec(name, val)
            if spec is not None:
                specs[name] = (spec, line)
            errors.extend((e, line) for e in errs)
        return f, specs, errors
    return None, {}, []


def _ctor_class(node: ast.AST) -> Optional[str]:
    """Class name when `node` is a ``ClassName(...)`` constructor call."""
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    name = fn.id if isinstance(fn, ast.Name) else \
        fn.attr if isinstance(fn, ast.Attribute) else None
    return name if name and name[:1].isupper() else None


def _pair_aliases(project: Project) -> "dict[tuple, str]":
    """Receiver-resolution index for pair call sites. GENERIC_NAMES
    blocks method-name resolution for release-side names (``release``,
    ``remove``, ``record`` …), so the pair rules resolve the RECEIVER:
    module-level ``ADMISSION = AdmissionController(...)`` singletons map
    ``("<module>", "ADMISSION")`` → class, and ``self._journal =
    DeltaJournal(...)`` inits map ``(OwnerCls, "_journal")`` → class."""
    aliases: dict[tuple, str] = {}
    for f in project.files:
        for node in f.tree.body:
            cls = _ctor_class(node.value) \
                if isinstance(node, ast.Assign) else None
            if cls:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        aliases[("<module>", t.id)] = cls
        for cls_name, fn in _iter_functions(f):
            if cls_name is None:
                continue
            for sub in ast.walk(fn):
                if not isinstance(sub, ast.Assign):
                    continue
                cls = _ctor_class(sub.value)
                if not cls:
                    continue
                for t in sub.targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self":
                        aliases[(cls_name, t.attr)] = cls
    return aliases


def _pair_call_class(project: Project, aliases: "dict[tuple, str]",
                     cls_name: Optional[str],
                     call: ast.Call) -> Optional[str]:
    """Best-effort class of the receiver of an ``x.meth(...)`` call."""
    text = _expr_text(call.func.value)
    if text == "self":
        return cls_name
    if text.startswith("self.") and text.count(".") == 1:
        hit = aliases.get((cls_name, text[5:])) if cls_name else None
        if hit:
            return hit
    last = text.rsplit(".", 1)[-1]
    if ("<module>", last) in aliases:
        return aliases[("<module>", last)]
    if last in project.method_classes.get(call.func.attr, set()) or \
            (last, call.func.attr) in project.methods:
        return last          # classmethod/staticmethod-style receiver
    meth = call.func.attr
    if meth not in GENERIC_NAMES:
        owners = project.method_classes.get(meth, set())
        if len(owners) == 1:
            return next(iter(owners))
    return None


def _pair_own_classes(spec) -> set:
    own = {spec.acquire[0], spec.release[0]}
    if spec.transfer:
        own.add(spec.transfer[0])
    if spec.sink:
        own.add(spec.sink[0])
    return own


def rule_pair_release(project: Project) -> list[Violation]:
    """Every acquire site of a ``finally``-scope pair must be discharged
    by a try/finally that reaches the declared release — in the
    acquiring function itself or (for an acquire wrapped in a helper) in
    EVERY resolvable caller — or by the declared ownership transfer.
    This is the exact shape of the admission-slot leak. Also owns
    the registry cross-checks: malformed specs, stale endpoints, dead
    pairs."""
    reg_f, specs, errors = _pair_registry(project)
    if reg_f is None:
        return []
    out: list[Violation] = [
        Violation("pair-release", reg_f.rel, line, msg)
        for msg, line in errors
        if not reg_f.allowed("pair-release", line)]
    aliases = _pair_aliases(project)

    # Bidirectional half 1: every declared endpoint must resolve to a
    # method defined somewhere in the tree.
    for name, (spec, line) in specs.items():
        for role, ref in (("acquire", spec.acquire),
                          ("release", spec.release),
                          ("transfer", spec.transfer),
                          ("sink", spec.sink)):
            if ref is not None and ref not in project.methods \
                    and not reg_f.allowed("pair-release", line):
                out.append(Violation(
                    "pair-release", reg_f.rel, line,
                    f"stale pair '{name}': {role} target "
                    f"{ref[0]}.{ref[1]} is not defined in the tree"))

    fin_pairs = [(name, spec) for name, (spec, _l) in specs.items()
                 if spec.scope == "finally"
                 and spec.acquire in project.methods]
    if not fin_pairs:
        return out

    fn_index: dict[tuple, tuple] = {}
    for f in project.files:
        for cls_name, fn in _iter_functions(f):
            fn_index[(cls_name, fn.name)] = (fn, f)
    contexts = project.call_contexts()

    def releases_in_finally(fn, cls_name, spec) -> bool:
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Try) and node.finalbody):
                continue
            for stmt in node.finalbody:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call) \
                            and isinstance(sub.func, ast.Attribute) \
                            and sub.func.attr == spec.release[1] \
                            and _pair_call_class(project, aliases,
                                                 cls_name, sub) \
                            == spec.release[0]:
                        return True
        return False

    def discharged(key: tuple, spec, seen: frozenset) -> bool:
        """True when `key`'s function holds the finally-release itself
        or every resolvable caller does (the acquire-in-a-helper shape:
        the service's _admission_check acquires, its handler callers own
        the slot's try/finally). Cycle edges resolve optimistically,
        like the lock-summary fixpoint."""
        if key in seen:
            return True
        entry = fn_index.get(key)
        if entry is None:
            return False
        fn, _f = entry
        if releases_in_finally(fn, key[0], spec):
            return True
        callers = {c for (c, _locks, _d) in contexts.get(key, ())}
        callers.discard(key)
        if not callers:
            return False
        seen = seen | {key}
        return all(discharged(c, spec, seen) for c in callers)

    live: set = set()
    for f in project.files:
        for cls_name, fn in _iter_functions(f):
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)):
                    continue
                for name, spec in fin_pairs:
                    if node.func.attr != spec.acquire[1] \
                            or _pair_call_class(project, aliases, cls_name,
                                                node) != spec.acquire[0]:
                        continue
                    live.add(name)
                    if cls_name in _pair_own_classes(spec):
                        continue     # the pair's own machinery
                    if f.allowed("pair-release", node.lineno):
                        continue
                    if discharged((cls_name, fn.name), spec, frozenset()):
                        continue
                    out.append(Violation(
                        "pair-release", f.rel, node.lineno,
                        f"acquire of pair '{name}' "
                        f"({spec.acquire[0]}.{spec.acquire[1]}) is not "
                        f"discharged by a try/finally "
                        f"{spec.release[0]}.{spec.release[1]} here or in "
                        f"its callers (the admission slot-leak shape)"))

    # Bidirectional half 2: a finally-pair no code acquires is dead —
    # the registry entry outlived its last call site.
    for name, (spec, line) in specs.items():
        if spec.scope == "finally" and spec.acquire in project.methods \
                and name not in live \
                and not reg_f.allowed("pair-release", line):
            out.append(Violation(
                "pair-release", reg_f.rel, line,
                f"dead pair '{name}': no acquire call site of "
                f"{spec.acquire[0]}.{spec.acquire[1]} in the tree"))
    return out


def rule_pair_once(project: Project) -> list[Violation]:
    """No path may release a ``finally``-scope pair twice: two
    unconditional releases in one function, or an unconditional release
    lexically after the declared ownership transfer (the transferred
    slot is released by the sink — releasing it here too would
    double-release). A release under a flag guard (``if slot["held"]``)
    is the blessed shape."""
    reg_f, specs, _errors = _pair_registry(project)
    if reg_f is None:
        return []
    aliases = _pair_aliases(project)
    fin_pairs = [(name, spec) for name, (spec, _l) in specs.items()
                 if spec.scope == "finally"]
    if not fin_pairs:
        return []

    out: list[Violation] = []
    GUARDS = (ast.If, ast.IfExp, ast.While, ast.ExceptHandler,
              ast.Assert, ast.BoolOp)

    for f in project.files:
        for cls_name, fn in _iter_functions(f):
            for name, spec in fin_pairs:
                if cls_name in _pair_own_classes(spec):
                    continue
                rels: list = []     # unguarded release calls, in order
                xfers: list = []    # unguarded transfer calls, in order

                def collect(node, guarded):
                    if isinstance(node, ast.Call) \
                            and isinstance(node.func, ast.Attribute):
                        attr = node.func.attr
                        if attr == spec.release[1] and not guarded \
                                and _pair_call_class(
                                    project, aliases, cls_name, node) \
                                == spec.release[0]:
                            rels.append(node)
                        elif spec.transfer is not None \
                                and attr == spec.transfer[1] \
                                and not guarded \
                                and _pair_call_class(
                                    project, aliases, cls_name, node) \
                                == spec.transfer[0]:
                            xfers.append(node)
                    for child in ast.iter_child_nodes(node):
                        collect(child,
                                guarded or isinstance(node, GUARDS))

                collect(fn, False)
                rels.sort(key=lambda n: n.lineno)
                xfers.sort(key=lambda n: n.lineno)
                for dup in rels[1:]:
                    if not f.allowed("pair-once", dup.lineno):
                        out.append(Violation(
                            "pair-once", f.rel, dup.lineno,
                            f"pair '{name}' released twice on the same "
                            f"path (first release at line "
                            f"{rels[0].lineno}); guard one release with "
                            f"the slot-ownership flag"))
                for rel in rels[:1]:
                    first_xfer = next((x for x in xfers
                                       if x.lineno < rel.lineno), None)
                    if first_xfer is not None \
                            and not f.allowed("pair-once", rel.lineno):
                        out.append(Violation(
                            "pair-once", f.rel, rel.lineno,
                            f"pair '{name}' released after ownership "
                            f"transfer ({spec.transfer[0]}."
                            f"{spec.transfer[1]} at line "
                            f"{first_xfer.lineno}) — the sink releases "
                            f"the transferred slot; guard this release "
                            f"with the slot-ownership flag"))
    return out


def rule_pair_evict(project: Project) -> list[Violation]:
    """Labeled metric series are released ONLY through the blessed
    eviction helper declared by the ``evict``-scope pair: a direct
    ``INSTRUMENT.remove(...)`` outside metrics.py is a hand-rolled
    eviction path, and a ``.labels(...)`` write lexically after an
    eviction of the same instrument in the same function is the
    gauge-resurrection shape."""
    reg_f, specs, _errors = _pair_registry(project)
    if reg_f is None:
        return []
    ev_pairs = [(name, spec, line) for name, (spec, line) in specs.items()
                if spec.scope == "evict"]
    if not ev_pairs:
        return []

    out: list[Violation] = []
    decl_file = None
    instruments: dict[str, int] = {}
    top_defs: set[str] = set()
    for f in project.files:
        if f.path.name != "metrics.py":
            continue
        found: dict[str, int] = {}
        defs: set[str] = set()
        for node in f.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.add(node.name)
            elif isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call) \
                    and isinstance(node.value.func, ast.Attribute) \
                    and node.value.func.attr in ("counter", "gauge",
                                                 "histogram"):
                mname = _first_str_arg(node.value)
                tgt = node.targets[0]
                if mname and isinstance(tgt, ast.Name):
                    found[tgt.id] = node.lineno
        if found:
            decl_file, instruments, top_defs = f, found, defs

    helper_names: set[str] = set()
    for name, spec, line in ev_pairs:
        if spec.helper is None:
            if not reg_f.allowed("pair-evict", line):
                out.append(Violation(
                    "pair-evict", reg_f.rel, line,
                    f"evict pair '{name}' declares no helper= "
                    f"(the blessed release site in metrics.py)"))
            continue
        helper_names.add(spec.helper)
        if decl_file is not None and spec.helper not in top_defs \
                and not reg_f.allowed("pair-evict", line):
            out.append(Violation(
                "pair-evict", reg_f.rel, line,
                f"stale pair '{name}': helper {spec.helper}() is not "
                f"defined in {decl_file.rel}"))
    if decl_file is None or not instruments or not helper_names:
        return out
    blessed = sorted(helper_names)[0]

    def recv_ident(call: ast.Call) -> Optional[str]:
        recv = call.func.value
        if isinstance(recv, ast.Name):
            return recv.id
        if isinstance(recv, ast.Attribute):
            return recv.attr
        return None

    for f in project.files:
        in_metrics = f.path.name == "metrics.py"
        for _cls_name, fn in _iter_functions(f):
            events: list[tuple[str, str, ast.Call]] = []
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                if isinstance(node.func, ast.Attribute):
                    ident = recv_ident(node)
                    if ident not in instruments:
                        continue
                    if node.func.attr == "remove":
                        events.append(("evict", ident, node))
                        if not in_metrics \
                                and not f.allowed("pair-evict",
                                                  node.lineno):
                            out.append(Violation(
                                "pair-evict", f.rel, node.lineno,
                                f"direct {ident}.remove(): evict labeled "
                                f"series via the blessed {blessed}() "
                                f"helper in metrics.py"))
                    elif node.func.attr == "labels":
                        events.append(("write", ident, node))
                elif isinstance(node.func, ast.Name) \
                        and node.func.id in helper_names and node.args:
                    a0 = node.args[0]
                    ident = a0.id if isinstance(a0, ast.Name) else \
                        a0.attr if isinstance(a0, ast.Attribute) else None
                    if ident in instruments:
                        events.append(("evict", ident, node))
            events.sort(key=lambda e: e[2].lineno)
            first_evict: dict[str, int] = {}
            for kind, ident, node in events:
                if kind == "evict":
                    first_evict.setdefault(ident, node.lineno)
                elif ident in first_evict \
                        and node.lineno > first_evict[ident] \
                        and not f.allowed("pair-evict", node.lineno):
                    out.append(Violation(
                        "pair-evict", f.rel, node.lineno,
                        f"write to {ident} after its series were evicted "
                        f"at line {first_evict[ident]} (the "
                        f"gauge-resurrection shape) — writes must only "
                        f"be reachable while the owning entity is "
                        f"registered"))
    return out


ALL_RULES = (
    rule_lock_discipline,
    rule_no_blocking_under_lock,
    rule_lock_order,
    rule_fault_point,
    rule_span_point,
    rule_metrics_registry,
    rule_hot_json,
    rule_broad_except,
    rule_async_blocking,
    rule_rcu,
    rule_state,
    rule_pair_release,
    rule_pair_once,
    rule_pair_evict,
)

#: Relaxed profile for support code (tests/, benchmarks/): every
#: behavioral rule, minus the declaration-discipline rule — support code
#: does not register locks/points, and a bench driver's ad-hoc local
#: lock is fine as long as nothing blocks under it.
SUPPORT_RULES = tuple(r for r in ALL_RULES if r is not rule_lock_discipline)
