"""swarmlock static half: interprocedural lock-family checks.

The serving stack is a genuinely concurrent system (lane decode threads,
a supervisor, per-peer detectors, many replication streams, a sharded
broker write path). SWL301 verifies *annotated* locks one function at
a time; these checks target the two failure classes it is structurally
blind to — lock-order inversion (deadlock) and fields that are guarded
almost everywhere but raced in one spot — plus the two repo-specific
blocking hazards that turn a lock into a stall amplifier:

- **SWL302 lock-order inversion**: an interprocedural acquisition-order
  graph built from ``with``/``.acquire()`` nesting and propagated
  through the call graph (callgraph.py). Any cycle is a finding on
  each participating edge, with both witness paths printed. Same-node
  edges are skipped: two *instances* of one class's lock (lane A vs
  lane B) are indistinguishable statically — the runtime sanitizer
  (obs/lockcheck.py) owns that case.
- **SWL303 inferred guarded-by** (RacerD-style): a ``self._x`` field
  accessed under one particular lock at >= ``SWL303_MIN_GUARDED``
  sites is *inferred* guarded by it; any unguarded access elsewhere is
  flagged, provided the unguarded sites are a strict minority and the
  field is written somewhere (a read-only field cannot race). No
  annotations required — existing ``guarded-by[...]`` declarations
  take precedence (those fields stay SWL301 territory).
- **SWL304 blocking-while-holding**: (a) ``Condition.wait`` whose
  predicate is not re-checked in a ``while`` loop — a spurious wakeup
  or stale notify returns with the predicate false; (b) in
  ``# swarmlint: hot`` code, a blocking call (socket ops, ``join``,
  ``sleep``, ``device_get``/``block_until_ready``, ``synchronize``,
  ``open``) made
  while any lock is held — the device/network stall is inherited by
  every thread queued on that lock.
- **SWL305 callback-under-lock**: invoking a *stored* hook/callback
  attribute (a ``Callable`` field, an attr assigned from a constructor
  arg or lambda, or a hook/handler-named attr) while holding a lock —
  the emission-ring/supervisor re-entrancy hazard: the callback can
  call back into the object and re-acquire.

Lock identity is the *allocation site* (``backend.engine.Engine._cv``),
discovered from ``threading.Lock/RLock/Condition`` or
``utils.sync.make_lock/make_rlock/make_condition`` assignments, plus
declared ``guarded-by[...]``/``holds[...]`` guards. ``threading.Event``
and ``queue.Queue`` allocations are tracked only to be *excluded* —
they are internally synchronized, so ``event.wait()`` is not a
condition wait and event-typed fields are not SWL303 candidates.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .callgraph import CallGraph, ClassInfo, FunctionInfo, module_name
from .core import Finding, SourceFile, dotted_name, make_finding

__all__ = ["check_project", "SWL303_MIN_GUARDED"]

#: minimum sites observed under one lock before a field is inferred
#: guarded by it (SWL303); unguarded sites must also be a strict
#: minority of the total
SWL303_MIN_GUARDED = 3

#: constructor names whose bodies are exempt (construction
#: happens-before sharing), mirroring locks.py
_CONSTRUCTORS = ("__init__", "__new__", "__post_init__")

#: allocation callables -> lock kind
_LOCK_FACTORIES = {
    "Lock": "lock", "RLock": "rlock", "Condition": "condition",
    "make_lock": "lock", "make_rlock": "rlock",
    "make_condition": "condition",
}
#: internally-synchronized allocations, tracked only for exclusion
_SAFE_FACTORIES = {"Event": "event", "Queue": "queue",
                   "SimpleQueue": "queue", "Semaphore": "event",
                   "BoundedSemaphore": "event", "Barrier": "event"}

_COND_NAME_RE = re.compile(r"^_?(cv|cond|condition)$")
_CALLBACK_NAME_RE = re.compile(
    r"(^on_|^_on_|hook|callback|(^|_)cb($|_)|handler)")

#: dotted-name tails that block while held (SWL304b, hot code only); the
#: port adds the card's host wait, ``synchronize``
_BLOCKING_TAILS = {
    "join", "recv", "recvfrom", "accept", "connect", "sendall",
    "sleep", "device_get", "block_until_ready", "create_connection",
    "getaddrinfo", "urlopen", "synchronize",
}


@dataclass
class _LockInfo:
    key: str          # "backend.engine.Engine._cv" / "broker.replica.<fn>.lock"
    kind: str         # lock | rlock | condition | event | queue | declared


@dataclass
class _ClassLocks:
    info: ClassInfo
    locks: Dict[str, _LockInfo] = field(default_factory=dict)  # attr -> info
    declared_fields: Set[str] = field(default_factory=set)
    stored_callables: Set[str] = field(default_factory=set)


@dataclass
class _Witness:
    src: SourceFile
    node: ast.AST
    scope: str                      # function key the site lives in
    path: List[str]                 # call chain, holder -> acquisition


@dataclass
class _Effects:
    """Per-function summary feeding the interprocedural pass."""
    acquires: Dict[str, _Witness] = field(default_factory=dict)
    calls: List[Tuple[str, Tuple[str, ...], ast.AST]] = \
        field(default_factory=list)


class _Index:
    """Project-wide lock/class index shared by all four checks."""

    def __init__(self, srcs: Sequence[SourceFile],
                 graph: CallGraph) -> None:
        self.graph = graph
        self.classes: Dict[str, _ClassLocks] = {}
        self.module_locks: Dict[str, Dict[str, _LockInfo]] = {}
        self.fn_locks: Dict[str, Dict[str, _LockInfo]] = {}
        # attr name -> lock keys across all classes (unique-name fallback)
        self.attr_index: Dict[str, List[_LockInfo]] = {}
        for src in srcs:
            self._index_file(src)

    def _alloc_kind(self, value: ast.AST) -> Optional[str]:
        if not isinstance(value, ast.Call):
            return None
        name = dotted_name(value.func)
        if not name:
            return None
        tail = name.split(".")[-1]
        return _LOCK_FACTORIES.get(tail) or _SAFE_FACTORIES.get(tail)

    def _index_file(self, src: SourceFile) -> None:
        mod = module_name(src.path)
        mod_locks = self.module_locks.setdefault(mod, {})
        for stmt in src.tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                kind = self._alloc_kind(stmt.value)
                if kind:
                    name = stmt.targets[0].id
                    mod_locks[name] = _LockInfo(f"{mod}.{name}", kind)
        for ci in self.graph.classes.values():
            if ci.src is not src:
                continue
            cl = _ClassLocks(ci)
            self.classes[ci.key] = cl
            for node in ast.walk(ci.node):
                tgt = val = ann = None
                if isinstance(node, ast.Assign) and len(node.targets) == 1:
                    tgt, val = node.targets[0], node.value
                elif isinstance(node, ast.AnnAssign):
                    tgt, val, ann = node.target, node.value, node.annotation
                attr = None
                if (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    attr = tgt.attr
                elif isinstance(tgt, ast.Name) and isinstance(
                        src.enclosing_scope(node.lineno), ast.ClassDef):
                    attr = tgt.id       # dataclass-style class body field
                if attr is None:
                    continue
                kind = self._alloc_kind(val) if val is not None else None
                if kind:
                    cl.locks[attr] = _LockInfo(f"{ci.key}.{attr}", kind)
                    continue
                # stored callables: Callable-annotated fields, lambdas,
                # and attrs bound from a constructor argument
                if ann is not None and "Callable" in ast.dump(ann):
                    cl.stored_callables.add(attr)
                if isinstance(val, ast.Lambda):
                    cl.stored_callables.add(attr)
                elif isinstance(val, ast.Name):
                    fn = src.enclosing_scope(node.lineno)
                    if isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                        params = {a.arg for a in fn.args.args
                                  + fn.args.kwonlyargs}
                        if val.id in params and _CALLBACK_NAME_RE.search(
                                attr):
                            cl.stored_callables.add(attr)
            # declared guards attach to the class: both the guard
            # itself (a known lock even without a seen allocation) and
            # the declared fields (SWL301 territory, excluded from 303)
            for decl in src.directives.guards:
                scope = src.enclosing_scope(decl.line, classes_only=True)
                if scope is not ci.node:
                    continue
                cl.declared_fields.update(decl.names)
                if decl.guard.startswith("self."):
                    attr = decl.guard[len("self."):]
                    cl.locks.setdefault(
                        attr, _LockInfo(f"{ci.key}.{attr}", "declared"))
            for cl_info in cl.locks.values():
                attr = cl_info.key.split(".")[-1]
                self.attr_index.setdefault(attr, []).append(cl_info)

        # function-local locks (closure-shared, e.g. replica._ack_pump)
        for fi in self.graph.functions.values():
            if fi.src is not src:
                continue
            locks: Dict[str, _LockInfo] = {}
            for node in ast.walk(fi.node):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    kind = self._alloc_kind(node.value)
                    if kind:
                        name = node.targets[0].id
                        locks[name] = _LockInfo(
                            f"{fi.key}.{name}", kind)
            if locks:
                self.fn_locks[fi.key] = locks

    # ------------------------------------------------------------ resolution

    def class_locks(self, fn: FunctionInfo) -> Optional[_ClassLocks]:
        if fn.cls is None:
            return None
        return self.classes.get(f"{fn.module}.{fn.cls.name}")

    def resolve_lock(self, expr: ast.AST, fn: FunctionInfo,
                     local_types: Dict[str, str]) -> Optional[_LockInfo]:
        """Lock identity of an expression, or None if it isn't one."""
        if isinstance(expr, ast.Name):
            info = self.fn_locks.get(fn.key, {}).get(expr.id)
            if info is not None:
                return info
            return self.module_locks.get(fn.module, {}).get(expr.id)
        if not isinstance(expr, ast.Attribute):
            return None
        attr = expr.attr
        base = expr.value
        if isinstance(base, ast.Name) and base.id == "self":
            cl = self.class_locks(fn)
            if cl is not None and attr in cl.locks:
                return cl.locks[attr]
            if cl is not None and _COND_NAME_RE.match(attr):
                # cv-named attr without a seen allocation (allocated by
                # a sibling class / passed in): still treat as one
                return cl.locks.setdefault(
                    attr, _LockInfo(f"{cl.info.key}.{attr}", "condition"))
            return None
        owner: Optional[str] = None
        if isinstance(base, ast.Name):
            owner = local_types.get(base.id)
        elif (isinstance(base, ast.Attribute)
              and isinstance(base.value, ast.Name)
              and base.value.id == "self"):
            ci = self.graph.class_info(fn)
            if ci is not None:
                owner = ci.attr_types.get(base.attr)
        if owner is not None:
            cl = self.classes.get(owner)
            if cl is not None and attr in cl.locks:
                return cl.locks[attr]
        # unique-attr-name fallback: exactly one scanned class allocates
        # a lock under this attr name (``part.cond`` -> PartitionState)
        cands = self.attr_index.get(attr, [])
        if len(cands) == 1 and cands[0].kind not in ("event", "queue"):
            return cands[0]
        return None


def _guard_key(guard_text: str, fn: FunctionInfo,
               index: _Index) -> Optional[str]:
    """Resolve a holds[]/guarded-by guard expression text to a lock key."""
    try:
        expr = ast.parse(guard_text, mode="eval").body
    except SyntaxError:
        return None
    info = index.resolve_lock(expr, fn, {})
    return info.key if info is not None else None


class _FunctionWalker:
    """One pass over a function body collecting everything the four
    checks need: acquisitions + ordered edges, resolved call sites with
    the held set, guarded/unguarded field accesses, wait-shape and
    blocking-call and callback-under-lock findings."""

    def __init__(self, fn: FunctionInfo, index: _Index,
                 findings: List[Finding],
                 edges: Dict[Tuple[str, str], _Witness],
                 effects: _Effects,
                 accesses: Dict[Tuple[str, str],
                                List[Tuple[bool, ast.AST, frozenset,
                                           str, SourceFile]]]) -> None:
        self.fn = fn
        self.index = index
        self.src = fn.src
        self.findings = findings
        self.edges = edges
        self.effects = effects
        self.accesses = accesses
        self.local_types = index.graph.local_types(fn)
        self.is_hot = fn.src.is_hot(fn.node)
        self.is_ctor = fn.node.name in _CONSTRUCTORS
        self.cl = index.class_locks(fn)

    # entry ------------------------------------------------------------

    def run(self) -> None:
        held: Tuple[str, ...] = tuple(
            k for k in (_guard_key(g, self.fn, self.index)
                        for g in self.src.held_guards(self.fn.node))
            if k is not None)
        self._stmts(list(ast.iter_child_nodes(self.fn.node)), held)

    # walking ----------------------------------------------------------

    def _acquire(self, info: _LockInfo, node: ast.AST,
                 held: Tuple[str, ...]) -> Tuple[str, ...]:
        if info.key in held:
            return held             # re-entrant / already-modeled
        for h in held:
            if h != info.key and (h, info.key) not in self.edges:
                self.edges[(h, info.key)] = _Witness(
                    self.src, node, self.fn.key, [])
        if info.key not in self.effects.acquires:
            self.effects.acquires[info.key] = _Witness(
                self.src, node, self.fn.key, [])
        return held + (info.key,)

    def _stmts(self, body: List[ast.AST], held: Tuple[str, ...]) -> None:
        for stmt in body:
            # statement-level explicit acquire()/release() updates the
            # held set for the FOLLOWING statements in this list
            if isinstance(stmt, ast.Expr) and isinstance(stmt.value,
                                                         ast.Call):
                call = stmt.value
                if isinstance(call.func, ast.Attribute) and \
                        call.func.attr in ("acquire", "release"):
                    info = self.index.resolve_lock(
                        call.func.value, self.fn, self.local_types)
                    if info is not None:
                        self._expr(stmt, held)
                        if call.func.attr == "acquire":
                            held = self._acquire(info, call, held)
                        elif info.key in held:
                            held = tuple(k for k in held
                                         if k != info.key)
                        continue
            self._stmt(stmt, held)

    def _stmt(self, node: ast.AST, held: Tuple[str, ...]) -> None:
        if isinstance(node, ast.With):
            new_held = held
            for item in node.items:
                self._expr(item.context_expr, held)
                info = self.index.resolve_lock(item.context_expr,
                                               self.fn, self.local_types)
                if info is not None and info.kind not in ("event", "queue"):
                    new_held = self._acquire(info, item.context_expr,
                                             new_held)
            self._stmts(node.body, new_held)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: may run on another thread — held locks do not
            # cross the boundary, and its acquisitions must not leak
            # into this function's summary (it is not called here)
            nested = FunctionInfo(
                key=f"{self.fn.key}.{node.name}", module=self.fn.module,
                src=self.src, node=node, cls=self.fn.cls)
            sub = _FunctionWalker(nested, self.index, self.findings,
                                  self.edges, _Effects(), self.accesses)
            sub.is_ctor = self.is_ctor
            sub.run()
            return
        if isinstance(node, ast.Lambda):
            return
        if isinstance(node, ast.ExceptHandler):
            # an except clause's body is a statement list: a `with` in it
            # holds its lock there (the JAX package's copy walks the
            # handler as one expression, so every access in it reads as
            # taken without the lock)
            if node.type is not None:
                self._expr(node.type, held)
            self._stmts(node.body, held)
            return
        # compound statements: visit non-body expressions with the
        # current held set, then bodies as statement lists
        for fname, value in ast.iter_fields(node):
            if isinstance(value, list) and value and isinstance(
                    value[0], ast.AST) and isinstance(
                        value[0], (ast.stmt,)):
                self._stmts(value, held)
            elif isinstance(value, ast.AST):
                self._expr(value, held)
            elif isinstance(value, list):
                for v in value:
                    if isinstance(v, ast.AST):
                        if isinstance(v, (ast.stmt, ast.ExceptHandler)):
                            self._stmt(v, held)
                        else:
                            self._expr(v, held)

    def _expr(self, node: ast.AST, held: Tuple[str, ...]) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._stmt(sub, held)
                continue
            if isinstance(sub, ast.Call):
                self._call(sub, held)
            elif isinstance(sub, ast.Attribute):
                self._field_access(sub, held)

    # per-node handlers ------------------------------------------------

    def _call(self, call: ast.Call, held: Tuple[str, ...]) -> None:
        func = call.func
        name = dotted_name(func)
        tail = name.split(".")[-1] if name else ""
        recv_lock = None
        if isinstance(func, ast.Attribute):
            recv_lock = self.index.resolve_lock(func.value, self.fn,
                                                self.local_types)
        # SWL304a: Condition.wait outside a while-predicate loop
        if (tail == "wait" and recv_lock is not None
                and recv_lock.kind == "condition"
                and not self._in_while(call)):
            self.findings.append(make_finding(
                self.src, "SWL304", call,
                f"`{ast.unparse(func.value)}.wait()` is not re-checked in a "
                f"`while` predicate loop — a spurious wakeup or stale "
                f"notify returns with the condition false; use "
                f"`while not <predicate>: cv.wait(...)`"))
        # SWL302 feed: explicit blocking acquire mid-expression
        if tail == "acquire" and recv_lock is not None:
            self._acquire(recv_lock, call, held)
        # SWL304b: blocking call while holding a lock, hot code only
        if (self.is_hot and held and tail in _BLOCKING_TAILS
                and recv_lock is None):
            self.findings.append(make_finding(
                self.src, "SWL304", call,
                f"blocking call `{name}` while holding "
                f"{self._held_label(held)} in hot code — the stall is "
                f"inherited by every thread queued on the lock"))
        if (self.is_hot and held and isinstance(func, ast.Name)
                and func.id == "open"):
            self.findings.append(make_finding(
                self.src, "SWL304", call,
                f"file I/O (`open`) while holding "
                f"{self._held_label(held)} in hot code"))
        # SWL305: stored callback invoked under a lock
        if held and not self.is_ctor:
            self._callback_check(call, held)
        # interprocedural feed
        target = self.index.graph.resolve_call(call, self.fn,
                                               self.local_types)
        if target is not None:
            self.effects.calls.append((target.key, held, call))

    def _callback_check(self, call: ast.Call,
                        held: Tuple[str, ...]) -> None:
        func = call.func
        if not isinstance(func, ast.Attribute):
            return
        base = func.value
        owner: Optional[_ClassLocks] = None
        label = None
        if isinstance(base, ast.Name) and base.id == "self":
            owner, label = self.cl, f"self.{func.attr}"
        elif isinstance(base, ast.Name) and base.id in self.local_types:
            owner = self.index.classes.get(self.local_types[base.id])
            label = f"{base.id}.{func.attr}"
        if owner is None:
            return
        attr = func.attr
        if self.index.graph._method(owner.info, attr) is not None:
            return                  # a real method, not a stored hook
        stored = attr in owner.stored_callables
        if not stored and not (_CALLBACK_NAME_RE.search(attr)
                               and attr not in owner.locks):
            return
        self.findings.append(make_finding(
            self.src, "SWL305", call,
            f"stored callback `{label}` invoked while holding "
            f"{self._held_label(held)} — a re-entrant callback can "
            f"call back in and re-acquire (deadlock) or observe "
            f"half-updated state; snapshot under the lock, invoke "
            f"outside it"))

    def _field_access(self, node: ast.Attribute,
                      held: Tuple[str, ...]) -> None:
        if self.cl is None or self.is_ctor:
            return
        if not (isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return
        attr = node.attr
        if attr in self.cl.locks or attr in self.cl.declared_fields:
            return
        # `self._x is (not) None` doesn't race: the reference read is
        # atomic and the is-None feature-flag idiom never mutates after
        # construction — counting these as unguarded sites would flag
        # every enabled-check on a lazily-built subsystem
        parent = self.src._parents.get(node)
        if isinstance(parent, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot))
                for op in parent.ops) and any(
                    isinstance(c, ast.Constant) and c.value is None
                    for c in parent.comparators):
            return
        self.accesses.setdefault((self.cl.info.key, attr), []).append(
            (self._is_write(node), node, frozenset(held),
             self.fn.node.name, self.src))

    #: container-mutating method names counted as writes (SWL303 —
    #: ``self._items[k] = v`` and ``self._items.pop(k)`` race exactly
    #: like ``self._items = ...`` does)
    _MUTATORS = frozenset((
        "append", "appendleft", "add", "insert", "extend", "update",
        "pop", "popleft", "popitem", "remove", "discard", "clear",
        "setdefault", "sort", "reverse"))

    def _is_write(self, node: ast.Attribute) -> bool:
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            return True
        parent = self.src._parents.get(node)
        if isinstance(parent, ast.Subscript) and isinstance(
                parent.ctx, (ast.Store, ast.Del)):
            return True
        if (isinstance(parent, ast.Attribute)
                and parent.attr in self._MUTATORS
                and isinstance(self.src._parents.get(parent), ast.Call)):
            return True
        return False

    # helpers ----------------------------------------------------------

    def _in_while(self, node: ast.AST) -> bool:
        cur: Optional[ast.AST] = node
        while cur is not None and not isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if isinstance(cur, ast.While):
                return True
            cur = self.src._parents.get(cur)
        return False

    @staticmethod
    def _held_label(held: Tuple[str, ...]) -> str:
        return " + ".join(f"`{h}`" for h in held)


# --------------------------------------------------------------- the checks

def _propagate(effects: Dict[str, _Effects],
               max_rounds: int = 40) -> Dict[str, Dict[str, _Witness]]:
    """Transitive acquisitions per function with a bounded witness
    chain (holder function -> ... -> acquiring function)."""
    trans: Dict[str, Dict[str, _Witness]] = {
        k: dict(e.acquires) for k, e in effects.items()}
    for _ in range(max_rounds):
        changed = False
        for key, eff in effects.items():
            mine = trans[key]
            for callee, _held, node in eff.calls:
                for lock, wit in trans.get(callee, {}).items():
                    if lock in mine:
                        continue
                    if len(wit.path) >= 5:
                        continue
                    mine[lock] = _Witness(
                        wit.src, wit.node, wit.scope,
                        [f"{callee} (line {node.lineno})"] + wit.path)
                    changed = True
        if not changed:
            break
    return trans


def _cycles(edges: Dict[Tuple[str, str], _Witness]
            ) -> List[Set[str]]:
    """Strongly connected components with >= 2 nodes (iterative
    Tarjan over the acquisition-order graph)."""
    adj: Dict[str, List[str]] = {}
    for (a, b) in edges:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, [])
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    counter = [0]
    out: List[Set[str]] = []

    for root in adj:
        if root in index:
            continue
        work: List[Tuple[str, int]] = [(root, 0)]
        while work:
            node, pi = work[-1]
            if pi == 0:
                index[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on_stack.add(node)
            recurse = False
            children = adj[node]
            for i in range(pi, len(children)):
                ch = children[i]
                if ch not in index:
                    work[-1] = (node, i + 1)
                    work.append((ch, 0))
                    recurse = True
                    break
                if ch in on_stack:
                    low[node] = min(low[node], index[ch])
            if recurse:
                continue
            if low[node] == index[node]:
                scc: Set[str] = set()
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.add(w)
                    if w == node:
                        break
                if len(scc) > 1:
                    out.append(scc)
            work.pop()
            if work:
                parent, _ = work[-1]
                low[parent] = min(low[parent], low[node])
    return out


def _reverse_path(edges: Dict[Tuple[str, str], _Witness], scc: Set[str],
                  frm: str, to: str) -> Optional[List[Tuple[str, str]]]:
    """BFS path frm -> to through SCC edges, as a list of edges."""
    prev: Dict[str, Tuple[str, str]] = {}
    queue = [frm]
    seen = {frm}
    while queue:
        cur = queue.pop(0)
        for (a, b) in edges:
            if a != cur or b not in scc or b in seen:
                continue
            prev[b] = (a, b)
            if b == to:
                path = [(a, b)]
                while path[0][0] != frm:
                    path.insert(0, prev[path[0][0]])
                return path
            seen.add(b)
            queue.append(b)
    return None


def _edge_label(edge: Tuple[str, str],
                wit: _Witness) -> str:
    a, b = edge
    chain = " -> ".join(wit.path + [f"{wit.scope} (line "
                                    f"{getattr(wit.node, 'lineno', '?')})"])
    return f"{a} -> {b} via {chain}"


def check_project(srcs: Sequence[SourceFile],
                  graph: Optional[CallGraph] = None) -> List[Finding]:
    """Run SWL302-305 over a set of files as one program."""
    if graph is None:
        graph = CallGraph(srcs)
    index = _Index(srcs, graph)
    findings: List[Finding] = []
    edges: Dict[Tuple[str, str], _Witness] = {}
    effects: Dict[str, _Effects] = {}
    accesses: Dict[Tuple[str, str],
                   List[Tuple[bool, ast.AST, frozenset, str,
                              SourceFile]]] = {}

    for fi in graph.functions.values():
        eff = _Effects()
        effects[fi.key] = eff
        _FunctionWalker(fi, index, findings, edges, eff, accesses).run()

    # SWL302: call-derived edges, then cycle detection
    trans = _propagate(effects)
    for key, eff in effects.items():
        for callee, held, node in eff.calls:
            if not held:
                continue
            for lock, wit in trans.get(callee, {}).items():
                for h in held:
                    if h == lock:
                        continue
                    if (h, lock) not in edges:
                        src = graph.functions[key].src
                        edges[(h, lock)] = _Witness(
                            src, node, key,
                            [f"{callee} (line {node.lineno})"]
                            + wit.path)
    for scc in _cycles(edges):
        for (a, b), wit in sorted(edges.items(),
                                  key=lambda kv: (kv[1].src.path,
                                                  kv[1].node.lineno)):
            if a not in scc or b not in scc:
                continue
            back = _reverse_path(edges, scc, b, a)
            back_label = ("; ".join(
                _edge_label(e, edges[e]) for e in back)
                if back else "(reverse path elided)")
            fwd = _edge_label((a, b), wit)
            findings.append(make_finding(
                wit.src, "SWL302", wit.node,
                f"lock-order inversion: acquires `{b}` while holding "
                f"`{a}` [{fwd}], but the reverse order also exists "
                f"[{back_label}] — cycle means deadlock under "
                f"concurrency"))

    # SWL303: inferred guarded-by
    for (cls_key, attr), sites in sorted(accesses.items()):
        if len(sites) < SWL303_MIN_GUARDED + 1:
            continue
        if not any(w for (w, *_rest) in sites):
            continue                # never written outside a ctor
        by_lock: Dict[str, int] = {}
        for (_w, _n, held, _m, _s) in sites:
            for h in held:
                by_lock[h] = by_lock.get(h, 0) + 1
        if not by_lock:
            continue
        lock, guarded = max(by_lock.items(), key=lambda kv: kv[1])
        unguarded = [s for s in sites if lock not in s[2]]
        if guarded < SWL303_MIN_GUARDED or not unguarded:
            continue
        if len(unguarded) * 2 >= guarded + len(unguarded):
            continue                # not a clear majority: no inference
        for (is_write, node, _held, _meth, src) in unguarded:
            kind = "write" if is_write else "read"
            findings.append(make_finding(
                src, "SWL303", node,
                f"{kind} of `self.{attr}` without `{lock}` — inferred "
                f"guarded: {guarded} of {guarded + len(unguarded)} "
                f"sites access it under that lock (declare "
                f"`# swarmlint: guarded-by[...]` or take the lock)"))
    return findings
