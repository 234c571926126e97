"""swarmpage static half: KV-page lifetime analysis (SWL801-805).

Every correctness proof the serving stack leans on — bit-identical
migration replay, prefix hits riding ragged waves, squeeze-pool chaos —
rests on hand-managed page ownership: ``PageAllocator.allocate/
allocate_with_prefix/reserve/release_taken`` and ``PrefixLRU.pin/unpin/
release/evict_lru`` form an ownership protocol that nothing checked.
This pass tracks page-HANDLE values (the ints/lists/ndarrays those APIs
hand out) through assignments, aliases, calls, and returns — riding the
same interprocedural infrastructure as the lock family (callgraph.py) —
and enforces the protocol:

- **SWL801 page-leak**: an owned handle that escapes the function
  (return / raise / fall-through) without reaching a free sink,
  registration, custody transfer, or heap escape. Includes the
  *exception-path* variant: a handle destined for a free sink held
  across a raising call with no ``try`` protection — the shape that
  silently leaked drained retirement batches when a device dispatch
  failed between ``take_pending_frees`` and ``release_taken``.
- **SWL802 use-after-free**: a handle flowing into a page-table write
  (``set_page_table_rows``, ``paged_write_ragged``, gather/scatter
  descriptors) or any other read after a path that freed it.
- **SWL803 double-free**: the same handle reaching a free sink twice.
- **SWL804 pin-discipline**: every ``PrefixLRU.pin``/``match_and_pin``
  must be matched by ``unpin``/``release`` or a custody handoff on all
  paths — a leaked pin permanently inflates ``evictable_count``, which
  ``_backpressure_gate`` trusts as reclaimable headroom.
- **SWL805 table-write-before-alloc**: a handle reaches a table write
  before the allocator call that produces it on this path.

Ownership across call boundaries is declared with the grammar-
registered directives (core.py): ``# swarmlint: owns[page]: <param>``
(callee takes ownership — the caller is discharged and must not reuse
the handle) and ``# swarmlint: borrows[page]: <param>`` (callee only
borrows — the caller remains responsible). Producer-ness propagates
automatically through wrappers that ``return`` an allocator call
(``Engine._paged_allocate``); ``owns[page]: return`` declares it where
inference can't see. Unresolvable calls conservatively *escape* the
handle (ownership assumed transferred) so a missing annotation makes
the pass quieter, never wrong — the runtime twin
(``SWARMDB_PAGECHECK=1``, obs/pagecheck.py) owns what escapes statics.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .callgraph import CallGraph, FunctionInfo
from .core import Finding, SourceFile, dotted_name, make_finding

__all__ = ["check_project"]

#: call tails producing an OWNED page handle (receiver must look like a
#: pool — see _poolish): the caller is now responsible for the pages
_OWN_TAILS = {"allocate", "allocate_with_prefix", "reserve", "acquire",
              "evict_lru", "take_pending_frees"}
#: call tails producing a PINNED handle (pin discipline, SWL804)
_PIN_TAILS = {"match_and_pin"}
#: call tails that FREE the handles passed to them
_FREE_TAILS = {"add_free", "release_taken", "_give", "rolling_free"}
#: call tails that discharge a pin
_UNPIN_TAILS = {"unpin"}
#: call tails transferring custody without freeing (handle stays live)
#: — on_demote/on_promote move pages across the tier boundary (host
#: custody); the handle stays live until rolling_free
_XFER_TAILS = {"register", "transfer_to_cache", "requeue_pending",
               "on_demote", "on_promote"}
#: page-table write / dispatch-descriptor sinks (SWL802/SWL805 anchors)
_TABLE_TAILS = {"set_page_table_rows", "paged_write_ragged",
                "paged_write_decode", "paged_write_chunk",
                "paged_insert_prefill", "paged_gather_kv"}
#: builtins that observe a handle without taking custody
_PURE_OBSERVERS = {"len", "min", "max", "sum", "any", "all", "bool",
                   "int", "float", "str", "repr", "print", "isinstance",
                   "enumerate", "range", "zip", "abs", "id", "type",
                   "hasattr", "getattr"}
#: calls whose RESULT aliases their argument (list(pages) is pages)
_ALIAS_MAKERS = {"list", "tuple", "sorted", "reversed", "copy",
                 "deepcopy", "asarray", "array"}

_POOLISH_NAME_RE = re.compile(r"alloc|prefix|lru|page|pool", re.I)
_POOL_CLASS_RE = re.compile(r"Alloc|Prefix|LRU|Page")


@dataclass
class _Cell:
    """One tracked handle (aliases share the cell object)."""
    state: str                  # owned | pinned | freed | gone
    node: ast.AST               # producing node (report anchor)
    tail: str                   # producing call tail ("allocate", ...)
    via: Optional[ast.AST] = None       # the freeing node (SWL802/803)
    risky: List[int] = field(default_factory=list)  # raising-call lines
    reported: bool = False

    def clone(self) -> "_Cell":
        c = _Cell(self.state, self.node, self.tail, self.via,
                  list(self.risky), self.reported)
        return c


_Env = Dict[str, _Cell]


def _copy_env(env: _Env) -> _Env:
    """Branch copy preserving alias groupings."""
    remap: Dict[int, _Cell] = {}
    out: _Env = {}
    for name, cell in env.items():
        nc = remap.get(id(cell))
        if nc is None:
            nc = cell.clone()
            remap[id(cell)] = nc
        out[name] = nc
    return out


def _merge_env(a: _Env, b: _Env) -> _Env:
    """Post-branch join: keep names both sides agree on (or that only
    one side tracks); disagreement drops the cell — the pass stays
    silent rather than guessing."""
    out: _Env = {}
    for name in set(a) | set(b):
        ca, cb = a.get(name), b.get(name)
        if ca is None and cb is not None:
            out[name] = cb
        elif cb is None and ca is not None:
            out[name] = ca
        elif ca is not None and cb is not None:
            if ca.state == cb.state:
                ca.risky = sorted(set(ca.risky) | set(cb.risky))
                ca.reported = ca.reported or cb.reported
                out[name] = ca
    return out


def _names_in(expr: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(expr) if isinstance(n, ast.Name)}


def _escaping_names(expr: ast.AST) -> Set[str]:
    """Local names whose HANDLE escapes through ``expr``'s value (used
    for return statements): ``return pages`` escapes, ``return
    len(pages)`` does not."""
    if isinstance(expr, ast.Name):
        return {expr.id}
    if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
        out: Set[str] = set()
        for e in expr.elts:
            out |= _escaping_names(e)
        return out
    if isinstance(expr, ast.Starred):
        return _escaping_names(expr.value)
    if isinstance(expr, ast.Subscript):
        return _escaping_names(expr.value)
    if isinstance(expr, ast.BinOp):
        return _escaping_names(expr.left) | _escaping_names(expr.right)
    if isinstance(expr, ast.BoolOp):
        out = set()
        for v in expr.values:
            out |= _escaping_names(v)
        return out
    if isinstance(expr, ast.IfExp):
        return _escaping_names(expr.body) | _escaping_names(expr.orelse)
    if isinstance(expr, ast.Dict):
        out = set()
        for v in list(expr.keys) + list(expr.values):
            if v is not None:
                out |= _escaping_names(v)
        return out
    if isinstance(expr, ast.Call):
        name = dotted_name(expr.func)
        tail = name.split(".")[-1] if name else ""
        if tail in _PURE_OBSERVERS:
            return set()
        out = set()
        for a in list(expr.args) + [k.value for k in expr.keywords]:
            out |= (_escaping_names(a) if tail in _ALIAS_MAKERS
                    else _names_in(a))
        return out
    if isinstance(expr, (ast.Constant, ast.Compare, ast.UnaryOp,
                         ast.Attribute)):
        return set()
    return _names_in(expr)


# ----------------------------------------------------------- producers

def _return_nodes(fn: ast.AST) -> List[ast.Return]:
    """Return statements belonging to ``fn`` itself (not nested defs)."""
    out: List[ast.Return] = []
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Return):
            out.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return out


class _Index:
    """Project-wide producer/annotation index shared by all walkers."""

    def __init__(self, srcs: Sequence[SourceFile],
                 graph: CallGraph) -> None:
        self.graph = graph
        # fn key -> (owns param names, borrows param names)
        self.owns: Dict[str, Set[str]] = {}
        self.borrows: Dict[str, Set[str]] = {}
        self.producers: Set[str] = set()
        src_set = set(srcs)
        fns = [f for f in graph.functions.values() if f.src in src_set]
        for fi in fns:
            o, b = fi.src.page_decls(fi.node)
            if o:
                self.owns[fi.key] = o
            if b:
                self.borrows[fi.key] = b
            if "return" in o:
                self.producers.add(fi.key)
        # producer propagation: `return <allocator call>` makes the
        # wrapper a producer; fixpoint follows wrapper-of-wrapper
        edges: Dict[str, Set[str]] = {}
        for fi in fns:
            lt = graph.local_types(fi)
            for ret in _return_nodes(fi.node):
                if not isinstance(ret.value, ast.Call):
                    continue
                call = ret.value
                if self._raw_producer_tail(call, fi, lt):
                    self.producers.add(fi.key)
                    continue
                target = graph.resolve_call(call, fi, lt)
                if target is not None:
                    edges.setdefault(fi.key, set()).add(target.key)
        changed = True
        while changed:
            changed = False
            for key, callees in edges.items():
                if key not in self.producers and (
                        callees & self.producers):
                    self.producers.add(key)
                    changed = True

    # -- receiver classification ----------------------------------------

    def _receiver_class(self, base: ast.AST, fn: FunctionInfo,
                        local_types: Dict[str, str]) -> Optional[str]:
        if isinstance(base, ast.Name):
            if base.id == "self" and fn.cls is not None:
                return f"{fn.module}.{fn.cls.name}"
            return local_types.get(base.id)
        if (isinstance(base, ast.Attribute)
                and isinstance(base.value, ast.Name)
                and base.value.id == "self"):
            ci = self.graph.class_info(fn)
            if ci is not None:
                return ci.attr_types.get(base.attr)
        return None

    def poolish(self, func: ast.AST, fn: FunctionInfo,
                local_types: Dict[str, str]) -> bool:
        """Does this call's receiver look like a page pool / prefix
        cache? Resolved types decide; unresolved receivers fall back to
        a name heuristic (``alloc``/``prefix``/``lru``/``page``/
        ``pool``) — which also keeps lock ``.acquire()`` out."""
        if not isinstance(func, ast.Attribute):
            return False
        cls_key = self._receiver_class(func.value, fn, local_types)
        if cls_key is not None:
            cls_name = cls_key.split(".")[-1]
            return bool(_POOL_CLASS_RE.search(cls_name))
        name = dotted_name(func.value)
        return bool(name and _POOLISH_NAME_RE.search(name))

    def _raw_producer_tail(self, call: ast.Call, fn: FunctionInfo,
                           local_types: Dict[str, str]) -> Optional[str]:
        name = dotted_name(call.func)
        tail = name.split(".")[-1] if name else ""
        if tail in (_OWN_TAILS | _PIN_TAILS) and self.poolish(
                call.func, fn, local_types):
            return tail
        return None

    def producer_kind(self, call: ast.Call, fn: FunctionInfo,
                      local_types: Dict[str, str]) -> Optional[str]:
        """"owned"/"pinned" when the call produces a handle, else None."""
        tail = self._raw_producer_tail(call, fn, local_types)
        if tail is not None:
            return "pinned" if tail in _PIN_TAILS else "owned"
        target = self.graph.resolve_call(call, fn, local_types)
        if target is not None and target.key in self.producers:
            return "owned"
        return None

    def callee_decls(self, call: ast.Call, fn: FunctionInfo,
                     local_types: Dict[str, str]
                     ) -> Tuple[Optional[FunctionInfo], Set[str],
                                Set[str]]:
        target = self.graph.resolve_call(call, fn, local_types)
        if target is None:
            return None, set(), set()
        return (target, self.owns.get(target.key, set()),
                self.borrows.get(target.key, set()))


def _param_of_arg(call: ast.Call, idx: int, kw: Optional[str],
                  target: FunctionInfo) -> Optional[str]:
    """The callee parameter name a given argument lands on (methods
    skip ``self``; overflow positionals map to the vararg name). A
    ``**`` splat (a keyword with no name, ``idx`` -1) binds to no one
    parameter: the JAX package's copy reads ``names[-1]`` there, binding
    it to the last positional parameter, or raising IndexError when the
    callee has none."""
    if kw is not None:
        return kw
    if idx < 0:
        return None
    args = target.node.args
    names = [a.arg for a in args.args]
    if names and names[0] in ("self", "cls") and target.cls is not None:
        names = names[1:]
    if idx < len(names):
        return names[idx]
    if args.vararg is not None:
        return args.vararg.arg
    return None


# -------------------------------------------------------------- walker

class _PageWalker:
    def __init__(self, fn: FunctionInfo, index: _Index,
                 findings: List[Finding]) -> None:
        self.fn = fn
        self.index = index
        self.src = fn.src
        self.findings = findings
        self.local_types = index.graph.local_types(fn)
        # later producer-assignment lines per name (SWL805)
        self.producer_lines: Dict[str, List[int]] = {}
        for node in ast.walk(fn.node):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)
                    and index.producer_kind(node.value, fn,
                                            self.local_types)):
                self.producer_lines.setdefault(
                    node.targets[0].id, []).append(node.lineno)

    # -- entry ---------------------------------------------------------

    def run(self) -> None:
        env: _Env = {}
        owns, _borrows = self.src.page_decls(self.fn.node)
        for name in owns:
            if name != "return":
                env[name] = _Cell("owned", self.fn.node, "owns[page]")
        terminated = self._stmts(list(self.fn.node.body), env)
        if not terminated:
            self._report_live(env, None)

    # -- reporting -----------------------------------------------------

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        self.findings.append(make_finding(self.src, rule, node, message))

    def _report_live(self, env: _Env, at: Optional[ast.AST],
                     how: str = "") -> None:
        seen: Set[int] = set()
        for name, cell in env.items():
            if id(cell) in seen or cell.reported:
                continue
            seen.add(id(cell))
            if cell.state == "owned":
                cell.reported = True
                self._emit("SWL801", at or cell.node,
                           f"page handle `{name}` (from `{cell.tail}`) "
                           f"{how or 'escapes every path'} without a "
                           f"free/registration/custody transfer — the "
                           f"pages leak from the pool")
            elif cell.state == "pinned":
                cell.reported = True
                self._emit("SWL804", at or cell.node,
                           f"pinned pages `{name}` (from `{cell.tail}`) "
                           f"{how or 'escape every path'} without "
                           f"unpin/release/handoff — evictable_count "
                           f"drifts and the backpressure gate "
                           f"overcounts reclaimable headroom")

    # -- statements ----------------------------------------------------

    def _stmts(self, body: List[ast.stmt], env: _Env) -> bool:
        """Walk a statement list; True when the block definitely
        terminated (return/raise/break/continue)."""
        for stmt in body:
            if self._stmt(stmt, env):
                return True
        return False

    def _stmt(self, node: ast.stmt, env: _Env) -> bool:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            nested = FunctionInfo(
                key=f"{self.fn.key}.{node.name}", module=self.fn.module,
                src=self.src, node=node, cls=self.fn.cls)
            _PageWalker(nested, self.index, self.findings).run()
            return False
        if isinstance(node, ast.Return):
            if node.value is not None:
                if isinstance(node.value, ast.Call) and \
                        self.index.producer_kind(node.value, self.fn,
                                                 self.local_types):
                    # `return alloc.allocate(...)`: the caller owns it
                    self._calls_in(node.value, env, skip_top=True)
                else:
                    self._calls_in(node.value, env)
                for name in _escaping_names(node.value):
                    cell = env.get(name)
                    if cell is None:
                        continue
                    if cell.state in ("owned", "pinned"):
                        cell.state = "gone"
                    elif cell.state == "freed" and not cell.reported:
                        cell.reported = True
                        self._emit(
                            "SWL802", node,
                            f"`{name}` returned after being freed at "
                            f"line {getattr(cell.via, 'lineno', '?')} "
                            f"— the caller receives a dead handle")
            self._report_live(env, node, "are live at this return")
            return True
        if isinstance(node, ast.Raise):
            if node.exc is not None:
                self._calls_in(node.exc, env)
            self._report_live(env, node, "are live at this raise")
            return True
        if isinstance(node, (ast.Break, ast.Continue)):
            return True
        if isinstance(node, ast.If):
            self._calls_in(node.test, env)
            then_env = _copy_env(env)
            else_env = _copy_env(env)
            self._apply_guard(node.test, then_env, else_env)
            t_term = self._stmts(node.body, then_env)
            e_term = self._stmts(node.orelse, else_env) \
                if node.orelse else False
            if t_term and e_term:
                return True
            if t_term:
                merged = else_env
            elif e_term:
                merged = then_env
            else:
                merged = _merge_env(then_env, else_env)
            env.clear()
            env.update(merged)
            return False
        if isinstance(node, ast.While):
            self._calls_in(node.test, env)
            body_env = _copy_env(env)
            self._stmts(node.body, body_env)
            merged = _merge_env(env, body_env)
            env.clear()
            env.update(merged)
            if node.orelse:
                self._stmts(node.orelse, env)
            return False
        if isinstance(node, (ast.For, ast.AsyncFor)):
            self._calls_in(node.iter, env)
            self._loop_iter_custody(node, env)
            body_env = _copy_env(env)
            self._stmts(node.body, body_env)
            merged = _merge_env(env, body_env)
            env.clear()
            env.update(merged)
            if node.orelse:
                self._stmts(node.orelse, env)
            return False
        if isinstance(node, ast.Try):
            pre = _copy_env(env)
            body_term = self._stmts(node.body, env)
            handler_envs = []
            for h in node.handlers:
                henv = _copy_env(pre)
                if not self._stmts(h.body, henv):
                    handler_envs.append(henv)
            merged = env if not body_term else None
            for henv in handler_envs:
                merged = henv if merged is None \
                    else _merge_env(merged, henv)
            if merged is None:
                merged = pre if not node.finalbody else _copy_env(pre)
            env.clear()
            env.update(merged)
            if node.finalbody:
                if self._stmts(node.finalbody, env):
                    return True
            return body_term and not handler_envs and not node.orelse
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                self._calls_in(item.context_expr, env)
            return self._stmts(node.body, env)
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            return self._assign(node, node.targets[0], node.value, env)
        if isinstance(node, ast.AnnAssign) and node.value is not None:
            return self._assign(node, node.target, node.value, env)
        # everything else: apply call effects in the contained exprs
        for _f, value in ast.iter_fields(node):
            if isinstance(value, ast.AST):
                self._calls_in(value, env)
            elif isinstance(value, list):
                for v in value:
                    if isinstance(v, ast.stmt):
                        self._stmt(v, env)
                    elif isinstance(v, ast.AST):
                        self._calls_in(v, env)
        return False

    def _loop_iter_custody(self, node: ast.For, env: _Env) -> None:
        """``for p in pages:`` — if the body frees/unpins each ``p``,
        the whole handle is discharged; otherwise it escapes element-
        wise (conservatively silent)."""
        if not (isinstance(node.iter, ast.Name)
                and isinstance(node.target, ast.Name)):
            return
        cell = env.get(node.iter.id)
        if cell is None or cell.state not in ("owned", "pinned"):
            return
        tgt = node.target.id
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            name = dotted_name(sub.func)
            tail = name.split(".")[-1] if name else ""
            if tail in (_FREE_TAILS | _UNPIN_TAILS | {"release"}):
                if any(tgt in _names_in(a) for a in sub.args):
                    self._free_cell(cell, node.iter.id, sub, tail)
                    return
        cell.state = "gone"

    def _apply_guard(self, test: ast.AST, then_env: _Env,
                     else_env: _Env) -> None:
        """Truthiness/None guards: in the branch where the handle is
        None/empty there is nothing to discharge."""
        name = None
        absent_in_then = False
        if isinstance(test, ast.Name):
            name, absent_in_then = test.id, False
        elif (isinstance(test, ast.UnaryOp)
              and isinstance(test.op, ast.Not)
              and isinstance(test.operand, ast.Name)):
            name, absent_in_then = test.operand.id, True
        elif (isinstance(test, ast.Compare) and len(test.ops) == 1
              and isinstance(test.left, ast.Name)
              and isinstance(test.comparators[0], ast.Constant)
              and test.comparators[0].value is None):
            name = test.left.id
            absent_in_then = isinstance(test.ops[0], ast.Is)
        if name is None:
            return
        (then_env if absent_in_then else else_env).pop(name, None)

    # -- assignment ----------------------------------------------------

    def _assign(self, stmt: ast.stmt, target: ast.AST, value: ast.AST,
                env: _Env) -> bool:
        if isinstance(target, ast.Name):
            if isinstance(value, ast.Call):
                kind = self.index.producer_kind(value, self.fn,
                                                self.local_types)
                if kind is not None:
                    self._calls_in(value, env, skip_top=True)
                    env[target.id] = _Cell(
                        kind, value,
                        (dotted_name(value.func) or "?").split(".")[-1])
                    return False
                name = dotted_name(value.func)
                tail = name.split(".")[-1] if name else ""
                if tail in _ALIAS_MAKERS and value.args:
                    # list(pages) / np.asarray(pending, np.int32): the
                    # result aliases the first argument's handle
                    inner = value.args[0]
                    alias = self._alias_of(inner, env)
                    if alias is not None:
                        self._calls_in(value, env, skip_top=True)
                        env[target.id] = alias
                        return False
            else:
                alias = self._alias_of(value, env)
                if alias is not None:
                    env[target.id] = alias
                    return False
            self._calls_in(value, env)
            env.pop(target.id, None)
            return False
        # store into an attribute/subscript: the handle escapes to the
        # heap — custody is the structure owner's problem now
        self._calls_in(value, env)
        for name in _names_in(value):
            cell = env.get(name)
            if cell is not None and cell.state in ("owned", "pinned"):
                cell.state = "gone"
            elif cell is not None and cell.state == "freed":
                self._emit("SWL802", stmt,
                           f"`{name}` stored after being freed at line "
                           f"{getattr(cell.via, 'lineno', '?')} — the "
                           f"pages may already belong to another "
                           f"conversation")
        return False

    def _alias_of(self, expr: ast.AST, env: _Env) -> Optional[_Cell]:
        if isinstance(expr, ast.Name):
            return env.get(expr.id)
        if isinstance(expr, ast.Subscript) and isinstance(
                expr.value, ast.Name):
            return env.get(expr.value.id)
        return None

    # -- calls ---------------------------------------------------------

    def _calls_in(self, expr: ast.AST, env: _Env,
                  skip_top: bool = False) -> None:
        calls = [n for n in ast.walk(expr) if isinstance(n, ast.Call)]
        for i, call in enumerate(calls):
            if skip_top and i == 0 and call is expr:
                continue
            self._handle_call(call, env)

    def _in_handled_try(self, node: ast.AST) -> bool:
        cur: Optional[ast.AST] = node
        while cur is not None and not isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            parent = self.src._parents.get(cur)
            if isinstance(parent, ast.Try) and (
                    parent.handlers or parent.finalbody):
                return True
            cur = parent
        return False

    def _free_cell(self, cell: _Cell, name: str, call: ast.Call,
                   tail: str) -> None:
        if cell.state == "freed":
            if not cell.reported:
                cell.reported = True
                self._emit("SWL803", call,
                           f"double-free of `{name}`: already freed at "
                           f"line {getattr(cell.via, 'lineno', '?')} — "
                           f"the second `{tail}` forks custody and two "
                           f"future allocations will alias these pages")
            return
        if cell.state in ("owned", "pinned"):
            if cell.risky and not self._in_handled_try(call) \
                    and not cell.reported:
                cell.reported = True
                self._emit("SWL801", cell.node,
                           f"page handle `{name}` leaks on the "
                           f"exception path: a raising call (line"
                           f"{'s' if len(cell.risky) > 1 else ''} "
                           f"{', '.join(map(str, cell.risky))}) sits "
                           f"between here and the `{tail}` at line "
                           f"{call.lineno} with no try protection — "
                           f"an exception skips the free forever")
            cell.state = "freed"
            cell.via = call

    def _inside_sink_call(self, call: ast.Call) -> bool:
        """Nested inside the argument of a sink or an annotated call
        (``add_free(list(pages))``, ``_mirrored(np.asarray(pending))``):
        the OUTER call's semantics already decided the names' fate —
        re-processing the inner call would read a just-freed handle as
        a UAF or escape a borrowed one."""
        sinks = (_FREE_TAILS | _UNPIN_TAILS | _XFER_TAILS | _TABLE_TAILS
                 | {"release", "pin"})
        cur = self.src._parents.get(call)
        while cur is not None and not isinstance(cur, ast.stmt):
            if isinstance(cur, ast.Call) and cur is not call:
                name = dotted_name(cur.func)
                if name and name.split(".")[-1] in sinks:
                    return True
                target, owns, borrows = self.index.callee_decls(
                    cur, self.fn, self.local_types)
                if target is not None and (owns or borrows):
                    return True
            cur = self.src._parents.get(cur)
        return False

    def _handle_call(self, call: ast.Call, env: _Env) -> None:
        name = dotted_name(call.func)
        tail = name.split(".")[-1] if name else ""
        if tail in _PURE_OBSERVERS and isinstance(call.func, ast.Name):
            return
        if self._inside_sink_call(call):
            return
        arg_exprs = list(call.args) + [k.value for k in call.keywords]
        poolish = self.index.poolish(call.func, self.fn,
                                     self.local_types)

        # table-write sinks: uses, never discharges (SWL802/805)
        if tail in _TABLE_TAILS:
            for a in arg_exprs:
                for n in _names_in(a):
                    cell = env.get(n)
                    if cell is not None and cell.state == "freed":
                        if not cell.reported:
                            cell.reported = True
                            self._emit(
                                "SWL802", call,
                                f"`{n}` flows into `{tail}` after "
                                f"being freed at line "
                                f"{getattr(cell.via, 'lineno', '?')} "
                                f"— the table write blesses pages "
                                f"another slot may now own")
                    elif cell is None and self._later_producer(n, call):
                        self._emit(
                            "SWL805", call,
                            f"`{n}` reaches the table write `{tail}` "
                            f"before the allocator call that produces "
                            f"it on this path (line "
                            f"{self.producer_lines[n][0]}) — the row "
                            f"blesses pages the pool has not granted")
            self._mark_risky(call, env)
            return

        # free / unpin / transfer sinks
        if tail in _FREE_TAILS or (tail == "release" and poolish):
            for a in arg_exprs:
                for n in _escaping_names(a):
                    cell = env.get(n)
                    if cell is not None:
                        self._free_cell(cell, n, call, tail)
            self._mark_risky(call, env)
            return
        if tail in _UNPIN_TAILS and poolish:
            for a in arg_exprs:
                for n in _escaping_names(a):
                    cell = env.get(n)
                    if cell is not None and cell.state == "pinned":
                        cell.state = "gone"
            self._mark_risky(call, env)
            return
        if tail in _XFER_TAILS and poolish:
            for a in arg_exprs:
                for n in _escaping_names(a):
                    cell = env.get(n)
                    if cell is not None and cell.state in ("owned",
                                                           "pinned"):
                        cell.state = "gone"
            self._mark_risky(call, env)
            return
        if tail == "pin" and poolish:
            for a in arg_exprs:
                for n in _escaping_names(a):
                    cell = env.get(n)
                    if cell is not None and cell.state == "owned":
                        cell.state = "pinned"
                    elif cell is None:
                        env[n] = _Cell("pinned", call, "pin")
            self._mark_risky(call, env)
            return

        # bare producer whose result is dropped on the floor
        kind = self.index.producer_kind(call, self.fn, self.local_types)
        if kind is not None:
            parent = self.src._parents.get(call)
            if isinstance(parent, ast.Expr):
                self._emit(
                    "SWL801" if kind == "owned" else "SWL804", call,
                    f"result of `{tail}` is dropped — the "
                    f"{'pages' if kind == 'owned' else 'pinned pages'} "
                    f"it hands out can never be "
                    f"{'freed' if kind == 'owned' else 'unpinned'}")
            self._mark_risky(call, env)
            return

        # resolved callee: honor owns[]/borrows[] param declarations
        target, owns, borrows = self.index.callee_decls(
            call, self.fn, self.local_types)
        for idx, a in enumerate(call.args):
            self._arg_effect(call, a, idx, None, target, owns, borrows,
                             env)
        for k in call.keywords:
            self._arg_effect(call, k.value, -1, k.arg, target, owns,
                             borrows, env)
        self._mark_risky(call, env)

    def _arg_effect(self, call: ast.Call, arg: ast.AST, idx: int,
                    kw: Optional[str], target: Optional[FunctionInfo],
                    owns: Set[str], borrows: Set[str],
                    env: _Env) -> None:
        param = (_param_of_arg(call, idx, kw, target)
                 if target is not None else None)
        # value-escape semantics: `np.zeros((len(pending), maxp))` only
        # OBSERVES pending — the handle doesn't travel into the result
        for n in _escaping_names(arg):
            cell = env.get(n)
            if cell is None:
                continue
            if cell.state == "freed":
                if not cell.reported:
                    cell.reported = True
                    self._emit(
                        "SWL802", call,
                        f"`{n}` passed onward after being freed at "
                        f"line {getattr(cell.via, 'lineno', '?')} — "
                        f"use-after-free")
                continue
            if param is not None and param in borrows:
                continue            # caller keeps responsibility
            if param is not None and param in owns:
                # ownership transferred INTO the callee: the handle is
                # dead to this function — reuse is use-after-transfer
                cell.state = "freed"
                cell.via = call
                continue
            if cell.state in ("owned", "pinned"):
                cell.state = "gone"  # conservative escape

    def _later_producer(self, name: str, call: ast.Call) -> bool:
        lines = self.producer_lines.get(name)
        return bool(lines) and all(ln > call.lineno for ln in lines)

    def _mark_risky(self, call: ast.Call, env: _Env) -> None:
        if self._in_handled_try(call):
            return
        seen: Set[int] = set()
        for cell in env.values():
            if id(cell) in seen:
                continue
            seen.add(id(cell))
            if cell.state in ("owned", "pinned"):
                cell.risky.append(call.lineno)


# ---------------------------------------------------------------- entry

def check_project(srcs: Sequence[SourceFile],
                  graph: Optional[CallGraph] = None) -> List[Finding]:
    """Run SWL801-805 over a set of files as one program."""
    if graph is None:
        graph = CallGraph(srcs)
    index = _Index(srcs, graph)
    findings: List[Finding] = []
    src_set = set(srcs)
    for fi in graph.functions.values():
        if fi.src in src_set:
            _PageWalker(fi, index, findings).run()
    return findings
