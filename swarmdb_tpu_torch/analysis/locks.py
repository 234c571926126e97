"""lock-discipline check (SWL301).

The repo's worst concurrency bugs have been unguarded shared-state access
(`broker/replica.py`'s mirror map read outside its lock, in the JAX
package). Classes declare which attributes a lock/Condition guards with an
inline directive::

    # swarmlint: guarded-by[self._cv]: _queue, _admitting, _stop

A guard spelled ``self.X`` attaches to the enclosing class and covers
``self.<name>`` accesses in every method; a bare-name guard (``lock``)
attaches to the enclosing function and covers its locals. Every read or
write of a guarded name outside a ``with <guard>:`` block is a finding,
with these deliberate carve-outs:

- ``__init__``-style constructor bodies (construction happens-before
  sharing);
- the declaration's own line (the initial binding);
- nested ``def``s inherit the *declaration* but not any held lock — a
  closure handed to another thread must re-acquire, which is exactly the
  replica ``ack_loop`` shape this check exists to police.

The guard expression is matched by normalized source text
(``ast.unparse``), so ``with self._cv:`` satisfies ``self._cv`` and
``with lock:`` satisfies ``lock``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, GuardDecl, SourceFile, make_finding

CONSTRUCTORS = ("__init__", "__new__", "__post_init__")


def _guard_text(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - malformed expr
        return "<unparseable>"


class _ScopeGuards:
    """Guard declarations in force for one class or function scope."""

    def __init__(self, decls: List[GuardDecl]) -> None:
        self.by_name: Dict[str, str] = {}
        self.decl_lines: Dict[str, Set[int]] = {}
        for d in decls:
            for n in d.names:
                self.by_name[n] = d.guard
                # the declaration exempts its own line AND the next one:
                # a standalone directive comment sits directly above the
                # initial binding it documents
                self.decl_lines.setdefault(n, set()).update(
                    (d.line, d.line + 1))


def _attach_decls(src: SourceFile) -> Tuple[
        Dict[ast.ClassDef, List[GuardDecl]],
        Dict[ast.AST, List[GuardDecl]]]:
    cls_decls: Dict[ast.ClassDef, List[GuardDecl]] = {}
    fn_decls: Dict[ast.AST, List[GuardDecl]] = {}
    for decl in src.directives.guards:
        if decl.guard.startswith("self."):
            scope = src.enclosing_scope(decl.line, classes_only=True)
            if isinstance(scope, ast.ClassDef):
                cls_decls.setdefault(scope, []).append(decl)
        else:
            scope = src.enclosing_scope(decl.line)
            if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fn_decls.setdefault(scope, []).append(decl)
    return cls_decls, fn_decls


def check(src: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    cls_decls, fn_decls = _attach_decls(src)

    def visit(node: ast.AST, guards: _ScopeGuards, held: Set[str],
              self_mode: bool, in_ctor: bool) -> None:
        if isinstance(node, ast.With):
            new_held = held | {_guard_text(i.context_expr)
                               for i in node.items}
            for item in node.items:
                visit(item, guards, held, self_mode, in_ctor)
            for stmt in node.body:
                visit(stmt, guards, new_held, self_mode, in_ctor)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # may run on another thread: declarations apply, held locks
            # do not cross the boundary (unless the def itself declares
            # a holds[] calling contract)
            inner_held = src.held_guards(node)
            for child in ast.iter_child_nodes(node):
                visit(child, guards, inner_held, self_mode, in_ctor)
            return
        name = _guarded_access(node, guards, self_mode)
        if name is not None and not in_ctor:
            guard = guards.by_name[name]
            if (guard not in held
                    and node.lineno not in guards.decl_lines[name]):
                kind = ("write" if isinstance(getattr(node, "ctx", None),
                                              (ast.Store, ast.Del))
                        else "read")
                label = f"self.{name}" if self_mode else name
                findings.append(make_finding(
                    src, "SWL301", node,
                    f"{kind} of `{label}` outside `with {guard}` "
                    f"(declared guard)"))
        for child in ast.iter_child_nodes(node):
            visit(child, guards, held, self_mode, in_ctor)

    def _guarded_access(node: ast.AST, guards: _ScopeGuards,
                        self_mode: bool) -> Optional[str]:
        if self_mode:
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "self"
                    and node.attr in guards.by_name):
                return node.attr
        elif isinstance(node, ast.Name) and node.id in guards.by_name:
            return node.id
        return None

    # class-level declarations: every method except constructors
    for cls, decls in cls_decls.items():
        guards = _ScopeGuards(decls)
        for item in cls.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ctor = item.name in CONSTRUCTORS
                held = src.held_guards(item)
                for child in ast.iter_child_nodes(item):
                    visit(child, guards, held, True, ctor)

    # function-level declarations: that function's body (nested defs
    # reset the held set at their boundary inside visit)
    for fn, decls in fn_decls.items():
        guards = _ScopeGuards(decls)
        held = src.held_guards(fn)
        for child in ast.iter_child_nodes(fn):
            visit(child, guards, held, False, False)

    return findings
