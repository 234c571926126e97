"""Best-effort intra-package call graph (shared infra).

The lock-family checks (lockorder.py) need to answer "what does this
function *transitively* acquire?", which no per-file pass can: the
AB-BA deadlock that kills control planes is two functions that each
look fine alone and only compose into a cycle through a call edge.
This module builds that edge set from the same ``SourceFile`` objects
the per-file checkers already parse — stdlib-only, resolution is
best-effort and *sound-ish for this repo's idiom* rather than general:

- ``self.meth()``            -> method of the enclosing class (base
  classes followed by name when they are defined in the scanned set);
- ``foo()``                  -> same-module function, else a
  ``from X import foo`` target defined in the scanned set;
- ``mod.foo()``              -> module-level function of an imported
  scanned module;
- ``self._attr.meth()`` and ``local.meth()`` -> resolved through a
  one-level type inference: ``self._attr = SomeClass(...)`` in any
  method, ``local = SomeClass(...)`` in the same function, or a plain
  ``name: SomeClass`` annotation.

Unresolvable calls are silently dropped — a missing edge can only make
the interprocedural checks *quieter*, never wrong. Module identity is
the trailing two path components (``backend.engine``), matching the
fingerprint convention in core.py, so ``backend/chaos.py`` and
``ha/chaos.py`` stay distinct.

Hostsync/recompile can grow interprocedural variants on top of this
later; nothing here is lock-specific.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import SourceFile, dotted_name

__all__ = ["CallGraph", "FunctionInfo", "ClassInfo", "module_name"]


def module_name(path: str) -> str:
    """Trailing-two-component dotted module id (``backend.engine``)."""
    norm = os.path.normpath(path).replace(os.sep, "/")
    parts = norm.split("/")
    stem = parts[-1][:-3] if parts[-1].endswith(".py") else parts[-1]
    if stem == "__init__" and len(parts) >= 2:
        return parts[-2]
    if len(parts) >= 2:
        return f"{parts[-2]}.{stem}"
    return stem


@dataclass
class FunctionInfo:
    key: str                      # "backend.engine.Engine._run"
    module: str
    src: SourceFile
    node: ast.AST                 # FunctionDef / AsyncFunctionDef
    cls: Optional[ast.ClassDef] = None

    @property
    def name(self) -> str:
        return self.node.name


@dataclass
class ClassInfo:
    key: str                      # "backend.engine.Engine"
    module: str
    src: SourceFile
    node: ast.ClassDef
    methods: Dict[str, FunctionInfo] = field(default_factory=dict)
    bases: List[str] = field(default_factory=list)       # base class names
    attr_types: Dict[str, str] = field(default_factory=dict)  # attr -> cls


class CallGraph:
    """Function/class index over a set of SourceFiles + call resolution."""

    def __init__(self, srcs: Sequence[SourceFile]) -> None:
        self.functions: Dict[str, FunctionInfo] = {}
        self.classes: Dict[str, ClassInfo] = {}
        # simple-name indexes for cross-module best-effort resolution
        self._cls_by_name: Dict[str, List[ClassInfo]] = {}
        self._fn_by_name: Dict[str, List[FunctionInfo]] = {}
        # per-module import table: local name -> dotted source ("x.y.z"
        # for `import x.y.z as name`, "x.y.z.attr" for `from x.y.z
        # import attr as name`)
        self._imports: Dict[str, Dict[str, str]] = {}
        self._modules: Dict[str, SourceFile] = {}
        for src in srcs:
            self._index(src)
        for src in srcs:
            self._infer_attr_types(src)

    # ------------------------------------------------------------- indexing

    def _index(self, src: SourceFile) -> None:
        mod = module_name(src.path)
        self._modules[mod] = src
        imports: Dict[str, str] = {}
        self._imports[mod] = imports
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    imports[alias.asname or alias.name.split(".")[0]] = \
                        alias.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    imports[alias.asname or alias.name] = \
                        f"{node.module}.{alias.name}"

        def add_fn(fn: ast.AST, cls: Optional[ast.ClassDef]) -> FunctionInfo:
            qual = src.qualname(fn)
            info = FunctionInfo(key=f"{mod}.{qual}", module=mod, src=src,
                                node=fn, cls=cls)
            self.functions[info.key] = info
            self._fn_by_name.setdefault(fn.name, []).append(info)
            return info

        for stmt in src.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                add_fn(stmt, None)
            elif isinstance(stmt, ast.ClassDef):
                ci = ClassInfo(key=f"{mod}.{stmt.name}", module=mod,
                               src=src, node=stmt,
                               bases=[b for b in
                                      (dotted_name(x) for x in stmt.bases)
                                      if b])
                self.classes[ci.key] = ci
                self._cls_by_name.setdefault(stmt.name, []).append(ci)
                for item in stmt.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        ci.methods[item.name] = add_fn(item, stmt)

    def _infer_attr_types(self, src: SourceFile) -> None:
        """``self._x = SomeClass(...)`` anywhere in a class -> attr type
        (only when SomeClass resolves to a scanned class)."""
        mod = module_name(src.path)
        for ci in self.classes.values():
            if ci.module != mod or ci.src is not src:
                continue
            for node in ast.walk(ci.node):
                target_attr = None
                value = None
                if isinstance(node, ast.Assign) and len(node.targets) == 1:
                    target_attr, value = node.targets[0], node.value
                elif isinstance(node, ast.AnnAssign):
                    target_attr, value = node.target, node.value
                if not (isinstance(target_attr, ast.Attribute)
                        and isinstance(target_attr.value, ast.Name)
                        and target_attr.value.id == "self"):
                    continue
                cls = None
                if isinstance(value, ast.Call):
                    cls = self._class_for(dotted_name(value.func), mod)
                if cls is None and isinstance(node, ast.AnnAssign):
                    cls = self._class_for(dotted_name(node.annotation), mod)
                if cls is not None:
                    ci.attr_types[target_attr.attr] = cls.key

    # ----------------------------------------------------------- resolution

    def class_info(self, fn: FunctionInfo) -> Optional[ClassInfo]:
        if fn.cls is None:
            return None
        return self.classes.get(f"{fn.module}.{fn.cls.name}")

    def _ann_name(self, ann: Optional[ast.AST]) -> Optional[str]:
        """Annotation -> dotted name, unwrapping string annotations
        (``x: "Store"``) and Optional[...] -style subscripts."""
        if ann is None:
            return None
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            try:
                ann = ast.parse(ann.value, mode="eval").body
            except SyntaxError:
                return None
        if isinstance(ann, ast.Subscript):
            head = dotted_name(ann.value)
            if head and head.split(".")[-1] == "Optional":
                return self._ann_name(ann.slice)
            return None
        return dotted_name(ann)

    def _class_for(self, name: Optional[str], mod: str) -> \
            Optional[ClassInfo]:
        """Resolve a (possibly dotted) class name seen in ``mod``."""
        if not name:
            return None
        simple = name.split(".")[-1]
        ci = self.classes.get(f"{mod}.{simple}")
        if ci is not None:
            return ci
        cands = self._cls_by_name.get(simple, [])
        if len(cands) == 1:
            return cands[0]
        # disambiguate through the import table when possible
        dotted = self._imports.get(mod, {}).get(name.split(".")[0])
        if dotted:
            for c in cands:
                if dotted.endswith(c.module) or c.module.endswith(
                        dotted.split(".")[-1]):
                    return c
        return None

    def _method(self, ci: Optional[ClassInfo],
                name: str) -> Optional[FunctionInfo]:
        """Method lookup walking same-set base classes by name."""
        seen: Set[str] = set()
        while ci is not None and ci.key not in seen:
            seen.add(ci.key)
            if name in ci.methods:
                return ci.methods[name]
            nxt = None
            for base in ci.bases:
                cand = self._class_for(base, ci.module)
                if cand is not None:
                    nxt = cand
                    break
            ci = nxt
        return None

    def local_types(self, fn: FunctionInfo) -> Dict[str, str]:
        """``x = SomeClass(...)`` / ``x: SomeClass`` in this function."""
        out: Dict[str, str] = {}
        for node in ast.walk(fn.node):
            tgt = val = ann = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt, val = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign):
                tgt, val, ann = node.target, node.value, node.annotation
            elif isinstance(node, ast.arg):
                tgt, ann = node, node.annotation
            if isinstance(tgt, ast.Name):
                name = tgt.id
            elif isinstance(tgt, ast.arg):
                name = tgt.arg
            else:
                continue
            cls = None
            if isinstance(val, ast.Call):
                cls = self._class_for(dotted_name(val.func), fn.module)
            if cls is None and ann is not None:
                cls = self._class_for(self._ann_name(ann), fn.module)
            if cls is not None:
                out[name] = cls.key
        return out

    def resolve_call(self, call: ast.Call, caller: FunctionInfo,
                     local_types: Optional[Dict[str, str]] = None
                     ) -> Optional[FunctionInfo]:
        """The FunctionInfo a call lands on, or None when unresolvable."""
        func = call.func
        mod = caller.module
        if isinstance(func, ast.Name):
            info = self.functions.get(f"{mod}.{func.id}")
            if info is not None and info.cls is None:
                return info
            dotted = self._imports.get(mod, {}).get(func.id)
            if dotted:
                cands = [f for f in self._fn_by_name.get(
                    dotted.split(".")[-1], []) if f.cls is None]
                if len(cands) == 1:
                    return cands[0]
            return None
        if not isinstance(func, ast.Attribute):
            return None
        base, meth = func.value, func.attr
        # self.meth(...)
        if isinstance(base, ast.Name) and base.id == "self":
            return self._method(self.class_info(caller), meth)
        # ClassName.meth(...) / mod.func(...) / typed_local.meth(...)
        if isinstance(base, ast.Name):
            if local_types and base.id in local_types:
                return self._method(self.classes.get(local_types[base.id]),
                                    meth)
            ci = self._class_for(base.id, mod)
            if ci is not None:
                return self._method(ci, meth)
            dotted = self._imports.get(mod, {}).get(base.id)
            if dotted:
                target_mod = ".".join(dotted.split(".")[-2:])
                info = (self.functions.get(f"{target_mod}.{meth}")
                        or self.functions.get(
                            f"{dotted.split('.')[-1]}.{meth}"))
                if info is not None and info.cls is None:
                    return info
            return None
        # self._attr.meth(...) through the inferred attr type
        if (isinstance(base, ast.Attribute)
                and isinstance(base.value, ast.Name)
                and base.value.id == "self"):
            ci = self.class_info(caller)
            if ci is not None and base.attr in ci.attr_types:
                return self._method(self.classes.get(
                    ci.attr_types[base.attr]), meth)
        return None
