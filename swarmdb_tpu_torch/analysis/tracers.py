"""capture-leak check (SWL401): the card's counterpart of the tracer leak.

The JAX rule (``swarmdb_tpu/analysis/tracers.py``) flags stores out of a
traced function, which run once at trace time and leak a tracer. A CUDA
graph capture runs its Python once too, and records device work that every
replay repeats, so the same stores leak on the card in two ways:

- **A tensor made under capture and kept.** A tensor allocated while a
  graph captures lives in the graph's private memory pool. Stored on
  ``self``, a global or a nonlocal, it outlives the capture, but the next
  replay (of this graph or of another graph in the pool) overwrites it: a
  reader outside the graph sees whatever the last replay left there. Any
  store of a computed value (a call, arithmetic, an index) to ``self.<x>``
  or to a ``global`` / ``nonlocal`` name inside a capture body is a
  finding; a constant flag is not.
- **An attribute a capture reads, rebound.** A graph reads the storage its
  capture saw. ``self.x = new_tensor`` leaves the graph reading the old
  storage; only ``self.x.copy_(new)`` reaches it. Every ``self.<attr>`` a
  capture body of a class reads, rebound in a method of that class other
  than ``__init__``, is a finding — unless the same method also rebinds
  the attribute holding the class's graph runner (a state rebuild that
  drops its graphs, as ``Engine._rebuild_state`` does).

Capture bodies are found structurally (``recompile.capture_bodies``): a
``with torch.cuda.graph(...)`` block, or a function of this file handed
to a graph runner (``ChunkRunner(self._chunk_body, ...)``). Functions that
such a body calls in other modules are not followed.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from .core import Finding, SourceFile, dotted_name, make_finding
from .recompile import RUNNER_CLASSES, capture_bodies


def _self_attr(node: ast.AST) -> Optional[str]:
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _computed(value: Optional[ast.AST]) -> bool:
    """A value the capture computes (a call, arithmetic, an index, a
    conditional), as against a constant or a plain name."""
    return isinstance(value, (ast.Call, ast.BinOp, ast.UnaryOp,
                              ast.Subscript, ast.IfExp))


def check(src: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    bodies = capture_bodies(src)
    for body in bodies:
        _check_stores(src, body, findings)
    _check_rebinds(src, bodies, findings)
    return findings


def _body_name(body: ast.AST) -> str:
    return getattr(body, "name", "torch.cuda.graph block")


def _check_stores(src: SourceFile, body: ast.AST,
                  findings: List[Finding]) -> None:
    escaping: Set[str] = set()
    # locals bound to a value the capture computes: storing one of them
    # is storing the computed value
    made: Set[str] = set()
    for node in ast.walk(body):
        if isinstance(node, (ast.Global, ast.Nonlocal)):
            escaping.update(node.names)
        elif isinstance(node, ast.Assign) and _computed(node.value):
            made.update(t.id for t in node.targets
                        if isinstance(t, ast.Name))
    for node in ast.walk(body):
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets, value = [node.target], node.value
        else:
            continue
        if not (_computed(value) or (isinstance(value, ast.Name)
                                     and value.id in made)):
            continue
        for tgt in targets:
            elts = (tgt.elts if isinstance(tgt, (ast.Tuple, ast.List))
                    else [tgt])
            for e in elts:
                attr = _self_attr(e)
                if attr is not None:
                    findings.append(make_finding(
                        src, "SWL401", e,
                        f"store to `self.{attr}` of a value made inside "
                        f"capture body `{_body_name(body)}` — it lives in "
                        f"the graph's pool and the next replay overwrites "
                        f"it"))
                elif isinstance(e, ast.Name) and e.id in escaping:
                    findings.append(make_finding(
                        src, "SWL401", e,
                        f"store to global/nonlocal `{e.id}` of a value "
                        f"made inside capture body `{_body_name(body)}` — "
                        f"it lives in the graph's pool and the next replay "
                        f"overwrites it"))


def _check_rebinds(src: SourceFile, bodies: List[ast.AST],
                   findings: List[Finding]) -> None:
    # class -> attributes its capture bodies read
    read: Dict[ast.ClassDef, Set[str]] = {}
    for body in bodies:
        cls = src.enclosing_scope(body.lineno, classes_only=True)
        if not isinstance(cls, ast.ClassDef):
            continue
        for node in ast.walk(body):
            attr = _self_attr(node)
            if attr is not None and isinstance(node.ctx, ast.Load):
                read.setdefault(cls, set()).add(attr)
    for cls, attrs in read.items():
        runners = _runner_attrs(cls)
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name == "__init__":
                continue
            stores: List[ast.Attribute] = []
            rebuilds = False
            for node in ast.walk(fn):
                if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                    continue
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for tgt in targets:
                    elts = (tgt.elts if isinstance(tgt, (ast.Tuple,
                                                         ast.List))
                            else [tgt])
                    for e in elts:
                        attr = _self_attr(e)
                        if attr in runners:
                            rebuilds = True
                        elif attr in attrs:
                            stores.append(e)
            if rebuilds:
                continue
            for e in stores:
                findings.append(make_finding(
                    src, "SWL401", e,
                    f"rebinding of `self.{e.attr}`, which a CUDA graph of "
                    f"class `{cls.name}` reads — the graph keeps reading "
                    f"the old storage; copy_ into it, or rebuild the "
                    f"runner in the same method"))


def _runner_attrs(cls: ast.ClassDef) -> Set[str]:
    """Attributes of ``cls`` that hold its graph runner: assigned from a
    runner class, or from a method of the class that returns one."""
    makers: Set[str] = set()
    for fn in cls.body:
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for node in ast.walk(fn):
                if (isinstance(node, ast.Return)
                        and isinstance(node.value, ast.Call)
                        and (dotted_name(node.value.func) or "").split(
                            ".")[-1] in RUNNER_CLASSES):
                    makers.add(fn.name)
    out: Set[str] = set()
    for node in ast.walk(cls):
        if not (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)):
            continue
        name = (dotted_name(node.value.func) or "").split(".")[-1]
        if name in RUNNER_CLASSES or (name in makers and _self_attr(
                node.value.func) is not None):
            for tgt in node.targets:
                attr = _self_attr(tgt)
                if attr is not None:
                    out.add(attr)
    return out
