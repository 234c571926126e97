"""graph-capture checks (SWL201/SWL203/SWL204): the card's recompile hazards.

The JAX package's recompile family (``swarmdb_tpu/analysis/recompile.py``)
guards XLA compiles. The port compiles its kernels once per process
(``ops/build.py``); what costs a latency cliff on the card is a CUDA graph
capture: each one synchronizes the device, empties the allocator's cache
and holds the device's capture lock (``backend/decode_graphs.py``). The
rule ids are kept, each mapped to its card hazard or declared void:

- SWL201: ``torch.cuda.CUDAGraph()`` or ``torch.cuda.graph(...)`` built
  inside a loop or a hot function — a capture per iteration or per call
  is a whole-device sync each time. Graphs belong to a runner that
  captures a variant once and replays it (``ChunkRunner``).
- SWL202: void on the card. XLA keys a compile on static arguments,
  strings and weak types; eager PyTorch compiles nothing per argument
  value, and a graph is keyed by its sampling variant alone.
- SWL203: in a class that defines ``warmup`` (or ``warmup_call_plan`` /
  ``precompile``), every attribute replayed as a graph — ``.launch(...)``
  on a runner, ``.replay()`` on a ``CUDAGraph`` — must be captured
  (``.capture_all()`` / ``.capture(...)``, or passed to
  ``torch.cuda.graph(...)``) in code reachable from the warmup: a variant
  the warmup misses is captured at its first replay, mid-traffic, and
  every engine on the card waits on the device lock meanwhile (the
  counterpart of the JAX package's warmup call plan).
- SWL204: a tensor allocated inside a capture body (a ``torch.cuda.graph``
  block, or a callable handed to a ``ChunkRunner``) whose shape embeds a
  runtime ``len(...)``: the graph is fixed to the shape it captured, so a
  per-call count becomes a stale buffer size at every later replay.
- SWL205: void on the card. The ragged prefill kernels take the wave
  width as a launch argument; a width read off the descriptors compiles
  no variant (the wave ladder's only job on the card is padding).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from .core import Finding, SourceFile, dotted_name, make_finding

WARMUP_METHODS = ("warmup", "warmup_call_plan", "precompile")
#: names of graph-runner classes: a callable passed to one runs under
#: capture on the card
RUNNER_CLASSES = ("ChunkRunner",)
_ARRAY_CTORS = ("zeros", "ones", "full", "empty", "arange", "rand",
                "randn", "randint")


def _is_graph_ctor(node: ast.Call) -> bool:
    name = dotted_name(node.func) or ""
    return name.endswith("CUDAGraph") or name in ("torch.cuda.graph",
                                                  "cuda.graph")


def check(src: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    findings.extend(_check_graph_sites(src))
    findings.extend(_check_warmup_coverage(src))
    findings.extend(_check_len_shaped_capture(src))
    return findings


# ------------------------------------------------------------------ SWL201

def _check_graph_sites(src: SourceFile) -> List[Finding]:
    findings: List[Finding] = []

    def visit(node: ast.AST, in_loop: bool, hot_fn: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            child_loop = in_loop or isinstance(child, (ast.For, ast.While))
            child_hot = hot_fn
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a nested def inherits hotness; a def inside a loop is
                # re-created per iteration, so keep in_loop
                child_hot = (child.name if (hot_fn or src.is_hot(child))
                             else None)
            if isinstance(child, ast.Call) and _is_graph_ctor(child):
                if child_loop:
                    findings.append(make_finding(
                        src, "SWL201", child,
                        "CUDA graph built inside a loop — a capture per "
                        "iteration synchronizes the device each time; "
                        "capture once and replay"))
                elif child_hot:
                    findings.append(make_finding(
                        src, "SWL201", child,
                        f"CUDA graph built inside hot function "
                        f"`{child_hot}` — a capture per call synchronizes "
                        f"the device; keep the graph in a runner"))
            visit(child, child_loop, child_hot)

    visit(src.tree, False, None)
    return findings


# ------------------------------------------------------------------ SWL203

def _ref_names(node: ast.AST, class_names: Set[str]) -> Set[str]:
    """Names in the class namespace referenced under ``node``:
    ``self.<attr>`` accesses, and bare names that are methods or
    class-level bindings."""
    out: Set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and n.id in class_names:
            out.add(n.id)
        elif (isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
              and n.value.id == "self"):
            out.add(n.attr)
    return out


def _self_attr(node: ast.AST) -> Optional[str]:
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _check_warmup_coverage(src: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    for cls in ast.walk(src.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        methods = {n.name: n for n in cls.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        warm = [methods[m] for m in WARMUP_METHODS if m in methods]
        if not warm:
            continue
        class_names: Set[str] = set(methods)
        # replayed graph attributes: self.X.launch(...) / self.X.replay()
        replayed: Dict[str, ast.AST] = {}
        for node in ast.walk(cls):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("launch", "replay")):
                attr = _self_attr(node.func.value)
                if attr is not None and attr not in replayed:
                    replayed[attr] = node
        if not replayed:
            continue
        method_refs = {name: _ref_names(fn, class_names)
                       for name, fn in methods.items()}
        reachable: Set[str] = set()
        frontier: Set[str] = set(m.name for m in warm)
        while frontier:
            new: Set[str] = set()
            for name in frontier:
                if name in reachable:
                    continue
                reachable.add(name)
                new |= method_refs.get(name, set())
            frontier = new - reachable
        captured: Set[str] = set()
        for name in reachable:
            fn = methods.get(name)
            if fn is None:
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr in ("capture", "capture_all")):
                    attr = _self_attr(node.func.value)
                    if attr is not None:
                        captured.add(attr)
                elif _is_graph_ctor(node) and node.args:
                    attr = _self_attr(node.args[0])
                    if attr is not None:
                        captured.add(attr)
        for attr, node in sorted(replayed.items()):
            if attr not in captured:
                findings.append(make_finding(
                    src, "SWL203", node,
                    f"graph `{attr}` of class `{cls.name}` is replayed but "
                    f"not captured from its warmup — the first "
                    f"serving-path replay pays a capture (a device sync) "
                    f"mid-traffic"))
    return findings


# ------------------------------------------------------------------ SWL204

def capture_bodies(src: SourceFile) -> List[ast.AST]:
    """Code that runs under a CUDA graph capture: the bodies of
    ``with torch.cuda.graph(...)`` blocks (the ``With`` node), and the
    functions of this file handed to a graph runner
    (``ChunkRunner(self._chunk_body, ...)`` names ``_chunk_body``)."""
    bodies: List[ast.AST] = []
    runner_fns: Set[str] = set()
    for node in ast.walk(src.tree):
        if isinstance(node, ast.With) and any(
                isinstance(it.context_expr, ast.Call)
                and _is_graph_ctor(it.context_expr)
                for it in node.items):
            bodies.append(node)
        elif isinstance(node, ast.Call) and node.args:
            name = dotted_name(node.func) or ""
            if name.split(".")[-1] in RUNNER_CLASSES:
                arg = node.args[0]
                ref = _self_attr(arg) or (arg.id if isinstance(
                    arg, ast.Name) else None)
                if ref:
                    runner_fns.add(ref)
    for node in ast.walk(src.tree):
        if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node.name in runner_fns):
            bodies.append(node)
    return bodies


def _shape_has_len(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Call) and dotted_name(n.func) == "len"
               for n in ast.walk(node))


def _check_len_shaped_capture(src: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    seen: Set[int] = set()
    for body in capture_bodies(src):
        for node in ast.walk(body):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            name = dotted_name(node.func) or ""
            if not (name.startswith("torch.")
                    and name.split(".")[-1] in _ARRAY_CTORS):
                continue
            if not any(_shape_has_len(a) for a in node.args):
                continue
            if id(node) in seen:
                continue
            seen.add(id(node))
            findings.append(make_finding(
                src, "SWL204", node,
                "tensor shaped by a runtime len() inside a capture body — "
                "the graph keeps the captured shape at every replay; size "
                "the buffer once, outside the capture"))
    return findings
