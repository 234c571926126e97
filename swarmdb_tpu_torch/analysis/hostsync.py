"""host-sync checks (SWL101/SWL102/SWL105), taught the card's syncs.

The JAX package's rules (``swarmdb_tpu/analysis/hostsync.py``) know
``jax.device_get``, ``block_until_ready``, ``np.asarray`` and ``.item()``.
On the card a kernel launch returns at once and the host waits only where
it asks to, so the engine's contract is one host wait per decode chunk
(``ChunkOut.host``) and none on the admission path. Every function
annotated hot (``# swarmlint: hot`` or an ``@hot`` decorator) is held to
it:

- SWL101: calls that ARE a host sync — ``torch.cuda.synchronize(...)``
  and ``<x>.synchronize()`` (an ``Event``, a ``Stream``,
  ``torch.cuda.current_stream()``). Flagged unconditionally inside hot
  functions unless the line carries ``# swarmlint: sanctioned-drain``.
- SWL102: host materialization of a *device* value — ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
  ``np.asarray`` / ``np.array`` / ``int()`` / ``float()`` / ``bool()`` of
  it, or an ``if`` / ``while`` / ``assert`` / boolean operand on it (a
  CUDA tensor's truth value waits for the device); a ``sanctioned-drain``
  line covers it as it covers a sync (on the card the read IS the
  sync). Only device-tainted
  operands count: values made by ``torch.*`` factories given a CUDA
  ``device=`` (a ``"cuda..."`` string or ``torch.device("cuda...")``), by
  ``.cuda()`` / ``.to(<cuda device>)``, ``self.<attr>`` declared
  ``# swarmlint: device-state``, and what is computed from them
  (indexing, arithmetic, tensor methods, ``torch.*`` calls over them).
  Shape and dtype reads are host metadata and carry no taint; numpy work
  on host arrays is not flagged.
- SWL105: a host sync lexically inside a ``for`` / ``while`` loop in hot
  code — a per-iteration sync — including an ``Event.query()`` polled in
  a loop (a busy wait). The ``# swarmlint: sanctioned-drain`` marker
  never applies inside a loop.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, SourceFile, dotted_name, make_finding

SYNC_CALLS = {"torch.cuda.synchronize"}
SYNC_METHODS = {"synchronize"}
#: non-blocking alone, a wait when polled in a loop
POLL_METHODS = {"query"}
MATERIALIZE_CALLS = {
    "np.asarray", "np.array", "numpy.asarray", "numpy.array",
    "float", "int", "bool",
}
MATERIALIZE_METHODS = {"item", "tolist", "cpu", "numpy"}
#: tensor attributes and methods that read host metadata, never the data
HOST_META = {"shape", "dtype", "device", "is_cuda", "ndim", "size", "dim",
             "numel", "nelement", "element_size", "data_ptr", "stride",
             "is_contiguous", "get_device", "storage_offset", "nbytes",
             "itemsize", "layout", "requires_grad"}
#: call results that are host values (taint sinks)
HOST_CALLS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array",
              "int", "float", "bool", "len", "list", "tuple", "str"}
#: torch factories that place their result on ``device=``
FACTORIES = {"zeros", "ones", "empty", "full", "arange", "tensor",
             "as_tensor", "rand", "randn", "randint", "zeros_like",
             "ones_like", "empty_like", "full_like", "linspace", "eye"}


def _is_cuda_device(node: Optional[ast.AST]) -> bool:
    """A literal CUDA device: ``"cuda"``, ``"cuda:0"``, or
    ``torch.device("cuda...")``."""
    if node is None:
        return False
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.startswith("cuda")
    if isinstance(node, ast.Call) and dotted_name(node.func) in (
            "torch.device", "device") and node.args:
        return _is_cuda_device(node.args[0])
    return False


def _is_cpu_device(node: Optional[ast.AST]) -> bool:
    if node is None:
        return False
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and dotted_name(node.func) in (
            "torch.device", "device") and node.args:
        return _is_cpu_device(node.args[0])
    return False


def _kw(call: ast.Call, name: str) -> Optional[ast.AST]:
    for k in call.keywords:
        if k.arg == name:
            return k.value
    return None


def _to_target(call: ast.Call) -> Optional[ast.AST]:
    """The device argument of a ``.to(...)`` call, if any."""
    dev = _kw(call, "device")
    if dev is None and call.args:
        dev = call.args[0]
    return dev


def _device_state_of(src: SourceFile) -> Dict[ast.ClassDef, Set[str]]:
    out: Dict[ast.ClassDef, Set[str]] = {}
    for line, names in src.directives.device_state:
        cls = src.enclosing_scope(line, classes_only=True)
        if isinstance(cls, ast.ClassDef):
            out.setdefault(cls, set()).update(names)
    return out


class _Taint:
    """Flow-insensitive per-function taint: names assigned from device
    values are device values; names assigned from host producers are host
    values (host wins — de-tainting is explicit). Iterated to a fixpoint,
    so ``a = self.cache[...]; b = a + 1`` taints ``b``."""

    def __init__(self, fn: ast.AST, device_attrs: Set[str]) -> None:
        self.device: Set[str] = set()
        self.host: Set[str] = set()
        self.device_attrs = device_attrs
        assigns: List[Tuple[List[str], ast.AST]] = []
        for node in ast.walk(fn):
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                if node.value is None:
                    continue
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                names: List[str] = []
                for t in targets:
                    elts = t.elts if isinstance(t, ast.Tuple) else [t]
                    names.extend(e.id for e in elts
                                 if isinstance(e, ast.Name))
                if names:
                    assigns.append((names, node.value))
        for names, value in assigns:
            if self._is_host_producer(value):
                self.host.update(names)
        changed = True
        while changed:
            changed = False
            for names, value in assigns:
                if self.tainted(value):
                    new = set(names) - self.device - self.host
                    if new:
                        self.device |= new
                        changed = True

    @staticmethod
    def _is_host_producer(value: ast.AST) -> bool:
        if not isinstance(value, ast.Call):
            return False
        name = dotted_name(value.func)
        if name in HOST_CALLS or (name or "").startswith(("np.", "numpy.")):
            return True
        if isinstance(value.func, ast.Attribute):
            attr = value.func.attr
            if attr in MATERIALIZE_METHODS or attr in HOST_META:
                return True
            if attr == "to" and _is_cpu_device(_to_target(value)):
                return True
        return False

    def _is_device_producer(self, call: ast.Call) -> bool:
        name = dotted_name(call.func) or ""
        if isinstance(call.func, ast.Attribute):
            attr = call.func.attr
            if attr == "cuda":
                return True
            if attr == "to" and _is_cuda_device(_to_target(call)):
                return True
        if (name.startswith("torch.")
                and name.split(".")[-1] in FACTORIES
                and _is_cuda_device(_kw(call, "device"))):
            return True
        return False

    def tainted(self, expr: ast.AST) -> bool:
        """Is ``expr`` plausibly a device value?"""
        if isinstance(expr, ast.Name):
            if expr.id in self.host:
                return False
            return expr.id in self.device
        if isinstance(expr, ast.Attribute):
            if (isinstance(expr.value, ast.Name)
                    and expr.value.id == "self"):
                return expr.attr in self.device_attrs
            if expr.attr in HOST_META:
                return False
            return self.tainted(expr.value)
        if isinstance(expr, ast.Subscript):
            return self.tainted(expr.value)
        if isinstance(expr, ast.Call):
            if self._is_host_producer(expr):
                return False
            if self._is_device_producer(expr):
                return True
            name = dotted_name(expr.func) or ""
            if isinstance(expr.func, ast.Attribute) and not name.startswith(
                    "torch."):
                # a tensor method on a device value stays on the device
                return self.tainted(expr.func.value)
            if name.startswith("torch.") and not name.startswith(
                    "torch.cuda."):
                return any(self.tainted(a) for a in expr.args) or any(
                    self.tainted(k.value) for k in expr.keywords)
            return False
        if isinstance(expr, ast.BinOp):
            return self.tainted(expr.left) or self.tainted(expr.right)
        if isinstance(expr, ast.UnaryOp):
            return self.tainted(expr.operand)
        if isinstance(expr, ast.Compare):
            if any(isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
                return False  # identity: no data read
            return self.tainted(expr.left) or any(
                self.tainted(c) for c in expr.comparators)
        if isinstance(expr, (ast.Tuple, ast.List)):
            return any(self.tainted(e) for e in expr.elts)
        return False


_SANCTIONED_RE = re.compile(r"#\s*swarmlint:\s*sanctioned-drain\b")


def _sanctioned_lines(src: SourceFile) -> Set[int]:
    """Code lines covered by a ``# swarmlint: sanctioned-drain`` marker:
    the marker's own line (inline form), or — when the marker opens a
    standalone comment block — the first code line after the block."""
    out: Set[int] = set()
    for idx, line in enumerate(src.lines):
        if not _SANCTIONED_RE.search(line):
            continue
        out.add(idx + 1)
        if line.lstrip().startswith("#"):
            j = idx + 1
            while j < len(src.lines):
                stripped = src.lines[j].strip()
                if stripped and not stripped.startswith("#"):
                    out.add(j + 1)
                    break
                j += 1
    return out


def _loop_spans(fn: ast.AST) -> List[Tuple[int, int]]:
    """(first, last) line spans of every loop BODY inside ``fn`` (the
    header line is excluded, so ``for x in y.tolist()`` — a one-time
    pre-loop sync — stays SWL101/102 territory)."""
    spans: List[Tuple[int, int]] = []
    for node in ast.walk(fn):
        if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            body = list(node.body) + list(node.orelse)
            if body:
                last = max(getattr(b, "end_lineno", b.lineno)
                           for b in body)
                spans.append((body[0].lineno, last))
    return spans


def _truth_tests(fn: ast.AST) -> List[ast.AST]:
    """Expressions whose Python truth value is taken: ``if`` / ``while``
    / ternary tests, ``assert`` tests and ``and`` / ``or`` / ``not``
    operands."""
    out: List[ast.AST] = []
    for node in ast.walk(fn):
        if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            out.append(node.test)
        elif isinstance(node, ast.BoolOp):
            out.extend(node.values)
        elif isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            out.append(node.operand)
    return out


def check(src: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    device_state = _device_state_of(src)
    sanctioned = _sanctioned_lines(src)

    # (hot function, enclosing class) pairs, hotness propagated into
    # nested defs
    hot_fns: List[Tuple[ast.AST, Optional[ast.ClassDef]]] = []

    def visit(node: ast.AST, hot: bool, cls: Optional[ast.ClassDef]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, hot, child)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                child_hot = hot or src.is_hot(child)
                if child_hot:
                    hot_fns.append((child, cls))
                visit(child, child_hot, cls)
            else:
                visit(child, hot, cls)

    visit(src.tree, False, None)

    seen: Set[Tuple[int, int]] = set()
    for fn, cls in hot_fns:
        attrs = device_state.get(cls, set()) if cls is not None else set()
        taint = _Taint(fn, attrs)
        loops = _loop_spans(fn)

        def _in_loop(lineno: int) -> bool:
            return any(lo <= lineno <= hi for lo, hi in loops)

        def _sync_finding(node: ast.AST, what: str) -> Optional[Finding]:
            if _in_loop(node.lineno):
                return make_finding(
                    src, "SWL105", node,
                    f"{what} inside a LOOP in hot function `{fn.name}` — "
                    f"a per-iteration host sync; keep the loop on the "
                    f"device (one graph replay per chunk) or wait once "
                    f"outside it")
            if node.lineno in sanctioned:
                return None  # declared per-request drain, straight-line
            return make_finding(
                src, "SWL101", node,
                f"{what} inside hot function `{fn.name}` — every sync "
                f"here serializes the decode pipeline (mark a legitimate "
                f"per-request drain with `# swarmlint: sanctioned-drain`)")

        def _materialize(node: ast.AST, what: str) -> None:
            key = (node.lineno, node.col_offset)
            if key in seen:
                return
            seen.add(key)
            if node.lineno in sanctioned:
                # on the card, reading a device value IS the sync: a
                # declared drain covers it, never inside a loop
                f = _sync_finding(node, what)
                if f is not None:
                    findings.append(f)
                return
            findings.append(make_finding(
                src, "SWL102", node,
                f"{what} on a device value inside hot function "
                f"`{fn.name}` waits for the card and copies to the host"))

        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            key = (node.lineno, node.col_offset)
            if key in seen:
                continue
            name = dotted_name(node.func)
            attr = (node.func.attr if isinstance(node.func, ast.Attribute)
                    else None)
            if name in SYNC_CALLS or (attr in SYNC_METHODS
                                      and name not in SYNC_CALLS):
                seen.add(key)
                what = (f"`{name}`" if name in SYNC_CALLS
                        else "`.synchronize()`")
                f = _sync_finding(node, what)
                if f is not None:
                    findings.append(f)
                continue
            if attr in POLL_METHODS and not node.args and _in_loop(
                    node.lineno):
                seen.add(key)
                f = _sync_finding(node, "`.query()` polled")
                if f is not None:
                    findings.append(f)
                continue
            if (attr in MATERIALIZE_METHODS
                    and taint.tainted(node.func.value)):
                _materialize(node, f"`.{attr}()`")
                continue
            if (attr == "to" and _is_cpu_device(_to_target(node))
                    and taint.tainted(node.func.value)):
                _materialize(node, "`.to('cpu')`")
                continue
            if (name in MATERIALIZE_CALLS and node.args
                    and taint.tainted(node.args[0])):
                _materialize(node, f"`{name}(...)`")
        for test in _truth_tests(fn):
            if taint.tainted(test):
                _materialize(test, "truth value (`if` / `while` / `and` / "
                                   "`or` / `not`)")
    return findings
