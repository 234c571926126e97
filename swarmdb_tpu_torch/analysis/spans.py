"""span-discipline checks (SWL501/SWL502) for the obs tracer.

The tracer (swarmdb_tpu/obs/tracer.py) has two record APIs with a
contract the type system cannot enforce:

- ``span_begin()`` returns a monotonic stamp that only becomes a span
  when some ``span_end(stamp, ...)`` consumes it. A function that calls
  ``span_begin`` but never ``span_end`` records NOTHING — the span is
  silently dropped, which is the observability equivalent of a swallowed
  exception (SWL501). Likewise a bare ``span_begin()`` expression whose
  stamp is discarded can never be ended. ``span_end`` without a local
  ``span_begin`` is fine: closing against an externally carried stamp
  (e.g. the engine's dispatch stamp) is the intended hot-path pattern.
- ``span(...)`` is an allocating context manager for warm paths. Inside
  a ``# swarmlint: hot`` function the only sanctioned record forms are
  the allocation-free ring writes (``span_begin``/``span_end``/
  ``span_at``/``instant``); a ``.span(...)`` context manager there
  allocates an object + frame per call on the decode path (SWL502).
- Histograms (``obs/metrics.py`` and ``utils/metrics.py``) have the
  same discipline: ``observe()`` is allocation-free only when the
  histogram object was bound ONCE. A per-call registry/dict lookup
  (``registry.get("x").observe(v)``, ``self.latencies["x"].observe``
  — a defaultdict that ALLOCATES a histogram on a miss) or a per-call
  ``Histogram(...)`` construction inside ``# swarmlint: hot`` code
  puts a hash lookup/allocation on the decode path (SWL503).
- Exemplar retention and the SLO sentinel's tick are record
  paths with an even stricter contract: the per-observation work is an
  in-place SLOT WRITE into preallocated parallel lists. Inside
  ``# swarmlint: hot`` code that belongs to exemplar/sentinel classes
  (``Histogram``/``*Sentinel*``, or any function touching
  ``exemplar``/``_ex_`` attributes), building a dict/list/set/str —
  displays, comprehensions, f-strings, ``dict()``/``list()``/
  ``str()``/``.format()`` calls — per observation is SWL504. The
  engine's hot step records (``_flight_step``) legitimately build one
  dict per STEP, so the rule is scoped to the per-observation exemplar
  and sentinel paths rather than every hot function.

- swarmmem's record hooks have the tightest contract of
  all: they run INSIDE locks the allocator/prefix cache already hold
  (that is the whole overhead story), so inside ``# swarmlint: hot``
  methods of the memory-accountant ledger classes (``MemPool``/
  ``PrefixProbe``/``ConvLedger``/``ReuseSampler``) ANY per-access
  allocation — displays, comprehensions, f-strings, ``dict()``/
  ``list()``/``set()``/``str()`` calls — is SWL507: the record path
  must stay int adds and slot writes, or every page grant pays an
  allocator while a pool lock is held.

- swarmprof's cost harvest is a compile-time activity with a
  compile-time cost: ``fn.lower(*specs)`` re-traces the function and
  ``cost_analysis()`` runs the XLA cost model — tens of milliseconds to
  seconds per variant. Inside ``# swarmlint: hot`` code either call is
  SWL506: harvest belongs in warmup (``Engine.profile_harvest``), never
  on a dispatch path. ``.lower()`` with NO arguments is the string
  method and exempt; the jax lowering always takes the arg specs.

``__enter__``/``__exit__`` pairs are exempt from SWL501 — the context-
manager protocol balances them across two methods by design.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional

from .core import Finding, SourceFile, dotted_name, make_finding

_BALANCE_EXEMPT = {"__enter__", "__exit__"}


def _own_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """Walk a function's body WITHOUT descending into nested defs (each
    function's span discipline is judged on its own scope — a nested
    callback that ends a span does not balance its parent)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _is_call_to(node: ast.AST, method: str) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func)
    return bool(name) and name.split(".")[-1] == method


#: histogram types whose construction in a hot function is SWL503
_HIST_TYPES = {"Histogram", "LatencyHistogram"}

#: builtins whose call in hot exemplar/sentinel code allocates (SWL504)
_ALLOC_BUILTINS = {"dict", "list", "set", "str"}

#: allocation-expression nodes for SWL504 (displays + comprehensions +
#: f-strings; GeneratorExp excluded — lazily evaluated, not a container)
_ALLOC_NODES = (ast.Dict, ast.List, ast.Set, ast.ListComp, ast.SetComp,
                ast.DictComp, ast.JoinedStr)


def _exemplar_scope(src: SourceFile, fn: ast.AST) -> bool:
    """True when a hot function is exemplar/sentinel record-path code:
    a method of a ``Histogram``/``*Sentinel*`` class, or any function
    touching ``exemplar``/``_ex_`` attributes. Scopes SWL504 so the
    engine's legitimate one-dict-per-step hot records stay clean."""
    cls = src.enclosing_scope(fn.lineno, classes_only=True)
    if cls is not None and ("Sentinel" in cls.name
                            or "Histogram" in cls.name):
        return True
    for node in _own_nodes(fn):
        if isinstance(node, ast.Attribute) and (
                "exemplar" in node.attr or node.attr.startswith("_ex_")):
            return True
    return False


#: memory-accountant ledger classes whose hot record methods must stay
#: allocation-free (SWL507) — they run under the owner's pool/cache lock
_MEMPROF_CLASSES = ("MemPool", "PrefixProbe", "ConvLedger", "ReuseSampler")


def _memprof_scope(src: SourceFile, fn: ast.AST) -> bool:
    """True when a hot function is memory-accountant record-path code: a
    method of one of the memprof ledger classes. Scopes SWL507 the way
    ``_exemplar_scope`` scopes SWL504 — the engine's own hot functions
    may legitimately build one record per step; a ledger hook that runs
    under the allocator's lock may not allocate at all."""
    cls = src.enclosing_scope(fn.lineno, classes_only=True)
    return cls is not None and any(tag in cls.name
                                   for tag in _MEMPROF_CLASSES)


def _alloc_desc(node: ast.AST) -> Optional[str]:
    """Human name of the allocation ``node`` performs, or None."""
    if isinstance(node, _ALLOC_NODES):
        return {ast.Dict: "dict display", ast.List: "list display",
                ast.Set: "set display", ast.ListComp: "list comprehension",
                ast.SetComp: "set comprehension",
                ast.DictComp: "dict comprehension",
                ast.JoinedStr: "f-string"}[type(node)]
    if isinstance(node, ast.Call):
        name = dotted_name(node.func)
        if name in _ALLOC_BUILTINS:
            return f"{name}() call"
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr == "format":
            return ".format() call"
    return None


def _dynamic_receiver(node: ast.AST) -> bool:
    """True when the expression contains a Subscript or Call — i.e. the
    histogram is looked up (or allocated, for defaultdict registries)
    per observation instead of being a pre-bound name/attribute."""
    for sub in ast.walk(node):
        if isinstance(sub, (ast.Subscript, ast.Call)):
            return True
    return False


def check(src: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    for fn in ast.walk(src.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        begins: List[ast.Call] = []
        ends = 0
        for node in _own_nodes(fn):
            if _is_call_to(node, "span_begin"):
                begins.append(node)  # type: ignore[arg-type]
            elif _is_call_to(node, "span_end"):
                ends += 1
            if (isinstance(node, ast.Expr)
                    and _is_call_to(node.value, "span_begin")):
                # stamp discarded on the spot — unendable
                findings.append(make_finding(
                    src, "SWL501", node,
                    "span_begin() stamp discarded — the span can never "
                    "be recorded (bind it and pass to span_end)"))
            if (src.is_hot(fn) and isinstance(node, ast.Call)
                    and _is_call_to(node, "span")):
                findings.append(make_finding(
                    src, "SWL502", node,
                    f"allocating span(...) context manager inside "
                    f"hot-path function `{fn.name}` — use the "
                    f"span_begin/span_end ring writes"))
            if src.is_hot(fn) and isinstance(node, ast.Call):
                name = dotted_name(node.func)
                if (name and name.split(".")[-1] in _HIST_TYPES):
                    findings.append(make_finding(
                        src, "SWL503", node,
                        f"histogram constructed inside hot-path "
                        f"function `{fn.name}` — construct at init and "
                        f"bind the object"))
                elif (isinstance(node.func, ast.Attribute)
                        and node.func.attr == "observe"
                        and _dynamic_receiver(node.func.value)):
                    findings.append(make_finding(
                        src, "SWL503", node,
                        f"per-call histogram lookup "
                        f"(`{ast.unparse(node.func.value)}`) before "
                        f".observe() inside hot-path function "
                        f"`{fn.name}` — a registry/dict lookup (or a "
                        f"defaultdict allocation) per observation; "
                        f"bind the histogram once"))
        if src.is_hot(fn):
            for node in _own_nodes(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = dotted_name(node.func)
                leaf = name.split(".")[-1] if name else ""
                if leaf == "cost_analysis":
                    findings.append(make_finding(
                        src, "SWL506", node,
                        f"cost_analysis() inside hot-path function "
                        f"`{fn.name}` — the XLA cost model runs at "
                        f"compile speed; harvest belongs in warmup "
                        f"(Engine.profile_harvest)"))
                elif (leaf == "lower"
                        and isinstance(node.func, ast.Attribute)
                        and (node.args or node.keywords)):
                    # str.lower() takes no args; jax lowering takes the
                    # arg specs — only the argful form is a re-trace
                    findings.append(make_finding(
                        src, "SWL506", node,
                        f"lower(...) inside hot-path function "
                        f"`{fn.name}` — lowering re-traces the jitted "
                        f"function per call; compile-time introspection "
                        f"belongs in warmup/precompile"))
        if src.is_hot(fn) and _exemplar_scope(src, fn):
            for node in _own_nodes(fn):
                desc = _alloc_desc(node)
                if desc is not None:
                    findings.append(make_finding(
                        src, "SWL504", node,
                        f"per-observation allocation ({desc}) inside "
                        f"hot exemplar/sentinel function `{fn.name}` — "
                        f"retention must be an in-place slot write into "
                        f"preallocated lists"))
        if src.is_hot(fn) and _memprof_scope(src, fn):
            for node in _own_nodes(fn):
                desc = _alloc_desc(node)
                if desc is not None:
                    findings.append(make_finding(
                        src, "SWL507", node,
                        f"per-access allocation ({desc}) inside hot "
                        f"memory-accountant function `{fn.name}` — the "
                        f"memprof record path runs under the allocator/"
                        f"cache lock and must stay int adds and slot "
                        f"writes"))
        if (begins and ends == 0
                and fn.name not in _BALANCE_EXEMPT):
            findings.append(make_finding(
                src, "SWL501", begins[0],
                f"`{fn.name}` calls span_begin but never span_end — "
                f"the span is begun and silently dropped"))
    return findings
