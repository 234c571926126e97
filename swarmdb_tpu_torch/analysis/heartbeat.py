"""heartbeat-safety checks (SWL601/SWL602/SWL603) for the HA layer.

The failure detector's verdict path (``ha/detector.py``:
``FailureDetector._evaluate``) must be pure arithmetic over monotonic
stamps: a verdict that can stall behind a socket, a sleep, or another
thread's lock reads as a DEAD leader and fires a false-positive
failover — the one bug class an HA layer must not have. The contract is
declared with ``# swarmlint: heartbeat`` on (or directly above) a
``def``, the same marker style as ``hot``, and machine-checked here:

- SWL601: a **blocking call** inside heartbeat code — socket
  construction/IO (``socket.*``, ``.recv``/``.sendall``/``.accept``/
  ``.connect`` and friends), ``time.sleep``, ``open``, ``subprocess.*``,
  ``select.*``, thread ``.join``, or event/condition ``.wait``. Probe
  I/O belongs on the probe thread, never the verdict path.
- SWL602: a **lock acquisition** inside heartbeat code — an explicit
  ``.acquire()`` or a ``with`` over a lock-shaped object (name matching
  lock/cv/cond/mutex/sem, or a ``threading.Lock()``-family constructor).
  A writer holding that lock stalls the verdict; the detector's signal
  stamps are single-writer float slots precisely so evaluation can stay
  lock-free.

The marker propagates into nested defs (a helper defined inside a
heartbeat function runs on the same thread).

SWL603 polices the OTHER half of the fencing contract — the
write path: a function marked ``# swarmlint: ha`` writes to a
replicated partition log under HA leadership, and every broker append
inside it (an ``.append(...)`` call with the topic/partition/value
shape — list-style single-argument appends are ignored) must be
preceded by an epoch-fence check (a call whose name contains
``fence``, e.g. ``_check_fenced`` / ``_check_partition_fence``). An
append that can run before the fence check is how a deposed leader
forks the replicated log — the exact bug class partition-level
fencing exists to make impossible.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional

from .core import Finding, SourceFile, dotted_name, make_finding

#: dotted-call prefixes that are blocking by construction
_BLOCKING_PREFIXES = ("socket.", "subprocess.", "select.", "requests.")
#: exact dotted calls that block
_BLOCKING_CALLS = {"time.sleep", "sleep", "open", "input"}
#: method names that block on whatever object they hang off
_BLOCKING_METHODS = {
    "recv", "recv_into", "recvfrom", "sendall", "accept",
    "connect", "makefile", "join", "wait", "wait_for",
    "create_connection",
}
#: `with <expr>:` targets that look like locks (SWL602)
_LOCKISH_TEXT = re.compile(r"(?:^|[._])(?:r?lock|cv|cond|condition|mutex|"
                           r"sem|semaphore)s?(?:$|[._(])", re.IGNORECASE)
_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore"}


def _is_lockish(expr: ast.AST) -> bool:
    name = dotted_name(expr if not isinstance(expr, ast.Call)
                       else expr.func)
    if name is None:
        try:
            name = ast.unparse(expr)
        except Exception:  # pragma: no cover - malformed expr
            return False
    if name.split(".")[-1] in _LOCK_CTORS:
        return True
    return bool(_LOCKISH_TEXT.search(name))


def _blocking_reason(node: ast.Call) -> Optional[str]:
    name = dotted_name(node.func)
    if name is not None:
        if name in _BLOCKING_CALLS:
            return f"`{name}(...)`"
        if name.startswith(_BLOCKING_PREFIXES):
            return f"`{name}(...)`"
    if isinstance(node.func, ast.Attribute):
        attr = node.func.attr
        if attr in _BLOCKING_METHODS:
            return f"`.{attr}(...)`"
    return None


def _is_partition_append(node: ast.Call) -> bool:
    """Broker-append shape: ``<obj>.append(topic, partition, value,
    ...)`` — at least three positional args (or two plus keywords), so
    ``some_list.append(x)`` never matches."""
    if not (isinstance(node.func, ast.Attribute)
            and node.func.attr == "append"):
        return False
    return (len(node.args) >= 3
            or (len(node.args) >= 2 and bool(node.keywords)))


def _is_fence_check(node: ast.Call) -> bool:
    name = dotted_name(node.func) or ""
    return "fence" in name.split(".")[-1].lower()


def _check_ha_fencing(src: SourceFile, fn: ast.AST,
                      findings: List[Finding]) -> None:
    """SWL603: inside a `# swarmlint: ha` function, every partition-log
    append must run strictly AFTER a fence check."""
    fence_lines = [n.lineno for n in ast.walk(fn)
                   if isinstance(n, ast.Call) and _is_fence_check(n)]
    first_fence = min(fence_lines) if fence_lines else None
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Call) and _is_partition_append(node)):
            continue
        if first_fence is not None and node.lineno > first_fence:
            continue
        findings.append(make_finding(
            src, "SWL603", node,
            f"partition-log append in HA function `{fn.name}` with no "
            f"epoch-fence check before it — call the fence check (e.g. "
            f"`_check_partition_fence(topic, partition)`) first, or a "
            f"deposed leader forks the log"))


def check(src: SourceFile) -> List[Finding]:
    findings: List[Finding] = []

    hb_fns: List[ast.AST] = []
    ha_fns: List[ast.AST] = []

    def visit(node: ast.AST, hb: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                child_hb = hb or src.is_heartbeat(child)
                if child_hb:
                    hb_fns.append(child)
                if src.is_ha(child):
                    ha_fns.append(child)
                visit(child, child_hb)
            else:
                visit(child, hb)

    visit(src.tree, False)

    for fn in ha_fns:
        _check_ha_fencing(src, fn, findings)

    seen = set()
    for fn in hb_fns:
        for node in ast.walk(fn):
            if isinstance(node, ast.With):
                for item in node.items:
                    if _is_lockish(item.context_expr):
                        key = (item.context_expr.lineno,
                               item.context_expr.col_offset, "SWL602")
                        if key in seen:
                            continue
                        seen.add(key)
                        findings.append(make_finding(
                            src, "SWL602", node,
                            f"lock acquisition inside heartbeat function "
                            f"`{fn.name}` — a writer holding it stalls "
                            f"the failure verdict (use single-writer "
                            f"stamps)"))
                continue
            if not isinstance(node, ast.Call):
                continue
            key = (node.lineno, node.col_offset)
            if key in seen:
                continue
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "acquire"):
                seen.add(key)
                findings.append(make_finding(
                    src, "SWL602", node,
                    f"`.acquire()` inside heartbeat function `{fn.name}` "
                    f"— detector evaluation must stay lock-free"))
                continue
            reason = _blocking_reason(node)
            if reason is not None:
                seen.add(key)
                findings.append(make_finding(
                    src, "SWL601", node,
                    f"{reason} can block inside heartbeat function "
                    f"`{fn.name}` — a stalled verdict reads as a dead "
                    f"peer (move I/O to the probe thread)"))
    return findings
