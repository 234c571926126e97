"""retry-discipline checks (SWL701) for marked retry loops.

The lane supervisor (``backend/supervisor.py``) re-admits quarantined
lanes and requeues lost requests — fallible work retried in loops. An
undisciplined retry loop is the classic outage amplifier: no bound turns
one failure into a storm, no backoff hammers the recovering dependency,
no deadline turns a hung dependency into a hung caller. The contract is
declared with ``# swarmlint: retry`` on (or directly above) a ``def``
(same marker style as ``hot``/``heartbeat``) and machine-checked here:
every loop inside a marked function must show all three of

- a **bound** — the loop condition compares against something (``while
  attempts < n``), the loop is a ``for`` over a finite iterable, or the
  body breaks/returns under a budget-shaped comparison (a name matching
  attempt/retry/tries/budget/left/remaining). Bare ``while True`` with
  none of these is unbounded.
- a **backoff** — a ``time.sleep``/``.wait(...)`` call or a
  ``threading.Timer`` construction inside the body: retries must yield
  between attempts.
- a **deadline check** — a comparison involving a deadline-shaped name
  (deadline/expires/timeout/until/cutoff) or a monotonic/wall clock
  read (``time.monotonic()``/``time.time()``) in the loop's test or
  body: a bounded count of unbounded waits is still unbounded.

The marker propagates into nested defs (a helper defined inside a retry
function runs the same retry loop).
"""

from __future__ import annotations

import ast
import re
from typing import List

from .core import Finding, SourceFile, dotted_name, make_finding

_BUDGET_NAME = re.compile(
    r"\b(?:attempts?|retr(?:y|ies|ied)\w*|tries|budget|(?:\w+_)?left|"
    r"remaining|probes?|clean_\w+)\b", re.IGNORECASE)
_DEADLINE_NAME = re.compile(
    r"\b(?:deadline\w*|expires?(?:_at)?|timeout\w*|until|cutoff)\b",
    re.IGNORECASE)
_CLOCK_CALLS = {"time.monotonic", "time.time", "monotonic",
                "time.monotonic_ns"}
_SLEEP_CALLS = {"time.sleep", "sleep"}
_SLEEP_METHODS = {"wait", "wait_for"}
_TIMER_CTORS = {"Timer"}
_UNBOUNDED_ITERS = {"itertools.count", "count", "iter", "cycle",
                    "itertools.cycle"}


def _expr_text(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - malformed expr
        return ""


def _is_const_true(test: ast.AST) -> bool:
    return isinstance(test, ast.Constant) and bool(test.value)


def _compares(node: ast.AST) -> List[ast.Compare]:
    return [n for n in ast.walk(node) if isinstance(n, ast.Compare)]


def _has_budget_compare(node: ast.AST) -> bool:
    return any(_BUDGET_NAME.search(_expr_text(cmp))
               for cmp in _compares(node))


def _has_deadline_check(node: ast.AST) -> bool:
    for cmp in _compares(node):
        text = _expr_text(cmp)
        if _DEADLINE_NAME.search(text):
            return True
        for call in (n for n in ast.walk(cmp) if isinstance(n, ast.Call)):
            if (dotted_name(call.func) or "") in _CLOCK_CALLS:
                return True
    return False


def _has_backoff(body: List[ast.stmt]) -> bool:
    for stmt in body:
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name in _SLEEP_CALLS:
                return True
            if name and name.split(".")[-1] in _TIMER_CTORS:
                return True
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _SLEEP_METHODS):
                return True
    return False


def _loop_bounded(loop: ast.AST) -> bool:
    if isinstance(loop, (ast.For, ast.AsyncFor)):
        name = dotted_name(loop.iter) if isinstance(
            loop.iter, (ast.Call, ast.Name, ast.Attribute)) else None
        return name not in _UNBOUNDED_ITERS
    # while: a comparing condition bounds it; else look for a
    # budget-shaped comparison guarding a break/return/raise in the body
    assert isinstance(loop, ast.While)
    if not _is_const_true(loop.test) and _compares(loop.test):
        return True
    for node in ast.walk(loop):
        if isinstance(node, ast.If) and _has_budget_compare(node.test):
            for inner in ast.walk(node):
                if isinstance(inner, (ast.Break, ast.Return, ast.Raise)):
                    return True
    return False


def check(src: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    retry_fns: List[ast.AST] = []

    def visit(node: ast.AST, marked: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                child_marked = marked or src.is_retry(child)
                if child_marked:
                    retry_fns.append(child)
                visit(child, child_marked)
            else:
                visit(child, marked)

    visit(src.tree, False)

    seen = set()
    for fn in retry_fns:
        for loop in ast.walk(fn):
            if not isinstance(loop, (ast.While, ast.For, ast.AsyncFor)):
                continue
            key = (loop.lineno, loop.col_offset)
            if key in seen:
                continue
            seen.add(key)
            missing: List[str] = []
            if not _loop_bounded(loop):
                missing.append("bound")
            if not _has_backoff(loop.body):
                missing.append("backoff")
            if not _has_deadline_check(loop):
                missing.append("deadline check")
            if missing:
                findings.append(make_finding(
                    src, "SWL701", loop,
                    f"retry loop in `{fn.name}` has no "
                    f"{', no '.join(missing)} — bound the attempts, "
                    f"sleep between them, and stop at the deadline"))
    return findings
