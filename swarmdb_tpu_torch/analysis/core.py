"""swarmlint core: source model, directives, findings, baseline.

The port's copy of ``swarmdb_tpu/analysis/core.py``. Everything here is
stdlib-only (``ast`` + ``tokenize``): the linter reads the port's source
and imports neither PyTorch nor the code it checks. The check families
live in sibling modules (hostsync, recompile, locks, tracers, kernelcheck
and the rest); this module owns what they share:

- :class:`SourceFile` — parsed tree + the comment **directives** that carry
  the repo's annotations (see below).
- :class:`Finding` — one diagnostic, with a content-addressed fingerprint
  (rule + path + enclosing scope + normalized source line) so the committed
  baseline survives unrelated line-number churn.
- baseline load/diff/update — CI fails only on findings whose fingerprint
  is not in ``swarmdb_tpu_torch/analysis/baseline.json`` (resolved
  against this package's directory, so the answer does not depend on the
  working directory).

Directive grammar (comments beginning ``# swarmlint:``):

``# swarmlint: hot``
    On (or directly above) a ``def``: the function is a hot-path function —
    host syncs inside it are findings (hostsync.py). An identity decorator
    named ``hot`` works too.
``# swarmlint: heartbeat``
    On (or directly above) a ``def``: the function runs on a failure
    detector's evaluation path — blocking I/O and lock acquisition inside
    it are findings (heartbeat.py, SWL601/SWL602): a detector that can
    stall turns a healthy leader into a "dead" one.
``# swarmlint: retry``
    On (or directly above) a ``def``: the function retries fallible work —
    every loop inside it must carry a bound, a backoff, and a deadline
    check (retry.py, SWL701): an undisciplined retry loop turns one
    failure into a retry storm.
``# swarmlint: ha``
    On (or directly above) a ``def``: the function writes to a replicated
    partition log under HA leadership — every broker append inside it
    must be preceded by an epoch-fence check (heartbeat.py, SWL603): an
    unfenced append is how a deposed leader forks the log.
``# swarmlint: disable=<rule>[,<rule>] [-- reason]``
    Suppress the named rules (ids like ``SWL101`` or family names like
    ``host-sync``) on this line, or — when the comment is a standalone
    comment line — on the next line. Bare ``disable`` suppresses all.
``# swarmlint: guarded-by[<guard>]: <name>[, <name>]``
    Lock-discipline declaration (locks.py): the listed attributes/locals
    may only be read or written inside ``with <guard>:``. A guard spelled
    ``self.X`` attaches the declaration to the enclosing *class* (names are
    ``self.<name>`` attributes); a bare name attaches it to the enclosing
    function (names are locals — nested ``def``s inherit the declaration
    but NOT any held lock, matching thread reality).
``# swarmlint: holds[<guard>]``
    On (or directly above) a ``def``: this function's calling contract is
    that the guard is already held (RLock helper methods) — its body is
    checked as if inside ``with <guard>:``. The contract claim is on the
    author; the checker polices everything past it.
``# swarmlint: device-state: <name>[, <name>]``
    Class-level taint declaration (hostsync.py): ``self.<name>`` holds
    device arrays, so host-materializing it in a hot function is a finding.
``# swarmlint: sanctioned-drain [-- reason]``
    On (or directly above) a host-sync call in hot code: this is a
    declared per-REQUEST drain (the engine's one session/chunk sync), so
    SWL101 stays quiet. Never applies inside a loop — a sync you loop
    over is a per-iteration sync and stays an SWL105 finding (hostsync.py).
``# swarmlint: owns[page]: <name>[, <name>]``
    Page-ownership transfer declaration (pagelife.py, SWL801-805): on
    (or directly above) a ``def``, the listed PARAMETERS receive
    ownership of the page handles passed in — the caller is discharged
    (and must not use the handle again: a later use is SWL802), and the
    callee body is responsible for freeing/escaping them. The special
    name ``return`` declares the function's return value an OWNED page
    handle (wrappers around allocator calls propagate producer-ness
    automatically; the directive covers the shapes inference can't see).
``# swarmlint: borrows[page]: <name>[, <name>]``
    The dual: the listed parameters only BORROW the handle — a call
    does NOT discharge the caller's ownership (the default for an
    unresolvable call is the conservative "escaped"), so the caller
    must still free/escape the handle on every path.
``# swarmlint: revisit[<dim>[, <dim>]] [-- reason]``
    Kernel-layer declaration of the JAX package (SWL902 over a
    ``pl.pallas_call``). The grammar keeps it so that annotations carry
    over word for word; nothing in the port's rules reads it (SWL902 has
    no CUDA counterpart, kernelcheck.py).
"""

from __future__ import annotations

import ast
import hashlib
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

DIRECTIVE_RE = re.compile(r"#\s*swarmlint:\s*(.*)$")


@dataclass(frozen=True)
class Rule:
    id: str
    family: str
    summary: str


RULES: Dict[str, Rule] = {
    r.id: r
    for r in (
        Rule("SWL101", "host-sync",
             "explicit host sync (torch.cuda.synchronize / Event."
             "synchronize / Stream.synchronize) in a hot-path function"),
        Rule("SWL102", "host-sync",
             "host materialization of a device value (.item() / .tolist() "
             "/ .cpu() / .numpy() / .to('cpu') / np.asarray / int() / "
             "float() / bool() / if) in a hot-path function"),
        Rule("SWL105", "host-sync",
             "host sync (synchronize(), or Event.query() polled) inside a "
             "LOOP in hot-path code — a per-iteration sync serializes the "
             "device pipeline; the `# swarmlint: sanctioned-drain` marker "
             "only sanctions straight-line per-request drains, never "
             "loops"),
        Rule("SWL201", "graph-capture",
             "torch.cuda.CUDAGraph() / torch.cuda.graph(...) built inside "
             "a loop or hot function — every capture synchronizes the "
             "whole device"),
        Rule("SWL202", "graph-capture",
             "not applicable on the card: eager PyTorch compiles nothing "
             "per argument value, and a graph is keyed by its sampling "
             "variant alone (coverage is SWL203)"),
        Rule("SWL203", "graph-capture",
             "graph runner (or CUDAGraph) that a class with `warmup` "
             "replays but never captures from its warmup — the first "
             "serving-path call pays a capture mid-traffic"),
        Rule("SWL204", "graph-capture",
             "len()-shaped tensor allocated inside a capture body — a "
             "graph is fixed to the shapes it captured, so a per-call "
             "count becomes a stale buffer size at replay"),
        Rule("SWL205", "graph-capture",
             "not applicable on the card: the CUDA kernels take the wave "
             "width as an argument, so descriptor-shaped widths compile "
             "no variant"),
        Rule("SWL301", "lock-discipline",
             "guarded attribute accessed outside a `with` on its declared "
             "lock/Condition"),
        Rule("SWL302", "lock-discipline",
             "lock-order inversion: two locks acquired in both orders "
             "(directly or through the call graph) — a cycle in the "
             "acquisition-order graph deadlocks under concurrency"),
        Rule("SWL303", "lock-discipline",
             "inferred guarded-by violation: a field accessed under one "
             "lock at most sites is read/written without it elsewhere "
             "(no annotation needed — the majority of sites IS the "
             "declaration)"),
        Rule("SWL304", "lock-discipline",
             "blocking while holding: Condition.wait outside a while-"
             "predicate loop, or a blocking call (socket/join/file/"
             "device_get/sleep) made while a lock is held in hot code"),
        Rule("SWL305", "lock-discipline",
             "stored hook/callback attribute invoked while holding a "
             "lock — re-entrant callbacks can re-acquire (deadlock) or "
             "observe half-updated state"),
        Rule("SWL401", "capture-leak",
             "store to self/global/nonlocal of a tensor made inside a "
             "function run under a CUDA graph capture (it lives in the "
             "graph's private pool and the next replay overwrites it), or "
             "a rebinding of an attribute a capture reads (the graph keeps "
             "reading the old storage: copy_ into it instead)"),
        Rule("SWL501", "span-discipline",
             "span_begin without any span_end in the function (or a "
             "discarded span_begin stamp) — the span is silently dropped"),
        Rule("SWL502", "span-discipline",
             "allocating span(...) context manager inside a hot-path "
             "function — use the span_begin/span_end ring writes"),
        Rule("SWL503", "span-discipline",
             "histogram allocated or looked up per observation inside a "
             "hot-path function — bind it once and observe through the "
             "bound object"),
        Rule("SWL504", "span-discipline",
             "per-observation allocation (dict/list/set/str "
             "construction, comprehension, f-string) in hot exemplar/"
             "sentinel record-path code — exemplar retention must be an "
             "in-place slot write"),
        Rule("SWL506", "span-discipline",
             "compile-time introspection (cost_analysis()/argful "
             "lower()) inside a hot-path function — the swarmprof cost "
             "harvest belongs in warmup, never on a dispatch path"),
        Rule("SWL507", "span-discipline",
             "per-access allocation (container display, comprehension, "
             "f-string, dict()/list()/set()/str() construction) in hot "
             "memory-accountant record-path code — the memprof hooks "
             "piggyback on locks the allocator/prefix cache already "
             "hold, so their record path must stay int adds and slot "
             "writes"),
        Rule("SWL601", "heartbeat-safety",
             "blocking call inside `# swarmlint: heartbeat` code — a "
             "stalled failure-detector evaluation reads as a dead peer "
             "(false-positive failover)"),
        Rule("SWL602", "heartbeat-safety",
             "lock acquisition inside `# swarmlint: heartbeat` code — "
             "detector evaluation must stay lock-free (a writer holding "
             "the lock stalls the verdict)"),
        Rule("SWL603", "heartbeat-safety",
             "partition-log append inside `# swarmlint: ha` code with no "
             "epoch-fence check before the write — a deposed leader's "
             "unfenced append forks the replicated log"),
        Rule("SWL701", "retry-discipline",
             "retry loop in `# swarmlint: retry` code with no bound, no "
             "backoff, or no deadline check — an undisciplined retry "
             "loop turns one failure into a retry storm (and a hung "
             "dependency into a hung caller)"),
        Rule("SWL801", "page-lifetime",
             "page-handle leak: pages taken from the allocator/prefix "
             "cache escape the function (return/raise/fall-through, "
             "including exception paths across raising calls) without "
             "reaching a free/registration/custody transfer"),
        Rule("SWL802", "page-lifetime",
             "page use-after-free: a handle flows into a page-table "
             "write, dispatch descriptor, or any read after a path "
             "that already freed it — the pages may belong to another "
             "conversation by the time the write lands"),
        Rule("SWL803", "page-lifetime",
             "page double-free: a handle reaches a free sink twice on "
             "one path — the second free forks custody and two future "
             "allocations will alias the same pages"),
        Rule("SWL804", "page-lifetime",
             "pin-discipline: pages pinned via PrefixLRU.pin/"
             "match_and_pin must be unpinned, released, or handed off "
             "on every path out — a leaked pin drifts evictable_count, "
             "which the pool backpressure gate trusts"),
        Rule("SWL805", "page-lifetime",
             "page-table write before allocation: a handle reaches a "
             "table write before the allocator call that produces it "
             "on this path — the row blesses page ids the pool has "
             "not granted"),
        Rule("SWL901", "kernel-check",
             "not applicable on the card: parses pl.pallas_call index "
             "maps; the CUDA kernels' bounds are the checked build's "
             "(SWARMDB_KERNCHECK, obs/kerncheck.py)"),
        Rule("SWL902", "kernel-check",
             "not applicable on the card: parses pl.pallas_call output "
             "block maps; a CUDA block writes what its own code indexes"),
        Rule("SWL903", "kernel-check",
             "shared memory per block of a CUDA kernel, at a registry "
             "model's dims and the dtypes the engines launch, over the "
             "card's opt-in limit per block — the launch is refused"),
        Rule("SWL904", "kernel-check",
             "not applicable on the card: TPU sublane x lane tiling of "
             "Pallas blocks has no CUDA counterpart"),
        Rule("SWL905", "kernel-check",
             "not applicable on the card: parses pl.pallas_call output "
             "refs; the kernels' coverage is the sanitizer's canary"),
    )
}

FAMILIES: Dict[str, Set[str]] = {}
for _r in RULES.values():
    FAMILIES.setdefault(_r.family, set()).add(_r.id)


def expand_rule_names(names: Iterable[str]) -> Set[str]:
    """Map a mix of rule ids and family names to a set of rule ids."""
    out: Set[str] = set()
    for n in names:
        n = n.strip()
        if not n:
            continue
        if n in RULES:
            out.add(n)
        elif n in FAMILIES:
            out.update(FAMILIES[n])
        else:
            raise KeyError(f"unknown swarmlint rule or family: {n!r}")
    return out


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str
    scope: str = "<module>"
    fingerprint: str = ""

    @property
    def family(self) -> str:
        return RULES[self.rule].family

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"[{self.family}] {self.message} (in {self.scope})")

    def to_json(self) -> Dict[str, object]:
        return {
            "rule": self.rule,
            "family": self.family,
            "path": self.path,
            "line": self.line,
            "scope": self.scope,
            "message": self.message,
            "fingerprint": self.fingerprint,
        }


@dataclass
class GuardDecl:
    line: int
    guard: str           # unparse-normalized guard expression text
    names: Tuple[str, ...]


@dataclass
class Directives:
    hot_lines: Set[int] = field(default_factory=set)
    heartbeat_lines: Set[int] = field(default_factory=set)
    retry_lines: Set[int] = field(default_factory=set)
    ha_lines: Set[int] = field(default_factory=set)
    # line -> None (suppress all) or set of rule ids
    disables: Dict[int, Optional[Set[str]]] = field(default_factory=dict)
    comment_only_lines: Set[int] = field(default_factory=set)
    guards: List[GuardDecl] = field(default_factory=list)
    holds: Dict[int, str] = field(default_factory=dict)  # line -> guard
    device_state: List[Tuple[int, Tuple[str, ...]]] = field(
        default_factory=list)
    # lines carrying `# swarmlint: sanctioned-drain` (hostsync SWL101/105)
    sanctioned_drains: Set[int] = field(default_factory=set)
    # page-ownership transfer at call boundaries (pagelife SWL801-805):
    # line -> parameter names (or "return") taking/borrowing ownership
    page_owns: Dict[int, Tuple[str, ...]] = field(default_factory=dict)
    page_borrows: Dict[int, Tuple[str, ...]] = field(default_factory=dict)
    # sanctioned output-block revisits (kernelcheck SWL902): line ->
    # grid dims (axis indices or index-map parameter names)
    revisits: Dict[int, Tuple[str, ...]] = field(default_factory=dict)


def _parse_directive(body: str, line: int, out: Directives) -> None:
    body = body.strip()
    if body == "hot" or body.startswith("hot "):
        out.hot_lines.add(line)
        return
    if body == "sanctioned-drain" or body.startswith("sanctioned-drain"):
        # declared per-request drain (hostsync SWL101/SWL105): consumed
        # by the hostsync checker via its own line scan; registered here
        # so the directive is part of the grammar, not an unknown
        out.sanctioned_drains.add(line)
        return
    if body == "heartbeat" or body.startswith("heartbeat "):
        out.heartbeat_lines.add(line)
        return
    if body == "retry" or body.startswith("retry "):
        out.retry_lines.add(line)
        return
    if body == "ha" or body.startswith("ha "):
        out.ha_lines.add(line)
        return
    if body.startswith("disable"):
        rest = body[len("disable"):]
        # strip an optional trailing free-text reason after '--'
        rest = rest.split("--", 1)[0].strip()
        if rest.startswith("="):
            names = [n for n in rest[1:].split(",") if n.strip()]
            try:
                out.disables[line] = expand_rule_names(names)
            except KeyError as exc:
                raise SyntaxError(
                    f"line {line}: {exc.args[0]}") from None
        else:
            out.disables[line] = None  # suppress everything
        return
    m = re.match(r"holds\[(?P<guard>[^\]]+)\]\s*$", body)
    if m:
        out.holds[line] = m.group("guard").strip()
        return
    m = re.match(r"revisit\[(?P<dims>[^\]]+)\]\s*(?:--.*)?$", body)
    if m:
        dims = tuple(d.strip() for d in m.group("dims").split(",")
                     if d.strip())
        out.revisits[line] = dims
        return
    m = re.match(r"(?P<kind>owns|borrows)\[page\]\s*:\s*(?P<names>.+)$",
                 body)
    if m:
        names = tuple(n.strip() for n in m.group("names").split(",")
                      if n.strip())
        dest = (out.page_owns if m.group("kind") == "owns"
                else out.page_borrows)
        dest[line] = names
        return
    m = re.match(r"guarded-by\[(?P<guard>[^\]]+)\]\s*:\s*(?P<names>.+)$",
                 body)
    if m:
        names = tuple(n.strip() for n in m.group("names").split(",")
                      if n.strip())
        out.guards.append(GuardDecl(line, m.group("guard").strip(), names))
        return
    m = re.match(r"device-state\s*:\s*(?P<names>.+)$", body)
    if m:
        names = tuple(n.strip() for n in m.group("names").split(",")
                      if n.strip())
        out.device_state.append((line, names))
        return
    raise SyntaxError(f"unrecognized swarmlint directive on line {line}: "
                      f"{body!r}")


class SourceFile:
    """One parsed source file plus its swarmlint directives."""

    def __init__(self, path: str, text: Optional[str] = None) -> None:
        self.path = path
        if text is None:
            with open(path, "r", encoding="utf-8") as f:
                text = f.read()
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        self.directives = self._scan_directives()
        self._scopes = self._index_scopes()
        self._parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent

    # ----------------------------------------------------------- directives

    def _scan_directives(self) -> Directives:
        out = Directives()
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO(self.text).readline))
        except tokenize.TokenError:
            return out
        code_lines: Set[int] = set()
        for tok in tokens:
            if tok.type == tokenize.COMMENT:
                m = DIRECTIVE_RE.search(tok.string)
                if m:
                    _parse_directive(m.group(1), tok.start[0], out)
            elif tok.type not in (tokenize.NL, tokenize.NEWLINE,
                                  tokenize.INDENT, tokenize.DEDENT,
                                  tokenize.ENCODING, tokenize.ENDMARKER):
                code_lines.add(tok.start[0])
        for tok in tokens:
            if (tok.type == tokenize.COMMENT
                    and tok.start[0] not in code_lines):
                out.comment_only_lines.add(tok.start[0])
        return out

    def suppressed(self, rule: str, line: int) -> bool:
        """True if ``rule`` is disabled on ``line`` (same-line comment, or a
        standalone directive comment on the line above)."""
        for cand in (line, line - 1):
            if cand not in self.directives.disables:
                continue
            if cand == line - 1 and (
                    cand not in self.directives.comment_only_lines):
                continue
            rules = self.directives.disables[cand]
            if rules is None or rule in rules:
                return True
        return False

    # --------------------------------------------------------------- scopes

    def _index_scopes(self) -> List[Tuple[int, int, ast.AST]]:
        spans = []
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                spans.append((node.lineno, node.end_lineno or node.lineno,
                              node))
        return spans

    def enclosing_scope(self, line: int,
                        classes_only: bool = False) -> Optional[ast.AST]:
        """Innermost function/class whose span contains ``line``."""
        best = None
        best_span = None
        for lo, hi, node in self._scopes:
            if classes_only and not isinstance(node, ast.ClassDef):
                continue
            if lo <= line <= hi:
                span = hi - lo
                if best_span is None or span < best_span:
                    best, best_span = node, span
        return best

    def qualname(self, node: ast.AST) -> str:
        parts: List[str] = []
        cur: Optional[ast.AST] = node
        while cur is not None and not isinstance(cur, ast.Module):
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                parts.append(cur.name)
            cur = self._parents.get(cur)
        return ".".join(reversed(parts)) or "<module>"

    def is_hot(self, fn: ast.AST) -> bool:
        """Hot if decorated ``@hot`` (any dotted path ending in hot) or a
        ``# swarmlint: hot`` comment sits on the decorator/def lines or the
        line directly above the def."""
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return False
        for dec in fn.decorator_list:
            name = dotted_name(dec)
            if name and name.split(".")[-1] == "hot":
                return True
        first = min([fn.lineno]
                    + [d.lineno for d in fn.decorator_list]) - 1
        for line in range(first, fn.body[0].lineno):
            if line in self.directives.hot_lines:
                return True
        return False

    def is_heartbeat(self, fn: ast.AST) -> bool:
        """Heartbeat-path function: ``# swarmlint: heartbeat`` on the
        decorator/def lines or directly above (same marker style as
        ``hot``)."""
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return False
        first = min([fn.lineno]
                    + [d.lineno for d in fn.decorator_list]) - 1
        for line in range(first, fn.body[0].lineno):
            if line in self.directives.heartbeat_lines:
                return True
        return False

    def is_retry(self, fn: ast.AST) -> bool:
        """Retry-path function: ``# swarmlint: retry`` on the
        decorator/def lines or directly above (same marker style as
        ``hot``/``heartbeat``). Loops inside must carry a bound, a
        backoff, and a deadline check (retry.py, SWL701)."""
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return False
        first = min([fn.lineno]
                    + [d.lineno for d in fn.decorator_list]) - 1
        for line in range(first, fn.body[0].lineno):
            if line in self.directives.retry_lines:
                return True
        return False

    def is_ha(self, fn: ast.AST) -> bool:
        """HA write-path function: ``# swarmlint: ha`` on the
        decorator/def lines or directly above. Broker appends inside
        must be epoch-fence-checked first (heartbeat.py, SWL603)."""
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return False
        first = min([fn.lineno]
                    + [d.lineno for d in fn.decorator_list]) - 1
        for line in range(first, fn.body[0].lineno):
            if line in self.directives.ha_lines:
                return True
        return False

    def page_decls(self, fn: ast.AST) -> Tuple[Set[str], Set[str]]:
        """(owns, borrows) parameter-name sets declared by
        ``# swarmlint: owns[page]:`` / ``borrows[page]:`` directives
        on/above the def (``"return"`` in owns marks the return value
        an owned handle)."""
        owns: Set[str] = set()
        borrows: Set[str] = set()
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return owns, borrows
        first = min([fn.lineno]
                    + [d.lineno for d in fn.decorator_list]) - 1
        for line in range(first, fn.body[0].lineno):
            owns.update(self.directives.page_owns.get(line, ()))
            borrows.update(self.directives.page_borrows.get(line, ()))
        return owns, borrows

    def held_guards(self, fn: ast.AST) -> Set[str]:
        """Guards a ``# swarmlint: holds[...]`` directive on/above the
        def declares as already held by this function's callers."""
        out: Set[str] = set()
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return out
        first = min([fn.lineno]
                    + [d.lineno for d in fn.decorator_list]) - 1
        for line in range(first, fn.body[0].lineno):
            if line in self.directives.holds:
                out.add(self.directives.holds[line])
        return out


def dotted_name(node: ast.AST) -> Optional[str]:
    """'torch.cuda.graph' for Attribute/Name chains; None for anything
    else."""
    if isinstance(node, ast.Call):
        return dotted_name(node.func)
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def make_finding(src: SourceFile, rule: str, node: ast.AST,
                 message: str) -> Finding:
    line = getattr(node, "lineno", 1)
    col = getattr(node, "col_offset", 0)
    scope = src.enclosing_scope(line)
    scope_name = src.qualname(scope) if scope is not None else "<module>"
    text = src.lines[line - 1].strip() if 0 < line <= len(src.lines) else ""
    norm_path = os.path.normpath(src.path).replace(os.sep, "/")
    # fingerprint on the trailing two path components so the same file
    # hashes identically whether scanned as `swarmdb_tpu/` from the repo
    # root or by absolute path (tests, editors); scope + line text keep
    # it collision-safe and line-number-churn-proof
    fp_path = "/".join(norm_path.split("/")[-2:])
    raw = "\x00".join((rule, fp_path, scope_name, text))
    fp = hashlib.sha256(raw.encode("utf-8")).hexdigest()[:16]
    return Finding(rule=rule, path=norm_path, line=line, col=col + 1,
                   message=message, scope=scope_name, fingerprint=fp)


# ------------------------------------------------------------------ baseline

BASELINE_VERSION = 1
#: the port's baseline, beside this file: the same from any working
#: directory (the JAX package resolves ``analysis/baseline.json`` against
#: the working directory)
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.json")
#: the port's package directory, the default scan
PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def default_paths() -> List[str]:
    """The package directory, relative to the working directory when it
    lies below it (shorter finding paths), else absolute."""
    rel = os.path.relpath(PACKAGE_DIR)
    return [PACKAGE_DIR if rel.startswith("..") else rel]


def load_baseline(path: str) -> Set[str]:
    return {e["fingerprint"] for e in load_baseline_entries(path)}


def load_baseline_entries(path: str) -> List[Dict[str, object]]:
    """Full baseline entries (path/line/rule/fingerprint) — the prune
    machinery needs more than the fingerprint set."""
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(f"unsupported baseline version in {path}: "
                         f"{data.get('version')!r}")
    return list(data.get("findings", []))


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    payload = {
        "version": BASELINE_VERSION,
        "comment": ("Accepted swarmlint findings. CI fails only on NEW "
                    "findings; regenerate with --update-baseline after "
                    "reviewing every entry you are accepting."),
        "findings": [f.to_json() for f in sorted(
            findings, key=lambda f: (f.path, f.line, f.rule))],
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=False)
        f.write("\n")


# -------------------------------------------------------------------- runner

def iter_py_files(paths: Sequence[str]) -> List[str]:
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                files.extend(os.path.join(root, n) for n in sorted(names)
                             if n.endswith(".py"))
        elif os.path.isfile(p) and p.endswith(".py"):
            files.append(p)
        else:
            # a typo'd path silently reporting "clean" would neuter CI
            raise OSError(f"not a directory or .py file: {p}")
    return files


# Parsed-AST cache shared across rule families AND across analyze
# calls in one process (keyed by (abspath, mtime_ns, size)). Before
# this cache, every analyze_file/analyze_paths call re-parsed its
# whole input set — the CI lint job's prune step and the swarmlint
# test suite each re-parsed the ~100-file tree from scratch per
# invocation. SourceFile is read-only to every checker, so sharing is
# safe; a rewritten file misses on mtime/size and re-parses.
_SRC_CACHE: Dict[str, Tuple[int, int, SourceFile]] = {}
_SRC_CACHE_MAX = 512


def _parse_source(path: str, text: Optional[str] = None) -> SourceFile:
    if text is None:
        key = os.path.abspath(path)
        try:
            st = os.stat(key)
            stamp = (st.st_mtime_ns, st.st_size)
        except OSError:
            stamp = None
        if stamp is not None:
            hit = _SRC_CACHE.get(key)
            if hit is not None and (hit[0], hit[1]) == stamp:
                return hit[2]
    try:
        src = SourceFile(path, text=text)
    except SyntaxError as exc:
        if exc.filename:  # ast.parse errors already carry the path
            raise
        raise SyntaxError(f"{path}: {exc}") from None
    if text is None and stamp is not None:
        if len(_SRC_CACHE) >= _SRC_CACHE_MAX:
            _SRC_CACHE.clear()
        _SRC_CACHE[key] = (stamp[0], stamp[1], src)
    return src


def _per_file_findings(src: SourceFile) -> List[Finding]:
    from . import heartbeat, hostsync, kernelcheck, locks, recompile, \
        retry, spans, tracers

    findings: List[Finding] = []
    for checker in (hostsync.check, recompile.check, locks.check,
                    tracers.check, spans.check, heartbeat.check,
                    retry.check, kernelcheck.check):
        findings.extend(checker(src))
    return findings


def _finalize(findings: List[Finding], srcs: Sequence[SourceFile],
              select: Optional[Set[str]]) -> List[Finding]:
    by_path = {os.path.normpath(s.path).replace(os.sep, "/"): s
               for s in srcs}
    out = []
    seen = set()
    for f in findings:
        key = (f.rule, f.path, f.line, f.col, f.message)
        if key in seen:  # e.g. a scan body nested in a jitted fn
            continue
        seen.add(key)
        if select is not None and f.rule not in select:
            continue
        src = by_path.get(f.path)
        if src is not None and src.suppressed(f.rule, f.line):
            continue
        out.append(f)
    return sorted(out, key=lambda f: (f.path, f.line, f.col, f.rule))


def _project_findings(srcs: Sequence[SourceFile]) -> List[Finding]:
    """Project-level passes. ONE CallGraph is built here and shared by
    every interprocedural family (lockorder SWL302-305, pagelife
    SWL801-805) — each family re-deriving its own graph doubled the
    project-pass indexing cost for zero semantic difference."""
    from . import lockorder, pagelife
    from .callgraph import CallGraph

    graph = CallGraph(srcs)
    findings = list(lockorder.check_project(srcs, graph=graph))
    findings.extend(pagelife.check_project(srcs, graph=graph))
    return findings


def analyze_file(path: str, select: Optional[Set[str]] = None,
                 text: Optional[str] = None) -> List[Finding]:
    src = _parse_source(path, text=text)
    findings = _per_file_findings(src)
    findings.extend(_project_findings([src]))
    return _finalize(findings, [src], select)


def analyze_paths(paths: Sequence[str],
                  select: Optional[Set[str]] = None) -> List[Finding]:
    """Per-file checks on every file, then the project-level passes
    (lockorder.py, pagelife.py) over ALL files as one program — the
    interprocedural SWL302/SWL80x edges only exist when the whole set
    is visible."""
    srcs = [_parse_source(p) for p in iter_py_files(paths)]
    findings: List[Finding] = []
    for src in srcs:
        findings.extend(_per_file_findings(src))
    findings.extend(_project_findings(srcs))
    return _finalize(findings, srcs, select)
