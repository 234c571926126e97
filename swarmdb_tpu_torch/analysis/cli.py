"""swarmlint CLI: ``python -m swarmdb_tpu_torch.analysis [paths...]``.

Exit codes: 0 = no findings beyond the baseline; 1 = new findings (or
any finding with ``--no-baseline``); 2 = usage error. With no paths it
scans the ``swarmdb_tpu_torch`` package, and the default baseline is
``swarmdb_tpu_torch/analysis/baseline.json``; both are found from this
file, so ``python -m swarmdb_tpu_torch.analysis`` gives the same answer
from any working directory.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from .core import (DEFAULT_BASELINE, PACKAGE_DIR, RULES, Finding, analyze_paths,
                   default_paths, expand_rule_names, iter_py_files,
                   load_baseline, load_baseline_entries, write_baseline)


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m swarmdb_tpu_torch.analysis",
        description="swarmlint for the PyTorch/CUDA package: host-sync "
                    "(the card's syncs), graph-capture hazards, "
                    "lock-discipline incl. interprocedural lock-order/"
                    "guarded-by inference, capture-leak, span-discipline, "
                    "heartbeat/fencing, retry, page-lifetime, and the "
                    "CUDA kernels' shared memory per block")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or directories to scan "
                         "(default: the swarmdb_tpu_torch package)")
    ap.add_argument("--baseline", default=None,
                    help="baseline json of accepted findings (default: "
                         "swarmdb_tpu_torch/analysis/baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore any baseline; every finding fails")
    ap.add_argument("--update-baseline", action="store_true",
                    help="write the current findings to the baseline "
                         "file and exit 0")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule ids or family names to run "
                         "(default: all)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--explain", metavar="SWL<code>", default=None,
                    help="print the rule's doc plus a minimal bad/good "
                         "example and exit (family names print every "
                         "member rule)")
    ap.add_argument("--prune-baseline", action="store_true",
                    help="report baseline entries whose finding no "
                         "longer exists in the scanned tree (moved/fixed"
                         "/deleted code); REPORT-ONLY unless --write")
    ap.add_argument("--write", action="store_true",
                    help="with --prune-baseline: rewrite the baseline "
                         "keeping only the entries that still match")
    return ap


def _explain(name: str) -> int:
    from .explain import EXPLAIN

    try:
        rules = sorted(expand_rule_names([name]))
    except KeyError as exc:
        print(f"swarmlint: {exc.args[0]}", file=sys.stderr)
        return 2
    for i, rid in enumerate(rules):
        if i:
            print()
        rule = RULES[rid]
        print(f"{rid} [{rule.family}] — {rule.summary}")
        entry = EXPLAIN.get(rid)
        if entry is None:  # pragma: no cover - every rule has an entry
            continue
        print()
        print(entry["doc"])
        print()
        print("  BAD:")
        for line in entry["bad"].splitlines():
            print(f"    {line}")
        print("  GOOD:")
        for line in entry["good"].splitlines():
            print(f"    {line}")
    return 0


def _prune_baseline(paths, baseline_path: str, write: bool) -> int:
    """Drop baseline entries whose finding no longer exists. An entry is
    stale when its file is gone, or the file was scanned and no current
    finding carries its fingerprint (the fingerprint is content-
    addressed, so pure line-number churn does NOT stale an entry).
    Entries for files outside the scanned set are kept untouched."""
    try:
        entries = load_baseline_entries(baseline_path)
    except FileNotFoundError:
        print(f"swarmlint: baseline {baseline_path} not found",
              file=sys.stderr)
        return 2
    root = os.path.dirname(PACKAGE_DIR)

    def where(path: str) -> str:
        # baseline paths are relative to the repository root
        return os.path.abspath(path if os.path.isabs(path)
                               else os.path.join(root, path))

    scanned = {os.path.abspath(p) for p in iter_py_files(paths)}
    current = {f.fingerprint for f in analyze_paths(paths)}
    kept, stale = [], []
    for e in entries:
        path = where(str(e.get("path", "")))
        if not os.path.exists(path):
            stale.append(e)
        elif path in scanned and e.get("fingerprint") not in current:
            stale.append(e)
        else:
            kept.append(e)
    for e in stale:
        why = ("file gone" if not os.path.exists(where(str(e.get("path",
                                                                   ""))))
               else "finding no longer produced")
        print(f"stale: {e.get('path')}:{e.get('line')} {e.get('rule')} "
              f"({why})")
    if not stale:
        print(f"swarmlint: baseline {baseline_path} has no stale "
              f"entries ({len(kept)} current)")
        return 0
    if write:
        payload = {
            "version": 1,
            "comment": ("Accepted swarmlint findings. CI fails only on "
                        "NEW findings; regenerate with --update-baseline "
                        "after reviewing every entry you are accepting."),
            "findings": kept,
        }
        with open(baseline_path, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")
        print(f"swarmlint: pruned {len(stale)} stale entrie(s), "
              f"{len(kept)} kept -> {baseline_path}")
    else:
        print(f"swarmlint: {len(stale)} stale entrie(s) of "
              f"{len(entries)} (report-only; pass --write to prune)")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.list_rules:
        for rule in sorted(RULES.values(), key=lambda r: r.id):
            print(f"{rule.id}  [{rule.family}]  {rule.summary}")
        return 0
    if args.explain:
        return _explain(args.explain)

    paths = args.paths or default_paths()
    if args.prune_baseline:
        target = args.baseline or DEFAULT_BASELINE
        try:
            return _prune_baseline(paths, target, args.write)
        except (OSError, SyntaxError) as exc:
            print(f"swarmlint: {exc}", file=sys.stderr)
            return 2
    select = None
    if args.select:
        try:
            select = expand_rule_names(args.select.split(","))
        except KeyError as exc:
            print(f"swarmlint: {exc.args[0]}", file=sys.stderr)
            return 2

    try:
        findings = analyze_paths(paths, select=select)
    except (OSError, SyntaxError) as exc:
        print(f"swarmlint: {exc}", file=sys.stderr)
        return 2

    baseline_path = args.baseline
    if baseline_path is None and not args.no_baseline \
            and os.path.exists(DEFAULT_BASELINE):
        baseline_path = DEFAULT_BASELINE

    if args.update_baseline:
        target = baseline_path or DEFAULT_BASELINE
        write_baseline(target, findings)
        print(f"swarmlint: wrote {len(findings)} accepted finding(s) to "
              f"{target}")
        return 0

    accepted = set()
    if baseline_path and not args.no_baseline:
        try:
            accepted = load_baseline(baseline_path)
        except FileNotFoundError:
            print(f"swarmlint: baseline {baseline_path} not found",
                  file=sys.stderr)
            return 2
    new = [f for f in findings if f.fingerprint not in accepted]
    known = len(findings) - len(new)

    if args.format == "json":
        print(json.dumps({"new": [f.to_json() for f in new],
                          "baselined": known}, indent=2))
    else:
        for f in new:
            print(f.render())
        suffix = f" ({known} baselined)" if known else ""
        if new:
            print(f"swarmlint: {len(new)} new finding(s){suffix}")
        else:
            print(f"swarmlint: clean{suffix}")
    return 1 if new else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
