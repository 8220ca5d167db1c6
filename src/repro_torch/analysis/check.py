"""CLI driver: ``python -m repro_torch.analysis.check``.

Runs every registered rule over the port, diffs the findings against
the checked-in baseline (``analysis_baseline_torch.json``), and exits
non-zero when anything un-baselined (or a stale baseline entry) is
present — the port's gate.  Exit codes: 0 clean, 1 new findings or
stale entries, 2 an unknown ``--rule``.

Options::

    paths...          roots to scan (default: src/repro_torch chip_smoke.py)
    --root DIR        repo root (default: auto-detect from cwd upward)
    --baseline FILE   baseline path
                      (default: <root>/analysis_baseline_torch.json)
    --json            machine-readable report on stdout
    --fix-baseline    pin current findings into the baseline and prune
                      stale entries (new pins get a TODO justification
                      that must be edited before review)
    --rule NAME       run only the named rule (repeatable)
    --list-rules      print registered rules and exit
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

from repro_torch.analysis import (
    Baseline, RULE_REGISTRY, RepoIndex, run_rules,
)
from repro_torch.analysis.framework import DEFAULT_PATHS

BASELINE_NAME = "analysis_baseline_torch.json"


def find_root(start: Optional[str] = None) -> str:
    """Walk upward from ``start`` (default cwd) to the first directory
    holding pyproject.toml or .git."""
    cur = os.path.abspath(start or os.getcwd())
    while True:
        if (os.path.exists(os.path.join(cur, "pyproject.toml"))
                or os.path.exists(os.path.join(cur, ".git"))):
            return cur
        parent = os.path.dirname(cur)
        if parent == cur:
            return os.path.abspath(start or os.getcwd())
        cur = parent


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.check",
        description="the port's static checker suite")
    p.add_argument("paths", nargs="*", default=None,
                   help=f"roots to scan (default: {' '.join(DEFAULT_PATHS)})")
    p.add_argument("--root", default=None, help="repo root")
    p.add_argument("--baseline", default=None,
                   help=f"baseline file (default: <root>/{BASELINE_NAME})")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable output")
    p.add_argument("--fix-baseline", action="store_true",
                   help="absorb current findings into the baseline")
    p.add_argument("--rule", action="append", default=None,
                   help="run only this rule (repeatable)")
    p.add_argument("--list-rules", action="store_true")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for name, cls in sorted(RULE_REGISTRY.items()):
            print(f"{name}: {cls.description}")
        return 0

    root = args.root or find_root()
    baseline_path = args.baseline or os.path.join(root, BASELINE_NAME)
    rules = None
    if args.rule:
        unknown = [r for r in args.rule if r not in RULE_REGISTRY]
        if unknown:
            print(f"unknown rule(s): {', '.join(unknown)}", file=sys.stderr)
            return 2
        rules = [RULE_REGISTRY[r]() for r in args.rule]

    index = RepoIndex.load(root, paths=args.paths or None)
    findings = run_rules(index, rules)
    baseline = Baseline.load(baseline_path)
    if args.fix_baseline:
        baseline.absorb(findings)
        baseline.save(baseline_path)
        print(f"baseline updated: {len(baseline.entries)} entries "
              f"-> {os.path.relpath(baseline_path, root)}")
        return 0
    new, stale = baseline.diff(findings)

    if args.as_json:
        print(json.dumps({
            "root": root,
            "modules_scanned": len(index.modules),
            "findings": [f.to_dict() for f in findings],
            "new": [f.to_dict() for f in new],
            "baselined": len(findings) - len(new),
            "stale_baseline": stale,
            "ok": not new and not stale,
        }, indent=2))
    else:
        for f in findings:
            tag = "" if f.key in baseline.entries else " (new)"
            print(f.format() + tag)
        for k in stale:
            print(f"stale baseline entry (finding no longer raised): {k}")
        n_err = sum(1 for f in new if f.severity == "error")
        n_warn = len(new) - n_err
        print(f"{len(index.modules)} modules scanned: "
              f"{len(findings)} finding(s), {len(new)} new "
              f"({n_err} error / {n_warn} warning), "
              f"{len(findings) - len(new)} baselined, "
              f"{len(stale)} stale baseline entr(y/ies)")
        if new or stale:
            print("un-baselined findings or stale entries present; "
                  "fix them or run with --fix-baseline and justify.")
    return 1 if (new or stale) else 0


if __name__ == "__main__":
    sys.exit(main())
