"""CLI for the invariant analyzer: `python -m repro_torch.analysis [paths...]`.

Exit status: 0 when every finding is suppressed or baselined, 1 otherwise.
See `repro_torch.analysis` (package docstring) for the rule catalog.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis.engine import exit_code, format_json, format_text, run
from repro_torch.analysis.findings import Baseline, merge_baseline_entries
from repro_torch.analysis.rules import REGISTRY

DEFAULT_BASELINE = "analysis_baseline.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Repo-specific invariant lint for the semantic router.",
    )
    ap.add_argument("paths", nargs="*", default=None, help="files/dirs (default: src)")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument(
        "--baseline",
        default=None,
        help=f"baseline JSON (default: {DEFAULT_BASELINE} when present)",
    )
    ap.add_argument(
        "--no-baseline", action="store_true", help="ignore any baseline file"
    )
    ap.add_argument(
        "--write-baseline",
        action="store_true",
        help="write current findings to the baseline file (keeps existing "
        "justifications) instead of failing",
    )
    ap.add_argument(
        "--tests-dir", default="tests", help="tests root for kernel-contract"
    )
    ap.add_argument(
        "--rule",
        action="append",
        dest="rules",
        default=None,
        metavar="RULE-ID",
        help="run only this rule (repeatable)",
    )
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument(
        "-v", "--verbose", action="store_true", help="also print baselined/suppressed"
    )
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid, rule in sorted(REGISTRY.items()):
            kind = "project" if rule.project else "module"
            print(f"{rid} ({kind}): {rule.description}")
        return 0

    if args.rules:
        unknown = [r for r in args.rules if r not in REGISTRY]
        if unknown:
            print(f"unknown rule id(s): {', '.join(unknown)}", file=sys.stderr)
            return 2

    paths = args.paths or ["src"]
    baseline_path = args.baseline or DEFAULT_BASELINE
    baseline = None
    if not args.no_baseline and Path(baseline_path).exists():
        baseline = Baseline.load(baseline_path)

    result = run(
        paths,
        tests_dir=args.tests_dir or None,
        baseline=baseline,
        rules=args.rules,
    )

    if args.write_baseline:
        old = baseline or Baseline()
        by_rel = {m.rel: m for m in result["modules"]}
        entries = []
        seen = set()
        for f in result["active"] + result["baselined"]:
            mod = by_rel.get(f.file)
            text = mod.line(f.line) if mod else ""
            e = Baseline.entry_for(f, text)
            key = (e["rule"], e["file"], e["content"])
            if key not in seen:
                seen.add(key)
                entries.append(e)
        Baseline(merge_baseline_entries(old, entries)).save(baseline_path)
        print(f"wrote {len(entries)} entries to {baseline_path}")
        return 0

    print(format_json(result) if args.json else format_text(result, args.verbose))
    return exit_code(result)


if __name__ == "__main__":
    raise SystemExit(main())
