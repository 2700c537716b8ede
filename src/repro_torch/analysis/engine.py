"""Analyzer engine: walk files, run rules, apply suppressions and baseline.

Counterpart of `repro/analysis/engine.py`, a copy. The engine is
deliberately dumb plumbing: rules (repro_torch.analysis.rules) hold all of
the repo knowledge, findings.py holds the suppression/baseline mechanics,
and this module just wires them together and formats output.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import Baseline, Finding, noqa_rules_by_line
from repro_torch.analysis.rules import REGISTRY, ModuleInfo

__all__ = ["collect_files", "scan", "run", "format_text", "format_json"]

_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", "build", "dist"}


def collect_files(paths: Sequence[str]) -> List[Path]:
    out: List[Path] = []
    for raw in paths:
        p = Path(raw)
        if p.is_file() and p.suffix == ".py":
            out.append(p)
        elif p.is_dir():
            out.extend(
                f
                for f in sorted(p.rglob("*.py"))
                if not any(part in _SKIP_DIRS for part in f.parts)
            )
    return out


def _rel(path: Path) -> str:
    """Stable posix key: path relative to cwd when possible, else as given."""
    try:
        return path.resolve().relative_to(Path.cwd()).as_posix()
    except ValueError:
        return path.as_posix()


def scan(
    paths: Sequence[str],
    tests_dir: Optional[str] = "tests",
    rules: Optional[Sequence[str]] = None,
) -> Tuple[List[Finding], List[ModuleInfo], List[str]]:
    """Parse files and run every (selected) rule.

    Returns (raw findings before suppression/baseline, parsed modules,
    parse-error strings). Unparseable files are reported, not fatal: the
    analyzer must degrade gracefully on scratch files in the tree.
    """
    modules: List[ModuleInfo] = []
    errors: List[str] = []
    for f in collect_files(paths):
        try:
            modules.append(ModuleInfo(f, _rel(f), f.read_text()))
        except (SyntaxError, UnicodeDecodeError) as exc:
            errors.append(f"{f}: parse error: {exc}")

    active = [
        r for rid, r in sorted(REGISTRY.items()) if rules is None or rid in rules
    ]
    findings: List[Finding] = []
    for rule in active:
        if rule.project:
            continue
        for m in modules:
            findings.extend(rule.check(m))
    td = Path(tests_dir) if tests_dir else None
    for rule in active:
        if rule.project:
            findings.extend(rule.check_project(modules, td))
    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return findings, modules, errors


def run(
    paths: Sequence[str],
    tests_dir: Optional[str] = "tests",
    baseline: Optional[Baseline] = None,
    rules: Optional[Sequence[str]] = None,
):
    """Scan + suppression + baseline. Returns a result dict:

    active: findings that should fail CI
    suppressed: findings silenced by `# repro: noqa[...]`
    baselined: findings matched by the baseline file
    stale_baseline: baseline entries that matched nothing (warnings)
    errors: parse failures
    """
    raw, modules, errors = scan(paths, tests_dir=tests_dir, rules=rules)
    by_rel = {m.rel: m for m in modules}
    active: List[Finding] = []
    suppressed: List[Finding] = []
    baselined: List[Finding] = []
    noqa_cache = {}
    for f in raw:
        mod = by_rel.get(f.file)
        line_text = mod.line(f.line) if mod else ""
        if mod is not None:
            if f.file not in noqa_cache:
                noqa_cache[f.file] = noqa_rules_by_line(mod.lines)
            rules_at = noqa_cache[f.file].get(f.line, ...)
            if rules_at is ... :
                pass
            elif rules_at is None or f.rule in rules_at:
                suppressed.append(f)
                continue
        if baseline is not None and baseline.matches(f, line_text):
            baselined.append(f)
            continue
        active.append(f)
    return {
        "active": active,
        "suppressed": suppressed,
        "baselined": baselined,
        "stale_baseline": baseline.stale_entries() if baseline else [],
        "errors": errors,
        "modules": modules,
    }


def format_text(result: dict, verbose: bool = False) -> str:
    lines: List[str] = []
    for f in result["active"]:
        lines.append(f"{f.location()}: [{f.rule}] {f.message}")
        if f.hint:
            lines.append(f"    fix: {f.hint}")
    for e in result["errors"]:
        lines.append(f"error: {e}")
    for e in result["stale_baseline"]:
        lines.append(
            f"warning: stale baseline entry [{e['rule']}] {e['file']}: "
            f"{e['content']!r} matches nothing — delete it"
        )
    if verbose:
        for f in result["baselined"]:
            lines.append(f"baselined: {f.location()}: [{f.rule}] {f.message}")
        for f in result["suppressed"]:
            lines.append(f"suppressed: {f.location()}: [{f.rule}] {f.message}")
    n_act = len(result["active"])
    lines.append(
        f"{n_act} finding(s), {len(result['baselined'])} baselined, "
        f"{len(result['suppressed'])} suppressed, "
        f"{len(result['errors'])} parse error(s)"
    )
    return "\n".join(lines)


def format_json(result: dict) -> str:
    return json.dumps(
        {
            "findings": [f.to_dict() for f in result["active"]],
            "baselined": [f.to_dict() for f in result["baselined"]],
            "suppressed": [f.to_dict() for f in result["suppressed"]],
            "stale_baseline": result["stale_baseline"],
            "errors": result["errors"],
        },
        indent=2,
    )


def exit_code(result: dict) -> int:
    return 1 if (result["active"] or result["errors"]) else 0
