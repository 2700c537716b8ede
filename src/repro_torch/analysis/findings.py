"""Finding/suppression/baseline plumbing for the invariant analyzer.

Counterpart of `repro/analysis/findings.py`, a copy: the same comment and
the same baseline file silence both packages' lints.

A `Finding` is one rule violation at one source location. Two mechanisms
make adoption incremental without weakening the CI gate:

  * **inline suppression** — a ``# repro: noqa[rule-id]`` comment on the
    flagged line (or ``# repro: noqa`` to silence every rule on that line)
    suppresses the finding at the source. Use it for one-off sites where
    the exception is obvious in context.
  * **baseline file** — a checked-in JSON file grandfathering deliberate
    exceptions, each with a one-line justification. Entries match on
    (rule, file, stripped source line), NOT on line numbers, so unrelated
    edits above a grandfathered site do not invalidate the baseline.
    Stale entries (matching nothing) are reported as warnings so the
    baseline shrinks over time instead of fossilizing.

The CI contract: `python -m repro_torch.analysis src/` exits non-zero on
any finding that is neither suppressed inline nor matched by the baseline.
"""
from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Finding", "Baseline", "noqa_rules_by_line"]

_NOQA_RE = re.compile(r"#\s*repro:\s*noqa(?:\[(?P<rules>[A-Za-z0-9_,\- ]+)\])?")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation: where, what, and how to fix it."""

    rule: str  # rule id, e.g. "cas-discipline"
    file: str  # posix path as scanned (stable across machines for a repo)
    line: int  # 1-based
    col: int  # 0-based
    message: str  # what is wrong at this site
    hint: str = ""  # how to fix it (rule-level fix recipe)

    def location(self) -> str:
        return f"{self.file}:{self.line}:{self.col}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def noqa_rules_by_line(source_lines: Sequence[str]) -> Dict[int, Optional[set]]:
    """{1-based line: set of suppressed rule ids, or None for 'all rules'}."""
    out: Dict[int, Optional[set]] = {}
    for i, text in enumerate(source_lines, start=1):
        m = _NOQA_RE.search(text)
        if not m:
            continue
        rules = m.group("rules")
        if rules is None:
            out[i] = None  # blanket: every rule suppressed on this line
        else:
            out[i] = {r.strip() for r in rules.split(",") if r.strip()}
    return out


class Baseline:
    """Checked-in grandfather list: (rule, file, line content) + justification.

    Content-matched, not line-number-matched: the flagged line's stripped
    text is the key, so the baseline survives edits elsewhere in the file
    but dies with the flagged code itself — exactly when it should be
    re-justified or deleted.
    """

    def __init__(self, entries: Optional[List[dict]] = None, path: str = ""):
        self.path = path
        self.entries: List[dict] = list(entries or [])
        self._matched = [False] * len(self.entries)

    @classmethod
    def load(cls, path) -> "Baseline":
        p = Path(path)
        data = json.loads(p.read_text())
        entries = data.get("entries", [])
        for e in entries:
            for key in ("rule", "file", "content"):
                if key not in e:
                    raise ValueError(
                        f"baseline entry missing {key!r} in {p}: {e}"
                    )
        return cls(entries, path=str(p))

    def save(self, path) -> None:
        Path(path).write_text(
            json.dumps({"entries": self.entries}, indent=2, sort_keys=False)
            + "\n"
        )

    def matches(self, finding: Finding, line_content: str) -> bool:
        """True (and marks the entry used) if a baseline entry covers this
        finding. Multiple identical sites may share one entry."""
        stripped = line_content.strip()
        hit = False
        for i, e in enumerate(self.entries):
            if (
                e["rule"] == finding.rule
                and e["file"] == finding.file
                and e["content"] == stripped
            ):
                self._matched[i] = True
                hit = True
        return hit

    def stale_entries(self) -> List[dict]:
        """Entries that matched no finding this run — candidates to delete."""
        return [e for e, m in zip(self.entries, self._matched) if not m]

    @staticmethod
    def entry_for(
        finding: Finding, line_content: str, justification: str = "TODO: justify"
    ) -> dict:
        return {
            "rule": finding.rule,
            "file": finding.file,
            "content": line_content.strip(),
            "justification": justification,
        }


def merge_baseline_entries(
    old: "Baseline", new_entries: List[dict]
) -> List[dict]:
    """Keep old justifications for entries that still exist; add the rest."""
    justified: Dict[Tuple[str, str, str], str] = {
        (e["rule"], e["file"], e["content"]): e.get("justification", "")
        for e in old.entries
    }
    out = []
    for e in new_entries:
        key = (e["rule"], e["file"], e["content"])
        if key in justified and justified[key]:
            e = dict(e, justification=justified[key])
        out.append(e)
    return out
