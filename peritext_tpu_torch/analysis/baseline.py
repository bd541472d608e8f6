"""Attributed baseline: the ledger of known, *justified* findings.

The package self-scan must be clean — but some violations are intentional
(observability timing in a hot loop, transport jitter that is nondeterministic
by design).  Those live in ``peritext_tpu_torch/graftlint_baseline.json``, one
entry per finding, each carrying a human justification.  Fingerprints are
``(rule, path, stripped source line, occurrence count)`` — line-number drift
never invalidates an entry; editing or removing the offending line does.

* a scan finding with no baseline budget left → **new** (fails the lint);
* a baseline entry whose finding no longer occurs → **stale** (warned, so
  the ledger gets pruned, but lint stays green — deleting dead suppressions
  must never block a fix).
"""

from __future__ import annotations

import json
from collections import Counter
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .engine import Finding

BASELINE_NAME = "graftlint_baseline.json"

#: fingerprint key
Key = Tuple[str, str, str]  # (rule, path, context)


@dataclass
class BaselineEntry:
    rule: str
    path: str
    context: str
    count: int
    justification: str


def load_baseline(path: Path) -> Dict[Key, BaselineEntry]:
    data = json.loads(path.read_text(encoding="utf-8"))
    entries: Dict[Key, BaselineEntry] = {}
    for raw in data.get("findings", []):
        entry = BaselineEntry(
            rule=raw["rule"],
            path=raw["path"],
            context=raw["context"],
            count=int(raw.get("count", 1)),
            justification=raw.get("justification", ""),
        )
        key = (entry.rule, entry.path, entry.context)
        if key in entries:  # merge duplicates defensively
            entries[key].count += entry.count
        else:
            entries[key] = entry
    return entries


def save_baseline(path: Path, entries: Iterable[BaselineEntry]) -> None:
    payload = {
        "//": "graftlint attributed baseline — every entry is a known, "
              "justified violation; regenerate with --update-baseline",
        "version": 1,
        "findings": [
            {
                "rule": e.rule,
                "path": e.path,
                "context": e.context,
                "count": e.count,
                "justification": e.justification,
            }
            for e in sorted(entries, key=lambda e: (e.path, e.rule, e.context))
        ],
    }
    path.write_text(json.dumps(payload, indent=2) + "\n", encoding="utf-8")


def apply_baseline(
    findings: Sequence[Finding], entries: Dict[Key, BaselineEntry]
) -> Tuple[List[Finding], List[BaselineEntry]]:
    """``(new, stale)``: findings not covered by the baseline, and baseline
    entries no longer matched by any finding (candidates for pruning)."""
    budget = Counter({key: e.count for key, e in entries.items()})
    new: List[Finding] = []
    for finding in findings:  # findings arrive line-sorted: earlier wins budget
        key = (finding.rule, finding.path, finding.context)
        if budget.get(key, 0) > 0:
            budget[key] -= 1
        else:
            new.append(finding)
    stale = [
        entries[key]
        for key, remaining in sorted(budget.items())
        if remaining > 0
    ]
    return new, stale


def update_baseline(
    findings: Sequence[Finding], old: Dict[Key, BaselineEntry]
) -> List[BaselineEntry]:
    """Rebuild entries from a scan, preserving existing justifications."""
    counts: Counter = Counter(
        (f.rule, f.path, f.context) for f in findings
    )
    out: List[BaselineEntry] = []
    for (rule, path, context), count in sorted(counts.items()):
        prior = old.get((rule, path, context))
        out.append(
            BaselineEntry(
                rule=rule,
                path=path,
                context=context,
                count=count,
                justification=prior.justification if prior else "TODO: justify or fix",
            )
        )
    return out


def find_default_baseline(paths: Sequence[str | Path]) -> Optional[Path]:
    """Walk up from the first scanned path, starting at the path itself,
    looking for the checked-in baseline (the package's own, for a scan of
    the package); None if absent."""
    if not paths:
        return None
    start = Path(paths[0]).resolve()
    if start.is_file():
        start = start.parent
    for candidate in [start, *start.parents]:
        hit = candidate / BASELINE_NAME
        if hit.is_file():
            return hit
    return None
