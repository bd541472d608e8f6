"""graftlint CLI.

Usage::

    python -m peritext_tpu_torch.analysis [paths...]         # lint (default: peritext_tpu_torch)
    python -m peritext_tpu_torch.analysis --list-rules
    python -m peritext_tpu_torch.analysis --update-baseline  # re-attribute the ledger

With no ``--baseline``, the baseline is the package's own,
``peritext_tpu_torch/graftlint_baseline.json``, whatever is scanned, so its
entries' paths are relative to the package.  ``--update-baseline`` writes
only a baseline inside the package, from a scan of paths inside it: any
other target or scanned path exits 2 and writes nothing (the repo root's
``graftlint_baseline.json`` is the JAX package's frozen ledger).

Exit codes: 0 clean (modulo baseline), 1 unbaselined findings, 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from .baseline import (
    apply_baseline,
    find_default_baseline,
    inside_package,
    load_baseline,
    package_baseline,
    save_baseline,
    update_baseline,
)
from .engine import all_rule_ids, rule_table, scan_paths


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m peritext_tpu_torch.analysis",
        description="graftlint: determinism static analysis",
    )
    parser.add_argument("paths", nargs="*", default=["peritext_tpu_torch"],
                        help="files/directories to scan (default: peritext_tpu_torch)")
    parser.add_argument("--baseline", metavar="FILE",
                        help="baseline file (default: the package's own, "
                             "peritext_tpu_torch/graftlint_baseline.json)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="report every finding, ignoring any baseline")
    parser.add_argument("--update-baseline", action="store_true",
                        help="rewrite the baseline from this scan, preserving "
                             "existing justifications (only a baseline inside the "
                             "package, from paths inside it)")
    parser.add_argument("--rules", metavar="IDS",
                        help="comma-separated rule subset (e.g. PTL001,PTL005)")
    parser.add_argument("--format", choices=("text", "json"), default="text")
    parser.add_argument("--list-rules", action="store_true")
    args = parser.parse_args(argv)

    if args.list_rules:
        for row in rule_table():
            print(f"{row['id']} [{row['scope']}] {row['summary']}")
            print(f"    {row['rationale']}")
        return 0

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = set(rules) - set(all_rule_ids())
        if unknown:
            print(f"unknown rule(s): {', '.join(sorted(unknown))}", file=sys.stderr)
            return 2

    baseline_path: Optional[Path] = None
    if args.baseline:
        baseline_path = Path(args.baseline)
        if not baseline_path.is_file() and not args.update_baseline:
            print(f"baseline not found: {baseline_path}", file=sys.stderr)
            return 2
    elif not args.no_baseline:
        baseline_path = find_default_baseline()

    root = (baseline_path.parent if baseline_path
            else package_baseline().parent if args.update_baseline else Path.cwd())
    try:
        findings = scan_paths(args.paths, root=root, rules=rules)
    except (FileNotFoundError, ValueError) as exc:
        print(str(exc), file=sys.stderr)
        return 2

    if args.update_baseline:
        # the default discovery reads only the package's own baseline, so
        # that is the one ledger an update may write, from a scan of the
        # package: never the JAX package's frozen one at the repo root
        target = baseline_path or package_baseline()
        outside = [str(p) for p in [target, *args.paths] if not inside_package(p)]
        if outside:
            print(f"refusing to update a baseline: {', '.join(outside)} "
                  f"lie(s) outside the package {package_baseline().parent}", file=sys.stderr)
            return 2
        old = load_baseline(target) if target.is_file() else {}
        entries = update_baseline(findings, old)
        if rules is not None:
            # a --rules-scoped update must not delete other rules' entries
            # (and their hand-written justifications) from the ledger
            selected = set(rules)
            entries.extend(
                e for e in old.values() if e.rule not in selected
            )
        save_baseline(target, entries)
        todo = sum(1 for e in entries if e.justification.startswith("TODO"))
        print(f"{target}: {len(entries)} entries ({todo} needing justification)")
        return 0

    entries = (
        load_baseline(baseline_path)
        if baseline_path and not args.no_baseline
        else {}
    )
    new, stale = apply_baseline(findings, entries)

    if args.format == "json":
        print(json.dumps(
            {
                "findings": [f.to_json() for f in new],
                "baselined": len(findings) - len(new),
                "stale_baseline_entries": [
                    {"rule": e.rule, "path": e.path, "context": e.context}
                    for e in stale
                ],
            },
            indent=2,
        ))
    else:
        for finding in new:
            print(finding.render())
        for entry in stale:
            print(
                f"warning: stale baseline entry {entry.rule} {entry.path} "
                f"({entry.context!r}) — prune with --update-baseline",
                file=sys.stderr,
            )
        summary = (
            f"graftlint: {len(new)} finding(s), "
            f"{len(findings) - len(new)} baselined, {len(stale)} stale"
        )
        print(summary, file=sys.stderr if new else sys.stdout)
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
