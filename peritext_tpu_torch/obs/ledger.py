"""Append-only JSONL perf-regression ledger.

Each ledger line is one :func:`ledger_record`: the result rows of one run
(a bench ladder's, or the card smoke's) plus an optional devprof snapshot,
keyed by (git sha, device fingerprint, config).  :func:`evaluate` judges
the LAST record against a ROLLING REFERENCE — the median of each row's
value over the preceding records with a matching device fingerprint and
row identity — and flags a regression beyond the row's tolerance band.

Tolerance-band policy: direction comes from the row's unit (``ops/s`` /
``docs/s`` regress DOWN, ``B/op`` and seconds regress UP); bands default
per unit — tight for deterministic byte-count rows, loose for wall-clock
rows — and improvements never fail the gate.  Reference matching is per
ROW: deterministic-unit rows compare across any machine of the same
platform, wall-clock rows require the full device fingerprint.  A
wall-clock row with no same-device reference passes vacuously and seeds
the reference; a SAME-CONFIG reference row the candidate no longer
carries is a ``missing`` verdict that FAILS the gate — dropping or
renaming a row must be a deliberate, reference-regenerating change.

:func:`device_fingerprint` describes the host: ``platform`` is ``"gpu"``
with an NVIDIA card present (``kind`` its ``torch.cuda.get_device_name``)
and ``"cpu"`` otherwise; it runs no work on the card.
"""

from __future__ import annotations

import json
import os
import subprocess
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

SCHEMA_VERSION = 1

#: regression direction by unit: +1 = higher is better, -1 = lower is better
DIRECTION_BY_UNIT = {
    "ops/s": +1,
    "docs/s": +1,
    "B/op": -1,
    "s": -1,
    "seconds": -1,
    "bytes": -1,
}

#: default tolerance band by unit (fraction of the reference value).
#: Byte-count rows are deterministic per (workload, codec) and get a tight
#: band; wall-clock-derived rows get a loose one — the gate is meant to
#: catch step regressions (a 2x slower round), not scheduler jitter.
BAND_BY_UNIT = {"B/op": 0.10, "bytes": 0.10}
DEFAULT_BAND = 0.50
#: rolling-reference window: how many prior matching records feed the median
DEFAULT_WINDOW = 5


def git_sha(root: Optional[str] = None) -> Optional[str]:
    """Current commit sha (best-effort: None outside a git checkout)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=root or os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10,
        )
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else None
    except (OSError, subprocess.SubprocessError):
        return None


def device_fingerprint() -> Dict[str, Any]:
    """The ledger's device key: platform + device kind + host core count.
    Two records compare only when this matches — a CPU run never gates
    against a card's.  With a CUDA card present the platform is ``"gpu"``
    and the kind ``torch.cuda.get_device_name(0)``; otherwise both are
    ``"cpu"`` (as the reference package's CPU backend reports them)."""
    import torch

    if torch.cuda.is_available():
        platform, kind = "gpu", torch.cuda.get_device_name(0)
    else:
        platform = kind = "cpu"
    return {"platform": platform, "kind": kind, "cpus": os.cpu_count()}


def _row_config_key(row: Dict[str, Any]) -> str:
    """Stable per-row config identity: the sizing fields that change what
    the row measures (a smoke row must never gate against a full row)."""
    fields = ("docs", "ops_per_doc", "rounds", "slot_capacity", "hosts")
    return ",".join(f"{k}={row[k]}" for k in fields if row.get(k) is not None)


def ledger_record(
    rows: Sequence[Dict[str, Any]],
    *,
    config: str,
    devprof: Optional[Dict[str, Any]] = None,
    sha: Optional[str] = None,
    device: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Build one ledger record from result rows (each a dict:
    ``row``/``metric``/``value``/``unit`` plus sizing fields)."""
    out_rows = []
    for r in rows:
        entry = {
            "row": r.get("row") or r.get("metric") or "?",
            "metric": r.get("metric"),
            "value": r.get("value"),
            "unit": r.get("unit"),
            "key": _row_config_key(r),
        }
        if r.get("failed"):
            entry["failed"] = True
        if r.get("skipped"):
            entry["skipped"] = True
        if isinstance(r.get("latency"), dict):
            # the latency plane's per-stage decomposition rides along so
            # `obs why` can diff a failing row's stages against its
            # rolling reference (older records simply lack the key)
            entry["latency"] = r["latency"]
        out_rows.append(entry)
    return {
        "schema": SCHEMA_VERSION,
        "sha": sha if sha is not None else git_sha(),
        "device": device if device is not None else device_fingerprint(),
        "config": config,
        "rows": out_rows,
        "devprof": devprof,
    }


def append_record(path: str | Path, record: Dict[str, Any]) -> None:
    """Append one record as a JSONL line (the ledger is append-only)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a") as fh:
        fh.write(json.dumps(record, sort_keys=True) + "\n")


def load_ledger(path: str | Path) -> List[Dict[str, Any]]:
    """All records, oldest first.  Raises on unreadable/corrupt lines —
    a silently-skipped record would silently weaken the gate."""
    records = []
    for n, line in enumerate(Path(path).read_text().splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError as exc:
            raise ValueError(f"{path}:{n}: corrupt ledger line: {exc}") from exc
    return records


# -- regression gate ---------------------------------------------------------


#: units whose values are a function of (workload, code), not clock speed —
#: their rows gate across machines of one PLATFORM, which is what keeps the
#: gate non-vacuous on ephemeral CI runners whose core counts never match
#: the committed reference's fingerprint
DETERMINISTIC_UNITS = frozenset(BAND_BY_UNIT)


def _row_identity(config: Optional[str], row: Dict[str, Any]) -> tuple:
    """A row's gate identity: the RECORD's config (a smoke row must never
    gate against a full row — sizing fields alone can be absent, e.g. the
    wire row) plus the row's name/metric/unit/sizing key."""
    return (config, row.get("row"), row.get("metric"), row.get("unit"),
            row.get("key"))


def _device_matches(a: Optional[Dict], b: Optional[Dict], match: str) -> bool:
    if match == "any":
        return True
    a, b = a or {}, b or {}
    if match == "platform":
        return a.get("platform") == b.get("platform")
    return a == b  # "device": the full fingerprint


def _match_level(unit: str, match: str) -> str:
    """Deterministic-unit rows relax a ``device`` match to ``platform``
    (their values don't depend on the machine's clock); explicit
    ``platform``/``any`` requests are honored as given."""
    if match == "device" and unit in DETERMINISTIC_UNITS:
        return "platform"
    return match


def _median(values: List[float]) -> float:
    xs = sorted(values)
    mid = len(xs) // 2
    return xs[mid] if len(xs) % 2 else (xs[mid - 1] + xs[mid]) / 2


def evaluate(
    records: Sequence[Dict[str, Any]],
    *,
    tolerance: Optional[float] = None,
    window: int = DEFAULT_WINDOW,
    match: str = "device",
) -> Dict[str, Any]:
    """Judge the LAST record against the rolling reference built from the
    records before it.  Returns ``{"rows": [verdict...], "regressed": bool,
    "candidate": {...}, "reference_records": n}``; verdict statuses are
    ``ok`` / ``improved`` / ``regressed`` / ``failed`` (the row failed where
    its reference succeeded) / ``new`` (no reference — vacuous pass) /
    ``missing`` (a same-config reference row the candidate no longer
    carries — a renamed or dropped bench row must fail the gate loudly,
    never silently weaken it to a vacuous pass).  Each verdict carries the
    reference median (``ref``), the SIGNED absolute delta (``delta``, in
    the row's own unit) and percentage delta alongside the status, plus
    the candidate row's ``latency`` decomposition when the ledger record
    has one — so ``obs why`` and CI artifacts consume one schema."""
    if not records:
        raise ValueError("empty ledger: nothing to evaluate")
    candidate = records[-1]
    cand_config = candidate.get("config")
    cand_dev = candidate.get("device")
    levels = {"device", "platform"} if match == "device" else {match}
    # device-filtered but NOT window-sliced: the window applies per row
    # identity below — slicing here would let recent OTHER-config records
    # evict a row's true references and quietly turn the gate vacuous
    priors = {
        level: [r for r in records[:-1]
                if _device_matches(r.get("device"), cand_dev, level)]
        for level in levels
    }
    verdicts = []
    regressed = False
    cand_idents = set()
    for row in candidate.get("rows", []):
        unit = row.get("unit") or ""
        ident = _row_identity(cand_config, row)
        cand_idents.add(ident)
        refs = [
            pr["value"]
            for rec in priors[_match_level(unit, match)]
            for pr in rec.get("rows", [])
            if _row_identity(rec.get("config"), pr) == ident
            and isinstance(pr.get("value"), (int, float))
            and not pr.get("failed") and not pr.get("skipped")
        ][-window:]
        band = (
            tolerance if tolerance is not None
            else BAND_BY_UNIT.get(unit, DEFAULT_BAND)
        )
        verdict = {
            "row": row.get("row"),
            "unit": unit,
            "value": row.get("value"),
            "ref": round(_median(refs), 4) if refs else None,
            "refs": len(refs),
            "band_pct": round(band * 100, 1),
            "delta": None,
            "delta_pct": None,
            "status": "new",
        }
        if isinstance(row.get("latency"), dict):
            verdict["latency"] = row["latency"]
        if refs:
            ref = _median(refs)
            value = row.get("value")
            if row.get("failed") or not isinstance(value, (int, float)):
                verdict["status"] = "failed"
                regressed = True
            else:
                direction = DIRECTION_BY_UNIT.get(unit, +1)
                delta = (value - ref) / ref if ref else 0.0
                verdict["delta"] = round(value - ref, 4)
                verdict["delta_pct"] = round(delta * 100, 1)
                shortfall = -delta * direction  # >0 = worse, whatever the unit
                if shortfall > band:
                    verdict["status"] = "regressed"
                    regressed = True
                elif delta * direction > band:
                    verdict["status"] = "improved"
                else:
                    verdict["status"] = "ok"
        verdicts.append(verdict)
    # reference rows the candidate dropped: only SAME-CONFIG references
    # count (a single-mode record appended to a ladder ledger is a new
    # config, not a mass row-drop), each judged at its own unit's level
    missing_seen = set(cand_idents)
    for level in sorted(levels):
        same_config = [r for r in priors[level]
                       if r.get("config") == cand_config][-window:]
        for rec in same_config:
            for pr in rec.get("rows", []):
                unit = pr.get("unit") or ""
                if _match_level(unit, match) != level:
                    continue
                ident = _row_identity(rec.get("config"), pr)
                if ident in missing_seen:
                    continue
                missing_seen.add(ident)
                verdicts.append({
                    "row": pr.get("row"),
                    "unit": unit,
                    "value": None,
                    "ref": pr.get("value"),
                    "refs": 1,
                    "band_pct": round(
                        (tolerance if tolerance is not None
                         else BAND_BY_UNIT.get(unit, DEFAULT_BAND)) * 100, 1),
                    "delta": None,
                    "delta_pct": None,
                    "status": "missing",
                })
                regressed = True
    return {
        "rows": verdicts,
        "regressed": regressed,
        "candidate": {
            "sha": candidate.get("sha"),
            "config": cand_config,
            "device": cand_dev,
        },
        "reference_records": max(len(p) for p in priors.values()),
    }
