"""Flight recorder: a bounded ring of recent spans+events per session,
dumped as JSONL when something goes wrong.

The recorder keeps the last ``capacity`` telemetry records (finished spans
via :meth:`record_span`, wired as a :class:`~.spans.Tracer` sink, plus
structured fault events) and writes the whole ring to a JSONL file on
:meth:`fault` (quarantine, rollback; throttled) or an explicit
:meth:`dump`.  Each line is one JSON record; a ``kind: "dump"`` header
line carries the reason.

Fault dumps can carry INCIDENT CONTEXT beyond the ring: register a
provider with :meth:`add_context_provider` and every fault-triggered dump
appends its output as ``kind: "context"`` records.  The serve mux
registers one mapping a quarantine/rollback fault's ``doc`` to that doc's
recent admission-verdict tail, so a post-mortem sees the backpressure
picture around the incident, not just the span ring.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from pathlib import Path
from typing import Callable, Dict, List, Optional

#: process-wide dump numbering: several recorders sharing one dump_dir
#: (e.g. a crash-restored supervisor reusing <ckpt>/flight) must never
#: mint colliding default filenames — an overwritten dump is exactly the
#: post-mortem the recorder exists to preserve
_DUMP_IDS = itertools.count(1)


class FlightRecorder:
    """Bounded telemetry ring with fault-triggered JSONL dumps.

    ``dump_dir`` enables automatic dumps on :meth:`fault` (at most one per
    ``min_dump_interval`` seconds — a burst of quarantines produces one
    post-mortem, not a disk flood).  ``fsync=True`` fsyncs each dump before
    returning: the flight-recorder path exists for crashes, and a dump that
    dies in the page cache recorded nothing.
    """

    def __init__(self, capacity: int = 1024,
                 dump_dir: Optional[str | Path] = None,
                 fsync: bool = False,
                 min_dump_interval: float = 1.0,
                 host: Optional[str] = None) -> None:
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        #: host label minted into dump filenames
        #: (``flight-<host>-<pid>-<n>-<reason>.jsonl``) so a cross-host
        #: merge (:func:`~.incidents.merge_flight_dumps`) attributes every
        #: record WITHOUT parsing dump bodies
        self.host = host
        self.dump_dir = Path(dump_dir) if dump_dir is not None else None
        self.fsync = bool(fsync)
        self.min_dump_interval = float(min_dump_interval)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self._seq = 0
        self._last_auto_dump: Optional[float] = None
        self.faults = 0
        self.dumps = 0
        self.last_dump_path: Optional[Path] = None
        #: name -> fn(fault_fields) returning a dict, a list of dicts, or
        #: None; outputs land in fault dumps as ``kind: "context"`` records
        self._context_providers: Dict[str, Callable] = {}

    # -- recording -----------------------------------------------------------

    def record(self, kind: str, **fields) -> Dict:
        """Append one structured record to the ring."""
        with self._lock:
            self._seq += 1
            rec = {"seq": self._seq, "ts": time.time(), "kind": kind, **fields}
            self._ring.append(rec)
        return rec

    def record_span(self, span) -> None:
        """Tracer-sink form: ``tracer.add_sink(recorder.record_span)``."""
        self.record("span", **span.to_json())

    def add_context_provider(self, name: str, fn: Callable) -> None:
        """Register ``fn(fault_fields) -> dict | list[dict] | None`` to be
        consulted on every fault-triggered dump; its output is appended to
        the dump as ``kind: "context"`` records labelled ``provider=name``.
        Re-registering a name replaces the provider (a rebuilt mux swaps
        its hook in place)."""
        with self._lock:
            self._context_providers[name] = fn

    def fault(self, reason: str, **fields) -> Dict:
        """Record a fault event and (when a ``dump_dir`` is configured)
        dump the ring — the quarantine/rollback/transport-give-up hook.
        The fault's fields are offered to every context provider, so the
        dump carries the incident's surroundings (e.g. the affected doc's
        admission-verdict tail), not just the telemetry ring."""
        self.faults += 1
        rec = self.record("fault", reason=reason, **fields)
        if self.dump_dir is not None:
            now = time.monotonic()
            if (self._last_auto_dump is None
                    or now - self._last_auto_dump >= self.min_dump_interval):
                self._last_auto_dump = now
                try:
                    self.dump(reason=reason, context=dict(fields))
                except OSError:
                    # a full or read-only disk must not turn a contained
                    # fault into a crash; the ring stays queryable in memory
                    pass
        return rec

    # -- dumping -------------------------------------------------------------

    def entries(self) -> List[Dict]:
        with self._lock:
            return list(self._ring)

    def _context_records(self, fields: Dict) -> List[Dict]:
        """Run every context provider against one fault's fields; cap the
        total so a runaway provider can't flood a dump."""
        with self._lock:
            providers = list(self._context_providers.items())
        out: List[Dict] = []
        for name, fn in providers:
            try:
                got = fn(fields)
            except Exception:  # graftlint: boundary(a broken provider must not lose the dump it decorates)
                continue
            if got is None:
                continue
            records = got if isinstance(got, list) else [got]
            for rec in records:
                if not isinstance(rec, dict):
                    continue
                # envelope keys WIN: a provider record carrying its own
                # ``kind`` (e.g. an admission verdict) must not break the
                # dump reader's kind=="context" filter
                out.append({**rec, "kind": "context", "provider": name})
                if len(out) >= 128:
                    return out
        return out

    def dump(self, path: Optional[str | Path] = None,
             reason: Optional[str] = None,
             context: Optional[Dict] = None) -> Path:
        """Write the ring to ``path`` (default: a fresh
        ``flight-<host>-<pid>-<n>-<reason>.jsonl`` under ``dump_dir``, where
        ``<n>`` is process-unique so recorders sharing the directory never
        overwrite each other's post-mortems) as JSONL; returns the path
        written.  ``context`` (the triggering fault's fields) activates the
        registered context providers, whose records are appended after the
        ring."""
        entries = self.entries()
        if context is not None:
            entries = entries + self._context_records(context)
        if path is None:
            if self.dump_dir is None:
                raise ValueError("no dump path given and no dump_dir configured")
            self.dump_dir.mkdir(parents=True, exist_ok=True)
            tag = (reason or "manual").replace("/", "_").replace(" ", "_")
            host = (self.host or "local").replace("/", "_").replace(" ", "_")
            path = self.dump_dir / (
                f"flight-{host}-{os.getpid()}-{next(_DUMP_IDS):06d}-{tag}.jsonl"
            )
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        header = {"kind": "dump", "ts": time.time(), "reason": reason,
                  "records": len(entries), "capacity": self.capacity}
        with open(path, "w") as f:
            f.write(json.dumps(header, default=str) + "\n")
            for rec in entries:
                f.write(json.dumps(rec, default=str) + "\n")
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        self.dumps += 1
        self.last_dump_path = path
        return path

    def snapshot(self) -> Dict:
        """Health-endpoint summary (JSON-serializable)."""
        with self._lock:
            size = len(self._ring)
        return {
            "capacity": self.capacity,
            "size": size,
            "faults": self.faults,
            "dumps": self.dumps,
            "last_dump": str(self.last_dump_path) if self.last_dump_path else None,
        }
