#!/usr/bin/env python
"""The scripted essay, playing in a browser on the PyTorch/CUDA port
(reference ``src/essay-demo.ts`` + ``essay-demo.html``).

The full-length authored two-author session (demos/torch_essay_content.py, 740
per-keystroke events across 9 sections) plays into two live editor panes:
remote changes FLASH in the receiving pane the way the reference's essay
embed highlights them (``highlightRemoteChanges``, src/essay-demo.ts:47-75),
a play/pause control drives an endless loop (:97-132), and a debug panel
streams per-event op descriptions (the reference renders the same log into
the demo DOM — ``describeOp``, src/bridge.ts:96-110).

The browser owns the clock: it polls ``POST /step {"n": k}`` to advance k
trace events (so play/pause/speed are purely client-side), and the server
replies with both panes' spans, the highlight ranges, the section banner,
and the op log.  When the trace ends the session restarts from a blank doc,
as the reference's endless loop does.

Run:  python demos/web/torch_essay_server.py [--port 8701] [--backend scalar|tpu] [--device D]
then open http://127.0.0.1:8701/
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # torch_essay_content
sys.path.insert(0, str(Path(__file__).resolve().parent))  # sibling torch_server.py

from torch_essay_content import ESSAY_SECTIONS, build_essay_trace  # noqa: E402
from torch_server import describe_op  # noqa: E402  (the shared op formatter)

from peritext_tpu_torch.bridge.bridge import create_editor  # noqa: E402
from peritext_tpu_torch.bridge.playback import execute_trace_event  # noqa: E402
from peritext_tpu_torch.parallel.pubsub import Publisher  # noqa: E402

_HERE = Path(__file__).parent


def describe_event(event: dict) -> str:
    """One-line TRACE-event description for the debug log: the shared op
    formatter (torch_server.describe_op, reference ``describeOp``
    src/bridge.ts:96-110) plus the trace-level sync/restart/makeList cases."""
    action = event.get("action")
    who = event.get("editorId", "")
    if action == "sync":
        return "-- sync: queues flushed both ways --"
    if action == "restart":
        return "-- restart --"
    if action == "makeList":
        return f'{who}: makeList {event.get("key")!r}'
    return describe_op(who, event)


class EssaySession:
    """Trace playback state: two editors, a cursor into the trace, the
    highlight ranges, and the rolling op log."""

    def __init__(self, backend: str = "scalar", device=None) -> None:
        """``device``: the torch device of the ``tpu`` backend's sessions
        (``None``: ``cuda``, which raises without a card)."""
        self.lock = threading.Lock()
        self.backend = backend
        self.device = device
        self.trace = build_essay_trace()
        self.loops = 0
        self._reset()

    def _reset(self) -> None:
        self.pub = Publisher()
        self.highlights: dict = {}
        self.oplog: list = []
        self.pos = 0
        self.sync_count = 0
        kw = {}
        if self.backend == "tpu":
            kw = {"backend": "tpu", "actors": ("alice", "bob")}
            if self.device is not None:
                kw["backend_config"] = {"device": self.device}

        def on_remote_patch(editor, patch):
            if patch["action"] == "insert":
                self.highlights[editor.actor_id] = (
                    patch["index"], patch["index"] + len(patch["values"]))
            elif "startIndex" in patch:
                self.highlights[editor.actor_id] = (
                    patch["startIndex"], patch["endIndex"])

        self.editors = {
            name: create_editor(name, self.pub, on_remote_patch=on_remote_patch, **kw)
            for name in ("alice", "bob")
        }

    def step(self, n: int) -> None:
        for _ in range(max(0, min(n, 200))):
            if self.pos >= len(self.trace):
                # endless loop: restart from a blank doc (reference
                # essay-demo.ts:97-132)
                self.loops += 1
                self._reset()
            event = self.trace[self.pos]
            self.pos += 1
            if event.get("action") == "sync":
                self.highlights.clear()  # flashes replaced by the new sync's
                self.sync_count += 1
            execute_trace_event(event, self.editors)
            self.oplog.append(describe_event(event))
        del self.oplog[:-12]

    def state(self) -> dict:
        section = ESSAY_SECTIONS[
            min(self.sync_count, len(ESSAY_SECTIONS)) - 1
        ] if self.sync_count else "warming up"
        return {
            "editors": {
                name: {"spans": ed.view.spans()} for name, ed in self.editors.items()
            },
            "highlights": dict(self.highlights),
            "section": section,
            "progress": {"event": self.pos, "total": len(self.trace),
                         "loops": self.loops},
            "oplog": list(self.oplog),
            "converged": self.editors["alice"].view == self.editors["bob"].view,
        }


SESSION: EssaySession = None  # set in main() / the test fixture


class Handler(BaseHTTPRequestHandler):
    def _json(self, payload, status=200):
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path in ("/", "/index.html", "/essay.html"):
            body = (_HERE / "essay.html").read_bytes()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/state":
            with SESSION.lock:
                self._json(SESSION.state())
        else:
            self._json({"error": "not found"}, 404)

    def do_POST(self):
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            with SESSION.lock:
                if self.path == "/step":
                    SESSION.step(int(payload.get("n", 1)))
                elif self.path == "/restart":
                    SESSION.loops += 1
                    SESSION._reset()
                else:
                    self._json({"error": "not found"}, 404)
                    return
                self._json(SESSION.state())
        except Exception as exc:  # surface playback errors to the page
            self._json({"error": repr(exc)}, 400)

    def log_message(self, fmt, *args):  # quiet
        pass


def main() -> None:
    global SESSION
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--port", type=int, default=8701)
    parser.add_argument(
        "--backend", default="scalar", choices=("scalar", "tpu"),
        help="merge backend for the two editors (identical semantics; "
             "scalar keeps per-keystroke playback snappy on CPU-only hosts)",
    )
    parser.add_argument("--device", default="cuda",
                        help="torch device of the tpu backend (default cuda; raises without "
                             "a card)")
    args = parser.parse_args()
    SESSION = EssaySession(backend=args.backend, device=args.device)
    server = ThreadingHTTPServer(("127.0.0.1", args.port), Handler)
    print(f"essay demo ({args.backend} backend): http://127.0.0.1:{args.port}/")
    server.serve_forever()


if __name__ == "__main__":
    main()
