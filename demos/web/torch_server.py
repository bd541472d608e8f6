#!/usr/bin/env python
"""Two live editors against the PyTorch/CUDA port's device merge backend,
in a browser.

The reference ships its two-editor demo on ProseMirror in the browser
(its ``src/index.ts:122-126``, ``index.html:41``).  This is the framework's
equivalent: a dependency-free page (demos/web/index.html) with two editable
panes talking to this server, which hosts two ``bridge.Editor`` instances on
the port's ``tpu`` backend (a one-doc ``StreamingMerge`` per editor on the
card) sharing an in-memory ``Publisher`` — the exact replication topology of
the reference demo, including the manual Sync button (changes queue locally
until synced, then anti-entropy merges both ways).

Run:  python demos/web/torch_server.py [--port 8700] [--backend tpu|scalar]
      [--device D]
then open http://localhost:8700/
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from peritext_tpu_torch.bridge.bridge import create_editor, initialize_docs
from peritext_tpu_torch.parallel.pubsub import Publisher

_HERE = Path(__file__).parent


def describe_op(editor: str, op: dict) -> str:
    """One-line op description for the debug log panel (the reference
    renders the same log into the demo DOM — ``describeOp``,
    src/bridge.ts:96-110, ``outputDebugForChange`` :235-242)."""
    action = op.get("action")
    if action == "insert":
        return f'{editor}: insert {"".join(op.get("values", []))!r} at {op.get("index")}'
    if action == "delete":
        return f'{editor}: delete {op.get("count")} at {op.get("index")}'
    if action in ("addMark", "removeMark"):
        attrs = op.get("attrs")
        extra = f" {attrs}" if attrs else ""
        return (f'{editor}: {action} {op.get("markType")} '
                f'[{op.get("startIndex")}, {op.get("endIndex")}){extra}')
    return f"{editor}: {action}"


class Session:
    """The two editors plus a lock (bridge editors are single-threaded)."""

    def __init__(self, backend: str = "tpu", device=None) -> None:
        """``device``: the torch device of the ``tpu`` backend's sessions
        (``None``: ``cuda``, which raises without a card)."""
        self.lock = threading.Lock()
        self.pub = Publisher()
        self.oplog: list = []
        actors = ("alice", "bob", "init")
        kw = {"backend": backend, "actors": actors}
        if backend == "tpu" and device is not None:
            kw["backend_config"] = {"device": device}
        self.editors = {
            "alice": create_editor("alice", self.pub, **kw),
            "bob": create_editor("bob", self.pub, **kw),
        }
        initialize_docs(
            [self.editors["alice"], self.editors["bob"]],
            "The Peritext editor",
        )

    def state(self) -> dict:
        return {
            **{
                name: {
                    "spans": ed.view.spans(),
                    "pending": len(ed.queue) if hasattr(ed, "queue") else 0,
                }
                for name, ed in self.editors.items()
            },
            "oplog": list(self.oplog),
        }

    def _log(self, line: str) -> None:
        self.oplog.append(line)
        del self.oplog[:-12]

    def dispatch(self, editor: str, ops) -> None:
        self.editors[editor].dispatch_input_ops(ops)
        for op in ops:
            self._log(describe_op(editor, op))

    def sync(self) -> None:
        had_pending = any(len(ed.queue) for ed in self.editors.values())
        for ed in self.editors.values():
            ed.sync()
        if had_pending:  # auto-sync no-ops must not flush real ops out of the log
            self._log("-- sync: queues flushed both ways --")


SESSION: Session = None  # set in main()


class Handler(BaseHTTPRequestHandler):
    def _json(self, payload, status=200):
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path in ("/", "/index.html"):
            body = (_HERE / "index.html").read_bytes()
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
                if self.path == "/op":
                    SESSION.dispatch(payload["editor"], payload["ops"])
                elif self.path == "/sync":
                    SESSION.sync()
                else:
                    self._json({"error": "not found"}, 404)
                    return
                self._json(SESSION.state())
        except Exception as exc:  # surface editor errors to the page
            self._json({"error": repr(exc)}, 400)

    def log_message(self, fmt, *args):  # quiet
        pass


def main() -> None:
    global SESSION
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--port", type=int, default=8700)
    parser.add_argument("--backend", default="tpu", choices=("tpu", "scalar"))
    parser.add_argument("--device", default="cuda",
                        help="torch device of the tpu backend (default cuda; raises without "
                             "a card)")
    args = parser.parse_args()
    SESSION = Session(backend=args.backend, device=args.device)
    server = ThreadingHTTPServer(("127.0.0.1", args.port), Handler)
    print(f"two-editor demo ({args.backend} backend): http://127.0.0.1:{args.port}/")
    server.serve_forever()


if __name__ == "__main__":
    main()
