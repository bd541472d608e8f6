#!/usr/bin/env python
"""Scripted playback demo on the PyTorch/CUDA port's bridge (headless
analog of the reference ``src/essay-demo.ts`` +
``src/essay-demo-content.ts``).

Plays a scripted trace through two editors: simulated per-keystroke typing,
concurrent formatting that overlaps after sync, conflicting links resolved
last-writer-wins, and co-existing comments.  Remote changes are highlighted
the way the reference's essay embed flashes them (``highlightRemoteChanges``,
src/essay-demo.ts:47-75): the receiving editor records the affected range and
the renderer shows it underlined.

Run:  python demos/torch_essay_demo.py [--realtime] [--loop N] [--short]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from peritext_tpu_torch.bridge import create_editor
from peritext_tpu_torch.bridge.playback import (
    execute_trace_event,
    simulate_typing_for_input_op,
    trace_from_spec,
)
from peritext_tpu_torch.core.doc import CONTENT_KEY
from peritext_tpu_torch.parallel.pubsub import Publisher

ANSI = {
    "strong": "\x1b[1m",
    "em": "\x1b[3m",
    "link": "\x1b[36m",
    "comment": "\x1b[43m",
    "highlight": "\x1b[4m",
    "reset": "\x1b[0m",
}


def build_trace():
    """The demo script: each section exercises one Peritext behavior."""
    trace = [
        {"editorId": "alice", "path": [], "action": "makeList", "key": CONTENT_KEY, "delay": 0},
        {"action": "sync", "delay": 0},
    ]

    def typing(editor_id, index, text):
        return simulate_typing_for_input_op(
            editor_id, {"action": "insert", "index": index, "values": list(text)}
        )

    # 1. typing syncs live between the two editors
    trace += typing("alice", 0, "Formatting survives concurrent edits.")
    trace.append({"action": "sync"})
    # 2. concurrent bold and italic overlap cleanly after sync
    #     0123456789012345678901234567890123456
    trace += [
        {"editorId": "alice", "action": "addMark", "path": [CONTENT_KEY],
         "startIndex": 0, "endIndex": 10, "markType": "strong"},
        {"editorId": "bob", "action": "addMark", "path": [CONTENT_KEY],
         "startIndex": 5, "endIndex": 19, "markType": "em"},
        {"action": "sync"},
    ]
    # 3. concurrent overlapping links: one writer wins deterministically
    trace += [
        {"editorId": "alice", "action": "addMark", "path": [CONTENT_KEY],
         "startIndex": 20, "endIndex": 30, "markType": "link",
         "attrs": {"url": "https://crdt.tech"}},
        {"editorId": "bob", "action": "addMark", "path": [CONTENT_KEY],
         "startIndex": 25, "endIndex": 36, "markType": "link",
         "attrs": {"url": "https://inkandswitch.com"}},
        {"action": "sync"},
    ]
    # 4. comments co-exist where links conflict
    trace += [
        {"editorId": "alice", "action": "addMark", "path": [CONTENT_KEY],
         "startIndex": 0, "endIndex": 10, "markType": "comment",
         "attrs": {"id": "comment-alice"}},
        {"editorId": "bob", "action": "addMark", "path": [CONTENT_KEY],
         "startIndex": 5, "endIndex": 19, "markType": "comment",
         "attrs": {"id": "comment-bob"}},
        {"action": "sync"},
        {"action": "restart"},
    ]
    return trace


def make_editors(publisher, highlights):
    def on_remote_patch(editor, patch):
        # record flashed ranges like the essay embed's highlight marks
        if patch["action"] == "insert":
            highlights[editor.actor_id] = (patch["index"], patch["index"] + len(patch["values"]))
        elif "startIndex" in patch:
            highlights[editor.actor_id] = (patch["startIndex"], patch["endIndex"])

    return {
        name: create_editor(name, publisher, on_remote_patch=on_remote_patch)
        for name in ("alice", "bob")
    }


def render(editor, highlight=None) -> str:
    out, index = [], 0
    for span in editor.view.spans():
        codes = "".join(ANSI[m] for m in sorted(span["marks"]) if m in ANSI)
        for ch in span["text"]:
            h = ANSI["highlight"] if highlight and highlight[0] <= index < highlight[1] else ""
            out.append(f"{codes}{h}{ch}{ANSI['reset']}" if (codes or h) else ch)
            index += 1
    return "".join(out)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--realtime", action="store_true", help="honor event delays")
    parser.add_argument("--loop", type=int, default=1, help="play the trace N times")
    parser.add_argument(
        "--short", action="store_true",
        help="play the short pedagogical trace instead of the full scripted "
             "essay session (demos/torch_essay_content.py)",
    )
    args = parser.parse_args(argv)

    publisher = Publisher()
    highlights = {}
    editors = make_editors(publisher, highlights)

    if args.short:
        section_names = ["typing", "concurrent bold+italic overlap",
                         "conflicting links (LWW)", "comments co-exist"]
    else:
        from torch_essay_content import ESSAY_SECTIONS

        section_names = ESSAY_SECTIONS
    sections = iter(section_names)

    def on_sync():
        label = next(sections, "sync")
        print(f"\n-- sync: {label} --")
        # flush happens after this hook, so render post-event below

    if args.short:
        trace = build_trace()
    else:
        from torch_essay_content import build_essay_trace

        trace = build_essay_trace()
    for _ in range(args.loop):
        for event in trace:
            execute_trace_event(event, editors, on_sync=on_sync, realtime=args.realtime)
            if event.get("action") == "sync":
                for name, editor in editors.items():
                    print(f"  {name}: {render(editor, highlights.get(name))}")

    alice, bob = editors["alice"], editors["bob"]
    assert alice.view == bob.view, "demo editors diverged"
    link_urls = {
        str(m.get("link", {}).get("url"))
        for m in alice.view.marks
        if "link" in m
    }
    print(f"\nconverged. winning link(s): {sorted(link_urls)}")
    print("spans:", alice.view.spans())


if __name__ == "__main__":
    main()
