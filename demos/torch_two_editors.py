#!/usr/bin/env python
"""Two-editor demo on the PyTorch/CUDA port (headless analog of the
reference ``src/index.ts``).

Two collaborative editors, alice and bob, edit concurrently; changes buffer
in per-editor outbound queues and only cross when you sync — exactly the
reference demo's manual Sync button (src/index.ts:122-126).  This script
scripts a short session and prints each editor's text, span structure, and
the structured change log at every stage.

Run: python demos/torch_two_editors.py [--backend scalar|tpu] [--device D]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from peritext_tpu_torch.bridge import EditorEvent, create_editor, initialize_docs
from peritext_tpu_torch.bridge.commands import (
    add_comment,
    set_link,
    toggle_bold,
    toggle_italic,
    type_text,
)
from peritext_tpu_torch.parallel.pubsub import Publisher


def render(editor) -> str:
    parts = []
    for span in editor.view.spans():
        text, marks = span["text"], span["marks"]
        if not marks:
            parts.append(text)
        else:
            names = ",".join(sorted(marks))
            parts.append(f"[{text}]({names})")
    return "".join(parts)


def show(editors, label) -> None:
    print(f"\n== {label} ==")
    for editor in editors:
        print(f"  {editor.actor_id}: {render(editor)}")


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--backend", choices=("scalar", "tpu"), default="scalar",
        help="merge backend for the editor views: 'tpu' drives them from the "
             "batched device engine's incremental patch stream",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device of the 'tpu' backend's sessions (default cuda; "
             "raises without a card)",
    )
    args = parser.parse_args(argv)

    events = []
    publisher = Publisher()
    kw = dict(on_event=events.append)
    if args.backend == "tpu":
        kw.update(backend="tpu", actors=("alice", "bob"),
                  backend_config={"device": args.device})
    alice = create_editor("alice", publisher, **kw)
    bob = create_editor("bob", publisher, **kw)
    initialize_docs([alice, bob], "The Peritext editor")
    show([alice, bob], f"seeded (shared origin change; {args.backend} backend)")

    # concurrent edits: nothing crosses until a sync
    type_text(alice, 1, "Hey! ")
    toggle_bold(bob, 5, 13)
    show([alice, bob], "concurrent edits, not yet synced")

    alice.sync()
    bob.sync()
    show([alice, bob], "after sync")

    # overlapping formatting + a link + a comment, then partition bob
    toggle_italic(alice, 10, 24)
    set_link(bob, 14, 22, "https://www.inkandswitch.com/peritext/")
    bob.disconnect()
    type_text(bob, 1, "(offline) ")
    show([alice, bob], "bob offline with local edits")

    alice.sync()
    bob.sync()  # manual flush still works after drop()
    add_comment(alice, 1, 10, comment_id="c-demo")
    alice.sync()
    show([alice, bob], "after reconnect + comment")

    assert alice.view == bob.view, "editors diverged!"
    print("\nconverged: both editors show identical marked text")
    print(f"events logged: {len(events)}")
    for ev in events[-4:]:
        print(f"  {ev.actor}: {ev.kind} {ev.detail}")


if __name__ == "__main__":
    main()
