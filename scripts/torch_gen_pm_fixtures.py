#!/usr/bin/env python3
"""Generate the ProseMirror conformance fixtures, the port's twin of
``scripts/gen_pm_fixtures.py``.

Each scenario's EDITS are authored directly in ProseMirror's wire schema
(``Step.toJSON()``, the JSON a real PM client posts through the bridge);
this script replays them through two bridged editors of the port
(``peritext_tpu_torch.bridge``, scalar backend, over a
``parallel/pubsub.Publisher``) and records the converged document as
``Node.toJSON()`` of the reference schema, one ``<scenario>.json`` per
scenario in ``--out``.  Its output must equal the checked-in
``tests/pm_fixtures/`` byte for byte; it writes only to ``--out`` and
refuses that directory.  Host work only: no device.

    python3 scripts/torch_gen_pm_fixtures.py --out /tmp/pm_fixtures
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: the checked-in fixtures this script never overwrites
FIXTURES = ROOT / "tests" / "pm_fixtures"

INITIAL = "The Peritext editor"


def replace(frm, to, text=None, marks=None):
    step = {"stepType": "replace", "from": frm, "to": to}
    if text:
        node = {"type": "text", "text": text}
        if marks:
            node["marks"] = marks
        step["slice"] = {"content": [node]}
    return step


def add_mark(frm, to, mark_type, attrs=None):
    mark = {"type": mark_type}
    if attrs:
        mark["attrs"] = attrs
    return {"stepType": "addMark", "from": frm, "to": to, "mark": mark}


def remove_mark(frm, to, mark_type, attrs=None):
    mark = {"type": mark_type}
    if attrs:
        mark["attrs"] = attrs
    return {"stepType": "removeMark", "from": frm, "to": to, "mark": mark}


def typing(editor, pos, text):
    """Per-keystroke replace steps (how PM delivers real typing)."""
    return [
        {"editor": editor, "steps": [replace(pos + i, pos + i, ch)]}
        for i, ch in enumerate(text)
    ]


SCENARIOS = {
    # interactive typing from both sides, merged mid-stream
    "typing": {
        "initial": INITIAL,
        "events": (
            typing("alice", 20, " rocks")
            + [{"sync": True}]
            + typing("bob", 1, ">> ")      # bob at the front...
            + typing("alice", 26, "!")     # ...alice at the end, unsynced
            + [{"sync": True}]
        ),
    },
    # the reference's headline conflict: overlapping bold and italic
    "format_overlap": {
        "initial": INITIAL,
        "events": [
            {"editor": "alice", "steps": [add_mark(1, 13, "strong")]},
            {"editor": "bob", "steps": [add_mark(5, 20, "em")]},
            {"sync": True},
        ],
    },
    # concurrent links over an overlap: one winner per character (LWW)
    "link_conflict": {
        "initial": INITIAL,
        "events": [
            {"editor": "alice",
             "steps": [add_mark(1, 10, "link", {"url": "https://inkandswitch.com"})]},
            {"editor": "bob",
             "steps": [add_mark(5, 15, "link", {"url": "https://example.org"})]},
            {"sync": True},
        ],
    },
    # comments are an id-keyed set: concurrent adds coexist, removal by id
    "comments": {
        "initial": INITIAL,
        "events": [
            {"editor": "alice", "steps": [add_mark(1, 8, "comment", {"id": "c-alice"})]},
            {"editor": "bob", "steps": [add_mark(4, 12, "comment", {"id": "c-bob"})]},
            {"sync": True},
            {"editor": "alice", "steps": [remove_mark(1, 8, "comment", {"id": "c-alice"})]},
            {"sync": True},
        ],
    },
    # select-and-type (content-bearing ReplaceStep) vs a concurrent delete
    "replace_selection": {
        "initial": INITIAL,
        "events": [
            {"editor": "bob", "steps": [replace(5, 13, "Micromerge")]},
            {"editor": "alice", "steps": [replace(1, 5, "")]},
            {"sync": True},
        ],
    },
    # unbold a sub-range while the other side types inside the bold span
    "unbold_while_typing": {
        "initial": INITIAL,
        "events": [
            {"editor": "alice", "steps": [add_mark(1, 13, "strong")]},
            {"sync": True},
            {"editor": "bob", "steps": [remove_mark(4, 9, "strong")]},
            *typing("alice", 5, "xy"),
            {"sync": True},
        ],
    },
    # marked typing: PM sends the stored-marks set inside the replace slice
    "typing_with_marks": {
        "initial": INITIAL,
        "events": [
            {"editor": "alice", "steps": [add_mark(1, 4, "strong")]},
            {"sync": True},
            {"editor": "bob",
             "steps": [replace(4, 4, "se", [{"type": "strong"}])]},
            {"sync": True},
        ],
    },
    # replace-with-content ON a marked range (delete+insert through the
    # bridge, reference src/bridge.ts:428-444) while the other side types
    # inside the same bold span
    "replace_marked_range": {
        "initial": INITIAL,
        "events": [
            {"editor": "alice", "steps": [add_mark(1, 13, "strong")]},
            {"sync": True},
            {"editor": "bob",
             "steps": [replace(4, 9, "plain")]},
            *typing("alice", 6, "zz"),
            {"sync": True},
        ],
    },
    # removeMark whose range spans text a concurrent editor deleted — the
    # anchors must resolve against the CRDT positions, not the PM indices
    "removemark_spanning_deletion": {
        "initial": INITIAL,
        "events": [
            {"editor": "alice", "steps": [add_mark(1, 16, "strong")]},
            {"sync": True},
            {"editor": "alice", "steps": [replace(5, 10, "")]},
            {"editor": "bob", "steps": [remove_mark(3, 14, "strong")]},
            {"sync": True},
        ],
    },
}

# External provenance per fixture: the step/doc JSON SHAPES follow
# prosemirror-transform's published wire schema (Step.toJSON:
# stepType/from/to + slice{content|openStart|openEnd} for ReplaceStep,
# mark{type,attrs} for Add/RemoveMarkStep) and prosemirror-model's
# Node.toJSON; each entry names the documented upstream construct the
# scenario mirrors (the strings are part of the fixtures' bytes), and the
# expected documents are pinned by replaying the steps through the bridge.
SOURCES = {
    "typing": "prosemirror-transform ReplaceStep one-char insert shape "
              "(tr.insertText -> Step.toJSON, PM ref manual); scenario: "
              "reference two-editors demo typing loop",
    "format_overlap": "AddMarkStep shape per prosemirror-transform "
                      "Step.toJSON; scenario: Peritext paper fig. 'bold "
                      "vs italic overlap' (reference essay.tsx)",
    "link_conflict": "AddMarkStep with attrs per prosemirror-transform; "
                     "scenario: Peritext paper link-conflict example "
                     "(reference src/schema.ts link allowMultiple=false)",
    "comments": "AddMark/RemoveMarkStep with id attrs; scenario: reference "
                "comment sidebar (src/schema.ts comment allowMultiple)",
    "replace_selection": "ReplaceStep select-and-type + pure-delete shapes "
                         "(prosemirror-transform tr.replaceWith/tr.delete "
                         "Step.toJSON)",
    "unbold_while_typing": "RemoveMarkStep sub-range shape; scenario: "
                           "Peritext paper unbold-while-typing example",
    "typing_with_marks": "ReplaceStep slice with marks (PM storedMarks "
                         "typing emits marked text nodes in the slice)",
    "replace_marked_range": "ReplaceStep with content over a marked range "
                            "(delete+insert, reference src/bridge.ts:"
                            "428-444); round-4 review gap",
    "removemark_spanning_deletion": "RemoveMarkStep spanning a concurrent "
                                    "deletion; round-4 review gap",
}


def run_scenario(spec):
    from peritext_tpu_torch.bridge.bridge import create_editor, initialize_docs
    from peritext_tpu_torch.bridge.pm import editor_doc_to_pm, transaction_from_pm
    from peritext_tpu_torch.parallel.pubsub import Publisher

    pub = Publisher()
    editors = {
        "alice": create_editor("alice", pub),
        "bob": create_editor("bob", pub),
    }
    initialize_docs([editors["alice"], editors["bob"]], spec["initial"])
    for event in spec["events"]:
        if event.get("sync"):
            for ed in editors.values():
                ed.sync()
            continue
        ed = editors[event["editor"]]
        ed.dispatch(transaction_from_pm(event["steps"]))
    for ed in editors.values():
        ed.sync()
    views = {name: editor_doc_to_pm(ed.view) for name, ed in editors.items()}
    assert views["alice"] == views["bob"], "scenario did not converge"
    return views["alice"], editors["alice"].text


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", default="pm_fixtures", help="directory to write")
    args = parser.parse_args(argv)
    out = Path(args.out)
    if out.resolve() == FIXTURES.resolve():
        print(f"torch_gen_pm_fixtures: refusing to overwrite the checked-in {out}",
              file=sys.stderr)
        return 2
    out.mkdir(parents=True, exist_ok=True)
    for name, spec in SCENARIOS.items():
        expected_doc, expected_text = run_scenario(spec)
        fixture = {"source": SOURCES[name], **spec}
        fixture["expected_doc"] = expected_doc
        fixture["expected_text"] = expected_text
        (out / f"{name}.json").write_text(json.dumps(fixture, indent=1) + "\n")
        print(f"{name}: {expected_text!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
