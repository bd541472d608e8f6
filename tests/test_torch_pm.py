"""The port's ProseMirror JSON codec (``peritext_tpu_torch.bridge.pm``) and
the presentation half of its schema, against the JAX package's, on the CPU.

Every step, mark set and document goes through both codecs, both ways:
the JSON each emits must be equal, and each must parse the other's.  The
nine ``tests/pm_fixtures`` sessions replay through the port's editors on
both backends (the ``"tpu"`` one with ``backend_config={"device": "cpu"}``),
as ``tests/test_pm_conformance.py`` replays them through the reference's.
"""

import dataclasses
import json
from pathlib import Path

import pytest

from peritext_tpu import schema as ref_schema
from peritext_tpu.bridge import model as ref_model
from peritext_tpu.bridge import pm as ref_pm
from peritext_tpu_torch import schema
from peritext_tpu_torch.bridge import model
from peritext_tpu_torch.bridge import pm
from peritext_tpu_torch.bridge.bridge import (
    create_editor,
    editor_doc_from_crdt,
    initialize_docs,
    patch_to_steps,
)
from peritext_tpu_torch.core.doc import Doc
from peritext_tpu_torch.parallel.causal import causal_sort
from peritext_tpu_torch.parallel.pubsub import Publisher

FIXTURES = sorted((Path(__file__).parent / "pm_fixtures").glob("*.json"))
ACTORS = ("alice", "bob")

STEPS = [
    ("ReplaceStep", (3, 3, "hi")),
    ("ReplaceStep", (1, 9)),
    ("ReplaceStep", (2, 5, "bold", {"strong": {"active": True}})),
    ("ReplaceStep", (4, 4, "x", {"link": {"active": True, "url": "https://a"}})),
    ("ReplaceStep", (1, 1, "c", {"comment": [{"id": "c1"}, {"id": "c2"}], "em": {"active": True}})),
    ("AddMarkStep", (1, 7, "strong")),
    ("AddMarkStep", (2, 9, "link", {"url": "https://a"})),
    ("AddMarkStep", (1, 4, "comment", {"id": "c1"})),
    ("RemoveMarkStep", (3, 6, "em")),
    ("RemoveMarkStep", (1, 4, "comment", {"id": "c1"})),
]

BAD = [
    {"stepType": "replaceAround", "from": 1, "to": 2},
    {"stepType": "replace", "from": 0, "to": 2},
    {"stepType": "replace", "from": 3, "to": 1},
    {"stepType": "replace", "from": 1, "to": 1, "slice": {"content": [{"type": "paragraph"}]}},
    {"stepType": "replace", "from": 1, "to": 1,
     "slice": {"content": [{"type": "text", "text": "x"}], "openStart": 1}},
    {"stepType": "replace", "from": 1, "to": 1, "slice": {"content": [
        {"type": "text", "text": "x"}, {"type": "text", "text": "y", "marks": [{"type": "em"}]}]}},
    {"stepType": "addMark", "from": 1, "to": 2, "mark": {"attrs": {}}},
    {"stepType": "addMark", "from": 1, "to": 2, "mark": {"type": "blink"}},
    "not a step",
]


def _key(step):
    return type(step).__name__, dataclasses.astuple(step)


@pytest.mark.parametrize("kind,args", STEPS, ids=[f"{k}{i}" for i, (k, _) in enumerate(STEPS)])
def test_steps_both_ways(kind, args):
    ours, theirs = getattr(model, kind)(*args), getattr(ref_model, kind)(*args)
    js, ref_js = pm.step_to_pm(ours), ref_pm.step_to_pm(theirs)
    assert js == ref_js
    # each codec parses the other's JSON into the same step
    assert _key(pm.step_from_pm(ref_js)) == _key(ref_pm.step_from_pm(js))
    assert pm.step_to_pm(pm.step_from_pm(ref_js)) == js
    doc, ref_doc = model.EditorDoc(), ref_model.EditorDoc()
    doc.insert_at(0, "hello world brave")
    ref_doc.insert_at(0, "hello world brave")
    ours.apply(doc)
    theirs.apply(ref_doc)
    assert (doc.chars, doc.marks) == (ref_doc.chars, ref_doc.marks)
    assert pm.editor_doc_to_pm(doc) == ref_pm.editor_doc_to_pm(ref_doc)


@pytest.mark.parametrize("bad", BAD, ids=range(len(BAD)))
def test_malformed_rejected_like_reference(bad):
    with pytest.raises(ref_pm.PMFormatError):
        ref_pm.step_from_pm(bad)
    with pytest.raises(pm.PMFormatError):
        pm.step_from_pm(bad)
    assert issubclass(pm.PMFormatError, ValueError)


def test_reset_step_has_no_pm_form():
    with pytest.raises(pm.PMFormatError):
        pm.step_to_pm(model.ResetStep())


@pytest.mark.parametrize("marks", [
    {},
    {"strong": {"active": True}, "link": {"active": True, "url": "https://a"},
     "comment": [{"id": "c1"}, {"id": "c2"}]},
    {"em": {"active": True}, "comment": [{"id": "z"}]},
])
def test_mark_sets_both_ways(marks):
    js = pm.marks_to_pm(marks)
    assert js == ref_pm.marks_to_pm(marks)
    assert pm.marks_from_pm(js) == ref_pm.marks_from_pm(js)
    assert pm.marks_from_pm(js) == marks


def test_add_to_set_semantics_like_reference():
    for pm_marks in ([{"type": "link", "attrs": {"url": "https://old"}},
                      {"type": "link", "attrs": {"url": "https://new"}}],
                     [{"type": "comment", "attrs": {"id": "c1"}},
                      {"type": "comment", "attrs": {"id": "c1"}},
                      {"type": "comment", "attrs": {"id": "c0"}}]):
        assert pm.marks_from_pm(pm_marks) == ref_pm.marks_from_pm(pm_marks)


def test_docs_both_ways():
    doc, ref_doc = model.EditorDoc(), ref_model.EditorDoc()
    for d in (doc, ref_doc):
        d.insert_at(0, "hello there")
        d.add_mark_at(0, 3, "strong", None)
        d.add_mark_at(2, 5, "link", {"url": "https://a"})
        d.add_mark_at(4, 9, "comment", {"id": "c9"})
    js = pm.editor_doc_to_pm(doc)
    assert js == ref_pm.editor_doc_to_pm(ref_doc)
    back, ref_back = pm.editor_doc_from_pm(js), ref_pm.editor_doc_from_pm(js)
    assert back == doc and (back.chars, back.marks) == (ref_back.chars, ref_back.marks)
    assert pm.editor_doc_to_pm(model.EditorDoc()) == ref_pm.editor_doc_to_pm(ref_model.EditorDoc())
    with pytest.raises(pm.PMFormatError):
        pm.editor_doc_from_pm({"type": "doc", "content": [{"type": "paragraph"}] * 2})


def test_presentation_schema_equals_reference():
    for mark in ("strong", "em", "comment", "link", "unknown"):
        assert schema.excludes_of(mark) == ref_schema.excludes_of(mark)
        for attrs in (None, {"url": "https://a"}, {"id": "c1"}):
            assert schema.mark_to_dom(mark, attrs) == ref_schema.mark_to_dom(mark, attrs)
    for name, spec in schema.MARK_SPEC.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(ref_schema.MARK_SPEC[name])


def test_add_mark_to_map_equals_reference():
    ours, theirs = {}, {}
    for mark, attrs in (("link", {"url": "https://old"}), ("strong", None),
                        ("link", {"url": "https://new"}), ("comment", {"id": "c2"}),
                        ("comment", {"id": "c1"}), ("comment", {"id": "c2"})):
        ours = model._add_mark_to_map(ours, mark, attrs)
        theirs = ref_model._add_mark_to_map(theirs, mark, attrs)
        assert ours == theirs
    for mark, attrs in (("comment", {"id": "c1"}), ("link", None), ("comment", None)):
        ours = model._remove_mark_from_map(ours, mark, attrs)
        theirs = ref_model._remove_mark_from_map(theirs, mark, attrs)
        assert ours == theirs


def replay_fixture(spec, backend):
    pub = Publisher()
    kwargs = ({"backend": "tpu", "actors": ACTORS, "backend_config": {"device": "cpu"}}
              if backend == "tpu" else {})
    editors = {name: create_editor(name, pub, **kwargs) for name in ACTORS}
    changes = [initialize_docs(list(editors.values()), spec["initial"])]
    for event in spec["events"]:
        if event.get("sync"):
            for ed in editors.values():
                ed.sync()
            continue
        changes.append(editors[event["editor"]].dispatch(pm.transaction_from_pm(event["steps"])))
    for ed in editors.values():
        ed.sync()
    return editors, changes


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.stem)
@pytest.mark.parametrize("backend", ["scalar", "tpu"])
def test_fixture_sessions_converge(path, backend):
    spec = json.loads(path.read_text())
    editors, changes = replay_fixture(spec, backend)
    views = {n: pm.editor_doc_to_pm(ed.view) for n, ed in editors.items()}
    assert views["alice"] == views["bob"] == spec["expected_doc"]
    assert editors["alice"].text == spec["expected_text"]
    for ed in editors.values():
        assert ed.view == editor_doc_from_crdt(ed.doc)
        assert ed.session is None or not ed.session.docs[0].fallback
    if backend == "scalar":
        # every patch an observer receives serializes to PM step JSON equal
        # to the reference codec's, and the observer renders the fixture's doc
        observer = Doc("observer")
        for ch in causal_sort(changes):
            for patch in observer.apply_change(ch):
                for step in patch_to_steps(patch):
                    if not isinstance(step, model.ResetStep):
                        args = dataclasses.astuple(step)
                        ref_step = getattr(ref_model, type(step).__name__)(*args)
                        assert pm.step_to_pm(step) == ref_pm.step_to_pm(ref_step)
        assert pm.editor_doc_to_pm(editor_doc_from_crdt(observer)) == spec["expected_doc"]
