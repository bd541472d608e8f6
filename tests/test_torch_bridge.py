"""The port's editor bridge (``peritext_tpu_torch.bridge``) against the JAX
package's, on the CPU.

The cases of ``tests/test_bridge.py`` and the seven patterns of
``tests/test_bridge_tpu.py`` run on the port's editors, the ``"tpu"``
backend with ``backend_config={"device": "cpu"}``.  The differential tests
drive the same transactions through the port's editors and the reference's
(each package's own editors, publisher and commands; every change crossed
through ``Change.to_json()``): changes, views, ``editor_doc_to_pm``, each
editor's ``read_patches`` stream and ``patch_to_steps`` of it must be
equal, exactly.  Also: the transport (``Publisher``, ``ChangeQueue``,
``FaultyPublisher``), comment bodies and the counter lock.  The two
longest sessions are in tests/test_torch_bridge_session.py.
"""

import copy
import dataclasses
import random
import threading
import time

import pytest
import torch

import peritext_tpu.bridge as ref_bridge
import peritext_tpu.bridge.commands as ref_commands
from peritext_tpu.bridge.pm import editor_doc_to_pm as ref_to_pm
from peritext_tpu.core import comment as ref_comment
from peritext_tpu.core.doc import Doc as RefDoc
from peritext_tpu.parallel.faults import FaultSpec as RefFaultSpec
from peritext_tpu.parallel.faults import FaultyPublisher as RefFaultyPublisher
from peritext_tpu.parallel.pubsub import Publisher as RefPublisher
from peritext_tpu_torch.bridge import (
    Editor,
    EditorDoc,
    Transaction,
    create_editor,
    editor_doc_from_crdt,
    initialize_docs,
    patch_to_steps,
    transaction_to_input_ops,
)
from peritext_tpu_torch.bridge import commands
from peritext_tpu_torch.bridge.commands import (
    add_comment,
    set_link,
    toggle_bold,
    type_text,
)
from peritext_tpu_torch.bridge.pm import editor_doc_to_pm
from peritext_tpu_torch.core import comment
from peritext_tpu_torch.core.doc import Doc
from peritext_tpu_torch.core.types import Change, span
from peritext_tpu_torch.obs import GLOBAL_COUNTERS, Counters
from peritext_tpu_torch.parallel.change_queue import ChangeQueue
from peritext_tpu_torch.parallel.faults import FaultSpec, FaultyPublisher
from peritext_tpu_torch.parallel.pubsub import Publisher

ACTORS = ("alice", "bob")
CPU = {"device": "cpu"}
BACKENDS = ["scalar", "tpu"]


def _kw(backend):
    return {"backend": "tpu", "actors": ACTORS, "backend_config": dict(CPU)} \
        if backend == "tpu" else {}


def make_pair(text="The Peritext editor", backends=("scalar", "scalar")):
    pub = Publisher()
    alice = create_editor("alice", pub, **_kw(backends[0]))
    bob = create_editor("bob", pub, **_kw(backends[1]))
    initialize_docs([alice, bob], text)
    return pub, alice, bob


def assert_view_consistent(*editors):
    """Incremental (patch- or session-driven) view == full CRDT render."""
    for editor in editors:
        assert editor.view == editor_doc_from_crdt(editor.doc), editor.actor_id


# ---------------------------------------------------------------------------
# tests/test_bridge.py, on the port
# ---------------------------------------------------------------------------


class TestTransforms:
    def test_insert_step_position_shift(self):
        ops = transaction_to_input_ops(Transaction().insert_text(1, "hi"))
        assert ops == [{"path": ["text"], "action": "insert", "index": 0, "values": ["h", "i"]}]

    def test_replace_becomes_delete_then_insert(self):
        ops = transaction_to_input_ops(Transaction().replace(2, 5, "xyz"))
        assert ops == [
            {"path": ["text"], "action": "delete", "index": 1, "count": 3},
            {"path": ["text"], "action": "insert", "index": 1, "values": ["x", "y", "z"]},
        ]

    def test_mark_steps(self):
        ops = transaction_to_input_ops(
            Transaction().add_mark(1, 4, "strong").remove_mark(2, 3, "comment", {"id": "c1"}))
        assert ops == [
            {"path": ["text"], "action": "addMark", "startIndex": 0, "endIndex": 3,
             "markType": "strong"},
            {"path": ["text"], "action": "removeMark", "startIndex": 1, "endIndex": 2,
             "markType": "comment", "attrs": {"id": "c1"}},
        ]

    def test_patch_to_steps_roundtrip_indices(self):
        view = EditorDoc(list("abc"), [{}, {}, {}])
        for step in patch_to_steps({"path": ["text"], "action": "insert", "index": 1,
                                    "values": ["X"], "marks": {}}):
            step.apply(view)
        assert view.text == "aXbc"
        for step in patch_to_steps({"path": ["text"], "action": "delete", "index": 0,
                                    "count": 2}):
            step.apply(view)
        assert view.text == "bc"


@pytest.mark.parametrize("backend", BACKENDS)
class TestLocalDispatch:
    def test_typing_updates_view(self, backend):
        _, alice, _ = make_pair(backends=(backend, backend))
        type_text(alice, 1, "Hey! ")
        assert alice.text == "Hey! The Peritext editor"
        assert_view_consistent(alice)

    def test_bold_then_unbold(self, backend):
        _, alice, _ = make_pair(backends=(backend, backend))
        toggle_bold(alice, 5, 13)
        assert {"strong": {"active": True}} in list(alice.view.marks)
        assert_view_consistent(alice)
        toggle_bold(alice, 5, 13)
        assert all("strong" not in m for m in alice.view.marks)
        assert_view_consistent(alice)

    def test_replace_range(self, backend):
        _, alice, _ = make_pair("hello world", backends=(backend, backend))
        alice.dispatch(Transaction().replace(1, 6, "goodbye"))
        assert alice.text == "goodbye world"
        assert_view_consistent(alice)

    def test_comment_and_link(self, backend):
        _, alice, _ = make_pair("hello world", backends=(backend, backend))
        add_comment(alice, 1, 6, comment_id="c-1")
        set_link(alice, 7, 12, "https://example.com")
        assert alice.doc.get_text_with_formatting(["text"]) == [
            span("hello", {"comment": [{"id": "c-1"}]}),
            span(" "),
            span("world", {"link": {"active": True, "url": "https://example.com"}}),
        ]
        assert_view_consistent(alice)


@pytest.mark.parametrize("backend", BACKENDS)
class TestSync:
    def test_two_editor_convergence_via_pubsub(self, backend):
        _, alice, bob = make_pair(backends=(backend, backend))
        type_text(alice, 1, "A")
        type_text(bob, 1, "B")
        assert alice.text != bob.text
        alice.sync()
        bob.sync()
        assert alice.text == bob.text and alice.view == bob.view
        assert_view_consistent(alice, bob)

    def test_concurrent_format_and_edit(self, backend):
        _, alice, bob = make_pair("The quick fox", backends=(backend, backend))
        toggle_bold(alice, 1, 10)
        type_text(bob, 5, "very ")
        alice.sync()
        bob.sync()
        assert alice.text == bob.text == "The very quick fox"
        assert alice.view == bob.view
        assert_view_consistent(alice, bob)

    def test_out_of_order_delivery_holdback(self, backend):
        _, alice, bob = make_pair(backends=(backend, backend))
        ch1 = type_text(alice, 1, "one ")
        ch2 = type_text(alice, 1, "two ")
        bob.apply_remote(ch2)
        assert bob.text == "The Peritext editor"
        bob.apply_remote(ch1)
        assert bob.text == "two one The Peritext editor"
        assert_view_consistent(bob)

    def test_duplicate_delivery_is_idempotent(self, backend):
        _, alice, bob = make_pair(backends=(backend, backend))
        ch = type_text(alice, 1, "x")
        bob.apply_remote(ch)
        bob.apply_remote(ch)
        assert bob.text == "xThe Peritext editor"
        assert_view_consistent(bob)

    def test_disconnect_drops_sync(self, backend):
        _, alice, bob = make_pair(backends=(backend, backend))
        alice.disconnect()
        type_text(alice, 1, "offline ")
        assert bob.text == "The Peritext editor"
        alice.sync()
        assert bob.text == "offline The Peritext editor"

    def test_on_remote_patch_called(self, backend):
        pub = Publisher()
        seen = []
        alice = create_editor("alice", pub, **_kw(backend))
        bob = create_editor("bob", pub, on_remote_patch=lambda ed, p: seen.append(p["action"]),
                            **_kw(backend))
        initialize_docs([alice, bob])
        type_text(alice, 1, "hi")
        alice.sync()
        assert "insert" in seen


# ---------------------------------------------------------------------------
# tests/test_bridge_tpu.py's seven patterns, on the port's device backend
# ---------------------------------------------------------------------------


def test_tpu_local_typing_updates_view_immediately():
    _, alice, _ = make_pair(backends=("tpu", "tpu"))
    type_text(alice, 1, "Hey! ")
    assert alice.text == "Hey! The Peritext editor"
    assert alice.session.device.type == "cpu"
    assert_view_consistent(alice)


def test_tpu_concurrent_edits_converge():
    _, alice, bob = make_pair(backends=("tpu", "tpu"))
    type_text(alice, 1, "A")
    toggle_bold(bob, 2, 10)
    set_link(bob, 5, 13, "https://x.test")
    alice.sync()
    bob.sync()
    assert alice.view == bob.view
    assert_view_consistent(alice, bob)


def test_tpu_mixed_backends_converge():
    _, alice, bob = make_pair(backends=("scalar", "tpu"))
    type_text(alice, 1, "Hello ")
    toggle_bold(bob, 1, 6)
    alice.sync()
    bob.sync()
    assert alice.view == bob.view
    assert_view_consistent(alice, bob)


def test_tpu_out_of_order_delivery():
    alice = Editor("alice", **_kw("tpu"))
    bob = Editor("bob", **_kw("tpu"))
    initialize_docs([alice, bob], "abc")
    c1 = alice.dispatch(Transaction().insert_text(1, "x"))
    c2 = alice.dispatch(Transaction().insert_text(2, "y"))
    c3 = alice.dispatch(Transaction().insert_text(3, "z"))
    bob.apply_remote(c3)
    bob.apply_remote(c2)
    assert bob.text == "abc"
    bob.apply_remote(c1)
    assert bob.text == alice.text == "xyzabc"
    assert_view_consistent(alice, bob)


def test_tpu_map_ops_stay_on_device():
    _, alice, bob = make_pair(backends=("tpu", "tpu"))
    alice.dispatch_input_ops([{"path": [], "action": "makeMap", "key": "comments"}])
    type_text(alice, 1, "Q")
    alice.sync()
    bob.sync()
    assert not alice.session.docs[0].fallback
    assert alice.view == bob.view
    assert_view_consistent(alice, bob)
    assert alice.session.read_root(0).get("comments") == {}


@pytest.mark.parametrize("name", ["gpu", "cuda", "TPU"])
def test_unknown_backend_rejected(name):
    with pytest.raises(ValueError):
        Editor("zoe", backend=name)


def test_tpu_backend_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Editor("alice", backend="tpu", actors=ACTORS)


def test_tpu_backend_takes_reference_defaults():
    ed = Editor("alice", **_kw("tpu"))
    cfg = ed.session.config
    assert (cfg["num_docs"], cfg["slot_capacity"], cfg["mark_capacity"]) == (1, 1024, 256)
    assert (cfg["round_insert_capacity"], cfg["round_delete_capacity"],
            cfg["round_mark_capacity"]) == (512, 256, 128)
    assert "device" not in cfg


# ---------------------------------------------------------------------------
# the port's editors against the reference's, transaction by transaction
# ---------------------------------------------------------------------------


def _step_key(step):
    return type(step).__name__, dataclasses.astuple(step)


class _Twins:
    """The same named editors in both packages, each package with its own
    publisher; every ``read_patches`` a session serves is recorded."""

    def __init__(self, backends, text):
        self.ref_pub, self.pub = RefPublisher(), Publisher()
        self.ref, self.port, self.streams = {}, {}, {}
        for name, backend in zip(ACTORS, backends):
            kw = _kw(backend)
            ref_kw = {k: v for k, v in kw.items() if k != "backend_config"}
            self.ref[name] = ref_bridge.create_editor(name, self.ref_pub, **ref_kw)
            self.port[name] = create_editor(name, self.pub, **kw)
            for side, ed in (("ref", self.ref[name]), ("port", self.port[name])):
                log = self.streams[side, name] = []
                if ed.session is not None:
                    ed.session.read_patches = self._recorder(ed.session.read_patches, log)
        ref_change = ref_bridge.initialize_docs(list(self.ref.values()), text)
        change = initialize_docs(list(self.port.values()), text)
        assert change.to_json() == ref_change.to_json()

    @staticmethod
    def _recorder(read_patches, log):
        def recorded(doc_index):
            out = read_patches(doc_index)
            log.append(copy.deepcopy(out))
            return out
        return recorded

    def command(self, name, fn, *args):
        ref_change = getattr(ref_commands, fn)(self.ref[name], *args)
        change = getattr(commands, fn)(self.port[name], *args)
        assert change.to_json() == ref_change.to_json()
        assert Change.from_json(ref_change.to_json()).to_json() == change.to_json()

    def sync(self):
        for name in ACTORS:
            self.ref[name].sync()
            self.port[name].sync()

    def check(self):
        for name in ACTORS:
            ref_ed, ed = self.ref[name], self.port[name]
            assert ed.view.chars == ref_ed.view.chars and ed.view.marks == ref_ed.view.marks
            assert editor_doc_to_pm(ed.view) == ref_to_pm(ref_ed.view)
            ours, theirs = self.streams["port", name], self.streams["ref", name]
            assert ours == theirs, name
            for a, b in zip(ours, theirs):
                for pa, pb in zip(a, b):
                    assert [_step_key(s) for s in patch_to_steps(pa)] == \
                        [_step_key(s) for s in ref_bridge.patch_to_steps(pb)]
            assert ed.session is None or not ed.session.docs[0].fallback


@pytest.mark.parametrize("backends", [("tpu", "tpu"), ("scalar", "tpu")])
def test_editors_equal_reference_editors(backends):
    twins = _Twins(backends, "The Peritext editor")
    rng = random.Random(5)
    for i in range(36):
        name = ACTORS[rng.randrange(2)]
        n = len(twins.port[name].view)
        roll = rng.random()
        if roll < 0.4 or n < 4:
            twins.command(name, "type_text", rng.randint(1, n + 1), rng.choice(["ab", "c", "xyz "]))
        elif roll < 0.55:
            a = rng.randint(1, n - 1)
            twins.command(name, "toggle_bold", a, rng.randint(a + 1, n))
        elif roll < 0.65:
            a = rng.randint(1, n - 1)
            twins.command(name, "toggle_italic", a, rng.randint(a + 1, n))
        elif roll < 0.75:
            a = rng.randint(1, n - 1)
            twins.command(name, "add_comment", a, rng.randint(a + 1, n), f"c{i}")
        elif roll < 0.85:
            a = rng.randint(1, n - 1)
            twins.command(name, "set_link", a, rng.randint(a + 1, n), f"https://{i}.test")
        else:
            a = rng.randint(1, n)
            twins.command(name, "delete_range", a, min(n + 1, a + rng.randint(1, 4)))
        if i % 6 == 5:
            twins.sync()
            twins.check()
    twins.sync()
    twins.check()
    views = {twins.port[n].view.text for n in ACTORS}
    assert len(views) == 1


# ---------------------------------------------------------------------------
# transport, comment bodies, the counter lock
# ---------------------------------------------------------------------------


class _Monitor:
    """Stands in for the convergence monitor (the port has none yet)."""

    def __init__(self):
        self.events = []

    def observe_success(self, key, **kw):
        self.events.append(("ok", key, kw.get("pulled")))

    def observe_failure(self, key, error=""):
        self.events.append(("fail", key, error))


def test_publisher_fans_out_in_sorted_order():
    mon = _Monitor()
    pub = Publisher(monitor=mon)
    got = []
    for key in ("carol", "alice", "bob"):
        pub.subscribe(key, lambda u, key=key: got.append((key, u)))
    with pytest.raises(ValueError):
        pub.subscribe("bob", lambda u: None)
    before = GLOBAL_COUNTERS.get("transport.pubsub_published")
    pub.publish("bob", "x")
    assert got == [("alice", "x"), ("carol", "x")]
    assert mon.events == [("ok", "alice", None), ("ok", "carol", None)]
    assert GLOBAL_COUNTERS.get("transport.pubsub_published") == before + 1
    pub.unsubscribe("alice")
    with pytest.raises(ValueError):
        pub.unsubscribe("alice")


def test_change_queue_requeues_backs_off_and_drops():
    calls, errors = [], []

    def flush(batch):
        calls.append(list(batch))
        if len(calls) <= 2:
            raise RuntimeError("link down")

    q = ChangeQueue(flush, interval=0.01, on_error=errors.append, max_backoff=0.04)
    q.enqueue("a", "b")
    with pytest.raises(RuntimeError):
        q.flush()
    assert len(q) == 2  # requeued at the front
    q.enqueue("c")
    q.start()
    deadline = time.time() + 10
    while len(q) and time.time() < deadline:
        time.sleep(0.005)
    q.drop()
    assert len(q) == 0 and calls[-1] == ["a", "b", "c"] and len(errors) == 1
    q.enqueue("d")
    time.sleep(0.05)
    assert len(q) == 1  # dropped: no timer flushes any more


def test_tpu_editors_converge_by_timer_flushes():
    pub = Publisher()
    alice = create_editor("alice", pub, queue_interval=0.005, start_queue=True, **_kw("tpu"))
    bob = create_editor("bob", pub, queue_interval=0.005, start_queue=True, **_kw("tpu"))
    try:
        initialize_docs([alice, bob], "timer")
        type_text(alice, 1, "A")
        type_text(bob, 6, "B")
        toggle_bold(alice, 1, 3)
        deadline = time.time() + 30
        while time.time() < deadline:
            if len(alice.queue) == 0 and len(bob.queue) == 0 and alice.text == bob.text \
                    and alice.view == bob.view:
                break
            time.sleep(0.01)
    finally:
        alice.disconnect()
        bob.disconnect()
    assert alice.view == bob.view and alice.text == "AtimerB"
    assert_view_consistent(alice, bob)


@pytest.mark.parametrize("spec", [
    dict(drop_p=0.3, dup_p=0.2),
    dict(drop_p=0.1, truncate_p=0.3, bitflip_p=0.3),
])
def test_faulty_publisher_equals_reference(spec):
    """The same seed and spec drop, duplicate, reorder and corrupt alike in
    both packages; redelivery repairs."""
    mon, ref_mon = _Monitor(), _Monitor()
    pub = FaultyPublisher(FaultSpec(**spec), seed=3, monitor=mon)
    ref_pub = RefFaultyPublisher(RefFaultSpec(**spec), seed=3, monitor=ref_mon)
    doc, ref_doc = Doc("w"), RefDoc("w")
    got, ref_got = {"r1": [], "r2": []}, {"r1": [], "r2": []}
    for key in got:
        pub.subscribe(key, lambda u, key=key: got[key].append([c.to_json() for c in u]))
        ref_pub.subscribe(key, lambda u, key=key: ref_got[key].append([c.to_json() for c in u]))
    changes, ref_changes = [], []
    for op in ([{"path": [], "action": "makeList", "key": "text"}] +
               [{"path": ["text"], "action": "insert", "index": i, "values": ["x"]}
                for i in range(12)]):
        changes.append(doc.change([op])[0])
        ref_changes.append(ref_doc.change([op])[0])
    for i in range(0, len(changes), 3):
        pub.publish("w", changes[i:i + 3])
        ref_pub.publish("w", ref_changes[i:i + 3])
    assert got == ref_got and mon.events == ref_mon.events
    assert (pub.dropped_count, pub.delivered_count, pub.corrupt_count) == \
        (ref_pub.dropped_count, ref_pub.delivered_count, ref_pub.corrupt_count)
    assert pub.redeliver_lost() == ref_pub.redeliver_lost()
    assert got == ref_got
    seen = {(c["actor"], c["seq"]) for batch in got["r1"] for c in batch}
    assert seen == {("w", s) for s in range(1, len(changes) + 1)}


def test_comment_bodies_equal_reference():
    doc, ref_doc = Doc("ann"), RefDoc("ann")
    for i, content in enumerate(("first", "second")):
        c, _ = comment.put_comment(doc, comment.Comment(f"c{i}", "ann", content))
        rc, _ = ref_comment.put_comment(ref_doc, ref_comment.Comment(f"c{i}", "ann", content))
        assert c.to_json() == rc.to_json()
    c, _ = comment.remove_comment(doc, "c0")
    rc, _ = ref_comment.remove_comment(ref_doc, "c0")
    assert c.to_json() == rc.to_json()
    assert comment.get_comment(doc, "c0") is None
    assert comment.get_comment(doc, "c1") == comment.Comment("c1", "ann", "second")
    assert [dataclasses.astuple(x) for x in comment.list_comments(doc)] == \
        [dataclasses.astuple(x) for x in ref_comment.list_comments(ref_doc)]


def test_counters_are_thread_safe():
    counters = Counters()

    def bump():
        for _ in range(20000):
            counters.add("x")

    threads = [threading.Thread(target=bump) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert counters.get("x") == 80000


def test_kernel_launch_counts_are_thread_safe():
    from peritext_tpu_torch.utils.nvcc import count_launch

    def wrapper():
        pass

    wrapper.launches = 0

    def launch():
        for _ in range(20000):
            count_launch(wrapper)

    threads = [threading.Thread(target=launch) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert wrapper.launches == 80000


def test_timer_delivery_failure_surfaces():
    """A peer's session that fails in a timer-driven delivery is not lost:
    the peer keeps its failure and raises it on every later call, and the
    sender raises its failed flush once on its next call."""
    pub = Publisher()
    alice = create_editor("alice", pub, queue_interval=0.005, **_kw("tpu"))
    bob = create_editor("bob", pub, **_kw("tpu"))
    initialize_docs([alice, bob], "x")

    def fail():
        raise RuntimeError("injected drain failure")

    bob.session.drain = fail
    alice.queue.start()
    try:
        type_text(alice, 1, "A")
        deadline = time.time() + 30
        while alice._flush_error is None and time.time() < deadline:
            time.sleep(0.005)
    finally:
        alice.disconnect()
    assert len(alice.queue) == 1  # requeued, not dropped
    for call in (lambda: type_text(bob, 1, "B"), bob.sync, bob.rerender,
                 lambda: bob.apply_remote(*alice.queue._changes)):
        with pytest.raises(RuntimeError, match="injected drain failure"):
            call()
    with pytest.raises(RuntimeError, match="timer flush failed"):
        alice.sync()
    alice_text = alice.text
    type_text(alice, 1, "C")  # raised once: alice itself is sound
    assert alice.text == "C" + alice_text
