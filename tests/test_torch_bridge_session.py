"""The port's editor bridge in its two longest sessions, moved out of
tests/test_torch_bridge.py unchanged so two test workers share the
bridge's wall: a random editing session of 120 transactions on every
backend pair (tests/test_bridge.py's case), and the fuzzed session of
tests/test_bridge_tpu.py on two ``"tpu"`` editors
(``backend_config={"device": "cpu"}``).  Each ends with both views equal
and equal to a full render of the editor's document.
"""

import random

import pytest

from peritext_tpu_torch.bridge import (
    Transaction,
    create_editor,
    editor_doc_from_crdt,
    initialize_docs,
)
from peritext_tpu_torch.bridge.commands import (
    delete_range,
    toggle_bold,
    toggle_italic,
    type_text,
)
from peritext_tpu_torch.parallel.pubsub import Publisher

ACTORS = ("alice", "bob")
CPU = {"device": "cpu"}


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


@pytest.mark.parametrize("backends", [("scalar", "scalar"), ("tpu", "tpu"), ("scalar", "tpu")])
def test_random_editing_session_converges(backends):
    rng = random.Random(42)
    _, alice, bob = make_pair("seed text", backends=backends)
    editors = [alice, bob]
    for i in range(120):
        ed = rng.choice(editors)
        n = len(ed.view)
        action = rng.randrange(4)
        if action == 0 or n == 0:
            type_text(ed, rng.randint(1, n + 1), rng.choice("abcdefgh"))
        elif action == 1 and n >= 1:
            start = rng.randint(1, n)
            delete_range(ed, start, min(n + 1, start + rng.randint(1, 3)))
        elif action == 2 and n >= 2:
            start = rng.randint(1, n - 1)
            toggle_bold(ed, start, rng.randint(start + 1, n))
        elif n >= 2:
            start = rng.randint(1, n - 1)
            toggle_italic(ed, start, rng.randint(start + 1, n))
        if i % 10 == 0:
            alice.sync()
            bob.sync()
    alice.sync()
    bob.sync()
    assert alice.view == bob.view
    assert_view_consistent(alice, bob)
    for ed in editors:
        assert ed.session is None or not ed.session.docs[0].fallback


def test_tpu_fuzz_session():
    rng = random.Random(11)
    _, alice, bob = make_pair(backends=("tpu", "tpu"))
    editors = [alice, bob]
    for _ in range(40):
        ed = editors[rng.randrange(2)]
        n = len(ed.view)
        roll = rng.random()
        if roll < 0.5 or n < 4:
            type_text(ed, rng.randrange(1, n + 1) if n else 1, rng.choice("abcdef "))
        elif roll < 0.75:
            a = rng.randrange(1, n)
            toggle_bold(ed, a, rng.randrange(a + 1, n + 1))
        else:
            a = rng.randrange(1, n)
            ed.dispatch(Transaction().delete(a, rng.randrange(a + 1, n + 1)))
        if rng.random() < 0.3:
            alice.sync()
            bob.sync()
    alice.sync()
    bob.sync()
    alice.sync()
    assert alice.view == bob.view
    assert_view_consistent(alice, bob)
