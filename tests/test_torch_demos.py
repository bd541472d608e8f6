"""The port's command-line demos (demos/torch_*.py) against their JAX twins
(demos/*.py) on the CPU: the scale demo's digest in every layout across
three read blocks, the two-editor and essay demos' output byte for byte, the
three hosts' digests; and every device entry point's default, the card,
raises without one."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
DEMOS = ROOT / "demos"


def _load(name):
    spec = importlib.util.spec_from_file_location(f"demo_{name}", DEMOS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(script, *args):
    """A demo's standard output, run as a script (JAX on the CPU)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PT_DEMO_PLATFORM", None)
    out = subprocess.run([sys.executable, str(DEMOS / script), *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    return out.stdout


#: the scale demo at test size: 96 docs in read blocks of 40 (3 blocks, 120 rows)
SCALE = dict(docs=96, read_chunk=40)


@pytest.fixture(scope="module")
def scale_reference():
    """The JAX demo's session (demos/scale_demo.py's arguments) on the same
    two frames, and its oracle spans."""
    from peritext_tpu.api.batch import _oracle_doc
    from peritext_tpu.parallel.codec import encode_frame
    from peritext_tpu.parallel.streaming import StreamingMerge
    from peritext_tpu.testing.fuzz import generate_workload

    w = generate_workload(seed=200, num_docs=1, ops_per_doc=220)[0]
    changes = [ch for log in w.values() for ch in log]
    half = len(changes) // 2
    sess = StreamingMerge(
        num_docs=SCALE["docs"], actors=("doc1", "doc2", "doc3"),
        slot_capacity=512, mark_capacity=160, tomb_capacity=192,
        round_insert_capacity=192, round_delete_capacity=96,
        round_mark_capacity=96,
    )
    for frame in (encode_frame(changes[:half]), encode_frame(changes[half:])):
        sess.ingest_frames((doc, frame) for doc in range(SCALE["docs"]))
        sess.drain()
    ops = sum(len(c.ops) for c in changes)
    return sess.digest(), _oracle_doc(w).get_text_with_formatting(["text"]), ops


@pytest.mark.parametrize("layout,counter,applies", [
    ("padded", "block_applies", 6),  # 3 blocks x 2 rounds
    ("paged", "group_applies", None),
    ("ragged", "ragged_applies", None),
])
def test_scale_demo_equals_the_jax_session(scale_reference, layout, counter, applies):
    digest, spans, ops = scale_reference
    out = _load("torch_scale_demo").run(SCALE["docs"], device="cpu", layout=layout,
                                        read_chunk=SCALE["read_chunk"])
    s = out["session"]
    assert s._padded_docs == 120 and s._n_blocks() == 3
    assert out["digest"] == digest
    assert s.read_all() == [spans] * SCALE["docs"]
    assert s.overflow_count() == 0 and not any(d.fallback for d in s.docs)
    assert out["doc_ops"] == ops and out["total_ops"] == SCALE["docs"] * ops
    assert [sorted(r) for r in out["rounds"]] == [["digest", "digest_wait", "drain", "ingest"]] * 2
    assert out["counters"][counter] == (applies or out["counters"][counter]) > 0
    assert sum(out["counters"].values()) == out["counters"][counter]


def test_scale_demo_main_prints_the_jax_digest(scale_reference, capsys):
    _load("torch_scale_demo").main(["--docs", "96", "--device", "cpu", "--layout", "ragged"])
    lines = capsys.readouterr().out.splitlines()
    ops = scale_reference[2]
    assert lines[0] == f"96 docs x {ops} ops (0.0M total), 2 arrival rounds of wire frames"
    assert f"converged ON DEVICE: digest {scale_reference[0]:#010x} " in "\n".join(lines)
    assert lines[-1] == "ALL docs verified against the scalar oracle; 0 fallbacks"


def test_two_editors_tpu_output_equals_the_jax_demo():
    got = _stdout("torch_two_editors.py", "--backend", "tpu", "--device", "cpu")
    assert got == _stdout("two_editors.py", "--backend", "tpu")
    assert "converged: both editors show identical marked text" in got


@pytest.mark.parametrize("args", [("--short",), ()], ids=["short", "essay"])
def test_essay_demo_output_equals_the_jax_demo(args):
    got = _stdout("torch_essay_demo.py", *args)
    assert got == _stdout("essay_demo.py", *args)
    assert "\nconverged. winning link(s): " in got


def test_multihost_digests_equal_each_other_and_the_jax_demo(capsys):
    """The three hosts converge to one digest, the JAX demo's.  The gossip
    rounds it takes may differ: a pushed change merges on the receiving
    server's handler thread, so the demo's bounded wait can read a digest
    before the merge (in either package), and the ring runs again."""
    out = _load("torch_multihost_demo").run("cpu")
    printed = capsys.readouterr().out.splitlines()
    assert len(set(out["digests"])) == 1 and 1 <= out["rounds"] <= 6
    want = _stdout("multihost_demo.py").splitlines()
    shared = f"shared digest: {out['digests'][0]:#010x}"
    assert printed[-2:] == want[-2:] and printed[-2] == shared
    assert printed[0] == want[0] == "session: 103 changes by 3 actors, one host each"


@pytest.mark.parametrize("call", [
    lambda: _load("torch_scale_demo").run(8),
    lambda: _load("torch_scale_demo").main(["--docs", "8"]),
    lambda: _load("torch_two_editors").main(["--backend", "tpu"]),
    lambda: _load("torch_multihost_demo").main([]),
], ids=["scale_run", "scale_main", "two_editors", "multihost"])
def test_device_demos_default_to_the_card(monkeypatch, call):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
