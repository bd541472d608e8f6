"""The port's wire codec (peritext_tpu_torch/parallel/codec.py), its native
library (peritext_tpu_torch/native) and its causal schedule against the
reference package's, on the same changes.

Every comparison is exact: frames byte-equal in every wire form (v2, v4
session frames with and without the preset dictionary, v5 traced, v6
checked), each package decoding the other's frames to the same changes,
the same typed ``DecodeError`` on corrupt frames, and native results equal
to the Python fallbacks array for array.
"""

import importlib.util
import random
from pathlib import Path

import numpy as np
import pytest

from peritext_tpu import native as jax_native
from peritext_tpu.core.errors import DecodeError as JaxDecodeError
from peritext_tpu.parallel import causal as jax_causal
from peritext_tpu.parallel import codec as jax_codec
from peritext_tpu.testing.fuzz import generate_markheavy_workload, generate_workload
from peritext_tpu.testing.generate import generate_docs
from peritext_tpu_torch import native
from peritext_tpu_torch.core.errors import DecodeError
from peritext_tpu_torch.core.types import Change
from peritext_tpu_torch.parallel import causal, codec


def _script(name):
    path = Path(__file__).resolve().parent.parent / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _port(changes):
    return [Change.from_json(c.to_json()) for c in changes]


def _json(changes):
    return [c.to_json() for c in changes]


def _map_changes():
    """Map registers of every value kind, a nested map, a delete, and a value
    the fast path cannot express (a float: JSON spill-over)."""
    docs, _, initial = generate_docs("hello world", 2)
    d1, d2 = docs
    c1, _ = d1.change([
        {"path": [], "action": "makeMap", "key": "meta"},
        {"path": ["meta"], "action": "set", "key": "title", "value": "draft"},
        {"path": ["meta"], "action": "set", "key": "n", "value": -7},
        {"path": [], "action": "set", "key": "ok", "value": True},
        {"path": [], "action": "set", "key": "none", "value": None},
        {"path": [], "action": "set", "key": "ratio", "value": 0.5},
    ])
    c2, _ = d2.change([
        {"path": ["text"], "action": "addMark", "startIndex": 1, "endIndex": 8,
         "markType": "comment", "attrs": {"id": "c-1"}},
        {"path": ["text"], "action": "addMark", "startIndex": 0, "endIndex": 4,
         "markType": "link", "attrs": {"url": "https://x.test/é"}},
        {"path": [], "action": "del", "key": "ok"},
    ])
    return [initial, c1, c2]


@pytest.fixture(scope="module")
def batches():
    """Reference change batches: fuzz logs with marks and comments, and the
    map-op batch."""
    out = [_map_changes()]
    for w in generate_markheavy_workload(seed=3, num_docs=3, ops_per_doc=60):
        out.append(sorted((c for log in w.values() for c in log),
                          key=lambda c: (c.actor, c.seq)))
    return out


def _encoders(form):
    """(reference encoder, port encoder, reference decoder, port decoder)
    for one wire form; session forms keep one session per side across the
    batches, as one peer link does."""
    if form == "v2":
        return (jax_codec.encode_frame, codec.encode_frame,
                jax_codec.decode_frame, codec.decode_frame)
    if form in ("v4", "v4_preset", "v3"):
        kw = dict(compress=form != "v3", preset=form == "v4_preset")
        return (jax_codec.WireSession(**kw).encode_frame, codec.WireSession(**kw).encode_frame,
                jax_codec.WireSession(**kw).decode_frame, codec.WireSession(**kw).decode_frame)
    if form == "v5":
        return (lambda cs: jax_codec.encode_frame_traced(cs, 0x1234_5678_9ABC, 77),
                lambda cs: codec.encode_frame_traced(cs, 0x1234_5678_9ABC, 77),
                jax_codec.decode_frame, codec.decode_frame)
    assert form == "v6"
    return (lambda cs: jax_codec.encode_frame_checked(cs, 5, 9),
            lambda cs: codec.encode_frame_checked(cs, 5, 9),
            jax_codec.decode_frame, codec.decode_frame)


@pytest.mark.parametrize("form", ["v2", "v3", "v4", "v4_preset", "v5", "v6"])
def test_frames_byte_equal_and_cross_decode(batches, form):
    jax_enc, port_enc, _, port_dec = _encoders(form)
    # the port decodes the reference's frames, and the reference the port's
    # (session decoders keep state: one per direction)
    _, _, jax_dec, _ = _encoders(form)
    for batch in batches:
        ref = jax_enc(batch)
        mine = port_enc(_port(batch))
        assert mine == ref
        assert _json(port_dec(ref)) == _json(batch)
        assert _json(jax_dec(mine)) == _json(batch)


@pytest.mark.parametrize("form", ["v5", "v6"])
def test_strip_trace_context_equal(batches, form):
    jax_enc, port_enc, _, _ = _encoders(form)
    ref = jax_enc(batches[0])
    assert codec.strip_trace_context(ref) == jax_codec.strip_trace_context(ref)
    ctx, plain = codec.strip_trace_context(port_enc(_port(batches[0])))
    assert ctx == ((0x1234_5678_9ABC, 77) if form == "v5" else (5, 9))
    assert plain == jax_codec.encode_frame(batches[0])


def test_chunks_multi_iter_and_parts_equal(batches):
    changes = [c for b in batches[1:] for c in b]
    ref_chunks = jax_codec.encode_frame_chunks(changes)
    assert codec.encode_frame_chunks(_port(changes)) == ref_chunks
    ref_sess = jax_codec.encode_frame_chunks(changes, session=jax_codec.WireSession(compress=True))
    mine_sess = codec.encode_frame_chunks(_port(changes), session=codec.WireSession(compress=True))
    assert mine_sess == ref_sess
    for chunks in (ref_chunks, ref_sess):
        data = b"".join(chunks)
        assert _json(codec.decode_frame_multi(data)) == _json(jax_codec.decode_frame_multi(data))
        assert list(codec.iter_frames(data)) == list(jax_codec.iter_frames(data))
    frame = jax_codec.encode_frame(batches[0])
    strings, values, n, version = codec.frame_parts(frame)
    ref_strings, ref_values, ref_n, ref_version = jax_codec.frame_parts(frame)
    assert (strings, n, version) == (ref_strings, ref_n, ref_version)
    assert np.array_equal(np.asarray(values), np.asarray(ref_values))


def _corruptions(frame_v2, frame_v6):
    flipped = bytearray(frame_v6)
    flipped[len(flipped) // 2] ^= 0x5A
    return {
        "crc_mismatch": bytes(flipped),
        "truncated_v2": frame_v2[:-3],
        "truncated_v6": frame_v6[:-1],
        "bad_magic": b"XXXX" + frame_v2[4:],
        "trailing_garbage": frame_v2 + b"\x00",
    }


@pytest.mark.parametrize("kind", ["crc_mismatch", "truncated_v2", "truncated_v6", "bad_magic",
                                  "trailing_garbage"])
def test_corrupt_frames_raise_decode_error_in_both(batches, kind):
    frame = _corruptions(jax_codec.encode_frame(batches[1]),
                         jax_codec.encode_frame_checked(batches[1]))[kind]
    with pytest.raises(JaxDecodeError):
        jax_codec.decode_frame(frame)
    with pytest.raises(DecodeError):
        codec.decode_frame(frame)
    # strip_trace_context is total: a damaged v6 frame passes through intact
    assert codec.strip_trace_context(frame) == jax_codec.strip_trace_context(frame)


def test_native_library_builds_into_the_package_build_dir():
    assert native.available()
    path = native.library_path()
    assert path.parent.name == "_build" and path.parent.parent.name == "peritext_tpu_torch"
    assert path.name.startswith("libptnative-") and path.exists()


def test_varint_native_equals_python_and_reference():
    rng = np.random.default_rng(0)
    values = np.concatenate([
        np.array([0, 1, -1, 63, -64, 64, 2**31 - 1, -2**31, 127, 128, 16383, 16384], np.int32),
        rng.integers(-2**31, 2**31, 500, dtype=np.int64).astype(np.int32),
    ])
    mine = native.varint_encode(values)
    assert mine == codec._py_varint_encode(values.tolist()) == jax_native.varint_encode(values)
    assert native.varint_decode(mine, len(values)).tolist() == values.tolist()
    assert codec._py_varint_decode(mine, len(values)) == values.tolist()
    with pytest.raises(ValueError):
        native.varint_decode(mine[:-1], len(values))


def _ordered_log(seed, docs=1, ops=160):
    """The causally ordered changes of fuzz docs, reference objects."""
    w = generate_workload(seed=seed, num_docs=docs, ops_per_doc=ops)
    return [c for d in w for log in d.values() for c in log]


def _schedule_cases():
    rng = random.Random(5)
    log = _ordered_log(11)
    shuffled = log[:]
    rng.shuffle(shuffled)
    # stuck: drop a few changes, so their successors and dependents wait
    dropped = [c for i, c in enumerate(shuffled) if i % 17 != 3]
    # ties: many concurrent heads of several actors, and duplicates
    dup = shuffled + shuffled[: len(shuffled) // 3]
    # deps on actors absent from the set and from the clock
    absent = []
    for i, c in enumerate(shuffled):
        j = c.to_json()
        if i % 9 == 0:
            j["deps"] = dict(j.get("deps") or {}, ghost=3)
        absent.append(j)
    base = {}
    for c in log[: len(log) // 4]:
        base[c.actor] = max(base.get(c.actor, 0), c.seq)
    return {
        "ordered": (log, None),
        "shuffled": (shuffled, None),
        "stuck": (dropped, None),
        "ties_and_duplicates": (dup, None),
        "absent_actor_deps": (absent, None),
        "base_clock": (shuffled, base),
        "base_clock_with_absent_actor": (dropped, dict(base, ghost=2)),
    }


@pytest.mark.parametrize("case", ["ordered", "shuffled", "stuck", "ties_and_duplicates",
                                  "absent_actor_deps", "base_clock",
                                  "base_clock_with_absent_actor"])
def test_causal_schedule_native_equals_python_and_reference(case):
    """The object path's Python heap equals the reference's schedule, and the
    port's C++ ``pt_causal_schedule``, fed arrays as the reference's native
    route builds them (``scripts/torch_causal_pairs.py``), gives the same
    order and the same stuck set."""
    changes, base = _schedule_cases()[case]
    if isinstance(changes[0], dict):
        from peritext_tpu.core.types import Change as JaxChange

        ref_changes = [JaxChange.from_json(j) for j in changes]
    else:
        ref_changes = changes
    mine = _port(ref_changes)
    key = lambda cs: [(c.actor, c.seq) for c in cs]  # noqa: E731
    ordered, stuck = causal.causal_schedule(mine, base)
    ref_ordered, ref_stuck = jax_causal.causal_schedule(ref_changes, base)
    assert (key(ordered), key(stuck)) == (key(ref_ordered), key(ref_stuck))
    before = native.calls.get("causal_schedule", 0)
    nat_ordered, nat_stuck = _script("torch_causal_pairs").native_schedule(mine, base)
    assert native.calls.get("causal_schedule", 0) == before + 1
    assert (key(nat_ordered), key(nat_stuck)) == (key(ordered), key(stuck))
    if case == "stuck":
        assert stuck
    if case == "absent_actor_deps":
        assert stuck and all("ghost" in (c.deps or {}) or c.seq > 1 for c in stuck)
