"""The port's traced-code rules (PTL002-PTL004, CUDA-graph capture as the
trace) against the reference package's (jit as the trace), and the capture
audit on the CPU.

* The torch corpus, ``tests/graftlint_corpus_torch/``, is the reference
  corpus's twin file for file and line for line: a graph-cache body or a
  capture-root marker where the original has ``@jax.jit``/``shard_map``,
  torch calls where it has jnp.  The port's PTL002-PTL004 findings on each
  twin equal the reference's on the original in rule, path (relative to its
  corpus root), line and column: 12 in the bad files, none in the clean
  one.  Each message is the reference's with the rule module's
  ``WORD_REPLACEMENTS`` applied, and the construct the twin swapped
  (:data:`TWIN_CONSTRUCTS`) named as the twin names it.
* Each rule has a true positive and a true negative of its own; the CLI's
  exit codes and ``--rules PTL002,PTL003,PTL004`` output equal the
  reference's on the pair of corpora, paths normalised.
* The capture audit (testing/capture_audit.py) over CPU sessions that run
  every ``GraphCache.run`` site (the padded forms with and without the
  digest chain, the multi-tenant form, paged, ragged, the padded mesh form
  on 2 virtual shards, the engine replay): every package function a body
  runs is in the set the rules scan.  A body that calls an unmarked helper
  of another module is reported.
"""

import random
import re
from pathlib import Path

import pytest
import torch

from peritext_tpu.analysis import scan_paths as jax_scan_paths
from peritext_tpu.analysis.__main__ import main as jax_main
from peritext_tpu_torch.analysis import astutil, scan_paths
from peritext_tpu_torch.analysis.__main__ import main
from peritext_tpu_torch.analysis.rules import (
    ptl002_tracer_control_flow,
    ptl003_host_sync,
    ptl004_recompile_hazard,
)
from peritext_tpu_torch.ops import ragged_insert as ragged_insert_mod
from peritext_tpu_torch.parallel.codec import encode_frame
from peritext_tpu_torch.parallel.mesh import make_mesh
from peritext_tpu_torch.parallel.streaming import StreamingMerge
from peritext_tpu_torch.testing.capture_audit import CaptureAudit, audit_call, captured_set
from peritext_tpu_torch.testing.engine import EngineReplay, replay_digest
from peritext_tpu_torch.testing.fuzz import generate_workload
from peritext_tpu_torch.utils.capture import CAPTURE_ROOTS
from peritext_tpu_torch.utils.graphs import GraphCache

ROOT = Path(__file__).resolve().parents[1]
CORPUS = ROOT / "tests" / "graftlint_corpus"
TWINS = ROOT / "tests" / "graftlint_corpus_torch"
TRACED = ("PTL002", "PTL003", "PTL004")
TWIN_FILES = ["bad/parallel/violations.py", "bad/parallel/fused_loop_sync.py",
              "bad/parallel/mesh_region_sync.py", "clean/parallel/idiomatic.py"]
REPLACEMENTS = {"PTL002": ptl002_tracer_control_flow.WORD_REPLACEMENTS,
                "PTL003": ptl003_host_sync.WORD_REPLACEMENTS,
                "PTL004": ptl004_recompile_hazard.WORD_REPLACEMENTS}
#: the constructs the twins swapped for the originals' jax calls
TWIN_CONSTRUCTS = {"'jax.device_get'": "'torch.nonzero'",
                   "'jax.block_until_ready'": "'torch.cuda.synchronize'",
                   "'jax.numpy.zeros'": "'torch.zeros'"}


def _traced(findings):
    return [f for f in findings if f.rule in TRACED]


def _port_message(rule, message):
    """A reference message in the port's words."""
    for old, new in REPLACEMENTS[rule]:
        message = message.replace(old, new)
    for old, new in TWIN_CONSTRUCTS.items():
        message = message.replace(old, new)
    return message


@pytest.mark.parametrize("twin", TWIN_FILES)
def test_twin_findings_equal_reference(twin):
    got = _traced(scan_paths([TWINS / twin], root=TWINS))
    want = _traced(jax_scan_paths([CORPUS / twin], root=CORPUS))
    assert [(f.rule, f.path, f.line, f.col) for f in got] == \
        [(f.rule, f.path, f.line, f.col) for f in want]
    assert [f.message for f in got] == [_port_message(f.rule, f.message) for f in want]
    if twin.startswith("clean"):
        assert got == []


def test_twins_hold_the_reference_twelve_findings_and_keep_its_layout():
    assert len(_traced(scan_paths([TWINS / "bad"], root=TWINS))) == 12
    for twin in TWIN_FILES:
        assert len((TWINS / twin).read_text().splitlines()) == \
            len((CORPUS / twin).read_text().splitlines()), twin
    # the other rules find on each twin what they find on its original
    for twin in TWIN_FILES:
        got = [(f.rule, f.line, f.col) for f in scan_paths([TWINS / twin], root=TWINS)
               if f.rule not in TRACED]
        want = [(f.rule, f.line, f.col) for f in jax_scan_paths([CORPUS / twin], root=CORPUS)
                if f.rule not in TRACED]
        assert got == want, twin


def _scan_source(tmp_path, source, rule, name="parallel/mod.py"):
    path = tmp_path / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(source)
    return [(f.line, f.message) for f in scan_paths([path], root=tmp_path, rules=[rule])]


_HEAD = "import numpy as np\nimport torch\nfrom ..utils.capture import captured\n\n\n"

RULE_CASES = {
    # PTL002: a branch on a body's input, on a closure tensor, and an and/or
    # operand; the key's statics, structural reads and `is None` stay clean
    ("PTL002", "body_input"): (
        "def f(graphs, buf):\n"
        "    def body(b):\n"
        "        if b.sum() > 0:\n"
        "            return b\n"
        "        return -b\n"
        "    return graphs.run((), 'f', body, (buf,))\n", [3]),
    ("PTL002", "closure_tensor_and_or"): (
        "def f(graphs, buf, mask):\n"
        "    def body(b):\n"
        "        return mask and b\n"
        "    return graphs.run((), 'f', body, (buf,))\n", [3]),
    ("PTL002", "key_static_and_structural"): (
        "def f(graphs, buf, rows):\n"
        "    k = len(rows)\n"
        "    depth = k * 2\n"
        "    def body(b, *rest):\n"
        "        if b.shape[0] > 4 and depth:\n"
        "            b = b + 1\n"
        "        for r in range(k):\n"
        "            b = b * 2\n"
        "        return b if rest is None or isinstance(b, torch.Tensor) else b\n"
        "    return graphs.run(('f', k), 'f', body, (buf,))\n", []),
    ("PTL002", "marked_static"): (
        "@captured(static=('window',))\n"
        "def g(x, window):\n"
        "    if window > 8:\n"
        "        return x[:, :window]\n"
        "    return x\n", []),
    # PTL003: a sync in a helper a body reaches, a host-to-device copy and a
    # boolean-mask index inside a marked root; the same sync outside the
    # capture, in the caller, stays clean
    ("PTL003", "reached_helper"): (
        "def _peek(x):\n"
        "    return x.cpu()\n\n\n"
        "def f(graphs, buf):\n"
        "    return graphs.run((), 'f', lambda b: _peek(b), (buf,))\n", [2]),
    ("PTL003", "copy_and_mask"): (
        "@captured\n"
        "def g(x, host):\n"
        "    y = torch.from_numpy(host).to(x.device)\n"
        "    return x[x > 0] + y\n", [3, 4]),
    ("PTL003", "sync_outside_the_capture"): (
        "def body(b):\n"
        "    return b * 2\n\n\n"
        "def f(graphs, buf):\n"
        "    out = graphs.run((), 'f', body, (buf,))\n"
        "    return out.item(), int(out.sum()), torch.nonzero(out)\n", []),
    # PTL004: a raw shape read in a key element, a variable-length inputs
    # sequence; a bucketed key element stays clean
    ("PTL004", "key_shape_and_varlen_inputs"): (
        "def f(graphs, bufs, body):\n"
        "    return graphs.run(('f', bufs[0].shape[0]), 'f', body, [b for b in bufs])\n", [2, 2]),
    ("PTL004", "bucketed_key"): (
        "def next_pow2(n):\n"
        "    return 1 << (n - 1).bit_length()\n\n\n"
        "def f(graphs, bufs, body):\n"
        "    return graphs.run(('f', next_pow2(len(bufs))), 'f', body, tuple(bufs[:2]) + ())\n",
        []),
}


@pytest.mark.parametrize("rule,case", sorted(RULE_CASES), ids=lambda x: x)
def test_rule_true_positive_and_negative(tmp_path, rule, case):
    source, lines = RULE_CASES[(rule, case)]
    got = _scan_source(tmp_path, _HEAD + source, rule)
    offset = _HEAD.count("\n")
    assert [line - offset for line, _ in got] == lines, got


def test_sync_in_an_unreached_function_is_clean(tmp_path):
    source = _HEAD + ("def host_side(x):\n    return x.item()\n\n\n"
                      "@captured\ndef g(x):\n    return x + 1\n")
    assert _scan_source(tmp_path, source, "PTL003") == []


def _cli(fn, argv, capsys, corpus):
    """(exit code, stdout, stderr) of one CLI call, the corpus root spelled
    ``<corpus>``."""
    rc = fn(argv)
    out = capsys.readouterr()
    return rc, out.out.replace(corpus, "<corpus>"), out.err.replace(corpus, "<corpus>")


@pytest.mark.parametrize("tree", ["bad", "clean"])
def test_cli_rules_output_equals_reference(tree, capsys, monkeypatch):
    monkeypatch.chdir(ROOT)
    argv = ["--no-baseline", "--rules", ",".join(TRACED)]
    port = _cli(main, [f"tests/graftlint_corpus_torch/{tree}"] + argv, capsys,
                "tests/graftlint_corpus_torch")
    ref = _cli(jax_main, [f"tests/graftlint_corpus/{tree}"] + argv, capsys,
               "tests/graftlint_corpus")
    assert port[0] == ref[0] == (1 if tree == "bad" else 0)
    lines = []
    for line in ref[1].splitlines():
        m = re.match(r"(\S+: )(PTL00\d) (.*)$", line)
        lines.append(m.group(1) + m.group(2) + " " + _port_message(m.group(2), m.group(3))
                     if m else line)
    assert port[1].splitlines() == lines
    assert port[2] == ref[2]


# -- the capture audit on the CPU ---------------------------------------------

ACTORS = ("doc1", "doc2", "doc3")
DOCS = 6
CAPS = dict(slot_capacity=128, mark_capacity=64, tomb_capacity=64, round_insert_capacity=8,
            round_delete_capacity=8, round_mark_capacity=8, round_map_capacity=8)
#: every (form, site) the sessions below run through a graph cache
FORMS = [("flat", "apply_batch_staged_rounds"), ("flat", "_fused_rounds_digest"),
         ("stacked", "apply_batch_stacked_rounds"), ("stacked", "_stacked_rounds_digest"),
         ("stacked_multi", "apply_batch_stacked_rounds_multi"),
         ("mesh_stacked", "apply_batch_stacked_rounds.mesh"),
         ("mesh_stacked", "_stacked_rounds_digest"),
         ("paged", "apply_batch_paged_groups"), ("ragged", "apply_batch_ragged"),
         ("engine", "apply_batch_compact_rounds")]


def _frames(seed=29, ops=36, chunks=2):
    """Per arrival round, ``(doc, frame)`` pairs: each doc's log shuffled,
    in ``chunks`` frames."""
    rng = random.Random(seed)
    plans = []
    for w in generate_workload(seed, num_docs=DOCS, ops_per_doc=ops):
        ch = [c for a in sorted(w) for c in w[a]]
        rng.shuffle(ch)
        size = -(-len(ch) // chunks)
        plans.append([ch[i:i + size] for i in range(0, len(ch), size)])
    return [[(d, encode_frame(sorted(p[r], key=lambda c: (c.actor, c.seq))))
             for d, p in enumerate(plans) if r < len(p)] for r in range(chunks)]


def _session(frames, layout="padded", mesh=None, static=False, prefetch=True, fusion=None,
             engine=None):
    kw = dict(CAPS, page_size=32) if layout != "padded" else dict(CAPS)
    s = StreamingMerge(num_docs=DOCS, actors=ACTORS, layout=layout, mesh=mesh, device="cpu",
                       static_rounds=static, **kw)
    s.prefetch_digest = prefetch
    s.fusion_rows = fusion
    s.FUSE_MAX_ROUNDS = 2
    s._capture_rounds = engine
    for items in frames:
        s.ingest_frames(items)
        s.drain()
    if s._stager is not None:
        s._stager.close()
    return s


@pytest.fixture(scope="module")
def audited():
    """Every graph-cache site run once on CPU sessions under one armed
    audit, and the sessions' digests."""
    frames = _frames()
    digests = {}
    with CaptureAudit() as audit:
        for name, kw in (("flat", {}), ("flat_undigested", dict(prefetch=False)),
                         ("stacked", dict(static=True)),
                         ("stacked_undigested", dict(static=True, prefetch=False)),
                         ("stacked_multi", dict(static=True, prefetch=False,
                                                fusion=((0, 3), 3))),
                         ("paged", dict(layout="paged")), ("ragged", dict(layout="ragged")),
                         ("mesh", dict(mesh=make_mesh(2, device="cpu")))):
            digests[name] = _session(frames, **kw).digest()
        captured = []
        s = _session(frames, prefetch=False, engine=captured)
        replay = EngineReplay(captured, s._padded_docs, s.config, "cpu",
                              s._digest_tables(0, s._padded_docs))
        digests["engine"] = replay_digest(replay())
        digests["engine_session"] = s.digest()
    assert GraphCache.audit is None
    return audit, digests


@pytest.mark.parametrize("form,site", FORMS, ids=["/".join(f) for f in FORMS])
def test_audit_finds_nothing_outside_the_captured_set(audited, form, site):
    audit, _ = audited
    seen, outside = audit.reports[(form, site)]
    assert outside == []
    assert seen and all(module.startswith("peritext_tpu_torch.") for module, _ in seen)


def test_audited_sessions_still_agree(audited):
    """The audit runs each first body as it is: every session of the same
    frames ends with the same digest, the engine replay with its session's."""
    _, digests = audited
    engine, engine_session = digests.pop("engine"), digests.pop("engine_session")
    assert len(set(digests.values())) == 1
    assert engine == engine_session == digests["flat"]


def test_audit_reports_an_unmarked_helper_of_another_module():
    """A scratch body that calls a package function no rule scans (a width
    bucket in utils/shapes.py) is reported, and the hook is unset after."""
    from peritext_tpu_torch.utils import shapes

    def body(x):
        return x[: shapes.next_pow2(x.shape[0])] * 2

    with CaptureAudit() as audit:
        out = GraphCache("cpu").run(("scratch",), "scratch", body, (torch.arange(5),))
    assert GraphCache.audit is None
    assert out.tolist() == [0, 2, 4, 6, 8]
    assert audit.outside() == [("peritext_tpu_torch.utils.shapes", "next_pow2")]
    assert audit.summary()["scratch/scratch"]["outside"] == \
        ["peritext_tpu_torch.utils.shapes:next_pow2"]
    result, seen, outside = audit_call(shapes.next_pow2, 5)
    assert (result, seen, outside) == (8, [("peritext_tpu_torch.utils.shapes", "next_pow2")],
                                       [("peritext_tpu_torch.utils.shapes", "next_pow2")])


def test_every_marked_root_is_in_the_captured_set():
    """The marker's run-time registry and the rules' reading of the source
    agree: each function marked ``captured`` is a root the rules scan."""
    import importlib

    for module in sorted({m for m, _ in CAPTURE_ROOTS} | {
            "peritext_tpu_torch.ops.kernel", "peritext_tpu_torch.ops.ragged",
            "peritext_tpu_torch.parallel.streaming"}):
        importlib.import_module(module)
    assert CAPTURE_ROOTS and CAPTURE_ROOTS <= captured_set()


def test_the_capture_roots_of_the_four_sites():
    """The rules find a body at each of the four ``GraphCache.run`` sites,
    nested defs resolved in their enclosing function and the engine's bound
    method in its class."""
    import ast

    want = {"parallel/streaming.py": ["StreamingMerge._run_form.<locals>.body"] * 2,
            "store/session.py": ["PagedStreamingMerge._run_groups.<locals>.body",
                                 "RaggedStreamingMerge._run_ragged.<locals>.body"],
            "testing/engine.py": ["EngineReplay._pass"]}
    for path, names in want.items():
        tree = ast.parse((ROOT / "peritext_tpu_torch" / path).read_text())
        qual = astutil.qualnames(tree)
        bodies = sorted(qual[id(n)] for n in ast.walk(tree)
                        if id(n) in astutil.capture_roots(tree)
                        and not getattr(n, "decorator_list", None))  # not a marked root
        assert bodies == sorted(names), path
    ragged = astutil.capture_roots(ast.parse(
        (ROOT / "peritext_tpu_torch" / "store" / "session.py").read_text()))
    # the ragged body's depth is a key element: static, not captured
    assert any("k" not in spec.closure and "pool_elem" in spec.closure
               for spec in ragged.values())


def test_ragged_launch_plan_is_never_built_inside_a_capture(monkeypatch):
    """The ragged insert builds its own launch plan only outside a capture
    (its uploads would be frozen by address into the graph); inside one it
    raises, and the captured calls pass the plan built beforehand."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="never inside a CUDA-graph capture"):
        ragged_insert_mod._host_launch_plan(torch.zeros(2, dtype=torch.int32), None, (2, 1), 64,
                                            torch.device("cpu"), 0)

