"""The port's padded ``DocBatch.merge`` (the slice end to end) against the
reference package's ``DocBatch`` and the scalar oracle, on the CPU; and the
port's isolation from JAX and from the reference package.

Workloads come from the reference's ``testing.fuzz`` and cross to the port
through the wire format.  Spans, roots, cursor positions and the set of
fallback docs must be equal.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from peritext_tpu.api.batch import DocBatch as JaxDocBatch
from peritext_tpu.api.batch import _oracle_doc as jax_oracle_doc
from peritext_tpu.api.batch import oracle_merge as jax_oracle_merge
from peritext_tpu.core.comment import Comment, put_comment
from peritext_tpu.core.doc import Doc as JaxDoc
from peritext_tpu.testing.fuzz import generate_markheavy_workload, generate_workload
from peritext_tpu_torch.api.batch import DocBatch, oracle_merge
from peritext_tpu_torch.core.types import Change
from peritext_tpu_torch.parallel.mesh import make_mesh
from peritext_tpu_torch.testing import fuzz as port_fuzz

ROOT = Path(__file__).resolve().parent.parent


def _to_port(workloads):
    return [{a: [Change.from_json(c.to_json()) for c in log] for a, log in w.items()}
            for w in workloads]


def _wire(workloads):
    return [{a: [c.to_json() for c in log] for a, log in w.items()} for w in workloads]


def _cursors(workloads, seed, per_doc=3):
    """Reference-shaped cursors from the oracle docs (visible elements)."""
    import random

    rng = random.Random(seed)
    out = []
    for w in workloads:
        doc = jax_oracle_doc(w)
        n = len(doc.root.get("text", []))
        out.append([doc.get_cursor(["text"], rng.randrange(n)) for _ in range(per_doc)]
                   if n else [])
    return out


def _with_comment_bodies(workloads):
    for d, w in enumerate(workloads):
        if d % 2 == 0:
            change, _ = put_comment(
                JaxDoc("commenter"), Comment(id=f"cb-{d}", actor="commenter", content="b")
            )
            w["commenter"] = [change]
    return workloads


FAMILIES = {
    # name: (workloads, DocBatch capacities)
    "fuzz": (lambda: generate_workload(5, 6, 40), dict(slot_capacity=128, mark_capacity=64)),
    "markheavy": (lambda: generate_markheavy_workload(2, 4, 60),
                  dict(slot_capacity=128, mark_capacity=64)),
    "maps": (lambda: _with_comment_bodies(generate_workload(17, 4, 30)),
             dict(slot_capacity=128, mark_capacity=64)),
    # docs 0, 1 exceed the mark capacity (encode-time fallback), docs 3, 4
    # overflow their slots on the device; docs 2, 5 stay on the device
    "fallback": (lambda: generate_workload(23, 6, 60), dict(slot_capacity=28, mark_capacity=16)),
}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_merge_equals_reference_and_oracle(name):
    make, caps = FAMILIES[name]
    workloads = make()
    cursors = _cursors(workloads, seed=len(name))
    theirs = JaxDocBatch(**caps).merge(workloads, cursors=cursors)
    ours = DocBatch(device="cpu", **caps).merge(_to_port(workloads), cursors=cursors)
    assert ours.fallback_docs == theirs.fallback_docs
    assert ours.spans == theirs.spans
    assert ours.roots == theirs.roots
    assert ours.cursor_positions == theirs.cursor_positions
    assert ours.spans == jax_oracle_merge(workloads)
    assert ours.spans == oracle_merge(_to_port(workloads))
    assert ours.device_ops == theirs.device_ops
    if name == "fallback":
        assert ours.fallback_docs == [0, 1, 3, 4]
    else:
        assert ours.fallback_docs == []
    stats = ours.stats
    assert stats.device_docs + stats.fallback_docs == len(workloads)
    assert stats.padding_efficiency == pytest.approx(theirs.stats.padding_efficiency)


@pytest.mark.parametrize("maker", ["generate_workload", "generate_markheavy_workload"])
def test_port_generator_equals_reference(maker):
    ours = getattr(port_fuzz, maker)(9, 3, 30)
    theirs = {"generate_workload": generate_workload,
              "generate_markheavy_workload": generate_markheavy_workload}[maker](9, 3, 30)
    assert _wire(ours) == _wire(theirs)


def test_sample_cursors_resolve_like_oracle():
    workloads = port_fuzz.generate_workload(3, 4, 40)
    cursors = port_fuzz.sample_cursors(workloads, 4, seed=1)
    report = DocBatch(device="cpu", slot_capacity=128).merge(workloads, cursors)
    from peritext_tpu_torch.api.batch import _oracle_doc

    for d, w in enumerate(workloads):
        doc = _oracle_doc(w)
        assert report.cursor_positions[d] == [doc.resolve_cursor(c) for c in cursors[d]]


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DocBatch()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DocBatch(device="cuda")


@pytest.mark.parametrize("kwargs,error,item", [
    (dict(mesh=object()), TypeError, "parallel.mesh.Mesh"),
    (dict(layout="paged", mesh=make_mesh(2, device="cpu")), ValueError, "does not support a mesh"),
    (dict(layout="ragged", mesh=make_mesh(2, device="cpu")), ValueError, "does not support a mesh"),
    (dict(mesh=make_mesh(2, device="cpu"), device="cuda"), ValueError, "device type"),
])
def test_unported_options_raise(kwargs, error, item):
    """The mesh is ported on the padded layout (tests/test_torch_mesh.py);
    what it refuses, it refuses as the reference does."""
    with pytest.raises(error, match=item):
        DocBatch(**dict(dict(device="cpu"), **kwargs))
    assert DocBatch(mesh=make_mesh(2, device="cpu")).mesh.size == 2


def test_import_leaves_jax_and_reference_out():
    code = (
        "import sys, peritext_tpu_torch, peritext_tpu_torch.api, peritext_tpu_torch.ops, "
        "peritext_tpu_torch.store, peritext_tpu_torch.testing, "
        "peritext_tpu_torch.parallel.streaming, peritext_tpu_torch.parallel.mesh, "
        "peritext_tpu_torch.ops.patches, peritext_tpu_torch.native, "
        "peritext_tpu_torch.parallel.codec, peritext_tpu_torch.ops.frames, "
        "peritext_tpu_torch.store.session, peritext_tpu_torch.parallel.faults, "
        "peritext_tpu_torch.bridge, peritext_tpu_torch.bridge.commands, "
        "peritext_tpu_torch.bridge.pm, peritext_tpu_torch.bridge.playback, "
        "peritext_tpu_torch.checkpoint, peritext_tpu_torch.core.comment, "
        "peritext_tpu_torch.parallel.pubsub, peritext_tpu_torch.parallel.change_queue, "
        "peritext_tpu_torch.testing.traces, peritext_tpu_torch.obs, peritext_tpu_torch.serve, "
        "peritext_tpu_torch.parallel.supervisor, peritext_tpu_torch.plan, "
        "peritext_tpu_torch.plan.fusion, peritext_tpu_torch.serve.fused, "
        "peritext_tpu_torch.serve.fleet, peritext_tpu_torch.parallel.multihost, "
        "peritext_tpu_torch.parallel.gossip, peritext_tpu_torch.parallel.lease, "
        "peritext_tpu_torch.parallel.router, peritext_tpu_torch.parallel.anti_entropy, "
        "peritext_tpu_torch.obs.convergence, peritext_tpu_torch.obs.incidents, "
        "peritext_tpu_torch.obs.events, peritext_tpu_torch.testing.accumulate, "
        "peritext_tpu_torch.testing.fuzz, peritext_tpu_torch.testing.chaos, "
        "peritext_tpu_torch.obs.devprof, peritext_tpu_torch.obs.sentinel, "
        "peritext_tpu_torch.obs.ledger, peritext_tpu_torch.obs.exporters, "
        "peritext_tpu_torch.observability, peritext_tpu_torch.testing.baseline, "
        "peritext_tpu_torch.testing.engine, peritext_tpu_torch.analysis, "
        "peritext_tpu_torch.analysis.__main__, peritext_tpu_torch.analysis.rules\n"
        "sys.path.insert(0, 'tests')\n"
        "import test_torch_fleet_cuda, test_torch_chaos_cuda, test_torch_devprof_cuda\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'peritext_tpu' or m.startswith('peritext_tpu.'))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_sources_import_no_jax_or_reference():
    """Every line that imports names neither jax nor the reference package
    (chip_smoke.py may name a reference file as the kernel a port replaces)."""
    reference = re.compile(r"\bperitext_tpu\b(?!_torch)")
    jax = re.compile(r"\bjax\b")
    files = sorted((ROOT / "peritext_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    walked = {p.relative_to(ROOT).as_posix() for p in files}
    assert {"peritext_tpu_torch/testing/baseline.py", "peritext_tpu_torch/testing/engine.py",
            "peritext_tpu_torch/analysis/astutil.py",
            "peritext_tpu_torch/analysis/rules/ptl007_ragged_bucket_free.py"} <= walked
    for path in files:
        for line in path.read_text().splitlines():
            if "import" in line:
                assert not reference.search(line), f"{path}: {line}"
                assert not jax.search(line), f"{path}: {line}"
