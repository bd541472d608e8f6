"""The rest of the port's test harness against the reference's: the
differential fuzz, the checked fuzz steps, the patch-replay oracle, causal
waves, trace listing and the fuzz CLI.

* ``run_differential`` on a padded, a paged and a ragged port ``DocBatch``
  (``device="cpu"``), each against the scalar oracle, and on the padded one
  against the reference's own run of the same seed;
* ``run_differential_frames`` against the scalar oracle and the reference;
* ``fuzz_step(check=, faults=)`` with its per-sync patch-list oracle,
  ``full_sync`` and ``run_fuzz``: the same stores, texts, clocks and patch
  streams as the reference's for the same seed;
* ``accumulate_patches`` and ``causal_waves`` equal to the reference's;
* ``available_traces`` on a temporary directory;
* the CLI's exit codes: 0 on success, 2 on a bad flag combination, 1 when
  a campaign raises (``--mesh``, not ported).
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from peritext_tpu.api.batch import DocBatch as RefBatch
from peritext_tpu.core.types import Change as RefChange
from peritext_tpu.parallel.causal import causal_waves as ref_causal_waves
from peritext_tpu.parallel.faults import FaultSpec as RefFaultSpec
from peritext_tpu.testing import fuzz as ref_fuzz
from peritext_tpu.testing import traces as ref_traces
from peritext_tpu.testing.accumulate import accumulate_patches as ref_accumulate
from peritext_tpu_torch.api.batch import DocBatch
from peritext_tpu_torch.core.errors import PeritextError
from peritext_tpu_torch.parallel import causal_waves
from peritext_tpu_torch.parallel.faults import FaultSpec
from peritext_tpu_torch.testing import accumulate_patches, fuzz, traces

ROOT = Path(__file__).resolve().parent.parent
CAPS = dict(slot_capacity=512, mark_capacity=128, comment_capacity=32)


@pytest.mark.parametrize("layout", ("padded", "paged", "ragged"))
def test_run_differential_every_layout(layout):
    batch = DocBatch(device="cpu", layout=layout, **CAPS)
    assert fuzz.run_differential(3, 12, 80, batch=batch) == 12


def test_run_differential_equals_the_reference():
    port = fuzz.run_differential(1, 8, 60, device="cpu")
    assert port == ref_fuzz.run_differential(1, 8, 60, batch=RefBatch(**CAPS)) == 8


def test_run_differential_frames_equals_the_reference():
    port = fuzz.run_differential_frames(2, 6, 48, device="cpu")
    assert port == ref_fuzz.run_differential_frames(2, 6, 48) == 6


def _crossed(changes):
    return [RefChange.from_json(json.loads(json.dumps(c.to_json()))) for c in changes]


@pytest.mark.parametrize("seed", range(3))
def test_checked_fuzz_equals_the_reference(seed):
    port = fuzz.run_fuzz(seed, 120, check=True)
    ref = ref_fuzz.run_fuzz(seed, 120, check=True)
    assert (port.ops_generated, port.syncs) == (ref.ops_generated, ref.syncs)
    for actor in ref.store.actors():
        assert [c.to_json() for c in port.store.log(actor)] == \
            [c.to_json() for c in ref.store.log(actor)]
    assert port.patch_lists == ref.patch_lists
    for idx, doc in enumerate(port.docs):
        assert accumulate_patches(port.patch_lists[idx]) == doc.get_text_with_formatting(["text"])


@pytest.mark.parametrize("seed", range(2))
def test_faulty_fuzz_then_full_sync_equals_the_reference(seed):
    port = fuzz.run_fuzz(seed, 150, faults=FaultSpec(drop_p=0.1, dup_p=0.1, reorder=True))
    ref = ref_fuzz.run_fuzz(seed, 150, faults=RefFaultSpec(drop_p=0.1, dup_p=0.1, reorder=True))
    assert [d.clock for d in port.docs] == [d.clock for d in ref.docs]
    fuzz.full_sync(port)
    ref_fuzz.full_sync(ref)
    texts = [d.get_text_with_formatting(["text"]) for d in port.docs]
    assert texts == [d.get_text_with_formatting(["text"]) for d in ref.docs]
    assert all(t == texts[0] for t in texts)
    assert all(d.clock == port.store.clock() for d in port.docs)
    assert port.patch_lists == ref.patch_lists
    for idx, doc in enumerate(port.docs):
        assert accumulate_patches(port.patch_lists[idx]) == texts[idx]


def test_unchecked_workloads_are_unchanged_by_the_checks():
    """The checks draw nothing from the rng: the generated workloads equal
    the reference's."""
    port = fuzz.generate_workload(4, num_docs=3, ops_per_doc=30)
    ref = ref_fuzz.generate_workload(4, num_docs=3, ops_per_doc=30)
    assert [{a: [c.to_json() for c in log] for a, log in w.items()} for w in port] == \
        [{a: [c.to_json() for c in log] for a, log in w.items()} for w in ref]


@pytest.mark.parametrize("seed", range(3))
def test_accumulate_patches_equals_the_reference(seed):
    state = fuzz.run_fuzz(seed, 80, check=False)
    for patches in state.patch_lists:
        assert accumulate_patches(patches) == ref_accumulate(patches)
    with pytest.raises(ValueError):
        accumulate_patches([{"path": ["other"], "action": "insert"}])
    with pytest.raises(ValueError):
        accumulate_patches([{"path": ["text"], "action": "teleport"}])


@pytest.mark.parametrize("seed", range(3))
def test_causal_waves_equal_the_reference(seed):
    import random

    workload = fuzz.generate_workload(seed, num_docs=1, ops_per_doc=40)[0]
    changes = [c for log in workload.values() for c in log]
    random.Random(seed).shuffle(changes)
    changes += changes[:3]  # duplicates are skipped
    base = {changes[0].actor: 1}
    for clock in (None, base):
        port = [[(c.actor, c.seq) for c in wave] for wave in causal_waves(changes, clock)]
        ref = [[(c.actor, c.seq) for c in wave]
               for wave in ref_causal_waves(_crossed(changes), clock)]
        assert port == ref and len(port) > 1
    gap = [c for c in changes if not (c.actor == changes[0].actor and c.seq == 1)]
    with pytest.raises(PeritextError, match="Causal gap"):
        causal_waves(gap)


def test_available_traces(tmp_path):
    assert traces.available_traces(str(tmp_path / "absent")) == []
    for name in ("b.json", "a.json", "notes.txt"):
        (tmp_path / name).write_text("{}")
    listed = traces.available_traces(str(tmp_path))
    assert listed == ref_traces.available_traces(str(tmp_path))
    assert [Path(p).name for p in listed] == ["a.json", "b.json"]
    assert Path(traces.REFERENCE_TRACES_DIR) == ROOT / "traces"


def test_cli_exit_codes(capsys):
    assert fuzz.main(["--iterations", "30", "--seed", "5"]) is None
    assert "all convergence oracles passed" in capsys.readouterr().out
    assert fuzz.main(["--iterations", "60", "--faults"]) is None
    assert "repaired + converged" in capsys.readouterr().out
    assert fuzz.main(["--differential", "--docs", "4", "--ops-per-doc", "30",
                      "--device", "cpu"]) is None
    assert "(4 on device) match the oracle" in capsys.readouterr().out
    assert fuzz.main(["--differential-frames", "--docs", "3", "--ops-per-doc", "30",
                      "--device", "cpu"]) is None
    assert fuzz.main(["--crash-restore", "--docs", "3", "--ops-per-doc", "30",
                      "--device", "cpu"]) is None
    for bad in (["--faults", "--differential"], ["--crash-restore", "--differential"]):
        with pytest.raises(SystemExit) as exc:
            fuzz.main(bad)
        assert exc.value.code == 2
    assert fuzz.main(["--differential", "--mesh", "2", "--device", "cpu", "--docs", "4",
                      "--ops-per-doc", "30"]) is None
    assert "(4 on device) match the oracle" in capsys.readouterr().out
    assert fuzz.main(["--crash-restore", "--mesh", "3", "--device", "cpu", "--docs", "3",
                      "--ops-per-doc", "30"]) is None
    assert "survived kill+restore+repair" in capsys.readouterr().out


def test_cli_module_exit_codes():
    run = lambda *args: subprocess.run(  # noqa: E731
        [sys.executable, "-m", "peritext_tpu_torch.testing.fuzz", *args], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    ok = run("--iterations", "20")
    assert ok.returncode == 0 and "RuntimeWarning" not in ok.stderr, ok.stderr
    assert run("--faults", "--differential-frames").returncode == 2
    # --mesh takes cards unless --device names the CPU, and there are none
    failed = run("--mesh", "2")
    assert failed.returncode == 1 and "need 2 CUDA devices" in failed.stderr


@pytest.mark.parametrize("seed", range(4))
def test_adding_changes_marks_equals_resolving_both_sets(seed):
    """The span walk's shortcut (does adding one mark op change the resolved
    marks?) answers as resolving the set with and without it does."""
    import random

    from peritext_tpu_torch.core.opids import ROOT as OBJ
    from peritext_tpu_torch.core.spans import adding_changes_marks, ops_to_marks
    from peritext_tpu_torch.core.types import Operation

    rng = random.Random(seed)

    def mark_op(counter):
        mark_type = rng.choice(("strong", "em", "link", "comment"))
        attrs = {"url": rng.choice("ab")} if mark_type == "link" else \
            {"id": rng.choice("xyz")} if mark_type == "comment" else {}
        return Operation(action=rng.choice(("addMark", "removeMark")), obj=OBJ,
                         opid=(counter, rng.choice(("doc1", "doc2"))),
                         mark_type=mark_type, attrs=attrs)

    for _ in range(400):
        ops = {}
        for _ in range(rng.randrange(8)):
            op = mark_op(rng.randrange(1, 12))
            ops[op.opid] = op
        op = rng.choice(list(ops.values())) if ops and rng.random() < 0.1 else \
            mark_op(rng.randrange(1, 12))
        expected = ops_to_marks(ops.values()) != ops_to_marks({**ops, op.opid: op}.values())
        assert adding_changes_marks(ops, op) == expected
