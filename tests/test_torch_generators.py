"""The port's fixture generators, its fifo arrival model and its append
A/Bs (``scripts/torch_gen_pm_fixtures.py``, ``torch_gen_wire_dict.py``,
``torch_append_ab.py``, ``torch_append_flat_ab.py``) on the CPU, against
the checked-in files and the reference package.

* Each generator's output is byte-equal to the checked-in files it
  regenerates (``tests/pm_fixtures/*.json``; the port's and the
  reference's ``wire_preset.bin``), written only to ``--out``; pointed at
  the checked-in files it refuses and writes nothing.
* ``testing.arrival.build_arrival(..., arrival_model="fifo")`` equals the
  reference bench's ``build_arrival(..., as_frames=False,
  arrival_model="fifo")`` batch by batch, change by change (and frame by
  frame as v2 frames); the default stays the shuffle model, and an unknown
  model raises.
* Both A/Bs exit 0 at a tiny size with their arms equal, and every append
  form equals the reference's ``ops/kernel.py`` ``_append_rows`` on the
  same numpy inputs, dropped writes past the table included.
"""

import contextlib
import importlib.util
import io
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import bench
from peritext_tpu.ops import kernel as ref_kernel
from peritext_tpu.testing.fuzz import generate_workload as jax_generate_workload
from peritext_tpu_torch.ops import kernel
from peritext_tpu_torch.testing.arrival import build_arrival
from peritext_tpu_torch.testing.fuzz import generate_workload

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "pm_fixtures"
PRESETS = (ROOT / "peritext_tpu_torch" / "parallel" / "wire_preset.bin",
           ROOT / "peritext_tpu" / "parallel" / "wire_preset.bin")


def _script(name):
    spec = importlib.util.spec_from_file_location(f"scripts_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(name, argv):
    with contextlib.redirect_stdout(io.StringIO()) as out, \
            contextlib.redirect_stderr(io.StringIO()):
        rc = _script(name).main(argv)
    return rc, out.getvalue().splitlines()


def test_pm_fixture_generator_reproduces_the_checked_in_fixtures(tmp_path):
    rc, lines = _run("torch_gen_pm_fixtures", ["--out", str(tmp_path)])
    assert rc == 0
    want = sorted(p.name for p in FIXTURES.glob("*.json"))
    assert sorted(p.name for p in tmp_path.iterdir()) == want and len(lines) == len(want)
    for name in want:
        assert (tmp_path / name).read_bytes() == (FIXTURES / name).read_bytes(), name


def test_wire_dict_generator_reproduces_wire_preset(tmp_path):
    out = tmp_path / "wire_preset.bin"
    rc, lines = _run("torch_gen_wire_dict", ["--out", str(out)])
    assert rc == 0 and lines == [f"wrote {out.stat().st_size} bytes to {out}"]
    for preset in PRESETS:
        assert out.read_bytes() == preset.read_bytes(), preset


def test_generators_refuse_the_checked_in_files():
    before = {p: p.read_bytes() for p in [*FIXTURES.glob("*.json"), *PRESETS]}
    assert _run("torch_gen_pm_fixtures", ["--out", str(FIXTURES)])[0] == 2
    for preset in PRESETS:
        assert _run("torch_gen_wire_dict", ["--out", str(preset)])[0] == 2
    assert {p: p.read_bytes() for p in before} == before


def _key(ch):
    return ch.to_json()


@pytest.mark.parametrize("seed", [0, 7, 999])
def test_fifo_arrival_equals_the_reference(seed):
    docs, ops, rounds = 4, 48, 3
    ours = build_arrival(generate_workload(seed, docs, ops), rounds, seed,
                         arrival_model="fifo")
    theirs, _ = bench.build_arrival(jax_generate_workload(seed, docs, ops), rounds, seed,
                                    as_frames=False, arrival_model="fifo")
    assert len(ours) == len(theirs) == docs
    for a, b in zip(ours, theirs):
        assert [[_key(c) for c in batch] for batch in a] == \
            [[_key(c) for c in batch] for batch in b]
    frames, wire_bytes = build_arrival(generate_workload(seed, docs, ops), rounds, seed,
                                       as_frames=True, arrival_model="fifo")
    ref_frames, ref_bytes = bench.build_arrival(jax_generate_workload(seed, docs, ops), rounds,
                                                seed, as_frames=True, arrival_model="fifo")
    assert frames == ref_frames and wire_bytes == ref_bytes


def test_fifo_keeps_each_senders_order_and_shuffle_stays_the_default():
    workloads = generate_workload(3, 3, 40)
    for doc, batches in zip(workloads, build_arrival(workloads, 4, 3, arrival_model="fifo")):
        seen = [ch for batch in batches for ch in batch]
        for actor, log in doc.items():
            assert [c.seq for c in seen if c.actor == actor] == [c.seq for c in log]
    default = build_arrival(workloads, 4, 3)
    assert [[[_key(c) for c in b] for b in d] for d in default] == \
        [[[_key(c) for c in b] for b in d]
         for d in build_arrival(workloads, 4, 3, arrival_model="shuffle")]
    theirs, _ = bench.build_arrival(jax_generate_workload(3, 3, 40), 4, 3, as_frames=False)
    assert [[[_key(c) for c in b] for b in d] for d in default] == \
        [[[_key(c) for c in b] for b in d] for d in theirs]
    with pytest.raises(ValueError, match="arrival model"):
        build_arrival(workloads, 4, 3, arrival_model="lifo")


def _append_inputs(seed, docs=16, cap=12, km=10, cols=3):
    """Tables with counts near capacity, so some rows' writes fall past the
    table and must drop."""
    rng = np.random.default_rng(seed)
    names = [f"c{i}" for i in range(cols)]
    table = {c: rng.integers(1, 1000, (docs, cap)).astype(np.int32) for c in names}
    rows = {c: rng.integers(1, 1000, (docs, km)).astype(np.int32) for c in names}
    count = rng.integers(0, cap + 1, docs).astype(np.int32)
    rows_count = rng.integers(0, km + 1, docs).astype(np.int32)
    return table, count, rows, rows_count


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_append_forms_equal_the_reference_append_rows(seed):
    table, count, rows, rows_count = _append_inputs(seed)
    assert ((count + rows_count) > table["c0"].shape[1]).any()  # some writes drop
    ref = jax.vmap(ref_kernel._append_rows)(table, count, rows, rows_count)
    t = lambda a: torch.from_numpy(a.copy())  # noqa: E731
    args = ({c: t(v) for c, v in table.items()}, t(count), {c: t(v) for c, v in rows.items()},
            t(rows_count))
    forms = {"kernel": kernel._append_rows,
             "scatter": _script("torch_append_ab").scatter_append,
             "flat": _script("torch_append_flat_ab").flat_append}
    for name, form in forms.items():
        out, new_count, overflow = form(*args)
        for c in table:
            np.testing.assert_array_equal(out[c].numpy(), np.asarray(ref[0][c]), err_msg=name)
        np.testing.assert_array_equal(new_count.numpy(), np.asarray(ref[1]), err_msg=name)
        np.testing.assert_array_equal(overflow.numpy(), np.asarray(ref[2]), err_msg=name)


def test_append_ab_arms_are_equal_on_the_cpu():
    rc, lines = _run("torch_append_ab", ["--docs", "32", "--ops-per-doc", "40", "--reps", "1",
                                         "--device", "cpu"])
    assert rc == 0
    assert lines[0] == "device: cpu"
    assert [line.split(":")[0].strip() for line in lines[1:5]] == \
        ["gather", "scatter", "gather2", "scatter2"]
    assert re.match(r"arms equal: num_slots \d+, state digest 0x[0-9a-f]{8}$", lines[-1])
    assert kernel._append_rows.__module__ == "peritext_tpu_torch.ops.kernel"  # restored


def test_append_flat_ab_arms_are_equal_on_the_cpu():
    rc, lines = _run("torch_append_flat_ab", ["--docs", "64", "--reps", "2", "--device", "cpu"])
    assert rc == 0
    assert lines[:2] == ["device: cpu", "equivalent outputs ok"]
    assert [line.split(":")[0] for line in lines[2:]] == ["batched", "flat", "batched", "flat"]
