"""The port's scalar baseline (peritext_tpu_torch/testing/baseline.py over
the port's native library) against the reference package's, exactly, on
seeded fuzz workloads: the parsed op matrices and their total, each
matrix's scalar apply, and the oracle check, which passes on true matrices
and raises on a corrupted one in both.  Without its native library the
port's ``scalar_apply`` raises (the reference returns None).
"""

import pytest

from peritext_tpu import native as jax_native
from peritext_tpu.testing import baseline as jax_baseline
from peritext_tpu.testing.fuzz import generate_workload as jax_generate_workload
from peritext_tpu_torch import native
from peritext_tpu_torch.testing import baseline
from peritext_tpu_torch.testing.fuzz import generate_workload

SEEDS = (0, 7, 11)
DOCS, OPS = 8, 64


@pytest.fixture(scope="module")
def workloads():
    """Per seed: (reference workloads, port workloads), each generated by
    its own package from the same seed."""
    return {seed: (jax_generate_workload(seed, num_docs=DOCS, ops_per_doc=OPS),
                   generate_workload(seed, num_docs=DOCS, ops_per_doc=OPS))
            for seed in SEEDS}


@pytest.fixture(scope="module")
def matrices(workloads):
    """Per seed: ((reference matrices, total), (port matrices, total))."""
    return {seed: (jax_baseline.workload_op_matrices(ref), baseline.workload_op_matrices(port))
            for seed, (ref, port) in workloads.items()}


@pytest.mark.parametrize("seed", SEEDS)
def test_workload_op_matrices_byte_equal(matrices, seed):
    (want, want_total), (got, got_total) = matrices[seed]
    assert got_total == want_total > 0
    assert len(got) == len(want) == DOCS
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and a.shape[1] == 10
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", SEEDS)
def test_scalar_apply_equals_reference(matrices, seed):
    (want, _), (got, _) = matrices[seed]
    calls = native.calls.get("scalar_apply", 0)
    for a, b in zip(got, want):
        applied, text = native.scalar_apply(a)
        ref_applied, ref_text = jax_native.scalar_apply(b)
        assert applied == ref_applied > 0
        assert text.dtype == ref_text.dtype and text.tobytes() == ref_text.tobytes()
    assert native.calls["scalar_apply"] - calls == len(got)


@pytest.mark.parametrize("seed", SEEDS)
def test_oracle_check_passes_in_both(workloads, matrices, seed):
    ref, port = workloads[seed]
    (want, _), (got, _) = matrices[seed]
    jax_baseline.check_scalar_apply_matches_oracle(ref, want)
    baseline.check_scalar_apply_matches_oracle(port, got)


def _corrupt(ms):
    """The matrices with every inserted character shifted by one: the
    applied text of any doc with visible text differs from the oracle's."""
    out = [m.copy() for m in ms]
    for m in out:
        m[m[:, 0] == 0, 4] += 1
    return out


def test_oracle_check_raises_on_corrupt_matrix_in_both(workloads, matrices):
    ref, port = workloads[SEEDS[0]]
    (want, _), (got, _) = matrices[SEEDS[0]]
    with pytest.raises(RuntimeError, match="diverged from the oracle"):
        jax_baseline.check_scalar_apply_matches_oracle(ref, _corrupt(want))
    with pytest.raises(RuntimeError, match="diverged from the oracle"):
        baseline.check_scalar_apply_matches_oracle(port, _corrupt(got))


def test_scalar_apply_raises_without_library(matrices, monkeypatch):
    (_, _), (got, _) = matrices[SEEDS[0]]
    monkeypatch.setattr(native, "load", lambda: None)
    calls = native.calls.get("scalar_apply", 0)
    with pytest.raises(RuntimeError, match="native host library is unavailable"):
        native.scalar_apply(got[0])
    assert native.calls.get("scalar_apply", 0) == calls
