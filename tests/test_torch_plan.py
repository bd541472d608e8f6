"""The port's planner (``peritext_tpu_torch/plan/model.py``, ``tuner.py``)
against the reference package's, on the CPU.

* On the committed ``perf/plan_devprof.json`` (the reference's capture):
  ``propose(...).to_json()`` byte-equal (``json.dumps(sort_keys=True)``)
  with and without ``perf/reference_ledger.jsonl``, an occupancy history,
  a memory peak and tolerances 0.1 and 1e6; and each ``CostModel`` term
  alone, on the observed configuration and on the candidate grid.
* Twin CPU sessions at small size, costs off: a padded (default,
  block-chunked, ``fused_pipeline=False``, ``static_rounds=True``), a
  paged and a ragged ``StreamingMerge``, and a ``DocBatch`` merge per
  layout, fed the same changes in both packages: ``observed_config`` and
  the whole proposal equal.  This holds the fused-depth mapping of the
  port's commit sites (ROADMAP.md section 3).  One twin differs and is
  pinned by name: a padded session whose every drain commits one round
  reads ``fused_depth`` 8 on the port (its snapshot cannot tell a one-round
  batch from a longer one) and 1 on the reference (its single-round form).
* A port snapshot with costs captured has no flop count: the model prices
  it in padded-op units, and its ``executable_bytes`` reads the buckets'
  argument + output bytes.
* The reference's ``TestPlanProposal`` cases held against the port, and
  ``health_snapshot(plan=)`` / ``prometheus_text(plan=)`` equal to the
  reference's for the same proposal.
"""

import json
import random
from pathlib import Path

import pytest

from peritext_tpu.api.batch import DocBatch as JaxDocBatch
from peritext_tpu.obs import GLOBAL_DEVPROF as JAX_DEVPROF
from peritext_tpu.obs import health_snapshot as jax_health_snapshot
from peritext_tpu.obs import prometheus_text as jax_prometheus_text
from peritext_tpu.obs.__main__ import main as jax_obs_main
from peritext_tpu.parallel.streaming import StreamingMerge as JaxStreamingMerge
from peritext_tpu.plan import CostModel as JaxCostModel
from peritext_tpu.plan import propose as jax_propose
from peritext_tpu.testing.fuzz import generate_workload
from peritext_tpu_torch.api.batch import DocBatch
from peritext_tpu_torch.core.types import Change
from peritext_tpu_torch.obs import GLOBAL_DEVPROF, health_snapshot, prometheus_text
from peritext_tpu_torch.obs.__main__ import main as obs_main
from peritext_tpu_torch.parallel.streaming import StreamingMerge
from peritext_tpu_torch.plan import (
    CostModel,
    PlanProposal,
    history_values,
    load_devprof,
    propose,
)
from peritext_tpu_torch.plan import model as model_mod
from peritext_tpu_torch.plan.tuner import DEFAULT_TOLERANCE, FUSED_DEPTHS

ROOT = Path(__file__).resolve().parents[1]
SNAPSHOT = ROOT / "perf" / "plan_devprof.json"
LEDGER = ROOT / "perf" / "reference_ledger.jsonl"
ACTORS = ("doc1", "doc2", "doc3")
#: an occupancy history of fused windows (the history plane's rows)
HISTORY = [0.125, 0.25, 0.9, 0.3, 0.75, 0.05, 1.0, 0.4]
STREAM = dict(docs=8, ops=48, seed=14, rounds=3)
STREAM_CAPS = dict(slot_capacity=256, mark_capacity=64, tomb_capacity=64,
                   round_insert_capacity=32, round_delete_capacity=16,
                   round_mark_capacity=16, round_map_capacity=8)
#: round widths that admit every change of a doc in one round
WIDE_CAPS = dict(STREAM_CAPS, round_insert_capacity=256, round_delete_capacity=128,
                 round_mark_capacity=128, round_map_capacity=64)
TERMS = ("observed_config", "padded_flops", "recompiles", "dispatches", "executable_bytes",
         "memory_budget", "utilization", "occupancy_distribution")


def _canon(obj):
    return json.dumps(obj, sort_keys=True)


def _ledger_records():
    return [json.loads(line) for line in LEDGER.read_text().splitlines() if line.strip()]


def _snapshot(peak=None):
    snap = json.loads(SNAPSHOT.read_text())
    if peak is not None:
        snap["memory"] = dict(snap["memory"], available=True, peak_bytes_in_use=peak)
    return snap


# ---------------------------------------------------------------------------
# the committed snapshot: whole proposals and each term
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tolerance", [0.1, 1e6])
@pytest.mark.parametrize("history", [None, HISTORY], ids=["no_history", "history"])
@pytest.mark.parametrize("with_ledger", [False, True], ids=["no_ledger", "ledger"])
def test_proposal_equals_the_reference_on_the_committed_snapshot(with_ledger, history,
                                                                 tolerance):
    records = _ledger_records() if with_ledger else None
    ours = propose(SNAPSHOT, records, history=history, tolerance=tolerance)
    ref = jax_propose(SNAPSHOT, records, history=history, tolerance=tolerance)
    assert _canon(ours.to_json()) == _canon(ref.to_json())
    assert ours.beats_current(tolerance) == ref.beats_current(tolerance)


@pytest.mark.parametrize("peak", [1 << 20, 1 << 26, 40 << 30],
                         ids=["budget_excludes_all", "budget_bites", "budget_roomy"])
def test_proposal_equals_the_reference_under_a_memory_budget(peak):
    """A card's snapshot has the allocator's peak: the budget and what it
    excludes come out the same in both packages."""
    snap = _snapshot(peak)
    ours, ref = propose(snap).to_json(), jax_propose(snap).to_json()
    assert _canon(ours) == _canon(ref)
    assert ours["modeled"]["budget_bytes"] == peak


def _candidates(model):
    obs = model.observed_config()
    out = [obs]
    for depth in FUSED_DEPTHS:
        for shrink in (1, 2):
            cand = dict(obs, fused_depth=depth, slot_capacity=max(64, obs["slot_capacity"] // shrink))
            for k in ("insert_width", "delete_width", "mark_width", "map_width"):
                cand[k] = max(4, obs[k] // shrink)
            out.append(cand)
    out.append(dict(obs, shards=4))
    return out


@pytest.mark.parametrize("term", TERMS)
def test_cost_model_term_equals_the_reference(term):
    for history in (None, HISTORY):
        for snap in (_snapshot(), _snapshot(1 << 26)):
            ours = CostModel(snap, occupancy_history=history)
            ref = JaxCostModel(snap, occupancy_history=history)
            if term in ("observed_config", "memory_budget", "utilization",
                        "occupancy_distribution"):
                assert _canon(getattr(ours, term)()) == _canon(getattr(ref, term)())
            else:
                for cand in _candidates(ref):
                    assert getattr(ours, term)(cand) == getattr(ref, term)(cand), cand
            assert ours.score(ours.observed_config()) == ref.score(ref.observed_config())


def test_history_values_normalizes_like_the_reference():
    from peritext_tpu.plan import history_values as jax_history_values

    rows = [{"occupancy": v, "round": i} for i, v in enumerate(HISTORY)]
    for form in (None, HISTORY, rows, {"occupancy_rows": rows}):
        assert history_values(form) == jax_history_values(form)


# ---------------------------------------------------------------------------
# twin CPU sessions: the fused-depth mapping of the port's commit sites
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stream_arrival():
    ref_w = generate_workload(STREAM["seed"], num_docs=STREAM["docs"], ops_per_doc=STREAM["ops"])
    rng = random.Random(STREAM["seed"])
    ref = []
    for w in ref_w:
        chs = [ch for log in w.values() for ch in log]
        rng.shuffle(chs)
        size = -(-len(chs) // STREAM["rounds"])
        ref.append([chs[i:i + size] for i in range(0, len(chs), size)])
    port = [[[Change.from_json(c.to_json()) for c in b] for b in doc] for doc in ref]
    return ref_w, ref, port


def _armed(run_ref, run_port):
    """Both packages' profilers armed (costs off) around one twin run;
    returns the two snapshots."""
    for p in (GLOBAL_DEVPROF, JAX_DEVPROF):
        p.reset()
        p.enable(capture_costs=False)
    try:
        run_ref()
        run_port()
        return GLOBAL_DEVPROF.snapshot(), JAX_DEVPROF.snapshot()
    finally:
        for p in (GLOBAL_DEVPROF, JAX_DEVPROF):
            p.disable()
            p.reset()


def _feed_rounds(s, arrival):
    for r in range(STREAM["rounds"]):
        for d, batches in enumerate(arrival):
            if r < len(batches):
                s.ingest(d, batches[r])
        s.drain()
    return s


#: twin session arms: (StreamingMerge kwargs, attributes set after build)
SESSION_ARMS = {
    "padded": ({}, {}),
    "padded_block_chunked": (dict(read_chunk=4), {}),
    "padded_fused_pipeline_off": ({}, dict(fused_pipeline=False)),
    "padded_static_rounds": (dict(static_rounds=True), {}),
    "paged": (dict(layout="paged"), {}),
    "ragged": (dict(layout="ragged"), {}),
}
#: what the reference reads for each arm (its staged / stacked programs)
WANT_DEPTH = {"padded": 8, "padded_block_chunked": 1, "padded_fused_pipeline_off": 1,
              "padded_static_rounds": 8, "paged": 1, "ragged": 1}


@pytest.mark.parametrize("arm", list(SESSION_ARMS))
def test_twin_session_observed_config_equals_the_reference(stream_arrival, arm):
    _, ref_arr, port_arr = stream_arrival
    kw, attrs = SESSION_ARMS[arm]
    sessions = []

    def build(cls, arrival, **extra):
        s = cls(num_docs=len(arrival), actors=ACTORS, **STREAM_CAPS, **kw, **extra)
        for k, v in attrs.items():
            setattr(s, k, v)
        sessions.append(_feed_rounds(s, arrival))

    ours, ref = _armed(lambda: build(JaxStreamingMerge, ref_arr),
                       lambda: build(StreamingMerge, port_arr, device="cpu"))
    assert sessions[0].read_all() == sessions[1].read_all()
    assert CostModel(ours).observed_config() == JaxCostModel(ref).observed_config()
    assert CostModel(ours).observed_config()["fused_depth"] == WANT_DEPTH[arm]
    assert _canon(propose(ours).to_json()) == _canon(jax_propose(ref).to_json())


@pytest.mark.parametrize("layout", ["padded", "paged", "ragged"])
def test_twin_merge_observed_config_equals_the_reference(stream_arrival, layout):
    ref_w, _, _ = stream_arrival
    port_w = [{a: [Change.from_json(c.to_json()) for c in log] for a, log in w.items()}
              for w in ref_w]
    caps = dict(slot_capacity=256, mark_capacity=64)
    ours, ref = _armed(lambda: JaxDocBatch(layout=layout, **caps).merge(ref_w),
                       lambda: DocBatch(device="cpu", layout=layout, **caps).merge(port_w))
    assert CostModel(ours).observed_config() == JaxCostModel(ref).observed_config()
    assert CostModel(ours).observed_config()["fused_depth"] == 1
    assert _canon(propose(ours).to_json()) == _canon(jax_propose(ref).to_json())


def test_single_round_drains_read_fused_depth_8_on_the_port_only(stream_arrival):
    """Every drain commits one round.  The port once read depth 8 here
    where the reference reads 1 (its commits had no single-round form);
    with the fused forms ported, both packages commit the round in the
    undonated single-round form on the CPU (``apply_batch_compact``
    alone), and the whole observed configuration, fused depth 1
    included, is equal."""
    _, ref_arr, port_arr = stream_arrival
    rounds = []

    def run(cls, arrival, **extra):
        s = cls(num_docs=len(arrival), actors=ACTORS, **WIDE_CAPS, **extra)
        for d, batches in enumerate(arrival):
            s.ingest(d, [ch for b in batches for ch in b])
        rounds.append(s.drain())

    ours, ref = _armed(lambda: run(JaxStreamingMerge, ref_arr),
                       lambda: run(StreamingMerge, port_arr, device="cpu"))
    assert rounds == [1, 1]
    assert set(ref["sites"]) == set(ours["sites"]) == {"apply_batch_compact"}
    got, want = CostModel(ours).observed_config(), JaxCostModel(ref).observed_config()
    assert got["fused_depth"] == want["fused_depth"] == 1
    assert got == want


def test_reference_snapshot_without_a_launch_plan_reads_as_the_reference(stream_arrival):
    """A reference snapshot of single-round drains reads depth 1 under the
    port's model, as under the reference's, and proposes the same."""
    _, ref_arr, port_arr = stream_arrival
    _, ref = _armed(lambda: _feed_rounds(JaxStreamingMerge(
        num_docs=len(ref_arr), actors=ACTORS, **WIDE_CAPS), [[[c for b in d for c in b]]
                                                             for d in ref_arr]),
        lambda: None)
    assert set(ref["sites"]) == {"apply_batch_compact"}
    assert CostModel(ref).observed_config() == JaxCostModel(ref).observed_config()
    assert _canon(propose(ref).to_json()) == _canon(jax_propose(ref).to_json())


def test_costed_port_snapshot_prices_padded_ops(stream_arrival):
    """Costs on, on the CPU: the port's buckets carry bytes and launches,
    no flops, so the model stays in padded-op units; ``executable_bytes``
    reads the largest bucket's argument + output bytes; no memory peak, no
    budget."""
    _, _, port_arr = stream_arrival
    GLOBAL_DEVPROF.reset()
    GLOBAL_DEVPROF.enable(capture_costs=True)
    try:
        _feed_rounds(StreamingMerge(num_docs=len(port_arr), actors=ACTORS, device="cpu",
                                    **STREAM_CAPS), port_arr)
        snap = GLOBAL_DEVPROF.snapshot()
    finally:
        GLOBAL_DEVPROF.disable()
        GLOBAL_DEVPROF.reset()
    model = CostModel(snap)
    assert model._flops_per_op == model_mod.DEFAULT_FLOPS_PER_OP
    obs = model.observed_config()
    bare = json.loads(json.dumps(snap))
    for site in bare["sites"].values():
        for b in site["buckets"].values():
            b["cost"] = None
    assert model.padded_flops(obs) == CostModel(bare).padded_flops(obs) > 0
    peak = max(b["memory"]["peak_bytes"] for site in snap["sites"].values()
               for b in site["buckets"].values())
    assert model.executable_bytes(obs) == model.recompiles(obs) * peak
    assert model.memory_budget() is None
    assert propose(snap).modeled["budget_bytes"] is None


# ---------------------------------------------------------------------------
# the reference's TestPlanProposal, held against the port
# ---------------------------------------------------------------------------


class TestPlanProposal:
    def test_golden_schema_on_committed_snapshot(self):
        proposal = propose(SNAPSHOT)
        body = proposal.to_json()
        assert set(body) == {"proposal", "current", "modeled"}
        assert set(body["proposal"]) == {
            "insert_width", "delete_width", "mark_width", "map_width",
            "slot_capacity", "page_size", "fused_depth", "window_seconds",
        }
        for key in ("current_score", "proposed_score", "savings_frac",
                    "padded_flops_current", "padded_flops_proposed",
                    "recompiles_current", "recompiles_proposed",
                    "dispatches_current", "dispatches_proposed",
                    "executable_bytes", "budget_bytes", "utilization",
                    "tolerance"):
            assert key in body["modeled"], key
        assert isinstance(proposal, PlanProposal)

    def test_proposal_is_deterministic(self):
        snap = load_devprof(SNAPSHOT)
        assert propose(snap).to_json() == propose(snap).to_json()

    def test_beats_current_matches_modeled_scores(self):
        proposal = propose(SNAPSHOT)
        cur = proposal.modeled["current_score"]
        new = proposal.modeled["proposed_score"]
        assert proposal.beats_current() == ((cur - new) / cur > DEFAULT_TOLERANCE)
        assert not proposal.beats_current(tolerance=float("inf"))

    def test_load_devprof_contract(self, tmp_path):
        snap = load_devprof(SNAPSHOT)
        assert load_devprof({"devprof": snap}) == snap
        with pytest.raises(ValueError):
            load_devprof({"not": "a snapshot"})
        with pytest.raises(TypeError):
            load_devprof(42)
        bad = tmp_path / "garbage.json"
        bad.write_text("{not json")
        with pytest.raises(json.JSONDecodeError):
            load_devprof(bad)

    def test_cost_model_scores_proposed_no_worse(self):
        model = CostModel(load_devprof(SNAPSHOT))
        proposal = propose(SNAPSHOT)
        cand = {k: getattr(proposal, k)
                for k in ("insert_width", "delete_width", "mark_width",
                          "map_width", "slot_capacity", "page_size",
                          "fused_depth")}
        assert model.score(cand) <= model.score(model.observed_config())

    def test_cli_exit_codes(self, capsys, tmp_path):
        proposal = propose(SNAPSHOT)
        rc = obs_main(["plan", str(SNAPSHOT), "--json"])
        assert rc == (1 if proposal.beats_current() else 0)
        body = json.loads(capsys.readouterr().out)
        assert body["proposal"] == proposal.to_json()["proposal"]
        assert body["beats_current"] == proposal.beats_current()
        assert obs_main(["plan", str(SNAPSHOT), "--json", "--tolerance", "1000000"]) == 0
        bad = tmp_path / "garbage.json"
        bad.write_text("{not json")
        assert obs_main(["plan", str(bad)]) == 2
        assert jax_obs_main(["plan", str(bad)]) == 2


# ---------------------------------------------------------------------------
# surfaces: health and gauges
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("history", [None, HISTORY], ids=["no_history", "history"])
def test_health_snapshot_carries_the_plan_like_the_reference(history):
    ours, ref = propose(SNAPSHOT, history=history), jax_propose(SNAPSHOT, history=history)
    snap = health_snapshot(plan=ours)
    assert snap["plan"] == ours.to_json()
    assert _canon(snap["plan"]) == _canon(jax_health_snapshot(plan=ref)["plan"])
    assert json.loads(json.dumps(snap))["plan"] == ours.to_json()
    assert health_snapshot(plan=ours.to_json())["plan"] == snap["plan"]


@pytest.mark.parametrize("history", [None, HISTORY], ids=["no_history", "history"])
def test_prometheus_plan_gauges_equal_the_reference(history):
    ours = prometheus_text(plan=propose(SNAPSHOT, history=history)).splitlines()
    ref = jax_prometheus_text(plan=jax_propose(SNAPSHOT, history=history)).splitlines()
    ours_plan = [line for line in ours if "peritext_plan_" in line]
    assert ours_plan == [line for line in ref if "peritext_plan_" in line]
    for metric in ("peritext_plan_current_score", "peritext_plan_proposed_score",
                   "peritext_plan_savings_frac", "peritext_plan_proposed_fused_depth"):
        assert any(line.startswith(metric) for line in ours_plan), metric
