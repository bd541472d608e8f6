"""The port's staging lane (peritext_tpu_torch/parallel/staging.py) against
the reference package's (peritext_tpu/parallel/staging.py).

Each scenario drives one lane class through the same jobs and returns what
it observed; the port's result must equal the reference's:

* FIFO order of the jobs and their handles' values, and ``stats()``;
* depth backpressure: with the worker held on a job, ``depth`` more jobs
  queue and the next ``submit`` blocks until the worker moves on;
* a job's failure re-raised by its handle's ``wait()`` on the waiting
  thread, counted, and the lane still serving the jobs after it;
* the idle reap (the worker retires after ``IDLE_TIMEOUT_SECONDS``) and
  the respawn on the next submit;
* ``close()``: idempotent, refuses new jobs, lets submitted ones resolve.

Then the port's own pieces: the ``span_factory`` hook, a session's lane
rebuilt after a close, and the CPU upload of ``CopyLane`` (one host tensor,
no event, no copy).
"""

import threading
import time

import numpy as np
import pytest
import torch

from peritext_tpu.parallel import staging as ref_staging
from peritext_tpu_torch.parallel import staging as port_staging
from peritext_tpu_torch.parallel.streaming import StreamingMerge

LANES = {"port": port_staging, "ref": ref_staging}


def _both(scenario, **kw):
    """The scenario's observations on the port's lane and the reference's."""
    return {name: scenario(mod, **kw) for name, mod in LANES.items()}


def _fifo(mod):
    lane = mod.FrameStager()
    order = []

    def job(i):
        order.append(i)
        return i * i

    handles = [lane.submit(job, i) for i in range(8)]
    values = [h.wait() for h in handles]
    stats = lane.stats()
    lane.close()
    return values, order, stats, all(h.ready() for h in handles)


def _backpressure(mod, depth):
    lane = mod.FrameStager(depth=depth)
    gate, started = threading.Event(), threading.Event()

    def held():
        started.set()
        gate.wait(10.0)
        return "held"

    first = lane.submit(held)
    assert started.wait(10.0)
    queued = [lane.submit(lambda i=i: i) for i in range(depth)]
    extra = {}

    def submit_one_more():
        extra["handle"] = lane.submit(lambda: "extra")

    t = threading.Thread(target=submit_one_more)
    t.start()
    t.join(0.3)
    blocked = t.is_alive()
    gate.set()
    t.join(10.0)
    values = [first.wait()] + [h.wait() for h in queued] + [extra["handle"].wait()]
    lane.close()
    return blocked, values, lane.stats()


def _error(mod):
    lane = mod.FrameStager()

    def boom():
        raise ValueError("staging failed")

    ok, bad, after = lane.submit(lambda: 1), lane.submit(boom), lane.submit(lambda: 2)
    seen = [ok.wait()]
    try:
        bad.wait()
    except ValueError as exc:
        seen.append(("raised", type(exc).__name__, str(exc)))
    seen.append(after.wait())
    lane.close()
    return seen, lane.stats()


def _idle_reap(mod, monkeypatch):
    monkeypatch.setattr(mod, "IDLE_TIMEOUT_SECONDS", 0.05)
    lane = mod.FrameStager()
    first = lane.submit(lambda: 1).wait()
    deadline = time.monotonic() + 5.0
    while lane._thread is not None and time.monotonic() < deadline:
        time.sleep(0.01)
    reaped = lane._thread is None
    second = lane.submit(lambda: 2).wait()
    respawned = lane._thread is not None
    lane.close()
    return first, reaped, second, respawned, lane.stats()


def _close(mod):
    lane = mod.FrameStager()
    gate = threading.Event()
    pending = lane.submit(lambda: gate.wait(10.0) and "resolved")
    lane.close()
    lane.close()
    try:
        lane.submit(lambda: 0)
        refused = None
    except RuntimeError as exc:
        refused = str(exc)
    gate.set()
    return pending.wait(), refused


def test_fifo_order_equals_reference():
    got = _both(_fifo)
    assert got["port"] == got["ref"]
    values, order, stats, ready = got["port"]
    assert values == [i * i for i in range(8)] and order == list(range(8)) and ready
    assert stats == {"staged": 8, "errors": 0, "depth": 2}


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_depth_backpressure_equals_reference(depth):
    got = _both(_backpressure, depth=depth)
    assert got["port"] == got["ref"]
    blocked, values, stats = got["port"]
    assert blocked, "submit past the depth bound must block"
    assert values == ["held"] + list(range(depth)) + ["extra"]
    assert stats["staged"] == depth + 2


def test_error_surfaces_on_wait_equals_reference():
    got = _both(_error)
    assert got["port"] == got["ref"]
    seen, stats = got["port"]
    assert seen == [1, ("raised", "ValueError", "staging failed"), 2]
    assert stats["errors"] == 1 and stats["staged"] == 2


def test_idle_reap_and_respawn_equals_reference(monkeypatch):
    got = {name: _idle_reap(mod, monkeypatch) for name, mod in LANES.items()}
    assert got["port"] == got["ref"]
    assert got["port"][:4] == (1, True, 2, True)


def test_close_equals_reference():
    got = _both(_close)
    assert got["port"] == got["ref"] == ("resolved", "FrameStager is closed")


def test_depth_validation_equals_reference():
    for mod in LANES.values():
        with pytest.raises(ValueError, match="depth"):
            mod.FrameStager(depth=0)


def test_span_factory_wraps_every_job():
    lane = port_staging.FrameStager()
    spans = []

    class Span:
        def __enter__(self):
            spans.append("enter")

        def __exit__(self, *exc):
            spans.append("exit")

    lane.span_factory = Span
    assert [lane.submit(lambda i=i: i).wait() for i in range(3)] == [0, 1, 2]
    lane.close()
    assert spans == ["enter", "exit"] * 3


def test_session_rebuilds_a_closed_lane():
    s = StreamingMerge(num_docs=2, actors=("doc1",), device="cpu")
    lane = s._ensure_stager()
    assert s._ensure_stager() is lane
    lane.close()
    fresh = s._ensure_stager()
    assert fresh is not lane and fresh.submit(lambda: 3).wait() == 3
    fresh.close()


def test_copy_lane_on_the_cpu_is_the_host_buffer():
    lane = port_staging.CopyLane(torch.device("cpu"))
    flat = np.arange(10, dtype=np.int64)
    up = lane.upload(flat)
    assert up.event is None and lane.copies == 0 and not lane._held
    got = up.consume()
    assert got.dtype == torch.int32 and got.tolist() == list(range(10))
