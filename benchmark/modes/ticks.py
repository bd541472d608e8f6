"""Traffic kind ``ticks``: a live server's steady state.

Each variant's delivery order is cut into a first frame of
``landed_share`` of its changes, then frames of ``changes_per_frame``
changes each (drawn from the seed).  Set-up lands every document's first
frame in one step on one session, then ``warmup_ticks`` ticks.  Each tick
hands ``tick_share`` of the documents their next frame, drawn without
replacement, weighted by the ops each has left.  The window ends with the
first tick at or after ``seconds``, or with the last tick the traffic can
fill.

End to end: ``converge_p95_ms``, the 95th percentile over every frame handed
in during the window of the time from its hand-in to the return of the
``wait()`` of the digest that covers it (every frame of a tick waits the
tick).  Checked: the last tick's session digest over every document at the
prefix it reached, and the sampled documents there.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..harness import verify
from ..harness.drive import Step, Spans, make_session, run_step
from ..harness.workload import derive_seed


def cut_frames(order: Sequence, traffic: Dict, rng) -> List[list]:
    n = len(order)
    landed = max(1, round(n * traffic["landed_share"]))
    frames = [list(order[:landed])]
    lo, hi = traffic["changes_per_frame"]
    i = landed
    while i < n:
        k = rng.randint(lo, hi)
        frames.append(list(order[i:i + k]))
        i += k
    return frames


def graph_totals(sess) -> Dict[str, int]:
    """The session's ``GraphCache.stats()`` summed over its shards and forms."""
    tot = {"eager": 0, "captures": 0, "replays": 0}
    for g in sess._shard_graphs:
        for row in g.stats().values():
            for k in tot:
                tot[k] += row.get(k, 0)
    return tot


class Driver:
    def __init__(self, config: Dict, traffic: Dict, wl, device, seed: int) -> None:
        self.config, self.traffic, self.wl, self.device = config, traffic, wl, device
        self.rng = np.random.default_rng(derive_seed(seed, "ticks") % (1 << 63))
        self.delivered = np.zeros(wl.num_docs, np.int64)  # frames handed in per doc
        self.left = np.asarray([int(wl.frame_ops[s].sum()) for s in wl.seq_of], np.float64)
        self.per_tick = max(1, round(traffic["tick_share"] * wl.num_docs))
        self.sess = None
        #: per tick: the (doc, frame index) pairs it handed in
        self.log: List[np.ndarray] = []

    def _hand(self, docs: np.ndarray) -> List:
        wl = self.wl
        items = []
        for d in docs.tolist():
            s, k = wl.seq_of[d], self.delivered[d]
            items.append((d, wl.frames[s][k]))
            self.left[d] -= wl.frame_ops[s][k]
        self.log.append(np.stack([docs, self.delivered[docs]], axis=1))
        self.delivered[docs] += 1
        return items

    def _draw(self) -> Optional[np.ndarray]:
        """The next tick's documents, or None once fewer than a tick's worth
        have frames left."""
        live = np.nonzero(self.left > 0)[0]
        if len(live) < self.per_tick:
            return None
        w = self.left[live]
        return np.sort(self.rng.choice(live, self.per_tick, replace=False, p=w / w.sum()))

    def set_up(self, spans: Spans) -> None:
        self.sess = make_session(self.config, self.device)
        run_step(self.sess, self._hand(np.arange(self.wl.num_docs)), spans, Step())
        for _ in range(self.traffic["warmup_ticks"]):
            run_step(self.sess, self._hand(self._draw()), spans, Step())

    def window(self, seconds: float, spans: Spans, hooks: Step, clock: Callable) -> Dict:
        first = len(self.log)
        graphs0 = graph_totals(self.sess)
        t0 = clock()
        lat, frames, ops = [], [], 0
        i = 0
        while True:
            docs = self._draw()
            if docs is None:
                if not lat:
                    raise RuntimeError("the traffic ran out before the window's first tick")
                break  # the traffic ran out: the window ends with its last tick
            hooks.before(i)
            t_in = clock()
            items = self._hand(docs)
            digest = run_step(self.sess, items, spans, hooks)
            lat.append(clock() - t_in)
            hooks.after(i)
            frames.append(len(items))
            ops += int(sum(self.wl.frame_ops[self.wl.seq_of[d]][k] for d, k in self.log[-1]))
            i += 1
            if clock() - t0 >= seconds:
                break
        window_s = clock() - t0
        g1 = graph_totals(self.sess)
        return dict(window_s=window_s, latencies=np.asarray(lat),
                    frames_per_tick=np.asarray(frames), frames=int(sum(frames)), ops=ops,
                    steps=i, first_tick=first, final_digest=digest,
                    graphs={k: g1[k] - graphs0[k] for k in g1})

    def stand_in(self, ticks: int) -> Dict:
        """What a window of ``ticks`` ticks delivers, without a session (the
        control)."""
        self._hand(np.arange(self.wl.num_docs))
        for _ in range(self.traffic["warmup_ticks"] + ticks):
            self._hand(self._draw())
        return dict(steps=ticks)

    def needs(self, out: Dict, docs: Sequence[int]) -> Dict[int, tuple]:
        wl = self.wl
        stops: Dict[int, set] = {}
        for s, k in zip(wl.seq_of.tolist(), self.delivered.tolist()):
            stops.setdefault(s, set()).add(k)
        spans: Dict[int, set] = {}
        for d in docs:
            spans.setdefault(int(wl.seq_of[d]), set()).add(int(self.delivered[d]))
        return {s: (st, spans.get(s, set())) for s, st in stops.items()}

    def _final(self, refs: Dict[int, Dict]) -> int:
        return verify.sum_terms([refs[s]["digests"][k] for s, k in
                                 zip(self.wl.seq_of.tolist(), self.delivered.tolist())])

    def from_reference(self, out: Dict, refs: Dict[int, Dict], docs: Sequence[int]) -> Dict:
        at = {d: int(self.delivered[d]) for d in docs}
        return dict(out, final_digest=self._final(refs),
                    program=verify.reference_outputs(self.wl, refs, docs, at))

    def check(self, out: Dict, refs: Dict[int, Dict], docs: Sequence[int]) -> Dict[str, Dict]:
        at = {d: int(self.delivered[d]) for d in docs}
        return {"final_digest_wrong": {"value": int(out["final_digest"] != self._final(refs)),
                                       "limit": 0},
                **verify.check_samples(self.wl, out["program"], refs, docs, at)}

    def tally(self, out: Dict, checks: Dict) -> tuple:
        return out["frames"], out["frames"] if checks["final_digest_wrong"]["value"] else 0

    def end_to_end(self, out: Dict, log: Callable) -> Dict[str, float]:
        per_frame = np.repeat(out["latencies"], out["frames_per_tick"])
        lat = out["latencies"] * 1e3
        tenths = [float(x.mean()) for x in np.array_split(lat, 10) if len(x)]
        log(f"frames handed in during the window: {len(per_frame)} ({out['steps']} ticks); "
            f"tick ms p50 {np.percentile(lat, 50):.3f} p95 {np.percentile(lat, 95):.3f} "
            f"max {lat.max():.3f}; mean by tenth of the window "
            f"{' '.join(f'{t:.1f}' for t in tenths)}", file=sys.stderr)
        return {"converge_p95_ms": float(np.percentile(per_frame, 95)) * 1e3}

    def slice_steps(self, out: Dict, first: int, count: int) -> List[np.ndarray]:
        at = out["first_tick"] + first
        return self.log[at:at + count]
