"""Traffic kind ``jobs``: convergence jobs back to back.

Each job is a fresh session that receives every document's changes in
``rounds`` steps, one frame a document a step (the variant's delivery
order cut into ``rounds`` frames of equal change counts).  The window
starts at the first job's session construction and ends with the first
job that converges at or after ``seconds``: whole jobs, since a job's
steps differ in their work (later steps hold more state), and a window
cut inside a job would take a share of fast and slow steps that moves
with where the cut falls.  Set-up runs one job on a fresh
session over the first ``warmup_docs`` documents (all where the
configuration names none: a session of several read blocks runs the same
shapes block by block).

End to end: ``ops_per_s``, every op of the steps that converged in the
window over the window.  Checked: each step's session digest, and the
sampled documents after the last job.

A traffic kind is a module ``modes/<kind>.py`` like this one:
``cut_frames(order, traffic, rng)`` cuts a variant's delivery order into
frames, and ``Driver(config, traffic, wl, device, seed)`` has ``set_up``,
``window`` (its session left in ``sess``), ``stand_in`` (the delivery
without a session, for the control), ``needs`` (what the reference
replays), ``from_reference`` (the control's answers in the program's
place), ``check``, ``tally`` (attempted, failed), ``end_to_end`` and
``slice_steps`` (what each traced step handed in).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np

from ..harness import verify
from ..harness.drive import Step, Spans, make_session, run_step


def cut_frames(order: Sequence, traffic: Dict, rng) -> List[list]:
    size = -(-len(order) // traffic["rounds"])
    return [list(order[i:i + size]) for i in range(0, len(order), size)]


class Driver:
    def __init__(self, config: Dict, traffic: Dict, wl, device, seed: int) -> None:
        self.config, self.wl, self.device = config, wl, device
        self.rounds = traffic["rounds"]
        self.sess = None
        self.items = [[(d, wl.frames[s][r]) for d, s in enumerate(wl.seq_of.tolist())
                       if r < len(wl.frames[s])] for r in range(self.rounds)]
        self.round_ops = [int(sum(wl.frame_ops[s][r] for s in wl.seq_of
                                  if r < len(wl.frame_ops[s]))) for r in range(self.rounds)]

    def set_up(self, spans: Spans) -> None:
        n = self.config.get("warmup_docs") or self.wl.num_docs
        sess = make_session(self.config, self.device, n)
        for r in range(self.rounds):
            run_step(sess, [(d, f) for d, f in self.items[r] if d < n], spans, Step())
        del sess

    def window(self, seconds: float, spans: Spans, hooks: Step, clock: Callable) -> Dict:
        t0 = clock()
        jobs: List[List[int]] = []
        ops = i = 0
        while True:
            self.sess = None  # the last job's session is dropped before the next is built
            with spans("bench.session"):
                self.sess = make_session(self.config, self.device)
            digests: List[int] = []
            jobs.append(digests)
            for r in range(self.rounds):
                hooks.before(i)
                digests.append(run_step(self.sess, self.items[r], spans, hooks))
                hooks.after(i)
                ops += self.round_ops[r]
                i += 1
            if clock() - t0 >= seconds:
                return dict(window_s=clock() - t0, ops=ops, jobs=jobs, steps=i)

    def stand_in(self, ticks: int) -> Dict:
        """What a window delivers, without a session (the control): one job."""
        return dict(steps=self.rounds)

    def needs(self, out: Dict, docs: Sequence[int]) -> Dict[int, tuple]:
        wl = self.wl
        sampled = {int(wl.seq_of[d]) for d in docs}
        return {int(s): (range(1, self.rounds + 1), [self.rounds] if s in sampled else [])
                for s in np.unique(wl.seq_of)}

    def from_reference(self, out: Dict, refs: Dict[int, Dict], docs: Sequence[int]) -> Dict:
        """``out`` with the program's answers taken from ``refs`` (the
        control's replicas in the program's place)."""
        wl = self.wl
        jobs = [[verify.sum_terms([refs[s]["digests"][r + 1] for s in wl.seq_of.tolist()])
                 for r in range(self.rounds)]]
        at = {d: self.rounds for d in docs}
        return dict(out, jobs=jobs, program=verify.reference_outputs(wl, refs, docs, at))

    def check(self, out: Dict, refs: Dict[int, Dict], docs: Sequence[int]) -> Dict[str, Dict]:
        wl = self.wl
        expect = [verify.sum_terms([refs[s]["digests"][r + 1] for s in wl.seq_of.tolist()])
                  for r in range(self.rounds)]
        wrong = sum(1 for job in out["jobs"] for r, got in enumerate(job) if got != expect[r])
        at = {d: self.rounds for d in docs}
        return {"step_digests_wrong": {"value": wrong, "limit": 0},
                **verify.check_samples(wl, out["program"], refs, docs, at)}

    def tally(self, out: Dict, checks: Dict) -> tuple:
        return out["steps"], checks["step_digests_wrong"]["value"]

    def end_to_end(self, out: Dict, log: Callable) -> Dict[str, float]:
        return {"ops_per_s": out["ops"] / out["window_s"]}

    def slice_steps(self, out: Dict, first: int, count: int) -> List[np.ndarray]:
        n = self.wl.num_docs
        return [np.stack([np.arange(n), np.full(n, i % self.rounds)], axis=1)
                for i in range(first, first + count)]
