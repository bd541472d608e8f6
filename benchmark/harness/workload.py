"""A cell's inputs, made from ``--seed`` alone: the documents' templates,
their arrival variants and the wire frames each document receives.

A configuration's documents fall into length classes.  Each class has a
pool of distinct fuzz sessions (templates), each delivered in a few seeded
per-sender FIFO orders (variants).  Every document draws one template of
its class and one variant; documents of one (template, variant) receive the
same frames, encoded once and shared by reference.  The traffic kind
(``modes/<kind>.py`` ``cut_frames``) says how a variant's changes are cut
into frames.

Templates are made in worker processes (a 4,096-op session takes seconds
of one core), each from a seed derived from the run's seed and its place.
"""

from __future__ import annotations

import hashlib
import os
import random
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from ..gen.arrival import fifo_order
from ..gen.codec import encode_frame
from ..gen.fuzz import session
from ..reference.types import Change
from . import pool, spec


def derive_seed(*parts) -> int:
    """A 63-bit seed from the run's seed and a place (any ints and strings)."""
    h = hashlib.sha256(repr(parts).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def make_template(args) -> Tuple[List[List[List[Change]]], List[List[bytes]], Dict[str, int]]:
    """One template: its fuzz session, its variants' frames (as changes and
    as v2 wire bytes), and its totals (inserts, deletes, mark ops, comment
    ids) for the capacity check.  A job for a worker process."""
    seed, ops, variants, traffic = args
    cut_frames = spec.mode(traffic["mode"]).cut_frames
    w = session(seed, ops)
    per_changes, per_bytes = [], []
    for v in range(variants):
        rng = random.Random(derive_seed(seed, "variant", v))
        frames = cut_frames(fifo_order(w, rng), traffic, rng)
        per_changes.append(frames)
        per_bytes.append([encode_frame(f) for f in frames])
    all_ops = [op for log in w.values() for ch in log for op in ch.ops]
    totals = {
        "ops": len(all_ops),
        "inserts": sum(1 for op in all_ops if op.action == "set" and op.insert),
        "deletes": sum(1 for op in all_ops if op.action == "del"),
        "marks": sum(1 for op in all_ops if op.action in ("addMark", "removeMark")),
        "comments": len({op.attrs["id"] for op in all_ops
                         if op.mark_type == "comment" and op.attrs}),
    }
    return per_changes, per_bytes, totals


@dataclass
class Workload:
    """What a cell's traffic delivers.  ``seq_of[d]`` is document ``d``'s
    (template, variant) sequence; ``frames[s]`` that sequence's wire frames,
    ``changes[s]`` the changes in each frame, ``frame_ops[s]`` each frame's
    op count."""

    num_docs: int
    seq_of: np.ndarray
    doc_class: np.ndarray
    frames: List[List[bytes]]
    changes: List[List[List[Change]]]
    frame_ops: List[np.ndarray]
    totals: List[Dict[str, int]] = field(default_factory=list)

    def frames_of(self, d: int) -> List[bytes]:
        return self.frames[self.seq_of[d]]


def build(config: Dict, traffic: Dict, seed: int, workers: int = 0) -> Workload:
    """The cell's workload from ``seed``.  ``workers`` processes make the
    templates (0: one per core, at most 8)."""
    variants = config["variants"]
    jobs = []
    for c, cls in enumerate(config["classes"]):
        for j in range(cls["templates"]):
            jobs.append((derive_seed(seed, "template", c, j), cls["ops"], variants, traffic))
    # the longest first, so the pool's last job is a short one
    order = sorted(range(len(jobs)), key=lambda i: -jobs[i][1])
    made = dict(zip(order, pool.run(make_template, [jobs[i] for i in order],
                                    workers or min(8, os.cpu_count() or 1))))

    frames, changes, frame_ops, totals = [], [], [], []
    first_seq, t = [], 0
    for c, cls in enumerate(config["classes"]):
        first_seq.append(len(frames))
        for _ in range(cls["templates"]):
            per_changes, per_bytes, tot = made[t]
            t += 1
            totals.append(tot)
            for v in range(variants):
                frames.append(per_bytes[v])
                changes.append(per_changes[v])
                frame_ops.append(np.asarray([sum(len(ch.ops) for ch in f)
                                             for f in per_changes[v]], np.int64))

    rng = np.random.default_rng(derive_seed(seed, "placement") % (1 << 63))
    doc_class = np.concatenate([np.full(cls["docs"], c, np.int64)
                                for c, cls in enumerate(config["classes"])])
    rng.shuffle(doc_class)
    seq_of = np.empty(len(doc_class), np.int64)
    for c, cls in enumerate(config["classes"]):
        at = np.nonzero(doc_class == c)[0]
        seq_of[at] = first_seq[c] + rng.integers(0, cls["templates"] * variants, len(at))
    return Workload(len(doc_class), seq_of, doc_class, frames, changes, frame_ops, totals)
