"""Synthetic op-stream generation for benchmarking.

The fuzz harness (testing/fuzz.py) produces semantically-checked workloads but
pays full scalar-oracle cost per generated op — fine for correctness, too slow
to build 10K-doc x 4K-op benchmark batches.  This module emits *valid encoded
split streams directly* (inserts reference existing elements, deletes target
existing elements, mark anchors are real), which is exactly what the device
kernel consumes after host-side causal scheduling; generation is cheap numpy.

Packed op ids are (k+1 << ACTOR_BITS | random actor) for stream position k —
unique per doc, with random actor bits so the RGA convergence skip path gets
exercised.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..ops.encode import MARK_COLS
from ..ops.packed import ACTOR_BITS, BK_AFTER, BK_BEFORE, MA_ADD, MA_REMOVE
from ..schema import MARK_INDEX

SynthStreams = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, Dict[str, np.ndarray], np.ndarray]


def synth_streams(
    num_docs: int,
    inserts_per_doc: int,
    deletes_per_doc: int = 0,
    marks_per_doc: int = 0,
    num_actors: int = 4,
    seed: int = 0,
    ctr_offset: int = 0,
) -> SynthStreams:
    """Split-stream tuple (ins_ref, ins_op, ins_char, del_target, marks,
    mark_count) shaped for ops/kernel.apply_batch.

    ``ctr_offset`` shifts all op-id counters; pass the number of ops already
    applied when synthesizing a follow-up round for carried state, so ids
    stay unique per document (the kernel's invariant).
    """
    rng = np.random.default_rng(seed)
    d, ki, kd, km = num_docs, inserts_per_doc, deletes_per_doc, marks_per_doc

    actors = rng.integers(1, num_actors + 1, size=(d, ki), dtype=np.int32)
    ctrs = np.broadcast_to(
        np.arange(ctr_offset + 1, ctr_offset + ki + 1, dtype=np.int32), (d, ki)
    )
    ins_op = (ctrs << ACTOR_BITS) | actors

    # ref for insert k: HEAD (5%) or a uniformly random earlier insert
    pick = rng.random((d, ki))
    ref_idx = (pick * np.arange(ki)[None, :]).astype(np.int64)  # in [0, k)
    ins_ref = np.where(
        (np.arange(ki)[None, :] == 0) | (pick < 0.05),
        np.int32(0),
        np.take_along_axis(ins_op, ref_idx, axis=1),
    ).astype(np.int32)
    ins_char = rng.integers(ord("a"), ord("z") + 1, size=(d, ki), dtype=np.int32)

    # deletes target random inserted elements
    del_idx = rng.integers(0, ki, size=(d, kd), dtype=np.int64)
    del_target = (
        np.take_along_axis(ins_op, del_idx, axis=1) if kd else np.zeros((d, 0), np.int32)
    ).astype(np.int32)

    marks = {col: np.zeros((d, km), np.int32) for col in MARK_COLS}
    if km:
        a_idx = rng.integers(0, ki, size=(d, km), dtype=np.int64)
        b_idx = rng.integers(0, ki, size=(d, km), dtype=np.int64)
        marks["m_action"][:] = np.where(rng.random((d, km)) < 0.7, MA_ADD, MA_REMOVE)
        marks["m_type"][:] = rng.integers(0, len(MARK_INDEX), size=(d, km))
        marks["m_start_kind"][:] = np.where(rng.random((d, km)) < 0.5, BK_BEFORE, BK_AFTER)
        marks["m_start_elem"][:] = np.take_along_axis(ins_op, a_idx, axis=1)
        marks["m_end_kind"][:] = np.where(rng.random((d, km)) < 0.5, BK_BEFORE, BK_AFTER)
        marks["m_end_elem"][:] = np.take_along_axis(ins_op, b_idx, axis=1)
        # mark op ids continue the counter space above the inserts
        m_ctrs = np.broadcast_to(
            np.arange(ctr_offset + ki + 1, ctr_offset + ki + km + 1, dtype=np.int32),
            (d, km),
        )
        m_actors = rng.integers(1, num_actors + 1, size=(d, km), dtype=np.int32)
        marks["m_op"][:] = (m_ctrs << ACTOR_BITS) | m_actors
        marks["m_attr"][:] = rng.integers(1, 16, size=(d, km))
    mark_count = np.full(d, km, np.int32)

    return ins_ref, ins_op, ins_char, del_target, marks, mark_count


def synth_total_ops(streams: SynthStreams) -> int:
    ins_ref, ins_op, _, del_target, marks, _ = streams
    return int(ins_op.size + del_target.size + marks["m_action"].size)
