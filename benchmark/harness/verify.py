"""Whether the timed path's outputs are correct: what the session produced
in the window, held against the plain reference (``reference/``) on the
same changes.

The reference replays each (template, variant) sequence once, in worker
processes, and gives its digest term after every prefix a document
reached, and its spans where a sampled document stands.  Every number
compared is a count of disagreements, with the limit 0: the session
digests the traffic kind checks (``modes/<kind>.py``), and
``sample_reads_wrong`` / ``sample_doc_digests_wrong``: sampled documents
(every length class, the longest template's documents among them) whose
spans read through ``read()``, or whose ``doc_digest()``, differ.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

from ..reference.digest import M32, actor_index
from ..reference.replay import replay
from . import pool
from .workload import Workload, derive_seed


def _replay_job(args):
    return replay(*args)


def reference(wl: Workload, config: Dict, needs: Dict[int, tuple], buffered: bool = True,
              workers: int = 0) -> Dict[int, Dict]:
    """``needs[s] = (stops, spans_at)`` per sequence ``s``: the reference's
    :func:`replay` of each, in worker processes, the longest first."""
    actors = actor_index(config["actors"])
    cap = config["session"]["slot_capacity"]
    keys = sorted(needs, key=lambda s: -int(wl.frame_ops[s].sum()))
    jobs = [(wl.changes[s], sorted(needs[s][0]), cap, actors, sorted(needs[s][1]), buffered)
            for s in keys]
    out = pool.run(_replay_job, jobs, workers or min(8, os.cpu_count() or 1))
    return dict(zip(keys, out))


def sample_docs(wl: Workload, seed: int, per_class: int) -> List[int]:
    """``per_class`` documents of each length class drawn from the seed,
    plus, per class, one document of its longest template."""
    rng = np.random.default_rng(derive_seed(seed, "sample") % (1 << 63))
    picked = set()
    for c in np.unique(wl.doc_class):
        docs = np.nonzero(wl.doc_class == c)[0]
        picked.update(rng.choice(docs, min(per_class, len(docs)), replace=False).tolist())
        ops = np.asarray([wl.frame_ops[wl.seq_of[d]].sum() for d in docs])
        picked.add(int(docs[int(np.argmax(ops))]))
    return sorted(int(d) for d in picked)


def program_outputs(sess, docs: Sequence[int]) -> Dict:
    """What the session holds for the sampled documents (read after the
    window, before the session is freed)."""
    return {"reads": {d: sess.read(d) for d in docs},
            "doc_digests": {d: sess.doc_digest(d) for d in docs},
            "fallback_docs": sum(1 for s in sess.docs if s.fallback) + sess.overflow_count()}


def sum_terms(terms) -> int:
    """The session digest: the documents' terms summed modulo 2**32."""
    return int(np.asarray(terms, np.uint64).sum() & M32)


def reference_outputs(wl: Workload, refs: Dict[int, Dict], docs: Sequence[int],
                      at: Dict[int, int]) -> Dict:
    """:func:`program_outputs` as the replicas in ``refs`` give them, each
    sampled document ``d`` after ``at[d]`` deliveries (the control)."""
    return {"reads": {d: refs[int(wl.seq_of[d])]["spans"][at[d]] for d in docs},
            "doc_digests": {d: refs[int(wl.seq_of[d])]["digests"][at[d]] for d in docs}}


def check_samples(wl: Workload, prog: Dict, refs: Dict[int, Dict], docs: Sequence[int],
                  at: Dict[int, int]) -> Dict[str, Dict]:
    """The sampled documents' reads and digests against the reference's,
    each document ``d`` after ``at[d]`` deliveries."""
    ref = reference_outputs(wl, refs, docs, at)
    return {"sample_reads_wrong": {"value": sum(1 for d in docs
                                                if prog["reads"][d] != ref["reads"][d]),
                                   "limit": 0},
            "sample_doc_digests_wrong": {"value": sum(1 for d in docs if prog["doc_digests"][d]
                                                      != ref["doc_digests"][d]),
                                         "limit": 0}}


def slice_work(wl: Workload, refs: Dict[int, Dict], steps: Sequence[np.ndarray]) -> Dict:
    """The reference's count of the work in the traced slice.  ``steps``
    holds, per step of the slice, the (doc, delivery index) pairs it handed
    in: K1's ``inserts`` and ``insert_ops``, and the ``digest_bytes`` of the
    rows each step's digest had to hash again (those whose state changed)."""
    from ..gen.bounds import ELEMENT_BYTES, MARK_BYTES, ROW_DIGEST_BYTES

    inserts = ops = nbytes = 0
    for pairs in steps:
        for d, k in pairs.tolist():
            r = refs[int(wl.seq_of[d])]
            inserts += r["inserts"][k]
            ops += r["insert_ops"][k]
            if r["changed"][k]:
                nbytes += r["slots"][k] * ELEMENT_BYTES + r["marks"][k] * MARK_BYTES \
                    + ROW_DIGEST_BYTES
    return {"inserts": inserts, "insert_ops": ops, "digest_bytes": nbytes}
