"""graftlint torch corpus: CLEAN NEGATIVES.

The twin of tests/graftlint_corpus/clean/parallel/idiomatic.py, line for
line; the suite asserts this file scans clean (and the suppression forms
are honored).
"""

import random
import time

import torch
from peritext_tpu_torch.utils.graphs import GraphCache, captured
GRAPHS = GraphCache("cuda")

WIDTH_TABLE = (8, 16, 32, 64)


def _width_bucket(n):
    for w in WIDTH_TABLE:
        if n <= w:
            return w
    return n


class Registry:
    def __init__(self):
        self._subscribers = {}
        self._lost = {}

    # PTL001-clean: sorted iteration over instance state
    def fanout(self, update):
        for key, callback in sorted(self._subscribers.items()):
            callback(update)

    # PTL001-clean: sorted set iteration; local dicts iterate freely
    def drop_all(self, doc_ids):
        for doc in sorted(set(doc_ids)):
            self._lost.pop(doc, None)
        local = {d: 1 for d in sorted(doc_ids)}
        return [v for _, v in local.items()]

    # PTL001-clean: order-insensitive consumers
    def stats(self):
        total = sum(v for v in self._lost.values())
        worst = max(self._lost.keys(), default=None)
        return total, worst

    # PTL001-clean: bare attribute iteration is fine for LIST state (order
    # is code-determined, not arrival hashing) and sorted() for dict state
    def walk(self):
        self._log = []
        for entry in self._log:
            yield entry
        for key in sorted(self._subscribers):
            yield key


# PTL002-clean: static reads and device-side branching
@captured(static=("flag",))
def traced_branch(x, flag):
    if flag:  # static argument: a branch fixed per graph is fine
        return x + 1
    if x.shape[0] > 4:  # structural read: static at capture time
        return torch.where(x > 0, x, -x)
    return torch.cumsum(x * 2, 0)


# PTL003-clean: syncs live OUTSIDE the capture
@captured
def pure_program(x):
    return (x * 2).sum()


def read_result(x):
    return float(pure_program(x))  # host sync at the boundary, not inside


# PTL004-clean: shapes routed through the width bucket
def dispatch(docs):
    padded = torch.zeros(_width_bucket(len(docs)))
    return GRAPHS.run(("pure",), "pure", pure_program, (padded,))


# PTL005-clean: typed error, and an annotated boundary
class MergeError(ValueError):
    pass


def guarded(op):
    try:
        return op()
    except MergeError:
        return None


def boundary(op):
    try:
        return op()
    except Exception:  # graftlint: boundary(fixture: any failure degrades to None by contract)
        return None


# PTL006-clean: seeded RNG threaded through; suppression honored
def deterministic_merge(items, seed):
    rng = random.Random(seed)
    rng.shuffle(items)
    t0 = time.perf_counter()  # graftlint: disable=PTL006
    return items, t0
