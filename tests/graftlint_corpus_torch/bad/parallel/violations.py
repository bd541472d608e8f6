"""graftlint torch corpus: TRUE POSITIVES, one block per rule.

The twin of tests/graftlint_corpus/bad/parallel/violations.py, line for
line: a graph-cache body or a capture-root marker stands where the original
has ``@jax.jit``, and torch calls where it has jnp.  Never "fix" this file.
"""

import random
import time

import numpy as np
import torch
from peritext_tpu_torch.utils.graphs import GraphCache, captured
GRAPHS = GraphCache("cuda")


class Registry:
    def __init__(self):
        self._subscribers = {}
        self._lost = {}

    # PTL001: dict view of long-lived instance state
    def fanout(self, update):
        for key, callback in list(self._subscribers.items()):
            callback(update)

    # PTL001: set iteration
    def drop_all(self, doc_ids):
        for doc in set(doc_ids):
            self._lost.pop(doc, None)

    # PTL001: set-typed local name
    def sweep(self):
        pending = set(self._lost)
        return [self._lost[d] for d in pending]

    # PTL001: bare iteration over dict-typed instance state
    def keys_walk(self):
        return [key for key in self._subscribers]


class PendingSet:
    def __init__(self):
        self._pending = set()

    # PTL001: bare iteration over set-typed instance state
    def drain(self):
        for doc in self._pending:
            yield doc


# PTL002: Python control flow on a captured value
@captured
def traced_branch(x, flag):
    if flag:
        return x + 1
    while x:
        x = x - 1
    return torch.where(x > 0, x, -x)


# PTL002 (a graph-cache body, run by dispatch below) + PTL003 (.item())
# the body of the graph-cache call in dispatch
def traced_loop(x, width):
    total = x.sum()
    sign = 1 if total else -1  # PTL002: ternary on a captured value
    for _ in range(total):
        x = x * sign * 2
    return x.item()


# PTL003: host sync reachable through a file-local helper
def _helper_sync(x):
    return np.asarray(x) + torch.nonzero(x)


@captured
def calls_helper(x):
    return _helper_sync(x)


# PTL004: shape-derived key element at a graph-cache call
def dispatch(docs):
    pads = torch.zeros(len(docs))  # PTL004: unbucketed len() shape
    return GRAPHS.run(("loop", len(docs)), "loop", traced_loop, (pads, pads))


# PTL003: devprof-style cost/memory probe sneaking INSIDE a merge-scope
# capture root — device-cost introspection belongs in obs/devprof.py,
# OUTSIDE every capture; in captured code it is a host sync
def _cost_probe(state):
    return torch.cuda.synchronize()


@captured
def apply_with_probe(state):
    _cost_probe(state)
    return state + 1


# PTL005: broad except without a boundary annotation
def swallow(op):
    try:
        return op()
    except Exception:
        return None


# PTL006: wall clock + unseeded/global RNG in a merge region
def jittery_merge(items):
    deadline = time.time() + 1.0
    random.shuffle(items)
    rng = random.Random()
    return items, rng.random(), deadline
