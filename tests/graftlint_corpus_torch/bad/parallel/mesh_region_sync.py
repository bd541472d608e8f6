"""graftlint torch fixture: the mesh-region mistake PTL003 exists for.

The twin of tests/graftlint_corpus/bad/parallel/mesh_region_sync.py: the
mesh commit path runs each shard's staged K-round body through the shard's
own graph cache, so a drain batch is ONE replay per shard.  A "quick peek"
``.item()`` inside a helper the body calls is a host sync from INSIDE the
capture: it raises there, and the shard's graph is never made, while on
the CPU, where nothing is captured, it passes unseen.  This file is the
TRUE POSITIVE proving PTL003 follows the body passed to each shard's
``run``; never "fix" it.
"""

import torch
from peritext_tpu_torch.utils.graphs import GraphCache

SHARD_GRAPHS = [GraphCache(torch.device("cuda", 0)) for _ in range(4)]


def _shard_debug_total(rows):
    total = rows.sum()
    # PTL003: host sync inside the shard's capture, reachable from the
    # graph-cache body below through the file-local call graph
    return total.item()


def _mesh_round_body(rows, stream):
    rows = rows + stream
    _shard_debug_total(rows)
    return rows


def mesh_fused_commit(rows, streams):
    # one graph-cache run per shard, each its own capture
    return [
        graphs.run(("mesh_round", s), "mesh_round", _mesh_round_body,
                   (rows[s], streams[s]))
        for s, graphs in enumerate(SHARD_GRAPHS)
    ]
