"""graftlint torch fixture: the fused-pipeline mistake PTL003 exists for.

The twin of tests/graftlint_corpus/bad/parallel/fused_loop_sync.py: the
fused round pipeline chains K rounds inside ONE captured CUDA graph so the
card never waits on the host between rounds.  The tempting "just checking"
move is a ``torch.cuda.synchronize()`` between chained rounds: inside a
capture it raises, and on the CPU, where nothing is captured, it passes
unseen.  This file is the TRUE POSITIVE proving PTL003 fires on that;
never "fix" it.
"""

import torch
from peritext_tpu_torch.utils.graphs import captured


def _chained_round(state, stream):
    state = state + stream
    # PTL003: host sync inside the fused round loop, reachable from the
    # capture root below through the file-local call graph
    torch.cuda.synchronize()
    return state


@captured
def fused_round_pipeline(state, streams):
    for k in range(4):
        state = _chained_round(state, streams[k])
    return state
