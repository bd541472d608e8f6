"""The engine replay: a streaming session's captured rounds applied again
with no host parse, schedule or upload, the reference bench's engine row
(``--mode engine``) in the port.

A padded session with ``_capture_rounds`` set to a list records each
committed round's device-ready inputs (:attr:`StreamingMerge._capture_rounds
<peritext_tpu_torch.parallel.streaming.StreamingMerge._capture_rounds>`).
:func:`replay_rounds` applies them to an empty state, one
``apply_batch_compact`` (one insert-kernel launch) per round, and returns the
per-doc full-state hash vector of the result without waiting for the card;
:func:`replay_digest` is its sync point.  With no fallback and no overflowed
doc in the session, the replay digest equals the session's ``digest()``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Union

import numpy as np
import torch

from ..ops.kernel import apply_batch_compact
from ..ops.packed import empty_docs
from ..parallel.streaming import _resolve_block_digest


def replay_rounds(captured: Sequence, padded_docs: int, caps: Dict[str, int],
                  device: Union[str, torch.device], tables: Sequence) -> torch.Tensor:
    """Replay ``captured`` (the session's ``(round_inputs, widths,
    loop_slots)`` list) on a fresh empty state of ``padded_docs`` rows at
    the session's capacities (``caps``, the session's ``config``), then
    resolve and hash every row over ``tables`` (the session's
    ``_digest_tables(0, padded_docs)``).  Returns the (padded_docs,) per-doc
    hash vector, on ``device``, unsynchronized."""
    state = empty_docs(padded_docs, caps["slot_capacity"], caps["mark_capacity"],
                       caps["tomb_capacity"], map_capacity=caps["map_capacity"], device=device)
    for round_inputs, widths, loop_slots in captured:
        state = apply_batch_compact(state, *round_inputs, widths=widths,
                                    insert_loop_slots=loop_slots)
    row_mask = torch.ones(padded_docs, dtype=torch.bool, device=device)
    _, per_doc = _resolve_block_digest(state, caps["comment_capacity"], row_mask, *tables)
    return per_doc


def replay_digest(per_doc: torch.Tensor) -> int:
    """The convergence digest of a replay: the per-doc hashes' uint32 sum,
    on the host (the sync point)."""
    return int(per_doc.cpu().numpy().sum(dtype=np.uint32))
