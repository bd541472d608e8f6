"""The engine replay: a streaming session's captured rounds applied again
with no host parse, schedule or upload, the reference bench's engine row
(``--mode engine``) in the port.

A padded session with ``_capture_rounds`` set to a list records each
committed round's device-ready inputs (:attr:`StreamingMerge._capture_rounds
<peritext_tpu_torch.parallel.streaming.StreamingMerge._capture_rounds>`).
:class:`EngineReplay` applies them all to an empty state through ONE
``apply_batch_compact_rounds`` site call (the reference bench replays them
through ``apply_batch_compact_rounds_jit`` in one dispatch), then resolves
and hashes every row.  Its state lives in resident buffers: each pass
starts by filling them with zeros, so on the card the first pass runs
eagerly, the second captures a CUDA graph (utils/graphs.py), and every
pass after that is one replay.  :func:`replay_rounds` is one pass of a
fresh replay; :func:`replay_digest` is the sync point.  With no fallback
and no overflowed doc in the session, the replay digest equals the
session's ``digest()``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Union

import numpy as np
import torch

from ..ops.kernel import _compact_rounds_chain, note_form, rounds_plan
from ..ops.packed import PackedDocs, empty_docs
from ..parallel.streaming import _resolve_block_digest, _write_resident
from ..utils.graphs import GraphCache


class EngineReplay:
    """Repeated replays of ``captured`` (the session's ``(round_inputs,
    widths, loop_slots)`` list) on ``padded_docs`` rows at the session's
    capacities (``caps``, its ``config``), hashed over ``tables`` (its
    ``_digest_tables(0, padded_docs)``).  ``graphs`` counts the eager
    runs, captures and replays."""

    def __init__(self, captured: Sequence, padded_docs: int, caps: Dict[str, int],
                 device: Union[str, torch.device], tables: Sequence) -> None:
        self.device = torch.device(device)
        self.captured = list(captured)
        self.widths_seq = tuple(tuple(w) for _, w, _ in self.captured)
        self.loop_slots_seq = tuple(ls for _, _, ls in self.captured)
        self.tables = tuple(tables)
        self.comment_capacity = caps["comment_capacity"]
        self.state = empty_docs(padded_docs, caps["slot_capacity"], caps["mark_capacity"],
                                caps["tomb_capacity"], map_capacity=caps["map_capacity"],
                                device=self.device)
        self.row_mask = torch.ones(padded_docs, dtype=torch.bool, device=self.device)
        self.graphs = GraphCache(self.device)

    def _pass(self) -> torch.Tensor:
        resident = tuple(self.state)
        for x in resident:
            x.zero_()
        rounds = tuple(r for r, _, _ in self.captured)
        new = _compact_rounds_chain(PackedDocs(*resident), rounds, self.widths_seq,
                                    self.loop_slots_seq)
        _write_resident(resident, new)
        _, per_doc = _resolve_block_digest(new, self.comment_capacity, self.row_mask,
                                           *self.tables)
        return per_doc

    def __call__(self) -> torch.Tensor:
        """One pass: the (padded_docs,) per-doc hash vector, on the device,
        unsynchronized."""
        binds = tuple(self.state) + (self.row_mask,) + self.tables + tuple(
            t for r, _, _ in self.captured for t in _leaves(r))
        return note_form(
            "apply_batch_compact_rounds", (self.state, [r for r, _, _ in self.captured]),
            lambda: self.graphs.run(("engine", self.widths_seq, self.loop_slots_seq),
                                    "apply_batch_compact_rounds", self._pass, (), binds=binds),
            lambda: rounds_plan(self.state, [w[0] for w in self.widths_seq], self.loop_slots_seq,
                                (("widths_seq", self.widths_seq),)),
            device=self.device)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _leaves(x)


def replay_rounds(captured: Sequence, padded_docs: int, caps: Dict[str, int],
                  device: Union[str, torch.device], tables: Sequence) -> torch.Tensor:
    """One pass of a fresh :class:`EngineReplay`: the (padded_docs,)
    per-doc hash vector, on ``device``, unsynchronized."""
    return EngineReplay(captured, padded_docs, caps, device, tables)()


def replay_digest(per_doc: torch.Tensor) -> int:
    """The convergence digest of a replay: the per-doc hashes' uint32 sum,
    on the host (the sync point)."""
    return int(per_doc.cpu().numpy().sum(dtype=np.uint32))
