"""Scalar-baseline workload preparation (the port's copy of the reference
package's module, shared by ``chip_smoke.py`` and the tests).

Parses fuzz workloads into causally-ordered op matrices for the C++
single-core baseline (``native.scalar_apply``, ``pt_scalar_apply``) and
validates its output against the Python oracle.  Host code only: the card
is not involved, and a missing native library raises.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .. import native
from ..api.batch import _oracle_doc
from ..ops.frames import parse_frame
from ..parallel.causal import causal_sort
from ..parallel.codec import encode_frame
from ..utils.interning import Interner, OrderedActorTable


def workload_op_matrices(workloads) -> Tuple[List[np.ndarray], int]:
    """Per-doc (N, 10) parsed op matrices in causal application order, plus
    the total op count across all docs."""
    matrices: List[np.ndarray] = []
    total_ops = 0
    for w in workloads:
        changes = causal_sort([ch for log in w.values() for ch in log])
        actors = OrderedActorTable(
            {ch.actor for ch in changes}
            | {op.opid[1] for ch in changes for op in ch.ops}
        )
        parsed, _ = parse_frame(
            encode_frame(changes), actors, Interner(), 0, Interner()
        )
        matrices.append(parsed.ops)
        total_ops += sum(len(ch.ops) for ch in changes)
    return matrices, total_ops


def check_scalar_apply_matches_oracle(workloads, matrices) -> None:
    """Raise RuntimeError if the native baseline diverges from the oracle's
    visible text on ANY doc (skipped-op masking must never inflate ops/s)."""
    for d, (w, m) in enumerate(zip(workloads, matrices)):
        _, text = native.scalar_apply(m)
        got = "".join(chr(int(c)) for c in text)
        expected = "".join(
            s["text"] for s in _oracle_doc(w).get_text_with_formatting(["text"])
        )
        if got != expected:
            raise RuntimeError(
                f"native scalar baseline diverged from the oracle on doc {d}"
            )
