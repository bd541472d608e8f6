"""peritext-tpu on PyTorch and CUDA: the batched rich-text CRDT merge.

A port of the repository's JAX package (JAX on a TPU, the reference it is
tested against) to PyTorch on an NVIDIA H100, module for module.  It
imports neither JAX nor that package.

* :mod:`peritext_tpu_torch.core` — the scalar document oracle (the
  specification layer): changes, clocks, mark spans, cursors.
* :mod:`peritext_tpu_torch.ops` — packed document state, host encode and
  decode, and the batched phases: the RGA insert kernels (``csrc/insert.cu``
  on the padded layout, ``csrc/ragged_insert.cu`` over the page pool),
  deletes, marks, map registers and span resolution.
* :mod:`peritext_tpu_torch.store` — the page pool, page tables and the
  ragged plan of the paged and ragged layouts, and the streaming session
  over them (``PagedStreamingMerge``, ``RaggedStreamingMerge``).
* :mod:`peritext_tpu_torch.api` — ``DocBatch``, the batched merge, in the
  padded, paged and ragged layouts.
* :mod:`peritext_tpu_torch.parallel` — causal scheduling, the convergence
  digests and ``StreamingMerge``, the streaming session (its constructor
  builds every layout).
* :mod:`peritext_tpu_torch.testing` — seeded workload generators and
  streaming arrival schedules.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from .core import Change, CausalityError, Doc, Operation, PeritextError, span
from .parallel.streaming import StreamingMerge
from .schema import ALL_MARKS, MARK_SPEC, MarkSchema, is_mark_type
from .store import PagedStreamingMerge, PoolExhausted, RaggedStreamingMerge

__all__ = [
    "ALL_MARKS",
    "Change",
    "CausalityError",
    "Doc",
    "MARK_SPEC",
    "MarkSchema",
    "Operation",
    "PagedStreamingMerge",
    "PeritextError",
    "PoolExhausted",
    "RaggedStreamingMerge",
    "StreamingMerge",
    "is_mark_type",
    "span",
]
