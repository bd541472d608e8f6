"""graftlint — the port's determinism static analysis (its copy of the
reference package's linter, over ``peritext_tpu_torch/``).

The north-star contract (byte-equality convergence) rests on invariants
that unit tests only probe after the fact:

* merge/convergence code must never let *iteration order of unordered
  containers* leak into digests or delivery order (PTL001);
* fault handling must use the typed errors from ``core/errors.py`` unless a
  boundary is explicitly declared (PTL005);
* deterministic merge regions must not read wall clocks or unseeded RNGs
  (PTL006);
* the ragged modules take true counts as data and never call a width
  bucket (PTL007);
* code that runs inside a CUDA-graph capture (a graph cache's body, a
  function marked as a capture root, what either reaches in its file) must
  not branch on a captured tensor (PTL002), sync with or copy from the host
  (PTL003), or key a capture by a per-call size (PTL004): the reference's
  rules over jit-traced code, with the capture as the trace.

This package machine-checks those invariants over the AST, without loading
the scanned code.  The capture audit (testing/capture_audit.py) checks on a
real capture that every function it runs is one the rules scan.

Run it::

    python -m peritext_tpu_torch.analysis peritext_tpu_torch

Pre-existing, intentional violations are attributed (with a justification
each) in ``peritext_tpu_torch/graftlint_baseline.json``; anything new fails
the scan.  Inline escapes: ``# graftlint: disable=PTL00X`` on the offending
line, or ``# graftlint: boundary(reason)`` to declare a fault boundary
(satisfies PTL005).
"""

from .engine import (  # noqa: F401
    Finding,
    LintConfig,
    all_rule_ids,
    rule_table,
    scan_paths,
)
from .baseline import (  # noqa: F401
    BASELINE_NAME,
    apply_baseline,
    find_default_baseline,
    load_baseline,
    update_baseline,
)
