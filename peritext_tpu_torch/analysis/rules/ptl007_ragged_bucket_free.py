"""PTL007 — the ragged modules must be bucket-free.

The ragged layout's entire claim (ops/ragged.py, DESIGN.md "Ragged paged
apply") is ONE launch plan for the whole pool: per-doc true op counts and
true page counts ride in as data, never as shapes.  The moment a
power-of-two rounder or width bucket sneaks into a ragged module, the
layout silently regrows the bucket ladder it exists to kill — and nothing
crashes, the kernel just starts paying for padding again.

So the rule is blunt: inside a ragged module (``ragged.py`` /
``ragged_insert.py``, the ragged insert kernel's wrapper), CALLING any
bucket/pow-2 helper is a finding, and so is IMPORTING one (an import is a
call waiting to happen, and the cheapest place to catch the regression is
the import line a reader of the change sees first).
"""

from __future__ import annotations

import ast
from pathlib import PurePosixPath
from typing import Iterator

from .. import astutil
from ..engine import FileContext, Finding, Rule

#: the modules that carry the one-shape contract
_RAGGED_BASENAMES = frozenset({"ragged.py", "ragged_insert.py"})

#: bucket spellings beyond the config's canonical set: the legacy private
#: rounder (store/paged._pow2 delegates to utils.shapes.next_pow2 but old
#: call sites spell it bare) and the cursor-table bucket
_EXTRA_BUCKET_FNS = frozenset({"_pow2", "pow2", "cursor_width_bucket"})


class RaggedBucketFreeRule(Rule):
    rule_id = "PTL007"
    scope = "all"
    summary = "bucket/pow-2 helper used or imported inside a ragged module"
    rationale = (
        "ragged = one compiled shape with true counts as data; any width "
        "bucket in a ragged module regrows the ladder the layout kills"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if PurePosixPath(ctx.display_path).name not in _RAGGED_BASENAMES:
            return
        banned = _EXTRA_BUCKET_FNS | ctx.config.bucket_fns
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                name = astutil.call_name(node)
                if name and name.rpartition(".")[2] in banned:
                    yield ctx.finding(
                        self.rule_id,
                        node,
                        f"bucket helper '{name}' called in a ragged module — "
                        "ragged dispatch takes true counts as data, never "
                        "as rounded shapes",
                    )
            elif isinstance(node, ast.ImportFrom):
                for alias in node.names:
                    if alias.name in banned:
                        yield ctx.finding(
                            self.rule_id,
                            node,
                            f"bucket helper '{alias.name}' imported into a "
                            "ragged module — the one-shape contract bans "
                            "width buckets here outright",
                        )
