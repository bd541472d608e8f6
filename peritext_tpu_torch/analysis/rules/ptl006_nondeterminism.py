"""PTL006 — wall-clock / unseeded-RNG reads in deterministic merge regions.

Byte-equality convergence means a merge's output is a pure function of the
change set.  A wall-clock read or a global/unseeded RNG inside ``core/``/
``ops/``/``parallel/`` is entropy leaking into that function — even when it
"only" orders retries, it desynchronizes replicas' observable behavior and
makes fuzz failures unreproducible.  RNG must arrive as an explicitly
seeded ``random.Random(seed)`` / ``np.random.default_rng(seed)`` passed in
by the caller; time belongs to the observability layer.
"""

from __future__ import annotations

import ast
from typing import Iterator

from .. import astutil
from ..engine import FileContext, Finding, Rule

_WALL_CLOCK = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.process_time",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
}
#: module-level (global-state) RNG entry points
_GLOBAL_RNG = {
    f"random.{fn}"
    for fn in (
        "random", "randint", "randrange", "uniform", "choice", "choices",
        "sample", "shuffle", "getrandbits", "gauss", "normalvariate",
        "betavariate", "expovariate", "randbytes",
    )
} | {
    f"numpy.random.{fn}"
    for fn in (
        "rand", "randn", "randint", "random", "random_sample", "ranf",
        "shuffle", "permutation", "choice", "normal", "uniform", "bytes",
    )
}
#: RNG constructors that are deterministic ONLY when given a seed
_SEEDABLE = {"random.Random", "numpy.random.default_rng", "numpy.random.RandomState"}
_ENTROPY = {"random.SystemRandom", "secrets.token_bytes", "secrets.token_hex",
            "uuid.uuid4", "os.urandom"}


class NondeterminismRule(Rule):
    rule_id = "PTL006"
    scope = "merge"
    summary = "wall-clock or unseeded RNG in a deterministic merge region"
    rationale = (
        "merge output must be a pure function of the change set; entropy "
        "makes replicas diverge and fuzz failures unreproducible"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = astutil.call_name(node)
            if name is None:
                continue
            resolved = ctx.resolve(name)
            if resolved in _WALL_CLOCK:
                yield ctx.finding(
                    self.rule_id,
                    node,
                    f"wall-clock read '{resolved}()' in a deterministic merge "
                    "region — timing belongs in the observability layer",
                )
            elif resolved in _GLOBAL_RNG:
                yield ctx.finding(
                    self.rule_id,
                    node,
                    f"global-RNG call '{resolved}()' in a deterministic merge "
                    "region — thread a seeded random.Random through instead",
                )
            elif resolved in _SEEDABLE and not node.args and not node.keywords:
                yield ctx.finding(
                    self.rule_id,
                    node,
                    f"unseeded '{resolved}()' in a deterministic merge region "
                    "— construct it from an explicit seed",
                )
            elif resolved in _ENTROPY:
                yield ctx.finding(
                    self.rule_id,
                    node,
                    f"entropy source '{resolved}()' in a deterministic merge "
                    "region — derive ids/jitter from seeded state",
                )
