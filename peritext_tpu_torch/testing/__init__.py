"""Test and fuzz harness: seeded fuzz change logs, synthetic op streams,
streaming arrival schedules, the patch-replay oracle, the differential
fuzz (:mod:`.fuzz`) and the chaos harness (:mod:`.chaos`).

:mod:`.fuzz` and :mod:`.chaos` load on first use of one of their names, so
``python -m peritext_tpu_torch.testing.fuzz`` runs the module once."""

from .accumulate import accumulate_patches
from .arrival import build_arrival, interleave_rounds
from .generate import generate_docs
from .synth import synth_streams

_LAZY = {
    "generate_markheavy_workload": ".fuzz",
    "generate_workload": ".fuzz",
    "run_differential": ".fuzz",
    "run_differential_frames": ".fuzz",
    "sample_cursors": ".fuzz",
    "ChaosReport": ".chaos",
    "run_campaign": ".chaos",
    "run_chaos": ".chaos",
    "run_divergence_injection": ".chaos",
    "run_fleet_chaos": ".chaos",
    "run_fused_drain_kill": ".chaos",
    "run_host_kill_failover": ".chaos",
    "run_markheavy_chaos": ".chaos",
    "run_reconnect_storm": ".chaos",
    "run_serve_chaos": ".chaos",
}


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module, __name__), name)


__all__ = [
    "ChaosReport",
    "accumulate_patches",
    "build_arrival",
    "generate_docs",
    "generate_markheavy_workload",
    "generate_workload",
    "interleave_rounds",
    "run_campaign",
    "run_chaos",
    "run_differential",
    "run_differential_frames",
    "run_divergence_injection",
    "run_fleet_chaos",
    "run_fused_drain_kill",
    "run_host_kill_failover",
    "run_markheavy_chaos",
    "run_reconnect_storm",
    "run_serve_chaos",
    "sample_cursors",
    "synth_streams",
]
