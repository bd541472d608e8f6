"""Shared fixtures of the benchmark's tests: the benchmark definition, and
each cell's configuration cut to a size the CPU runs in seconds."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import spec  # noqa: E402


@pytest.fixture(scope="session")
def bench():
    return spec.load_benchmark()


def tiny_config(bench, cell, docs: int = 24, ops: int = 60):
    """The cell's configuration with its classes cut to ``docs`` documents
    in all (each class keeps a share, at least 3), ``ops`` ops at most, two
    templates a class, and read blocks that still split a several-block
    configuration."""
    cfg = spec.config(bench, cell["config"])
    total = cfg["docs"]
    classes = [dict(c, docs=max(3, c["docs"] * docs // total), ops=min(c["ops"], ops),
                    templates=2) for c in cfg["classes"]]
    n = sum(c["docs"] for c in classes)
    several = cfg["docs"] > cfg["read_chunk"]
    return dict(cfg, docs=n, classes=classes, read_chunk=n // 2 if several else n,
                warmup_docs=n // 2 if cfg.get("warmup_docs") else None)


@pytest.fixture
def cuda_card():
    """Skips the test where this machine has no CUDA card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the benchmark measures the CUDA port")
