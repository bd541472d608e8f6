#!/usr/bin/env python
"""BASELINE config 5b's streaming session in each storage layout on one card.

Runs ``demos/torch_scale_demo.py``'s command-line entry point once per
layout (its own output, its own assertions), each in a fresh allocator
state, and after each prints one JSON line: the layout, the docs, the card
(``nvidia-smi --query-gpu=name,power.limit``) and the peak
``torch.cuda.max_memory_allocated`` of the run.

    python scripts/torch_scale_layouts.py [--docs 100000] [--layouts paged ragged]
"""

import argparse
import gc
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--docs", type=int, default=100_000)
    parser.add_argument("--layouts", nargs="+", default=["padded", "paged", "ragged"],
                        choices=("padded", "paged", "ragged"))
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_scale_layouts: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    spec = importlib.util.spec_from_file_location("torch_scale_demo",
                                                  ROOT / "demos" / "torch_scale_demo.py")
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    for layout in args.layouts:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        demo.main(["--docs", str(args.docs), "--layout", layout])
        print(json.dumps({"layout": layout, "docs": args.docs, "card": card,
                          "peak_memory_bytes": torch.cuda.max_memory_allocated()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
