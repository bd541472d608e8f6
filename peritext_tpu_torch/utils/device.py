"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller names another device.  With
no card present and none named, they raise: the plain torch path on the
CPU is there for tests that ask for it, never as a silent stand-in for the
device.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device to run on: ``device`` if given, else ``cuda``.  Raises
    when a CUDA device is asked for (or defaulted to) and none exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "torch path on the CPU"
        )
    return dev
