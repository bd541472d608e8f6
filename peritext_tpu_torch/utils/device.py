"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller names another device.  With
no card present and none named, they raise: the plain torch path on the
CPU is there for tests that ask for it, never as a silent stand-in for the
device.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
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


def upload_int32(arrays: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """Every array of ``arrays``, as int32, on ``device`` through ONE copy of
    one concatenated buffer; returns contiguous views of it, shaped as the
    arrays.  The buffer is pageable and made here, so the copy has
    completed when this returns."""
    flat = np.concatenate([np.ascontiguousarray(a, np.int32).reshape(-1) for a in arrays.values()]) \
        if arrays else np.zeros(0, np.int32)
    dev = torch.from_numpy(flat).to(device)
    out, off = {}, 0
    for name, a in arrays.items():
        out[name] = dev[off:off + a.size].view(a.shape)
        off += a.size
    return out
