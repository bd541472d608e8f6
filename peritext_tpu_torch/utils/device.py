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


def pack_int32(arrays: Dict[str, np.ndarray]):
    """``(flat, layout)``: every array of ``arrays``, in order, as int32 in
    ONE buffer, and the ``((name, shape), ...)`` that slices it back
    (:func:`unpack_int32`)."""
    layout = tuple((name, tuple(np.shape(a))) for name, a in arrays.items())
    flat = (np.concatenate([np.ascontiguousarray(a, np.int32).reshape(-1)
                            for a in arrays.values()])
            if arrays else np.zeros(0, np.int32))
    return flat, layout


def unpack_int32(buf: torch.Tensor, layout) -> Dict[str, torch.Tensor]:
    """Views of a packed buffer by name, shaped as ``layout`` says, at its
    static offsets."""
    out, off = {}, 0
    for name, shape in layout:
        n = int(np.prod(shape, dtype=np.int64))
        out[name] = buf[off:off + n].view(shape)
        off += n
    return out


def upload_int32(arrays: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """Every array of ``arrays``, as int32, on ``device`` through ONE copy of
    one concatenated buffer (:func:`pack_int32`); returns contiguous views
    of it, shaped as the arrays.  The buffer is pageable and made here, so
    the copy has completed when this returns."""
    flat, layout = pack_int32(arrays)
    return unpack_int32(torch.from_numpy(flat).to(device), layout)
