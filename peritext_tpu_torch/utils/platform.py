"""The devices a device mesh runs on.

A mesh (parallel/mesh.py) is an ordered tuple of torch devices, one per
shard, all of one type.  :func:`mesh_devices` picks them:

* real cards by default: ``cuda:0 .. cuda:n-1``, raising when fewer
  cards exist (a mesh never shrinks or moves to the CPU on its own);
* virtual shards when asked for: ``device="cpu"`` gives ``n`` shards on
  the CPU, the counterpart of the reference's forced host devices (the
  port's CPU tests), and a device with an index (``"cuda:0"``) gives
  ``n`` shards on that one card.

Shards on one device are still separate tensors: nothing in the mesh
paths makes one shard a view of another's storage.  The reference's
platform pinning (``XLA_FLAGS``, ``JAX_PLATFORMS``, ``jax.config``) sets
up virtual devices before a backend starts; torch needs no such set-up,
so this module only chooses devices.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch


def mesh_devices(n: int, device: Optional[Union[str, torch.device]] = None) -> List[torch.device]:
    """``n`` devices for a mesh of ``n`` shards (module doc).

    ``device`` None or ``"cuda"``: the first ``n`` cards, raising
    ``RuntimeError`` ("need n cards, have m") when fewer exist;
    ``"cpu"`` or a device with an index: ``n`` virtual shards on it."""
    n = int(n)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"need {n} CUDA devices for a {n}-shard mesh, have {have}; pass "
                f"device='cpu' (or a card such as 'cuda:0') for {n} virtual shards")
        return [torch.device("cuda", i) for i in range(n)]
    if dev.type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if dev.index >= have:
            raise RuntimeError(f"no CUDA device {dev}: {have} card(s) exist")
    elif dev.type != "cpu":
        raise ValueError(f"a mesh runs on cuda or cpu devices, not {dev}")
    return [dev] * n
