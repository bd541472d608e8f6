"""Mesh plumbing shared by the sharded session paths: the mesh's value
identity, per-shard plan planes, and the page mover.

* :func:`mesh_fingerprint` — a mesh's value identity (axis names, shard
  count, devices).  Torch compiles no program per mesh, so the port keeps
  no per-mesh program cache; the fingerprint is what a caller compares
  when it asks whether two meshes are the same one.
* :func:`shard_leading` — host planes stacked on a leading ``(n_shards,
  ...)`` axis, each shard's slice shipped to its own device.
* :func:`permute_shard_rows` — a row permutation over per-shard row
  tensors (a reshard): each destination shard gathers the rows it takes
  from every source shard and copies them to its device.
* :func:`move_pages` — the reshard protocol of the sharded page pool
  (store/sharded.py): pages move from shard to shard at each ring offset
  ``d`` (shard ``s`` sends to ``(s + d) % n``) as device-to-device copies
  (peer copies between cards), and the vacated source pages are re-zeroed.
  The caller (``ShardedPagedDocStore.permute_rows``) allocates first:
  destination pages are disjoint from the pages staying and the pages
  leaving, and every payload is gathered before any page is written, so
  an incoming page never lands on one whose payload is still unread.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def mesh_fingerprint(mesh) -> Tuple:
    """Value identity of a mesh: (axis names, shard grid shape, devices).
    Two meshes agreeing on all three place every shard alike."""
    if mesh is None:
        return ("meshless",)
    return (tuple(mesh.axis_names), (mesh.size,), tuple(str(d) for d in mesh.devices))


def shard_leading(tree, mesh) -> list:
    """One tree per shard from host arrays stacked on a leading shard axis:
    shard ``s`` receives ``leaf[s]`` as a tensor on its device."""
    def take(t, s, dev):
        if isinstance(t, dict):
            return {k: take(v, s, dev) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(take(v, s, dev) for v in t))
        if isinstance(t, (tuple, list)):
            return type(t)(take(v, s, dev) for v in t)
        if isinstance(t, torch.Tensor):
            return t[s].to(dev, copy=True)
        return torch.from_numpy(np.ascontiguousarray(np.asarray(t)[s])).to(dev)

    return [take(tree, s, dev) for s, dev in enumerate(mesh.devices)]


def _index(a: np.ndarray, bound: int, device: torch.device) -> torch.Tensor:
    """The entries of ``a`` below ``bound`` (the pad sentinel is ``bound``:
    the reference's out-of-bounds scatter index, which it drops and torch
    would refuse), as an int64 tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a[a < bound], np.int64)).to(device)


def move_pages(pools_elem: List[torch.Tensor], pools_char: List[torch.Tensor],
               send_idx: np.ndarray, recv_idx: np.ndarray, zero_idx: np.ndarray) -> None:
    """Move pool pages between shards in place (module doc).

    ``pools_elem`` / ``pools_char``: one ``(Ps, P)`` pool per shard, on its
    device.  ``send_idx`` ``(n, n - 1, m)``: shard ``s`` row ``d - 1``
    holds the local pages it sends at ring offset ``d`` (pad 0, the null
    page, whose payload is zeros); ``recv_idx`` ``(n, n - 1, m)``: shard
    ``s`` row ``d - 1`` holds the local destinations of the pages arriving
    from ``(s - d) % n`` (pad ``Ps``, dropped); ``zero_idx`` ``(n, z)``:
    each shard's vacated pages to re-zero afterwards (pad ``Ps``,
    dropped).  The ``k``-th sent page of a pair lands on its ``k``-th
    destination."""
    n = len(pools_elem)
    ps = int(pools_elem[0].shape[0])
    # gather every outgoing payload before any scatter lands
    payload = {}
    for s in range(n):
        for d in range(1, n):
            idx = _index(send_idx[s, d - 1], ps, pools_elem[s].device)
            payload[s, d] = (pools_elem[s][idx], pools_char[s][idx])
    for d in range(1, n):
        for s in range(n):
            dst = (s + d) % n
            recv = recv_idx[dst, d - 1]
            keep = recv < ps
            if not keep.any():
                continue
            dev = pools_elem[dst].device
            pe, pc = payload[s, d]
            sel = torch.from_numpy(np.nonzero(keep)[0]).to(pe.device)
            idx = _index(recv, ps, dev)
            pools_elem[dst][idx] = pe[sel].to(dev)
            pools_char[dst][idx] = pc[sel].to(dev)
    for s in range(n):
        idx = _index(zero_idx[s], ps, pools_elem[s].device)
        if idx.numel():
            pools_elem[s][idx] = 0
            pools_char[s][idx] = 0


def permute_shard_rows(shards: list, src: np.ndarray, mesh) -> list:
    """Per-shard trees of doc rows (one tuple of ``(R, ...)`` tensors per
    shard) after a row permutation: new row ``r`` takes old row
    ``src[r]``.  Each destination shard gathers, from every source shard,
    the rows it takes, and copies them to its own device."""
    src = np.asarray(src, np.int64)
    r = len(src) // mesh.size
    out = []
    for t, dev in enumerate(mesh.devices):
        want = src[t * r:(t + 1) * r]
        fields = []
        for f in range(len(shards[t])):
            dst = torch.empty_like(shards[t][f])
            for s in np.unique(want // r):
                pos = np.nonzero(want // r == s)[0]
                rows = torch.from_numpy(want[pos] - s * r).to(shards[s][f].device)
                dst[torch.from_numpy(pos).to(dev)] = shards[s][f][rows].to(dev)
            fields.append(dst)
        out.append(type(shards[t])(*fields) if hasattr(shards[t], "_fields") else tuple(fields))
    return out
