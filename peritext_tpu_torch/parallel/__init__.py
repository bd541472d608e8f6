"""Host-side replication (causal scheduling, change stores, anti-entropy),
the convergence digests, the streaming session and its supervisor, and the
fleet's transport: the framed TCP replica endpoint (:mod:`.multihost`),
lag-driven gossip (:mod:`.gossip`), round-counted heartbeat leases
(:mod:`.lease`) and deterministic doc placement (:mod:`.router`)."""

from .anti_entropy import ChangeStore, apply_changes, change_digest, get_missing_changes, sync
from .causal import causal_schedule, causal_sort, causal_waves
from .gossip import GossipPeer, GossipScheduler
from .lease import DEAD, LIVE, SUSPECT, HeartbeatLedger, Lease
from .multihost import (
    RetryPolicy,
    ReplicaServer,
    SyncOutcome,
    merge_changes,
    ship_frames,
    sync_with,
    try_sync_with,
)
from .router import FleetRouter, HostSlot, PlacementError
from .streaming import StreamingMerge
from .supervisor import GuardedSession

__all__ = [
    "ChangeStore",
    "DEAD",
    "FleetRouter",
    "GossipPeer",
    "GossipScheduler",
    "GuardedSession",
    "HeartbeatLedger",
    "HostSlot",
    "LIVE",
    "Lease",
    "PlacementError",
    "ReplicaServer",
    "RetryPolicy",
    "SUSPECT",
    "StreamingMerge",
    "SyncOutcome",
    "apply_changes",
    "causal_schedule",
    "causal_sort",
    "causal_waves",
    "change_digest",
    "get_missing_changes",
    "merge_changes",
    "ship_frames",
    "sync",
    "sync_with",
    "try_sync_with",
]
