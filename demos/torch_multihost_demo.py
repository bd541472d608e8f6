#!/usr/bin/env python
"""Multi-host convergence demo on the PyTorch/CUDA port: three hosts, real
sockets, one shared doc.

Each "host" owns one collaborating actor of a fuzz-generated editing session:
its own append-only ChangeStore, a TCP anti-entropy endpoint
(parallel/multihost.py) speaking binary codec frames, and its own device
merge session (parallel/streaming.py) fed raw wire bytes through the
server's on_frame hook (frame-native ingest — no Python Change objects on
the device path; on_changes only counts deliveries for the quiescence
check).  Gossip rounds around the ring converge all three stores, and each
host's device state converges to the same digest — the multi-host analog of
the reference's in-memory Publisher + getMissingChanges sync
(src/pubsub.ts, test/merge.ts), with DCN traffic carrying only change
frames while per-op CRDT work stays on each host's chips.

Run: python demos/torch_multihost_demo.py [--device D]   (default cuda)
"""

import argparse
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

ACTORS = ("doc1", "doc2", "doc3")


class Host:
    """One simulated host: store + TCP endpoint + device merge session."""

    def __init__(self, name: str, actor: str, workload, device: str = "cuda"):
        from peritext_tpu_torch.parallel import ChangeStore, ReplicaServer
        from peritext_tpu_torch.parallel.codec import encode_frame
        from peritext_tpu_torch.parallel.streaming import StreamingMerge

        self.name = name
        self.actor = actor
        self.store = ChangeStore()
        self.session = StreamingMerge(
            num_docs=1, actors=ACTORS, slot_capacity=512, mark_capacity=128,
            device=device,
        )
        self._ingest_lock = threading.Lock()
        self._delivered = 0
        own = workload.get(actor, [])
        for change in own:
            self.store.append(change)
        if own:
            self._ingest_frame(encode_frame(own), len(own))
        # wire bytes flow straight into the device session (on_frame): no
        # Python Change objects on the hot ingest path; on_changes only
        # counts deliveries for the quiescence check
        self.server = ReplicaServer(
            self.store,
            on_changes=self._count,
            on_frame=lambda frame: self._ingest_frame(frame, 0),
        )
        self.address = self.server.start()

    def _count(self, changes):
        with self._ingest_lock:
            self._delivered += len(changes)

    def _ingest_frame(self, frame, count):
        with self._ingest_lock:
            self._delivered += count
            self.session.ingest_frame(0, frame)
            self.session.drain()

    def digest(self) -> int:
        with self._ingest_lock:
            return self.session.digest()

    def settled(self) -> bool:
        """True once every change in the store has been delivered to the
        device session (the server's on_changes hook runs on its handler
        thread, so ingestion trails sync_with returning).  Counts deliveries
        rather than comparing clocks: the session may legitimately hold back
        causally incomplete changes mid-gossip."""
        in_store = sum(len(self.store.log(a)) for a in self.store.actors())
        with self._ingest_lock:
            return self._delivered == in_store

    def text(self) -> str:
        with self._ingest_lock:
            return "".join(s["text"] for s in self.session.read(0))

    def stop(self):
        self.server.stop()


def _wait_settled(hosts, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while not all(h.settled() for h in hosts):
        if time.monotonic() > deadline:  # pragma: no cover
            raise RuntimeError("hosts failed to ingest synced changes in time")
        time.sleep(0.01)


def run(device: str = "cuda") -> dict:
    """The demo on ``device``: prints its progress, checks convergence, and
    returns the gossip rounds, each host's final digest and the seconds."""
    from peritext_tpu_torch.api.batch import _oracle_doc
    from peritext_tpu_torch.testing.fuzz import generate_workload

    t_all = time.perf_counter()

    workload = generate_workload(seed=33, num_docs=1, ops_per_doc=150)[0]

    # Each actor additionally sets per-host MAP state (a metadata key under
    # the root map): the convergence digest is full-state, so the gossip
    # loop below provably synchronizes map registers, not just text+marks.
    from peritext_tpu_torch.core.opids import ROOT
    from peritext_tpu_torch.core.types import Change, Operation

    for actor in ACTORS:
        log = workload.setdefault(actor, [])
        next_op = max(
            [ch.start_op + len(ch.ops) for ch in log], default=1
        )
        log.append(Change(
            actor=actor, seq=len(log) + 1, deps={}, start_op=next_op,
            ops=[Operation(action="set", obj=ROOT, opid=(next_op, actor),
                           key=f"edited-by-{actor}", value=True)],
        ))

    total = sum(len(log) for log in workload.values())
    print(f"session: {total} changes by {len(ACTORS)} actors, one host each\n")

    hosts = [Host(f"host{i}", actor, workload, device) for i, actor in enumerate(ACTORS)]
    try:
        for h in hosts:
            print(f"{h.name} ({h.actor}) @ {h.address[0]}:{h.address[1]} "
                  f"digest={h.digest():#010x}")

        round_no = 0
        while len({h.digest() for h in hosts}) > 1:
            round_no += 1
            print(f"\n-- gossip round {round_no} (ring) --")
            for i, h in enumerate(hosts):
                peer = hosts[(i + 1) % len(hosts)]
                pulled, pushed = h.server.sync_with(*peer.address)
                print(f"{h.name} <-> {peer.name}: pulled {pulled}, pushed {pushed}")
            # pushed changes are ingested on the receiving server's handler
            # thread; wait for quiescence before reading digests
            _wait_settled(hosts)
            for h in hosts:
                print(f"{h.name} digest={h.digest():#010x} "
                      f"frontier={h.store.clock()}")
            if round_no > 5:
                raise RuntimeError("gossip failed to converge")

        digests = {h.digest() for h in hosts}
        assert len(digests) == 1, digests
        expected = _oracle_doc(workload).get_text_with_formatting(["text"])
        expected_text = "".join(s["text"] for s in expected)
        meta_keys = {f"edited-by-{a}" for a in ACTORS}
        for h in hosts:
            assert h.text() == expected_text, h.name
            # the full-state digest above already proves map convergence;
            # read back the registers as direct evidence too
            root = h.session.read_root(0)
            assert meta_keys <= set(root), (h.name, root)
        print(f"\nall hosts converged after {round_no} gossip rounds "
              f"(digest covers text+marks+map; every host sees {sorted(meta_keys)})")
        print(f"shared digest: {hosts[0].digest():#010x}")
        print(f"document ({len(expected_text)} chars): {expected_text[:70]!r}...")
        return dict(rounds=round_no, digests=[h.digest() for h in hosts],
                    seconds=time.perf_counter() - t_all)
    finally:
        for h in hosts:
            h.stop()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="cuda",
                        help="torch device of every host's session (default cuda; raises "
                             "without a card)")
    run(parser.parse_args(argv).device)


if __name__ == "__main__":
    main()
