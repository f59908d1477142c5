"""Cross-replica KV migration links.

A :class:`PeerLink` is one *direction* of the interconnect between an
ordered pair of replicas, composed from the two endpoints' per-replica
NIC channels (``TransferEngine.peer_out`` on the source,
``TransferEngine.peer_in`` on the target — the same serial-queue
:class:`~repro_torch.serving.kvstore.transfer.Channel` machinery as the tier
channels, including :class:`BandwidthCurve` message-size pricing). A
migration is therefore priced as the three-hop chain the paper's tier
model already knows how to reason about:

    d2h on the source (HBM -> host staging, only if the KV was pinned)
    -> peer_out on the source NIC  (serializes vs other outbound moves)
    -> peer_in on the target NIC   (serializes vs other inbound moves)
    ... and finally h2d on the target when the entry is reloaded.

Because all four hops are independent channels, migrations overlap
compute and tier traffic everywhere; only the *reload the target engine
is waiting on* enters its critical path.

The link keeps an in-flight **ledger**: every migration is recorded with
its departure and arrival times, and the cluster conservation check uses
it to classify a program's KV as "in flight on exactly one PeerLink"
until the arrival time passes (the landed entry is pinned in the target
store for exactly that window, so tier pressure can never drop KV that
is still on the wire).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Migration:
    """One ledger record: a program's KV crossing this link."""
    program_id: str
    tokens: int
    nbytes: float
    src: str                      # engine ids
    dst: str
    depart: float
    arrive: float
    delivered: bool = False       # the arrival-time pump ran for it


class PeerLink:
    """Directed interconnect edge between two replicas' NICs."""

    def __init__(self, src_engine, dst_engine):
        te_out = src_engine.kvstore.transfer
        te_in = dst_engine.kvstore.transfer
        assert te_out.peer_out is not None and te_in.peer_in is not None, \
            "attach_peer_channels on both endpoints first"
        self.src_id = src_engine.engine_id
        self.dst_id = dst_engine.engine_id
        self.out = te_out.peer_out
        self.inn = te_in.peer_in
        self.ledger: list[Migration] = []   # in-flight + not-yet-pumped
        self.bytes_moved = 0.0
        self.n_sent = 0
        self.n_delivered = 0

    # ------------------------------------------------------------- pricing
    def eta(self, nbytes: float, now: float,
            staged_ready: float = 0.0) -> float:
        """Peek the arrival time of an ``nbytes`` migration sent now whose
        source staging copy is ready at ``staged_ready`` — both NIC hops
        queued behind whatever is already in flight, nothing committed."""
        _, sent = self.out.eta(nbytes, now, earliest=staged_ready)
        _, arrive = self.inn.eta(nbytes, now, earliest=sent)
        return arrive

    # -------------------------------------------------------------- commit
    def send(self, program_id: str, tokens: int, nbytes: float, now: float,
             staged_ready: float = 0.0) -> Migration:
        """Commit the two NIC hops and open a ledger record."""
        sent = self.out.submit(nbytes, now, earliest=staged_ready)
        recv = self.inn.submit(nbytes, now, earliest=sent.end)
        m = Migration(program_id, tokens, nbytes, self.src_id, self.dst_id,
                      depart=now, arrive=recv.end)
        self.ledger.append(m)
        self.bytes_moved += nbytes
        self.n_sent += 1
        return m

    # -------------------------------------------------------------- ledger
    def in_flight(self, now: float) -> list[Migration]:
        return [m for m in self.ledger if m.arrive > now]

    def pump(self, now: float) -> list[Migration]:
        """Migrations whose arrival time has passed since the last pump
        (the cluster unpins their landed store entries). Delivered
        records leave the ledger, so conservation scans stay
        O(in-flight)."""
        arrived = [m for m in self.ledger
                   if not m.delivered and m.arrive <= now]
        for m in arrived:
            m.delivered = True
            self.n_delivered += 1
        if arrived:
            self.ledger = [m for m in self.ledger if not m.delivered]
        return arrived
