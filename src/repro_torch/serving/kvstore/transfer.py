"""Event-timeline model of the KV copy channels.

Each direction of the memory hierarchy is a :class:`Channel` — a serial
queue with a bandwidth and a fixed per-transfer latency. Submitting a
transfer occupies the channel until ``start + latency + nbytes/bw``;
subsequent transfers on the same channel queue behind it. Channels are
independent, so a D2H demotion write overlaps an H2D reload (full
duplex), and every transfer overlaps compute — only *reads the engine
is waiting on* enter the critical path, matching LMCache-style async
offload.

The channels:

    h2d        host DRAM  -> HBM        (reload)
    d2h        HBM        -> host DRAM  (TTL-expiry demotion, async)
    ssd_read   SSD        -> host DRAM  (first hop of an SSD reload)
    ssd_write  host DRAM  -> SSD        (pressure demotion, async)

An SSD-resident prefix reloads in *two serial hops* (SSD→DRAM, then
DRAM→HBM) — the corrected pricing that replaces the old one-hop
``min(ssd_bw, h2d_bw)`` formula — and both hops queue behind whatever
is already in flight on their channel. :meth:`TransferEngine.reload_eta`
prices that chain against current queue state without committing;
``commit=True`` actually occupies the channels.

Bandwidth is either a constant (the default, the paper's model) or a
:class:`BandwidthCurve`: a piecewise-linear message-size-dependent
transfer-time model calibrated from measured ``(message_size, bw)``
points, the way :class:`~repro_torch.serving.profiler.HardwareProfile.mfu`
calibrates compute. Small messages on a real PCIe/NVMe link achieve a
fraction of peak bandwidth; the curve prices that, so demoting many
small entries is correctly more expensive per byte than one bulk
staging transfer.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union


@dataclasses.dataclass
class Transfer:
    channel: str
    nbytes: float
    start: float
    end: float

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclasses.dataclass(frozen=True)
class BandwidthCurve:
    """Message-size-dependent transfer time, calibrated from measured
    ``(size_bytes, achieved_bw)`` samples (ascending sizes).

    The model interpolates *transfer time* piecewise-linearly between the
    knots ``t_i = size_i / bw_i`` (and extrapolates at ``bw[0]`` below the
    first knot, ``bw[-1]`` above the last), so transfer seconds are
    monotone non-decreasing in message size by construction — a curve
    whose knot times decrease (physically impossible: sending more bytes
    can't finish sooner) is rejected at construction time."""

    sizes: tuple
    bws: tuple

    def __post_init__(self):
        assert len(self.sizes) == len(self.bws) >= 1, "need >= 1 sample"
        assert all(s > 0 for s in self.sizes) and \
            all(b > 0 for b in self.bws), (self.sizes, self.bws)
        knots = self.knot_seconds()
        for a, b in zip(self.sizes, self.sizes[1:]):
            if b <= a:
                raise ValueError(f"sizes must be ascending: {self.sizes}")
        for a, b in zip(knots, knots[1:]):
            if b < a:
                raise ValueError(
                    "calibration not monotone: a larger message would "
                    f"finish sooner (knot times {knots})")

    @classmethod
    def from_points(cls, points) -> "BandwidthCurve":
        """Build from an iterable of ``(size_bytes, bw)`` pairs."""
        pts = sorted((float(s), float(b)) for s, b in points)
        return cls(tuple(s for s, _ in pts), tuple(b for _, b in pts))

    def knot_seconds(self) -> tuple:
        return tuple(s / b for s, b in zip(self.sizes, self.bws))

    @property
    def peak_bw(self) -> float:
        return max(self.bws)

    def seconds(self, nbytes: float) -> float:
        """Latency-free transfer seconds for an ``nbytes`` message."""
        if nbytes <= 0:
            return 0.0
        sizes, knots = self.sizes, self.knot_seconds()
        if nbytes <= sizes[0]:
            return nbytes / self.bws[0]
        if nbytes >= sizes[-1]:
            return knots[-1] + (nbytes - sizes[-1]) / self.bws[-1]
        for i in range(len(sizes) - 1):
            if nbytes <= sizes[i + 1]:
                f = (nbytes - sizes[i]) / (sizes[i + 1] - sizes[i])
                return knots[i] + f * (knots[i + 1] - knots[i])
        return knots[-1]  # unreachable

    def bandwidth(self, nbytes: float) -> float:
        """Effective bytes/s at this message size."""
        t = self.seconds(nbytes)
        return nbytes / t if t > 0 else self.peak_bw


Bandwidth = Union[float, BandwidthCurve]


def resolve_bandwidth(curve_points, const: float) -> Bandwidth:
    """Config helper: measured (size, bw) points win over the constant."""
    return BandwidthCurve.from_points(curve_points) if curve_points \
        else const


class Channel:
    """Serial transfer queue: one direction of one link."""

    def __init__(self, name: str, bw: Bandwidth, latency: float = 0.0):
        if isinstance(bw, BandwidthCurve):
            self.curve: Optional[BandwidthCurve] = bw
            self.bw = bw.peak_bw            # nominal peak, for insight
        else:
            assert bw > 0, (name, bw)
            self.curve = None
            self.bw = bw
        self.name = name
        self.latency = latency
        self.busy_until = 0.0          # when the queue drains
        self.bytes_moved = 0.0
        self.n_transfers = 0
        # telemetry: every committed transfer becomes a complete span on
        # this channel's trace lane (obs_track, e.g. "r0/h2d")
        self.obs = None
        self.obs_track = ""

    def seconds(self, nbytes: float) -> float:
        """Occupancy of a single transfer (latency + size-dependent time);
        0 for empty messages."""
        if nbytes <= 0:
            return 0.0
        base = self.curve.seconds(nbytes) if self.curve is not None \
            else nbytes / self.bw
        return self.latency + base

    def eta(self, nbytes: float, now: float, earliest: float = 0.0
            ) -> tuple[float, float]:
        """(start, end) the next transfer would get — no commitment.
        ``earliest`` lower-bounds the start (source-readiness chaining)."""
        start = max(now, self.busy_until, earliest)
        return start, start + self.seconds(nbytes)

    def submit(self, nbytes: float, now: float, earliest: float = 0.0
               ) -> Transfer:
        start, end = self.eta(nbytes, now, earliest)
        self.busy_until = end
        self.bytes_moved += max(nbytes, 0.0)
        self.n_transfers += 1
        if self.obs is not None:
            self.obs.channel_transfer(self.obs_track, self.name,
                                      max(nbytes, 0.0), start, end)
        return Transfer(self.name, nbytes, start, end)

    def backlog_seconds(self, now: float) -> float:
        return max(0.0, self.busy_until - now)


class TransferEngine:
    """The four channels plus the reload-chain pricing used by the TTL
    model and admission: how long until a (dram_bytes, ssd_bytes) prefix
    is resident in HBM, given everything already in flight."""

    def __init__(self, h2d_bw: Bandwidth, d2h_bw: Bandwidth,
                 ssd_read_bw: Bandwidth, ssd_write_bw: Bandwidth,
                 latency: float = 0.0):
        self.h2d = Channel("h2d", h2d_bw, latency)
        self.d2h = Channel("d2h", d2h_bw, latency)
        self.ssd_read = Channel("ssd_read", ssd_read_bw, latency)
        self.ssd_write = Channel("ssd_write", ssd_write_bw, latency)
        # cross-replica interconnect NIC: send/receive direction pair,
        # attached lazily by the cluster layer (None = single replica)
        self.peer_out: Optional[Channel] = None
        self.peer_in: Optional[Channel] = None

    # ---------------------------------------------------------------- peers
    def attach_peer_channels(self, out_bw: Bandwidth, in_bw: Bandwidth,
                             latency: float = 0.0) -> None:
        """Add the cross-replica interconnect direction pair. Like the
        four tier channels, each direction is one serial queue: every
        outbound migration from this replica shares (and queues on)
        ``peer_out``, every inbound one on ``peer_in`` — so concurrent
        migrations to/from one replica serialize on its NIC while
        opposite directions overlap (full duplex). Idempotent."""
        if self.peer_out is None:
            self.peer_out = Channel("peer_out", out_bw, latency)
        if self.peer_in is None:
            self.peer_in = Channel("peer_in", in_bw, latency)

    def send_peer(self, nbytes: float, now: float,
                  earliest: float = 0.0) -> Transfer:
        """Outbound hop of a cross-replica KV migration (source NIC)."""
        assert self.peer_out is not None, "attach_peer_channels first"
        return self.peer_out.submit(nbytes, now, earliest)

    def recv_peer(self, nbytes: float, now: float,
                  earliest: float = 0.0) -> Transfer:
        """Inbound hop of a cross-replica KV migration (target NIC)."""
        assert self.peer_in is not None, "attach_peer_channels first"
        return self.peer_in.submit(nbytes, now, earliest)

    # ------------------------------------------------------------- writes
    def write_dram(self, nbytes: float, now: float,
                   earliest: float = 0.0) -> Transfer:
        """Async HBM→DRAM demotion write; returns its completion event.
        The written entry is reloadable only after ``end``."""
        return self.d2h.submit(nbytes, now, earliest)

    def write_ssd(self, nbytes: float, now: float,
                  earliest: float = 0.0) -> Transfer:
        """Async DRAM→SSD pressure-demotion write."""
        return self.ssd_write.submit(nbytes, now, earliest)

    def read_ssd(self, nbytes: float, now: float,
                 earliest: float = 0.0) -> Transfer:
        """SSD→DRAM promotion read (first hop of an SSD reload)."""
        return self.ssd_read.submit(nbytes, now, earliest)

    # ------------------------------------------------------------- reload
    def reload_eta(self, dram_bytes: float, ssd_bytes: float, now: float,
                   dram_ready: float = 0.0, ssd_ready: float = 0.0,
                   commit: bool = False) -> float:
        """Seconds until the whole prefix is HBM-resident.

        The DRAM portion takes one H2D hop; the SSD portion takes a
        serial SSD→DRAM read then its own H2D hop, queued behind the
        DRAM portion's (same channel). ``*_ready`` are the completion
        times of any still-in-flight demotion writes — a reload cannot
        start before the data has actually landed in its tier.
        """
        if dram_bytes <= 0 and ssd_bytes <= 0:
            return 0.0
        if commit:
            done = now
            if dram_bytes > 0:
                done = self.h2d.submit(dram_bytes, now, dram_ready).end
            if ssd_bytes > 0:
                staged = self.ssd_read.submit(ssd_bytes, now, ssd_ready).end
                done = max(done, self.h2d.submit(ssd_bytes, now, staged).end)
            return done - now
        # peek: simulate the chain against a local copy of the h2d queue
        h2d_free = self.h2d.busy_until
        done = now
        if dram_bytes > 0:
            start = max(now, h2d_free, dram_ready)
            h2d_free = start + self.h2d.seconds(dram_bytes)
            done = h2d_free
        if ssd_bytes > 0:
            rstart, staged = self.ssd_read.eta(ssd_bytes, now, ssd_ready)
            start = max(now, h2d_free, staged)
            done = max(done, start + self.h2d.seconds(ssd_bytes))
        return done - now

    def usage(self) -> dict:
        chans = [self.h2d, self.d2h, self.ssd_read, self.ssd_write]
        chans += [c for c in (self.peer_out, self.peer_in) if c is not None]
        return {c.name: {"bytes_moved": c.bytes_moved,
                         "transfers": c.n_transfers,
                         "busy_until": c.busy_until}
                for c in chans}
