"""Cross-process monotonic-clock alignment for fleet observability.

Every process in a fleet keeps time with its own ``time.monotonic()``
— the clocks share no epoch, so a replica-side span timestamp is
meaningless in the router's timeline until it is shifted by that
replica's clock offset.  The router estimates the offset from the
request/response pairs it already has: the gossip heartbeat
(docs/FLEET.md) is a natural NTP-style probe, sent at local ``t_send``,
answered with the replica's ``t_remote``, received at local ``t_recv``.

The classic bound applies: assuming the remote timestamp was taken
somewhere inside the round trip, the offset

    offset = t_remote - (t_send + t_recv) / 2

is wrong by at most half the round-trip time — so the estimator keeps a
sliding window of samples and reports the one with the SMALLEST RTT,
whose error bound ``rtt/2`` is the tightest available
(tests/test_fleet_obs.py pins the bound on synthetic samples).

Offsets are defined as ``remote - local``: ``to_local`` maps a
replica-clock timestamp into the router's clock by subtracting the
offset.  Gossip runs every ~25 ms, so the window refreshes fast enough
that monotonic-clock drift (ppm-scale) never dominates the RTT bound.

The same rule aligns two clocks of one process: :func:`wall_offset_s`
is the offset of ``time.time()`` (the clock ``torch.profiler`` stamps
its events with) from ``time.monotonic()`` (the request spans' clock),
from paired reads.
"""

from __future__ import annotations

import threading
import time
from collections import deque


class ClockOffsetEstimator:
    """Min-RTT offset estimate between one remote clock and ours."""

    def __init__(self, window: int = 64):
        self._samples = deque(maxlen=int(window))   # (rtt, offset)
        self._lock = threading.Lock()

    def add_sample(self, t_send: float, t_remote: float,
                   t_recv: float) -> None:
        """One probe: local send/receive timestamps bracketing the
        remote timestamp they carried back."""
        rtt = max(0.0, t_recv - t_send)
        offset = t_remote - 0.5 * (t_send + t_recv)
        with self._lock:
            self._samples.append((rtt, offset))

    @property
    def n(self) -> int:
        return len(self._samples)

    def _best(self):
        with self._lock:
            if not self._samples:
                return None
            return min(self._samples)

    @property
    def offset(self) -> float:
        """Estimated ``remote - local`` offset in seconds (0.0 before
        the first sample)."""
        best = self._best()
        return 0.0 if best is None else best[1]

    @property
    def uncertainty_s(self) -> float:
        """Worst-case estimate error: half the RTT of the sample the
        offset came from (``inf`` before the first sample)."""
        best = self._best()
        return float('inf') if best is None else 0.5 * best[0]

    def to_local(self, t_remote: float) -> float:
        """Map a remote-clock timestamp onto the local clock."""
        return t_remote - self.offset

    def to_remote(self, t_local: float) -> float:
        """Map a local-clock timestamp onto the remote clock."""
        return t_local + self.offset


def wall_offset_s() -> float:
    """``time.time() - time.monotonic()`` in seconds: 16 wall reads, each
    bracketed by two monotonic reads, and the one with the smallest
    bracket kept (:class:`ClockOffsetEstimator`'s rule; error under a
    microsecond).  Measured anew on each call, since the wall clock may
    be stepped."""
    est = ClockOffsetEstimator(window=16)
    for _ in range(16):
        t_send = time.monotonic()
        t_wall = time.time()
        est.add_sample(t_send, t_wall, time.monotonic())
    return est.offset
