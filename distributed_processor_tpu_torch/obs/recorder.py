"""Flight recorder: a lock-cheap ring buffer of structured events.

When a chaos soak ends with a tripped breaker or a dead executor, the
counters say *that* it happened; the flight recorder says *what led up
to it* — the last N supervision events in order, each a small JSON-able
dict.  Event taxonomy (docs/OBSERVABILITY.md):

``breaker_trip``     executor quarantined (consecutive infra failures)
``canary``           canary probe result (``ok`` bool)
``readmission``      quarantined executor re-admitted after canary pass
``executor_death``   dispatcher thread found dead by the supervisor
``respawn``          dead dispatcher re-spawned
``hang``             dispatch exceeded the hang watchdog
``shed``             overload eviction of a queued request
``overload_reject``  admission-time overload rejection
``retry``            batch failure re-queued under the retry policy
``retry_exhausted``  retry budget exhausted, request failed
``batch_failure``    a batch raised (infra or program class)
``chaos_inject``     ChaosMonkey injected a non-ok outcome
``cache_invalidate`` compile-cache calibration-epoch invalidation
``integrity_violation`` audit or digest mismatch (edge-triggered per
                     executor: one event per clean->bad transition)
``scrubber_fail``    background scrubber canary mismatched golden ref

Cost discipline: ``record`` is one dict build + ``deque.append``
(atomic under the GIL) + an ``itertools.count`` draw — no lock, safe
from any thread.  The ring holds the newest ``capacity`` events;
``recorded`` counts everything ever seen so truncation is visible.

``ExecutionService`` owns one recorder per service and dumps it
automatically on supervisor-detected failures when ``flight_dump_dir``
(or ``$DPROC_FLIGHT_DIR``) is set; ``tools/servechaos.py`` attaches the
recorder to its exit report.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from collections import Counter, deque


class FlightRecorder:
    """Bounded in-memory ring of structured events."""

    def __init__(self, capacity: int = 512):
        self.capacity = int(capacity)
        self._ring = deque(maxlen=self.capacity)
        self._seq = itertools.count()

    def record(self, kind: str, **data) -> None:
        """Append one event; ``data`` values must be JSON-able.  The
        ``seq``/``t``/``mono``/``kind`` fields are the recorder's own —
        a colliding payload key is overwritten, never the envelope."""
        ev = dict(data)
        ev.update(seq=next(self._seq), t=time.time(),
                  mono=time.monotonic(), kind=kind)
        self._ring.append(ev)

    @property
    def recorded(self) -> int:
        """Total events ever recorded (>= len(events()) once the ring
        wraps)."""
        # itertools.count has no peek; its pickle form carries the
        # next value to be drawn
        return self._seq.__reduce__()[1][0]

    @property
    def dropped(self) -> int:
        """Events overwritten by ring wrap: a nonzero value means the
        dump is a TRUNCATED incident timeline, not a quiet one — the
        federated fleet report surfaces it per replica."""
        return max(0, self.recorded - len(self._ring))

    def events(self, kind: str = None) -> list:
        """Snapshot of retained events, oldest first; optionally
        filtered by ``kind``."""
        evs = list(self._ring)
        if kind is not None:
            evs = [e for e in evs if e['kind'] == kind]
        return evs

    def counts(self) -> dict:
        """Retained event counts by kind."""
        return dict(Counter(e['kind'] for e in self._ring))

    def to_json(self) -> dict:
        return {'capacity': self.capacity, 'recorded': self.recorded,
                'dropped': self.dropped, 'counts': self.counts(),
                'events': self.events()}

    def dump(self, path: str) -> int:
        """Atomically write the ring to ``path``; returns the retained
        event count."""
        doc = self.to_json()
        tmp = f'{path}.tmp.{os.getpid()}'
        with open(tmp, 'w') as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)
        return len(doc['events'])
