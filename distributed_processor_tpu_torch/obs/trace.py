"""Per-request tracing: typed lifecycle spans, Chrome Trace export.

A sampled request carries one :class:`TraceContext` on its
:class:`~..serve.request.RequestHandle` from ``submit``/``submit_source``
to resolution; the serving layers append spans as the request moves
through the pipeline.  The span taxonomy (docs/OBSERVABILITY.md):

duration spans (``t0``..``t1``)
    ``compile``         submit_source front door (args: hit/disk/miss/wait)
    ``queued``          submit (or requeue) → claimed by a dispatcher
    ``coalesce.ripen``  oldest batch member's wait → batch pop
    ``dispatch``        claim → simulate entry (args: device, bucket,
                        cold/warm/aot classification, engine, occupancy)
    ``execute``         the whole ``_run_batch`` window (chaos included)
    ``demux``           per-request result split + fulfil

instant events (hops; ``t1`` is None)
    ``submit`` ``submit_source`` ``park`` ``unpark`` ``steal``
    ``migrate`` ``retry`` ``retry_exhausted`` ``requeue`` ``chaos``
    ``shed`` ``batch_error`` ``done``

A retried request simply accumulates another ``queued``/``dispatch``/
``execute`` run joined by ``retry``/``requeue`` instants — the
multi-hop chain the chaos tests assert on.

Export is Chrome Trace Event JSON (``{"traceEvents": [...]}``), one
``tid`` row per request, loadable in Perfetto / chrome://tracing.
Times are ``time.monotonic()`` seconds internally, rebased to
microseconds at export.

Cost discipline: with sampling off the per-request footprint is the
``None`` context slot already present on every handle — ``maybe_start``
returns ``None`` without allocating, and every emission site guards on
``handle._trace is not None``.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from collections import deque

# canonical stage order for waterfall-style summaries (tools/traceview).
# The fleet stages interleave with the service stages when a request
# crosses the wire (docs/OBSERVABILITY.md "Fleet observability"):
# `route` and `wire.send` are router-side, the replica stages (queued..
# demux) land inside the `wire.await` window after clock alignment.
STAGE_ORDER = ('submit', 'submit_source', 'route', 'wire.send',
               'compile', 'queued', 'coalesce.ripen', 'dispatch',
               'execute', 'demux', 'wire.await')


def _period_of(sample: float) -> int:
    if sample <= 0.0:
        return 0
    if sample >= 1.0:
        return 1
    return max(1, int(round(1.0 / sample)))


class TraceContext:
    """Span accumulator for one sampled request.

    Appends come from the submitter thread, dispatcher threads, and the
    supervisor; ``list.append`` is atomic under the GIL and spans are
    immutable once appended, so no lock is needed.  ``last_claim``
    carries the batch-claim timestamp from the dispatch loop to the
    ``dispatch`` span recorded inside the batch runner.
    """

    __slots__ = ('trace_id', 'spans', 'last_claim')

    def __init__(self, trace_id: int):
        self.trace_id = trace_id
        self.spans = []
        self.last_claim = None

    def span(self, name: str, t0: float, t1: float, **args) -> None:
        """Record a completed duration span."""
        self.spans.append({'name': name, 't0': t0, 't1': t1,
                           'args': args})

    def instant(self, name: str, t: float = None, **args) -> None:
        """Record an instant (zero-duration hop) event."""
        self.spans.append({'name': name,
                           't0': time.monotonic() if t is None else t,
                           't1': None, 'args': args})


class Tracer:
    """Sampling front door + bounded retention of sampled contexts.

    ``sample`` is the fraction of submissions traced: ``0`` disables
    tracing entirely (``maybe_start`` returns ``None`` with no
    allocation), ``>= 1`` traces everything, and intermediate values
    sample deterministically every ``round(1/sample)``-th submission —
    deterministic so tests and repeated bench runs see the same set.
    """

    def __init__(self, sample: float = 0.0, keep: int = 1024):
        self.sample = float(sample)
        self._period = _period_of(self.sample)
        self._seq = itertools.count()
        self._kept = deque(maxlen=keep)

    @property
    def enabled(self) -> bool:
        return self._period > 0

    def set_sample(self, sample: float) -> None:
        """Retune the sampling rate in place, keeping the id sequence
        and retained contexts (bench sweeps use this to compare trace
        cost without rebuilding retention)."""
        self.sample = float(sample)
        self._period = _period_of(self.sample)

    def sampled(self, trace_id: int) -> bool:
        """The sampling decision as a pure function of the trace id —
        deterministic, so two processes holding the same rate agree on
        the same ids (the fleet router and its replicas)."""
        return self._period > 0 and trace_id % self._period == 0

    def maybe_start(self) -> TraceContext | None:
        """Sampling decision for one submission: a fresh context when
        sampled (retained for later export), else ``None``."""
        if not self._period:
            return None
        n = next(self._seq)
        if not self.sampled(n):
            return None
        return self.start(n)

    def start(self, trace_id: int) -> TraceContext:
        """Open a context for an externally-made sampling decision —
        the fleet wire carries the ROUTER's decision to the replica,
        which must trace exactly those requests regardless of its own
        sampling rate.  Retained like locally sampled contexts."""
        ctx = TraceContext(int(trace_id))
        self._kept.append(ctx)
        return ctx

    def contexts(self) -> list:
        """Snapshot of retained contexts, oldest first."""
        return list(self._kept)


def chrome_trace_events(contexts, pid: str = 'serve') -> list:
    """Flatten trace contexts into Chrome Trace Event dicts.

    Duration spans become complete events (``ph: "X"``), instants
    become thread-scoped instant events (``ph: "i"``); each request is
    its own ``tid`` row so Perfetto renders a per-request waterfall.
    Timestamps are rebased to the earliest span and expressed in µs.
    """
    t_base = None
    for ctx in contexts:
        for s in ctx.spans:
            if t_base is None or s['t0'] < t_base:
                t_base = s['t0']
    if t_base is None:
        return []
    events = []
    for ctx in contexts:
        tid = f'req-{ctx.trace_id}'
        for s in ctx.spans:
            ev = {'name': s['name'], 'cat': 'serve', 'pid': pid,
                  'tid': tid,
                  'ts': round((s['t0'] - t_base) * 1e6, 3)}
            if s['t1'] is not None:
                ev['ph'] = 'X'
                ev['dur'] = round(max(0.0, s['t1'] - s['t0']) * 1e6, 3)
            else:
                ev['ph'] = 'i'
                ev['s'] = 't'
            if s['args']:
                ev['args'] = s['args']
            events.append(ev)
    return events


def write_chrome_trace(path: str, contexts, pid: str = 'serve') -> int:
    """Write a Perfetto-loadable trace file; returns the event count.

    Atomic (tmp + rename) so a reader never sees a torn file.
    """
    events = chrome_trace_events(contexts, pid=pid)
    doc = {'traceEvents': events, 'displayTimeUnit': 'ms'}
    tmp = f'{path}.tmp.{os.getpid()}'
    with open(tmp, 'w') as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return len(events)
