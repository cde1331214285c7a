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

Host spans (:func:`host_span`) are the other half: spans inside the
port's hot paths, on every thread, on the clock ``torch.profiler``
stamps its events with (``time.time_ns()``), kept in one process-wide
ring (:data:`HOST_SPANS`) while a profile collects, so that each idle
gap of the device's trace lines up with what the host was doing.
Taxonomy (every span that blocks on the device is named ``*.wait``;
PERF.md section 3 names the benchmark metric that reads each):

    ``physics.batch``   ``sim.physics.run_physics_batch`` (args: shots,
                        engine, exec: ``'kernel'`` where the exec hop is
                        one span-kernel launch an epoch, else
                        ``'plain'``, device: the device model's kind),
                        with ``physics.prepare``, then per
                        epoch ``physics.epoch`` (arg: ep) over
                        ``physics.wait``,
                        ``physics.exec`` and ``physics.resolve``, and
                        ``physics.finalize``
    ``statevec.apply``  ``sim.interpreter._statevec_pulse``, once a step of
                        the generic engine on the statevec device (under
                        ``physics.exec``): the 1q, coupling, noise and
                        collapse updates the step enqueues
    ``sweep.stats``     ``parallel.sweep.physics_batch_stats``
    ``rounds.call``     ``sim.interpreter.simulate_rounds``, over
                        ``rounds.prepare``, ``rounds.exec``,
                        ``rounds.decode`` and ``rounds.wait``
    ``serve.*``         ``ExecutionService._dispatch_batch`` on the
                        dispatcher thread: ``serve.pack``,
                        ``serve.enqueue``, ``serve.copy``, ``serve.demux``
    ``step.wait``       the settle test of the generic and block engines'
                        step loop, a host read once a step
    ``h2d.wait``        a blocking copy of a host constant or input to the
                        device, which first waits for the stream's queued
                        work: in the straight-line engine's eager pass
                        once a constant, in ``_step`` once a step, and
                        around each call's program constants and inputs

The ``*.wait`` spans nest under the span whose work they interrupt.

The statevec block's counter (``utils.profiling``, on the host, one
increment a step, no device read): ``statevec.steps``, the engine steps
it took; each enqueues the same updates (C 1q, one a coupling, C
measurement).  On the device, ``run_physics_batch`` returns the event
gate's ``gate_stall_steps`` and ``live_core_steps``.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque

import torch.autograd.profiler as _profiler

from .clock import wall_offset_s

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


def chrome_trace_events(contexts, pid: str = 'serve', base_ns: int = None,
                        host_spans=()) -> list:
    """Flatten trace contexts into Chrome Trace Event dicts.

    Duration spans become complete events (``ph: "X"``), instants
    become thread-scoped instant events (``ph: "i"``); each request is
    its own ``tid`` row so Perfetto renders a per-request waterfall.
    Timestamps are in µs: rebased to the earliest span, or, with
    ``base_ns``, on the profiler's clock as µs past ``base_ns`` (a
    ``torch.profiler`` trace's ``baseTimeNanoseconds``; 0 for the Unix
    epoch) — the request spans shifted from ``time.monotonic()`` by
    :func:`~.clock.wall_offset_s`, and ``host_spans`` (dicts of
    :meth:`HostSpanRing.spans`) added as one ``tid`` row per thread — so the
    file and the profiler's trace open as one timeline.
    """
    if base_ns is not None:
        off = wall_offset_s()

        def ts(t):
            return round((t + off) * 1e6 - base_ns / 1e3, 3)
    else:
        t_base = None
        for ctx in contexts:
            for s in ctx.spans:
                if t_base is None or s['t0'] < t_base:
                    t_base = s['t0']
        if t_base is None:
            return []

        def ts(t):
            return round((t - t_base) * 1e6, 3)
    events = []
    for ctx in contexts:
        tid = f'req-{ctx.trace_id}'
        for s in ctx.spans:
            ev = {'name': s['name'], 'cat': 'serve', 'pid': pid,
                  'tid': tid, 'ts': ts(s['t0'])}
            if s['t1'] is not None:
                ev['ph'] = 'X'
                ev['dur'] = round(max(0.0, s['t1'] - s['t0']) * 1e6, 3)
            else:
                ev['ph'] = 'i'
                ev['s'] = 't'
            if s['args']:
                ev['args'] = s['args']
            events.append(ev)
    if base_ns is not None:
        for s in host_spans:
            ev = {'name': s['name'], 'cat': 'host', 'ph': 'X', 'pid': pid,
                  'tid': f'thread-{s["thread"]}',
                  'ts': round((s['t0'] - base_ns) / 1e3, 3),
                  'dur': round((s['t1'] - s['t0']) / 1e3, 3)}
            if s['args']:
                ev['args'] = s['args']
            events.append(ev)
    return events


def write_chrome_trace(path: str, contexts, pid: str = 'serve',
                       base_ns: int = None, host_spans=()) -> int:
    """Write a Perfetto-loadable trace file; returns the event count.
    ``base_ns``, ``host_spans``: as in :func:`chrome_trace_events`.

    Atomic (tmp + rename) so a reader never sees a torn file.
    """
    events = chrome_trace_events(contexts, pid=pid, base_ns=base_ns,
                                 host_spans=host_spans)
    doc = {'traceEvents': events, 'displayTimeUnit': 'ms'}
    if base_ns is not None:
        doc['baseTimeNanoseconds'] = int(base_ns)
    tmp = f'{path}.tmp.{os.getpid()}'
    with open(tmp, 'w') as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return len(events)


# ---------------------------------------------------------------------------
# host spans: the port's hot paths on the profiler's clock
# ---------------------------------------------------------------------------

class HostSpanRing:
    """Bounded ring of finished host spans, oldest first: the newest
    ``capacity`` are kept, ``recorded`` counts every span ever appended
    and ``dropped`` those the ring has overwritten (as
    :class:`~.recorder.FlightRecorder` counts its events).  Appends come
    from any thread; a short lock keeps the count and the ring in step.
    """

    def __init__(self, capacity: int = 1 << 16):
        self.capacity = int(capacity)
        self._ring = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._n = 0

    def append(self, span: dict) -> None:
        with self._lock:
            self._ring.append(span)
            self._n += 1

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._n = 0

    @property
    def recorded(self) -> int:
        return self._n

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._n - len(self._ring)

    def spans(self, start_ns: int = None, end_ns: int = None) -> list:
        """The retained spans that lie inside ``[start_ns, end_ns]``
        (either bound may be omitted), oldest first: dicts of ``name``,
        ``t0``, ``t1`` (``time.time_ns()``), ``args``, ``id``, ``parent``
        (the enclosing span's ``id`` on the same thread, or None) and
        ``thread``."""
        with self._lock:
            out = list(self._ring)
        if start_ns is not None:
            out = [s for s in out if s['t0'] >= start_ns]
        if end_ns is not None:
            out = [s for s in out if s['t1'] <= end_ns]
        return out


# the process-wide ring every span site appends to
HOST_SPANS = HostSpanRing()

_ids = itertools.count(1)
_local = threading.local()


class _HostSpan:
    """One open span: the thread-local stack gives its parent."""

    __slots__ = ('name', 'args', 'id', 'parent', 't0')

    def __init__(self, name: str, args: dict):
        self.name, self.args = name, args

    def arg(self, key: str, value) -> None:
        """Add an argument known only once the span is open."""
        self.args[key] = value

    def __enter__(self):
        stack = getattr(_local, 'stack', None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.time_ns()
        _local.stack.pop()
        HOST_SPANS.append({'name': self.name, 't0': self.t0, 't1': t1,
                           'args': self.args, 'id': self.id,
                           'parent': self.parent,
                           'thread': threading.get_ident()})
        return False


class _NoSpan:
    """The shared span of every site while no profile collects."""

    __slots__ = ()

    def arg(self, key: str, value) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


def host_span(name: str, key: str = None, value=None, key2: str = None,
              value2=None):
    """A context manager that records the span ``name`` in
    :data:`HOST_SPANS` while a ``torch.profiler`` profile collects
    anywhere in the process, with up to two arguments given as
    positional key/value pairs (so that a site allocates nothing).

    The switch is ``torch.autograd.profiler._is_profiler_enabled``,
    which the profiler sets for the whole process (not per thread, as
    ``torch._C._autograd._profiler_enabled()`` is), so spans of the
    service's dispatcher thread record too; while it is off a site
    costs that one attribute read and gets a shared no-op span.  Times
    are ``time.time_ns()``, the clock the profiler stamps host and
    device events with."""
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    args = {}
    if key is not None:
        args[key] = value
    if key2 is not None:
        args[key2] = value2
    return _HostSpan(name, args)


def self_time_ns(spans) -> dict:
    """``id -> ns`` for every span of ``spans``: its duration less what
    its child spans among ``spans`` cover (children nest inside their
    parent on its thread, one after another)."""
    covered = {}
    for s in spans:
        if s['parent'] is not None:
            covered[s['parent']] = covered.get(s['parent'], 0) \
                + (s['t1'] - s['t0'])
    return {s['id']: s['t1'] - s['t0'] - covered.get(s['id'], 0)
            for s in spans}


def host_work_intervals(spans) -> list:
    """Sorted, disjoint ``[start_ns, end_ns]`` intervals in which some
    thread's innermost open span among ``spans`` is not a ``*.wait``:
    the host working, not waiting on the device."""
    kids = {}
    for s in spans:
        if s['parent'] is not None:
            kids.setdefault(s['parent'], []).append((s['t0'], s['t1']))
    iv = []
    for s in spans:
        if s['name'].endswith('.wait'):
            continue
        t = s['t0']
        for a, b in sorted(kids.get(s['id'], ())):
            if a > t:
                iv.append((t, a))
            t = max(t, b)
        if s['t1'] > t:
            iv.append((t, s['t1']))
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def host_idle_ns(spans, busy) -> int:
    """Nanoseconds of the host work among ``spans``
    (:func:`host_work_intervals`) that no interval of ``busy`` covers:
    ``busy`` is sorted, disjoint ``(start_ns, end_ns)`` intervals of the
    device's activity, so the result is the time the device idled while
    the port's host worked."""
    busy = list(busy)
    idle, j = 0, 0
    for s, e in host_work_intervals(spans):
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k, t = j, s
        while k < len(busy) and busy[k][0] < e:
            idle += max(0, busy[k][0] - t)
            t = max(t, busy[k][1])
            k += 1
        idle += max(0, e - t)
    return idle
