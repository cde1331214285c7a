"""Typed metrics registry: counters, gauges, fixed-bucket histograms.

The flat named-counter dict in ``utils/profiling.py`` grew organically
from the interpreter's retrace probes into the serving tier's whole
metrics surface.  This module is the typed replacement it delegates to:
one process-wide :class:`MetricsRegistry` holding

``counter``    monotone int (the existing ``counter_inc`` namespace —
               every ``serve.*`` / ``*_trace`` / ``aot_*`` name lands
               here unchanged)
``gauge``      last-write-wins float (queue depths, cache sizes)
``histogram``  fixed-bucket counts + sum/count for exposition, plus a
               bounded window of raw samples so existing exact-
               percentile ``stats()`` fields stay byte-compatible

with a Prometheus-style text exposition (:meth:`prometheus_text`) and a
snapshot/restore API that the test suite uses to isolate counter
asserts from execution order (tests/conftest.py).

Deliberately stdlib-only and import-cheap: the serve dispatcher
increments counters on its hot path and the tracing layer must be
importable without the array libraries.
"""

from __future__ import annotations

import bisect
import math
import re
import threading
from collections import deque

# latency-flavoured default bucket ladder (milliseconds); the +inf
# bucket is implicit — Prometheus convention, cumulative on exposition
DEFAULT_BUCKETS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
                   250.0, 500.0, 1000.0, 2500.0, 5000.0)

_NAME_RE = re.compile(r'[^a-zA-Z0-9_:]')


def _prom_name(name: str) -> str:
    """Sanitize a dotted counter name into a Prometheus metric name."""
    out = _NAME_RE.sub('_', name)
    if out and out[0].isdigit():
        out = '_' + out
    return out


def escape_label_value(value) -> str:
    """Escape a label value per the Prometheus text-format spec:
    backslash, double-quote, and newline must be backslash-escaped.
    Replica ids and bucket-spec labels flow through here on the fleet
    exposition path."""
    return (str(value).replace('\\', '\\\\').replace('"', '\\"')
            .replace('\n', '\\n'))


def _format_labels(labels: dict) -> str:
    """``{k="v",...}`` with keys sorted, values escaped; '' if empty."""
    if not labels:
        return ''
    body = ','.join(f'{k}="{escape_label_value(v)}"'
                    for k, v in sorted(labels.items()))
    return '{' + body + '}'


def prometheus_snapshot_lines(snap: dict, labels: dict = None,
                              type_lines: bool = True) -> list:
    """Render a :meth:`MetricsRegistry.snapshot` dict as Prometheus
    text-format lines, optionally stamping constant ``labels`` onto
    every series — the fleet router re-exposes each replica's snapshot
    with a ``replica`` label this way (docs/FLEET.md)."""
    labels = dict(labels or {})
    lab = _format_labels(labels)
    lines = []
    for name, val in sorted(snap.get('counters', {}).items()):
        pn = _prom_name(name)
        if type_lines:
            lines.append(f'# TYPE {pn} counter')
        lines.append(f'{pn}{lab} {val}')
    for name, val in sorted(snap.get('gauges', {}).items()):
        pn = _prom_name(name)
        if type_lines:
            lines.append(f'# TYPE {pn} gauge')
        lines.append(f'{pn}{lab} {val}')
    for name, st in sorted(snap.get('histograms', {}).items()):
        pn = _prom_name(name)
        if type_lines:
            lines.append(f'# TYPE {pn} histogram')
        lines.extend(_histogram_lines(pn, st, labels))
    return lines


def _histogram_lines(pn: str, st: dict, labels: dict) -> list:
    lines = []
    cum = 0
    for edge, c in zip(st['buckets'], st['counts']):
        cum += c
        lines.append(
            f'{pn}_bucket{_format_labels({**labels, "le": edge})} '
            f'{cum}')
    cum += st['counts'][-1]
    lines.append(
        f'{pn}_bucket{_format_labels({**labels, "le": "+Inf"})} {cum}')
    lab = _format_labels(labels)
    lines.append(f'{pn}_sum{lab} {st["sum"]}')
    lines.append(f'{pn}_count{lab} {st["n"]}')
    return lines


def merged_prometheus_text(snapshots: dict, label: str = 'replica'
                           ) -> list:
    """Merge per-process registry snapshots into one labeled
    exposition: for every metric name, one ``# TYPE`` line, a
    fleet-level ROLLUP series (counters: sum; histograms: summed
    buckets when the ladders agree), then one ``{label="<id>"}``
    series per process.  ``snapshots`` maps process id (replica id) →
    :meth:`MetricsRegistry.snapshot` dict; returns text lines."""
    lines = []
    names = sorted({n for s in snapshots.values()
                    for n in s.get('counters', {})})
    for name in names:
        pn = _prom_name(name)
        lines.append(f'# TYPE {pn} counter')
        lines.append(f'{pn} ' + str(sum(
            s.get('counters', {}).get(name, 0)
            for s in snapshots.values())))
        for rid in sorted(snapshots):
            val = snapshots[rid].get('counters', {}).get(name)
            if val is not None:
                lines.append(f'{pn}{_format_labels({label: rid})} '
                             f'{val}')
    names = sorted({n for s in snapshots.values()
                    for n in s.get('gauges', {})})
    for name in names:
        pn = _prom_name(name)
        lines.append(f'# TYPE {pn} gauge')
        for rid in sorted(snapshots):
            val = snapshots[rid].get('gauges', {}).get(name)
            if val is not None:
                lines.append(f'{pn}{_format_labels({label: rid})} '
                             f'{val}')
    names = sorted({n for s in snapshots.values()
                    for n in s.get('histograms', {})})
    for name in names:
        pn = _prom_name(name)
        lines.append(f'# TYPE {pn} histogram')
        sts = {rid: snapshots[rid]['histograms'][name]
               for rid in sorted(snapshots)
               if name in snapshots[rid].get('histograms', {})}
        ladders = {tuple(st['buckets']) for st in sts.values()}
        if len(ladders) == 1:
            roll = {'buckets': next(iter(ladders)),
                    'counts': [sum(c) for c in zip(
                        *(st['counts'] for st in sts.values()))],
                    'sum': sum(st['sum'] for st in sts.values()),
                    'n': sum(st['n'] for st in sts.values())}
            lines.extend(_histogram_lines(pn, roll, {}))
        for rid, st in sts.items():
            lines.extend(_histogram_lines(pn, st, {label: rid}))
    return lines


# billing-grade per-tenant meter suffixes: the ``tenant.<name>.<meter>``
# counter family the serving tier emits (docs/SERVING.md "Tenants").
# Fixed set so tenant names containing dots still parse unambiguously —
# the meter is always the LAST dotted segment and always one of these.
TENANT_METERS = ('submitted', 'completed', 'failed', 'shed',
                 'quota_rejected', 'shots', 'device_ms', 'compile_ms',
                 'bytes_wire')


def tenant_usage(snap: dict) -> dict:
    """Fold the ``tenant.<name>.<meter>`` counter family out of a
    registry :meth:`MetricsRegistry.snapshot` (or a bare counters dict)
    into ``{tenant: {meter: value}}`` usage rows, zero-filled over
    :data:`TENANT_METERS`.  Fleet tooling sums these rows across
    replica snapshots to get fleet-level billing totals — counters are
    monotone, so summation is exact."""
    counters = snap.get('counters', snap) if isinstance(snap, dict) \
        else {}
    out = {}
    for name, val in counters.items():
        if not isinstance(name, str) or not name.startswith('tenant.'):
            continue
        tenant, sep, meter = name[len('tenant.'):].rpartition('.')
        if not sep or meter not in TENANT_METERS:
            continue
        row = out.setdefault(tenant, {m: 0 for m in TENANT_METERS})
        row[meter] = val
    return out


def merge_tenant_usage(per_process: dict) -> dict:
    """Sum :func:`tenant_usage` rows across processes: maps
    ``{process_id: usage_rows}`` → one fleet-level ``{tenant:
    {meter: total}}`` rollup."""
    out = {}
    for rows in per_process.values():
        for tenant, row in rows.items():
            agg = out.setdefault(tenant,
                                 {m: 0 for m in TENANT_METERS})
            for m in TENANT_METERS:
                agg[m] += row.get(m, 0)
    return out


class Histogram:
    """Fixed-bucket histogram with a bounded exact-sample window.

    The buckets feed the Prometheus exposition; the window keeps the
    raw samples (newest ``window`` of them) so callers that previously
    ran ``np.percentile`` over a deque — the service's latency
    percentiles, the compile cache's compile-time percentiles — keep
    producing the exact same numbers after migrating onto the registry.
    """

    def __init__(self, name: str, buckets=None, window: int = 4096):
        self.name = name
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))
        self._counts = [0] * (len(self.buckets) + 1)   # +1 = +inf
        self._sum = 0.0
        self._n = 0
        self._window = deque(maxlen=window)
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._n += 1
        # deque.append is atomic; keeping it outside the lock keeps the
        # hot path to one short critical section
        self._window.append(value)

    @property
    def count(self) -> int:
        return self._n

    @property
    def sum(self) -> float:
        return self._sum

    def values(self) -> list:
        """Snapshot of the retained raw-sample window (newest last)."""
        return list(self._window)

    def percentile(self, p: float):
        """Exact percentile over the retained window (linear
        interpolation, numpy-compatible); None when empty."""
        vals = sorted(self._window)
        if not vals:
            return None
        if len(vals) == 1:
            return vals[0]
        rank = (p / 100.0) * (len(vals) - 1)
        lo = int(math.floor(rank))
        hi = min(lo + 1, len(vals) - 1)
        frac = rank - lo
        return vals[lo] * (1.0 - frac) + vals[hi] * frac

    def state(self) -> dict:
        with self._lock:
            return {'buckets': self.buckets,
                    'counts': list(self._counts),
                    'sum': self._sum, 'n': self._n,
                    'window': list(self._window),
                    'maxlen': self._window.maxlen}

    @classmethod
    def from_state(cls, name: str, st: dict) -> 'Histogram':
        h = cls(name, buckets=st['buckets'], window=st['maxlen'])
        h._counts = list(st['counts'])
        h._sum = st['sum']
        h._n = st['n']
        h._window.extend(st['window'])
        return h


class MetricsRegistry:
    """One process-wide home for every counter, gauge, and histogram."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._gauges: dict = {}
        self._histograms: dict = {}

    # -- counters (the utils.profiling namespace) -----------------------

    def inc(self, name: str, amount: int = 1) -> int:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + amount
            return self._counters[name]

    def get(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    # -- gauges ---------------------------------------------------------

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def gauge(self, name: str, default=0.0) -> float:
        with self._lock:
            return self._gauges.get(name, default)

    def gauges(self) -> dict:
        with self._lock:
            return dict(self._gauges)

    # -- histograms -----------------------------------------------------

    def histogram(self, name: str, buckets=None,
                  window: int = 4096) -> Histogram:
        """Get-or-create the named histogram (first caller fixes the
        bucket ladder and window size)."""
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = Histogram(name, buckets=buckets, window=window)
                self._histograms[name] = h
            return h

    def observe(self, name: str, value: float, buckets=None) -> None:
        self.histogram(name, buckets=buckets).observe(value)

    def histograms(self) -> dict:
        with self._lock:
            return dict(self._histograms)

    # -- snapshot / restore (test isolation) ----------------------------

    def snapshot(self) -> dict:
        """Deep-copyable state of every metric, for later ``restore``."""
        with self._lock:
            return {
                'counters': dict(self._counters),
                'gauges': dict(self._gauges),
                'histograms': {n: h.state()
                               for n, h in self._histograms.items()},
            }

    def restore(self, snap: dict) -> None:
        """Reset the registry to a prior ``snapshot``.  Histogram
        objects handed out before the snapshot keep working (they are
        rebuilt fresh in the registry, so post-restore observations via
        ``observe(name, ...)`` land in the restored instance)."""
        with self._lock:
            self._counters = dict(snap.get('counters', {}))
            self._gauges = dict(snap.get('gauges', {}))
            self._histograms = {
                n: Histogram.from_state(n, st)
                for n, st in snap.get('histograms', {}).items()}

    def reset(self) -> None:
        self.restore({'counters': {}, 'gauges': {}, 'histograms': {}})

    # -- exposition -----------------------------------------------------

    def prometheus_text(self) -> str:
        """Prometheus text-format exposition of every metric.

        Dotted names are sanitized (``serve.compile.cold`` →
        ``serve_compile_cold``); histogram buckets are cumulative with
        the conventional ``le`` label and trailing ``+Inf``; label
        values are escaped per the text-format spec
        (:func:`escape_label_value`).
        """
        lines = prometheus_snapshot_lines(self.snapshot())
        return '\n'.join(lines) + ('\n' if lines else '')


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry ``utils.profiling`` delegates to."""
    return _DEFAULT
