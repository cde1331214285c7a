"""Flight-deck observability for the serving stack (docs/OBSERVABILITY.md).

Four pieces the serve / compilecache / sim layers emit into (a copy of
the JAX package's ``obs/``, stdlib-only but for the profiler's switch
that :mod:`.trace`'s host spans read):

:mod:`.trace`     per-request lifecycle spans + Chrome Trace export;
                  host spans inside the hot paths on the profiler's
                  clock
:mod:`.metrics`   typed registry (counters / gauges / histograms) with
                  Prometheus text exposition — the backing store for
                  ``utils.profiling``'s counter namespace
:mod:`.recorder`  flight recorder — lock-cheap ring buffer of
                  supervision / chaos events
:mod:`.clock`     cross-process monotonic-clock offset estimation —
                  aligns replica-side spans and flight events into the
                  fleet router's timeline (docs/FLEET.md), and the
                  wall clock's offset from the monotonic one
"""

from .clock import ClockOffsetEstimator, wall_offset_s
from .metrics import (DEFAULT_BUCKETS, TENANT_METERS, Histogram,
                      MetricsRegistry, default_registry,
                      escape_label_value, merge_tenant_usage,
                      merged_prometheus_text,
                      prometheus_snapshot_lines, tenant_usage)
from .recorder import FlightRecorder
from .trace import (HOST_SPANS, STAGE_ORDER, HostSpanRing, TraceContext,
                    Tracer, chrome_trace_events, host_idle_ns, host_span,
                    host_work_intervals, self_time_ns, write_chrome_trace)

__all__ = [
    'ClockOffsetEstimator',
    'wall_offset_s',
    'DEFAULT_BUCKETS',
    'Histogram',
    'MetricsRegistry',
    'default_registry',
    'escape_label_value',
    'merge_tenant_usage',
    'merged_prometheus_text',
    'prometheus_snapshot_lines',
    'TENANT_METERS',
    'tenant_usage',
    'FlightRecorder',
    'HOST_SPANS',
    'HostSpanRing',
    'STAGE_ORDER',
    'TraceContext',
    'Tracer',
    'chrome_trace_events',
    'host_idle_ns',
    'host_span',
    'host_work_intervals',
    'self_time_ns',
    'write_chrome_trace',
]
