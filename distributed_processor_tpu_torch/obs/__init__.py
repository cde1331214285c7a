"""Flight-deck observability for the serving stack (docs/OBSERVABILITY.md).

Four stdlib-only pieces the serve / compilecache / sim layers emit
into (a copy of the JAX package's ``obs/``):

:mod:`.trace`     per-request lifecycle spans + Chrome Trace export
:mod:`.metrics`   typed registry (counters / gauges / histograms) with
                  Prometheus text exposition — the backing store for
                  ``utils.profiling``'s counter namespace
:mod:`.recorder`  flight recorder — lock-cheap ring buffer of
                  supervision / chaos events
:mod:`.clock`     cross-process monotonic-clock offset estimation —
                  aligns replica-side spans and flight events into the
                  fleet router's timeline (docs/FLEET.md)
"""

from .clock import ClockOffsetEstimator
from .metrics import (DEFAULT_BUCKETS, TENANT_METERS, Histogram,
                      MetricsRegistry, default_registry,
                      escape_label_value, merge_tenant_usage,
                      merged_prometheus_text,
                      prometheus_snapshot_lines, tenant_usage)
from .recorder import FlightRecorder
from .trace import (STAGE_ORDER, TraceContext, Tracer,
                    chrome_trace_events, write_chrome_trace)

__all__ = [
    'ClockOffsetEstimator',
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
    'STAGE_ORDER',
    'TraceContext',
    'Tracer',
    'chrome_trace_events',
    'write_chrome_trace',
]
