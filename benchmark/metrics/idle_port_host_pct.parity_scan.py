"""The share of the traced window in which the device is idle while the
port's host works: 100 x the time that no activity of the profiler's
device trace covers and some thread's innermost open host span of the
port (``obs/trace.py``) is not a ``*.wait``, over the window.  What
``device_idle_pct`` holds beyond it is idle time outside the port's
host work (the benchmark's own code, arrivals, the interpreter lock).
Nothing where the port has no host spans, records none, or its ring
dropped any."""

from benchmark.harness.trace import busy_intervals


def read(rec):
    try:
        from distributed_processor_tpu_torch.obs.trace import (
            HOST_SPANS, host_idle_ns)
    except ImportError:            # a port without host spans
        return None
    ev = rec['events']
    w = ev['window']
    spans = HOST_SPANS.spans(*w)
    if not spans or HOST_SPANS.dropped:
        return None
    idle = host_idle_ns(spans, busy_intervals(ev['device'], w))
    return 100.0 * idle / (w[1] - w[0])
