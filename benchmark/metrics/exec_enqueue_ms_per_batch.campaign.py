"""Milliseconds per batch the host spends enqueueing the exec hop in the
campaign: the self time of the port's ``physics.exec`` host spans
(``obs/trace.py``, on the profiler's clock) inside the traced window,
over the ``physics.batch`` spans there.  Nothing where the port has no
host spans, records none, or its ring dropped any."""


def read(rec):
    try:
        from distributed_processor_tpu_torch.obs.trace import (
            HOST_SPANS, self_time_ns)
    except ImportError:            # a port without host spans
        return None
    spans = HOST_SPANS.spans(*rec['events']['window'])
    batches = sum(s['name'] == 'physics.batch' for s in spans)
    if not batches or HOST_SPANS.dropped:
        return None
    own = self_time_ns(spans)
    return sum(own[s['id']] for s in spans
               if s['name'] == 'physics.exec') / 1e6 / batches
