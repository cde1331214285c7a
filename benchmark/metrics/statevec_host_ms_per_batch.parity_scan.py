"""Milliseconds per batch the host spends in the statevec block of the
parity scan: the self time of the port's ``statevec.apply`` host spans
(``obs/trace.py``, one a generic-engine step, over the 1q, coupling,
noise and collapse updates it enqueues) inside the traced window, over
the ``physics.batch`` spans there.  Nothing where the port has no such
spans, records none, or its ring dropped any."""


def read(rec):
    try:
        from distributed_processor_tpu_torch.obs.trace import (
            HOST_SPANS, self_time_ns)
    except ImportError:            # a port without host spans
        return None
    spans = HOST_SPANS.spans(*rec['events']['window'])
    batches = sum(s['name'] == 'physics.batch' for s in spans)
    applies = [s for s in spans if s['name'] == 'statevec.apply']
    if not batches or not applies or HOST_SPANS.dropped:
        return None
    own = self_time_ns(spans)
    return sum(own[s['id']] for s in applies) / 1e6 / batches
