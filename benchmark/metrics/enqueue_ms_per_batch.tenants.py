"""Milliseconds per batch the service's dispatcher thread spends
enqueueing a coalesced batch (``simulate_multi_batch``): the self time
of the port's ``serve.enqueue`` host spans (``obs/trace.py``) inside the
traced segment, the engine's waits on the device (``*.wait`` spans
inside) left out, over their count.  Nothing where the port has no host
spans, records none, or its ring dropped any."""


def read(rec):
    try:
        from distributed_processor_tpu_torch.obs.trace import (
            HOST_SPANS, self_time_ns)
    except ImportError:            # a port without host spans
        return None
    spans = HOST_SPANS.spans(*rec['events']['window'])
    enq = [s for s in spans if s['name'] == 'serve.enqueue']
    if not enq or HOST_SPANS.dropped:
        return None
    own = self_time_ns(spans)
    return sum(own[s['id']] for s in enq) / 1e6 / len(enq)
