"""Milliseconds of host work per ``simulate_rounds`` call in the stream:
the self time of the port's ``rounds.*`` host spans (``obs/trace.py``)
other than ``rounds.wait`` inside the traced window, over the
``rounds.call`` spans there.  Nothing where the port has no host spans,
records none, or its ring dropped any."""


def read(rec):
    try:
        from distributed_processor_tpu_torch.obs.trace import (
            HOST_SPANS, self_time_ns)
    except ImportError:            # a port without host spans
        return None
    spans = HOST_SPANS.spans(*rec['events']['window'])
    calls = sum(s['name'] == 'rounds.call' for s in spans)
    if not calls or HOST_SPANS.dropped:
        return None
    own = self_time_ns(spans)
    return sum(own[s['id']] for s in spans
               if s['name'].startswith('rounds.')
               and s['name'] != 'rounds.wait') / 1e6 / calls
