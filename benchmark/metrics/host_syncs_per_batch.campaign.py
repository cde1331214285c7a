"""Host waits on the device per batch in the campaign: the port's
``*.wait`` host spans (``obs/trace.py``) under a ``physics.batch`` or a
``sweep.stats`` span inside the traced window, over the
``physics.batch`` spans there.  Nothing where the port has no host
spans, records none, or its ring dropped any."""

ROOTS = ('physics.batch', 'sweep.stats')


def read(rec):
    try:
        from distributed_processor_tpu_torch.obs.trace import HOST_SPANS
    except ImportError:            # a port without host spans
        return None
    spans = HOST_SPANS.spans(*rec['events']['window'])
    batches = sum(s['name'] == 'physics.batch' for s in spans)
    if not batches or HOST_SPANS.dropped:
        return None
    by_id = {s['id']: s for s in spans}

    def under_root(s):
        while s['parent'] in by_id:
            s = by_id[s['parent']]
            if s['name'] in ROOTS:
                return True
        return False

    return sum(s['name'].endswith('.wait') and under_root(s)
               for s in spans) / batches
