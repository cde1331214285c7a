"""Milliseconds per dispatched batch inside the service: the ``execute``
spans of ``obs/trace.py`` (every request traced in a ``--trace 1`` run),
one per batch, total time over the number of batches."""


def read(rec):
    spans = rec['work'].get('execute_spans') or []
    if not spans:
        return None
    return 1e3 * sum(t1 - t0 for t0, t1 in spans) / len(spans)
