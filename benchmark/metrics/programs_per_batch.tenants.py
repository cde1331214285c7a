"""Programs per coalesced batch over the window: the service's own
counters (``ExecutionService.stats()`` ``programs_dispatched`` over
``dispatches``), differenced over the window."""


def read(rec):
    w = rec['work']
    if not w.get('batches'):
        return None
    return w['programs'] / w['batches']
