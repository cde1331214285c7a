"""Milliseconds per batch the host spends enqueueing the exec hop in the
parity scan outside the statevec block: the campaign's reading
(``exec_enqueue_ms_per_batch.campaign``: the self time of the port's
``physics.exec`` host spans inside the traced window, over the
``physics.batch`` spans there) in this cell, where the generic engine
runs under ``physics.exec`` and its ``statevec.apply`` and ``*.wait``
children are not counted.  Nothing where the port has no host spans,
records none, or its ring dropped any."""

from benchmark.harness.cell import read_metric


def read(rec):
    return read_metric('exec_enqueue_ms_per_batch.campaign', rec)
