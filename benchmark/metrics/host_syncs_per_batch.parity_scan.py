"""Host waits on the device per batch in the parity scan: the campaign's
reading (``host_syncs_per_batch.campaign``: the port's ``*.wait`` host
spans under a ``physics.batch`` or ``sweep.stats`` span inside the
traced window, over the ``physics.batch`` spans there) in this cell,
where the generic engine's ``step.wait`` and ``h2d.wait`` take one or
more a step.  Nothing where the port has no host spans, records none,
or its ring dropped any."""

from benchmark.harness.cell import read_metric


def read(rec):
    return read_metric('host_syncs_per_batch.campaign', rec)
