"""The resolve hop's share of its roofline in the parity scan: the least
time of the readout windows the traced batches fired (the reset's and
the analysis's read on every core of every shot,
``benchmark/roofline/resolve.py``) over the device time of the kernels
that ``benchmark/layers`` assigns to the resolve hop (K2)."""

from benchmark.harness.trace import device_seconds, matching


def read(rec):
    kernels = matching(rec['events']['device'], rec['layers']('resolve hop'))
    spent = device_seconds(kernels)
    least = rec['work'].get('resolve_least_s')
    if spent <= 0 or not least:
        return None
    return 100.0 * least[0] / spent
