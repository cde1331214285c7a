"""The resolve hop's share of its roofline in the campaign: the least
time of the readout windows the traced batches fired
(``benchmark/roofline/resolve.py``) over the device time of the kernels
that ``benchmark/layers`` assigns to the resolve hop."""

from benchmark.harness.trace import device_seconds, matching


def read(rec):
    kernels = matching(rec['events']['device'], rec['layers']('resolve hop'))
    spent = device_seconds(kernels)
    if spent <= 0:
        return None
    return 100.0 * rec['work']['resolve_least_s'][0] / spent
