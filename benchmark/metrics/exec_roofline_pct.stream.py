"""The exec hop's share of its roofline in the stream: the least time of
the traced calls' retired rows and bytes
(``benchmark/roofline/exec_rows.py``) over the device time of the
kernels that ``benchmark/layers`` assigns to the exec hop."""

from benchmark.harness.trace import device_seconds, matching


def read(rec):
    kernels = matching(rec['events']['device'], rec['layers']('exec hop'))
    spent = device_seconds(kernels)
    if spent <= 0:
        return None
    return 100.0 * rec['work']['exec_least_s'][0] / spent
