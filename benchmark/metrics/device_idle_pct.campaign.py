"""The device's idle share of the traced window: 100 x (1 - the union of
every device activity's interval / the window), from the profiler's
trace."""

from benchmark.harness.trace import busy_s, window_s


def read(rec):
    ev = rec['events']
    if not ev['device']:
        return None
    return 100.0 * (1.0 - busy_s(ev) / window_s(ev))
