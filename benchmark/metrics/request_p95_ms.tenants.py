"""The 95th percentile, by nearest rank, of every request's time from
its due time to its result on the host, over all requests of the
window; a failed, shed or unanswered request counts at the time the run
gave up on it.  A traced run profiles a segment after the window, so
the profiler stalls none of these requests."""

from benchmark.harness.common import p95


def read(rec):
    lat = rec['window'].get('latencies_ms')
    if not lat:
        return None
    return p95(lat)
