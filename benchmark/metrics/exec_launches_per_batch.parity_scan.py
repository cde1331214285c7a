"""Kernel launches per batch outside the resolve hop in the parity scan:
the profiler's kernel events over the traced batches, less those that
``benchmark/layers`` assigns to the resolve hop, per batch; on the
statevec device these are the generic engine's eager launches (the step
loop, the statevec block, the event gate).  Held against K2's own launch
counter (``ops.resolve.resolve_windows_fused.launches``) over the same
batches: where the trace holds another number of resolve kernels than
the counter, the profiler lost events and the metric is not reported."""

from benchmark.harness.trace import is_kernel, matching


def read(rec):
    ev, work = rec['events'], rec['work']
    kernels = [d for d in ev['device'] if is_kernel(d[0])]
    resolve = matching(kernels, rec['layers']('resolve hop'))
    if not kernels or not work.get('batches') \
            or len(resolve) != work.get('resolve_launches'):
        return None
    return (len(kernels) - len(resolve)) / work['batches']
